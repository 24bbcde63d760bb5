"""The port's GIF reader (io/images.py, native/gif.cpp) against
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` (OpenCV 5.0's own
GIF decoder, the first frame), byte for byte and None for None: cv2's and
Pillow's files (interlace, local palettes, transparency, disposal,
animation), LZW at every minimum code size, a full table with and without
clear codes, hand-written code streams for the decoder's edge cases
(codes past the table, a missing end code or terminator, strings past the
frame, codes after its last pixel), frames inside a larger screen, colour
table corner cases, and seeded cuts and corruptions. image_format,
unsupported and read_image agree on every file."""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

from ocr_inference_tpu_torch.io.images import (
    image_format, read_image, unsupported,
)
from tests.image_writers import (
    gif_blocks, gif_codes, gif_file, gif_interlace, gif_lzw, pack_lsb,
)

PALETTE = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [200, 200, 200]],
                   np.uint8)


def _cv2_rgb(path):
    try:
        img = cv2.imread(str(path))
    except cv2.error:
        return None
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _same(path, data=None):
    if data is not None:
        path.write_bytes(data)
    want, got = _cv2_rgb(path), read_image(path)
    if want is None:
        assert got is None, path.name
    else:
        assert got is not None and got.shape == want.shape, path.name
        np.testing.assert_array_equal(got, want, err_msg=path.name)
    assert unsupported(path) is None
    if path.read_bytes()[:6] in (b"GIF87a", b"GIF89a"):
        assert image_format(path) == "GIF"
    return want


def _indexed(rng, h, w, colors):
    a = rng.integers(0, colors, (h, w)).astype(np.uint8)
    a[: h // 2, : w // 3] = a[0, 0]  # runs for the LZW table
    return a


@pytest.mark.parametrize("interlace", [False, True])
def test_cv2_and_pillow_gifs(tmp_path, interlace):
    """cv2's own GIF and Pillow's, adaptive palettes of 2-256 colours,
    plain and interlaced."""
    rng = np.random.default_rng(int(interlace))
    for h, w in ((1, 1), (5, 9), (33, 47), (90, 64)):
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        if not interlace:
            assert _same(tmp_path / "c.gif", cv2.imencode(
                ".gif", img)[1].tobytes()) is not None
        for colors in (2, 16, 255):
            buf = io.BytesIO()
            Image.fromarray(img).convert(
                "P", palette=Image.ADAPTIVE, colors=colors).save(
                buf, "GIF", interlace=interlace)
            assert _same(tmp_path / "p.gif", buf.getvalue()) is not None


@pytest.mark.parametrize("disposal", range(4))
def test_pillow_transparency_and_animation(tmp_path, disposal):
    """Transparency (the transparent pixels keep the background colour),
    each disposal method, a background index, and animations whose later
    frames are cropped to what changed (only the first frame is read)."""
    rng = np.random.default_rng(10 + disposal)
    read = 0
    for h, w in ((7, 11), (40, 31), (16, 16), (25, 3)):
        colors = int(rng.integers(3, 200))
        pal = rng.integers(0, 256, 3 * colors).tolist()
        index = _indexed(rng, h, w, colors)
        im = Image.fromarray(index, "P")
        im.putpalette(pal)
        buf = io.BytesIO()
        im.save(buf, "GIF", transparency=int(index[0, 0]),
                disposal=disposal, background=int(rng.integers(0, colors)))
        # Pillow may shrink the table below the background index: None
        read += _same(tmp_path / "t.gif", buf.getvalue()) is not None
        frames = []
        for k in range(3):
            f = Image.fromarray((index + k) % colors, "P")
            f.putpalette(pal)
            frames.append(f)
        buf = io.BytesIO()
        frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:],
                       disposal=disposal, transparency=1, optimize=True)
        read += _same(tmp_path / "a.gif", buf.getvalue()) is not None
    assert read >= 4


@pytest.mark.parametrize("min_size", range(1, 13))
def test_lzw_minimum_code_sizes(tmp_path, min_size):
    """Minimum code sizes 2-11 read (1 and 12 give None, as cv2), the
    table grown to 4096 codes with a clear code after it, and with a clear
    code every few codes; frames up to 2**min_size colours."""
    rng = np.random.default_rng(min_size)
    colors = min(1 << min_size, 256)
    h, w = 48, 70
    index = _indexed(rng, h, w, colors)
    pal = rng.integers(0, 256, (max(colors, 2), 3))
    for clear_every in (0, 37):
        data = gif_lzw(index, min_size, clear_every) if 2 <= min_size \
            else gif_lzw(index, 2)
        _same(tmp_path / "m.gif", gif_file(w, h, data, min_size, gct=pal))


def _stream(codes, min_size=2, **kwargs):
    w = kwargs.pop("w", 4)
    h = kwargs.pop("h", 1)
    return gif_file(w, h, pack_lsb(gif_codes(codes, min_size)), min_size,
                    gct=kwargs.pop("gct", PALETTE), **kwargs)


LZW_CASES = {
    "plain": [4, 0, 1, 2, 3, 5],
    "no_clear_first": [0, 1, 2, 3, 5],
    "no_end_code": [4, 0, 1, 2, 3],
    "repeat_kwk": [4, 0, 6, 1, 5],
    "code_past_table": [4, 0, 7, 5],
    "string_first": [4, 6, 0, 1, 5],
    "clear_inside": [4, 0, 1, 4, 2, 3, 5],
    "short_with_end": [4, 0, 5],
    "short_padded": [4, 0, 1, 2],
    "string_past_frame": [4, 0, 1, 2, 6, 5],
    "literal_past_frame": [4, 0, 1, 2, 3, 0, 1, 5],
    "code_after_last_pixel": [4, 0, 1, 2, 3, 0],
    "codes_after_end": [4, 0, 1, 2, 5, 3, 5],
    "end_then_literal": [4, 0, 1, 2, 3, 5, 0, 5],
    "clear_then_end": [4, 0, 1, 2, 3, 4, 5],
}


@pytest.mark.parametrize("name", sorted(LZW_CASES))
def test_lzw_edge_cases(tmp_path, name):
    """Hand-written code streams at the decoder's edges, as cv2 reads
    them (an image or None)."""
    _same(tmp_path / f"{name}.gif", _stream(LZW_CASES[name]))


@pytest.mark.parametrize("seed", range(6))
def test_lzw_tail_codes(tmp_path, seed):
    """Random code sequences after a complete frame (literals, strings,
    clear and end codes, up to three bytes of them): the image or None, as
    cv2 gives it."""
    rng = np.random.default_rng(seed)
    for i in range(50):
        tail = [int(c) for c in rng.choice([0, 1, 2, 3, 5, 5, 4, 6],
                                           int(rng.integers(1, 7)))]
        _same(tmp_path / f"tail{i}.gif", _stream([4, 0, 1, 2, 3] + tail))


def test_frames_screens_and_tables(tmp_path):
    """A frame inside a larger screen on the background colour (black
    without a global table), offsets past the screen, indices past the
    local table (the global one's colour) and past both (None), no colour table at all, disposal methods 4-7 and Graphic
    Control Extensions of another length (None), a background index past
    the table (None), a zero screen width or height (None), interlacing
    of few rows, other extensions, GIF87a, the header walk over later
    frames and blocks."""
    data = pack_lsb(gif_codes([4, 0, 1, 2, 3, 5], 2))
    small = PALETTE[:2]
    cases = {
        "inside": gif_file(6, 3, data, 2, gct=PALETTE, background=3,
                           frame=(1, 1, 4, 1)),
        "inside_no_gct": gif_file(6, 3, data, 2, lct=PALETTE, background=3,
                                  frame=(1, 1, 4, 1), gce=(2, None)),
        "outside": gif_file(4, 1, data, 2, gct=PALETTE, frame=(1, 0, 4, 1)),
        "screen_w0": gif_file(0, 3, data, 2, gct=PALETTE, frame=(0, 1, 4, 1)),
        "screen_h0": gif_file(4, 0, data, 2, gct=PALETTE, frame=(0, 0, 4, 1)),
        "screen_0_offset": gif_file(0, 0, data, 2, gct=PALETTE,
                                    frame=(1, 1, 4, 1)),
        "past_lct_in_gct": gif_file(4, 1, data, 2, gct=PALETTE, lct=small),
        "past_both": gif_file(4, 1, data, 2, gct=small),
        "no_tables": gif_file(4, 1, data, 2),
        "background_past": gif_file(4, 1, data, 2, gct=PALETTE,
                                    background=9),
        "gct_87a": gif_file(4, 1, data, 2, gct=PALETTE, version=b"87a"),
        "app_extension": gif_file(4, 1, data, 2, gct=PALETTE, extensions=(
            b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")),
        "comment_after": gif_file(4, 1, data, 2, gct=PALETTE,
                                  more=b"\x21\xfe\x03abc\x00"),
        "gce_5": gif_file(4, 1, data, 2, gct=PALETTE,
                          extensions=b"\x21\xf9\x05" + bytes(6)),
        "unknown_block": gif_file(4, 1, data, 2, gct=PALETTE, more=b"\x99"),
        "no_trailer": gif_file(4, 1, data, 2, gct=PALETTE, trailer=False),
        "later_frame_broken": gif_file(
            4, 1, data, 2, gct=PALETTE, more=b"\x2c" + bytes(8) + b"\0\x02"
            + gif_blocks(pack_lsb(gif_codes([4, 0, 7, 5], 2)))),
        "later_frame_cut": gif_file(4, 1, data, 2, gct=PALETTE,
                                    more=b"\x2c" + bytes(4),
                                    trailer=False),
    }
    for disposal in range(8):
        for transparent in (None, 1, 3):
            cases[f"gce_{disposal}_{transparent}"] = gif_file(
                6, 3, data, 2, gct=PALETTE, background=3,
                frame=(1, 1, 4, 1), gce=(disposal, transparent))
    rows = np.arange(10)[:, None] % 4
    inter = pack_lsb(gif_codes([4] + gif_interlace(rows).ravel().tolist()
                               + [5], 2))
    cases["interlaced_10_rows"] = gif_file(1, 10, inter, 2, gct=PALETTE,
                                           interlace=True)
    read = 0
    for name, blob in cases.items():
        read += _same(tmp_path / f"{name}.gif", blob) is not None
    assert read >= 20


@pytest.mark.parametrize("kind", ["plain", "interlaced", "animated"])
def test_gif_cuts_and_corruptions(tmp_path, kind):
    """Seeded cuts and changed bytes of Pillow's files: what cv2 makes of
    them, or None where it gives None."""
    rng = np.random.default_rng(len(kind) + 3)
    img = rng.integers(0, 256, (41, 53, 3), np.uint8)
    img[10:30] = img[10, 0]
    pal = Image.fromarray(img).convert("P", palette=Image.ADAPTIVE,
                                       colors=int(rng.integers(4, 200)))
    buf = io.BytesIO()
    if kind == "animated":
        pal.save(buf, "GIF", save_all=True, transparency=2,
                 append_images=[pal.rotate(90), pal.transpose(0)])
    else:
        pal.save(buf, "GIF", interlace=kind == "interlaced")
    data = buf.getvalue()
    for i in range(40):
        _same(tmp_path / f"c{i}.gif", data[:int(rng.integers(1, len(data)))])
        changed = bytearray(data)
        for _ in range(int(rng.integers(1, 3))):
            changed[int(rng.integers(6, len(data)))] = \
                int(rng.integers(0, 256))
        _same(tmp_path / f"x{i}.gif", bytes(changed))
