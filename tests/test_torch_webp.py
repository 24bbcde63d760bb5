"""The port's WebP reader (io/images.py, native/webp.cpp) against
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` (cv2 5.0's
WebPDecoder over its bundled libwebp), byte for byte and None for None:
lossy files at every quality cv2 writes and lossless ones (quality 101),
Pillow's lossy and lossless files with alpha, ``exact`` and every method,
animations, libwebp's own encoder driven through ctypes for segments,
filter type, strength and sharpness, token partitions, near-lossless and
the alpha plane's filter and compression, hand-built containers, and
seeded cuts and corruptions of each. image_format, unsupported and
read_image agree on every file."""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

from ocr_inference_tpu_torch.io.images import (
    image_format, read_image, unsupported,
)
from tests.image_writers import (
    ispe_scaled_avif, layered_avif, riff_chunks, riff_file,
    screen_content_avif,
    sequence_avif, ten_bit_avif, webp_encode,
)


def _cv2_rgb(path):
    try:
        img = cv2.imread(str(path))
    except cv2.error:  # imread's size check raises; the port gives None
        return None
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _same(path, data=None):
    """read_image equals cv2 (an image or None); the sniffing and
    unsupported() agree with read_image."""
    if data is not None:
        path.write_bytes(data)
    want, got = _cv2_rgb(path), read_image(path)
    if want is None:
        assert got is None, path.name
    else:
        assert got is not None and got.shape == want.shape, path.name
        np.testing.assert_array_equal(got, want, err_msg=path.name)
    assert unsupported(path) is None
    if len(path.read_bytes()) >= 12 and path.read_bytes()[8:12] == b"WEBP":
        assert image_format(path) == "WebP"
    return want


def _page(rng, h, w, channels=3):
    """A page-like image: white, dark blocks of text-like strokes, noise,
    and (with 4 channels) alpha that is 0 over a third of the pixels."""
    img = np.full((h, w, channels), 255, np.uint8)
    for _ in range(int(rng.integers(2, 9))):
        y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y:y + int(rng.integers(1, 12)), x:x + int(rng.integers(1, 30))] \
            = rng.integers(0, 256, channels)
    img = (img.astype(int) + rng.integers(-12, 13, img.shape)).clip(0, 255)
    img = img.astype(np.uint8)
    if channels == 4:
        img[..., 3] = np.where(rng.random((h, w)) < 0.33, 0,
                               rng.integers(0, 256, (h, w)))
    return img


@pytest.mark.parametrize("quality", [1, 5, 20, 40, 60, 75, 90, 100, 101])
def test_cv2_written_webp(tmp_path, quality):
    """cv2's own files, lossy at qualities 1-100 and lossless at 101, at
    odd and even sizes (the upsampler's last row and column)."""
    rng = np.random.default_rng(quality)
    for h, w in ((1, 1), (2, 3), (17, 16), (31, 45), (64, 33)):
        for img in (_page(rng, h, w), rng.integers(0, 256, (h, w, 3),
                                                   np.uint8)):
            path = tmp_path / "x.webp"
            assert cv2.imwrite(str(path), img,
                               [cv2.IMWRITE_WEBP_QUALITY, quality])
            assert _same(path) is not None


@pytest.mark.parametrize("method", range(7))
def test_pillow_webp(tmp_path, method):
    """Pillow's files at each method: lossy with and without alpha (alpha
    dropped, colours kept as decoded), lossless with alpha, with and
    without ``exact`` (the encoder may zero colours under alpha 0; the
    decoder keeps what it finds)."""
    rng = np.random.default_rng(100 + method)
    for h, w in ((9, 14), (40, 57)):
        for mode, kwargs in (("RGB", {}), ("RGBA", {}),
                             ("RGBA", {"lossless": True}),
                             ("RGBA", {"lossless": True, "exact": True}),
                             ("RGB", {"lossless": True})):
            img = _page(rng, h, w, 4 if mode == "RGBA" else 3)
            buf = io.BytesIO()
            Image.fromarray(img, mode).save(
                buf, "WEBP", method=method,
                quality=int(rng.integers(0, 101)), **kwargs)
            assert _same(tmp_path / "p.webp", buf.getvalue()) is not None


@pytest.mark.parametrize("lossless", [False, True])
def test_animated_webp_first_frame(tmp_path, lossless):
    """An animation's first frame, as WebPAnimDecoder composes it for
    cv2: Pillow's frames (the later ones cropped to what changed) and a
    first frame offset inside a larger canvas (black around it)."""
    rng = np.random.default_rng(7 + lossless)
    for h, w in ((12, 20), (33, 27)):
        base = _page(rng, h, w, 4)
        frames = [Image.fromarray(base, "RGBA")]
        for _ in range(2):
            nxt = base.copy()
            nxt[2:6, 3:9] = rng.integers(0, 256, 4)
            frames.append(Image.fromarray(nxt, "RGBA"))
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                       lossless=lossless, duration=40, minimize_size=True)
        assert _same(tmp_path / "a.webp", buf.getvalue()) is not None
        # the first frame moved into a larger canvas
        data = buf.getvalue()
        chunks = [(tag, data[at:at + size])
                  for tag, at, size in riff_chunks(data)]
        vp8x = bytearray(chunks[0][1])
        vp8x[4:7] = (w + 9).to_bytes(3, "little")
        vp8x[7:10] = (h + 5).to_bytes(3, "little")
        anmf = bytearray(chunks[2][1])
        anmf[0:3] = (3).to_bytes(3, "little")   # x = 6
        anmf[3:6] = (2).to_bytes(3, "little")   # y = 4
        moved = riff_file([(b"VP8X", bytes(vp8x)), chunks[1],
                           (b"ANMF", bytes(anmf))] + chunks[3:])
        got = _same(tmp_path / "m.webp", moved)
        assert got is not None and not got[:4].any() and not got[:, :6].any()


OPTIONS = [
    {"segments": 1}, {"segments": 2}, {"segments": 3},
    {"segments": 4, "sns_strength": 100},
    {"filter_type": 0, "filter_strength": 20},
    {"filter_type": 0, "filter_strength": 100, "filter_sharpness": 3},
    {"filter_type": 1, "filter_strength": 0},
    {"filter_type": 1, "filter_strength": 100},
    {"filter_type": 1, "filter_strength": 60, "filter_sharpness": 2},
    {"filter_type": 1, "filter_strength": 80, "filter_sharpness": 7},
    {"autofilter": 1}, {"partitions": 1}, {"partitions": 2},
    {"partitions": 3, "method": 0}, {"preprocessing": 2},
    {"use_sharp_yuv": 1}, {"pass_": 3, "quality": 95},
    {"lossless": 1, "near_lossless": 0}, {"lossless": 1, "near_lossless": 40},
    {"lossless": 1, "near_lossless": 80}, {"lossless": 1, "method": 0},
    {"lossless": 1, "method": 6, "quality": 100},
    {"lossless": 1, "quality": 0, "exact": 1},
    {"alpha_compression": 0}, {"alpha_filtering": 0},
    {"alpha_filtering": 2, "alpha_quality": 50},
    {"alpha_compression": 1, "alpha_quality": 10},
    {"alpha_compression": 1, "alpha_filtering": 2, "method": 6},
]


@pytest.mark.parametrize("options", OPTIONS,
                         ids=lambda o: "-".join(f"{k}{v}" for k, v in
                                                o.items()))
def test_libwebp_encoder_options(tmp_path, options):
    """libwebp's own encoder: segments and spatial noise shaping, the
    simple and normal loop filters at several strengths and sharpnesses,
    one to eight token partitions, near-lossless, and the ALPH plane raw,
    filtered and lossless-coded."""
    rng = np.random.default_rng(len(str(options)))
    for h, w in ((23, 31), (70, 49)):
        for channels in (3, 4):
            img = _page(rng, h, w, channels)
            data = webp_encode(img, **options)
            assert _same(tmp_path / "o.webp", data) is not None


def _variants(data, rng, n):
    """Seeded cuts and byte changes of a file."""
    out = []
    for _ in range(n):
        out.append(data[:int(rng.integers(1, len(data)))])
        changed = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            changed[int(rng.integers(12, len(data)))] = \
                int(rng.integers(0, 256))
        out.append(bytes(changed))
    return out


@pytest.mark.parametrize("kind", ["lossy", "lossy_alpha", "lossless",
                                  "animated"])
def test_webp_cuts_and_corruptions(tmp_path, kind):
    """Files cut short and bytes changed (headers, partitions, Huffman
    codes, transforms, alpha): the image where libwebp decodes one, None
    where it fails, as cv2."""
    rng = np.random.default_rng(len(kind))
    img = _page(rng, 37, 52, 4)
    if kind == "lossy":
        data = webp_encode(img[..., :3], quality=80)
    elif kind == "lossy_alpha":
        data = webp_encode(img, quality=60, alpha_filtering=1)
    elif kind == "lossless":
        data = webp_encode(img, lossless=1, quality=50)
    else:
        buf = io.BytesIO()
        frames = [Image.fromarray(img, "RGBA"),
                  Image.fromarray(255 - img, "RGBA")]
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                       lossless=True)
        data = buf.getvalue()
    for i, blob in enumerate(_variants(data, rng, 40)):
        _same(tmp_path / f"v{i}.webp", blob)


def test_webp_hand_built_containers(tmp_path):
    """Containers as libwebp's parser and demuxer judge them: the ALPH
    header's method, pre-processing and reserved bits, raw alpha too
    short, a VP8X canvas that differs from the frame, an ALPH chunk
    without the VP8X alpha flag, unknown chunks, odd chunk padding, a
    RIFF size past the file or short of it, files under 32 bytes, an
    animation frame outside its canvas or without ANIM."""
    rng = np.random.default_rng(3)
    img = _page(rng, 20, 26, 4)
    lossy = webp_encode(img, quality=70, alpha_compression=0)
    chunks = [(tag, lossy[at:at + size]) for tag, at, size in
              riff_chunks(lossy)]
    vp8x, alph, vp8 = chunks
    assert (vp8x[0], alph[0], vp8[0]) == (b"VP8X", b"ALPH", b"VP8 ")
    cases = {"ok": riff_file(chunks)}
    for header in (0x00, 0x04, 0x08, 0x0C, 0x10, 0x20, 0x30, 0x40, 0x80,
                   0x02, 0x03):
        cases[f"alph_{header:02x}"] = riff_file(
            [vp8x, (b"ALPH", bytes([header]) + alph[1][1:]), vp8])
    cases["alph_short"] = riff_file([vp8x, (b"ALPH", alph[1][:-1]), vp8])
    cases["alph_one_byte"] = riff_file([vp8x, (b"ALPH", b"\0"), vp8])
    cases["no_alpha_flag"] = riff_file(
        [(b"VP8X", b"\0" + vp8x[1][1:]), alph, vp8])
    lossless_alpha = webp_encode(img, quality=70)
    lc = dict((tag, lossless_alpha[at:at + size])
              for tag, at, size in riff_chunks(lossless_alpha))
    broken = bytearray(lc[b"ALPH"])
    broken[len(broken) // 2:] = bytes(len(broken) - len(broken) // 2)
    cases["alph_lossless_broken"] = riff_file(
        [(b"VP8X", lc[b"VP8X"]), (b"ALPH", bytes(broken)),
         (b"VP8 ", lc[b"VP8 "])])
    canvas = bytearray(vp8x[1])
    canvas[4] += 1
    cases["canvas_differs"] = riff_file([(b"VP8X", bytes(canvas)), alph,
                                         vp8])
    cases["unknown_chunk"] = riff_file([vp8x, (b"XYZW", b"abc"), alph, vp8])
    cases["iccp_chunk"] = riff_file([vp8x, (b"ICCP", b"x" * 7), alph, vp8])
    simple = riff_file([vp8])
    cases["simple"] = simple
    cases["riff_past_file"] = simple[:4] + (len(simple)).to_bytes(
        4, "little") + simple[8:]
    cases["riff_short"] = simple[:4] + (len(simple) - 20).to_bytes(
        4, "little") + simple[8:]
    cases["trailing_bytes"] = simple + b"trailing"
    cases["tiny"] = simple[:31]
    anim = io.BytesIO()
    Image.fromarray(img, "RGBA").save(anim, "WEBP", save_all=True,
                                      append_images=[Image.fromarray(
                                          img[::-1], "RGBA")])
    anim = anim.getvalue()
    ac = [(tag, anim[at:at + size]) for tag, at, size in riff_chunks(anim)]
    far = bytearray(ac[2][1])
    far[0:3] = (40).to_bytes(3, "little")
    cases["frame_outside"] = riff_file(ac[:2] + [(b"ANMF", bytes(far))]
                                       + ac[3:])
    cases["no_anim_chunk"] = riff_file([ac[0]] + ac[2:])
    cases["anim_flag_still"] = riff_file(
        [(b"VP8X", bytes([vp8x[1][0] | 2]) + vp8x[1][1:]), alph, vp8])
    bad_sub = bytearray(ac[2][1])
    bad_sub[17] ^= 0x40  # the first frame's image chunk tag
    cases["frame_bad_subchunk"] = riff_file(ac[:2] + [(b"ANMF",
                                                       bytes(bad_sub))]
                                            + ac[3:])
    read = 0
    for name, blob in cases.items():
        read += _same(tmp_path / f"{name}.webp", blob) is not None
    assert read >= 5


def test_webp_sniffing_and_refusals(tmp_path):
    """RIFF/WEBP is sniffed by content under any name; cv2's default AVIF,
    AVIFs with screen-content tools, of 10 bits, an image sequence and a
    layered item read as cv2 reads them, and an AVIF whose ispe differs
    from its frame is refused by name, before and after the WebP
    readers."""
    img = np.random.default_rng(9).integers(0, 256, (10, 12, 3), np.uint8)
    path = tmp_path / "page.png"
    assert cv2.imwrite(str(tmp_path / "w.webp"), img)
    path.write_bytes((tmp_path / "w.webp").read_bytes())
    assert image_format(path) == "WebP" and unsupported(path) is None
    _same(path)
    avif = tmp_path / "x.avif"
    assert cv2.imwrite(str(avif), img)
    assert image_format(avif) == "AVIF" and unsupported(avif) is None
    np.testing.assert_array_equal(read_image(avif), _cv2_rgb(avif))
    avif = tmp_path / "screen.avif"
    screen_content_avif(avif)
    assert image_format(avif) == "AVIF" and unsupported(avif) is None
    np.testing.assert_array_equal(read_image(avif), _cv2_rgb(avif))
    avif = tmp_path / "ten.avif"
    ten_bit_avif(avif)
    assert image_format(avif) == "AVIF" and unsupported(avif) is None
    np.testing.assert_array_equal(read_image(avif), _cv2_rgb(avif))
    avif = tmp_path / "frames.avif"
    sequence_avif(avif)
    assert image_format(avif) == "AVIF" and unsupported(avif) is None
    np.testing.assert_array_equal(read_image(avif), _cv2_rgb(avif))
    avif = tmp_path / "layered.avif"
    layered_avif(avif)
    assert image_format(avif) == "AVIF" and unsupported(avif) is None
    np.testing.assert_array_equal(read_image(avif), _cv2_rgb(avif))
    avif = tmp_path / "scaled.avif"
    ispe_scaled_avif(avif)
    assert image_format(avif) == "AVIF"
    assert "ispe property differs" in unsupported(avif)
    with pytest.raises(NotImplementedError, match="ispe property differs"):
        read_image(avif)
