"""HTJ2K (JPEG 2000 Part 15 HT code-blocks) in the port's reader
(io/images.py, native/jp2.cpp) against ``cv2.cvtColor(cv2.imread(path),
cv2.COLOR_BGR2RGB)`` (OpenJPEG 2.5.3 in cv2 5.0), byte for byte.

The decoder's CxtVLC tables, which the writer inverts, are held against
OpenJPEG's as cv2's shared library carries them. The files come from
tests/htj2k_writer.py, whose coder is proven first and on its own: a lossless 5/3 file decodes in cv2 to its source array
exactly (and, where cv2 refuses the layout, in Pillow's OpenJPEG). Then
every HT variant the writer makes reads equal to cv2: gray and RGB, 5/3
and 9/7, SigProp and MagRef passes, stripe-causal blocks, tiles, two
layers, RPCL, COC mixing HT and Part 1 components, JPH files (colr method
5 among them); OpenJPEG's own limits give None in both (more than three
passes, ROI, Scup out of range, too many zero bit-planes, Mb over 30,
mixed code-blocks); and a seeded fuzz of byte flips in HT segments, their
Lcup/Scup bytes and packet headers, and of cuts, gives what cv2 gives."""

import io
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from ocr_inference_tpu_torch import native
from ocr_inference_tpu_torch.io.images import read_image, unsupported
from tests.htj2k_writer import (
    JP2_SIGNATURE_BOX, _box, htj2k_encode, jph_file, vlc_tables,
)


def _cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _same(path, data):
    """read_image equals cv2 (an image or None), and unsupported() passes
    the file."""
    path.write_bytes(data)
    want, got = _cv2_rgb(path), read_image(path)
    if want is None:
        assert got is None, path.name
    else:
        assert got is not None, path.name
        np.testing.assert_array_equal(got, want)
    assert unsupported(path) is None
    return want


def test_cxtvlc_tables_are_openjpegs():
    """jp2.cpp's kVlcTbl0 and kVlcTbl1 (T.814 Annex C's CxtVLC code, one
    table for the first line pair and one for the others) are OpenJPEG's
    vlc_tbl0 and vlc_tbl1 as cv2's shared library holds them: 1024
    little-endian uint16 each, the first found by its first four entries,
    the second beside it."""
    data = next(Path(cv2.__file__).parent.glob("cv2*.so")).read_bytes()
    tbl0, tbl1 = vlc_tables()
    at = data.find(struct.pack("<4H", 0x0023, 0x00A5, 0x0043, 0x0066))
    assert at >= 0
    np.testing.assert_array_equal(np.frombuffer(data, "<u2", 1024, at), tbl0)
    assert tbl1.astype("<u2").tobytes() in (data[at - 2048:at],
                                            data[at + 2048:at + 4096])


def _page(rng, h, w, c=3):
    """Smooth shapes with noise: blocks of many bit-planes and of runs of
    zeros both."""
    yy, xx = np.mgrid[:h, :w]
    base = 0.5 + 0.35 * np.sin(xx / 5.0 + yy / 9.0)[..., None]
    noise = rng.normal(0, 0.06, (h, w, c))
    return ((base + noise).clip(0, 1) * 255).astype(np.int64)


ROUND_TRIPS = {
    "16x16": (16, 16, {}),
    "noise_37x53": (37, 53, {"noise": True}),
    "64x80_cb32": (64, 80, {"cblk": (5, 5)}),
    "cb16x64": (70, 90, {"cblk": (4, 6)}),
    "256x256": (256, 256, {"levels": 6}),
    "tiles": (53, 61, {"tile": (24, 40)}),
    "two_layers_rpcl": (40, 48, {"layers": 2, "progression": "RPCL",
                                 "tile": (32, 32)}),
    "no_mct": (33, 47, {"mct": False, "levels": 1}),
    "no_wavelet": (9, 13, {"levels": 0}),
    "odd_rows": (5, 7, {}),
    "one_row": (1, 9, {}),
    "three_passes": (48, 40, {"passes": 3, "noise": True}),
    "coc_part1": (24, 32, {"part1": (1,)}),
    "offset": (20, 30, {"offset": (3, 5), "levels": 3}),
    "offset_tiles": (33, 17, {"offset": (1, 2), "tile": (24, 16),
                              "levels": 2}),
}


@pytest.mark.parametrize("name", ROUND_TRIPS)
def test_writer_lossless_round_trip(tmp_path, name):
    """The writer's lossless files decode to their source arrays: in cv2,
    and in the port; an image offset on the reference grid, which cv2
    refuses (None), in Pillow's OpenJPEG 2.5 and the port's decoder."""
    h, w, kw = ROUND_TRIPS[name]
    kw = dict(kw)
    rng = np.random.default_rng(len(name))
    x = rng.integers(0, 256, (h, w, 3)) if kw.pop("noise", False) \
        else _page(rng, h, w)
    cs = htj2k_encode(x, **kw)
    if "offset" in kw:
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(cs))), x)
        rc, planes = native.j2k_decode(cs)
        assert rc == 0
        np.testing.assert_array_equal(np.dstack(planes), x)
        assert _same(tmp_path / "x.j2k", cs) is None
        return
    if kw.get("passes", 1) > 1:
        # lossless only where every magnitude-1 sample neighbours one the
        # cleanup found: here the rest differ by one at most
        got = _same(tmp_path / "x.j2k", cs)
        assert np.abs(got.astype(int) - x).max() <= 1
        return
    np.testing.assert_array_equal(_same(tmp_path / "x.j2k", cs), x)


VARIANTS = {
    "97": dict(reversible=False),
    "97_sigprop": dict(reversible=False, passes=2),
    "97_sigprop_magref": dict(reversible=False, passes=3),
    "97_causal": dict(reversible=False, passes=3, causal=True),
    "97_coarse": dict(reversible=False, passes=3, step=4.0),
    "97_tiles": dict(reversible=False, passes=3, tile=(40, 24)),
    "97_two_layers": dict(reversible=False, passes=3, layers=2),
    "97_refinement_in_layer_1": dict(reversible=False, passes=3, layers=2,
                                     split=True),
    "97_rpcl_two_layers": dict(reversible=False, passes=3, layers=2,
                               progression="RPCL", tile=(32, 32)),
    "97_coc_part1": dict(reversible=False, passes=3, part1=(1,)),
    "53_coc_part1_two": dict(part1=(0, 2), mct=False),
    "53_cb16": dict(cblk=(4, 4), passes=3),
    "97_cb64x16": dict(reversible=False, passes=3, cblk=(6, 4)),
    "97_no_mct": dict(reversible=False, passes=3, mct=False),
    "bypass_bit": dict(reversible=False, passes=3, style=1),
    "segsym_bit": dict(style=0x20),
}


@pytest.mark.parametrize("name", VARIANTS)
def test_variants_equal_cv2(tmp_path, name):
    """Each HT variant reads equal to cv2's image (or None with it; the
    style bits OpenJPEG's HT decoder ignores among them)."""
    x = _page(np.random.default_rng(7), 45, 58)
    kw = VARIANTS[name]
    want = _same(tmp_path / "x.j2k", htj2k_encode(x, **kw))
    assert want is not None
    assert np.abs(want.astype(int) - x).mean() < 3 + 2 * kw.get("step", 0.5)


JPH = {
    "rgb": (3, ("enum", 16), True),
    "rgb_cicp": (3, ("cicp", 1, 13, 0, 1), True),
    "rgb_cicp_ycc": (3, ("cicp", 1, 13, 1, 0), True),
    "gray": (1, ("enum", 17), True),
    "gray_cicp": (1, ("cicp", 1, 13, 0, 1), False),
    "gray_no_colr": (1, None, False),
}


@pytest.mark.parametrize("name", JPH)
def test_jph_files(tmp_path, name):
    """JPH files (brand jph, T.814 Annex D) read as cv2 reads them: colr
    method 5 (the CICP values) is ignored as OpenJPEG's jp2.c ignores
    every method past 2, so a gray JPH so described is None, as a gray
    one with no colr box (and a gray raw codestream) is."""
    nc, colr, image = JPH[name]
    x = _page(np.random.default_rng(5), 20, 24)[..., :nc]
    data = jph_file(htj2k_encode(x, passes=3), 20, 24, nc, colr=colr)
    got = _same(tmp_path / "x.jph", data)
    assert (got is not None) == image
    if image:
        np.testing.assert_array_equal(got, np.broadcast_to(x, (20, 24, 3)))
    if nc == 1:
        assert _same(tmp_path / "x.j2k", htj2k_encode(x)) is None


def test_jph_second_colr_box(tmp_path):
    """A colr box of method 5 does not hide the next colr: a gray JPH whose
    first colr is method 5 and second EnumCS 17 reads as gray."""
    x = _page(np.random.default_rng(6), 20, 24)[..., :1]
    body = _box(b"ihdr", struct.pack(">IIHBBBB", 20, 24, 1, 7, 7, 0, 0))
    body += _box(b"colr", struct.pack(">BBBHHHB", 5, 0, 0, 1, 13, 0, 128))
    body += _box(b"colr", struct.pack(">BBBI", 1, 0, 0, 17))
    data = (JP2_SIGNATURE_BOX + _box(b"ftyp", b"jph \0\0\0\0jph ")
            + _box(b"jp2h", body) + _box(b"jp2c", htj2k_encode(x)))
    np.testing.assert_array_equal(_same(tmp_path / "x.jph", data),
                                  np.broadcast_to(x, (20, 24, 3)))


def _segs(b, n, segs):
    b.layers[min(b.layers)] = (n, segs)


def _first(b):
    return b.layers[min(b.layers)]


def _placeholders(b):
    n, segs = _first(b)
    if len(segs) == 2:
        _segs(b, 4, [segs[0], (3, segs[1][1])])


def _placeholders_empty(b):
    n, segs = _first(b)
    _segs(b, 4, [segs[0], (3, b"")])


def _refinement_empty(b):
    n, segs = _first(b)
    if len(segs) == 2:
        _segs(b, 3, [segs[0], (2, b"")])


def _cleanup_of(edit):
    def hook(b):
        n, segs = _first(b)
        cup = bytearray(segs[0][1])
        edit(cup)
        _segs(b, n, [(1, bytes(cup))] + segs[1:])
    return hook


def _zero_planes(d):
    def hook(b):
        b.zero_planes += d
    return hook


def _scup_big(c):
    c[-1] = 0xFE


def _scup_small(c):
    c[-1] = 0
    c[-2] &= 0xF0


def _lcup_one(c):
    del c[:-1]


LIMITS = {
    # OpenJPEG 2.5 decodes one HT set: a first contribution of 4 passes
    # (placeholder passes) fails, unless its refinement is empty
    "four_passes": (dict(reversible=False, passes=3, hook=_placeholders),
                    False),
    "four_passes_empty": (dict(reversible=False, passes=3,
                               hook=_placeholders_empty), True),
    "refinement_empty": (dict(reversible=False, passes=3,
                              hook=_refinement_empty), True),
    "lcup_one": (dict(hook=_cleanup_of(_lcup_one)), False),
    "scup_past_lcup": (dict(hook=_cleanup_of(_scup_big)), False),
    "scup_under_2": (dict(hook=_cleanup_of(_scup_small)), False),
    "zero_planes_mb": (dict(hook=_zero_planes(1)), False),
    "zero_planes_past_mb": (dict(hook=_zero_planes(2)), False),
    "zero_planes_mb_refined": (dict(reversible=False, passes=3,
                                    hook=_zero_planes(1)), False),
    "zero_planes_less": (dict(hook=_zero_planes(-1)), True),
    "u_q_past_bound": (dict(hook=_zero_planes(-3)), False),
    "mb_31": (dict(reversible=False, step=2.0 ** -22), False),
    "mb_30": (dict(reversible=False, step=2.0 ** -21), True),
    "mixed_bit7": (dict(style=0x80), False),
    "termall_layers": (dict(reversible=False, passes=3, layers=2,
                            split=True, style=4), False),
}


@pytest.mark.parametrize("name", LIMITS)
def test_openjpeg_limits(tmp_path, name):
    """OpenJPEG 2.5's HT decoder's own rules, found by running cv2 on such
    files: each file reads as cv2 reads it, None where cv2 gives None."""
    kw, image = LIMITS[name]
    x = _page(np.random.default_rng(0), 24, 28)
    got = _same(tmp_path / "x.j2k", htj2k_encode(x, **kw))
    assert (got is not None) == image


def test_roi_shift_fails(tmp_path):
    """An RGN marker on an HT component fails the decode (OpenJPEG has no
    ROI for HT blocks), however flat the page; without the shift it
    reads."""
    for x in (np.full((16, 16, 3), 128),
              np.random.default_rng(1).integers(0, 256, (16, 16, 3))):
        cs = htj2k_encode(x)
        at = cs.index(b"\xff\x5c")
        for shift, image in ((0, True), (3, False)):
            data = cs[:at] + struct.pack(">HHBBB", 0xFF5E, 5, 0, 0, shift) \
                + cs[at:]
            assert (_same(tmp_path / "x.j2k", data) is not None) == image


def test_fuzz_equal_cv2(tmp_path):
    """A seeded fuzz: byte flips inside HT cleanup and refinement segments
    (their Lcup/Scup bytes the most), in packet headers, and cuts of the
    codestream, each read as cv2 reads it (an image or None)."""
    rng = np.random.default_rng(24)
    x = _page(rng, 40, 48)
    bases = []
    for kw in (dict(), dict(reversible=False, passes=3, layers=2,
                            cblk=(5, 5)),
               dict(reversible=False, passes=2, causal=True, cblk=(4, 4))):
        layout = []
        bases.append((htj2k_encode(x, layout=layout, **kw), layout))
    images = nones = 0
    for it in range(360):
        cs, layout = bases[it % 3]
        data = bytearray(cs)
        kind = it % 6
        off, n, _ = layout[int(rng.integers(len(layout)))]
        if kind == 0:  # Scup's two bytes
            i = off + n - 1 - int(rng.integers(2))
            data[i] = int(rng.integers(256))
        elif kind in (1, 2):  # inside a segment
            for _ in range(1 + kind):
                data[off + int(rng.integers(n))] ^= 1 << int(rng.integers(8))
        elif kind == 3:  # a packet header byte (just before a segment)
            data[max(off - 1 - int(rng.integers(3)), 0)] ^= \
                1 << int(rng.integers(8))
        elif kind == 4:
            data[int(rng.integers(len(cs) // 2, len(cs) - 2))] = \
                int(rng.integers(256))
        else:
            data = data[:int(rng.integers(len(cs) // 3, len(cs)))] + \
                b"\xff\xd9"
        want = _same(tmp_path / "x.j2k", bytes(data))
        images += want is not None
        nones += want is None
    assert images > 100 and nones > 50
