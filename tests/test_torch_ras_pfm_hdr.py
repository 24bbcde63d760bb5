"""The port's Sun raster, colour PFM and Radiance HDR readers
(io/images.py, native/hdr.cpp) against ``cv2.cvtColor(cv2.imread(path),
cv2.COLOR_BGR2RGB)`` (cv2 5.0's SunRasterDecoder, PFMDecoder and
HdrDecoder over rgbe.cpp), byte for byte and None for None: cv2's own
files, every Sun raster depth, type and colour map (the byte-encoded and
RGB types give None, as cv2), PFM scales, byte orders, header spellings
and special values, HDR run-length, flat and mixed scanlines and header
lines, and seeded cuts and corruptions. image_format, unsupported and
read_image agree on every file."""

import cv2
import numpy as np
import pytest

from ocr_inference_tpu_torch.io.images import (
    image_format, read_image, unsupported,
)
from tests.image_writers import (
    hdr_header, hdr_rle, pfm_file, sun_raster, sun_rle, sun_rows,
)


def _cv2_rgb(path):
    try:
        img = cv2.imread(str(path))
    except cv2.error:  # imread's size check raises; the port gives None
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
    return want


def _variants(data, rng, n, start=0):
    out = []
    for _ in range(n):
        out.append(data[:int(rng.integers(1, len(data)))])
        changed = bytearray(data)
        for _ in range(int(rng.integers(1, 3))):
            changed[int(rng.integers(start, len(data)))] = \
                int(rng.integers(0, 256))
        out.append(bytes(changed))
    return out


# -- Sun raster ---------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 8, 24, 32])
@pytest.mark.parametrize("rtype", [0, 1, 2, 3, 5])
def test_sun_raster_depths_and_types(tmp_path, depth, rtype):
    """Old (0) and standard (1) rasters at every depth, odd widths (rows
    padded to 16 bits), without a colour map and, at depths 1 and 8, with
    one of every length; byte-encoded (2), RGB (3) and other types give
    None, as cv2 5.0 reads neither."""
    rng = np.random.default_rng(depth * 10 + rtype)
    for w, h in ((1, 1), (7, 3), (30, 17)):
        if depth <= 8:
            pixels = rng.integers(0, 1 << depth, (h, w))
        else:
            pixels = rng.integers(0, 256, (h, w, depth // 8))
        rows = sun_rows(pixels, depth)
        data = sun_rle(rows) if rtype == 2 else rows
        want = _same(tmp_path / "a.ras", sun_raster(w, h, depth, data,
                                                    rtype))
        assert (want is not None) == (rtype <= 1)
        assert image_format(tmp_path / "a.ras") == "Sun raster"
        if depth <= 8:
            for entries in (1, 2, 1 << depth):
                for gray in (False, True):
                    pal = rng.integers(0, 256, (3, entries), np.uint8)
                    if gray:
                        pal[1:] = pal[0]
                    _same(tmp_path / "m.ras", sun_raster(
                        w, h, depth, data, rtype, 1, pal.tobytes()))


def test_sun_raster_headers_and_cuts(tmp_path):
    """cv2's own rasters; map types and lengths cv2 refuses (a map of
    another type, a map length without a map, a map at 24 bits, a map
    longer than the depth allows), bad depths and sizes, and seeded cuts
    and corruptions."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (21, 33, 3), np.uint8)
    path = tmp_path / "cv.ras"
    assert cv2.imwrite(str(path), img)
    assert _same(path) is not None
    rows8 = sun_rows(rng.integers(0, 256, (4, 6)), 8)
    cases = [
        sun_raster(6, 4, 8, rows8, maptype=2, colormap=bytes(6)),
        sun_raster(6, 4, 8, rows8, maptype=0, colormap=bytes(6)),
        sun_raster(6, 4, 8, rows8, maptype=1, colormap=bytes(6),
                   maplength=0),
        sun_raster(6, 4, 24, rows8 * 3, maptype=1, colormap=bytes(6)),
        sun_raster(6, 4, 1, sun_rows(np.zeros((4, 6)), 1), maptype=1,
                   colormap=bytes(9)),
        sun_raster(6, 4, 8, rows8, maptype=1, colormap=bytes(7)),
        sun_raster(6, 4, 4, rows8), sun_raster(6, 4, 16, rows8 * 2),
        sun_raster(0, 4, 8, rows8), sun_raster(6, 0, 8, rows8),
        sun_raster(0x80000000, 4, 8, rows8),
    ]
    for i, blob in enumerate(cases):
        _same(tmp_path / f"h{i}.ras", blob)
    for i, blob in enumerate(_variants(path.read_bytes(), rng, 30)):
        _same(tmp_path / f"v{i}.ras", blob)


# -- PFM ----------------------------------------------------------------------

@pytest.mark.parametrize("scale", [-1.0, 1.0, -2.0, 0.5, -3.0, 255.0,
                                   -1e-3, 0.0])
def test_pfm_scales_and_byte_orders(tmp_path, scale):
    """Values divided by |scale| and rounded to 8 bits without a factor
    (half to even, saturated; NaN, infinities and values past the int
    range give 0), little-endian below zero and big-endian from it; a
    scale of 0 gives None."""
    rng = np.random.default_rng(int(abs(scale) * 10))
    values = (rng.standard_normal((9, 13, 3)) * 150).astype(np.float32)
    values[0, :6, 0] = [0.5, 1.5, 2.5, 254.5, 255.5, -0.5]
    values[1, :6, 1] = [np.nan, np.inf, -np.inf, 1e10, 2147483520.0,
                        2147483648.0]
    _same(tmp_path / "s.pfm", pfm_file(values * abs(scale) if scale else
                                       values, scale))
    assert image_format(tmp_path / "s.pfm") == "PFM"


def test_pfm_headers_and_cuts(tmp_path):
    """cv2's own colour PFM files; header spellings (numbers ended by one
    whitespace byte each, leading zeros, a sign, an exponent, trailing
    letters, a second space that shifts the data, CR LF, a space after
    "PF"), the gray "Pf" (None, as imread's own check), seeded cuts and
    corruptions."""
    rng = np.random.default_rng(11)
    for h, w in ((1, 1), (12, 7), (40, 61)):
        img = (rng.random((h, w, 3)) * rng.choice([1.0, 300.0])) \
            .astype(np.float32)
        path = tmp_path / "cv.pfm"
        assert cv2.imwrite(str(path), img)
        assert _same(path) is not None
    values = (rng.random((3, 4, 3)) * 300).astype(np.float32)
    body = values[::-1].astype("<f4").tobytes()
    for i, head in enumerate([
            b"PF\n4 3\n-1.0\n", b"PF\n04 003\n-1\n", b"PF\n4 3\n-1e0\n",
            b"PF\n4x 3\n-1.0\n", b"PF\n4 3\n-1.0 \n", b"PF\n4  3\n-1.0\n",
            b"PF\n 4 3\n-1.0\n", b"PF\r\n4 3\n-1.0\n", b"PF 4 3 -1.0\n",
            b"PF\n4 3\n-inf\n", b"PF\n4 3\n-nan\n", b"PF\n+4 3\n-1.0\n",
            b"Pf\n4 3\n-1.0\n"]):
        _same(tmp_path / f"h{i}.pfm", head + body + body)
    data = pfm_file(values, -1.0)
    for i, blob in enumerate(_variants(data, rng, 30)):
        _same(tmp_path / f"v{i}.pfm", blob)


# -- Radiance HDR -------------------------------------------------------------

def _rgbe(rng, h, w):
    px = rng.integers(0, 6, (h, w, 4)).astype(np.uint8) * 45
    px[..., 3] = rng.integers(110, 150, (h, w))
    px[0, :3, 3] = 0   # exponent 0: black
    px[-1, -1, 3] = 255  # past 8 bits after the factor 255
    px[-2, -1, 3] = 200
    return px


@pytest.mark.parametrize("width", [1, 7, 8, 37, 300])
def test_hdr_scanlines(tmp_path, width):
    """Run-length scanlines (widths 8 to 0x7fff), flat pixels (narrower
    ones, or a first scanline that does not start with 2, 2), a run-length
    scanline followed by flat ones, old-style run pixels (read flat, as
    rgbe.cpp reads them), and both magic lines."""
    rng = np.random.default_rng(width)
    px = _rgbe(rng, 5, width)
    flat = hdr_header(width, 5) + px.tobytes()
    _same(tmp_path / "f.hdr", flat)
    assert image_format(tmp_path / "f.hdr") == "Radiance HDR"
    _same(tmp_path / "g.hdr", hdr_header(width, 5, b"#?RGBE") + px.tobytes())
    old = px.copy()
    old[2, 0] = [1, 1, 1, 3]
    _same(tmp_path / "o.hdr", hdr_header(width, 5) + old.tobytes())
    if width >= 8:
        _same(tmp_path / "r.hdr", hdr_header(width, 5) + hdr_rle(px))
        _same(tmp_path / "m.hdr", hdr_header(width, 5) + hdr_rle(px[:2])
              + px[2:].tobytes())


def test_hdr_headers_runs_and_cuts(tmp_path):
    """cv2's own HDR files; header lines (exposure and other lines read
    past, another format, a missing blank line or format, +Y or -X
    orientation, CR LF, no magic line after the sniffed one), run-length
    faults (a zero count, a run past the channel, a scanline of another
    width) and seeded cuts and corruptions."""
    rng = np.random.default_rng(2)
    for h, w in ((1, 1), (9, 23), (31, 64)):
        img = (rng.random((h, w, 3)) * rng.choice([1.0, 2.0, 100.0])) \
            .astype(np.float32)
        path = tmp_path / "cv.hdr"
        assert cv2.imwrite(str(path), img)
        assert _same(path) is not None
    px = _rgbe(rng, 3, 12)
    runs = hdr_rle(px)
    size = b"-Y 3 +X 12\n"
    heads = [
        b"#?RADIANCE\nEXPOSURE=2.0\nFORMAT=32-bit_rle_rgbe\n\n" + size,
        b"#?RADIANCE\nSOFTWARE=x\nGAMMA=2.2\nFORMAT=32-bit_rle_rgbe\n\n"
        + size,
        b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n" + size,
        b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n" + size,
        b"#?RADIANCE\n\n" + size,
        b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 3 +X 12\n",
        b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 3 -X 12\n",
        b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 3 +X 12 extra\n",
        b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y  3  +X 12\n",
        b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\r\n\n" + size,
        b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 0 +X 12\n",
    ]
    for i, head in enumerate(heads):
        _same(tmp_path / f"h{i}.hdr", head + runs)
    start = len(hdr_header(12, 3))
    faults = []
    zero = bytearray(hdr_header(12, 3) + runs)
    zero[start + 4] = 0
    faults.append(bytes(zero))
    past = bytearray(hdr_header(12, 3) + runs)
    past[start + 4] = 128 + 13
    faults.append(bytes(past))
    other = bytearray(hdr_header(12, 3) + runs)
    other[start + 3] = 11
    faults.append(bytes(other))
    faults.append(hdr_header(12, 3) + runs + b"trailing")
    for i, blob in enumerate(faults):
        _same(tmp_path / f"r{i}.hdr", blob)
    for i, blob in enumerate(_variants(hdr_header(12, 3) + runs, rng, 30,
                                       start)):
        _same(tmp_path / f"v{i}.hdr", blob)
