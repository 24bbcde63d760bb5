"""The port's BMP, PNM (P1-P6) and PAM (P7) readers (io/images.py,
native/bmp.cpp) against ``cv2.cvtColor(cv2.imread(path),
cv2.COLOR_BGR2RGB)`` (cv2 5.0's grfmt_bmp.cpp, grfmt_pxm.cpp and
grfmt_pam.cpp), byte for byte: every BMP header and bit depth, RLE8 and
RLE4 streams of seeded escapes, bit fields, top-down rows, palettes short
of their entries and files cut short; ASCII and binary PNM with comments,
maxvals below 255 and 16-bit samples; PAM tuple types and depths. And the
sniffing repairs: a colour PFM and an ``#?RGBE`` Radiance HDR are read as
cv2 reads them, a gray PFM gives None, as cv2."""

import cv2
import numpy as np
import pytest

from ocr_inference_tpu_torch.io.images import (
    image_format, read_image, unsupported,
)
from tests.image_writers import (
    bmp_file, bmp_rle8, bmp_rows, pam_file, pnm_file,
)


def _cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _same(path, data=None, columns=None):
    """read_image equals cv2 (an image or None), on the first ``columns``
    of each row where only those are written by cv2; unsupported() passes
    the file."""
    if data is not None:
        path.write_bytes(data)
    want, got = _cv2_rgb(path), read_image(path)
    if want is None:
        assert got is None, path.name
    else:
        assert got is not None and got.shape == want.shape, path.name
        np.testing.assert_array_equal(got[:, :columns], want[:, :columns])
    assert unsupported(path) is None
    return want


# -- BMP ----------------------------------------------------------------------

@pytest.mark.parametrize("header", [12, 40, 64, 108, 124])
@pytest.mark.parametrize("bpp", [1, 4, 8, 16, 24, 32])
def test_bmp_headers_and_depths(tmp_path, header, bpp):
    """Core (12-byte, no 16-bit), info, OS/2 2.x, V4 and V5 headers at
    every depth, bottom-up and top-down, odd widths, palettes full and
    short (clrused), as cv2 reads them."""
    rng = np.random.default_rng(header * 40 + bpp)
    for w, h in ((1, 1), (7, 5), (33, 17)):
        for top_down in (False, True):
            if header == 12 and (top_down or bpp == 16):
                continue
            if bpp <= 8:
                count = int(rng.integers(1, (1 << bpp) + 1))
                pal = rng.integers(0, 256,
                                   (1 << bpp, 3 if header == 12 else 4))
                index = rng.integers(0, 1 << bpp, (h, w))
                data = bmp_rows(index.astype(np.uint8), bpp)
                used = 0 if header == 12 else count
                palette = pal if header == 12 else pal[:count]
            else:  # the rows' bytes as they are stored
                pixels = rng.integers(0, 256, (h, w * bpp // 8))
                data = bmp_rows(pixels.astype(np.uint8), 8)
                used, palette = 0, None
            if top_down:  # rows top first: reverse the stored order
                pitch = len(data) // h
                data = b"".join(data[i * pitch: (i + 1) * pitch]
                                for i in range(h - 1, -1, -1))
            path = tmp_path / "x.bmp"
            _same(path, bmp_file(w, -h if top_down else h, bpp, data,
                                 header=header, clrused=used,
                                 palette=palette))
            assert image_format(path) == "BMP"


@pytest.mark.parametrize("masks", [
    (0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F), (0xF00, 0xF0, 0xF),
    (0xFF0000, 0xFF00, 0xFF), (0xFF, 0xFF00, 0xFF0000)])
@pytest.mark.parametrize("bpp", [16, 32])
def test_bmp_bitfields(tmp_path, masks, bpp):
    """BI_BITFIELDS: 16 bits as 5-6-5 or 5-5-5 (other masks give None),
    32 bits as its first three bytes whatever the masks."""
    rng = np.random.default_rng(bpp)
    pixels = rng.integers(0, 256, (9, 13 * bpp // 8)).astype(np.uint8)
    _same(tmp_path / "x.bmp", bmp_file(13, 9, bpp, bmp_rows(pixels, 8),
                                       compression=3, masks=masks))


def _rle_stream(rng, width, bits, ops):
    """Seeded RLE ops: encoded and absolute runs, end-of-line, delta and
    end-of-bitmap escapes, some overflowing their row."""
    out = bytearray()
    for _ in range(ops):
        k = rng.random()
        if k < 0.45:
            out += bytes([int(rng.integers(1, max(2, width))),
                          int(rng.integers(0, 256))])
        elif k < 0.75:
            n = int(rng.integers(3, max(4, min(255, width + 2))))
            nb = n if bits == 8 else (n + 1) // 2
            out += bytes([0, n]) + rng.integers(0, 256, nb, np.uint8) \
                .tobytes() + bytes(nb & 1)
        elif k < 0.88:
            out += b"\x00\x00"
        elif k < 0.95:
            out += bytes([0, 2, int(rng.integers(0, 4)),
                          int(rng.integers(0, 2))])
        else:
            out += b"\x00\x01"
    if rng.random() < 0.8:
        out += b"\x00\x01"
    return bytes(out)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("seed", range(4))
def test_bmp_rle(tmp_path, bits, seed):
    """RLE8 and RLE4 as OpenCV decodes them (native/bmp.cpp): escapes that
    skip pixels fill them with palette entry 0, RLE4's escapes move by
    their x shift alone, a run past its row or data that ends early gives
    None."""
    rng = np.random.default_rng(seed * 2 + bits)
    for _ in range(40):
        w, h = int(rng.integers(1, 30)), int(rng.integers(1, 12))
        pal = rng.integers(0, 256, (1 << bits, 4))
        stream = _rle_stream(rng, w, bits, int(rng.integers(1, 60)))
        _same(tmp_path / "x.bmp", bmp_file(
            w, -h if rng.random() < 0.3 else h, bits, stream,
            compression=1 if bits == 8 else 2, palette=pal))
    index = rng.integers(0, 3, (20, 37)).astype(np.uint8)
    index[:, 5:30] = 1  # long runs
    pal = rng.integers(0, 256, (256, 4))
    _same(tmp_path / "r.bmp", bmp_file(37, 20, 8, bmp_rle8(index),
                                       compression=1, palette=pal))


def test_bmp_none_cases(tmp_path):
    """What cv2 gives None for: files cut in the header, the palette or the
    rows; compressions it does not read (JPEG, PNG in BMP); depths that
    do not match the compression; OS/2 signatures (BA, CI, CP, IC, PT),
    which no decoder of cv2's takes."""
    rng = np.random.default_rng(9)
    index = rng.integers(0, 256, (11, 13)).astype(np.uint8)
    good = bmp_file(13, 11, 8, bmp_rows(index, 8),
                    palette=rng.integers(0, 256, (256, 4)))
    assert _same(tmp_path / "g.bmp", good) is not None
    for cut in (10, 30, 60, 400, len(good) - 1):
        assert _same(tmp_path / "c.bmp", good[:cut]) is None
    for bpp, comp in ((24, 4), (24, 5), (8, 2), (4, 1), (24, 1), (16, 1)):
        assert _same(tmp_path / "b.bmp", bmp_file(
            13, 11, bpp, bytes(2000), compression=comp)) is None
    for sig in (b"BA", b"CI", b"CP", b"IC", b"PT"):
        path = tmp_path / "o.bmp"
        path.write_bytes(sig + good[2:])
        assert image_format(path) is None
        assert _same(path) is None


# -- PNM ----------------------------------------------------------------------

@pytest.mark.parametrize("maxval", [1, 15, 100, 255, 256, 1000, 65535])
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_pgm_ppm(tmp_path, maxval, binary):
    """P2/P5 and P3/P6 at maxvals below, at and above 255: binary 8-bit
    samples kept as they are, ASCII ones scaled by the maxval (and
    clipped to it), 16-bit ones keeping their high byte; a comment
    after the magic."""
    rng = np.random.default_rng(maxval + binary)
    for shape in ((5, 7), (6, 4, 3), (1, 1), (9, 17, 3)):
        top = maxval + (3 if not binary else 0)
        if binary and maxval < 256:
            top = 256
        samples = rng.integers(0, top, shape)
        _same(tmp_path / "x.pnm", pnm_file(samples, maxval, binary,
                                           comment=b"made here"))


def test_pbm_and_headers(tmp_path):
    """P1 (digits with and without separators) and P4 packed bits, 1
    black; headers with comments and tabs; what cv2 gives None for: a
    file cut short, a maxval of 0 or above 65535, a width of 0, a byte
    that is no digit, P7 read as PNM."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (5, 11))
    ascii_ = b"P1\n# c\n11 5\n" + b"\n".join(
        b"".join(b"%d" % v for v in row) for row in bits) + b"\n"
    _same(tmp_path / "a.pbm", ascii_)
    spaced = b"P1\t11\t5\n" + b" ".join(b"%d" % v for v in bits.ravel()) + \
        b"\n"
    _same(tmp_path / "b.pbm", spaced)
    packed = np.packbits(bits.astype(np.uint8), axis=1)
    _same(tmp_path / "c.pbm", b"P4\n11 5\n" + packed.tobytes())
    for data in (b"P5\n4 3\n0\n" + bytes(12), b"P5\n4 3\n70000\n" + bytes(24),
                 b"P5\n0 3\n255\n" + bytes(12), b"P5\n4 x3\n255\n" + bytes(12),
                 b"P5\n4 3\n255\n" + bytes(11), b"P2\n2 2\n255\n1 2 3",
                 b"P6 2 2 255\n" + bytes(11), b"P5\n4 3\n255"):
        assert _same(tmp_path / "n.pgm", data) is None
    path = tmp_path / "t.pgm"
    path.write_bytes(b"P5#c\n4 3\n255\n" + bytes(12))
    assert image_format(path) is None and _same(path) is None


# -- PAM ----------------------------------------------------------------------

@pytest.mark.parametrize("tupltype,depth", [
    (None, 1), (None, 3), ("BLACKANDWHITE", 1), ("GRAYSCALE", 1),
    ("GRAYSCALE_ALPHA", 2), ("RGB", 3), ("RGB_ALPHA", 4)])
@pytest.mark.parametrize("maxval", [1, 15, 255, 256, 65535])
def test_pam(tmp_path, tupltype, depth, maxval):
    """PAM as cv2 reads it: three channels copied as they lie (red and
    blue swapped), one repeated, 16-bit samples keeping their high byte, a
    maxval of 1 read as packed bits; with two or four channels only the
    first ceil(width / depth) pixels of a row are written by cv2 (the
    rest is its Mat's fresh memory), and only those are compared; no
    tuple type above 255 or of depth 2 or 4 gives None."""
    rng = np.random.default_rng(depth * 7 + maxval)
    for h, w in ((3, 10), (7, 33)):
        samples = rng.integers(0, maxval + 1, (h, w, depth))
        written = -(-w // depth) if depth in (2, 4) and maxval > 1 else None
        _same(tmp_path / "x.pam", pam_file(samples, maxval, tupltype),
              columns=written)


def test_pam_headers(tmp_path):
    """Comments, any field order; what cv2 gives None for: a tuple type
    that does not match the depth, an unknown one or field, a field
    twice, no ENDHDR, a number with trailing bytes, a space after P7, a
    file cut in its samples."""
    samples = np.arange(24).reshape(2, 4, 3)
    good = pam_file(samples, 255, "RGB")
    assert _same(tmp_path / "g.pam", good) is not None
    lines = good.split(b"\n")
    reordered = b"\n".join([lines[0], b"# c", lines[3], lines[1], lines[4],
                            lines[2]] + lines[5:])
    assert _same(tmp_path / "r.pam", reordered) is not None
    bad = [pam_file(samples, 255, "GRAYSCALE"),
           pam_file(samples, 255, "CMYK"),
           good.replace(b"WIDTH 4", b"WIDTH 4\nWIDTH 4"),
           good.replace(b"ENDHDR\n", b""),
           good.replace(b"WIDTH 4", b"WIDTH 4x"),
           good.replace(b"WIDTH 4", b"LENGTH 4"),
           b"P7 " + good[3:], good[:-1]]
    for data in bad:
        assert _same(tmp_path / "b.pam", data) is None


# -- the sniffing repairs -----------------------------------------------------

def test_pfm_and_radiance_hdr_sniffed_as_cv2(tmp_path):
    """A colour PFM ("PF") and a Radiance HDR whose header is ``#?RGBE``
    are sniffed as cv2 sniffs them and read as it reads them (they were
    refused by name before their decoders; earlier still they gave None);
    a gray PFM ("Pf") gives None, as imread's own check fails on it."""
    img = np.random.default_rng(0).random((20, 30, 3)).astype(np.float32)
    pfm = tmp_path / "x.pfm"
    assert cv2.imwrite(str(pfm), img)
    assert pfm.read_bytes()[:3] == b"PF\n" and _cv2_rgb(pfm) is not None
    assert image_format(pfm) == "PFM"
    _same(pfm)
    gray = tmp_path / "g.pfm"
    assert cv2.imwrite(str(gray), img[..., 0])
    assert gray.read_bytes()[:3] == b"Pf\n" and _cv2_rgb(gray) is None
    assert unsupported(gray) is None and read_image(gray) is None
    hdr = tmp_path / "x.hdr"
    assert cv2.imwrite(str(hdr), img)
    rgbe = tmp_path / "rgbe.hdr"
    rgbe.write_bytes(b"#?RGBE" + hdr.read_bytes()[len(b"#?RADIANCE"):])
    for path in (hdr, rgbe):
        assert _cv2_rgb(path) is not None
        assert image_format(path) == "Radiance HDR"
        _same(path)
