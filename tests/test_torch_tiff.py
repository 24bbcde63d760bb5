"""The port's TIFF reader (io/images.py read_image, native/tiff.cpp and
jpeg.cpp) against ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` on
files that PIL and tests/image_writers.py write here: byte-equal for no
compression, PackBits, LZW, Deflate, CCITT modified Huffman, T.4 and Group
4 and JPEG (compression 7), with and without predictor 2, in strips and
tiles, contiguous and planar, photometric 0-3, 5 (CMYK) and 6 (YCbCr) at
1, 8 and 16 bits, both byte orders, classic TIFF and BigTIFF, extra
samples, orientations and multi-page files (the first page); None where
cv2 gives None (LZMA, Zstd, WebP and the other codecs cv2's libtiff lacks,
floating-point samples and predictor); the compressions libtiff does not
know refused by name (test_torch_tiff_variants.py and
test_torch_tiff_damage.py: libtiff's other codecs, L*a*b*, damaged
strips)."""

import cv2
import numpy as np
import pytest
from PIL import Image

from ocr_inference_tpu_torch.io.images import (
    image_format, read_image, unsupported,
)
from tests.image_writers import (
    ccitt_2d, ispe_scaled_avif, jpeg_arith, layered_avif, old_style_lzw,
    screen_content_avif,
    sequence_avif, split_jpeg_tables, ten_bit_avif, write_tiff,
)

# (photometric, bits, samples per pixel)
KINDS = [(1, 8, 1), (0, 8, 1), (1, 1, 1), (0, 1, 1), (1, 16, 1),
         (0, 16, 1), (2, 8, 3), (2, 16, 3), (2, 8, 4), (3, 8, 1), (3, 4, 1),
         (3, 1, 1), (1, 8, 2)]
COMPRESSIONS = [1, 8, 32946, 32773]


def _cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _assert_same_as_cv2(path):
    want = _cv2_rgb(path)
    got = read_image(path)
    assert want is not None
    assert got is not None and got.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _kind_page(rng, phot, bits, spp, h, w, **kw):
    page = dict(samples=rng.randint(0, 1 << bits, (h, w, spp)), bits=bits,
                photometric=phot, **kw)
    if phot == 3:
        page["colormap"] = rng.randint(0, 65536, 3 << bits)
    if spp in (2, 4):
        page["extra_samples"] = [2]
    return page


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: "p%d-%db-%ds" % k)
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_strips_and_tiles(tmp_path, kind, compression):
    """Every kind in one strip, in strips of 3 rows and in 16x16 tiles,
    with and without the predictor, little- and big-endian. Tiled pages
    are 48 wide: see test_partial_tiles_of_16_bit_pixels."""
    rng = np.random.RandomState(compression + 7 * kind[1] + kind[0])
    path = tmp_path / "t.tif"
    for order in "<>":
        for layout in ({}, {"rows_per_strip": 3}, {"tile": (16, 16)}):
            for predictor in (1, 2) if kind[1] >= 8 else (1,):
                w = 48 if "tile" in layout else 45
                write_tiff(path, [_kind_page(rng, *kind, 37, w,
                                             compression=compression,
                                             predictor=predictor, **layout)],
                           order)
                assert image_format(path) == "TIFF"
                _assert_same_as_cv2(path)


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "I;16", "P", "LA",
                                  "1"])
@pytest.mark.parametrize("compression", ["tiff_lzw", "tiff_deflate",
                                         "tiff_adobe_deflate", "packbits",
                                         "raw"])
def test_pil_written(tmp_path, mode, compression):
    """PIL's libtiff writer, LZW included, with and without predictor 2."""
    rng = np.random.RandomState(len(mode))
    img = rng.randint(0, 256, (61, 83, 3)).astype(np.uint8)
    im = Image.fromarray(img)
    if mode == "I;16":
        im = Image.fromarray(img[..., 0].astype(np.uint16) * 257 + 3)
    elif mode != "RGB":
        im = im.convert(mode)
    path = tmp_path / "pil.tif"
    for tiffinfo in ({}, {317: 2}):
        if tiffinfo and (mode == "1" or compression in ("packbits", "raw")):
            continue
        im.save(path, compression=compression, tiffinfo=tiffinfo)
        _assert_same_as_cv2(path)


def _bitonal(h=300, w=517, seed=0):
    """Text-like bitonal structure: long runs and short ones."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    return (np.sin(x / 7.0) + np.cos(y / 5.0) + rng.rand(h, w) * 0.6) > 1.1


@pytest.mark.parametrize("compression,tiffinfo", [
    ("tiff_ccitt", {}), ("group3", {}), ("group3", {292: 1}),
    ("group3", {292: 4}), ("group3", {292: 5}), ("group4", {}),
])
@pytest.mark.parametrize("size", [(300, 517), (1, 1), (9, 1728),
                                  (40, 2600)])
def test_ccitt(tmp_path, compression, tiffinfo, size):
    """Modified Huffman, T.4 1-D and 2-D (with and without fill bits) and
    Group 4 as libtiff writes them, min-is-white; widths past one make-up
    code included."""
    ink = _bitonal(*size, seed=size[1])
    path = tmp_path / "fax.tif"
    Image.fromarray((~ink).astype(np.uint8) * 255).convert("1").save(
        path, compression=compression, tiffinfo=tiffinfo)
    assert Image.open(path).tag_v2[259] == {"tiff_ccitt": 2, "group3": 3,
                                            "group4": 4}[compression]
    _assert_same_as_cv2(path)
    got = read_image(path)
    np.testing.assert_array_equal(got[..., 0] == 0, ink)


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("tile", [None, (16, 16)])
def test_orientation(tmp_path, orientation, tile):
    """cv2 5.0 flips 2-4 (a tiled page tile column by tile column) and
    gives None for 5-8; so does the reader."""
    rng = np.random.RandomState(orientation)
    page = dict(samples=rng.randint(0, 256, (37, 45, 3)), bits=8,
                photometric=2, orientation=orientation)
    if tile:
        page["tile"] = tile
    path = tmp_path / "o.tif"
    write_tiff(path, [page])
    if orientation >= 5:
        assert _cv2_rgb(path) is None
        assert read_image(path) is None
    else:
        _assert_same_as_cv2(path)


@pytest.mark.parametrize("extra", [0, 1, 2])
@pytest.mark.parametrize("spp,phot", [(4, 2), (2, 1)])
def test_extra_samples(tmp_path, extra, spp, phot):
    """Unassociated alpha (2) is multiplied into RGB, then dropped, as
    libtiff's RGBA interface and cv2 do; associated (1) and unspecified
    (0) alpha are dropped."""
    rng = np.random.RandomState(extra)
    path = tmp_path / "a.tif"
    write_tiff(path, [dict(samples=rng.randint(0, 256, (23, 31, spp)),
                           bits=8, photometric=phot, extra_samples=[extra])])
    _assert_same_as_cv2(path)


def test_multi_page_reads_the_first(tmp_path):
    rng = np.random.RandomState(5)
    first = rng.randint(0, 256, (37, 45, 3))
    path = tmp_path / "m.tif"
    write_tiff(path, [dict(samples=first, bits=8, photometric=2),
                      dict(samples=rng.randint(0, 256, (20, 10, 1)), bits=8,
                           photometric=1)])
    _assert_same_as_cv2(path)
    np.testing.assert_array_equal(read_image(path), first)
    frames = [Image.fromarray(rng.randint(0, 256, (30, 40, 3), np.uint8))
              for _ in range(3)]
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   compression="tiff_lzw")
    _assert_same_as_cv2(path)


def test_fill_order_2(tmp_path):
    rng = np.random.RandomState(6)
    path = tmp_path / "f.tif"
    for compression in (1, 32773):
        write_tiff(path, [dict(samples=rng.randint(0, 2, (37, 45, 1)),
                               bits=1, photometric=0, fill_order=2,
                               compression=compression)])
        _assert_same_as_cv2(path)


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("phot", [0, 1])
def test_two_and_four_bit_gray_give_none_as_cv2(tmp_path, bits, phot):
    path = tmp_path / "g.tif"
    write_tiff(path, [dict(samples=np.random.RandomState(bits).randint(
        0, 1 << bits, (9, 13, 1)), bits=bits, photometric=phot)])
    assert _cv2_rgb(path) is None
    assert read_image(path) is None


@pytest.mark.parametrize("spp,phot", [(1, 1), (2, 1)])
def test_partial_tiles_of_16_bit_pixels(tmp_path, spp, phot):
    """A stated quirk: cv2 5.0 misreads the last, partial tile column of a
    tiled page whose pixels take 16 bits (16-bit gray, 8-bit gray + alpha).
    The reader gives the file's pixels there, and cv2's everywhere else."""
    rng = np.random.RandomState(spp)
    bits = 16 if spp == 1 else 8
    samples = rng.randint(0, 1 << bits, (37, 45, spp))
    path = tmp_path / "q.tif"
    write_tiff(path, [dict(samples=samples, bits=bits, photometric=phot,
                           tile=(16, 16), extra_samples=[0])])
    got = read_image(path)
    np.testing.assert_array_equal(got[..., 0], samples[..., 0] >> (bits - 8))
    np.testing.assert_array_equal(got[:, :32], _cv2_rgb(path)[:, :32])


def test_truncated_and_corrupt_files_give_none(tmp_path):
    rng = np.random.RandomState(8)
    path = tmp_path / "c.tif"
    Image.fromarray(rng.randint(0, 256, (40, 50, 3), np.uint8)).save(
        path, compression="tiff_lzw")
    data = path.read_bytes()
    for blob in (data[:6], b"II*\x00\xff\xff\xff\x7f"):
        path.write_bytes(blob)
        assert _cv2_rgb(path) is None
        assert read_image(path) is None


@pytest.mark.parametrize("save,name", [
    ({"compression": "jpeg"}, "JPEG-in-TIFF"),
    ({"tags": {284: 2}}, "planar"),
    ({"tags": {317: 3}}, "floating-point TIFF predictor"),
    ({"tags": {339: 3}}, "floating-point TIFF samples"),
    ({"photometric": 5}, "CMYK"),
    ({"photometric": 6}, "YCbCr"),
    ({"compression": 50000}, "Zstandard"),
])
def test_variants_refused_by_name(tmp_path, save, name):
    """These variants were refused by name; each now reads as cv2 reads
    it, or gives None where cv2 does: a 24x32 RGB page saved as
    JPEG-in-TIFF (PIL), planar, with the floating-point predictor on
    uncompressed data (libtiff ignores the tag there), with float samples
    (None), as CMYK and YCbCr (their defaults: InkSet 1, YCbCrSubsampling
    2x2 read as packed blocks) and Zstandard (None)."""
    rng = np.random.RandomState(9)
    path = tmp_path / "v.tif"
    img = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    if save.get("compression") == "jpeg":
        Image.fromarray(img).save(path, compression="jpeg")
    else:
        page = dict(samples=img, bits=8, photometric=save.get("photometric",
                                                              2),
                    tags=save.get("tags", {}))
        if "compression" in save:
            page["tags"] = {259: save["compression"]}
        write_tiff(path, [page])
    want = _cv2_rgb(path)
    if want is None:
        assert read_image(path) is None, name
        assert unsupported(path) is None, name
    else:
        _assert_same_as_cv2(path)


def test_bigtiff_and_other_formats_refused_by_name(tmp_path):
    """BigTIFF, once refused by name, reads as cv2 reads it (a header
    with no IFD gives None, as in cv2); BMP reads as cv2 reads it, and a
    JPEG 2000 signature box cut short gives None, as in cv2 (both were
    refused by name before the slice that decodes them); WebP reads as cv2
    reads it and a GIF header with no image gives None, as in cv2 (both
    were refused by name before the GIF and WebP slice); cv2's default
    AVIF reads as cv2 reads it, and one with screen-content tools stays
    refused by name."""
    path = tmp_path / "big.tif"
    path.write_bytes(b"II+\x00\x08\x00\x00\x00" + b"\x00" * 32)
    assert _cv2_rgb(path) is None and read_image(path) is None
    rng = np.random.RandomState(10)
    write_tiff(path, [dict(samples=rng.randint(0, 256, (21, 30, 3)), bits=8,
                           photometric=2, compression=8)], big=True)
    assert image_format(path) == "TIFF"
    _assert_same_as_cv2(path)
    img = np.zeros((8, 8, 3), np.uint8)
    path = tmp_path / "x.bmp"
    assert cv2.imwrite(str(path), img)
    assert image_format(path) == "BMP"
    _assert_same_as_cv2(path)
    path = tmp_path / "x.webp"
    assert cv2.imwrite(str(path), img)
    assert image_format(path) == "WebP"
    _assert_same_as_cv2(path)
    path = tmp_path / "x.jp2"
    path.write_bytes(b"\x00\x00\x00\x0cjP  \r\n" + b"\x00" * 32)
    assert _cv2_rgb(path) is None and read_image(path) is None
    path = tmp_path / "x.gif"
    path.write_bytes(b"GIF89a" + b"\x00" * 32)
    assert _cv2_rgb(path) is None and read_image(path) is None
    path = tmp_path / "x.avif"
    assert cv2.imwrite(str(path), img)
    assert image_format(path) == "AVIF"
    _assert_same_as_cv2(path)
    path = tmp_path / "screen.avif"
    screen_content_avif(path)
    _assert_same_as_cv2(path)
    path = tmp_path / "ten.avif"
    ten_bit_avif(path)
    _assert_same_as_cv2(path)
    path = tmp_path / "frames.avif"
    sequence_avif(path)
    _assert_same_as_cv2(path)
    path = tmp_path / "layered.avif"
    layered_avif(path)
    _assert_same_as_cv2(path)
    path = tmp_path / "scaled.avif"
    ispe_scaled_avif(path)
    with pytest.raises(NotImplementedError, match="ispe property differs"):
        read_image(path)


# -- BigTIFF -----------------------------------------------------------------

@pytest.mark.parametrize("kind", [(2, 8, 3), (1, 16, 1), (3, 8, 1),
                                  (0, 1, 1), (2, 8, 4)],
                         ids=lambda k: "p%d-%db-%ds" % k)
@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("layout", ["strips", "tiles", "planar"])
def test_bigtiff(tmp_path, kind, order, layout):
    """BigTIFF (version 43: 8-byte counts and offsets, 20-byte entries,
    strip and tile offsets as LONG8), both byte orders."""
    phot, bits, spp = kind
    rng = np.random.RandomState(bits + spp)
    page = _kind_page(rng, phot, bits, spp, 29, 48,
                      compression=32773 if bits == 1 else 8)
    page.update({"strips": {"rows_per_strip": 4},
                 "tiles": {"tile": (16, 16)},
                 "planar": {"planar": True, "rows_per_strip": 7}}[layout])
    path = tmp_path / "b.tif"
    write_tiff(path, [page], order, big=True)
    want = _cv2_rgb(path)
    if want is None:  # planar palette and 1-bit: libtiff cannot
        assert read_image(path) is None
    else:
        _assert_same_as_cv2(path)


# -- planar (PlanarConfiguration 2) ------------------------------------------

PLANAR_KINDS = [(2, 3, None), (2, 4, 2), (2, 4, 1), (2, 4, 0), (2, 4, None),
                (1, 2, 2), (1, 2, 0), (0, 2, 2), (1, 3, None)]


@pytest.mark.parametrize("kind", PLANAR_KINDS,
                         ids=lambda k: "p%d-%ds-x%s" % k)
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_planar(tmp_path, kind, bits, compression):
    """One plane of strips or tiles per sample, each through its codec
    and predictor 2 on its own, mapped by libtiff's separate-plane
    routines (putRGBseparate8bittile, ...16bittile and their alpha
    variants): 16-bit samples rounded as the contiguous path rounds them;
    gray planes are not inverted for min-is-white and take their alpha."""
    phot, spp, extra = kind
    rng = np.random.RandomState(bits * 7 + spp)
    path = tmp_path / "p.tif"
    for order in "<>":
        for layout in ({"rows_per_strip": 5}, {"tile": (16, 16)}):
            for predictor in (1, 2) if compression in (5, 8) else (1,):
                w = 40 if "tile" in layout else 37
                page = dict(samples=rng.randint(0, 1 << bits, (21, w, spp)),
                            bits=bits, photometric=phot, planar=True,
                            compression=compression, predictor=predictor,
                            **layout)
                if extra is not None:
                    page["extra_samples"] = [extra]
                write_tiff(path, [page], order)
                _assert_same_as_cv2(path)


# -- CMYK (photometric 5) ----------------------------------------------------

@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("planar", [False, True])
def test_cmyk(tmp_path, compression, planar):
    """8-bit CMYK, InkSet 1, contiguous and planar, strips and tiles:
    tif_getimage.c's integer k = 255 - K; r = k * (255 - C) / 255."""
    rng = np.random.RandomState(compression)
    path = tmp_path / "c.tif"
    for layout in ({}, {"rows_per_strip": 5}, {"tile": (16, 16)}):
        for predictor in (1, 2) if compression in (5, 8) else (1,):
            write_tiff(path, [dict(samples=rng.randint(0, 256, (21, 37, 4)),
                                   bits=8, photometric=5, planar=planar,
                                   compression=compression,
                                   predictor=predictor, **layout)])
            _assert_same_as_cv2(path)


def test_cmyk_pil_and_the_variants_cv2_gives_none(tmp_path):
    """PIL's CMYK TIFF (LZW); 16-bit CMYK, a fifth sample and other ink
    sets give None, as in cv2."""
    rng = np.random.RandomState(3)
    path = tmp_path / "c.tif"
    Image.fromarray(rng.randint(0, 256, (30, 40, 3)).astype(np.uint8)).convert(
        "CMYK").save(path, compression="tiff_lzw")
    _assert_same_as_cv2(path)
    for page in (dict(bits=16, samples=rng.randint(0, 65536, (9, 11, 4))),
                 dict(bits=8, samples=rng.randint(0, 256, (9, 11, 5))),
                 dict(bits=8, samples=rng.randint(0, 256, (9, 11, 4)),
                      tags={332: 2})):
        for planar in (False, True):
            write_tiff(path, [dict(page, photometric=5, planar=planar)])
            assert _cv2_rgb(path) is None
            assert read_image(path) is None


# -- YCbCr (photometric 6) without JPEG --------------------------------------

YCBCR_SAMPLING = [(1, 1), (2, 1), (2, 2), (4, 2), (4, 4), (1, 2), (4, 1)]


@pytest.mark.parametrize("sampling", YCBCR_SAMPLING,
                         ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("compression", [1, 5, 8])
@pytest.mark.parametrize("size", [(21, 37), (16, 32), (1, 1), (7, 5),
                                  (33, 45)])
def test_ycbcr(tmp_path, sampling, compression, size):
    """Packed YCbCr blocks of every subsampling libtiff's RGBA interface
    puts (putcontig8bitYCbCr{11,12,21,22,41,42,44}tile: each block's
    chroma repeated over its pixels), partial blocks at the right and
    bottom edges, in one strip, in strips of two block rows and in 16x16
    tiles (the 4x4 routine's skew over a clipped tile's blocks included)."""
    rng = np.random.RandomState(sum(sampling) * 31 + compression)
    path = tmp_path / "y.tif"
    for layout in ({}, {"rows_per_strip": sampling[1] * 2},
                   {"tile": (16, 16)}):
        write_tiff(path, [dict(samples=rng.randint(0, 256, size + (3,)),
                               bits=8, photometric=6, compression=compression,
                               ycbcr_subsampling=sampling, **layout)])
        _assert_same_as_cv2(path)


def _rationals(values):
    return (5, [(int(round(v * 1000)), 1000) for v in values])


@pytest.mark.parametrize("rbw", [[0, 255, 128, 255, 128, 255],
                                 [16, 235, 128, 240, 128, 240],
                                 [15.5, 235.25, 128, 240, 127, 241],
                                 [0, 0, 128, 128, 128, 128]])
@pytest.mark.parametrize("luma", [[0.299, 0.587, 0.114],
                                  [0.2126, 0.7152, 0.0722]])
def test_ycbcr_reference_and_coefficients(tmp_path, rbw, luma):
    """ReferenceBlackWhite and YCbCrCoefficients into tif_color.c's
    fixed-point tables, built from float arithmetic as libtiff builds them;
    absent tags (2x2 subsampling, the default references) and planar 1x1
    YCbCr (putseparate8bitYCbCr11tile) too; planar 2x2 gives None."""
    rng = np.random.RandomState(len(str(rbw)))
    path = tmp_path / "y.tif"
    tags = {532: _rationals(rbw), 529: _rationals(luma)}
    for sampling in ((1, 1), (2, 2)):
        write_tiff(path, [dict(samples=rng.randint(0, 256, (21, 37, 3)),
                               bits=8, photometric=6, tags=tags,
                               ycbcr_subsampling=sampling)])
        _assert_same_as_cv2(path)
    write_tiff(path, [dict(samples=rng.randint(0, 256, (21, 37, 3)), bits=8,
                           photometric=6, planar=True,
                           tags={**tags, 530: (3, [1, 1])})])
    _assert_same_as_cv2(path)
    write_tiff(path, [dict(samples=rng.randint(0, 256, (21, 37, 3)), bits=8,
                           photometric=6, planar=True, tags=tags)])
    assert _cv2_rgb(path) is None and read_image(path) is None
    write_tiff(path, [dict(samples=rng.randint(0, 256, (21, 37, 3)), bits=8,
                           photometric=6, ycbcr_subsampling=(2, 2),
                           subsampling_tag=False)])
    _assert_same_as_cv2(path)


@pytest.mark.parametrize("rbw", [[0, 255, 128, 255, 128, 255],
                                 [16, 235, 128, 240, 128, 240]])
def test_ycbcr_every_code(tmp_path, rbw):
    """Every (Y, Cb, Cr) of 256^3 at 4:4:4 against cv2, in four
    2048x2048 pages."""
    path = tmp_path / "all.tif"
    for part in range(4):
        v = np.arange(part << 22, (part + 1) << 22)
        samples = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1)
        write_tiff(path, [dict(samples=samples.reshape(2048, 2048, 3), bits=8,
                               photometric=6, ycbcr_subsampling=(1, 1),
                               rows_per_strip=256,
                               tags={532: _rationals(rbw)})])
        _assert_same_as_cv2(path)


# -- JPEG-in-TIFF (compression 7) --------------------------------------------

SAMPLING_FACTORS = {(1, 1): 0x111111, (2, 1): 0x211111, (2, 2): 0x221111,
                    (1, 2): 0x121111, (4, 1): 0x411111}


def _smooth_page(rng, h, w, gray=False):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(x / 7.0) * 90 + 128, np.cos(y / 5.0) * 90 + 128,
                    (x * 3 + y * 5) % 256], -1) + rng.randint(-40, 40,
                                                              (h, w, 3))
    img = img.clip(0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def _jpeg(img, sampling=(2, 2), progressive=0):
    ok, data = cv2.imencode(".jpg", img[..., ::-1] if img.ndim == 3 else img,
                            [cv2.IMWRITE_JPEG_QUALITY, 90,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                             SAMPLING_FACTORS[sampling],
                             cv2.IMWRITE_JPEG_PROGRESSIVE, progressive])
    assert ok
    return data.tobytes()


def _jpeg_chunks(img, layout, **kw):
    """One JPEG stream per strip (16 rows; "strip1": one strip) or 16x16
    tile of img, and the write_tiff layout."""
    h, w = img.shape[:2]
    if layout == "tiles":
        padded = np.zeros((-(-h // 16) * 16, -(-w // 16) * 16)
                          + img.shape[2:], np.uint8)
        padded[:h, :w] = img
        return [_jpeg(padded[y: y + 16, x: x + 16], **kw)
                for y in range(0, padded.shape[0], 16)
                for x in range(0, padded.shape[1], 16)], {"tile": (16, 16)}
    rps = h if layout == "strip1" else 16
    return [_jpeg(img[y: y + rps], **kw) for y in range(0, h, rps)], \
        {"rows_per_strip": rps}


@pytest.mark.parametrize("mode", ["RGB", "L", "CMYK", "YCbCr"])
@pytest.mark.parametrize("size", [(61, 83), (300, 200)])
def test_jpeg_in_tiff_pil(tmp_path, mode, size):
    """PIL's JPEG-in-TIFF (libtiff's writer: JPEGTables and abbreviated
    strips; RGB as photometric YCbCr, gray, CMYK)."""
    rng = np.random.RandomState(size[0])
    path = tmp_path / "j.tif"
    im = Image.fromarray(_smooth_page(rng, *size)).convert(mode)
    for quality in (50, 90):
        im.save(path, compression="jpeg", quality=quality)
        assert Image.open(path).tag_v2[259] == 7
        _assert_same_as_cv2(path)


@pytest.mark.parametrize("sampling", list(SAMPLING_FACTORS),
                         ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("layout", ["strip1", "strips", "tiles"])
@pytest.mark.parametrize("tables", [False, True])
@pytest.mark.parametrize("progressive", [0, 1])
def test_jpeg_in_tiff_ycbcr(tmp_path, sampling, layout, tables, progressive):
    """The YCbCr layout scanners write: cv2-encoded JPEG streams wrapped
    as strips or tiles with photometric 6 and their YCbCrSubsampling, the
    tables in each stream or in tag 347 (each strip then keeps its own
    later tables, and the page's decompressor carries them on). libtiff
    has libjpeg turn YCbCr into RGB after its fancy upsampling; each strip
    is its own stream. At 4:4:4 the same streams as photometric RGB are
    read with no colour conversion at all."""
    rng = np.random.RandomState(sampling[0] * 3 + sampling[1])
    path = tmp_path / "j.tif"
    for size in ((37, 45), (64, 80), (16, 16)):
        img = _smooth_page(rng, *size)
        chunks, lay = _jpeg_chunks(img, layout, sampling=sampling,
                                   progressive=progressive)
        tags = {530: (3, list(sampling))}
        if tables:
            parts = [split_jpeg_tables(c) for c in chunks]
            tags[347] = (7, parts[0][0])
            chunks = [p[1] for p in parts]
        write_tiff(path, [dict(samples=img, bits=8, photometric=6,
                               compression=7, chunks=chunks, tags=tags,
                               **lay)])
        _assert_same_as_cv2(path)
        if sampling == (1, 1):
            del tags[530]
            write_tiff(path, [dict(samples=img, bits=8, photometric=2,
                                   compression=7, chunks=chunks, tags=tags,
                                   **lay)])
            _assert_same_as_cv2(path)


def test_jpeg_in_tiff_gray_subsampling_and_short_strips(tmp_path):
    """Gray streams in strips and in tiles; YCbCrSubsampling absent (libtiff
    takes the stream's), equal to the stream's, or not (None); a last strip
    whose stream holds the full RowsPerStrip (libtiff cuts it)."""
    rng = np.random.RandomState(12)
    path = tmp_path / "j.tif"
    gray = _smooth_page(rng, 37, 45, gray=True)
    for layout in ("strips", "tiles"):
        chunks, lay = _jpeg_chunks(gray, layout)
        write_tiff(path, [dict(samples=gray, bits=8, photometric=1,
                               compression=7, chunks=chunks, **lay)])
        _assert_same_as_cv2(path)
    img = _smooth_page(rng, 37, 45)
    for tag in (None, (2, 2), (1, 1), (2, 1)):
        tags = {} if tag is None else {530: (3, list(tag))}
        write_tiff(path, [dict(samples=img, bits=8, photometric=6,
                               compression=7, chunks=[_jpeg(img)],
                               tags=tags)])
        if tag in (None, (2, 2)):
            _assert_same_as_cv2(path)
        else:
            assert _cv2_rgb(path) is None and read_image(path) is None
    padded = np.zeros((48, 45, 3), np.uint8)
    padded[:37] = img
    write_tiff(path, [dict(samples=img, bits=8, photometric=6, compression=7,
                           rows_per_strip=16, tags={530: (3, [2, 2])},
                           chunks=[_jpeg(padded[y: y + 16])
                                   for y in range(0, 48, 16)])])
    _assert_same_as_cv2(path)


@pytest.mark.parametrize("tables", [b"\xff\xd8\xff\xc0\x00\x11garbage", b"xx"])
@pytest.mark.parametrize("tagged", [False, True])
def test_jpeg_in_tiff_bogus_tables_give_none(tmp_path, tables, tagged):
    """A JPEGTables field libjpeg cannot read as tables ("Bogus JPEGTables
    field"): None, as cv2, with or without YCbCrSubsampling (without it
    libtiff reads the first strip's sampling through those tables)."""
    img = _smooth_page(np.random.RandomState(15), 16, 16)
    tags = {347: (7, tables)}
    if tagged:
        tags[530] = (3, [2, 2])
    path = tmp_path / "b.tif"
    write_tiff(path, [dict(samples=img, bits=8, photometric=6, compression=7,
                           chunks=[_jpeg(img)], tags=tags)])
    assert _cv2_rgb(path) is None
    assert read_image(path) is None and unsupported(path) is None


# -- what cv2 gives None for, and what stays refused ------------------------

@pytest.mark.parametrize("compression", [6, 32909, 34661, 34887, 34925,
                                         50000, 50001])
def test_codecs_cv2_lacks_give_none(tmp_path, compression):
    """Old-style JPEG, PixarLog, JBIG, LERC, LZMA, Zstandard and WebP:
    cv2's libtiff was built without them, so cv2.imread gives None; so
    does the reader, and unsupported() lets the CLIs go on."""
    rng = np.random.RandomState(compression)
    path = tmp_path / "n.tif"
    for spp, phot in ((3, 2), (1, 1)):
        write_tiff(path, [dict(samples=rng.randint(0, 256, (9, 13, spp)),
                               bits=8, photometric=phot,
                               tags={259: compression})])
        assert _cv2_rgb(path) is None
        assert read_image(path) is None
        assert unsupported(path) is None


def test_float_samples_and_predictor_give_none(tmp_path):
    """Float samples (cv2.imwrite's float32 and float64 TIFF, SampleFormat 3
    at 16 bits, SampleFormat 4), 32-bit integers, and the floating-point
    predictor under LZW or Deflate: None, as cv2; under no compression
    libtiff ignores the predictor tag and the page reads."""
    rng = np.random.RandomState(13)
    path = tmp_path / "f.tif"
    for dtype in (np.float32, np.float64, np.int32):
        assert cv2.imwrite(str(path), (rng.rand(20, 30, 3) * 100).astype(dtype))
        assert _cv2_rgb(path) is None
        assert read_image(path) is None and unsupported(path) is None
    img = rng.randint(0, 256, (9, 13, 3))
    for bits, fmt in ((16, 3), (8, 4), (8, 3)):
        write_tiff(path, [dict(samples=img, bits=bits, photometric=2,
                               tags={339: fmt})])
        assert _cv2_rgb(path) is None and read_image(path) is None
    for compression in (5, 8):
        for predictor in (3, 4):
            write_tiff(path, [dict(samples=img, bits=8, photometric=2,
                                   compression=compression,
                                   predictor=predictor)])
            assert _cv2_rgb(path) is None and read_image(path) is None
    write_tiff(path, [dict(samples=img, bits=8, photometric=2, predictor=3)])
    _assert_same_as_cv2(path)


@pytest.mark.parametrize("photometric", [4, 7, 9, 10, 32844, 32845])
def test_photometrics_libtiff_cannot_map_give_none(tmp_path, photometric):
    """A transparency mask, ICC and ITU L*a*b*, and SGI LogL/LogLuv without
    their SGILog compression: libtiff's RGBA interface cannot map them,
    and cv2 gives None; so does the reader (CIE L*a*b*, which it maps, is
    read in test_other_once_refused_variants)."""
    path = tmp_path / "p.tif"
    write_tiff(path, [dict(samples=np.zeros((9, 13, 3)), bits=8,
                           photometric=photometric)])
    assert _cv2_rgb(path) is None
    assert read_image(path) is None and unsupported(path) is None


@pytest.mark.parametrize("compression,name", [
    (32766, "NeXT"), (32771, "RLE-W"), (32809, "ThunderScan"),
    (34676, "LogLuv"), (34712, "JPEG 2000"), (50002, "TIFF compression"),
    (99, "TIFF compression 99"),
])
def test_codecs_once_or_still_refused_by_name(tmp_path, compression, name):
    """libtiff's NeXT, RLE-W, ThunderScan and SGI Log codecs were refused
    by name: on an 8-bit RGB page, which none of them can code, cv2 gives
    None and so does the reader (test_torch_tiff_variants.py has pages
    made for each). A compression libtiff does not know (JPEG 2000 in
    TIFF, JPEG XL, ...) gives cv2 an all-zero page: still refused by
    name, in read_image and unsupported() alike."""
    path = tmp_path / "r.tif"
    write_tiff(path, [dict(samples=np.zeros((9, 13, 3)), bits=8,
                           photometric=2, tags={259: compression})])
    if compression in (32766, 32771, 32809, 34676):
        assert _cv2_rgb(path) is None
        assert read_image(path) is None and unsupported(path) is None
        return
    with pytest.raises(NotImplementedError, match=name):
        read_image(path)
    assert name in unsupported(path)


def test_other_once_refused_variants(tmp_path):
    """CIE L*a*b* pages, old-style LZW and arithmetic-coded JPEG strips,
    once refused by name, read as cv2 reads them; unsupported() names
    none of them."""
    rng = np.random.RandomState(14)
    img = _smooth_page(rng, 16, 16)
    planes = [img[..., c].astype(float) for c in range(3)]
    gray = rng.randint(0, 256, (9, 13)).astype(np.uint8)
    cases = {
        "L*a*b*": dict(samples=rng.randint(0, 256, (9, 13, 3)), bits=8,
                       photometric=8),
        "old-style": dict(samples=gray[..., None], bits=8, photometric=1,
                          compression=5,
                          chunks=[old_style_lzw(gray.tobytes())]),
        "arithmetic": dict(samples=img, bits=8, photometric=6, compression=7,
                           chunks=[jpeg_arith(
                               [planes[0], planes[1][::2, ::2],
                                planes[2][::2, ::2]],
                               [(2, 2), (1, 1), (1, 1)])],
                           tags={530: (3, [2, 2])}),
    }
    path = tmp_path / "r.tif"
    for name, page in cases.items():
        write_tiff(path, [page])
        _assert_same_as_cv2(path)
        assert unsupported(path) is None, name


@pytest.mark.parametrize("first", [77, 3, 201, 254])
def test_old_style_lzw(tmp_path, first):
    """An old-style LZW strip is told as libtiff's LZWPreDecode tells it
    (byte 0 zero, bit 0 of byte 1 set), whatever the first code's low
    bits put in byte 1 (first pixel 77: bytes 00 9b), and decoded as
    LZWDecodeCompat decodes it, byte-equal with cv2; a page past 512
    codes crosses the width steps."""
    rng = np.random.RandomState(first)
    gray = rng.randint(0, 256, (8, 10)).astype(np.uint8)
    gray[0, 0] = first
    strip = old_style_lzw(gray.tobytes())
    assert strip[0] == 0 and strip[1] & 1
    path = tmp_path / "old.tif"
    write_tiff(path, [dict(samples=gray[..., None], bits=8, photometric=1,
                           compression=5, chunks=[strip])])
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(want, gray)
    _assert_same_as_cv2(path)
    assert unsupported(path) is None
    big = (np.add.outer(np.arange(90), np.arange(120)) * first % 256
           ^ rng.randint(0, 2, (90, 120))).astype(np.uint8)
    write_tiff(path, [dict(samples=big[..., None], bits=8, photometric=1,
                           compression=5,
                           chunks=[old_style_lzw(big.tobytes())])])
    np.testing.assert_array_equal(read_image(path)[..., 0], big)
    _assert_same_as_cv2(path)


@pytest.mark.parametrize("size", [(40, 70), (64, 96)])
def test_group4_that_allows_uncompressed_mode(tmp_path, size):
    """T6Options bit 1 only allows uncompressed mode: PIL's Group 4 strip
    of a random page, rewritten with tag 293 = 2 and no extension code in
    it, reads as any Group 4 page, byte-equal with cv2."""
    ink = np.random.RandomState(size[1]).rand(*size) < 0.3
    pil = tmp_path / "pil.tif"
    Image.fromarray((~ink).astype(np.uint8) * 255).convert("1").save(
        pil, compression="group4")
    tags = Image.open(pil).tag_v2
    raw = pil.read_bytes()
    strips = [raw[o: o + n] for o, n in zip(tags[273], tags[279])]
    path = tmp_path / "g4.tif"
    write_tiff(path, [dict(samples=np.zeros(size + (1,), np.uint8), bits=1,
                           photometric=tags[262], compression=4,
                           chunks=strips, rows_per_strip=tags[278],
                           fill_order=tags.get(266, 1), tags={293: 2})])
    assert unsupported(path) is None
    _assert_same_as_cv2(path)
    np.testing.assert_array_equal(read_image(path)[..., 0] == 0, ink)


@pytest.mark.parametrize("compression", [3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ccitt_extension_code(tmp_path, compression, seed):
    """A 2-D row that holds an extension code (uncompressed mode, which
    libtiff reports and does not decode) ends there as libtiff's EXPAND2D
    ends it, after vertical, horizontal and pass modes alike; the next
    row follows the code's 7 bits (Group 4) or the next EOL (Group 3).
    Equal to cv2, with a warning."""
    rng = np.random.RandomState(seed)
    h, w = 12, int(rng.randint(9, 40))
    ink = rng.rand(h, w) < 0.35
    ext = {int(y): int(rng.randint(0, 6))
           for y in rng.choice(h, 3, replace=False)}
    path = tmp_path / "ext.tif"
    write_tiff(path, [dict(samples=np.zeros((h, w, 1), np.uint8), bits=1,
                           photometric=0, compression=compression,
                           chunks=[ccitt_2d(ink, compression, ext)],
                           tags={292 if compression == 3 else 293:
                                 1 if compression == 3 else 2})])
    with pytest.warns(UserWarning, match="extension"):
        _assert_same_as_cv2(path)
