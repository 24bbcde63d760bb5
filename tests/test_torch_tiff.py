"""The port's TIFF reader (io/images.py read_image, native/tiff.cpp)
against ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` on files that
PIL and tests/image_writers.py write here: byte-equal for no compression,
PackBits, LZW, Deflate and CCITT modified Huffman, T.4 and Group 4, with
and without predictor 2, in strips and tiles, photometric 0-3 at 1, 8 and
16 bits, both byte orders, extra samples, orientations and multi-page
files (the first page); None where cv2 gives None; the variants it does
not decode refused by name."""

import cv2
import numpy as np
import pytest
from PIL import Image

from ocr_inference_tpu_torch.io.images import image_format, read_image
from tests.image_writers import write_tiff

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
    with pytest.raises(NotImplementedError, match=name):
        read_image(path)


def test_bigtiff_and_other_formats_refused_by_name(tmp_path):
    path = tmp_path / "big.tif"
    path.write_bytes(b"II+\x00\x08\x00\x00\x00" + b"\x00" * 32)
    with pytest.raises(NotImplementedError, match="BigTIFF"):
        read_image(path)
    img = np.zeros((8, 8, 3), np.uint8)
    for ext, name in ((".bmp", "BMP"), (".webp", "WebP")):
        path = tmp_path / f"x{ext}"
        assert cv2.imwrite(str(path), img)
        with pytest.raises(NotImplementedError, match=name):
            read_image(path)
    for ext, head, name in ((".jp2", b"\x00\x00\x00\x0cjP  \r\n", "JPEG 2000"),
                            (".gif", b"GIF89a", "GIF")):
        path = tmp_path / f"x{ext}"
        path.write_bytes(head + b"\x00" * 32)
        with pytest.raises(NotImplementedError, match=name):
            read_image(path)
