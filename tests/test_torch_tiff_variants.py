"""The TIFF variants once refused by name (io/images.py read_image,
native/tiff.cpp) against ``cv2.cvtColor(cv2.imread(path),
cv2.COLOR_BGR2RGB)``, on pages written by tests/image_writers.py: old-style
LZW, CCITT RLE-W, ThunderScan, NeXT, SGI LogL and LogLuv (32- and 24-bit)
and CIE L*a*b* (8 and 16 bits, with and without a WhitePoint), intact and
damaged; byte-equal with cv2, or None where cv2 gives None (NeXT pages are
2-bit, which cv2 5.0 does not read; so are 4-bit gray ThunderScan
pages), and unsupported() names none of them."""

import cv2
import numpy as np
import pytest
from PIL import Image

from ocr_inference_tpu_torch.io.images import read_image, unsupported
from tests.image_writers import (
    modified_huffman, next_2bit, old_style_lzw, sgilog, sgilog24,
    thunderscan, write_tiff,
)
from tests.test_torch_tiff_damage import REVERSED, _fuzz

pytestmark = pytest.mark.filterwarnings("ignore:CCITT data damaged")


def _cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _assert_as_cv2(path, none=False):
    """read_image(path) equal to cv2 (None with it when ``none``), and
    unsupported() naming nothing."""
    want = _cv2_rgb(path)
    got = read_image(path)
    assert unsupported(path) is None
    if none:
        assert want is None and got is None
        return
    assert want is not None and got is not None
    np.testing.assert_array_equal(got, want)


SIZES = [(1, 1), (7, 13), (24, 61), (40, 130)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("fill_order", [1, 2])
@pytest.mark.parametrize("odd", [False, True])
def test_rle_w(tmp_path, size, fill_order, odd):
    """CCITT RLE-W (32771): modified Huffman rows aligned to 16 bits, read
    as tif_fax3.c Fax3DecodeRLE reads them with FAXMODE_WORDALIGN (the
    alignment is of the mapped file's addresses: an odd strip offset moves
    it), in strips of 5 rows."""
    rng = np.random.RandomState(size[1] + fill_order)
    ink = rng.rand(*size) < 0.4
    chunks = [modified_huffman(ink[y: y + 5], 16)
              for y in range(0, size[0], 5)]
    if fill_order == 2:
        chunks = [REVERSED[np.frombuffer(c, np.uint8)].tobytes()
                  for c in chunks]
    path = tmp_path / "rlew.tif"
    write_tiff(path, [dict(samples=ink[..., None].astype(np.uint8), bits=1,
                           photometric=0, compression=32771, chunks=chunks,
                           rows_per_strip=5, fill_order=fill_order,
                           odd_offsets=odd)])
    _assert_as_cv2(path)


def test_rle_w_and_modified_huffman_damaged(tmp_path):
    """300 seeded corruptions and truncations each of RLE-W and of
    modified Huffman strips written here (with make-up codes)."""
    ink = np.random.RandomState(5).rand(40, 200) < 0.3
    ink[:, 60:140] = True
    for comp, align in ((32771, 16), (2, 8)):
        chunks = [modified_huffman(ink[y: y + 8], align)
                  for y in range(0, 40, 8)]

        def page(cs):
            return dict(samples=np.zeros((40, 200, 1), np.uint8), bits=1,
                        photometric=0, compression=comp, chunks=cs,
                        rows_per_strip=8)

        path = tmp_path / "mh.tif"
        write_tiff(path, [page(chunks)])
        _assert_as_cv2(path)
        if comp == 2:  # (libtiff's RLE-W reads a row that leaves 16 or
            # more bits in its buffer from the next byte, not word)
            np.testing.assert_array_equal(read_image(path)[..., 0] == 0,
                                          ink)
        assert _fuzz(tmp_path, page, chunks, 300, seed=comp) == []


@pytest.mark.parametrize("size", SIZES)
def test_thunderscan(tmp_path, size):
    """ThunderScan 4-bit (32809) palette pages, each row coded with raw
    pixels, runs and 2- and 3-bit deltas, in strips of 4 rows: as
    tif_thunder.c decodes them; 4-bit gray gives None, as cv2."""
    rng = np.random.RandomState(size[0])
    smooth = (np.add.outer(np.arange(size[0]) // 3, np.arange(size[1]) // 5)
              % 16)
    samples = np.where(rng.rand(*size) < 0.3, rng.randint(0, 16, size),
                       smooth)
    chunks = [thunderscan(samples[y: y + 4]) for y in range(0, size[0], 4)]
    path = tmp_path / "t.tif"
    cmap = rng.randint(0, 65536, 48)
    for phot in (3, 1):
        write_tiff(path, [dict(samples=samples[..., None], bits=4,
                               photometric=phot, compression=32809,
                               chunks=chunks, rows_per_strip=4,
                               colormap=cmap)])
        _assert_as_cv2(path, none=phot == 1)
    pal = (cmap.reshape(3, 16) >> 8).T.astype(np.uint8)
    write_tiff(path, [dict(samples=samples[..., None], bits=4, photometric=3,
                           compression=32809, chunks=chunks,
                           rows_per_strip=4, colormap=cmap)])
    np.testing.assert_array_equal(read_image(path), pal[samples])


def test_thunderscan_damaged(tmp_path):
    """300 seeded corruptions and truncations of ThunderScan strips: a row
    whose codes give too few or too many pixels is zeroed from where it
    stopped, and its strip ends there."""
    rng = np.random.RandomState(9)
    samples = (np.add.outer(np.arange(30), np.arange(45)) // 4 % 16)
    samples[rng.rand(30, 45) < 0.2] = 7
    chunks = [thunderscan(samples[y: y + 6]) for y in range(0, 30, 6)]
    cmap = rng.randint(0, 65536, 48)

    def page(cs):
        return dict(samples=samples[..., None], bits=4, photometric=3,
                    compression=32809, chunks=cs, rows_per_strip=6,
                    colormap=cmap)

    assert _fuzz(tmp_path, page, chunks, 300, seed=3) == []


@pytest.mark.parametrize("photometric", [0, 1, 3])
def test_next_pages_give_none(tmp_path, photometric):
    """NeXT 2-bit RLE (32766) is 2-bit only, and cv2 5.0 reads no 2-bit
    page (gray or palette): None, as cv2, and not refused by name; a
    2-bit palette page of no compression gives None too."""
    rng = np.random.RandomState(photometric)
    samples = rng.randint(0, 4, (12, 37))
    path = tmp_path / "n.tif"
    write_tiff(path, [dict(samples=samples[..., None], bits=2,
                           photometric=photometric, compression=32766,
                           chunks=[next_2bit(samples)],
                           colormap=rng.randint(0, 65536, 12))])
    _assert_as_cv2(path, none=True)
    write_tiff(path, [dict(samples=samples[..., None], bits=2,
                           photometric=photometric,
                           colormap=rng.randint(0, 65536, 12))])
    _assert_as_cv2(path, none=True)


def _xyz(rng, h, w):
    y = np.exp(rng.uniform(-12, 2, (h, w)))
    x = y * rng.uniform(0.3, 1.6, (h, w))
    z = y * rng.uniform(0.2, 1.8, (h, w))
    return np.stack([x, y, z], -1)


@pytest.mark.parametrize("kind", ["logl", "logluv", "logluv24"])
@pytest.mark.parametrize("rows_per_strip", [1, 5])
def test_sgi_log(tmp_path, kind, rows_per_strip):
    """SGI LogL (34676 over photometric 32844) and LogLuv, 32-bit (34676)
    and 24-bit (34677, libtiff's uv cell table) over 32845: tif_luv.c's
    run-length rows turned into 8-bit gray or RGB as the RGBA interface
    asks (L16toGry, Luv32toRGB, Luv24toRGB), every luminance code and
    colour index included (negative, zero, out of the table)."""
    rng = np.random.RandomState(len(kind) + rows_per_strip)
    h, w = 23, 37
    if kind == "logl":
        rows = sgilog(np.exp(rng.uniform(-20, 4, (h, w)))
                      * rng.choice([1, -1, 0], (h, w)), False)
        phot, comp, spp = 32844, 34676, 1
    elif kind == "logluv":
        rows = sgilog(_xyz(rng, h, w), True)
        phot, comp, spp = 32845, 34676, 3
    else:
        codes = (rng.randint(0, 1024, (h, w)) << 14) | rng.randint(
            0, 16384, (h, w))
        codes[0, :4] = [0, 1 << 14, (1023 << 14) | 16288,
                        (512 << 14) | 16289]
        rows = sgilog24(codes)
        phot, comp, spp = 32845, 34677, 3
    chunks = [b"".join(rows[y: y + rows_per_strip])
              for y in range(0, h, rows_per_strip)]
    path = tmp_path / "log.tif"
    write_tiff(path, [dict(samples=np.zeros((h, w, spp)), bits=16,
                           photometric=phot, compression=comp, chunks=chunks,
                           rows_per_strip=rows_per_strip)])
    _assert_as_cv2(path)


def test_sgi_log_damaged_and_misfits(tmp_path):
    """200 seeded corruptions and truncations of LogL and LogLuv strips
    (a row whose data runs out stays zero and ends its strip); LogL over
    the 24-bit codec and LogLuv of one sample give None, as cv2."""
    rng = np.random.RandomState(4)
    h, w = 20, 31
    for phot, comp, spp, rows in (
            (32844, 34676, 1, sgilog(np.exp(rng.uniform(-9, 1, (h, w))),
                                     False)),
            (32845, 34676, 3, sgilog(_xyz(rng, h, w), True))):
        chunks = [b"".join(rows[y: y + 4]) for y in range(0, h, 4)]

        def page(cs):
            return dict(samples=np.zeros((h, w, spp)), bits=16,
                        photometric=phot, compression=comp, chunks=cs,
                        rows_per_strip=4)

        assert _fuzz(tmp_path, page, chunks, 200, seed=phot) == []
    path = tmp_path / "x.tif"
    for phot, comp, spp in ((32844, 34677, 1), (32845, 34676, 1)):
        write_tiff(path, [dict(samples=np.zeros((h, w, spp)), bits=16,
                               photometric=phot, compression=comp,
                               chunks=[bytes(100)])])
        _assert_as_cv2(path, none=True)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("white", [None, ((3127, 10000), (3290, 10000)),
                                   ((1, 3), (1, 3))])
@pytest.mark.parametrize("compression", [1, 5])
def test_cielab(tmp_path, bits, white, compression):
    """CIE L*a*b* (photometric 8) at 8 and 16 bits, every L, a and b code
    at 8 bits: through XYZ to sRGB as tif_color.c computes it in float,
    with the WhitePoint tag (D65, equal energy) or D50 without it."""
    rng = np.random.RandomState(bits + (white is None))
    if bits == 8:
        codes = np.arange(256)
        lab = np.stack(np.meshgrid(codes, codes, codes[::5], indexing="ij"),
                       -1).reshape(-1, 3)
        lab = lab[rng.permutation(len(lab))[:128 * 130]].reshape(128, 130, 3)
    else:
        lab = rng.randint(0, 65536, (40, 50, 3))
    tags = {} if white is None else {318: (5, list(white))}
    path = tmp_path / "lab.tif"
    write_tiff(path, [dict(samples=lab, bits=bits, photometric=8,
                           compression=compression, rows_per_strip=16,
                           tags=tags)])
    _assert_as_cv2(path)


def test_cielab_pil_and_layouts_libtiff_cannot_map(tmp_path):
    """PIL's LAB TIFF reads as cv2 reads it; L*a*b* with an alpha sample,
    planar, or at 4 bits gives None, as cv2."""
    rng = np.random.RandomState(2)
    lab = rng.randint(0, 256, (19, 23, 3)).astype(np.uint8)
    path = tmp_path / "lab.tif"
    Image.fromarray(lab, "LAB").save(path)
    _assert_as_cv2(path)
    for page in (dict(samples=np.dstack([lab, lab[..., :1]]), bits=8,
                      extra_samples=[2]),
                 dict(samples=lab, bits=8, planar=True),
                 dict(samples=lab >> 4, bits=4)):
        write_tiff(path, [dict(photometric=8, **page)])
        _assert_as_cv2(path, none=True)


@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("predictor", [1, 2])
def test_old_style_lzw_pages(tmp_path, layout, predictor):
    """Old-style LZW pages of several strips or tiles (past the width
    steps and a clear), with and without the predictor, intact and with
    300 seeded corruptions and truncations; once the first strip is
    old-style, libtiff decodes every strip so."""
    rng = np.random.RandomState(predictor)
    y, x = np.mgrid[0:64, 0:80]
    img = np.stack([(x * 3 + y) % 256, (y * 5) % 256, (x ^ y) % 256],
                   -1).astype(np.uint8)
    img[rng.rand(64, 80) < 0.2] = 9
    from tests.image_writers import _difference, _raw_rows

    def block(part):
        raw = _raw_rows(_difference(part) if predictor == 2 else part, 8,
                        "<")
        return old_style_lzw(raw.tobytes())

    if layout == "tiles":
        pad = np.zeros((64, 96, 3), np.uint8)
        pad[:, :80] = img
        chunks = [block(pad[yy: yy + 32, xx: xx + 32])
                  for yy in range(0, 64, 32) for xx in range(0, 96, 32)]
        shape = {"tile": (32, 32)}
    else:
        chunks = [block(img[yy: yy + 16]) for yy in range(0, 64, 16)]
        shape = {"rows_per_strip": 16}

    def page(cs):
        return dict(samples=img, bits=8, photometric=2, compression=5,
                    predictor=predictor, chunks=cs, **shape)

    path = tmp_path / "old.tif"
    write_tiff(path, [page(chunks)])
    np.testing.assert_array_equal(read_image(path), img)
    _assert_as_cv2(path)
    assert _fuzz(tmp_path, page, chunks, 300, seed=predictor) == []
