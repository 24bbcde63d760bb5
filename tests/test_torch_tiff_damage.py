"""Damaged and cut TIFF strips and tiles (io/images.py read_image,
native/tiff.cpp, native/jpeg.cpp) against
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``: cv2 reads a TIFF
through libtiff's RGBA interface, which reads on past a strip that fails
and keeps what its codec decoded. Thousands of seeded corruptions and
truncations per kind, each byte-equal with cv2 (or None where cv2 gives
None): CCITT modified Huffman, T.4 1-D and 2-D and T.6 at both fill
orders, LZW and Deflate with and without the predictor, PackBits and
JPEG-in-TIFF, in strips and tiles; and the strips libtiff cannot fill
(empty, past the end of the file), which give None."""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from ocr_inference_tpu_torch.io.images import read_image
from tests.image_writers import split_jpeg_tables, write_tiff

# each damaged CCITT strip warns, as libtiff does
pytestmark = pytest.mark.filterwarnings("ignore:CCITT data damaged")

REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                    np.uint8)


def _cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _same_as_cv2(path) -> bool:
    want = _cv2_rgb(path)
    got = read_image(path)
    if want is None or got is None:
        return want is None and got is None
    return want.shape == got.shape and bool((want == got).all())


def _bitonal(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    return (np.sin(x / 7.0) + np.cos(y / 5.0) + rng.rand(h, w) * 0.6) > 1.1


def _pil_chunks(img: Image.Image, **save):
    """The strips PIL (libtiff) writes for an image, and its tags."""
    buf = io.BytesIO()
    img.save(buf, "TIFF", **save)
    tags = dict(Image.open(buf).tag_v2)
    raw = buf.getvalue()
    return [raw[o: o + n] for o, n in zip(tags[273], tags[279])], tags


def _damaged(rng, chunks):
    """One chunk with 1-3 bytes changed, cut short, or both."""
    chunks = list(chunks)
    i = int(rng.randint(len(chunks)))
    c = bytearray(chunks[i])
    mode = rng.randint(3)
    if mode != 1:
        for _ in range(rng.randint(1, 4)):
            c[rng.randint(len(c))] ^= int(rng.randint(1, 256))
    if mode != 0:
        c = c[: max(1, int(rng.randint(len(c))))]
    chunks[i] = bytes(c)
    return chunks


def _fuzz(tmp_path, page, chunks, n, seed):
    """n damaged copies of a page (page(chunks) -> write_tiff's page)
    against cv2; the seeds that differ."""
    rng = np.random.RandomState(seed)
    path = tmp_path / "d.tif"
    bad = []
    for k in range(n):
        write_tiff(path, [page(_damaged(rng, chunks))])
        if not _same_as_cv2(path):
            bad.append(k)
    return bad


# (PIL compression, T4Options): modified Huffman, T.4 1-D, T.4 2-D, T.6
CCITT = {"mh": ("tiff_ccitt", {}), "t4_1d": ("group3", {}),
         "t4_2d": ("group3", {292: 1}), "t6": ("group4", {})}


def _ccitt_chunks(kind, ink, layout, fill_order):
    """A bitonal page's CCITT strips (16 rows each) or 32x32 tiles, coded
    by PIL's libtiff, and the page's tags; fill order 2 reverses the bits
    of every byte."""
    comp, info = CCITT[kind]
    if layout == "strips":
        chunks, tags = _pil_chunks(
            Image.fromarray((~ink).astype(np.uint8) * 255).convert("1"),
            compression=comp, tiffinfo={**info, 278: 16})
    else:
        h, w = ink.shape
        chunks = []
        for y in range(0, h, 32):
            for x in range(0, w, 32):
                tile = np.zeros((32, 32), bool)
                part = ink[y: y + 32, x: x + 32]
                tile[: part.shape[0], : part.shape[1]] = part
                c, tags = _pil_chunks(
                    Image.fromarray((~tile).astype(np.uint8) * 255)
                    .convert("1"), compression=comp, tiffinfo=info)
                chunks.append(b"".join(c))
    if fill_order == 2:
        chunks = [REVERSED[np.frombuffer(c, np.uint8)].tobytes()
                  for c in chunks]
    return chunks, tags


@pytest.mark.parametrize("fill_order", [1, 2])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("kind", sorted(CCITT))
def test_damaged_ccitt(tmp_path, kind, layout, fill_order):
    """500 seeded corruptions and truncations of one strip or tile of a
    bitonal page (2000 per kind): tif_fax3.c's recovery, row by row, with
    its run arrays kept from strip to strip, and T.4 decoded again without
    EOLs once data ends inside one."""
    ink = _bitonal(64, 96 if layout == "tiles" else 131, seed=len(kind))
    chunks, tags = _ccitt_chunks(kind, ink, layout, fill_order)
    extra = {k: tags[k] for k in (292, 293) if k in tags}
    shape = {"tile": (32, 32)} if layout == "tiles" else \
        {"rows_per_strip": 16}

    def page(cs):
        return dict(samples=np.zeros(ink.shape + (1,), np.uint8), bits=1,
                    photometric=tags[262], compression=tags[259], chunks=cs,
                    fill_order=fill_order, tags=extra, **shape)

    path = tmp_path / "intact.tif"
    write_tiff(path, [page(chunks)])
    assert _same_as_cv2(path)
    np.testing.assert_array_equal(read_image(path)[..., 0] == 0, ink)
    assert _fuzz(tmp_path, page, chunks, 500, seed=fill_order) == []


def test_t4_retried_without_eols_for_the_rest_of_the_page(tmp_path):
    """A T.4 strip cut right after an EOL's zeros: libtiff 4.5+ decodes
    the strip again from its start without looking for EOLs (garbled
    rows), and keeps that mode for the strips after it."""
    ink = _bitonal(64, 131, seed=3)
    chunks, tags = _pil_chunks(
        Image.fromarray((~ink).astype(np.uint8) * 255).convert("1"),
        compression="group3", tiffinfo={278: 16})
    data = chunks[0]
    eol = data.index(b"\x00", 20)  # the zeros of a row's EOL
    path = tmp_path / "t4.tif"
    write_tiff(path, [dict(samples=np.zeros((64, 131, 1), np.uint8), bits=1,
                           photometric=tags[262], compression=3,
                           chunks=[data[: eol + 1]] + chunks[1:],
                           rows_per_strip=16)])
    assert _same_as_cv2(path)
    got = read_image(path)[..., 0] == 0
    assert not (got[16:] == ink[16:]).all()  # the later strips too


# (compression, predictor) of the byte codecs
BYTE_CODECS = [(5, 1), (5, 2), (8, 1), (8, 2), (32946, 2), (32773, 1)]


@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("codec", BYTE_CODECS,
                         ids=lambda c: "c%d-p%d" % c)
def test_damaged_byte_codecs(tmp_path, codec, layout):
    """400 seeded corruptions and truncations of an RGB page's LZW,
    Deflate or PackBits strips or tiles: the bytes decoded before a bad
    code, a bad check value or the end of the data stay (zlib's and
    tif_lzw.c's output), the rest are zero, and the predictor is undone
    only for a strip whose decode succeeded."""
    compression, predictor = codec
    rng = np.random.RandomState(compression + predictor)
    y, x = np.mgrid[0:40, 0:48]
    img = np.stack([(x * 5 + y) % 256, (y * 7) % 256,
                    (x * y) % 251], -1).astype(np.uint8)
    img[rng.rand(40, 48) < 0.1] = 17
    from tests.image_writers import _page_chunks

    shape = {"tile": (16, 16)} if layout == "tiles" else \
        {"rows_per_strip": 8}
    chunks = _page_chunks(img, 8, compression, predictor, shape.get("tile"),
                          shape.get("rows_per_strip", 40), "<", 1)

    def page(cs):
        return dict(samples=img, bits=8, photometric=2,
                    compression=compression, predictor=predictor, chunks=cs,
                    **shape)

    assert _fuzz(tmp_path, page, chunks, 400, seed=compression) == []


@pytest.mark.parametrize("kind", ["rgb", "gray", "ycbcr_tables", "tiles"])
def test_damaged_jpeg_in_tiff(tmp_path, kind):
    """500 seeded corruptions and truncations of JPEG-in-TIFF strips or
    tiles (one JPEGTables stream for the YCbCr page): libjpeg's handling
    of corrupt data inside a strip, a strip whose header libjpeg rejects
    failing the page (cv2 gives None), and what jpeg_finish_decompress
    meets after a single-scan strip changing nothing."""
    y, x = np.mgrid[0:48, 0:64]
    img = np.stack([(x * 3 + y) % 256, (y * 4) % 256, (x * y) % 256],
                   -1).astype(np.uint8)
    tags = {}
    if kind in ("rgb", "gray"):
        src = Image.fromarray(img if kind == "rgb" else img[..., 0])
        chunks, t = _pil_chunks(src, compression="jpeg",
                                tiffinfo={278: 16})
        phot, spp, shape = t[262], 3 if kind == "rgb" else 1, \
            {"rows_per_strip": 16}
        if 347 in t:
            tags[347] = (7, list(t[347]))
    else:
        tile = kind == "tiles"
        step = 16
        chunks, tables = [], None
        blocks = [(yy, xx) for yy in range(0, 48, step)
                  for xx in range(0, 64, 32 if tile else 64)]
        for yy, xx in blocks:
            part = img[yy: yy + step, xx: xx + (32 if tile else 64)]
            ok, enc = cv2.imencode(".jpg", part[..., ::-1])
            tables, abbreviated = split_jpeg_tables(enc.tobytes())
            chunks.append(abbreviated)
        tags = {530: (3, [2, 2]), 347: (7, tables)}
        phot, spp = 6, 3
        shape = {"tile": (32, 16)} if tile else {"rows_per_strip": 16}

    def page(cs):
        return dict(samples=np.zeros((48, 64, spp), np.uint8), bits=8,
                    photometric=phot, compression=7, chunks=cs, tags=tags,
                    **shape)

    path = tmp_path / "intact.tif"
    write_tiff(path, [page(chunks)])
    assert _same_as_cv2(path)
    assert _fuzz(tmp_path, page, chunks, 500, seed=len(kind)) == []


def _patch_strips(path, counts=None, offsets=None):
    """Overwrite a little-endian TIFF's StripByteCounts or StripOffsets
    (None keeps an entry)."""
    data = bytearray(path.read_bytes())
    ifd, = struct.unpack_from("<I", data, 4)
    n, = struct.unpack_from("<H", data, ifd)
    for i in range(n):
        at = ifd + 2 + 12 * i
        tag, _, count = struct.unpack_from("<HHI", data, at)
        for want, values in ((279, counts), (273, offsets)):
            if tag != want or values is None:
                continue
            where = at + 8 if count == 1 else \
                struct.unpack_from("<I", data, at + 8)[0]
            for k, v in enumerate(values):
                if v is not None:
                    struct.pack_into("<I", data, where + 4 * k, v)
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("strips", [1, 4])
def test_strips_libtiff_cannot_fill(tmp_path, compression, strips):
    """A strip with no bytes, one running past the end of the file, or one
    that starts past it fails libtiff's TIFFFillStrip before any buffer
    is made: cv2 gives None. A single strip whose count looks bad (zero;
    uncompressed, short or past the file) gets libtiff's estimate
    instead; a short strip inside the file is decoded as far as it goes
    (uncompressed: DumpModeDecode copies nothing)."""
    g = (np.add.outer(np.arange(40), np.arange(50)) % 37 * 7).astype(
        np.uint8)
    path = tmp_path / "s.tif"
    last = [None] * (strips - 1)
    for case in ("zero", "short", "past", "offset past"):
        write_tiff(path, [dict(samples=g[..., None], bits=8, photometric=1,
                               compression=compression,
                               rows_per_strip=40 // strips)])
        size = path.stat().st_size
        if case == "offset past":
            _patch_strips(path, offsets=last + [size + 10])
        else:
            _patch_strips(path, counts=last + [
                {"zero": 0, "short": 5, "past": 2 * size}[case]])
        assert _same_as_cv2(path), case
        if strips > 1 and case != "short":
            assert read_image(path) is None, case
