"""The port's PNG reader (io/images.py read_image) against
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``: byte-equal on PNGs
written by cv2.imwrite, by the port's write_png and, for the colour types,
bit depths, filters and Adam7 interlacing cv2.imwrite does not choose, by
small encoders here on zlib; EXIF orientation from an ``eXIf`` chunk;
None where cv2 gives None; NotImplementedError for the formats read_image
does not decode. JPEG and TIFF have their own files
(tests/test_torch_jpeg.py, tests/test_torch_tiff.py)."""

import hashlib
import json
import struct
import zlib

import cv2
import numpy as np
import pytest

from PIL import Image

from ocr_inference_tpu_torch.io.artifacts import write_png
from ocr_inference_tpu_torch.io.images import (
    image_format, read_image, unsupported,
)
from tests.htj2k_writer import htj2k_encode, jph_file
from tests.image_writers import (
    bmp_file, bmp_rle8, j2k_ht_flagged, j2k_mcc, j2k_mco, j2k_mct, jp2_file,
    ispe_scaled_avif, layered_avif, openjpeg_encode, pam_file, pnm_file,
    screen_content_avif,
    sequence_avif, ten_bit_avif,
    write_adam7_png,
)
from tests.make_torch_port_fixture import OUT

IMAGES = json.loads((OUT / "images.json").read_text(encoding="utf-8"))


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


def _chunk(tag: bytes, data: bytes, crc=None) -> bytes:
    crc = zlib.crc32(tag + data) if crc is None else crc
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter(raw: np.ndarray, bpp: int, types) -> bytes:
    """PNG-filter each row of raw (h, row_bytes) with types[y % len]."""
    out = []
    prior = np.zeros(raw.shape[1], np.int64)
    for y, row in enumerate(raw.astype(np.int64)):
        t = types[y % len(types)]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        pred = {0: 0, 1: left, 2: prior, 3: (left + prior) // 2,
                4: _paeth(left, prior, up_left)}[t]
        out.append(bytes([t]) + ((row - pred) % 256).astype(np.uint8)
                   .tobytes())
        prior = row
    return b"".join(out)


def _png(path, raw, w, h, depth, color, types=(0,), palette=None,
         trns=None, interlace=0, idat_parts=1, bpp=None):
    """Write a PNG of raw (h, row_bytes) samples with the given filters."""
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    bpp = bpp or max(1, channels * depth // 8)
    data = zlib.compress(_filter(raw, bpp, types))
    step = -(-len(data) // idat_parts)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                       interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        body += _chunk(b"tRNS", trns)
    for i in range(0, len(data), step):
        body += _chunk(b"IDAT", data[i: i + step])
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IEND", b""))
    return path


def _adam7_png(path, img):
    """An Adam7-interlaced 8-bit RGB PNG of img: the seven passes'
    sub-images one after another, each row with filter type 0."""
    h, w = img.shape[:2]
    data = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        sub = img[y0::dy, x0::dx]
        if sub.size:
            data += b"".join(b"\x00" + row.tobytes() for row in sub)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
    body += _chunk(b"IDAT", zlib.compress(data))
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IEND", b""))
    return path


def _smooth(h, w, c):
    """Gradients: cv2.imwrite's adaptive filtering picks several filter
    types on them."""
    yy, xx = np.mgrid[:h, :w]
    planes = [(xx * (i + 1) + yy * (3 - i)) % 256 for i in range(c)]
    return np.stack(planes, -1).astype(np.uint8)


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "gray16", "rgb16",
                                  "rgba16", "smooth_rgb", "smooth_gray"])
def test_cv2_written_pngs(tmp_path, kind):
    rng = np.random.default_rng(len(kind))
    shape = {"gray": (37, 53), "rgb": (37, 53, 3), "rgba": (37, 53, 4)}
    if kind == "smooth_rgb":
        img = _smooth(61, 97, 3)
    elif kind == "smooth_gray":
        img = _smooth(61, 97, 1)[..., 0]
    elif kind.endswith("16"):
        img = rng.integers(0, 65536, shape[kind[:-2]], dtype=np.uint16)
    else:
        img = rng.integers(0, 256, shape[kind], dtype=np.uint8)
    path = tmp_path / f"{kind}.png"
    assert cv2.imwrite(str(path), img)
    _assert_same_as_cv2(path)


def test_16_bit_keeps_the_high_byte(tmp_path):
    """IMREAD_COLOR reduces 16-bit samples by their high byte (no
    rounding): 0x12FF reads 0x12."""
    v = np.array([[0x0000, 0x00FF, 0x0100, 0x127F, 0x1280, 0x12FF, 0xFFFF]],
                 np.uint16)
    path = tmp_path / "g16.png"
    cv2.imwrite(str(path), v)
    got = read_image(path)
    np.testing.assert_array_equal(got[0, :, 0], (v[0] >> 8).astype(np.uint8))
    _assert_same_as_cv2(path)


@pytest.mark.parametrize("shape", [(40, 64), (33, 57, 3)])
def test_port_written_pngs(tmp_path, shape):
    img = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "port.png"
    write_png(path, img)
    _assert_same_as_cv2(path)
    if len(shape) == 3:  # write_png takes BGR, as cv2.imwrite
        np.testing.assert_array_equal(read_image(path), img[..., ::-1])


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("color,depth", [(0, 8), (2, 8), (6, 8), (4, 8),
                                         (2, 16), (4, 16)])
def test_every_filter_type(tmp_path, ftype, color, depth):
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    h, w = 23, 31
    rng = np.random.default_rng(ftype if ftype != "mixed" else 9)
    raw = np.clip(_smooth(h, w * channels * depth // 8, 1)[..., 0].astype(int)
                  + rng.integers(-20, 20, (h, w * channels * depth // 8)),
                  0, 255).astype(np.uint8)
    types = (0, 1, 2, 3, 4) if ftype == "mixed" else (ftype,)
    path = _png(tmp_path / "f.png", raw, w, h, depth, color, types=types,
                idat_parts=3)
    _assert_same_as_cv2(path)


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("trns", [None, b"\x00\x80"])
def test_palette_pngs(tmp_path, depth, trns):
    h, w = 19, 45
    rng = np.random.default_rng(depth)
    n = 1 << depth
    palette = rng.integers(0, 256, (n, 3))
    idx = rng.integers(0, n, (h, w)).astype(np.uint8)
    per_byte = 8 // depth
    padded = np.zeros((h, -(-w // per_byte) * per_byte), np.uint8)
    padded[:, :w] = idx
    groups = padded.reshape(h, -1, per_byte).astype(np.int64)
    shifts = np.arange(8 - depth, -1, -depth)
    raw = (groups << shifts).sum(-1).astype(np.uint8)
    path = _png(tmp_path / "p.png", raw, w, h, depth, 3, types=(0, 1, 4),
                palette=palette, trns=trns)
    _assert_same_as_cv2(path)
    np.testing.assert_array_equal(read_image(path), palette[idx])


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_low_bit_gray_pngs(tmp_path, depth):
    h, w = 11, 29
    rng = np.random.default_rng(depth + 10)
    row_bytes = -(-w * depth // 8)
    raw = rng.integers(0, 256, (h, row_bytes), dtype=np.uint8)
    path = _png(tmp_path / "g.png", raw, w, h, depth, 0, types=(0, 2))
    _assert_same_as_cv2(path)


def test_unreadable_files_give_none(tmp_path):
    img = np.random.default_rng(4).integers(0, 256, (30, 40, 3), np.uint8)
    good = tmp_path / "good.png"
    cv2.imwrite(str(good), img)
    data = good.read_bytes()
    cases = {
        "truncated.png": data[: len(data) // 2],
        "garbage.png": b"not an image at all",
        "empty.png": b"",
    }
    # a flipped byte inside the IDAT payload fails its CRC
    idat = data.index(b"IDAT") + 8
    cases["bad_crc.png"] = data[:idat] + bytes([data[idat] ^ 0xFF]) + \
        data[idat + 1:]
    for name, blob in cases.items():
        path = tmp_path / name
        path.write_bytes(blob)
        assert _cv2_rgb(path) is None, name
        assert read_image(path) is None, name
    assert read_image(tmp_path / "missing.png") is None


def test_other_formats_and_interlaced_png_raise(tmp_path):
    """An AVIF whose ispe differs from its frame is refused by name; JPEG,
    TIFF, Adam7 PNG, BMP, WebP, GIF, cv2's default AVIF, an AVIF with
    screen-content tools, one of 10 bits, an AVIF image sequence and a
    layered AVIF (AV1 inter frames), once refused, now read as cv2 reads
    them."""
    img = np.random.default_rng(5).integers(0, 256, (16, 24, 3), np.uint8)
    path = tmp_path / "scaled.avif"
    ispe_scaled_avif(path)
    assert image_format(path) == "AVIF"
    with pytest.raises(NotImplementedError, match="ispe property differs"):
        read_image(path)
    path = tmp_path / "layered.avif"
    layered_avif(path)
    assert image_format(path) == "AVIF"
    _assert_same_as_cv2(path)
    path = tmp_path / "frames.avif"
    sequence_avif(path)
    assert image_format(path) == "AVIF"
    _assert_same_as_cv2(path)
    path = tmp_path / "ten.avif"
    ten_bit_avif(path)
    assert image_format(path) == "AVIF"
    _assert_same_as_cv2(path)
    path = tmp_path / "screen.avif"
    screen_content_avif(path)
    assert image_format(path) == "AVIF"
    _assert_same_as_cv2(path)
    for ext, name in ((".jpg", "JPEG"), (".tiff", "TIFF"), (".bmp", "BMP"),
                      (".webp", "WebP"), (".gif", "GIF"), (".avif", "AVIF")):
        path = tmp_path / f"page{ext}"
        assert cv2.imwrite(str(path), img)
        assert image_format(path) == name
        _assert_same_as_cv2(path)
    path = _adam7_png(tmp_path / "adam7.png", img)
    np.testing.assert_array_equal(_cv2_rgb(path), img)  # cv2 reads it
    np.testing.assert_array_equal(read_image(path), img)
    assert image_format(tmp_path / "adam7.png") == "PNG"


@pytest.mark.parametrize("color,depth", [
    (0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
    (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)])
def test_adam7_pngs(tmp_path, color, depth):
    """Every colour type at its depths, Adam7-interlaced, each pass's rows
    through all five filters; sizes where passes are empty included."""
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    rng = np.random.RandomState(color * 17 + depth)
    for h, w in ((1, 1), (3, 5), (7, 13), (33, 17)):
        samples = rng.randint(0, 1 << depth, (h, w, channels))
        palette = rng.randint(0, 256, (1 << depth, 3)) if color == 3 \
            else None
        path = tmp_path / "i.png"
        write_adam7_png(path, samples, color, depth, palette)
        _assert_same_as_cv2(path)


def _exif_png(path, img, orientation, where="before", crc=None):
    """A PNG with an eXIf chunk (orientation) before or after IDAT."""
    exif = Image.Exif()
    exif[0x0112] = orientation
    plain = path.with_suffix(".plain.png")
    Image.fromarray(img).save(plain)
    data = plain.read_bytes()
    block = exif.tobytes()
    block = block[6:] if block.startswith(b"Exif\x00\x00") else block
    chunk = _chunk(b"eXIf", block, crc)
    at = data.index(b"IDAT") - 4 if where == "before" else \
        data.index(b"IEND") - 4
    path.write_bytes(data[:at] + chunk + data[at:])
    return path


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("where", ["before", "after"])
def test_png_exif_orientation(tmp_path, orientation, where):
    """cv2.imread turns a PNG by its eXIf orientation, wherever the chunk
    stands; a 20x30 page with orientation 6 comes back 30x20, equal to
    np.rot90(page, -1). An eXIf chunk with a bad CRC is ignored."""
    img = np.random.default_rng(orientation).integers(0, 256, (20, 30, 3),
                                                      np.uint8)
    path = _exif_png(tmp_path / "e.png", img, orientation, where)
    _assert_same_as_cv2(path)
    if orientation == 6:
        np.testing.assert_array_equal(read_image(path), np.rot90(img, -1))
    path = _exif_png(tmp_path / "bad.png", img, orientation, where, crc=0)
    _assert_same_as_cv2(path)
    np.testing.assert_array_equal(read_image(path), img)


@pytest.mark.parametrize("rel", sorted(IMAGES["files"]))
def test_committed_files_equal_the_cv2_record(rel):
    """The encoded pages chip_smoke.py reads on the card (the card machine
    has no cv2): each file unchanged, and read_image gives cv2's decode,
    equal to the shape and sha256 images.json records (None for the files
    of images/none/, as cv2)."""
    want = IMAGES["files"][rel]
    path = OUT / "images" / rel
    assert hashlib.sha256(path.read_bytes()).hexdigest() == \
        want["file_sha256"]
    got = read_image(path)
    if want["shape"] is None:  # images/none/: cv2 gives None
        assert got is None and _cv2_rgb(path) is None
        return
    assert list(got.shape) == want["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    np.testing.assert_array_equal(got, _cv2_rgb(path))


def _agreement_corpus(root):
    """One file of each kind the reader tests write: every format and
    variant read, given None or refused, and corrupt files, plus the
    committed page files."""
    from tests.image_writers import (
        jpeg2000_tiff, jpeg_arith, jpeg_dct, jpeg_lossless, modified_huffman,
        old_style_lzw, sgilog, split_jpeg_tables, thunderscan,
        write_tiff,
    )

    rng = np.random.RandomState(21)
    img = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    files = [OUT / "images" / rel for rel in IMAGES["files"]]

    def add(name, data=None):
        path = root / name
        if data is not None:
            path.write_bytes(data)
        files.append(path)
        return path

    cv2.imwrite(str(root / "p.png"), img)
    add("p.png")
    _adam7_png(root / "a7.png", img)
    add("a7.png")
    for name, params in (("b.jpg", []), ("p.jpg", [
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1]), ("r.jpg", [
            cv2.IMWRITE_JPEG_RST_INTERVAL, 2])):
        cv2.imwrite(str(root / name), img, params)
        data = add(name).read_bytes()
        for cut in (len(data) // 3, len(data) // 2, 200, 20):
            add(f"cut{cut}_{name}", data[:cut])
        flipped = bytearray(data)
        flipped[len(data) // 2] ^= 0x5A
        add(f"flip_{name}", bytes(flipped))
    base = (root / "b.jpg").read_bytes()
    planes = [img[..., c].astype(float) for c in range(3)]
    add("arith.jpg", jpeg_arith(planes))
    add("arith_prog.jpg", jpeg_arith(planes, progressive=True, restart=3))
    add("lossless_rgb.jpg", jpeg_lossless(img, 8, 4))
    add("lossless_gray.jpg", jpeg_lossless(img[..., 0], 8, 1))
    add("lossless_16.jpg", jpeg_lossless(img.astype(int) * 250, 16, 7))
    add("dct12.jpg", jpeg_dct([p * 16 for p in planes], 12))
    add("j2k.jpg", jpeg2000_tiff())
    add("twelve.jpg", base.replace(b"\xff\xc0\x00\x11\x08",
                                   b"\xff\xc0\x00\x11\x0c", 1))
    lossless = bytearray(base.replace(b"\xff\xc0", b"\xff\xc3", 1))
    add("lossless_bad_scan.jpg", bytes(lossless))
    at = lossless.index(b"\xff\xda")
    lossless[at + 11: at + 14] = b"\x01\x00\x00"
    add("lossless.jpg", bytes(lossless))
    Image.fromarray(img).convert("CMYK").save(root / "cmyk.jpg")
    add("cmyk.jpg")
    ycck = bytearray((root / "cmyk.jpg").read_bytes())
    ycck[ycck.index(b"Adobe") + 11] = 2
    add("ycck.jpg", bytes(ycck))
    for mode, comp in (("RGB", "jpeg"), ("L", "jpeg"), ("CMYK", "tiff_lzw"),
                       ("RGB", "tiff_lzw"), ("1", "group4")):
        name = f"{mode}_{comp}.tif"
        Image.fromarray(img).convert(mode).save(root / name, compression=comp)
        add(name)
    pages = {
        "planar.tif": dict(samples=img, bits=8, photometric=2, planar=True,
                           compression=5, predictor=2),
        "ycc22.tif": dict(samples=img, bits=8, photometric=6, compression=8,
                          ycbcr_subsampling=(2, 2)),
        "ycc33.tif": dict(samples=img, bits=8, photometric=6,
                          ycbcr_subsampling=(3, 3)),
        "cmyk16.tif": dict(samples=rng.randint(0, 65536, (8, 8, 4)),
                           bits=16, photometric=5),
        "lab.tif": dict(samples=img, bits=8, photometric=8),
        "float.tif": dict(samples=img, bits=16, photometric=2,
                          tags={339: 3}),
        "fpred.tif": dict(samples=img, bits=8, photometric=2, compression=8,
                          predictor=3),
        "oldlzw.tif": dict(samples=img, bits=8, photometric=2,
                           compression=5, chunks=[b"\x00\x01" + bytes(40)]),
        "oldlzw_real.tif": dict(samples=img, bits=8, photometric=2,
                                compression=5,
                                chunks=[old_style_lzw(img.tobytes())]),
        "rlew.tif": dict(samples=img[..., :1] > 128, bits=1, photometric=0,
                         compression=32771,
                         chunks=[modified_huffman(img[..., 0] > 128, 16)]),
        "thunder.tif": dict(samples=img[..., :1] >> 4, bits=4, photometric=3,
                            compression=32809,
                            colormap=rng.randint(0, 65536, 48),
                            chunks=[thunderscan(img[..., 0] >> 4)]),
        "logl.tif": dict(samples=img[..., :1], bits=16, photometric=32844,
                         compression=34676, rows_per_strip=1,
                         chunks=sgilog(img[..., 0] / 255.0, False)),
        "g4unc.tif": dict(samples=img[..., :1] > 128, bits=1, photometric=0,
                          compression=4, tags={293: 2}, chunks=[bytes(20)]),
    }
    for comp in (6, 32766, 32771, 32809, 32909, 34661, 34676, 34712, 34887,
                 34925, 50000, 50001, 50002):
        pages[f"c{comp}.tif"] = dict(samples=img, bits=8, photometric=2,
                                     tags={259: comp})
    ok, stream = cv2.imencode(".jpg", img)
    tables, abbreviated = split_jpeg_tables(stream.tobytes())
    pages["jpeg_ycc.tif"] = dict(samples=img, bits=8, photometric=6,
                                 compression=7, chunks=[abbreviated],
                                 tags={530: (3, [2, 2]), 347: (7, tables)})
    pages["jpeg_arith.tif"] = dict(samples=img, bits=8, photometric=2,
                                   compression=7,
                                   chunks=[jpeg_arith(planes, ids=[82, 71,
                                                                   66])])
    pages["jpeg_lossless.tif"] = dict(samples=img, bits=8, photometric=2,
                                      compression=7,
                                      chunks=[jpeg_lossless(img, 8, 5)])
    for name, page in pages.items():
        write_tiff(root / name, [page])
        add(name)
    write_tiff(root / "big.tif", [pages["planar.tif"]], big=True)
    add("big.tif")
    for ext in (".bmp", ".webp", ".ppm", ".pgm", ".pam", ".pfm",
                ".hdr", ".ras", ".avif"):
        cv2.imwrite(str(root / f"x{ext}"), img.astype(np.float32) / 255
                    if ext in (".pfm", ".hdr") else img)
        add(f"x{ext}")
    add("x.gif", b"GIF89a" + bytes(32))
    add("gray.pfm", b"Pf\n2 2\n-1\n" + bytes(16))
    add("rgbe.hdr", b"#?RGBE\n\n-Y 2 +X 2\n" + bytes(16))
    add("x.exr", b"\x76\x2f\x31\x01" + bytes(32))
    add("os2.bmp", b"BA" + bytes(40))
    # the JPEG 2000, BMP, PNM and PAM writers' files
    cs = openjpeg_encode(img, numresolution=2)
    add("raw.j2k", cs)
    add("gray.j2k", openjpeg_encode(img[..., 0], numresolution=2))
    add("sycc420.jp2", openjpeg_encode(img, jp2=True, color_space=3,
                                       subsampling=2, numresolution=2))
    add("cmyk.jp2", jp2_file(cs, *img.shape, colr=("enum", 12)))
    add("cut.jp2", jp2_file(cs, *img.shape)[:-40])
    siz = 4 + struct.unpack_from(">H", cs, 4)[0]
    add("htj2k.j2k", j2k_ht_flagged(openjpeg_encode(
        np.full((8, 8, 3), 128), numresolution=2, tcp_mct=0)))
    add("ht97.j2k", htj2k_encode(img, reversible=False, passes=3))
    add("ht.jph", jph_file(htj2k_encode(img), *img.shape))
    add("part2.j2k", cs[:siz] + j2k_mct(1, [9, 99, 199]) + j2k_mcc(
        1, 3, offset=1) + j2k_mco(1) + cs[siz:])
    add("rle8.bmp", bmp_file(24, 16, 8, bmp_rle8(img[..., 0] >> 6),
                             compression=1, palette=np.zeros((256, 4))))
    add("p2.pgm", pnm_file(img[..., 0], 255, binary=False))
    add("p6_16.ppm", pnm_file(img.astype(np.int64) * 257, 65535))
    add("rgba.pam", pam_file(np.dstack([img, img[..., :1]]), 255,
                             "RGB_ALPHA"))
    add("missing.jpg")
    return files


def test_unsupported_agrees_with_read_image(tmp_path):
    """unsupported() judges from the headers what read_image would refuse:
    for every kind of file the reader tests make, a file it passes
    (None) never makes read_image raise NotImplementedError, and a file it
    names always does."""
    for path in _agreement_corpus(tmp_path):
        why = unsupported(path)
        try:
            read_image(path)
            refused = False
        except NotImplementedError:
            refused = True
        assert refused == (why is not None), (path.name, why)
