"""The port's PNG reader (io/images.py read_image) against
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``: byte-equal on PNGs
written by cv2.imwrite, by the port's write_png and, for the colour types,
bit depths and filters cv2.imwrite does not choose, by a small encoder
here on zlib; None where cv2 gives None; NotImplementedError for other
formats and interlaced PNG."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from ocr_inference_tpu_torch.io.artifacts import write_png
from ocr_inference_tpu_torch.io.images import image_format, read_image


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
    img = np.random.default_rng(5).integers(0, 256, (16, 24, 3), np.uint8)
    for ext, name in ((".jpg", "JPEG"), (".tiff", "TIFF"), (".bmp", "BMP")):
        path = tmp_path / f"page{ext}"
        assert cv2.imwrite(str(path), img)
        assert image_format(path) == name
        with pytest.raises(NotImplementedError, match=name):
            read_image(path)
    path = _adam7_png(tmp_path / "adam7.png", img)
    np.testing.assert_array_equal(_cv2_rgb(path), img)  # cv2 reads it
    with pytest.raises(NotImplementedError, match="interlaced"):
        read_image(path)
    assert image_format(tmp_path / "adam7.png") == "PNG"
