"""Page images from files: the port's counterpart of
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` for PNG.

The card machine has neither OpenCV nor PIL, so PNG is decoded here on
stdlib ``zlib`` and numpy, with the scanline unfilter in native code
(native/png.cpp). What ``cv2.imread(path)`` (``IMREAD_COLOR``) gives, this
gives in RGB order:

- colour types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and
  6 (RGBA); bit depths 1, 2, 4, 8 and 16 where the type allows them;
- gray and palette are expanded to three channels; alpha is dropped, not
  composited; 16-bit samples keep their high byte, as libpng's
  ``png_set_strip_16`` (behind ``IMREAD_COLOR``) does; gray below 8 bits
  is scaled to 0..255;
- an unreadable file (missing, truncated, a bad CRC of a critical chunk,
  bad zlib data, an unknown filter) gives ``None``, as ``imread`` does.

Adam7-interlaced PNG and every other image format raise
``NotImplementedError`` naming it, so that no page is skipped silently.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ocr_inference_tpu_torch import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# leading bytes of the formats cv2.imread reads besides PNG
_MAGIC = (
    (b"\xff\xd8\xff", "JPEG"),
    (b"II*\x00", "TIFF"),
    (b"MM\x00*", "TIFF"),
    (b"BM", "BMP"),
    (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"),
    (b"\xffO\xffQ", "JPEG 2000"),
    (b"GIF8", "GIF"),
    (b"v/1\x01", "OpenEXR"),
    (b"#?RADIANCE", "Radiance HDR"),
    (b"\x59\xa6\x6a\x95", "Sun raster"),
)

# channels of each colour type, and the bit depths it allows
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


class _Corrupt(ValueError):
    """The file is a PNG that cannot be decoded."""


def image_format(path: str | Path) -> str | None:
    """The image format of a file by its leading bytes: "PNG", another
    format's name, or None for a file that is missing or of no known
    format."""
    try:
        with open(path, "rb") as f:
            head = f.read(16)
    except OSError:
        return None
    if head.startswith(PNG_SIGNATURE):
        return "PNG"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    if head[4:12] in (b"ftypavif", b"ftypavis"):
        return "AVIF"
    if len(head) > 1 and head[:1] == b"P" and head[1:2] in b"1234567f":
        return "PNM"
    for magic, name in _MAGIC:
        if head.startswith(magic):
            return name
    return None


def read_image(path: str | Path) -> np.ndarray | None:
    """A PNG file -> (H, W, 3) uint8 RGB, or None when it cannot be read
    (see the module doc). Other formats and interlaced PNG raise
    NotImplementedError."""
    fmt = image_format(path)
    if fmt is None:
        return None
    if fmt != "PNG":
        raise NotImplementedError(
            f"{path}: {fmt} images are not supported; only PNG is read")
    try:
        data = Path(path).read_bytes()
        return _decode_png(data)
    except NotImplementedError as e:
        raise NotImplementedError(f"{path}: {e}") from None
    except (OSError, _Corrupt, zlib.error, struct.error, ValueError):
        return None


def _chunks(data: bytes):
    """(type, payload) of each chunk up to IEND; a critical chunk with a
    bad CRC, or a file that ends inside a chunk, is corrupt."""
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise _Corrupt("no IEND chunk")
        length, tag = struct.unpack(">I4s", data[pos: pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise _Corrupt(f"truncated {tag!r} chunk")
        payload = data[pos + 8: end]
        crc, = struct.unpack(">I", data[end: end + 4])
        critical = not (tag[0] & 0x20)
        if critical and zlib.crc32(tag + payload) != crc:
            raise _Corrupt(f"bad CRC in {tag!r}")
        yield tag, payload
        if tag == b"IEND":
            return
        pos = end + 4


def _decode_png(data: bytes) -> np.ndarray:
    header = palette = None
    idat = []
    for tag, payload in _chunks(data):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            palette = payload
        elif tag == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise _Corrupt("no IHDR or no IDAT")
    w, h, depth, color, compression, filtering, interlace = header
    if color not in _CHANNELS or depth not in _DEPTHS[color] or w == 0 \
            or h == 0 or compression or filtering:
        raise _Corrupt(f"invalid header {header}")
    if interlace == 1:
        raise NotImplementedError("Adam7-interlaced PNG is not supported")
    if interlace:
        raise _Corrupt(f"unknown interlace method {interlace}")
    if color == 3 and palette is None:
        raise _Corrupt("palette image without PLTE")

    channels = _CHANNELS[color]
    row_bytes = (w * channels * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (row_bytes + 1):
        raise _Corrupt("image data too short")
    rows = native.png_unfilter(raw[: h * (row_bytes + 1)], h, row_bytes,
                               max(1, channels * depth // 8))

    if depth == 16:  # big-endian samples; keep the high byte
        samples = rows.reshape(h, w * channels, 2)[..., 0]
    elif depth == 8:
        samples = rows
    else:  # 1, 2 or 4 bits a sample, first sample in the high bits
        per_byte = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = ((rows[..., None] >> shifts) & ((1 << depth) - 1))
        samples = samples.reshape(h, row_bytes * per_byte)[:, :w]
        if color == 0:  # scale gray to 0..255
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
    samples = samples.reshape(h, w, channels)

    if color == 3:
        table = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(palette, np.uint8)
        entries = entries[: entries.size // 3 * 3].reshape(-1, 3)[:256]
        table[: len(entries)] = entries
        return table[samples[..., 0]]
    if color in (0, 4):
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])
