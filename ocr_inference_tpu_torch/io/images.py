"""Page images from files: the port's counterpart of
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` for PNG, JPEG and
TIFF, byte for byte.

The card machine has neither OpenCV nor PIL, so the formats are decoded
here on stdlib ``zlib`` and numpy, with the pixel loops in native code
(native/png.cpp, jpeg.cpp, tiff.cpp). What ``cv2.imread(path)``
(``IMREAD_COLOR``) gives, this gives in RGB order:

- PNG: colour types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and
  6 (RGBA) at every bit depth the type allows, plain or Adam7-interlaced;
  gray and palette are expanded to three channels; alpha is dropped, not
  composited; 16-bit samples keep their high byte (libpng's
  ``png_set_strip_16``); gray below 8 bits is scaled to 0..255;
- JPEG: baseline, extended and progressive Huffman coding, restart
  intervals, 1 or 3 components at every sampling factor, decoded as
  libjpeg-turbo decodes them for cv2 (native/jpeg.cpp);
- TIFF: the first page; no compression, PackBits, LZW, Deflate (8 and
  32946) and CCITT modified Huffman, T.4 and T.6 (Group 4); strips and
  tiles; horizontal predictor 2; photometric 0-3 at 1, 2, 4, 8 and 16 bits,
  each sample mapped as libtiff's RGBA interface maps it for cv2 (16-bit
  gray keeps its high byte, 16-bit RGB rounds ``(v + 128) // 257``,
  unassociated alpha is multiplied in, then alpha is dropped);
- EXIF orientation 2-8 is applied as cv2 applies it, from a JPEG's first
  APP1 segment and from a PNG's ``eXIf`` chunk. A TIFF's orientation is
  applied as cv2 5.0 applies it: 4 flips top-bottom; 2 flips each strip or
  tile column left-right within its own width, and 3 does that and flips
  top-bottom (so a tiled page's tiles stay in place); 5-8 give None, as
  imread does;
- a file cv2 cannot read (missing, truncated inside its headers, a bad CRC
  of a critical PNG chunk, bad zlib or LZW data) gives ``None``. A JPEG
  truncated inside its entropy-coded data decodes as libjpeg decodes it:
  the missing blocks are mid-gray.

What cv2 reads and this does not raises ``NotImplementedError`` naming
it, so that no page is skipped silently: CMYK/YCCK, 12-bit, arithmetic-
coded and lossless JPEG, a progressive JPEG whose scans leave
coefficients unsent (libjpeg smooths those blocks), JPEG-in-TIFF, planar
TIFF, the floating-point predictor and other TIFF codecs, BigTIFF, and
every other format (BMP, WebP, JPEG 2000, GIF, ...).
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
    (b"II+\x00", "BigTIFF"),
    (b"MM\x00+", "BigTIFF"),
    (b"BM", "BMP"),
    (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"),
    (b"\xffO\xffQ", "JPEG 2000"),
    (b"GIF8", "GIF"),
    (b"v/1\x01", "OpenEXR"),
    (b"#?RADIANCE", "Radiance HDR"),
    (b"\x59\xa6\x6a\x95", "Sun raster"),
)

# channels of each PNG colour type, and the bit depths it allows
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}

# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

# jpeg.cpp's status codes for the variants it does not decode
_JPEG_VARIANTS = {
    2: "arithmetic-coded JPEG",
    3: "lossless JPEG",
    4: "JPEG with 12- or 16-bit samples",
    5: "CMYK/YCCK JPEG (four components)",
    6: "progressive JPEG with coefficients left unsent (block smoothing)",
}

_TIFF_COMPRESSION_NAMES = {
    6: "old-style JPEG-in-TIFF (compression 6)",
    7: "JPEG-in-TIFF (compression 7)",
    34712: "JPEG 2000 in TIFF (compression 34712)",
    34925: "LZMA TIFF (compression 34925)",
    50000: "Zstandard TIFF (compression 50000)",
    50001: "WebP in TIFF (compression 50001)",
}

# TIFF field types -> struct codes (rationals as two LONGs)
_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B",
               8: "h", 9: "i", 10: "ii", 11: "f", 12: "d", 13: "I"}

_REVERSED_BITS = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                          np.uint8)


class _Corrupt(ValueError):
    """The file cannot be decoded; cv2.imread gives None for it."""


def image_format(path: str | Path) -> str | None:
    """The image format of a file by its leading bytes: "PNG", "JPEG",
    "TIFF", another format's name, or None for a file that is missing or of
    no known format."""
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


def unsupported(path: str | Path) -> str | None:
    """Why read_image would refuse a file, judged from its headers: the
    format or variant it names, or None for a file it reads (or that
    cv2.imread cannot read either). A progressive JPEG that libjpeg would
    smooth shows only when it is decoded."""
    fmt = image_format(path)
    if fmt is None or fmt == "PNG":
        return None
    if fmt not in _DECODERS:
        return f"{fmt} images are not supported"
    try:
        data = Path(path).read_bytes()
        if fmt == "JPEG":
            rc = native.jpeg_header(data)[0]
            if rc > 1:
                return f"{_JPEG_VARIANTS[rc]} is not supported"
        else:
            _tiff_first_page(data)
    except NotImplementedError as e:
        return str(e)
    except (OSError, KeyError, struct.error, ValueError, IndexError,
            _Corrupt):
        pass
    return None


def read_image(path: str | Path) -> np.ndarray | None:
    """A PNG, JPEG or TIFF file -> (H, W, 3) uint8 RGB, or None when it
    cannot be read (see the module doc). Other formats and the variants
    the module doc names raise NotImplementedError."""
    fmt = image_format(path)
    if fmt is None:
        return None
    decode = _DECODERS.get(fmt)
    if decode is None:
        raise NotImplementedError(
            f"{path}: {fmt} images are not supported; PNG, JPEG and TIFF "
            "are read")
    try:
        return decode(Path(path).read_bytes())
    except NotImplementedError as e:
        raise NotImplementedError(f"{path}: {e}") from None
    except (OSError, _Corrupt, zlib.error, struct.error, ValueError,
            IndexError, KeyError):
        return None


# ---------------------------------------------------------------------------
# EXIF orientation
# ---------------------------------------------------------------------------

def _exif_orientation(tiff: bytes) -> int:
    """Tag 0x0112 of a TIFF-structured EXIF block's first IFD, read as
    OpenCV's ExifReader reads it (the SHORT at the entry's value field);
    1 when there is none."""
    order = {b"II": "<", b"MM": ">"}.get(bytes(tiff[:2]))
    if order is None:
        return 1
    try:
        if struct.unpack_from(order + "H", tiff, 2)[0] != 42:
            return 1
        ifd, = struct.unpack_from(order + "I", tiff, 4)
        count, = struct.unpack_from(order + "H", tiff, ifd)
        for i in range(count):
            at = ifd + 2 + 12 * i
            if struct.unpack_from(order + "H", tiff, at)[0] == 0x0112:
                return struct.unpack_from(order + "H", tiff, at + 8)[0]
    except struct.error:
        pass
    return 1


def _apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ExifTransform: 2 flips left-right, 3 rotates 180, 4 flips
    top-bottom; 5-8 transpose first, then flip as 1-4 do."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
        orientation -= 4
    if orientation in (2, 3):
        img = img[:, ::-1]
    if orientation in (3, 4):
        img = img[::-1]
    return np.ascontiguousarray(img)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _chunks(data: bytes):
    """(type, payload, crc ok) of each chunk up to IEND; a critical chunk
    with a bad CRC, or a file that ends inside a chunk, is corrupt."""
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
        crc_ok = zlib.crc32(tag + payload) == crc
        if not (tag[0] & 0x20) and not crc_ok:
            raise _Corrupt(f"bad CRC in {tag!r}")
        yield tag, payload, crc_ok
        if tag == b"IEND":
            return
        pos = end + 4


def _png_samples(rows: np.ndarray, w: int, h: int, depth: int,
                 channels: int, color: int) -> np.ndarray:
    """Unfiltered rows (h, row_bytes) -> (h, w, channels) uint8 samples."""
    if depth == 16:  # big-endian samples; keep the high byte
        samples = rows.reshape(h, w * channels, 2)[..., 0]
    elif depth == 8:
        samples = rows
    else:  # 1, 2 or 4 bits a sample, first sample in the high bits
        samples = _unpack_bits(rows, depth)[:, :w]
        if color == 0:  # scale gray to 0..255
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
    return samples.reshape(h, w, channels)


def _unpack_bits(rows: np.ndarray, depth: int) -> np.ndarray:
    """(h, row_bytes) of ``depth``-bit samples, first in the high bits ->
    (h, row_bytes * 8 // depth) uint8."""
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    out = (rows[..., None] >> shifts) & np.uint8((1 << depth) - 1)
    return out.reshape(rows.shape[0], -1)


def _decode_png(data: bytes) -> np.ndarray:
    header = palette = exif = None
    idat = []
    for tag, payload, crc_ok in _chunks(data):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            palette = payload
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"eXIf" and crc_ok and exif is None:
            exif = payload
    if header is None or not idat:
        raise _Corrupt("no IHDR or no IDAT")
    w, h, depth, color, compression, filtering, interlace = header
    if color not in _CHANNELS or depth not in _DEPTHS[color] or w == 0 \
            or h == 0 or compression or filtering or interlace > 1:
        raise _Corrupt(f"invalid header {header}")
    if color == 3 and palette is None:
        raise _Corrupt("palette image without PLTE")

    channels = _CHANNELS[color]
    bpp = max(1, channels * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace:
        samples = np.zeros((h, w, channels), np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            row_bytes = (pw * channels * depth + 7) // 8
            size = ph * (row_bytes + 1)
            if raw.size < pos + size:
                raise _Corrupt("image data too short")
            rows = native.png_unfilter(raw[pos: pos + size], ph, row_bytes,
                                       bpp)
            samples[y0::dy, x0::dx] = _png_samples(rows, pw, ph, depth,
                                                   channels, color)
            pos += size
    else:
        row_bytes = (w * channels * depth + 7) // 8
        if raw.size < h * (row_bytes + 1):
            raise _Corrupt("image data too short")
        rows = native.png_unfilter(raw[: h * (row_bytes + 1)], h, row_bytes,
                                   bpp)
        samples = _png_samples(rows, w, h, depth, channels, color)

    if color == 3:
        table = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(palette, np.uint8)
        entries = entries[: entries.size // 3 * 3].reshape(-1, 3)[:256]
        table[: len(entries)] = entries
        img = table[samples[..., 0]]
    elif color in (0, 4):
        img = np.repeat(samples[..., :1], 3, axis=2)
    else:
        img = np.ascontiguousarray(samples[..., :3])
    return _apply_orientation(img, _exif_orientation(exif or b""))


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

def _jpeg_app1(data: bytes) -> bytes:
    """The first APP1 segment before the first scan, less its 6 leading
    bytes ("Exif\\0\\0"): the block OpenCV's JPEG decoder parses."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF or marker == 0x01 or 0xD0 <= marker <= 0xD7:
            pos += 1 if marker == 0xFF else 2
            continue
        if marker in (0xDA, 0xD9):
            break
        length = (data[pos + 2] << 8) | data[pos + 3]
        if marker == 0xE1:
            return data[pos + 4: pos + 2 + length][6:]
        pos += 2 + length
    return b""


def _decode_jpeg(data: bytes) -> np.ndarray:
    rc, img = native.jpeg_decode(data)
    if rc == 1:
        raise _Corrupt("JPEG data cv2 cannot read")
    if rc:
        raise NotImplementedError(f"{_JPEG_VARIANTS[rc]} is not supported")
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return _apply_orientation(img, _exif_orientation(_jpeg_app1(data)))


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

def _tiff_ifd(data: bytes, order: str, offset: int) -> dict[int, tuple]:
    """The tags of the IFD at ``offset``: tag -> tuple of values (bytes
    for ASCII and UNDEFINED)."""
    count, = struct.unpack_from(order + "H", data, offset)
    tags: dict[int, tuple] = {}
    for i in range(count):
        at = offset + 2 + 12 * i
        tag, typ, n = struct.unpack_from(order + "HHI", data, at)
        code = _TIFF_TYPES.get(typ)
        if code is None:
            continue
        size = struct.calcsize(order + code) * n
        where = at + 8 if size <= 4 else \
            struct.unpack_from(order + "I", data, at + 8)[0]
        if where + size > len(data):
            raise _Corrupt(f"tag {tag} runs past the end of the file")
        if typ in (2, 7):
            tags[tag] = (data[where: where + n],)
        else:
            tags[tag] = struct.unpack_from(order + code * n, data, where)
    return tags


def _tiff_unpack(compression: int, chunk: bytes, size: int, width: int,
                 rows: int, tags: dict) -> np.ndarray:
    """One strip or tile's bytes, decompressed to ``size`` bytes (zero
    padded where the data is short, as libtiff leaves the buffer)."""
    if compression == 1:
        out = np.frombuffer(chunk[:size], np.uint8)
    elif compression in (8, 32946):
        out = np.frombuffer(zlib.decompressobj().decompress(chunk, size),
                            np.uint8)
    elif compression == 5:
        if chunk[:2] == b"\x00\x01":
            raise NotImplementedError("old-style (pre-TIFF 6) LZW is not "
                                      "supported")
        out = native.tiff_unpack("lzw", chunk, size)
    elif compression == 32773:
        out = native.tiff_unpack("packbits", chunk, size)
    else:  # CCITT 2, 3 or 4 (_tiff_first_page refused the others)
        opts = tags.get(292 if compression == 3 else 293, (0,))[0]
        if compression == 4 and opts & 2:
            raise NotImplementedError("uncompressed mode in Group 4 TIFF is "
                                      "not supported")
        return native.tiff_fax(chunk, width, rows, compression, opts,
                               tags.get(266, (1,))[0]).reshape(-1)
    if out.size < size:
        out = np.concatenate([out, np.zeros(size - out.size, np.uint8)])
    return out


def _undo_predictor(block: np.ndarray, bits: int, spp: int,
                    order: str) -> np.ndarray:
    """Horizontal predictor 2 over (rows, row_bytes) of one strip or tile:
    each sample is the running sum of its row, wrapping."""
    if bits == 16:
        samples = block.view(order + "u2").reshape(block.shape[0], -1, spp)
    else:
        samples = block.reshape(block.shape[0], -1, spp)
    summed = np.cumsum(samples, axis=1, dtype=samples.dtype)
    return summed.astype(samples.dtype).reshape(block.shape[0], -1) \
        .view(np.uint8)


def _tiff_raw(data: bytes, tags: dict, w: int, h: int, bits: int, spp: int,
              compression: int, order: str) -> np.ndarray:
    """Every strip or tile decompressed into (h, row_bytes) raw bytes,
    the predictor undone. libtiff runs predictor 2 inside the LZW and
    Deflate codecs only: with no compression or PackBits the tag does
    nothing."""
    pixel_bits = bits * spp
    row_bytes = (w * pixel_bits + 7) // 8
    predictor = tags.get(317, (1,))[0] if compression in (5, 8, 32946) \
        else 1
    if predictor == 2 and bits < 8:
        raise _Corrupt("horizontal predictor on samples under 8 bits")
    if predictor not in (1, 2):
        raise _Corrupt(f"unknown predictor {predictor}")

    def unpack(chunk, size, width, rows, stride):
        block = _tiff_unpack(compression, chunk, size, width, rows, tags)
        block = block.reshape(rows, stride)
        return _undo_predictor(block, bits, spp, order) \
            if predictor == 2 else block

    bits_rev = tags.get(266, (1,))[0] == 2 and compression not in (2, 3, 4)

    def chunk(offset, count):
        blob = data[offset: offset + count]
        return _REVERSED_BITS[np.frombuffer(blob, np.uint8)].tobytes() \
            if bits_rev else blob

    raw = np.zeros((h, row_bytes), np.uint8)
    if 322 in tags:  # tiles, their width a multiple of 16 pixels
        tw, th = tags[322][0], tags[323][0]
        if tw * pixel_bits % 8:
            raise _Corrupt("tile rows do not end on a byte")
        tile_row = tw * pixel_bits // 8
        across = -(-w // tw)
        for i, (off, cnt) in enumerate(zip(tags[324], tags[325])):
            ty, tx = divmod(i, across)
            if ty * th >= h:
                break
            tile = unpack(chunk(off, cnt), th * tile_row, tw, th, tile_row)
            y0, x0 = ty * th, tx * tile_row
            rows, cols = min(th, h - y0), min(tile_row, row_bytes - x0)
            raw[y0: y0 + rows, x0: x0 + cols] = tile[:rows, :cols]
        return raw
    rps = min(tags.get(278, (h,))[0], h)
    offsets = tags[273]
    counts = tags.get(279) or (len(data),) * len(offsets)
    for i, (off, cnt) in enumerate(zip(offsets, counts)):
        y0 = i * rps
        if y0 >= h:
            break
        rows = min(rps, h - y0)
        raw[y0: y0 + rows] = unpack(chunk(off, cnt), rows * row_bytes, w,
                                    rows, row_bytes)
    return raw


def _tiff_first_page(data: bytes) -> tuple[str, dict]:
    """(byte order, tags of the first IFD), the variants this reader does
    not decode refused by name."""
    order = {b"II": "<", b"MM": ">"}[data[:2]]
    tags = _tiff_ifd(data, order, struct.unpack_from(order + "I", data, 4)[0])
    spp = tags.get(277, (1,))[0]
    compression = tags.get(259, (1,))[0]
    if compression not in (1, 2, 3, 4, 5, 8, 32773, 32946):
        raise NotImplementedError(
            _TIFF_COMPRESSION_NAMES.get(
                compression, f"TIFF compression {compression}")
            + " is not supported")
    if tags.get(284, (1,))[0] == 2 and spp > 1:
        raise NotImplementedError("planar TIFF (PlanarConfiguration 2) is "
                                  "not supported")
    if tags.get(317, (1,))[0] == 3:
        raise NotImplementedError("the floating-point TIFF predictor (3) is "
                                  "not supported")
    if tags.get(339, (1,))[0] not in (1, 2):
        raise NotImplementedError("floating-point TIFF samples are not "
                                  "supported")
    photometric = tags.get(262, (1 if spp < 3 else 2,))[0]
    if photometric not in (0, 1, 2, 3):
        names = {5: "CMYK (separated)", 6: "YCbCr", 8: "CIE L*a*b*"}
        raise NotImplementedError(
            f"{names.get(photometric, f'photometric {photometric}')} TIFF "
            "is not supported")
    bits = tags.get(258, (1,))[0]
    allowed = {0: (1, 2, 4, 8, 16), 1: (1, 2, 4, 8, 16), 2: (8, 16),
               3: (1, 2, 4, 8)}[photometric]
    if bits not in allowed:
        raise NotImplementedError(f"{bits}-bit TIFF samples are not "
                                  "supported here")
    return order, tags


def _decode_tiff(data: bytes) -> np.ndarray | None:
    order, tags = _tiff_first_page(data)
    w, h = tags[256][0], tags[257][0]
    if w == 0 or h == 0:
        raise _Corrupt("empty image")
    spp = tags.get(277, (1,))[0]
    bits = tags.get(258, (1,))[0]
    compression = tags.get(259, (1,))[0]
    photometric = tags.get(262, (1 if spp < 3 else 2,))[0]
    if spp < (3 if photometric == 2 else 1):
        raise _Corrupt("too few samples per pixel")
    if compression in (2, 3, 4) and (bits != 1 or spp != 1):
        raise _Corrupt("CCITT data of more than one bit a pixel")
    orientation = tags.get(274, (1,))[0]
    if orientation in (5, 6, 7, 8):
        return None  # cv2 5.0's imread fails on these
    if photometric in (0, 1) and bits in (2, 4):
        return None  # cv2 5.0's imread fails on 2- and 4-bit gray

    raw = _tiff_raw(data, tags, w, h, bits, spp, compression, order)
    if bits == 16:
        samples = raw.view(order + "u2").reshape(h, w, spp)
    elif bits == 8:
        samples = raw.reshape(h, w, spp)
    else:
        samples = _unpack_bits(raw, bits)[:, : w * spp].reshape(h, w, spp)

    # libtiff's RGBA interface (tif_getimage.c), as cv2 reads it
    if photometric in (0, 1):
        if bits == 16:
            v = (samples[..., 0] >> 8).astype(np.uint8)
            gray = 255 - v if photometric == 0 else v
        else:
            top = (1 << bits) - 1
            v = samples[..., 0].astype(np.int32)
            if photometric == 0:
                v = top - v
            gray = (v * 255 // top).astype(np.uint8)
        img = np.repeat(gray[..., None], 3, axis=2)
    elif photometric == 3:
        cmap = np.asarray(tags[320], np.int64).reshape(3, 1 << bits)
        if (cmap >= 256).any():  # a 16-bit colormap (checkcmap)
            cmap = cmap >> 8
        img = cmap.T.astype(np.uint8)[samples[..., 0]]
    else:
        rgb = samples[..., :3]
        alpha = samples[..., 3] if spp > 3 else None
        if bits == 16:
            rgb = ((rgb.astype(np.int64) + 128) // 257).astype(np.uint8)
            if alpha is not None:
                alpha = ((alpha.astype(np.int64) + 128) // 257)
        extra = tags.get(338, (0,))
        if alpha is not None and extra[0] == 2:  # unassociated alpha
            a = alpha.astype(np.int64)[..., None]
            rgb = ((rgb.astype(np.int64) * a + 127) // 255).astype(np.uint8)
        img = np.ascontiguousarray(rgb, dtype=np.uint8)
    if orientation in (2, 3):
        # libtiff flips each tile (or strip) left-right within its own
        # width: a tiled page's tile columns stay where they are
        step = tags[322][0] if 322 in tags else w
        img = np.concatenate([img[:, x: x + step][:, ::-1]
                              for x in range(0, w, step)], axis=1)
    if orientation in (3, 4):
        img = img[::-1]
    return np.ascontiguousarray(img)


_DECODERS = {"PNG": _decode_png, "JPEG": _decode_jpeg, "TIFF": _decode_tiff}
