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
  intervals, 1, 3 or 4 components at every sampling factor, decoded as
  libjpeg-turbo 3.1 decodes them for cv2 (native/jpeg.cpp): CMYK, and
  YCCK turned into CMYK, then RGB as OpenCV converts CMYK; a progressive
  file whose scans leave low coefficients unsent or short of bits (cut
  short, or complete) smoothed as libjpeg smooths it; corrupt data as
  libjpeg treats it;
- TIFF and BigTIFF: the first page; no compression, PackBits, LZW,
  Deflate (8 and 32946), CCITT modified Huffman, T.4 and T.6 (Group 4) and
  JPEG (7: JPEGTables, strips and tiles, YCbCr turned into RGB by libjpeg
  as libtiff asks it to); strips and tiles, contiguous and planar;
  horizontal predictor 2; photometric 0-3 at 1, 2, 4, 8 and 16 bits, 5
  (CMYK, 8-bit, InkSet 1) and 6 (YCbCr, 8-bit, every subsampling libtiff
  puts, its ReferenceBlackWhite and YCbCrCoefficients), each sample mapped
  as libtiff's RGBA interface maps it for cv2 (16-bit gray keeps its high
  byte, 16-bit RGB rounds ``(v + 128) // 257``, unassociated alpha is
  multiplied in, then alpha is dropped);
- EXIF orientation 2-8 is applied as cv2 applies it, from a JPEG's first
  APP1 segment and from a PNG's ``eXIf`` chunk. A TIFF's orientation is
  applied as cv2 5.0 applies it: 4 flips top-bottom; 2 flips each strip or
  tile column left-right within its own width, and 3 does that and flips
  top-bottom (so a tiled page's tiles stay in place); 5-8 give None, as
  imread does;
- a file cv2 cannot read gives ``None``: missing, truncated inside its
  headers, a bad CRC of a critical PNG chunk, bad zlib or LZW data, and
  the TIFF variants cv2's libtiff cannot read or map (LZMA, Zstandard,
  WebP, old-style JPEG, PixarLog, JBIG and LERC compression, which it was
  built without; float samples, the floating-point predictor, 32-bit
  samples, 16-bit CMYK). A JPEG truncated inside its entropy-coded data
  decodes as libjpeg decodes it: the missing blocks are mid-gray.

What cv2 reads and this does not raises ``NotImplementedError`` naming
it, so that no page is skipped silently: arithmetic-coded, lossless and
12-bit JPEG, the TIFF codecs NeXT, ThunderScan, CCITT RLE-W and SGI Log,
a TIFF compression libtiff does not know (JPEG 2000 in TIFF 34712, ...;
cv2 gives an all-zero page for those), CIE L*a*b* TIFF, old-style LZW,
and every other format (BMP, WebP, JPEG 2000, GIF, ...).
``unsupported(path)`` tells these from the headers, without decoding.
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
    (b"II+\x00", "TIFF"),
    (b"MM\x00+", "TIFF"),
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
}

# TIFF compressions decoded here
_TIFF_CODECS = (1, 2, 3, 4, 5, 7, 8, 32773, 32946)
# compressions cv2's libtiff was built without: cv2.imread gives None
_TIFF_NOT_CONFIGURED = {6: "old-style JPEG", 32909: "PixarLog",
                        34661: "JBIG", 34887: "LERC", 34925: "LZMA",
                        50000: "Zstandard", 50001: "WebP"}
# compressions cv2 reads that are not decoded here (libtiff's own NeXT,
# ThunderScan, RLE-W and SGI Log codecs); for a compression libtiff does
# not know (JPEG 2000 34712, JPEG XL 50002, ...) cv2 gives an all-zero page
_TIFF_COMPRESSION_NAMES = {
    32766: "NeXT 2-bit RLE TIFF (compression 32766)",
    32771: "CCITT RLE-W TIFF (compression 32771)",
    32809: "ThunderScan TIFF (compression 32809)",
    34676: "SGI LogLuv TIFF (compression 34676)",
    34677: "SGI LogLuv 24-bit TIFF (compression 34677)",
    34712: "JPEG 2000 in TIFF (compression 34712)",
}

# TIFF field types -> struct codes (rationals as two LONGs; BigTIFF's
# LONG8, SLONG8 and IFD8)
_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B",
               8: "h", 9: "i", 10: "ii", 11: "f", 12: "d", 13: "I",
               16: "Q", 17: "q", 18: "Q"}

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
    cv2.imread cannot read either)."""
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

def _tiff_ifd(data: bytes, order: str, offset: int,
              big: bool = False) -> dict[int, tuple]:
    """The tags of the IFD at ``offset`` (a BigTIFF's when ``big``: 8-byte
    counts and offsets, 20-byte entries): tag -> tuple of values (bytes
    for ASCII and UNDEFINED)."""
    count_code, entry, field = ("Q", 20, 8) if big else ("H", 12, 4)
    count, = struct.unpack_from(order + count_code, data, offset)
    base = offset + struct.calcsize(count_code)
    if base + entry * count > len(data):
        raise _Corrupt("the IFD runs past the end of the file")
    tags: dict[int, tuple] = {}
    for i in range(count):
        at = base + entry * i
        tag, typ = struct.unpack_from(order + "HH", data, at)
        n, = struct.unpack_from(order + ("Q" if big else "I"), data, at + 4)
        code = _TIFF_TYPES.get(typ)
        if code is None:
            continue
        size = struct.calcsize(order + code) * n
        where = at + 4 + field
        if size > field:
            where, = struct.unpack_from(order + ("Q" if big else "I"), data,
                                        where)
        if where + size > len(data):
            raise _Corrupt(f"tag {tag} runs past the end of the file")
        if typ in (2, 7):
            tags[tag] = (data[where: where + n],)
        else:
            tags[tag] = struct.unpack_from(order + code * n, data, where)
    return tags


def _tiff_chunks(tags: dict) -> list[tuple[int, int]]:
    """(offset, byte count) of every strip or tile, planes one after
    another."""
    offsets = tags.get(324) or tags[273]
    counts = tags.get(325) or tags.get(279) or (1 << 62,) * len(offsets)
    return list(zip(offsets, counts))


def _tiff_photometric(tags: dict) -> int:
    return tags.get(262, (1 if tags.get(277, (1,))[0] < 3 else 2,))[0]


def _tiff_header(data: bytes) -> tuple[str, bool, int]:
    """(byte order, BigTIFF, offset of the first IFD)."""
    order = {b"II": "<", b"MM": ">"}[bytes(data[:2])]
    version, = struct.unpack_from(order + "H", data, 2)
    if version == 43:
        if struct.unpack_from(order + "HH", data, 4) != (8, 0):
            raise _Corrupt("bad BigTIFF header")
        return order, True, struct.unpack_from(order + "Q", data, 8)[0]
    if version != 42:
        raise _Corrupt(f"TIFF version {version}")
    return order, False, struct.unpack_from(order + "I", data, 4)[0]


def _tiff_first_page(data: bytes) -> tuple[str, dict]:
    """(byte order, tags of the first IFD). The variants this reader does
    not decode and cv2 reads raise NotImplementedError naming them; those
    cv2's libtiff was built without raise _Corrupt (None, as cv2)."""
    order, big, offset = _tiff_header(data)
    tags = _tiff_ifd(data, order, offset, big)
    compression = tags.get(259, (1,))[0]
    if compression in _TIFF_NOT_CONFIGURED:
        raise _Corrupt(f"{_TIFF_NOT_CONFIGURED[compression]} TIFF: not in "
                       "cv2's libtiff")
    if compression not in _TIFF_CODECS:
        raise NotImplementedError(
            _TIFF_COMPRESSION_NAMES.get(
                compression, f"TIFF compression {compression}")
            + " is not supported")
    if _tiff_photometric(tags) == 8 and tags.get(277, (1,))[0] == 3 \
            and tags.get(258, (1,))[0] in (8, 16):
        # what libtiff's RGBA interface turns into RGB through XYZ
        raise NotImplementedError("CIE L*a*b* TIFF (photometric 8) is not "
                                  "supported")
    if compression == 5:
        for off, _ in _tiff_chunks(tags):
            # libtiff's LZWPreDecode: byte 0 zero and bit 0 of byte 1 set
            # (bits 1-7 hold the low bits of the first LSB-first code)
            if data[off: off + 1] == b"\x00" and \
                    data[off + 1: off + 2] and data[off + 1] & 1:
                raise NotImplementedError("old-style (pre-TIFF 6) LZW is not "
                                          "supported")
    if compression == 7:
        with native.JpegTiffTables(tags.get(347, (b"",))[0]) as tables:
            for off, cnt in _tiff_chunks(tags) if not tables.status else ():
                rc = tables.header(data[off: off + cnt])[0]
                if rc in (2, 3):
                    raise NotImplementedError(
                        f"{_JPEG_VARIANTS[rc]} in TIFF is not supported")
    return order, tags


def _tiff_unpack(compression: int, chunk: bytes, size: int, width: int,
                 rows: int, tags: dict, jpeg=None) -> np.ndarray:
    """One strip or tile's bytes, decompressed to ``size`` bytes (zero
    padded where the data is short, as libtiff leaves the buffer)."""
    if compression == 1:
        out = np.frombuffer(chunk[:size], np.uint8)
    elif compression in (8, 32946):
        out = np.frombuffer(zlib.decompressobj().decompress(chunk, size),
                            np.uint8)
    elif compression == 5:
        out = native.tiff_unpack("lzw", chunk, size)
    elif compression == 32773:
        out = native.tiff_unpack("packbits", chunk, size)
    elif compression == 7:
        return jpeg.decode(chunk, width, rows).reshape(-1)
    else:  # CCITT 2, 3 or 4
        opts = tags.get(292 if compression == 3 else 293, (0,))[0]
        return native.tiff_fax(chunk, width, rows, compression, opts,
                               tags.get(266, (1,))[0]).reshape(-1)
    if out.size < size:
        out = np.concatenate([out, np.zeros(size - out.size, np.uint8)])
    return out


class _TiffJpeg:
    """How libtiff's tif_jpeg.c has libjpeg decode each strip or tile: the
    JPEGTables stream first, YCbCr turned into RGB for a contiguous YCbCr
    page (JPEGCOLORMODE RGB) and the components kept as decoded otherwise,
    the stream's size and sampling checked against the strip's (a last
    strip whose stream holds the full RowsPerStrip is cut)."""

    def __init__(self, tables: native.JpegTiffTables, tags: dict, h: int,
                 components: int, rgb: bool, sampling: tuple[int, int]):
        self.tables = tables
        self.tiled = 322 in tags
        self.h, self.components, self.rgb = h, components, rgb
        self.sampling = sampling
        self.y = 0  # the next strip's first row

    def decode(self, chunk: bytes, width: int, rows: int) -> np.ndarray:
        last = not self.tiled and self.y + rows >= self.h
        self.y += rows
        rc, (sw, sh, nc, h0, v0, rest_1x1) = self.tables.header(chunk)
        if rc:
            raise _Corrupt("JPEG data libtiff cannot read")
        cut = 0
        if sw == width and sh > rows and last:
            cut = rows
        elif sw != width or sh != rows:
            raise _Corrupt(f"a {sw}x{sh} JPEG stream in a {width}x{rows} "
                           "strip or tile")
        if nc != self.components or (h0, v0) != self.sampling \
                or not rest_1x1:
            raise _Corrupt("JPEG components or sampling do not match the "
                           "TIFF's")
        rc, img = self.tables.decode(chunk, 1 if self.rgb else 0, cut)
        if rc:
            raise _Corrupt("JPEG data libtiff cannot read")
        return img


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
              compression: int, order: str, plane: int = 0,
              jpeg: _TiffJpeg | None = None) -> np.ndarray:
    """Every strip or tile of one plane (all of a contiguous page: plane
    0 with every sample) decompressed into (h, row_bytes) raw bytes, the
    predictor undone. libtiff runs predictor 2 inside the LZW and Deflate
    codecs only: with no compression or PackBits the tag does nothing."""
    pixel_bits = bits * spp
    row_bytes = (w * pixel_bits + 7) // 8
    predictor = tags.get(317, (1,))[0] if compression in (5, 8, 32946) \
        else 1
    if predictor == 2 and bits < 8:
        raise _Corrupt("horizontal predictor on samples under 8 bits")
    if predictor not in (1, 2):
        raise _Corrupt(f"predictor {predictor} on integer samples")

    def unpack(chunk, size, width, rows, stride):
        block = _tiff_unpack(compression, chunk, size, width, rows, tags,
                             jpeg)
        block = block.reshape(rows, stride)
        return _undo_predictor(block, bits, spp, order) \
            if predictor == 2 else block

    bits_rev = tags.get(266, (1,))[0] == 2 and \
        compression not in (2, 3, 4, 7)

    def chunk(offset, count):
        blob = data[offset: offset + count]
        return _REVERSED_BITS[np.frombuffer(blob, np.uint8)].tobytes() \
            if bits_rev else blob

    chunks = _tiff_chunks(tags)
    raw = np.zeros((h, row_bytes), np.uint8)
    if 322 in tags:  # tiles, their width a multiple of 16 pixels
        tw, th = tags[322][0], tags[323][0]
        if tw * pixel_bits % 8:
            raise _Corrupt("tile rows do not end on a byte")
        tile_row = tw * pixel_bits // 8
        across, down = -(-w // tw), -(-h // th)
        per_plane = across * down
        for i, (off, cnt) in enumerate(
                chunks[plane * per_plane: (plane + 1) * per_plane]):
            ty, tx = divmod(i, across)
            tile = unpack(chunk(off, cnt), th * tile_row, tw, th, tile_row)
            y0, x0 = ty * th, tx * tile_row
            rows, cols = min(th, h - y0), min(tile_row, row_bytes - x0)
            raw[y0: y0 + rows, x0: x0 + cols] = tile[:rows, :cols]
        return raw
    rps = min(tags.get(278, (h,))[0], h)
    per_plane = -(-h // rps)
    for i, (off, cnt) in enumerate(
            chunks[plane * per_plane: (plane + 1) * per_plane]):
        y0 = i * rps
        rows = min(rps, h - y0)
        raw[y0: y0 + rows] = unpack(chunk(off, cnt), rows * row_bytes, w,
                                    rows, row_bytes)
    return raw


def _tiff_ycbcr_blocks(data: bytes, tags: dict, w: int, h: int,
                       compression: int, hs: int, vs: int) -> np.ndarray:
    """A contiguous YCbCr page's packed blocks (each vs rows by hs
    columns: its hs * vs Y samples, then one Cb and one Cr) -> (h, w, 3)
    Y, Cb, Cr samples, each block's chroma repeated over its pixels, as
    tif_getimage.c's putcontig8bitYCbCr*tile do. Of a strip libtiff reads
    only its rows rounded up to vs times TIFFScanlineSize (the block row
    over vs, rounded down); the bytes past that stay zero."""
    block = hs * vs + 2
    out = np.zeros((h, w, 3), np.uint8)

    def put(chunk, y0, x0, rows, cols, span, take):
        across, down = -(-span // hs), -(-rows // vs)
        size = down * across * block
        raw = _tiff_unpack(compression, chunk, min(size, take), span, rows,
                           tags)[:size]
        raw = np.concatenate([raw, np.zeros(size - raw.size, np.uint8)])
        used = -(-cols // hs)
        if (hs, vs) == (4, 4) and cols < span:
            # putcontig8bitYCbCr44tile skips a clipped tile's unseen
            # blocks as 4x2 blocks of 10 bytes
            stride = used * block + (span - cols) // 4 * 10
            b = np.stack([raw[r * stride: r * stride + used * block]
                          for r in range(down)]).reshape(down, used, block)
        else:
            b = raw.reshape(down, across, block)[:, :used]
        y = b[..., : hs * vs].reshape(down, used, vs, hs) \
            .transpose(0, 2, 1, 3).reshape(down * vs, used * hs)
        chroma = np.repeat(np.repeat(b[..., hs * vs:], vs, 0), hs, 1)
        px = np.concatenate([y[..., None], chroma], axis=2)
        out[y0: y0 + rows, x0: x0 + cols] = px[:rows, :cols]

    chunks = _tiff_chunks(tags)
    if 322 in tags:
        tw, th = tags[322][0], tags[323][0]
        across = -(-w // tw)
        for i, (off, cnt) in enumerate(chunks[: across * -(-h // th)]):
            ty, tx = divmod(i, across)
            y0, x0 = ty * th, tx * tw
            put(data[off: off + cnt], y0, x0, min(th, h - y0),
                min(tw, w - x0), tw, 1 << 62)
        return out
    rps = min(tags.get(278, (h,))[0], h)
    scanline = -(-w // hs) * block // vs
    for i, (off, cnt) in enumerate(chunks[: -(-h // rps)]):
        y0 = i * rps
        rows = min(rps, h - y0)
        put(data[off: off + cnt], y0, 0, rows, w, w,
            -(-rows // vs) * vs * scanline)
    return out


def _ycbcr_tables(tags: dict) -> tuple[np.ndarray, ...]:
    """tif_color.c TIFFYCbCrToRGBInit: the Y, Cr->R, Cb->B, Cr->G and
    Cb->G tables, built in float from YCbCrCoefficients (tag 529) and
    ReferenceBlackWhite (tag 532) as libtiff reads their RATIONALs into
    floats, then FIX()ed to 16-bit fixed point."""
    f32 = np.float32

    def rationals(tag, default):
        v = tags.get(tag)
        if v is None or len(v) < 2 * len(default):
            return [f32(x) for x in default]
        return [f32(0.0) if d == 0 else f32(n) / f32(d)
                for n, d in zip(v[0::2], v[1::2])][: len(default)]

    luma = rationals(529, (0.299, 0.587, 0.114))
    rbw = rationals(532, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0))
    if any(np.isnan(luma)) or luma[1] == 0 or any(
            not (-0x7FFFFFFF + 128 < x < 0x7FFFFFFF) for x in rbw):
        raise _Corrupt("invalid YCbCr coefficients or reference values")

    def fix(x):  # FIX(CLAMP(x, 0, 2)): (int32)(x * 65536 + 0.5) in double
        x = f32(0.0) if not x >= 0 else min(x, f32(2.0))
        return int(np.float64(f32(x) * f32(65536.0)) + 0.5)

    f1 = f32(2.0) - f32(2.0) * luma[0]
    f3 = f32(2.0) - f32(2.0) * luma[2]
    d1, d2 = fix(f1), -fix(luma[0] * f1 / luma[1])
    d3, d4 = fix(f3), -fix(luma[2] * f3 / luma[1])

    def code2v(c, rb, rw, cr):  # Code2V, CLAMPw(-4096, 4096), (int32_t)
        den = rw - rb
        v = (c - np.int32(rb)).astype(f32) * f32(cr) / (den if den != 0
                                                        else f32(1.0))
        return np.clip(v, f32(-4096.0), f32(4096.0)).astype(np.int64)

    x = np.arange(-128, 128, dtype=np.int64)
    cr = code2v(x, rbw[4] - f32(128.0), rbw[5] - f32(128.0), 127)
    cb = code2v(x, rbw[2] - f32(128.0), rbw[3] - f32(128.0), 127)
    one_half = 1 << 15
    return (code2v(x + 128, rbw[0], rbw[1], 255), (d1 * cr + one_half) >> 16,
            (d3 * cb + one_half) >> 16, d2 * cr, d4 * cb + one_half)


def _ycbcr_to_rgb(ycc: np.ndarray, tags: dict) -> np.ndarray:
    """tif_color.c TIFFYCbCrtoRGB over (h, w, 3) Y, Cb, Cr samples."""
    return native.tiff_ycbcr(ycc, np.stack(_ycbcr_tables(tags)))


# YCbCrSubsampling blocks libtiff's RGBA interface puts (tif_getimage.c
# putcontig8bitYCbCr{44,42,41,22,21,12,11}tile); others it cannot handle
_YCBCR_SAMPLING = ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))


def _decode_tiff(data: bytes) -> np.ndarray | None:
    order, tags = _tiff_first_page(data)
    if tags.get(259, (1,))[0] != 7:
        return _decode_tiff_page(data, order, tags, None)
    # JPEG: one decompressor for the page's strips, as in tif_jpeg.c
    with native.JpegTiffTables(tags.get(347, (b"",))[0]) as tables:
        return _decode_tiff_page(data, order, tags, tables)


def _decode_tiff_page(data: bytes, order: str, tags: dict,
                      tables: native.JpegTiffTables | None
                      ) -> np.ndarray | None:
    w, h = tags[256][0], tags[257][0]
    if w == 0 or h == 0:
        raise _Corrupt("empty image")
    spp = tags.get(277, (1,))[0]
    bits = tags.get(258, (1,))[0]
    compression = tags.get(259, (1,))[0]
    photometric = _tiff_photometric(tags)
    planar = tags.get(284, (1,))[0] == 2 and spp > 1
    extra = tags.get(338, ())
    # what libtiff's RGBA interface (TIFFRGBAImageOK, PickContigCase,
    # PickSeparateCase) and cv2's TIFF decoder cannot handle: None
    if bits not in (1, 2, 4, 8, 16) or not 1 <= spp <= 4 \
            or tags.get(339, (1,))[0] not in (1, 2):
        raise _Corrupt(f"{bits}-bit samples, {spp} samples per pixel")
    if spp < (3 if photometric == 2 else 1):
        raise _Corrupt("too few samples per pixel")
    if compression in (2, 3, 4) and (bits != 1 or spp != 1):
        raise _Corrupt("CCITT data of more than one bit a pixel")
    orientation = tags.get(274, (1,))[0]
    if orientation in (5, 6, 7, 8):
        return None  # cv2 5.0's imread fails on these
    sampling = (1, 1)
    jpeg = None
    if compression == 7:
        if tables.status:
            raise _Corrupt("a bogus JPEGTables field")
        rgb = photometric == 6 and not planar
        if rgb:  # tif_getimage.c sets JPEGCOLORMODE RGB: an RGB page now
            if 530 in tags:
                sampling = tuple(tags[530][:2])
            else:  # tif_jpeg.c JPEGFixupTagsSubsampling: the stream's
                off, cnt = _tiff_chunks(tags)[0]
                sampling = tables.header(data[off: off + cnt])[1][3:5]
            photometric = 2
        jpeg = _TiffJpeg(tables, tags, h, 1 if planar else spp, rgb,
                         sampling)
    if photometric in (0, 1):
        if bits in (2, 4):
            return None  # cv2 5.0's imread fails on 2- and 4-bit gray
        if (bits < 8 and spp > 1) or (planar and bits != 16 and bits != 8):
            raise _Corrupt("gray layout libtiff cannot handle")
    elif photometric == 2:
        if bits not in (8, 16) or spp - len(extra) < 3:
            raise _Corrupt("RGB layout libtiff cannot handle")
    elif photometric == 3:
        if bits == 16 or planar or (bits < 8 and spp > 1):
            raise _Corrupt("palette layout libtiff cannot handle")
    elif photometric == 5:
        if bits != 8 or spp != 4 or tags.get(332, (1,))[0] != 1:
            raise _Corrupt("separated (CMYK) layout libtiff cannot handle")
    elif photometric == 6:
        sampling = tuple(tags.get(530, (2, 2))[:2])
        if bits != 8 or spp != 3 or sampling not in _YCBCR_SAMPLING \
                or (planar and sampling != (1, 1)):
            raise _Corrupt("YCbCr layout libtiff cannot handle")
    else:
        raise _Corrupt(f"photometric {photometric}")

    if photometric == 6 and not planar:
        samples = _tiff_ycbcr_blocks(data, tags, w, h, compression,
                                     *sampling)
    elif planar:
        samples = np.stack([
            _tiff_raw(data, tags, w, h, bits, 1, compression, order, s, jpeg)
            .view(order + "u2" if bits == 16 else np.uint8)
            for s in range(spp)], axis=-1)
    else:
        raw = _tiff_raw(data, tags, w, h, bits, spp, compression, order,
                        jpeg=jpeg)
        if bits == 16:
            samples = raw.view(order + "u2").reshape(h, w, spp)
        elif bits == 8:
            samples = raw.reshape(h, w, spp)
        else:
            samples = _unpack_bits(raw, bits)[:, : w * spp].reshape(h, w,
                                                                     spp)

    # libtiff's RGBA interface (tif_getimage.c), as cv2 reads it
    alpha = samples[..., -1] if spp > (1 if photometric in (0, 1) else 3) \
        else None
    if photometric in (0, 1) and not planar:
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
    elif photometric == 5:  # putRGBcontig8bitCMYKtile, putCMYKseparate8bit
        k = 255 - samples[..., 3:4].astype(np.int32)
        img = (k * (255 - samples[..., :3].astype(np.int32)) // 255) \
            .astype(np.uint8)
    elif photometric == 6:
        img = _ycbcr_to_rgb(samples[..., :3], tags)
    else:  # RGB, and gray in separate planes (r = g = b, not inverted)
        rgb = samples[..., :3] if photometric == 2 else \
            np.repeat(samples[..., :1], 3, axis=2)
        if bits == 16:  # Bitdepth16To8
            rgb = ((rgb.astype(np.int64) + 128) // 257).astype(np.uint8)
            if alpha is not None:
                alpha = ((alpha.astype(np.int64) + 128) // 257)
        if alpha is not None and extra[:1] == (2,):  # unassociated alpha
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
