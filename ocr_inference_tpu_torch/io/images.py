"""Page images from files: the port's counterpart of
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` for PNG, JPEG, TIFF,
JPEG 2000, BMP, PNM, PAM, GIF, WebP, Sun raster, colour PFM, Radiance HDR
and AVIF, byte for byte.

The card machine has neither OpenCV, PIL, libwebp nor libavif, so the
formats are decoded here on stdlib ``zlib`` and numpy, with the pixel
loops in native code (native/png.cpp, jpeg.cpp, tiff.cpp, jp2.cpp,
bmp.cpp, gif.cpp, webp.cpp, hdr.cpp, av1.cpp). A file's format is
told from its leading bytes as cv2 5.0's findDecoder tells it (its name
plays no part). What ``cv2.imread(path)`` (``IMREAD_COLOR``) gives, this
gives in RGB order:

- PNG: colour types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and
  6 (RGBA) at every bit depth the type allows, plain or Adam7-interlaced;
  gray and palette are expanded to three channels; alpha is dropped, not
  composited; 16-bit samples keep their high byte (libpng's
  ``png_set_strip_16``); gray below 8 bits is scaled to 0..255;
- JPEG: baseline, extended and progressive, Huffman or arithmetic coding
  (SOF9/SOF10, with DAC conditioning), restart intervals, 1, 3 or 4
  components at every sampling factor, decoded as libjpeg-turbo 3.1
  decodes them for cv2 (native/jpeg.cpp): CMYK, and YCCK turned into
  CMYK, then RGB as OpenCV converts CMYK; a progressive file whose scans
  leave low coefficients unsent or short of bits (cut short, or complete)
  smoothed as libjpeg smooths it; corrupt data as libjpeg treats it.
  Lossless JPEG (SOF3: predictors 1-7, point transform, restarts, any
  integral sampling factors, in one interleaved scan or one scan a
  component, subsampled components replicated as libjpeg-turbo's lossless
  mode upsamples them) of 2-8 bits decodes where libjpeg-turbo need not
  convert its colours for OpenCV: RGB (no JFIF marker, Adobe transform 0
  or none) and CMYK; a component no scan reached gives None; gray,
  YCbCr and YCCK lossless frames, lossless frames of 9-16 bits,
  arithmetic-coded lossless (SOF11) and 12-bit DCT frames give None, as
  OpenCV 5.0 reads only 8-bit samples;
- TIFF and BigTIFF: the first page; no compression, PackBits, LZW (TIFF 6
  and old-style codes), Deflate (8 and 32946), CCITT modified Huffman,
  RLE-W, T.4 and T.6 (Group 4), ThunderScan, SGI LogL and LogLuv (32- and
  24-bit, mapped as libtiff's RGBA interface asks tif_luv.c to: 8-bit gray
  or RGB) and JPEG (7: JPEGTables, strips and tiles, YCbCr turned into RGB
  by libjpeg as libtiff asks it to; the JPEG variants above); strips and
  tiles, contiguous and planar; horizontal predictor 2; photometric 0-3
  at 1, 2, 4, 8 and 16 bits, 5 (CMYK, 8-bit, InkSet 1), 6 (YCbCr, 8-bit,
  every subsampling libtiff puts, its ReferenceBlackWhite and
  YCbCrCoefficients) and 8 (CIE L*a*b*, 8- and 16-bit, through XYZ to
  sRGB with tif_color.c's tables and the WhitePoint, D50 by default), each
  sample mapped as libtiff's RGBA interface maps it for cv2 (16-bit gray
  keeps its high byte, 16-bit RGB rounds ``(v + 128) // 257``,
  unassociated alpha is multiplied in, then alpha is dropped);
- a damaged or cut strip or tile is read as libtiff reads it for cv2's
  RGBA reader, which reads on past a failed strip: the rows decoded before
  the fault are kept, what the codec makes of the rest follows libtiff
  (CCITT: tif_fax3.c's recovery row by row, its run arrays carried from
  strip to strip, T.4 retried without EOLs from the strip's start; LZW and
  Deflate: what was decoded before the bad code or check; JPEG: libjpeg's
  corrupt-data handling), and the buffer past it stays zero (a predictor
  is then not undone). A strip that is empty or runs past the end of the
  file, or whose JPEG header libjpeg rejects, fails before any buffer is
  made: cv2 gives None;
- JPEG 2000: JP2 files (their boxes as OpenJPEG's jp2.c reads them: the
  signature and ftyp boxes, jp2h with ihdr, the first colr, pclr/cmap
  palettes and cdef channel definitions, then jp2c, XL and zero box
  lengths, other boxes skipped) and raw J2K codestreams, decoded as
  OpenJPEG 2.5.3 decodes them for cv2 in its strict mode (native/jp2.cpp:
  every Part 1 progression, POC, tile-part, code-block style, precinct,
  ROI and packed-header layout, 5/3 and 9/7, RCT and ICT, and HTJ2K's HT
  code-blocks of Part 15, in raw codestreams and JPH files, brand jph),
  then mapped as
  cv2's Jpeg2KOpjDecoder maps them: every component shifted right by the
  codestream's largest precision less 8 and cast to 8 bits, greyscale
  (colr 17) from component 0, sYCC (18) through cvtColor's YUV -> BGR,
  sRGB and every other space (no colr, an ICC profile, a raw codestream)
  from components 0-2. cv2 gives None, and so does this, for components
  of under 8 bits, signed, subsampled or offset on the reference grid
  (sYCC 4:2:0 among them), fewer than 3 components outside greyscale,
  CMYK and e-sYCC, and a codestream cut or broken (OpenJPEG's strict
  mode fails on a cut tile-part). The Part 2 markers OpenJPEG reads act
  as they act there: an MCO replaces the DC level shifts by its MCC's
  offset array (zero without one), CBD the components' precision and
  signedness; CAP and the other Part 2 markers are read past;
- BMP ("BM"): the core, info, V4, V5 and OS/2 2.x headers, 1, 4 and 8
  bits through the palette, RLE8 and RLE4 (native/bmp.cpp, escapes as
  OpenCV decodes them), 16 bits as 5-5-5 or 5-6-5 (BI_BITFIELDS), 24 and
  32 bits, top-down rows, as OpenCV's grfmt_bmp.cpp reads them; a file cut
  short gives None;
- PNM (P1-P6, ASCII and binary, with comments) and PAM (P7, tuple types
  BLACKANDWHITE, GRAYSCALE, GRAYSCALE_ALPHA, RGB, RGB_ALPHA of depths
  1-4), as grfmt_pxm.cpp and grfmt_pam.cpp read them: binary 8-bit
  samples are not scaled by the maxval, ASCII ones are; 16-bit samples
  keep their high byte; a PAM's three channels are copied as they lie (an
  RGB PAM comes out with red and blue swapped, as cv2 reads it), and of
  two or four only the first ceil(width / depth) pixels of a row are
  written (the rest of cv2's image is its fresh memory: zero here);
- GIF (87a and 89a): the first frame, as OpenCV 5.0's own GIF decoder
  reads it (not giflib): global and local colour tables, the Graphic
  Control Extension's transparency, interlaced rows, a frame smaller than
  its screen on the background colour; its departures from the GIF89a
  specification are listed at ``_decode_gif`` and native/gif.cpp;
- WebP: lossless (VP8L) and lossy (VP8) still images, with or without an
  ALPH chunk, and the first frame of an animation, decoded as the libwebp
  cv2 bundles decodes them (native/webp.cpp): lossy frames through
  libwebp's fancy upsampling and fixed-point YUV -> RGB; alpha is decoded
  (a broken ALPH chunk gives None) and dropped, not composited; an
  animation's first frame lies on a black canvas; a file under 32 bytes,
  cut short or broken gives None;
- Sun raster: the old and standard types at depths 1, 8, 24 and 32, with
  or without an RGB colour map; byte-encoded (RLE) and RGB-type rasters
  give None, as cv2 5.0 reads neither;
- colour PFM ("PF"): floats divided by |scale|, then rounded to 8 bits
  without a factor, as imread converts them (0.6 reads as 1, not 153);
- Radiance HDR (``#?RADIANCE`` or ``#?RGBE``, FORMAT=32-bit_rle_rgbe, -Y
  +X): run-length and flat scanlines as rgbe.cpp reads them, then times
  255, rounded and saturated;
- AVIF (an ftyp box whose brands, major or compatible, include avif or
  avis): the image libavif 1.4.2 reads for cv2, from the source its
  AVIF_DECODER_SOURCE_AUTO picks (major brand avis, or another than avif
  where a moov was read: the colour track of the moov, its first sample,
  with the track that is its alpha; else meta's primary item: meta with
  hdlr pict, pitm, iloc v0-2 with several extents and idat, iinf/infe
  v2-3, iref, iprp/ipco/ipma, every property parsed as libavif parses it
  and an essential one it does not know skipping the item; an av01 item
  or a grid item of av01 cells, stitched and cut to its output size, with
  an alpha item or grid), cv2's signature check (libavif's parse of the
  first 500 bytes; a read past them gives None), and each AV1 frame
  decoded as the specification decodes it, so as libaom decodes it (what
  follows it read as libaom reads it) (native/av1.cpp: reduced or full
  sequence headers,
  4:2:0, 4:2:2 (AV1 profile 2), 4:4:4 and monochrome at 8, 10 and 12
  bits, 64x64 and 128x128 superblocks, uniform and explicit tiles, every
  intra tool, the screen-content tools palette and intra block copy,
  quantiser matrices, segmentation, delta q and lf, the deblocking
  filter, CDEF, loop restoration, Wiener and self-guided, and film grain
  synthesised as libaom adds it; a layered item's AV1 inter frames too,
  every inter tool, the frame libaom gives libavif: the last shown, or
  the first shown of the spatial layer lsel names, with a1op's
  operating point and a1lx's layer sizes as libavif takes them); then
  libavif's YUV -> RGB: 10 and 12
  bits shifted down to 8, then libyuv's fixed-point constants for
  BT.601, BT.709 and BT.2020 (unspecified as BT.601) at full and limited
  range with bilinear 4:2:0 and linear 4:2:2 upsampling; libavif's own
  float conversion for FCC, SMPTE 240, YCgCo, YCgCo-Re (10 bits to 8),
  the chroma-derived matrix of other primaries and the identity matrix
  above 8 bits or on limited range (at 8 bits of full range G = Y, B = U,
  R = V); colour premultiplied by its alpha divided by it (libyuv's
  ARGBUnattenuate, or in libavif's float conversion); a monochrome
  frame's Y on all three channels, as cv2 copies it (a colour frame too,
  where its av1C says monochrome; above 8 bits scaled to 8 and rounded
  half to even, as Mat::convertTo). An alpha item, grid or track is
  decoded (a failure there fails the read) and dropped; irot, imir and
  clap are not applied, as cv2 does not apply them. A file cut short, a
  box libavif rejects (a child past its parent, versions and reserved
  fields it checks, pixi depths other than av1C's, a grid's cells that do
  not match or cover it), a conversion libavif fails on (the identity
  matrix with subsampled chroma, YCgCo on limited range), a frame libaom
  fails on (a bad header, tile data that overruns or leaves other than
  the trailing bits after it) gives None;
- EXIF orientation 2-8 is applied as cv2 applies it, from a JPEG's first
  APP1 segment and from a PNG's ``eXIf`` chunk. A TIFF's orientation is
  applied as cv2 5.0 applies it: 4 flips top-bottom; 2 flips each strip or
  tile column left-right within its own width, and 3 does that and flips
  top-bottom (so a tiled page's tiles stay in place); 5-8 give None, as
  imread does;
- a file cv2 cannot read gives ``None``: missing, truncated inside its
  headers, a bad CRC of a critical PNG chunk or bad zlib data in a PNG,
  the TIFF variants cv2's libtiff cannot read or map (LZMA, Zstandard,
  WebP, old-style JPEG, PixarLog, JBIG and LERC compression, which it was
  built without; float samples, the floating-point predictor, 32-bit
  samples, 16-bit CMYK; 2-bit pages, NeXT's among them, and 4-bit gray),
  a gray PFM ("Pf", which trips imread's own check), OpenEXR (this cv2 is
  built without it) and OS/2 bitmaps (BA, CI, CP, IC, PT: no decoder of
  cv2's takes them). A JPEG truncated inside its entropy-coded data
  decodes as libjpeg decodes it: the missing blocks are mid-gray.

What cv2 reads and this does not raises ``NotImplementedError`` naming
it, so that no page is skipped silently: a TIFF compression libtiff does
not know (JPEG 2000 in TIFF 34712, JPEG XL 50002, any other number; cv2
gives an all-zero page for those), and these AVIF variants,
which cv2 reads through libavif and libaom: a frame with superres (no
tool at hand writes one to test against), an ispe (or a track's size)
other than the frame's (libavif scales the frame to it: a layer lsel
picks that was coded smaller too), premultiplied
alpha at 12 bits 4:2:0 through libyuv, or of another size than the
colour. ``unsupported(path)`` tells these from the headers, without
decoding.
"""

from __future__ import annotations

import re
import struct
import zlib
from pathlib import Path

import numpy as np

from ocr_inference_tpu_torch import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xffO\xffQ"
_SPACE = b" \t\n\v\f\r"  # C's isspace

# leading bytes of the formats cv2.imread reads besides PNG and those
# image_format tests by rule (cv2 5.0's signatures; this cv2 is built
# without OpenEXR, and reads BMP only under "BM", not OS/2's BA, CI, CP, IC
# or PT)
_MAGIC = (
    (b"BM", "BMP"),
    (b"\xff\xd8\xff", "JPEG"),
    (b"\x59\xa6\x6a\x95", "Sun raster"),
    (b"II*\x00", "TIFF"),
    (b"MM\x00*", "TIFF"),
    (b"II+\x00", "TIFF"),
    (b"MM\x00+", "TIFF"),
    (JP2_SIGNATURE, "JPEG 2000"),
    (J2K_SIGNATURE, "JPEG 2000"),
    (b"GIF87a", "GIF"),
    (b"GIF89a", "GIF"),
)

# channels of each PNG colour type, and the bit depths it allows
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}

# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

# TIFF compressions decoded here (NeXT: only at 2 bits, which cv2 5.0
# does not read; its pages give None)
_TIFF_CODECS = (1, 2, 3, 4, 5, 7, 8, 32766, 32771, 32773, 32809, 32946,
                34676, 34677)
# compressions cv2's libtiff was built without: cv2.imread gives None
_TIFF_NOT_CONFIGURED = {6: "old-style JPEG", 32909: "PixarLog",
                        34661: "JBIG", 34887: "LERC", 34925: "LZMA",
                        50000: "Zstandard", 50001: "WebP"}
# compressions libtiff does not know (JPEG 2000 34712, JPEG XL 50002, any
# other number): cv2 gives an all-zero page, and they are refused by name
_TIFF_COMPRESSION_NAMES = {
    34712: "JPEG 2000 in TIFF (compression 34712)",
}
# SGI Log photometrics: LogL and LogLuv
_TIFF_LOGL, _TIFF_LOGLUV = 32844, 32845

# TIFF field types -> bytes a value (TIFFDataWidth)
_TIFF_WIDTHS = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
                11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}

# TIFF field types -> struct codes (rationals as two LONGs; BigTIFF's
# LONG8, SLONG8 and IFD8)
_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B",
               8: "h", 9: "i", 10: "ii", 11: "f", 12: "d", 13: "I",
               16: "Q", 17: "q", 18: "Q"}

_REVERSED_BITS = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                          np.uint8)


class _Corrupt(ValueError):
    """The file cannot be decoded; cv2.imread gives None for it."""


def _check_size(width: int, height: int) -> None:
    """imread's validateInputImageSize: at most 2**20 a side and 2**30
    pixels; a larger header gives None (before anything is allocated)."""
    if not (0 < width <= 1 << 20 and 0 < height <= 1 << 20
            and width * height <= 1 << 30):
        raise _Corrupt(f"a {width}x{height} image: cv2 refuses its size")


def image_format(path: str | Path) -> str | None:
    """The image format of a file by its leading bytes, as cv2 5.0's
    findDecoder picks its decoder: "PNG", "JPEG", "TIFF", "JPEG 2000",
    "BMP", "PNM" (P1-P6), "PAM" (P7), another format's name, or None for a
    file that is missing, that no decoder of cv2's takes, or that cv2
    gives None for by its signature alone (a gray PFM, "Pf", which trips
    imread's own check)."""
    try:
        with open(path, "rb") as f:
            head = f.read(16)
    except OSError:
        return None
    if head.startswith(PNG_SIGNATURE):
        return "PNG"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    if head[4:8] == b"ftyp" and _avif_brand(path):
        return "AVIF"
    # HdrDecoder compares at least as many bytes as "#?RADIANCE" holds
    if len(head) >= 10 and (head.startswith(b"#?RADIANCE")
                            or head.startswith(b"#?RGBE")):
        return "Radiance HDR"
    if len(head) >= 3 and head[:1] == b"P" and head[2] in _SPACE:
        kind = head[1:2]
        if b"1" <= kind <= b"6":
            return "PNM"
        if kind == b"7":
            return "PAM"
        if kind == b"F":
            return "PFM"
    for magic, name in _MAGIC:
        if head.startswith(magic):
            return name
    return None


def _avif_brand(path: str | Path) -> bool:
    """Whether a file's leading ftyp box names the brand avif or avis,
    major or compatible, as libavif's avifFileTypeIsCompatible asks (cv2
    gives libavif the file's first 500 bytes to tell AVIF by)."""
    with open(path, "rb") as f:
        head = f.read(500)
    size = int.from_bytes(head[:4], "big")
    if size < 16 or size > len(head):
        return False
    brands = [head[8:12]] + [head[i:i + 4] for i in range(16, size - 3, 4)]
    return b"avif" in brands or b"avis" in brands


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
        if fmt == "TIFF":
            _tiff_first_page(data)
        elif fmt == "JPEG 2000":
            _jp2_header(data)
        elif fmt == "AVIF":
            _avif_headers(data)
    except NotImplementedError as e:
        return str(e)
    except (OSError, KeyError, struct.error, ValueError, IndexError,
            _Corrupt):
        pass
    return None


def read_image(path: str | Path) -> np.ndarray | None:
    """An image file of a format the module doc lists -> (H, W, 3) uint8
    RGB, or None when cv2.imread gives None (see the module doc). The
    variants the module doc names raise NotImplementedError."""
    fmt = image_format(path)
    if fmt is None:
        return None
    decode = _DECODERS.get(fmt)
    if decode is None:
        raise NotImplementedError(
            f"{path}: {fmt} images are not supported; PNG, JPEG, TIFF, "
            "JPEG 2000, BMP, PNM, PAM, GIF, WebP, Sun raster, colour PFM, "
            "Radiance HDR and AVIF are read")
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
    if rc:
        raise _Corrupt("JPEG data cv2 cannot read")
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return _apply_orientation(img, _exif_orientation(_jpeg_app1(data)))


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

def _tiff_ifd(data: bytes, order: str, offset: int,
              big: bool = False) -> dict:
    """The tags of the IFD at ``offset`` (a BigTIFF's when ``big``: 8-byte
    counts and offsets, 20-byte entries): tag -> tuple of values (bytes
    for ASCII and UNDEFINED); and under "space", (the bytes of the header,
    the IFD and its values held outside the entries, the file's size),
    which libtiff's byte-count estimate needs."""
    count_code, entry, field = ("Q", 20, 8) if big else ("H", 12, 4)
    count, = struct.unpack_from(order + count_code, data, offset)
    base = offset + struct.calcsize(count_code)
    if base + entry * count > len(data):
        raise _Corrupt("the IFD runs past the end of the file")
    tags: dict = {}
    # header, entry count, entries and next-IFD link, then the values
    # kept outside the entries: what EstimateStripByteCounts leaves out
    space = (16 + 8 + entry * count + 8) if big else (8 + 2 + 12 * count + 4)
    for i in range(count):
        at = base + entry * i
        tag, typ = struct.unpack_from(order + "HH", data, at)
        n, = struct.unpack_from(order + ("Q" if big else "I"), data, at + 4)
        width = _TIFF_WIDTHS.get(typ, 0)
        space += width * n if width * n > field else 0
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
    tags["space"] = (space, len(data))
    return tags


def _tiff_chunks(tags: dict) -> list[tuple[int, int]]:
    """(offset, byte count) of every strip or tile, planes one after
    another, the counts as libtiff's TIFFReadDirectory leaves them: with
    no byte counts (one strip or tile per plane only), or a single strip
    whose count looks bad (ByteCountLooksBad), EstimateStripByteCounts
    makes them up."""
    offsets = tags.get(324) or tags[273]
    counts = tags.get(325) or tags.get(279)
    spp = tags.get(277, (1,))[0]
    planar = tags.get(284, (1,))[0] == 2
    if counts is None:
        if len(offsets) != (spp if planar else 1):
            raise _Corrupt("no StripByteCounts for several strips")
    elif not (len(offsets) == 1 and 322 not in tags
              and _byte_count_looks_bad(tags, offsets[0], counts[0])):
        return list(zip(offsets, counts))
    space, filesize = tags["space"]
    if tags.get(259, (1,))[0] != 1:
        est = max(filesize - space, 0) // (spp if planar else 1)
        counts = [est] * len(offsets)
        if offsets[-1] + est > filesize:
            counts[-1] = max(filesize - offsets[-1], 0)
    elif 322 in tags:
        counts = [_tiff_tile_bytes(tags)] * len(offsets)
    else:
        h = tags[257][0]
        rps = h // max(len(offsets) // (spp if planar else 1), 1)
        counts = [_tiff_scanline(tags) * rps] * len(offsets)
    return list(zip(offsets, counts))


def _tiff_scanline(tags: dict) -> int:
    """TIFFScanlineSize: the bytes of one row of the image (of one plane
    when planar)."""
    spp = tags.get(277, (1,))[0]
    planar = tags.get(284, (1,))[0] == 2
    if _tiff_photometric(tags) == 6 and spp == 3 and not planar and \
            tags.get(259, (1,))[0] != 7:
        hs, vs = tags.get(530, (2, 2))[:2]
        block_row = -(-tags[256][0] // hs) * (hs * vs + 2)
        return (block_row * tags.get(258, (8,))[0] + 7) // 8 // max(vs, 1)
    bits = tags.get(258, (1,))[0] * (1 if planar else spp)
    return (tags[256][0] * bits + 7) // 8


def _tiff_tile_bytes(tags: dict) -> int:
    spp = tags.get(277, (1,))[0]
    planar = tags.get(284, (1,))[0] == 2
    bits = tags.get(258, (1,))[0] * (1 if planar else spp)
    return (tags[322][0] * bits + 7) // 8 * tags[323][0]


def _byte_count_looks_bad(tags: dict, offset: int, count: int) -> bool:
    """tif_dirread.c ByteCountLooksBad for a single strip."""
    if offset == 0:
        return False
    if count == 0:
        return True
    if tags.get(259, (1,))[0] != 1:
        return False
    filesize = tags["space"][1]
    if offset <= filesize and count > filesize - offset:
        return True
    return count < _tiff_scanline(tags) * tags[257][0]


def _tiff_chunk(data: bytes, offset: int, count: int) -> bytes:
    """A strip or tile's bytes. One that is empty or runs past the end of
    the file fails libtiff's TIFFFillStrip (the file is mapped), before any
    buffer is made: TIFFReadRGBAStrip fails, and cv2 gives None."""
    if count == 0 or count > len(data) or offset > len(data) - count:
        raise _Corrupt("a strip or tile outside the file")
    return data[offset: offset + count]


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
    return order, tags


def _tiff_unpack(compression: int, chunk: bytes, size: int, width: int,
                 rows: int, tags: dict, jpeg=None, lzw: str = "lzw",
                 odd: bool = False, fax: dict | None = None
                 ) -> tuple[np.ndarray, bool]:
    """One strip or tile's bytes decompressed to the ``size`` bytes
    libtiff leaves in its buffer, and whether its codec succeeded. Data
    that ends early or goes bad keeps what was decoded before the fault,
    as libtiff's RGBA interface keeps it for cv2 (it reads on past a
    failed strip); the rest stays zero. ``lzw`` is "lzw-old" for the
    pre-TIFF 6 codes; ``odd``, the data's file offset is odd (RLE-W);
    ``fax``, the page's CCITT state (native.tiff_fax ``state``)."""
    if compression == 1:
        # DumpModeDecode copies nothing from a strip shorter than it needs
        ok = len(chunk) >= size
        out = np.frombuffer(chunk[:size], np.uint8) if ok \
            else np.zeros(size, np.uint8)
        return out, ok
    if compression in (8, 32946):
        return native.tiff_unpack("inflate", chunk, size)
    if compression == 5:
        return native.tiff_unpack(lzw, chunk, size)
    if compression == 32773:
        return native.tiff_unpack("packbits", chunk, size)
    if compression == 7:
        return jpeg.decode(chunk, width, rows).reshape(-1), True
    if compression in (32809, 34676, 34677):
        method = "thunder" if compression == 32809 else "logluv24" \
            if compression == 34677 else "logluv" \
            if _tiff_photometric(tags) == _TIFF_LOGLUV else "logl"
        out, ok = native.tiff_rows(method, chunk, width, rows)
        return out.reshape(-1), ok
    # CCITT 2, 3, 4 or RLE-W
    opts = tags.get(292 if compression == 3 else 293, (0,))[0]
    return native.tiff_fax(chunk, width, rows, compression, opts,
                           tags.get(266, (1,))[0], odd, fax).reshape(-1), \
        True


class _TiffJpeg:
    """How libtiff's tif_jpeg.c has libjpeg decode each strip or tile: the
    JPEGTables stream first, YCbCr turned into RGB for a contiguous YCbCr
    page (JPEGCOLORMODE RGB) and the components kept as decoded otherwise,
    the stream's size and sampling checked against the strip's (a last
    strip whose stream holds the full RowsPerStrip is cut; a smaller
    stream fills the start of the strip)."""

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
        rc, (sw, sh, nc, h0, v0, rest_1x1) = self.tables.header(
            chunk, color=int(self.rgb))
        if rc:
            raise _Corrupt("JPEG data libtiff cannot read")
        cut = 0
        if sw == width and sh > rows and last:
            cut = rows
        elif sw > width or sh > rows:
            raise _Corrupt(f"a {sw}x{sh} JPEG stream in a {width}x{rows} "
                           "strip or tile")
        if nc != self.components or (h0, v0) != self.sampling \
                or not rest_1x1:
            raise _Corrupt("JPEG components or sampling do not match the "
                           "TIFF's")
        rc, img = self.tables.decode(chunk, 1 if self.rgb else 0, cut)
        if rc:
            raise _Corrupt("JPEG data libtiff cannot read")
        if img.shape[:2] != (rows, width):
            # a smaller stream (JPEGPreDecode only warns): its rows fill
            # the start of the strip's rows, the rest stays zero
            out = np.zeros((rows, width, img.shape[2]), np.uint8)
            out[: img.shape[0], : img.shape[1]] = img[:rows]
            img = out
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


def _lzw_method(data: bytes, tags: dict) -> str:
    """tiff_unpack's LZW method for a page: libtiff's LZWPreDecode picks
    the old-style decoder when the first strip decoded starts with a zero
    byte and a byte whose bit 0 is set, and keeps it for every strip."""
    off, cnt = _tiff_chunks(tags)[0]
    head = data[off: off + min(cnt, 2)]
    if tags.get(266, (1,))[0] == 2:  # libtiff reverses the bits first
        head = bytes(_REVERSED_BITS[np.frombuffer(head, np.uint8)])
    return "lzw-old" if len(head) == 2 and head[0] == 0 and head[1] & 1 \
        else "lzw"


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

    bits_rev = tags.get(266, (1,))[0] == 2 and \
        compression not in (2, 3, 4, 7, 32771)
    lzw = _lzw_method(data, tags)
    fax: dict = {}

    def unpack(offset, count, size, width, rows, stride):
        blob = _tiff_chunk(data, offset, count)
        if bits_rev:
            blob = _REVERSED_BITS[np.frombuffer(blob, np.uint8)].tobytes()
        block, ok = _tiff_unpack(compression, blob, size, width, rows, tags,
                                 jpeg, lzw, offset & 1, fax)
        block = block.reshape(rows, stride)
        # PredictorDecodeTile undoes the predictor only after a good decode
        return _undo_predictor(block, bits, spp, order) \
            if predictor == 2 and ok else block

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
            tile = unpack(off, cnt, th * tile_row, tw, th, tile_row)
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
        raw[y0: y0 + rows] = unpack(off, cnt, rows * row_bytes, w, rows,
                                    row_bytes)
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
    lzw = _lzw_method(data, tags)

    def put(chunk, y0, x0, rows, cols, span, take):
        across, down = -(-span // hs), -(-rows // vs)
        size = down * across * block
        raw = _tiff_unpack(compression, chunk, min(size, take), span, rows,
                           tags, lzw=lzw)[0][:size]
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
            put(_tiff_chunk(data, off, cnt), y0, x0, min(th, h - y0),
                min(tw, w - x0), tw, 1 << 62)
        return out
    rps = min(tags.get(278, (h,))[0], h)
    scanline = -(-w // hs) * block // vs
    for i, (off, cnt) in enumerate(chunks[: -(-h // rps)]):
        y0 = i * rps
        rows = min(rps, h - y0)
        put(_tiff_chunk(data, off, cnt), y0, 0, rows, w, w,
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


def _lab_white(tags: dict) -> tuple[float, float, float]:
    """tif_getimage.c initCIELabConversion: the reference white's X0, Y0,
    Z0 (Y0 100) from the WhitePoint chromaticity (tag 318, read into
    floats; CIE D50 when absent), in float32 as libtiff computes them."""
    f32 = np.float32
    v = tags.get(318)
    if v is not None and len(v) >= 4:
        wx, wy = (f32(0.0) if d == 0 else f32(n) / f32(d)
                  for n, d in ((v[0], v[1]), (v[2], v[3])))
    else:
        d50 = f32(96.4250) + f32(100.0) + f32(82.4680)
        wx, wy = f32(96.4250) / d50, f32(100.0) / d50
    if wy == 0:
        raise _Corrupt("invalid WhitePoint")
    return (float(wx / wy * f32(100.0)), 100.0,
            float((f32(1.0) - wx - wy) / wy * f32(100.0)))


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
    if compression in (2, 3, 4, 32771) and (bits != 1 or spp != 1):
        raise _Corrupt("CCITT data of more than one bit a pixel")
    orientation = tags.get(274, (1,))[0]
    if orientation in (5, 6, 7, 8):
        return None  # cv2 5.0's imread fails on these
    if compression == 32766:
        raise _Corrupt("NeXT data is 2-bit, which cv2 5.0 does not read")
    if compression == 32809 and bits != 4:
        raise _Corrupt("ThunderScan data of other than 4 bits")
    if compression in (34676, 34677):
        # the RGBA interface has tif_luv.c give 8-bit samples: gray for
        # LogL (its own codec only), RGB for LogLuv
        if photometric == _TIFF_LOGL and compression == 34676 \
                and spp == 1:
            photometric, bits = 1, 8
        elif photometric == _TIFF_LOGLUV and spp == 3 and not planar \
                and not extra:
            photometric, bits = 2, 8
        else:
            raise _Corrupt("SGI Log data libtiff cannot map")
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
        if bits == 2:
            return None  # nor on 2-bit palette pages
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
    elif photometric == 8:
        if bits not in (8, 16) or spp != 3 or extra or planar:
            raise _Corrupt("CIE L*a*b* layout libtiff cannot handle")
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
    elif photometric == 8:  # putcontig8bitCIELab8/16
        img = native.tiff_cielab(samples, _lab_white(tags))
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


# ---------------------------------------------------------------------------
# JPEG 2000
# ---------------------------------------------------------------------------

# colr box EnumCS values OpenJPEG maps to a colour space cv2 handles:
# sRGB, greyscale, sYCC; CMYK (12) and e-sYCC (24) cv2 refuses (None);
# every other value, an ICC profile or no colr box is "unknown", which
# cv2 reads as sRGB
_JP2_SRGB, _JP2_GRAY, _JP2_SYCC = 16, 17, 18
_JP2_REFUSED_SPACES = (12, 24)


def _jp2_boxes(data: bytes) -> dict:
    """A JP2 file's boxes as OpenJPEG's jp2.c reads them: the signature
    box, then ftyp, then (in any order with other boxes, which are skipped)
    jp2h with ihdr first among what it needs, colr (the first only: method
    1 an EnumCS, method 2 an ICC profile), pclr, cmap, cdef; then jp2c,
    whose codestream runs to the end of the file."""
    out: dict = {"enumcs": None, "pclr": None, "cmap": None, "cdef": None}
    pos, n, state = 0, len(data), 0
    while True:
        if pos + 8 > n:
            raise _Corrupt("no jp2c box")
        length, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if length == 1:
            if pos + 16 > n:
                raise _Corrupt("cut XL box length")
            length, = struct.unpack_from(">Q", data, pos + 8)
            head = 16
        elif length == 0:
            length = n - pos
        if length < head:
            raise _Corrupt("box length is inconsistent")
        if kind == b"jp2c":
            if not state & 4:
                raise _Corrupt("badly placed codestream")
            out["codestream"] = data[pos + head:]
            return out
        if pos + length > n:
            raise _Corrupt("a box runs past the end of the file")
        body = data[pos + head: pos + length]
        if state == 0:
            if kind != b"jP  " or length != 12 or body != b"\r\n\x87\n":
                raise _Corrupt("first box must be the signature box")
            state = 1
        elif state == 1:
            if kind != b"ftyp" or len(body) < 8 or len(body) % 4:
                raise _Corrupt("second box must be the file type box")
            state = 3
        elif kind == b"jp2h":
            _jp2_header_box(body, out)
            state |= 4
        pos += length


def _jp2_header_box(body: bytes, out: dict) -> None:
    """The jp2h superbox's boxes into ``out`` (opj_jp2_read_jp2h)."""
    pos, has_ihdr = 0, False
    while pos < len(body):
        if pos + 8 > len(body):
            raise _Corrupt("cut box in jp2h")
        length, kind = struct.unpack_from(">I4s", body, pos)
        head = 8
        if length == 1:
            length, = struct.unpack_from(">Q", body, pos + 8)
            head = 16
        elif length == 0:
            length = len(body) - pos
        if length < head or pos + length > len(body):
            raise _Corrupt("box length is inconsistent")
        box = body[pos + head: pos + length]
        if not has_ihdr and kind != b"ihdr":
            raise _Corrupt("ihdr must be the first box of jp2h")
        if kind == b"ihdr":
            if not has_ihdr:
                if len(box) != 14:
                    raise _Corrupt("bad ihdr box")
                h, w, nc = struct.unpack_from(">IIH", box)
                if not (h and w and nc):
                    raise _Corrupt("empty image in ihdr")
            has_ihdr = True
        elif kind == b"colr" and "colr" not in out:
            if len(box) < 3:
                raise _Corrupt("bad colr box")
            if box[0] == 1:
                if len(box) < 7:
                    raise _Corrupt("bad colr box")
                out["enumcs"], = struct.unpack_from(">I", box, 3)
                out["colr"] = True
            elif box[0] == 2:
                out["colr"] = True
            # other methods: the box is ignored
        elif kind == b"pclr":
            if out["pclr"] is not None or len(box) < 3:
                raise _Corrupt("bad pclr box")
            ne, npc = struct.unpack_from(">HB", box)
            if not 1 <= ne <= 1024 or npc == 0 or len(box) < 3 + npc:
                raise _Corrupt("bad pclr box")
            sizes = box[3: 3 + npc]
            entries = np.zeros((ne, npc), np.int64)
            at = 3 + npc
            for e in range(ne):
                for c, b in enumerate(sizes):
                    nb = min(((b & 0x7F) + 1 + 7) >> 3, 4)
                    if at + nb > len(box):
                        raise _Corrupt("cut pclr box")
                    entries[e, c] = int.from_bytes(box[at: at + nb], "big")
                    at += nb
            out["pclr"] = entries
        elif kind == b"cmap":
            if out["pclr"] is None or out["cmap"] is not None:
                raise _Corrupt("cmap without pclr, or a second cmap")
            npc = out["pclr"].shape[1]
            if len(box) < 4 * npc:
                raise _Corrupt("bad cmap box")
            out["cmap"] = [struct.unpack_from(">HBB", box, 4 * i)
                           for i in range(npc)]
        elif kind == b"cdef":
            if out["cdef"] is not None or len(box) < 2:
                raise _Corrupt("bad cdef box")
            count, = struct.unpack_from(">H", box)
            if count == 0 or len(box) < 2 + 6 * count:
                raise _Corrupt("bad cdef box")
            out["cdef"] = [list(struct.unpack_from(">HHH", box, 2 + 6 * i))
                           for i in range(count)]
        pos += length
    if not has_ihdr:
        raise _Corrupt("no ihdr box")


def _jp2_check_color(comps: int, boxes: dict) -> None:
    """opj_jp2_check_color: cdef indices in range and complete, each cmap
    channel mapped once from an existing component; a broken one fails
    the decode (None)."""
    pclr, cmap, cdef = boxes["pclr"], boxes["cmap"], boxes["cdef"]
    if cdef is not None:
        channels = len(cmap) if pclr is not None and cmap is not None \
            else comps
        for cn, _, asoc in cdef:
            if cn >= channels or (asoc not in (0, 65535)
                                  and asoc - 1 >= channels):
                raise _Corrupt("invalid cdef box")
        if not {cn for cn, _, _ in cdef} >= set(range(channels)):
            raise _Corrupt("incomplete channel definitions")
    if pclr is not None and cmap is not None:
        used = [False] * len(cmap)
        sane = True
        for i, (cmp, mtyp, pcol) in enumerate(cmap):
            if cmp >= comps:
                sane = False
            if mtyp not in (0, 1) or pcol >= len(cmap) \
                    or (used[pcol] and mtyp == 1) \
                    or (mtyp == 0 and pcol != 0) or (mtyp == 1 and pcol != i):
                sane = False
            else:
                used[pcol] = True
        if any(not used[i] and cmap[i][1] != 0 for i in range(len(cmap))):
            sane = False
        if sane and comps == 1 and not all(used):
            # "Component mapping seems wrong. Trying to correct."
            cmap[:] = [(cmp, 1, i) for i, (cmp, _, _) in enumerate(cmap)]
        if not sane:
            raise _Corrupt("invalid cmap box")


def _jp2_header(data: bytes) -> tuple[bytes, dict, dict]:
    """(codestream, boxes, main header) of a JP2 file or raw J2K
    codestream, judged as cv2's Jpeg2K decoder judges them before it
    decodes: what it gives None for raises _Corrupt (signed components,
    no component of 8 bits or more, components that are subsampled or
    offset, colour spaces it refuses, fewer than 3 components outside
    greyscale)."""
    if data.startswith(J2K_SIGNATURE):
        boxes = {"enumcs": None, "pclr": None, "cmap": None, "cdef": None,
                 "codestream": data}
    else:
        boxes = _jp2_boxes(data)
    cs = boxes["codestream"]
    rc, hdr = native.j2k_header(cs)
    if rc == native.J2K_FAIL:
        raise _Corrupt("JPEG 2000 codestream OpenJPEG cannot read")
    comps = hdr["comps"]
    if any(sgnd for _, _, _, sgnd in comps):
        raise _Corrupt("signed components: cv2 refuses them")
    if max(prec for _, _, prec, _ in comps) < 8:
        raise _Corrupt("precision under 8 bits: cv2 refuses it")
    if hdr["x0"] or hdr["y0"] or any((dx, dy) != (1, 1)
                                     for dx, dy, _, _ in comps):
        raise _Corrupt("subsampled or offset components: cv2 refuses them")
    _check_size(hdr["x1"], hdr["y1"])
    space = boxes["enumcs"]
    channels = len(boxes["cmap"]) if boxes["pclr"] is not None \
        and boxes["cmap"] is not None else len(comps)
    if space in _JP2_REFUSED_SPACES or (space != _JP2_GRAY and channels < 3):
        raise _Corrupt("a colour space or component count cv2 refuses")
    return cs, boxes, hdr


def _decode_jp2(data: bytes) -> np.ndarray:
    """OpenJPEG's decode (native/jp2.cpp), its pclr/cmap and cdef steps,
    then cv2's Jpeg2KOpjDecoder: every component shifted right by the
    largest precision less 8 and saturated to 8 bits; greyscale from
    component 0, sYCC from components 0-2 through cvtColor's YUV -> BGR,
    everything else (sRGB, unknown) from components 0-2 as RGB."""
    cs, boxes, hdr = _jp2_header(data)
    rc, planes = native.j2k_decode(cs)
    if rc:
        raise _Corrupt("JPEG 2000 data OpenJPEG cannot decode")
    comps = len(planes)
    pclr, cmap, cdef = boxes["pclr"], boxes["cmap"], boxes["cdef"]
    _jp2_check_color(comps, boxes)
    if pclr is not None and cmap is not None:  # opj_jp2_apply_pclr
        entries = pclr
        mapped = []
        for i, (cmp, mtyp, pcol) in enumerate(cmap):
            if mtyp == 0:
                mapped.append(planes[cmp])
            else:
                index = np.clip(planes[cmp], 0, len(entries) - 1)
                mapped.append(entries[index, pcol].astype(np.int32))
        planes = mapped
    if cdef is not None:  # opj_jp2_apply_cdef: swap colour channels
        cdef = [list(c) for c in cdef]
        for i, (cn, typ, asoc) in enumerate(cdef):
            if cn >= len(planes) or asoc in (0, 65535):
                continue
            acn = asoc - 1
            if acn >= len(planes):
                continue
            if cn != acn and typ == 0:
                planes[cn], planes[acn] = planes[acn], planes[cn]
                for later in cdef[i + 1:]:
                    if later[0] == cn:
                        later[0] = acn
                    elif later[0] == acn:
                        later[0] = cn
    shift = max(max(prec for _, _, prec, _ in hdr["comps"]) - 8, 0)

    def eight(plane):  # a C cast keeps the low 8 bits (a palette entry
        # may be wider than 8 bits)
        return (plane >> shift if shift else plane).astype(np.uint8)

    space = boxes["enumcs"]
    if space == _JP2_GRAY:
        return np.repeat(eight(planes[0])[..., None], 3, axis=2)
    if len(planes) < 3:
        raise _Corrupt("fewer than 3 components for an RGB image")
    rgb = np.stack([eight(p) for p in planes[:3]], axis=-1)
    if space == _JP2_SYCC:
        return _yuv_to_rgb(rgb)
    return rgb


def _yuv_to_rgb(yuv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(COLOR_YUV2BGR) on 8-bit samples, in RGB order: its
    14-bit fixed-point coefficients, each term rounded."""
    y = yuv[..., 0].astype(np.int32)
    u = yuv[..., 1].astype(np.int32) - 128
    v = yuv[..., 2].astype(np.int32) - 128

    def descale(x):
        return (x + (1 << 13)) >> 14

    r = y + descale(v * 18678)
    g = y + descale(u * -6472 + v * -9519)
    b = y + descale(u * 33292)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------

_BMP_RGB, _BMP_RLE8, _BMP_RLE4, _BMP_BITFIELDS = 0, 1, 2, 3


def _decode_bmp(data: bytes) -> np.ndarray:
    """OpenCV's grfmt_bmp.cpp: the core (12-byte), info, V4, V5 and OS/2
    2.x headers; 1, 4 and 8 bits through the palette read just after the
    header (entries past its count are black), RLE4 and RLE8
    (native/bmp.cpp), 16 bits as 5-5-5 or, with BI_BITFIELDS masks read
    after the header, 5-6-5 (the low bits zero, not replicated), 24 bits,
    and 32 bits as the first three bytes of each pixel whatever the masks
    say; rows bottom-up unless the height is negative. A file that ends
    before its last row gives None, as cv2's stream throws."""
    if len(data) < 18:
        raise _Corrupt("BMP header cut short")
    offset, size = struct.unpack_from("<Ii", data, 10)
    if size <= 0:
        raise _Corrupt("bad BMP header size")
    palette = np.zeros((256, 3), np.uint8)  # BGR
    if size >= 36:
        if len(data) < 50:
            raise _Corrupt("BMP header cut short")
        width, height, planes_bpp, rle = struct.unpack_from("<iiIi", data,
                                                            18)
        bpp = planes_bpp >> 16
        clrused, = struct.unpack_from("<i", data, 46)
        if not 0 <= rle <= _BMP_BITFIELDS:
            raise _Corrupt("BMP compression cv2 does not read")
        at = 14 + size
        if not (width > 0 and height != 0 and (
                (bpp in (1, 4, 8, 24, 32) and rle == _BMP_RGB)
                or (bpp in (16, 32) and rle in (_BMP_RGB, _BMP_BITFIELDS))
                or (bpp == 4 and rle == _BMP_RLE4)
                or (bpp == 8 and rle == _BMP_RLE8))):
            raise _Corrupt("BMP layout cv2 does not read")
        if bpp <= 8:
            if not 0 <= clrused <= 256:
                raise _Corrupt("bad BMP palette size")
            count = clrused or 1 << bpp
            if at + 4 * count > len(data):
                raise _Corrupt("BMP palette cut short")
            entries = np.frombuffer(data, np.uint8, 4 * count, at)
            palette[:count] = entries.reshape(count, 4)[:, :3]
        elif bpp == 16 and rle == _BMP_BITFIELDS:
            if at + 12 > len(data):
                raise _Corrupt("BMP masks cut short")
            masks = struct.unpack_from("<iii", data, at)  # red, green, blue
            if masks == (0x7C00, 0x3E0, 0x1F):
                bpp = 15
            elif masks != (0xF800, 0x7E0, 0x1F):
                raise _Corrupt("16-bit BMP masks cv2 does not read")
        elif bpp == 16:
            bpp = 15
    elif size == 12:
        if len(data) < 26:
            raise _Corrupt("BMP header cut short")
        width, height, planes_bpp = struct.unpack_from("<HHI", data, 18)
        bpp, rle = planes_bpp >> 16, _BMP_RGB
        if not (width > 0 and height != 0 and bpp in (1, 4, 8, 24, 32)):
            raise _Corrupt("BMP layout cv2 does not read")
        if bpp <= 8:
            count = 1 << bpp
            if 26 + 3 * count > len(data):
                raise _Corrupt("BMP palette cut short")
            palette[:count] = np.frombuffer(data, np.uint8, 3 * count,
                                            26).reshape(count, 3)
    else:
        raise _Corrupt(f"BMP header of {size} bytes")
    bottom_up = height > 0
    height = abs(height)
    _check_size(width, height)
    if height * width * 3 >= 1 << 30 or offset >= 1 << 31:
        raise _Corrupt("BMP too large for cv2's reader")
    if rle in (_BMP_RLE4, _BMP_RLE8):
        img = native.bmp_rle(data, offset, width, height, bpp, palette,
                             bottom_up)
        if img is None:
            raise _Corrupt("bad BMP RLE data")
        return np.ascontiguousarray(img[..., ::-1])
    pitch = ((width * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
    if offset + height * pitch > len(data):
        raise _Corrupt("BMP pixel data cut short")
    rows = np.frombuffer(data, np.uint8, height * pitch, offset) \
        .reshape(height, pitch)
    if bpp <= 8:
        index = rows if bpp == 8 else _unpack_bits(rows, bpp)
        bgr = palette[index[:, :width]]
    elif bpp in (15, 16):
        t = rows[:, : 2 * width].copy().view("<u2").astype(np.int32)
        if bpp == 15:
            bgr = np.stack([(t << 3) & 0xF8, (t >> 2) & 0xF8,
                            (t >> 7) & 0xF8], axis=-1)
        else:
            bgr = np.stack([(t << 3) & 0xF8, (t >> 3) & 0xFC,
                            (t >> 8) & 0xF8], axis=-1)
    else:
        step = bpp // 8
        bgr = rows[:, : step * width].reshape(height, width, step)[..., :3]
    if bottom_up:
        bgr = bgr[::-1]
    return np.ascontiguousarray(bgr[..., ::-1], dtype=np.uint8)


# ---------------------------------------------------------------------------
# PNM (P1-P6) and PAM (P7)
# ---------------------------------------------------------------------------

class _ByteStream:
    """cv2's RLByteStream over a file's bytes: a read past the end throws
    (cv2 gives None)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise _Corrupt("unexpected end of the file")
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise _Corrupt("unexpected end of the file")
        self.pos += n
        return self.data[self.pos - n: self.pos]


def _isspace(c: int) -> bool:
    return c in (32, 9, 10, 11, 12, 13)


def _isdigit(c: int) -> bool:
    return 48 <= c <= 57


def _pnm_number(s: _ByteStream, maxdigits: int = 0) -> int:
    """grfmt_pxm.cpp ReadNumber: whitespace and # comments skipped, any
    other non-digit an error; the byte after the digits is consumed."""
    code = s.byte()
    while not _isdigit(code):
        if code == ord("#"):
            while code not in (10, 13):
                code = s.byte()
            code = s.byte()
        elif _isspace(code):
            while _isspace(code):
                code = s.byte()
        else:
            raise _Corrupt(f"unexpected byte {code:#x} in a PNM number")
    val = digits = 0
    while True:
        val = val * 10 + code - 48
        if val > 0x7FFFFFFF:
            raise _Corrupt("PNM number too large")
        digits += 1
        if maxdigits and digits >= maxdigits:
            break
        code = s.byte()
        if not _isdigit(code):
            break
    return val


def _decode_pnm(data: bytes) -> np.ndarray:
    """OpenCV's grfmt_pxm.cpp (P1-P6, ASCII and binary, # comments): the
    binary samples of 8 bits are kept as they are (not scaled by the
    maxval), the ASCII ones scaled as ``v * 255 // maxval``; above a maxval
    of 255 the samples are 16-bit and keep their high byte; P1 and P4's 1
    is black."""
    s = _ByteStream(data)
    if s.byte() != ord("P"):
        raise _Corrupt("not a PNM file")
    kind = s.byte() - 48
    if not 1 <= kind <= 6:
        raise _Corrupt("not a PNM file")
    bpp = (1, 8, 24)[(kind - 1) % 3]
    binary = kind >= 4
    width = _pnm_number(s)
    height = _pnm_number(s)
    maxval = _pnm_number(s) if bpp > 1 else 1
    if maxval > 65535 or not (width > 0 and height > 0 and maxval > 0):
        raise _Corrupt("bad PNM header")
    _check_size(width, height)
    nch = 3 if bpp == 24 else 1
    if bpp == 1:
        if binary:
            rows = np.frombuffer(s.take(height * ((width + 7) // 8)),
                                 np.uint8).reshape(height, -1)
            bits = _unpack_bits(rows, 1)[:, :width]
        else:
            bits = np.array([[_pnm_number(s, 1) != 0 for _ in range(width)]
                             for _ in range(height)], np.uint8)
        gray = np.where(bits.astype(bool), 0, 255).astype(np.uint8)
        return np.repeat(gray[..., None], 3, axis=2)
    wide = maxval > 255
    if binary:
        raw = s.take(height * width * nch * (2 if wide else 1))
        samples = np.frombuffer(raw, ">u2" if wide else np.uint8)
        samples = (samples >> 8).astype(np.uint8) if wide else samples
    else:
        codes = np.array([min(_pnm_number(s), maxval)
                          for _ in range(height * width * nch)], np.int64)
        samples = (codes >> 8 if wide else codes * 255 // maxval) \
            .astype(np.uint8)
    samples = samples.reshape(height, width, nch)
    return np.ascontiguousarray(np.repeat(samples, 3, axis=2)
                                if nch == 1 else samples)


_PAM_FIELDS = ("ENDHDR", "HEIGHT", "WIDTH", "DEPTH", "MAXVAL", "TUPLTYPE")
# the tuple types cv2 knows, each with the depth it must have
_PAM_TUPLTYPES_DEPTH = {"BLACKANDWHITE": 1, "GRAYSCALE": 1,
                        "GRAYSCALE_ALPHA": 2, "RGB": 3, "RGB_ALPHA": 4}


def _pam_line(s: _ByteStream) -> tuple[str | None, bytes]:
    """grfmt_pam.cpp ReadPAMHeaderLine: (field, value); field None for a
    comment; an unknown or overlong identifier, or an overlong value, is a
    bad header."""
    code = s.byte()
    while _isspace(code):
        code = s.byte()
    if code == ord("#"):
        while code not in (10, 13):
            code = s.byte()
        return None, b""
    ident = bytearray()
    while len(ident) < 8 and not _isspace(code):
        ident.append(code)
        code = s.byte()
    if not _isspace(code) or ident.decode("latin-1") not in _PAM_FIELDS:
        raise _Corrupt("bad PAM header line")
    field = ident.decode("latin-1")
    if code in (10, 13):
        return field, b""
    code = s.byte()
    while _isspace(code):
        code = s.byte()
    value = bytearray()
    while len(value) < 255 and code not in (10, 13):
        value.append(code)
        code = s.byte()
    if code not in (10, 13):
        raise _Corrupt("PAM header value too long")
    return field, bytes(value).rstrip(_SPACE)


def _pam_int(value: bytes) -> int:
    """grfmt_pam.cpp ParseInt: an optional minus, digits, nothing after."""
    text = value.split(b"\0")[0]
    neg = text.startswith(b"-")
    digits = text[1:] if neg else text
    if neg and not digits[:1].isdigit():
        raise _Corrupt("bad PAM number")
    n = 0
    for c in digits:
        if not _isdigit(c):
            raise _Corrupt("bad PAM number")
        n = n * 10 + c - 48
        if n >= 0x7FFFFFFF:
            raise _Corrupt("PAM number too large")
    return -n if neg else n


def _decode_pam(data: bytes) -> np.ndarray:
    """OpenCV's grfmt_pam.cpp, as cv2.imread(IMREAD_COLOR) reads it: three
    channels of 8-bit samples are copied as they lie in the file (into
    cv2's BGR order: an RGB PAM comes out with red and blue swapped, as
    cv2 writes it); 16-bit samples keep their high byte; one channel is
    repeated; with two or four (gray or RGB with alpha) only a row's first
    ceil(width / depth) pixels are converted; a maxval of 1 reads the
    rows' first bytes as packed bits (1 white). A tuple type that does not
    match the depth gives None."""
    s = _ByteStream(data)
    if s.take(2) != b"P7" or s.byte() not in (10, 13):
        raise _Corrupt("not a PAM file")
    seen: dict = {}
    tupltype = None
    while True:
        field, value = _pam_line(s)
        if field is None:
            continue
        if field == "ENDHDR":
            break
        if field == "TUPLTYPE":
            name = value.decode("latin-1")
            if name not in _PAM_TUPLTYPES_DEPTH:
                raise _Corrupt(f"PAM tuple type {name!r}")
            tupltype = name
            continue
        if field in seen:
            raise _Corrupt(f"PAM field {field} twice")
        seen[field] = _pam_int(value)
        if field == "MAXVAL" and seen[field] > 65535:
            raise _Corrupt("PAM maxval above 65535")
    if len(seen) != 4:
        raise _Corrupt("PAM header without every field")
    width, height = seen["WIDTH"], seen["HEIGHT"]
    depth, maxval = seen["DEPTH"], seen["MAXVAL"]
    if tupltype is not None:
        if depth != _PAM_TUPLTYPES_DEPTH[tupltype]:
            raise _Corrupt(f"PAM {tupltype} of depth {depth}")
    else:
        if depth == 1 and maxval == 1:
            tupltype = "BLACKANDWHITE"
        elif depth == 1 and maxval < 256:
            tupltype = "GRAYSCALE"
        elif depth == 3 and maxval < 256:
            tupltype = "RGB"
        else:
            raise _Corrupt("PAM tuple type cv2 cannot determine")
    _check_size(width, height)
    size = 2 if maxval > 255 else 1
    stride = width * depth * size
    rows = np.frombuffer(s.take(height * stride), np.uint8) \
        .reshape(height, stride)
    if maxval == 1:
        bits = _unpack_bits(rows[:, : (width + 7) // 8], 1)[:, :width]
        gray = (bits * np.uint8(255)).astype(np.uint8)
        return np.repeat(gray[..., None], 3, axis=2)
    if size == 2:
        rows = (rows.view(">u2") >> 8).astype(np.uint8)
    px = rows.reshape(height, width, depth)
    if depth == 3:  # copied as they lie: the file's first sample is blue
        return np.ascontiguousarray(px[..., ::-1])
    if depth == 1:
        return np.ascontiguousarray(np.repeat(px, 3, axis=2))
    # grfmt_pam.cpp basic_conversion stops after ``width`` samples, not
    # pixels: only the first ceil(width / depth) pixels of a row are
    # written; the rest stay as cv2's fresh Mat holds them (zero)
    out = np.zeros((height, width, 3), np.uint8)
    done = -(-width // depth)
    out[:, :done] = np.repeat(px[:, :done, :1], 3, axis=2) if depth == 2 \
        else px[:, :done, :3]
    return out


# ---------------------------------------------------------------------------
# WebP (libwebp's webp_dec.c and demux.c; the codecs are native/webp.cpp)
# ---------------------------------------------------------------------------

_WEBP_MAX_PAYLOAD = 0xFFFFFFFF - 8 - 1
_WEBP_ALPHA_FLAG, _WEBP_ANIMATION_FLAG = 0x10, 0x02


def _le24(b: bytes, at: int) -> int:
    return b[at] | (b[at + 1] << 8) | (b[at + 2] << 16)


def _vp8_info(p: bytes, chunk_size: int) -> tuple[int, int]:
    """VP8GetInfo: a key frame's width and height, checked as libwebp
    checks them."""
    if len(p) < 10 or p[3:6] != b"\x9d\x01\x2a":
        raise _Corrupt("bad VP8 frame header")
    bits = p[0] | (p[1] << 8) | (p[2] << 16)
    w = ((p[7] << 8) | p[6]) & 0x3FFF
    h = ((p[9] << 8) | p[8]) & 0x3FFF
    if (bits & 1 or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1
            or bits >> 5 >= chunk_size or not w or not h):
        raise _Corrupt("bad VP8 frame header")
    return w, h


def _vp8l_info(p: bytes) -> tuple[int, int, bool]:
    """VP8LGetInfo: (width, height, alpha bit) of a VP8L header."""
    if len(p) < 5 or p[0] != 0x2F or p[4] >> 5:
        raise _Corrupt("bad VP8L header")
    bits = int.from_bytes(p[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, \
        bool((bits >> 28) & 1)


def _webp_headers(data: bytes, have_all: bool) -> dict:
    """webp_dec.c ParseHeadersInternal. ``have_all`` False is
    WebPGetFeatures (cv2 gives it the file's first 32 bytes): a VP8X
    header is then enough. Raises _Corrupt where libwebp fails."""
    n = len(data)
    if n < 12:
        raise _Corrupt("WebP header cut short")
    pos, riff_size = 0, 0
    if data[:4] == b"RIFF":
        if data[8:12] != b"WEBP":
            raise _Corrupt("not a WebP file")
        size = struct.unpack_from("<I", data, 4)[0]
        if size < 12 or size > _WEBP_MAX_PAYLOAD:
            raise _Corrupt("bad RIFF size")
        if have_all and size > n - 8:
            raise _Corrupt("WebP file cut short")
        riff_size, pos = size, 12
    out = {"alpha": None, "animation": False, "has_alpha": False}
    if n - pos < 8:
        raise _Corrupt("WebP header cut short")
    vp8x = data[pos:pos + 4] == b"VP8X"
    if vp8x:
        if struct.unpack_from("<I", data, pos + 4)[0] != 10:
            raise _Corrupt("bad VP8X size")
        if n - pos < 18:
            raise _Corrupt("WebP header cut short")
        flags = struct.unpack_from("<I", data, pos + 8)[0]
        width = 1 + _le24(data, pos + 12)
        height = 1 + _le24(data, pos + 15)
        if width * height >= 1 << 32:
            raise _Corrupt("WebP canvas too large")
        if not riff_size:
            raise _Corrupt("VP8X outside a RIFF container")
        out.update(width=width, height=height, flags=flags,
                   has_alpha=bool(flags & _WEBP_ALPHA_FLAG),
                   animation=bool(flags & _WEBP_ANIMATION_FLAG))
        pos += 18
        if out["animation"] and not have_all:
            return out

    def vp8x_only(why: str) -> dict:
        # NOT_ENOUGH_DATA after a VP8X header: WebPGetFeatures answers
        # from the VP8X header alone
        if vp8x and not have_all:
            return out
        raise _Corrupt(why)

    if n - pos < 4:
        return vp8x_only("WebP header cut short")
    if (riff_size and vp8x) or (not riff_size and not vp8x
                                and data[pos:pos + 4] == b"ALPH"):
        total = 4 + 8 + 10
        while True:
            if n - pos < 8:
                return vp8x_only("WebP chunk cut short")
            size = struct.unpack_from("<I", data, pos + 4)[0]
            if size > _WEBP_MAX_PAYLOAD:
                raise _Corrupt("bad WebP chunk size")
            disk = (8 + size + 1) & ~1
            total += disk
            if riff_size and total > riff_size:
                raise _Corrupt("WebP chunk past the RIFF size")
            if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                break
            if n - pos < disk:
                return vp8x_only("WebP chunk cut short")
            if data[pos:pos + 4] == b"ALPH":
                out["alpha"] = data[pos + 8:pos + 8 + size]
            pos += disk
    if n - pos < 8:
        return vp8x_only("WebP chunk cut short")
    tag = data[pos:pos + 4]
    if tag in (b"VP8 ", b"VP8L"):
        size = struct.unpack_from("<I", data, pos + 4)[0]
        if riff_size >= 12 and size > riff_size - 12:
            raise _Corrupt("VP8 chunk past the RIFF size")
        if have_all and size > n - pos - 8:
            raise _Corrupt("WebP file cut short")
        lossless = tag == b"VP8L"
        pos += 8
    else:  # a raw bitstream
        size = n - pos
        lossless = data[pos] == 0x2F and n - pos >= 5 \
            and not data[pos + 4] >> 5
    if size > _WEBP_MAX_PAYLOAD:
        raise _Corrupt("bad WebP chunk size")
    payload = data[pos:]
    if lossless:
        if len(payload) < 5:
            return vp8x_only("VP8L header cut short")
        w, h, alpha = _vp8l_info(payload)
        out["has_alpha"] = out["has_alpha"] or alpha
    else:
        if len(payload) < 10:
            return vp8x_only("VP8 header cut short")
        w, h = _vp8_info(payload, size)
    if vp8x and (w, h) != (out["width"], out["height"]):
        raise _Corrupt("VP8X canvas and frame sizes differ")
    out.update(width=w, height=h, lossless=lossless, payload=payload)
    out["has_alpha"] = out["has_alpha"] or out["alpha"] is not None
    return out


def _webp_alpha(alpha: bytes, width: int, height: int) -> None:
    """ALPHInit and the decode of an ALPH chunk: its header byte (method,
    pre-processing and reserved bits) and its raw or lossless data, as
    libwebp checks them. The filter (none, horizontal, vertical, gradient)
    cannot fail and acts on the alpha values only, which imread drops."""
    if len(alpha) <= 1:
        raise _Corrupt("ALPH chunk too short")
    method, pre, reserved = alpha[0] & 3, (alpha[0] >> 4) & 3, alpha[0] >> 6
    if method > 1 or pre > 1 or reserved:
        raise _Corrupt("bad ALPH header")
    if method == 0:
        if len(alpha) - 1 < width * height:
            raise _Corrupt("ALPH data cut short")
    elif not native.webp_alpha_ok(alpha[1:], width, height):
        raise _Corrupt("bad ALPH data")


def _webp_frame(data: bytes) -> np.ndarray:
    """WebPDecode of a still image or one frame (after its RIFF, VP8X and
    optional chunks) -> (h, w, 3) RGB."""
    hdr = _webp_headers(data, True)
    if hdr["animation"]:
        raise _Corrupt("an animated WebP where a still image is decoded")
    w, h = hdr["width"], hdr["height"]
    if hdr["lossless"]:
        argb = native.webp_vp8l(hdr["payload"], w, h)
        if argb is None:
            raise _Corrupt("bad VP8L data")
        rgb = np.empty((h, w, 3), np.uint8)
        rgb[..., 0] = argb >> 16
        rgb[..., 1] = argb >> 8
        rgb[..., 2] = argb
        return rgb
    rgb = native.webp_vp8(hdr["payload"], w, h)
    if rgb is None:
        raise _Corrupt("bad VP8 data")
    if hdr["alpha"] is not None:
        _webp_alpha(hdr["alpha"], w, h)
    return rgb


def _webp_demux_frame(data: bytes, pos: int, riff_end: int, payload: int,
                      frame: dict) -> int:
    """demux.c StoreFrame: an ANMF frame's ALPH and VP8/VP8L chunks from
    ``pos``, into ``frame``; returns where it stopped (an unknown chunk
    there is read next as a chunk of the file's own)."""
    if riff_end - pos < 8 or riff_end - pos < payload:
        raise _Corrupt("WebP frame cut short")
    while True:
        start = pos
        tag = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        pos += 8
        if size > _WEBP_MAX_PAYLOAD:
            raise _Corrupt("bad WebP chunk size")
        padded = size + (size & 1)
        if padded > riff_end - pos:
            raise _Corrupt("WebP chunk past the RIFF size")
        if tag == b"ALPH" and "alpha" not in frame:
            frame["alpha"] = start
        elif tag in (b"VP8 ", b"VP8L") and "image" not in frame:
            if tag == b"VP8L" and "alpha" in frame:
                raise _Corrupt("VP8L frame after an ALPH chunk")
            feats = _webp_headers(data[start:start + 8 + padded], False)
            frame.update(image=start, end=start + 8 + padded,
                         width=feats["width"], height=feats["height"])
        else:
            return pos - 8
        pos += padded
        if pos == riff_end:
            return pos
        if riff_end - pos < 8:
            raise _Corrupt("WebP chunk cut short")


def _webp_first_frame(data: bytes, width: int, height: int) -> np.ndarray:
    """cv2's animated path: WebPAnimDecoder's first frame. demux.c must
    accept the whole file first (its chunks walked as it walks them, every
    frame complete and inside the canvas); the first frame is decoded onto
    a zero canvas at its offset, and imread drops alpha (the rest of the
    canvas is black)."""
    riff_size = struct.unpack_from("<I", data, 4)[0]
    if riff_size < 8 or riff_size > _WEBP_MAX_PAYLOAD:
        raise _Corrupt("bad RIFF size")
    riff_end = riff_size + 8
    if len(data) < riff_end:
        raise _Corrupt("WebP file cut short")
    vp8x = struct.unpack_from("<I", data, 16)[0]
    if vp8x < 10 or vp8x > _WEBP_MAX_PAYLOAD:
        raise _Corrupt("bad VP8X size")
    vp8x += vp8x & 1
    if vp8x > riff_end - 20:
        raise _Corrupt("VP8X past the RIFF size")
    flags = data[20]
    canvas_w, canvas_h = 1 + _le24(data, 24), 1 + _le24(data, 27)
    pos = 20 + vp8x
    if riff_end - pos < 8:
        raise _Corrupt("WebP file without chunks")
    anim, frames = False, []
    while True:
        tag = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        pos += 8
        if size > _WEBP_MAX_PAYLOAD:
            raise _Corrupt("bad WebP chunk size")
        padded = size + (size & 1)
        if padded > riff_end - pos:
            raise _Corrupt("WebP chunk past the RIFF size")
        if tag in (b"VP8X", b"ALPH", b"VP8 ", b"VP8L"):
            raise _Corrupt(f"a {tag!r} chunk outside the frames")
        if tag == b"ANIM":
            if padded < 6:
                raise _Corrupt("bad ANIM chunk")
            anim = True
            pos += padded
        elif tag == b"ANMF":
            if not anim:
                raise _Corrupt("ANMF before ANIM")
            if padded < 16:
                raise _Corrupt("bad ANMF chunk")
            frame = {"x": 2 * _le24(data, pos), "y": 2 * _le24(data, pos + 3)}
            pos = _webp_demux_frame(data, pos + 16, riff_end, padded - 16,
                                    frame)
            if len(frame) > 2:  # the frame has an ALPH or image chunk
                if frames and "image" not in frames[-1]:
                    raise _Corrupt("a WebP frame after an incomplete one")
                frames.append(frame)
        else:
            pos += padded
        if pos == riff_end:
            break
        if riff_end - pos < 8:
            raise _Corrupt("WebP chunk cut short")
    if flags & ~0x3E or not frames:
        raise _Corrupt("bad VP8X flags, or no frames")
    for f in frames:
        if "image" not in f or f.get("alpha", 0) > f["image"]:
            raise _Corrupt("WebP frame without its image chunk")
        if (f["x"] + f["width"] > canvas_w
                or f["y"] + f["height"] > canvas_h):
            raise _Corrupt("WebP frame outside the canvas")
    first = frames[0]
    body = data[first.get("alpha", first["image"]):first["end"]]
    img = _webp_frame(body)
    canvas = np.zeros((height, width, 3), np.uint8)
    x0, y0 = first["x"], first["y"]
    canvas[y0:y0 + img.shape[0], x0:x0 + img.shape[1]] = img
    return canvas


def _decode_webp(data: bytes) -> np.ndarray:
    """cv2's WebPDecoder over libwebp: the features from the file's first
    32 bytes (a shorter file gives None), then WebPDecode of a still image
    or, for an animated one, WebPAnimDecoder's first frame. Alpha, of a
    VP8L image or an ALPH chunk, is decoded and dropped; colours under
    alpha 0 stay as they were coded."""
    if len(data) < 32:
        raise _Corrupt("WebP file under 32 bytes")
    feats = _webp_headers(data[:32], False)
    width, height = feats["width"], feats["height"]
    _check_size(width, height)
    if feats["animation"]:
        return _webp_first_frame(data, width, height)
    return _webp_frame(data)


# ---------------------------------------------------------------------------
# GIF (OpenCV 5.0's grfmt_gif.cpp; the LZW codes are native/gif.cpp)
# ---------------------------------------------------------------------------

# the palette of a frame without any colour table: index i is gray i, but
# index 1 is white
_GIF_DEFAULT_PALETTE = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3,
                                 axis=1)
_GIF_DEFAULT_PALETTE[1] = 255


def _gif_skip_blocks(s: _ByteStream) -> None:
    """Skip data sub-blocks up to their terminator."""
    n = s.byte()
    while n:
        s.take(n)
        n = s.byte()


def _decode_gif(data: bytes) -> np.ndarray:
    """OpenCV 5.0's own GIF decoder, as cv2.imread reads the first frame,
    which departs from the GIF89a specification in these places:

    - the header walk reads every block up to the trailer (extensions and
      images, their sub-blocks skipped): a file cut short, or a block that
      is neither, gives None;
    - a background index past the global colour table gives None; the
      canvas outside the frame (and under its transparent pixels) is the
      background colour, or black without a global table, whatever the
      disposal method (4-7 give None); a Graphic Control Extension that
      is not 4 bytes long gives None;
    - an index past the local table takes the global table's colour, and
      one past both gives None; without any table a frame uses gray i for
      index i, white for 1;
    - the LZW codes as native/gif.cpp decodes them (minimum code sizes
      2-11, the frame's pixels exactly).

    Only the first frame is decoded, and only its own extensions are read
    (a later frame may be broken)."""
    s = _ByteStream(data)
    s.take(6)
    width, height = struct.unpack("<HH", s.take(4))
    flags, bg = s.byte(), s.byte()
    s.byte()
    gct = None
    if flags & 0x80:
        gct = np.frombuffer(s.take(3 << ((flags & 7) + 1)), np.uint8) \
            .reshape(-1, 3)
        if bg >= len(gct):
            raise _Corrupt("GIF background index past its colour table")
    body = s.pos
    while True:
        block = s.byte()
        if block == 0x21:
            s.byte()
            _gif_skip_blocks(s)
        elif block == 0x2C:
            desc = s.take(9)
            if desc[8] & 0x80:
                s.take(3 << ((desc[8] & 7) + 1))
            s.byte()
            _gif_skip_blocks(s)
        elif block == 0x3B:
            break
        else:
            raise _Corrupt(f"GIF block {block:#x}")
    _check_size(width, height)
    # the first frame's extensions
    s.pos = body
    transparent = None
    while s.byte() == 0x21:
        if s.byte() == 0xF9:
            if s.byte() != 4:
                raise _Corrupt("GIF graphic control extension not 4 long")
            gce_flags = s.byte()
            s.take(2)
            tindex = s.byte()
            if (gce_flags >> 2) & 7 > 3:
                raise _Corrupt("GIF disposal method past 3")
            transparent = tindex if gce_flags & 1 else None
        _gif_skip_blocks(s)
    s.pos -= 1
    if s.byte() != 0x2C:
        raise _Corrupt("GIF without an image")
    left, top, fw, fh, fflags = struct.unpack("<HHHHB", s.take(9))
    if not (fw and fh and left + fw <= width and top + fh <= height):
        raise _Corrupt("GIF frame outside its screen")
    if gct is not None:
        canvas = np.empty((height, width, 3), np.uint8)
        canvas[:] = gct[bg]
    else:
        canvas = np.zeros((height, width, 3), np.uint8)
    if fflags & 0x80:
        lct = np.frombuffer(s.take(3 << ((fflags & 7) + 1)), np.uint8) \
            .reshape(-1, 3)
    else:
        lct = gct if gct is not None else _GIF_DEFAULT_PALETTE
    decoded = native.gif_lzw(data, s.pos, fw * fh)
    if decoded is None:
        raise _Corrupt("bad GIF LZW data")
    index = decoded[0]
    if fflags & 0x40:  # interlaced: rows 0::8, 4::8, 2::4, 1::2
        order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                np.arange(2, fh, 4), np.arange(1, fh, 2)])
        rows = np.empty((fh, fw), np.uint8)
        rows[order] = index.reshape(fh, fw)
        index = rows
    index = index.reshape(fh, fw).astype(np.int64)
    table = np.zeros((256, 3), np.uint8)
    known = np.zeros(256, bool)
    if gct is not None:
        table[:len(gct)], known[:len(gct)] = gct, True
    table[:len(lct)], known[:len(lct)] = lct, True
    keep = np.ones((fh, fw), bool) if transparent is None \
        else index != transparent
    if not known[index[keep]].all():
        raise _Corrupt("GIF index past its colour tables")
    frame = canvas[top:top + fh, left:left + fw]
    frame[keep] = table[index[keep]]
    return canvas


# ---------------------------------------------------------------------------
# Sun raster, colour PFM and Radiance HDR
# ---------------------------------------------------------------------------

def _decode_sunras(data: bytes) -> np.ndarray:
    """OpenCV's SunRasterDecoder (big-endian header): depths 1, 8, 24 and
    32; the old (0) and standard (1) types, as cv2 5.0 reads them: a
    byte-encoded (RLE, 2), RGB (3) or other type gives None, and so does a
    colour map of another type than 1 (RGB planes, at most 2**depth
    entries, depth 8 or less), a header map length without a map, or rows
    cut short. Rows are padded to 16 bits. Without a map, depth 1 is black
    (0) and white (1), depth 8 gray; 24-bit pixels are B, G, R and 32-bit
    ones X, B, G, R."""
    s = _ByteStream(data)
    s.take(4)
    width, height, depth = struct.unpack(">iii", s.take(12))
    pal_size = (1 << depth) * 3 if 0 < depth <= 8 else 0
    if width <= 0 or height <= 0 or depth not in (1, 8, 24, 32):
        raise _Corrupt("bad Sun raster header")
    s.take(4)
    rtype, maptype, maplen = struct.unpack(">iii", s.take(12))
    if not (0 <= rtype <= 1 and ((maptype == 0 and maplen == 0)
                                 or (maptype == 1 and 0 < maplen <= pal_size
                                     and depth <= 8))):
        raise _Corrupt("a Sun raster type or colour map cv2 does not read")
    _check_size(width, height)
    palette = np.zeros((256, 3), np.uint8)
    if maplen:
        planes = s.take(maplen)
        n = maplen // 3
        palette[:n] = np.frombuffer(planes[:3 * n], np.uint8) \
            .reshape(3, n).T
    elif depth == 1:
        palette[1] = 255
    else:
        palette[:] = np.arange(256, dtype=np.uint8)[:, None]
    pitch = ((width * depth + 7) // 8 + 1) & ~1
    rows = np.frombuffer(s.take(pitch * height), np.uint8) \
        .reshape(height, pitch)
    if depth == 1:
        return palette[_unpack_bits(rows, 1)[:, :width]]
    if depth == 8:
        return palette[rows[:, :width]]
    px = rows[:, :width * depth // 8].reshape(height, width, depth // 8)
    return np.ascontiguousarray(px[..., ::-1][..., :3])


def _float_to_u8(v: np.ndarray) -> np.ndarray:
    """Mat::convertTo(CV_8U) of float32 values: rounded half to even and
    saturated; NaN, infinities and values past the int range become 0
    (cvRound's INT_MIN, saturated)."""
    with np.errstate(invalid="ignore", over="ignore"):
        r = np.rint(v.astype(np.float32))
        ok = np.isfinite(r) & (r < 2.0 ** 31) & (r >= -(2.0 ** 31))
        return np.where(ok, np.clip(np.where(ok, r, 0), 0, 255), 0) \
            .astype(np.uint8)


_C_INT = re.compile(rb"[+-]?\d*")
_C_FLOAT = re.compile(
    rb"[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf(?:inity)?|nan)",
    re.IGNORECASE)


def _atoi(token: bytes) -> int:
    """C's atoi on a token without whitespace (0 where no digits lead)."""
    text = _C_INT.match(token).group()
    try:
        n = int(text)
    except ValueError:
        return 0
    return (n + (1 << 31)) % (1 << 32) - (1 << 31)


def _atof(token: bytes) -> float:
    """C's atof on a token without whitespace (0.0 where no number leads)."""
    m = _C_FLOAT.match(token)
    if m is None:
        return 0.0
    try:
        return float(m.group())
    except (ValueError, OverflowError):
        return 0.0


def _pfm_token(s: _ByteStream) -> bytes:
    """grfmt_pfm.cpp read_number's text: up to 64 bytes, ended by the first
    whitespace byte (which it takes), none skipped before; a byte past 127
    fails its check."""
    out = bytearray()
    for _ in range(64):
        c = s.byte()
        if c > 127:
            raise _Corrupt("PFM header byte past 127")
        if c in _SPACE:
            break
        out.append(c)
    return bytes(out)


def _decode_pfm(data: bytes) -> np.ndarray:
    """OpenCV's PFMDecoder for a colour PFM ("PF\\n", then width, height
    and scale each ended by one whitespace byte, as atoi/atof read them):
    float32 rows bottom to top, big-endian for a scale of 0 or more and
    little-endian below; each value divided by |scale| (a scale of 0 or NaN
    gives None), then converted to 8 bits without scaling, as imread's
    convertTo does (rounded, saturated, non-finite values 0)."""
    s = _ByteStream(data)
    if s.take(3) != b"PF\n":
        raise _Corrupt("not a colour PFM")
    width = _atoi(_pfm_token(s))
    height = _atoi(_pfm_token(s))
    scale = _atof(_pfm_token(s))
    _check_size(width, height)
    rows = np.frombuffer(s.take(width * height * 12),
                         ">f4" if scale >= 0 else "<f4")
    if not abs(scale) > 0:
        raise _Corrupt("PFM scale 0")
    rgb = rows.reshape(height, width, 3)[::-1].astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        rgb = rgb * np.float32(1.0 / abs(scale))
    return _float_to_u8(rgb)


def _hdr_line(s: _ByteStream) -> bytes:
    """fgets into rgbe.cpp's 128-byte buffer: a line with its newline, at
    most 127 bytes; the end of the file fails."""
    out = bytearray()
    while len(out) < 127:
        if s.pos >= len(s.data):
            if not out:
                raise _Corrupt("Radiance HDR header cut short")
            break
        c = s.byte()
        out.append(c)
        if c == 10:
            break
    return bytes(out)


def _hdr_size(line: bytes) -> tuple[int, int]:
    """sscanf(line, "-Y %d +X %d"): (height, width)."""
    m = re.match(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)", line)
    if m is None:
        raise _Corrupt("Radiance HDR without its image size")
    return int(m.group(1)), int(m.group(2))


def _decode_hdr(data: bytes) -> np.ndarray:
    """OpenCV's HdrDecoder over rgbe.cpp: the header's lines up to
    "FORMAT=32-bit_rle_rgbe", a blank line and "-Y <height> +X <width>"
    (other lines skipped; a blank line before the format, another format
    or another orientation gives None), the pixels as native/hdr.cpp reads
    them, each RGBE quadruple as rgbe2float makes floats of it (exponent 0
    is black), then imread's convertTo with a factor of 255 (float32
    products, rounded, saturated)."""
    s = _ByteStream(data)
    line = _hdr_line(s)
    if line[:2] == b"#?":
        line = _hdr_line(s)
    while line != b"FORMAT=32-bit_rle_rgbe\n":
        if line[:1] in (b"", b"\0", b"\n"):
            raise _Corrupt("Radiance HDR without its format")
        line = _hdr_line(s)
    if _hdr_line(s) != b"\n":
        raise _Corrupt("Radiance HDR without the blank line")
    height, width = _hdr_size(_hdr_line(s))
    _check_size(width, height)
    rgbe = native.hdr_pixels(data, s.pos, width, height)
    if rgbe is None:
        raise _Corrupt("bad Radiance HDR pixels")
    e = rgbe[..., 3:].astype(np.int64)
    f = np.where(e > 0, np.ldexp(np.float32(1), e - 136), 0) \
        .astype(np.float32)
    return _float_to_u8(rgbe[..., :3].astype(np.float32) * f
                        * np.float32(255))


# ---------------------------------------------------------------------------
# AVIF (libavif 1.4.2's container as cv2 reads it; the AV1 frames are
# native/av1.cpp, their YUV -> RGB libyuv's through libavif)
# ---------------------------------------------------------------------------

# the item properties libavif reads (an unknown essential one makes it
# skip the item)
_AVIF_PROPERTIES = {b"ispe", b"auxC", b"colr", b"av1C", b"av2C", b"pasp",
                    b"clap", b"irot", b"imir", b"pixi", b"a1op", b"lsel",
                    b"a1lx", b"clli", b"mdcv", b"cclv", b"amve"}
_AVIF_ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
                    b"urn:mpeg:hevc:2015:auxid:1")
# av1.cpp's status codes for the variants it refuses
_AV1_NO_FRAME = 9  # av1.cpp: OBUs libaom reads that hold no frame
_AV1_VARIANTS = {
    3: "AVIF with superres (no tool at hand writes it, so no decode of it "
       "could be held against cv2's)",
}


def _avif_boxes(data: bytes, start: int, end: int, top: bool = False):
    """(type, body start, box end) of each ISOBMFF box in data[start:end]
    (_avif_box_header); at the top level a box may run past ``end``, as
    libavif skips what it does not read."""
    at = start
    while at < end:
        kind, head, size = _avif_box_header(data, at, end, top)
        yield kind, at + head, at + size
        at += size


def _avif_box_header(data: bytes, at: int, end: int, top: bool = False
                     ) -> tuple[bytes, int, int]:
    """(type, header length, size) of the box at ``at`` within a parent
    ending at ``end``, as libavif reads a box header: a size of 1 is a
    64-bit size; 0 runs to ``end`` and only a top-level box may have it;
    a nested box that runs past its parent fails."""
    if end - at < 8:
        raise _Corrupt("AVIF box header cut short")
    size, kind = struct.unpack_from(">I4s", data, at)
    head = 8
    if size == 1:
        if end - at < 16:
            raise _Corrupt("AVIF box header cut short")
        size = struct.unpack_from(">Q", data, at + 8)[0]
        head = 16
    elif size == 0:
        if not top:
            raise _Corrupt(f"AVIF nested {kind!r} box of size 0")
        size = end - at
    if kind == b"uuid":
        head += 16
    if size < head:
        raise _Corrupt("AVIF box smaller than its header")
    if at + size > end and not top:
        raise _Corrupt(f"AVIF {kind!r} box runs past its parent")
    return kind, head, size


def _avif_children(data: bytes, start: int, end: int) -> dict:
    """The first box of each type among data[start:end]'s boxes."""
    out = {}
    for kind, body, box_end in _avif_boxes(data, start, end):
        out.setdefault(kind, (body, box_end))
    return out


class _AvifReader:
    """Big-endian fields of one box; reading past the box fails."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.at, self.end = data, start, end

    def uint(self, nbytes: int) -> int:
        if nbytes == 0:
            return 0
        if self.at + nbytes > self.end:
            raise _Corrupt("AVIF box cut short")
        v = int.from_bytes(self.data[self.at:self.at + nbytes], "big")
        self.at += nbytes
        return v

    def full_box(self) -> tuple[int, int]:
        return self.uint(1), self.uint(3)


# cv2's AvifDecoder::checkSignature runs avifDecoderParse over the file's
# first 500 bytes (the size hint set far past them): it takes the file where
# that gives OK or AVIF_RESULT_TRUNCATED_DATA, so a read that starts past
# them (AVIF_RESULT_IO_ERROR) makes cv2 give None for a file it could read
_AVIF_SIGNATURE = 500


def _avif_signature_cut(boxes: list) -> bool:
    """Whether checkSignature's parse stops within the top-level boxes
    (kind, start, body, end) the parse of the whole file read, taking the
    file: at the end of the signature bytes, or at a box it reads whole
    (ftyp, meta, moov) that runs past them. A header that starts past
    them, or that they cut, fails it (_Corrupt). False where the parse
    reads all it needs within them and goes on to avifDecoderReset."""
    for kind, at, body, end in boxes:
        if at >= _AVIF_SIGNATURE:
            if at > _AVIF_SIGNATURE:
                raise _Corrupt("AVIF box past cv2's signature bytes")
            return True
        if body > _AVIF_SIGNATURE:
            raise _Corrupt("AVIF box header cut by cv2's signature bytes")
        if kind in (b"ftyp", b"meta", b"moov") and end > _AVIF_SIGNATURE:
            return True
    return False


def _avif_signature_reads(reads: list) -> None:
    """The reads avifDecoderReset makes in checkSignature's parse (a grid's
    ImageGrid payload, the first colour sample's leading bytes for its
    sequence header where no colr nclx gives the CICP), in order, each a
    list of file extents and the bytes it needs: one that starts past the
    signature bytes fails; one they cut stops the parse, taking the
    file."""
    for extents, need in reads:
        for offset, length in extents:
            if not need:
                break
            if offset > _AVIF_SIGNATURE:
                raise _Corrupt("AVIF read past cv2's signature bytes")
            take = min(length, need)
            if offset + take > _AVIF_SIGNATURE:
                return
            need -= take


def _avif_top(data: bytes) -> tuple[dict, bytes, list]:
    """The top-level boxes libavif's avifParse reads: ftyp, meta and moov
    whole, the rest skipped, until it has ftyp and the meta (brand avif)
    and moov (brand avis) the brands ask for -> ({type: (body, end)}, the
    major brand, (type, start, body, end) of each box it went through)."""
    top, brands, boxes, at = {}, set(), [], 0
    for kind, body, end in _avif_boxes(data, 0, len(data), top=True):
        if kind in (b"ftyp", b"meta", b"moov") and end > len(data):
            raise _Corrupt("AVIF file cut short")
        if kind == b"ftyp" and kind not in top and end - body >= 8:
            brands = {data[i:i + 4] for i in [body] + list(
                range(body + 8, end - 3, 4))}
        top.setdefault(kind, (body, end))
        boxes.append((kind, at, body, end))
        at = end
        if (b"ftyp" in top and (b"avif" not in brands or b"meta" in top)
                and (b"avis" not in brands or b"moov" in top)):
            break
    if b"ftyp" not in top:
        raise _Corrupt("AVIF without ftyp")
    body, end = top[b"ftyp"]
    if end - body < 8:
        raise _Corrupt("AVIF ftyp cut short")
    if not brands & {b"avif", b"avis"}:
        raise _Corrupt("not an AVIF image")
    if b"avif" in brands and b"meta" not in top:
        raise _Corrupt("AVIF of brand avif without meta")
    if b"avis" in brands and b"moov" not in top:
        raise _Corrupt("AVIF of brand avis without moov")
    return top, data[body:body + 4], boxes


class _AvifMeta:
    """A meta box's items as libavif's avifParseMetaBox reads them: hdlr
    ``pict``, pitm, iinf/infe (v2-3), iloc (v0-2, several extents,
    construction methods 0 and 1 (idat)), iref and iprp/ipco/ipma."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data = data
        r = _AvifReader(data, start, end)
        if r.full_box()[0] != 0:
            raise _Corrupt("AVIF meta of version 1 or more")
        meta = _avif_children(data, r.at, r.end)
        self.idat = meta.get(b"idat")
        if b"hdlr" not in meta:
            raise _Corrupt("AVIF without hdlr")
        body, end = meta[b"hdlr"]
        if (end - body < 24 or data[body] != 0
                or data[body + 4:body + 8] != bytes(4)
                or data[body + 8:body + 12] != b"pict"
                or b"\0" not in data[body + 24:end]):
            raise _Corrupt("AVIF hdlr not version 0, pre_defined 0, pict, "
                           "with a name")
        self.primary = 0
        if b"pitm" in meta:
            r = _AvifReader(data, *meta[b"pitm"])
            version, _ = r.full_box()
            self.primary = r.uint(2 if version == 0 else 4)
        self.types = self._item_types(meta.get(b"iinf"))
        self.locations = self._locations(meta.get(b"iloc"))
        self.refs = self._references(meta.get(b"iref"))
        self.props, self.assoc = self._properties(meta.get(b"iprp"))
        # each item's last auxl and prem target, and the grid (and index
        # in its reference) each dimg target is a cell of, as libavif keeps
        # them
        self.aux_for, self.prem_by, self.dimg_for = {}, {}, {}
        for kind, source, targets in self.refs:
            for index, target in enumerate(targets):
                if kind == b"auxl":
                    self.aux_for[source] = target
                elif kind == b"prem":
                    self.prem_by[source] = target
                elif kind == b"dimg":
                    # ISO/IEC 14496-12 8.11.12.1: each target once
                    if self.dimg_for.get(target, (0,))[0] == source:
                        raise _Corrupt("AVIF dimg reference naming an item "
                                       "twice")
                    self.dimg_for[target] = (source, index)

    def _item_types(self, box) -> dict:
        data, types = self.data, {}
        if box is None:
            return types
        r = _AvifReader(data, *box)
        version, _ = r.full_box()
        count = r.uint(2 if version == 0 else 4)
        entries = _avif_boxes(data, r.at, box[1])
        for _ in range(count):
            kind, body, end = next(entries, (None, 0, 0))
            if kind != b"infe":
                raise _Corrupt("AVIF iinf entry that is not an infe box")
            e = _AvifReader(data, body, end)
            version, _ = e.full_box()
            if version not in (2, 3):
                raise _Corrupt("AVIF infe of a version other than 2 or 3")
            item = e.uint(2 if version == 2 else 4)
            if item == 0:
                raise _Corrupt("AVIF infe of item 0")
            e.uint(2)
            types[item] = e.uint(4).to_bytes(4, "big")
            if b"\0" not in data[e.at:end]:
                raise _Corrupt("AVIF infe item_name without its terminator")
        return types

    def _locations(self, box) -> dict:
        locations = {}
        if box is None:
            return locations
        r = _AvifReader(self.data, *box)
        version, _ = r.full_box()
        if version > 2:
            raise _Corrupt("AVIF iloc of an unknown version")
        sizes = r.uint(2)
        off_size, len_size = sizes >> 12, (sizes >> 8) & 15
        base_size, index_size = (sizes >> 4) & 15, sizes & 15
        for _ in range(r.uint(2 if version < 2 else 4)):
            item = r.uint(2 if version < 2 else 4)
            if item == 0 or item in locations:
                raise _Corrupt("AVIF iloc entry of item 0 or of an item "
                               "twice")
            method = r.uint(2) & 15 if version in (1, 2) else 0
            r.uint(2)
            base = r.uint(base_size)
            extents = []
            for _ in range(r.uint(2)):
                if version in (1, 2):
                    r.uint(index_size)
                extents.append((base + r.uint(off_size), r.uint(len_size)))
            locations[item] = (method, extents)
        return locations

    def _references(self, box) -> list:
        refs = []
        if box is None:
            return refs
        r = _AvifReader(self.data, *box)
        version, _ = r.full_box()
        width = 2 if version == 0 else 4
        # libavif skips an iref of a version past 1, and reads each
        # reference's fields on from its box header, whatever the box's
        # size says
        while version <= 1 and r.at < r.end:
            kind, head, _ = _avif_box_header(self.data, r.at, r.end)
            r.at += head
            source = r.uint(width)
            targets = [r.uint(width) for _ in range(r.uint(2))]
            if not source or not all(targets):
                raise _Corrupt("AVIF iref reference from or to item 0")
            refs.append((kind, source, targets))
        return refs

    def _properties(self, box) -> tuple[list, dict]:
        data, props, assoc = self.data, [], {}
        if box is None:
            return props, assoc
        iprp = _avif_children(data, *box)
        if b"ipco" in iprp:
            props = list(_avif_boxes(data, *iprp[b"ipco"]))
            for prop in props:
                _avif_check_property(data, *prop)
        for kind, body, end in _avif_boxes(data, *box):
            if kind != b"ipma":
                continue
            r = _AvifReader(data, body, end)
            version, flags = r.full_box()
            for _ in range(r.uint(4)):
                item = r.uint(2 if version < 1 else 4)
                # the items iloc, iinf and iref name (libavif makes an
                # item for each); ipma may not name another
                known = (item in self.locations or item in self.types
                         or any(item == s or item in t
                                for _, s, t in self.refs))
                if item in assoc or not known:
                    raise _Corrupt("AVIF ipma entry of an unknown or "
                                   "repeated item")
                assoc[item] = []
                for _ in range(r.uint(1)):
                    v = r.uint(2) if flags & 1 else r.uint(1)
                    bits = 15 if flags & 1 else 7
                    index = v & ((1 << bits) - 1)
                    if index > len(props) or (not index and v >> bits):
                        raise _Corrupt("AVIF property index out of range, "
                                       "or 0 and essential")
                    # AV1-AVIF 2.3.2: a1op and lsel essential, a1lx not
                    kind = props[index - 1][0] if index else None
                    if (kind == b"a1lx" and v >> bits) or (
                            kind in (b"a1op", b"lsel") and not v >> bits):
                        raise _Corrupt(f"AVIF {kind!r} of the wrong "
                                       "essential flag")
                    if index:
                        assoc[item].append((index, v >> bits))
        return props, assoc

    def items(self) -> set[int]:
        """The items libavif makes: those iloc, iinf, iref and ipma name."""
        return (set(self.locations) | set(self.types) | set(self.assoc)
                | {i for _, s, t in self.refs for i in [s, *t]})

    def item_boxes(self, item: int, kind: bytes) -> list:
        """(body, end) of each of an item's properties of a type."""
        return [self.props[i - 1][1:] for i, _ in self.assoc.get(item, [])
                if self.props[i - 1][0] == kind]

    def item_props(self, item: int) -> dict:
        out = {}
        for index, _ in self.assoc.get(item, []):
            kind, body, end = self.props[index - 1]
            out.setdefault(kind, (body, end))
        return out

    def unknown_essential(self, item: int) -> bool:
        return any(ess and self.props[index - 1][0] not in _AVIF_PROPERTIES
                   for index, ess in self.assoc.get(item, []))

    def skipped(self, item: int) -> bool:
        """libavif skips an item without data, or with an essential
        property it does not know."""
        if not sum(n for _, n in self.locations.get(item, (0, []))[1]):
            return True
        return self.unknown_essential(item)

    def payload(self, item: int) -> bytes:
        if item not in self.locations:
            raise _Corrupt("AVIF item without a location")
        method, extents = self.locations[item]
        chunks = []
        for offset, length in extents:
            if method == 0:
                start, limit = offset, len(self.data)
            elif method == 1 and self.idat is not None:
                start, limit = self.idat[0] + offset, self.idat[1]
            else:
                raise _Corrupt("AVIF item construction method not read")
            if start + length > limit:
                raise _Corrupt("AVIF item extent past the end of the file")
            chunks.append(self.data[start:start + length])
        return b"".join(chunks)

    def ispe(self, item: int) -> tuple[int, int] | None:
        """An item's ispe (version 0) within libavif's default size
        limits, or None where it has none."""
        props = self.item_props(item)
        if b"ispe" not in props:
            return None
        r = _AvifReader(self.data, *props[b"ispe"])
        if r.full_box()[0] != 0:
            raise _Corrupt("AVIF ispe of version 1 or more")
        ispe = (r.uint(4), r.uint(4))
        _avif_check_dimensions(*ispe)
        return ispe

    def layering(self, item: int) -> tuple[int, int, int | None]:
        """An AV1 item's operating point (a1op, else 0), the frame libavif
        takes of it (lsel's layer: its first frame of that spatial id; -1
        without lsel or with 0xFFFF: the last) and the bytes of the item
        it hands the decoder (None: all), as libavif's
        avifCodecDecodeInputFillFromDecoderItem reads a1lx: each layer
        size given must be smaller than what is left of the item, and an
        lsel layer within a1lx's layers takes those up to it alone."""
        props = self.item_props(item)
        op = self.data[props[b"a1op"][0]] if b"a1op" in props else 0
        layer, keep, sizes = -1, None, []
        if b"a1lx" in props:
            body, _ = props[b"a1lx"]
            width = 4 if self.data[body] & 1 else 2
            left = self.file_extents(item)[1]
            for i in range(3):
                at = body + 1 + i * width
                size = int.from_bytes(self.data[at:at + width], "big")
                if not size:
                    break
                if size >= left:
                    raise _Corrupt("AVIF a1lx layer past the item's size")
                sizes.append(size)
                left -= size
            sizes.append(left)
        if b"lsel" in props:
            body, _ = props[b"lsel"]
            layer = int.from_bytes(self.data[body:body + 2], "big")
            if layer == 0xFFFF:
                layer = -1
            elif sizes:
                if layer >= len(sizes):
                    raise _Corrupt("AVIF lsel layer past a1lx's layers")
                keep = sum(sizes[:layer + 1])
        return op, layer, keep

    def av1_item(self, item: int) -> tuple[bytes, tuple[int, int]]:
        """An av01 item's payload as libavif hands it to libaom, and its
        (operating point, layer) (layering)."""
        op, layer, keep = self.layering(item)
        payload = self.payload(item)
        return payload if keep is None else payload[:keep], (op, layer)

    def cells(self, item: int) -> list[int]:
        """The items a grid's dimg reference names, by their index in it
        (libavif's avifFillDimgIdxToItemIdxArray: each index once)."""
        cells = [(index, cell) for cell, (source, index)
                 in self.dimg_for.items() if source == item]
        if sorted(i for i, _ in cells) != list(range(len(cells))):
            raise _Corrupt("AVIF grid whose dimg reference does not name "
                           "its cells once each")
        return [cell for _, cell in sorted(cells)]

    def file_extents(self, item: int) -> tuple[list, int]:
        """An item's extents in the file (none where it lies in idat) and
        its size."""
        method, extents = self.locations.get(item, (0, []))
        return ([] if method else extents), sum(n for _, n in extents)

    def image(self, item: int) -> dict:
        """An av01 or grid item -> {"cells": the AV1 payloads (one, or the
        grid's cells in the order of its dimg reference; av1_item),
        "layering": each cell's (operating point, layer), "grid": (rows,
        columns, output width, output height) or None, a grid's
        "cell_ispes" (each cell's, or None), "config_mono": the monochrome
        flag of the av1C libavif takes (a grid's own, else its first
        cell's)}, with libavif's checks of a grid
        (avifDecoderItemReadAndParse, avifDecoderGenerateImageTiles,
        avifDecoderItemValidateProperties)."""
        props = self.item_props(item)
        if self.types.get(item) != b"grid":
            if b"av1C" not in props:
                raise _Corrupt("AVIF item without av1C")
            payload, layering = self.av1_item(item)
            return {"cells": [payload], "grid": None, "layering": [layering],
                    "config_mono": _avif_check_config(self.data, props)}
        grid = _avif_image_grid(self.payload(item))
        cells = self.cells(item)
        if len(cells) != grid[0] * grid[1]:
            raise _Corrupt("AVIF grid of another number of dimg cells")
        for cell in cells:
            if self.types.get(cell) != b"av01" or self.skipped(cell):
                raise _Corrupt("AVIF grid cell not AV1, empty or not read")
            if b"av1C" not in self.item_props(cell):
                raise _Corrupt("AVIF grid cell without av1C")
        config = props.get(b"av1C", self.item_props(cells[0])[b"av1C"])
        config_mono = _avif_check_config(self.data, {**props,
                                                     b"av1C": config})
        for cell in cells:
            body, _ = self.item_props(cell)[b"av1C"]
            _avif_check_config(self.data, {b"av1C": (body, body + 4)})
            # MIAF 7.3.11.4.1: every cell of one decoder configuration
            if self.data[body + 1:body + 3] != \
                    self.data[config[0] + 1:config[0] + 3]:
                raise _Corrupt("AVIF grid cells of different av1C")
        items = [self.av1_item(c) for c in cells]
        return {"cells": [payload for payload, _ in items], "grid": grid,
                "cell_ispes": [self.ispe(c) for c in cells],
                "layering": [layering for _, layering in items],
                "config_mono": config_mono}


def _avif_check_dimensions(width: int, height: int) -> None:
    """libavif's default image size limits (avifDimensionsTooLarge)."""
    if (not width or not height or max(width, height) > 32768
            or width * height > 16384 * 16384):
        raise _Corrupt("AVIF size out of libavif's limits")


def _avif_image_grid(payload: bytes) -> tuple[int, int, int, int]:
    """An ImageGrid payload as libavif's avifParseImageGridBox reads it:
    version 0, flags (bit 0: 32-bit output sizes), rows - 1, columns - 1,
    output width and height (not zero, within libavif's limits, and
    nothing after them) -> (rows, columns, width, height)."""
    if len(payload) < 4 or payload[0] != 0:
        raise _Corrupt("AVIF ImageGrid cut short or not version 0")
    field = 4 if payload[1] & 1 else 2
    if len(payload) != 4 + 2 * field:
        raise _Corrupt("AVIF ImageGrid of another length")
    width = int.from_bytes(payload[4:4 + field], "big")
    height = int.from_bytes(payload[4 + field:], "big")
    _avif_check_dimensions(width, height)
    return payload[2] + 1, payload[3] + 1, width, height


def _avif_item_source(data: bytes, m: _AvifMeta) -> dict:
    """meta's primary item (av01 or grid) and its alpha item, as libavif's
    avifDecoderReset takes them for the primary item source."""
    if m.types.get(m.primary) not in (b"av01", b"grid") \
            or m.skipped(m.primary):
        raise _Corrupt("AVIF primary item is not AV1 or a grid, or not read")
    # every image item libavif reads has an ispe, unless it is alpha
    for item in m.items():
        if (m.types.get(item) in (b"av01", b"grid") and not m.skipped(item)
                and m.ispe(item) is None and _avif_aux_type(
                    data, m.item_props(item)) not in _AVIF_ALPHA_URNS):
            raise _Corrupt(f"AVIF item {item} without ispe")
    color = m.image(m.primary)
    ispe = m.ispe(m.primary)
    if ispe is None:
        raise _Corrupt("AVIF primary item without ispe")
    if color["grid"] is not None and ispe != color["grid"][2:]:
        raise _Corrupt("AVIF grid whose ispe is not its output size")
    alpha = alpha_item = None
    for kind, source, targets in m.refs:
        if kind != b"auxl" or m.aux_for.get(source) != m.primary:
            continue
        if m.types.get(source) not in (b"av01", b"grid") or m.skipped(source):
            continue
        if _avif_aux_type(data, m.item_props(source)) in _AVIF_ALPHA_URNS:
            alpha, alpha_item = m.image(source), source
            alpha["ispe"] = m.ispe(source) or ispe
            break
    # the reads avifDecoderReset makes: the ImageGrid payloads, then the
    # first cell's sequence header where no colr nclx sets the CICP
    nclx = _avif_nclx(data, m.item_boxes(m.primary, b"colr"))
    reads = [m.file_extents(item) for item in (m.primary, alpha_item)
             if m.types.get(item) == b"grid"]
    if nclx is None:
        cell = m.cells(m.primary)[0] if color["grid"] else m.primary
        reads.append((m.file_extents(cell)[0], 64))
    return {**color, "alpha": alpha, "nclx": nclx, "ispe": ispe,
            "premultiplied": alpha is not None
            and m.prem_by.get(m.primary) == alpha_item,
            "source": "item", "frames": 1, "signature_reads": reads}


_AVIF_IMAGE_COUNT_LIMIT = 12 * 3600 * 60  # libavif's default


def _avif_string(data: bytes, at: int, end: int) -> None:
    if b"\0" not in data[at:end]:
        raise _Corrupt("AVIF string without its terminator")


def _avif_tracks(data: bytes, start: int, end: int) -> list[dict]:
    """A moov box's tracks as libavif's avifParseMovieBox reads them."""
    tracks = [_avif_track(data, body, box_end)
              for kind, body, box_end in _avif_boxes(data, start, end)
              if kind == b"trak"]
    if not tracks:
        raise _Corrupt("AVIF moov without a track")
    return tracks


def _avif_once(seen: set, kind: bytes) -> None:
    if kind in seen:
        raise _Corrupt(f"AVIF box {kind!r} twice")
    seen.add(kind)


def _avif_track(data: bytes, start: int, end: int) -> dict:
    """One trak: tkhd (its id and size), tref (auxl, prem), edts/elst and
    mdia (mdhd, hdlr, minf/stbl), with libavif's checks."""
    track = {"id": 0, "aux_for": 0, "prem_by": 0, "stbl": None}
    seen = set()
    repeating, segment, duration = False, 0, 0
    for kind, body, box_end in _avif_boxes(data, start, end):
        r = _AvifReader(data, body, box_end)
        if kind == b"tkhd":
            _avif_once(seen, kind)
            version, _ = r.full_box()
            if version > 1:
                raise _Corrupt("AVIF tkhd of an unknown version")
            wide = 8 if version == 1 else 4
            r.uint(2 * wide)  # creation and modification times
            track_id = r.uint(4)
            r.uint(4)
            duration = r.uint(wide)
            if duration == (1 << 8 * wide) - 1:
                duration = None  # indefinite
            r.uint(52)
            width, height = r.uint(4) >> 16, r.uint(4) >> 16
            _avif_check_dimensions(width, height)
            track.update(id=track_id, size=(width, height))
        elif kind == b"meta":
            _AvifMeta(data, body, box_end)
        elif kind == b"mdia":
            _avif_media(data, body, box_end, track)
        elif kind == b"tref":
            while r.at < r.end:
                ref, head, size = _avif_box_header(data, r.at, r.end)
                at = r.at + head
                r.at += size
                if ref in (b"auxl", b"prem"):
                    if size - head < 4:
                        raise _Corrupt("AVIF tref reference cut short")
                    first = int.from_bytes(data[at:at + 4], "big")
                    track["aux_for" if ref == b"auxl" else "prem_by"] = first
        elif kind == b"edts":
            _avif_once(seen, kind)
            elst = [(b, e) for k, b, e in _avif_boxes(data, body, box_end)
                    if k == b"elst"]
            if len(elst) != 1:
                raise _Corrupt("AVIF edts without one elst")
            e = _AvifReader(data, *elst[0])
            version, flags = e.full_box()
            repeating = bool(flags & 1)
            if repeating:
                if e.uint(4) != 1:
                    raise _Corrupt("AVIF elst of other than one entry")
                if version > 1:
                    raise _Corrupt("AVIF elst of an unknown version")
                segment = e.uint(8 if version == 1 else 4)
    if b"tkhd" not in seen:
        raise _Corrupt("AVIF trak without tkhd")
    if repeating and segment == 0:
        raise _Corrupt("AVIF repeating elst of segment duration 0")
    return track


def _avif_media(data: bytes, start: int, end: int, track: dict) -> None:
    """mdia: mdhd, hdlr and minf, each once; minf's stbl."""
    seen = set()
    for kind, body, box_end in _avif_boxes(data, start, end):
        r = _AvifReader(data, body, box_end)
        if kind == b"mdhd":
            _avif_once(seen, kind)
            version, _ = r.full_box()
            if version > 1:
                raise _Corrupt("AVIF mdhd of an unknown version")
            r.uint(20 if version == 1 else 12)
            r.uint(8 if version == 1 else 4)
        elif kind == b"hdlr":
            _avif_once(seen, kind)
            if r.full_box()[0] != 0 or r.uint(4) != 0:
                raise _Corrupt("AVIF hdlr not version 0, pre_defined 0")
            r.uint(16)  # handler_type, reserved
            _avif_string(data, r.at, box_end)
        elif kind == b"minf":
            stbls = [(b, e) for k, b, e in _avif_boxes(data, body, box_end)
                     if k == b"stbl"]
            for stbl in stbls:
                if track["stbl"] is not None:
                    raise _Corrupt("AVIF track of two stbl boxes")
                track["stbl"] = _avif_sample_table(data, *stbl)


def _avif_sample_table(data: bytes, start: int, end: int) -> dict:
    """stbl as libavif's avifParseSampleTableBox reads it: chunk offsets
    (stco and co64 alike), sample-to-chunk runs (from chunk 1, strictly
    increasing), sample sizes (one for all, or each), sync samples, time
    to sample, and the sample descriptions (an av01 entry's properties
    after its 78-byte VisualSampleEntry)."""
    t = {"chunks": [], "stsc": [], "size": 0, "sizes": [],
         "descriptions": []}
    for kind, body, box_end in _avif_boxes(data, start, end):
        r = _AvifReader(data, body, box_end)
        if kind not in (b"stco", b"co64", b"stsc", b"stsz", b"stss",
                        b"stts", b"stsd"):
            continue
        # stsd may be of version 1 (ISO/IEC 14496-12 8.5.2)
        if r.full_box()[0] > (kind == b"stsd"):
            raise _Corrupt(f"AVIF {kind!r} of an unknown version")
        if kind == b"stsz":
            size, count = r.uint(4), r.uint(4)
            if size:
                t["size"] = size
            else:
                t["sizes"] += [r.uint(4) for _ in range(count)]
            continue
        count = r.uint(4)
        if kind == b"stsd":
            entries = _avif_boxes(data, r.at, box_end)
            for _ in range(count):
                fmt, entry, entry_end = next(entries, (None, 0, 0))
                if fmt is None:
                    raise _Corrupt("AVIF stsd cut short")
                if fmt == b"av01":
                    if entry_end - entry < 78:
                        raise _Corrupt("AVIF VisualSampleEntry cut short")
                    for prop in _avif_boxes(data, entry + 78, entry_end):
                        _avif_check_property(data, *prop)
                t["descriptions"].append((fmt, entry + 78, entry_end))
            continue
        for _ in range(count):
            if kind == b"stco":
                t["chunks"].append(r.uint(4))
            elif kind == b"co64":
                t["chunks"].append(r.uint(8))
            elif kind == b"stsc":
                first, per_chunk = r.uint(4), r.uint(4)
                r.uint(4)
                previous = t["stsc"][-1][0] if t["stsc"] else 0
                if (first != 1) if not t["stsc"] else first <= previous:
                    raise _Corrupt("AVIF stsc not from chunk 1 and "
                                   "increasing")
                t["stsc"].append((first, per_chunk))
            else:
                r.uint(4 if kind == b"stss" else 8)
    return t


# the bytes libavif's parse of a property reads (a1lx: with 16-bit sizes)
_AVIF_PROPERTY_BYTES = {b"pasp": 8, b"clap": 32, b"clli": 4, b"a1op": 1,
                        b"lsel": 2, b"a1lx": 7, b"irot": 1, b"imir": 1}


def _avif_check_property(data: bytes, kind: bytes, body: int, end: int
                         ) -> None:
    """libavif's parse of a property, which it makes of every property in
    ipco (and in a sample entry), used or not: one it cannot read fails
    the file (a box cut short, a version other than 0 where it asks for
    one, reserved bits of irot and imir, a pixi of other than 1 to 4
    planes of 1 to 16 bits, an ICC profile of no bytes, an auxC or auxi
    without its terminator)."""
    size = end - body
    if kind in (b"auxi", b"auxC"):
        _avif_aux_type(data, {kind: (body, end)}, kind)
    elif kind == b"av1C":
        _avif_check_config(data, {kind: (body, end)})
    elif kind == b"colr":
        colour = data[body:body + 4]
        if size < 4 or (size == 4 and colour in (b"rICC", b"prof")) or (
                colour == b"nclx" and (size < 11 or data[body + 10] & 0x7F)):
            raise _Corrupt("AVIF colr cut short, or nclx with reserved bits")
    elif kind == b"ispe":
        r = _AvifReader(data, body, end)
        if r.full_box()[0] != 0:
            raise _Corrupt("AVIF ispe of version 1 or more")
        r.uint(8)
    elif kind == b"pixi":
        r = _AvifReader(data, body, end)
        version, _ = r.full_box()
        planes = r.uint(1)
        if version != 0 or not 1 <= planes <= 4 or not all(
                1 <= r.uint(1) <= 16 for _ in range(planes)):
            raise _Corrupt("AVIF pixi not version 0, or not of 1 to 4 "
                           "planes of 1 to 16 bits")
    elif kind in _AVIF_PROPERTY_BYTES:
        need = _AVIF_PROPERTY_BYTES[kind]
        if kind == b"a1lx" and size and data[body] & 1:
            need = 13  # 32-bit sizes
        if size < need or (kind == b"irot" and data[body] & 0xFC) or (
                kind in (b"imir", b"a1lx") and data[body] & 0xFE):
            raise _Corrupt(f"AVIF {kind!r} cut short or with reserved bits")
        layer = int.from_bytes(data[body:body + 2], "big")
        if (kind == b"a1op" and data[body] > 31) or (
                kind == b"lsel" and 4 <= layer < 0xFFFF):
            raise _Corrupt(f"AVIF {kind!r} past AV1's operating points or "
                           "layers")


def _avif_aux_type(data: bytes, props: dict, kind: bytes = b"auxC"
                   ) -> bytes | None:
    """The URN of an auxC (or a sample entry's auxi) property, or None
    where there is none; one not of version 0 or without its terminator
    fails."""
    if kind not in props:
        return None
    body, end = props[kind]
    if end - body < 4 or data[body] != 0 or b"\0" not in data[body + 4:end]:
        raise _Corrupt("AVIF auxC not version 0 with a terminated type")
    return data[body + 4:end].split(b"\0")[0]


def _avif_samples(data: bytes, t: dict) -> list[tuple[int, int]]:
    """(offset, size) of each sample of a sample table, as libavif's
    avifCodecDecodeInputFillFromSampleTable lists them; a chunk of no
    samples, more samples than libavif's image count limit, a sample past
    the end of the file or of no bytes fail."""
    counts = []
    for chunk in range(len(t["chunks"])):
        runs = [n for first, n in t["stsc"] if first <= chunk + 1]
        counts.append(runs[-1] if runs else 0)
        if not counts[-1]:
            raise _Corrupt("AVIF chunk of no samples")
    if sum(counts) > _AVIF_IMAGE_COUNT_LIMIT:
        raise _Corrupt("AVIF of more samples than libavif takes")
    samples = []
    for offset, count in zip(t["chunks"], counts):
        for _ in range(count):
            size = t["size"]
            if not size:
                if len(samples) >= len(t["sizes"]):
                    raise _Corrupt("AVIF sample table cut short")
                size = t["sizes"][len(samples)]
            if not size or offset + size > len(data):
                raise _Corrupt("AVIF sample empty or past the end")
            samples.append((offset, size))
            offset += size
    return samples


def _avif_track_source(data: bytes, tracks: list) -> dict:
    """The colour track (the first with an id, chunks and an av01 sample
    entry that is no other's auxiliary; its handler is not looked at) and
    the track that is its alpha, as libavif's avifDecoderReset takes them
    for the track source; the first sample of each is decoded."""

    def av1(track):  # where the first av01 sample entry's properties lie
        t = track["stbl"]
        if t is None or not track["id"] or not t["chunks"]:
            return None
        return next(((start, end) for fmt, start, end in t["descriptions"]
                     if fmt == b"av01"), None)

    color = next((tr for tr in tracks if av1(tr) is not None
                  and not tr["aux_for"]), None)
    if color is None:
        raise _Corrupt("AVIF without an AV1 colour track")
    props = _avif_children(data, *av1(color))
    if b"av1C" not in props:
        raise _Corrupt("AVIF colour track without av1C")
    # the auxiliary track of the colour track whose auxi, where it has
    # one, names alpha
    alpha = next((tr for tr in tracks if av1(tr) is not None
                  and tr["aux_for"] == color["id"]
                  and _avif_aux_type(data, _avif_children(data, *av1(tr)),
                                     b"auxi")
                  in (None,) + _AVIF_ALPHA_URNS), None)
    samples = _avif_samples(data, color["stbl"])
    first = samples[0]
    nclx = _avif_nclx(data, [(b, e) for k, b, e in _avif_boxes(
        data, *av1(color)) if k == b"colr"])
    out = {"cells": [data[first[0]:first[0] + first[1]]], "grid": None,
           "layering": [(0, -1)],
           "config_mono": _avif_check_config(data, props), "alpha": None,
           "nclx": nclx, "ispe": color["size"], "source": "track",
           "premultiplied": alpha is not None
           and color["prem_by"] == alpha["id"],
           "frames": len(samples),
           "signature_reads": [] if nclx else [([first], 64)]}
    if alpha is not None:
        first = _avif_samples(data, alpha["stbl"])[0]
        out["alpha"] = {"cells": [data[first[0]:first[0] + first[1]]],
                        "grid": None, "layering": [(0, -1)],
                        "ispe": alpha["size"]}
    return out


def _avif_container(data: bytes) -> dict:
    """The image an AVIF file holds, as libavif 1.4's avifDecoderParse and
    avifDecoderReset find it for cv2: the source libavif's
    AVIF_DECODER_SOURCE_AUTO picks (the moov's track where the major brand
    is avis, or where it is not avif and a moov was read; else meta's
    primary item) -> {"cells": the colour AV1 payloads (one, or a grid's
    cells), "layering" (each cell's operating point and layer), "grid":
    (rows, columns, output width, output height) or None, a grid's
    "cell_ispes", "config_mono" (_AvifMeta.image), "alpha": the alpha
    image (its "cells", "layering", "grid", a grid's "cell_ispes" and
    "ispe") or
    None, "premultiplied": whether the colour is premultiplied by that
    alpha (prem), "nclx": the colour image's colr nclx (_avif_nclx),
    "ispe": the image's size (a track's tkhd size), "source": "item" or
    "track", "frames": the track's samples (1 for an item)}. Raises
    _Corrupt where libavif fails and NotImplementedError for what is
    refused by name (superres, a frame libavif scales, premultiplied
    alpha it would convert through libyuv)."""
    top, major, boxes = _avif_top(data)
    meta = _AvifMeta(data, *top[b"meta"]) if b"meta" in top else None
    tracks = _avif_tracks(data, *top[b"moov"]) if b"moov" in top else []
    if major == b"avis" or (major != b"avif" and tracks):
        c = _avif_track_source(data, tracks)
    elif meta is None:
        raise _Corrupt("AVIF without meta")
    else:
        c = _avif_item_source(data, meta)
    if not _avif_signature_cut(boxes):
        _avif_signature_reads(c.pop("signature_reads"))
    return c


def _avif_check_config(data: bytes, props: dict) -> bool:
    """libavif's checks of an item's av1C (marker and version 1) and pixi
    (version 0, 1 to 4 planes, each of av1C's depth) -> av1C's
    monochrome flag."""
    body, end = props[b"av1C"]
    if end - body < 4 or data[body] != 0x81:
        raise _Corrupt("AVIF av1C without its marker and version 1")
    mono = bool(data[body + 2] & 0x10)
    depth = 12 if data[body + 2] & 0x20 else 10 if data[body + 2] & 0x40 else 8
    if b"pixi" in props:
        r = _AvifReader(data, *props[b"pixi"])
        if r.full_box()[0] != 0:
            raise _Corrupt("AVIF pixi of version 1 or more")
        planes = r.uint(1)
        if not 1 <= planes <= 4 or any(r.uint(1) != depth
                                        for _ in range(planes)):
            raise _Corrupt("AVIF pixi depth other than av1C's")
    return mono


def _avif_image_infos(image: dict, alpha: bool = False,
                      previous: np.ndarray | None = None
                      ) -> list[np.ndarray]:
    """Each cell's AV1 headers (_av1_frame_info), and the checks libavif
    makes of a grid's cells once each is decoded and scaled to its ispe
    (avifDecoderDataFillImageGrid): one size and depth, and for colour one
    format, range and CICP; cells that cover the output size, with the
    last row and column reaching into it; cells of at least 64x64, and
    even output and cell sizes where the chroma is subsampled across them.
    A cell without ispe fails (libavif scales it to 0x0); a colour cell
    whose ispe differs from its frame is refused by name (libavif scales
    the frame to it), an alpha cell is scaled and dropped. Where one libaom
    decoder reads every cell (``previous``: the last colour cell's
    headers), an alpha cell that holds no frame takes the frame decoded
    before it, as libavif's aom codec reuses it (its headers stand in the
    list, its index in ``image["reused"]``; _avif_check_alpha does not
    decode it)."""
    infos, image["reused"] = [], set()
    layering = image["layering"]
    for k, cell in enumerate(image["cells"]):
        rc, info = native.av1_info(cell, *layering[k])
        if rc == _AV1_NO_FRAME and alpha and previous is not None:
            info = previous
            image["reused"].add(k)
        else:
            info = _av1_frame_info(cell, rc, info)
        infos.append(info)
        previous = info
    if image["grid"] is None:
        return infos
    sizes = image["cell_ispes"]
    first = infos[0]
    same = slice(2, 3) if alpha else slice(2, 10)
    if None in sizes or any(s != sizes[0] or (i[same] != first[same]).any()
                            for i, s in zip(infos, sizes)):
        raise _Corrupt("AVIF grid cells without ispe or that do not match")
    rows, cols, width, height = image["grid"]
    cw, ch = sizes[0]
    if (cw * cols < width or ch * rows < height or cw * (cols - 1) >= width
            or ch * (rows - 1) >= height):
        raise _Corrupt("AVIF grid cells that do not cover its output")
    sx, sy = (0, 0) if alpha or first[3] else (first[4], first[5])
    if (cw < 64 or ch < 64 or (sx and (width % 2 or cw % 2))
            or (sy and (height % 2 or ch % 2))):
        raise _Corrupt("AVIF grid cells under 64 samples, or odd where "
                       "the chroma is subsampled")
    if not alpha and any(s != (int(i[0]), int(i[1]))
                         for i, s in zip(infos, sizes)):
        raise NotImplementedError(
            "AVIF whose ispe property differs from its AV1 frame's size "
            "(libavif scales the frame to it) is not supported")
    return infos


def _avif_planes(image: dict, infos: list, previous: list | None = None,
                 count: int = 3) -> tuple[list[np.ndarray], list]:
    """An image's decoded planes (native.av1_decode; film grain is each
    cell's, as libaom adds it frame by frame): its one frame, or a grid's
    cells stitched at the stream's depth and cut to the output size, as
    avifDecoderDataFillImageGrid copies them; the first ``count`` planes
    (alpha: 1). A cell libaom fails on fails the read; an alpha cell of no
    frame takes the planes decoded before it (``previous``: the last
    colour cell's; _avif_image_infos). -> (planes, the last cell's
    planes)."""
    decoded = []
    layering = image["layering"]
    for k, (cell, info) in enumerate(zip(image["cells"], infos)):
        if k in image["reused"]:
            decoded.append(previous)
            continue
        rc, previous = native.av1_decode(cell, info, *layering[k])
        if rc:
            raise _Corrupt("AV1 frame libaom does not decode")
        decoded.append(previous)
    if image["grid"] is None:
        return decoded[0][:count], previous
    rows, cols, width, height = image["grid"]
    sx, sy = int(infos[0][4]), int(infos[0][5])
    out = []
    for p in range(min(count, len(decoded[0]))):
        whole = np.block([[decoded[r * cols + c][p] for c in range(cols)]
                          for r in range(rows)])
        shift_x, shift_y = (sx, sy) if p else (0, 0)
        out.append(whole[:(height + shift_y) >> shift_y,
                         :(width + shift_x) >> shift_x])
    return out, previous


def _avif_check_alpha(image: dict) -> None:
    """Decode each alpha cell, but those of no frame (_avif_image_infos):
    a cell libaom fails on fails the read; the planes are dropped."""
    layering = image["layering"]
    for k, cell in enumerate(image["cells"]):
        if k not in image["reused"] and native.av1_check(cell, *layering[k]):
            raise _Corrupt("AVIF alpha plane libaom does not decode")


def _avif_unpremultiply(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """libavif's avifRGBImageUnpremultiplyAlpha of 8-bit BGRA, which is
    libyuv's ARGBUnattenuate (its AVX2 rows): each channel times 257 times
    the 16-bit reciprocal 65536 // a (65535 at a = 1, 256 at 255, 0 at 0),
    the high 16 bits packed to 8 with signed saturation (so 32768 and more
    give 0)."""
    a = alpha.astype(np.int64)[:, :, None]
    inverse = np.where(a == 1, 0xFFFF, np.where(
        a == 255, 0x100, 0x10000 // np.maximum(a, 1)))
    inverse[a == 0] = 0
    v = (rgb.astype(np.int64) * 257 * inverse) >> 16
    return np.where(v >= 32768, 0, np.minimum(v, 255)).astype(np.uint8)


def _av1_frame_info(obus: bytes, rc: int | None = None,
                    info: np.ndarray | None = None) -> np.ndarray:
    """native.av1_info (or its status and info where given), raising as
    read_image does for its status."""
    if rc is None:
        rc, info = native.av1_info(obus)
    if rc in _AV1_VARIANTS:
        raise NotImplementedError(f"{_AV1_VARIANTS[rc]} is not supported")
    if rc:
        raise _Corrupt("AV1 stream libaom does not decode")
    return info


def _avif_nclx(data: bytes, colrs: list) -> tuple[int, int] | None:
    """The colr nclx among the colour image's colr properties (libavif's
    avifReadColorProperties: it gives the CICP and range), or None; two of
    nclx, or two ICC profiles, fail."""
    kinds = [data[body:body + 4] for body, _ in colrs]
    if kinds.count(b"nclx") > 1 or \
            kinds.count(b"rICC") + kinds.count(b"prof") > 1:
        raise _Corrupt("AVIF of two colr nclx or two ICC profiles")
    return next((c for c, k in zip(colrs, kinds) if k == b"nclx"), None)


def _avif_cicp(data: bytes, nclx: tuple[int, int] | None, info: np.ndarray
               ) -> tuple[int, int, bool]:
    """(matrix coefficients, colour primaries, full range): the colr nclx
    property's where the image has one, else the AV1 sequence header's."""
    if nclx is not None:
        cp, _, mc = struct.unpack_from(">HHH", data, nclx[0] + 4)
        return mc, cp, bool(data[nclx[0] + 10] & 0x80)
    return int(info[7]), int(info[8]), bool(info[6])


def _avif_libyuv_kind(mc: int, cp: int, full: bool) -> int | None:
    """libavif's libyuv constants for the matrix (reformat_libyuv.c):
    av1.cpp's kind, or None where libavif converts on its own; a matrix
    libavif does not convert at all (BT.2020 constant luminance, SMPTE
    2085, chroma-derived constant luminance, ICtCp, reserved values) fails
    as avifImageYUVToRGB fails."""
    if mc in (3, 10, 11, 13, 14, 15) or mc > 17:
        raise _Corrupt(f"libavif does not convert matrix coefficients {mc}")
    if mc == 12:  # chroma-derived: by the primaries
        mc = {1: 1, 2: 1, 5: 6, 6: 6, 9: 9}.get(cp, -1)
    if mc == 1:
        return 2 if full else 3
    if mc in (2, 5, 6):
        return 0 if full else 1
    if mc == 9:
        return 4 if full else 5
    return None


# libavif's kr and kb of the matrices it converts itself
# (avifCalcYUVCoefficients)
_AVIF_KR_KB = {4: (0.30, 0.11), 7: (0.212, 0.087)}
# colour primaries (red, green, blue and white x, y) as libavif's
# avifColorPrimariesGetValues gives them (BT.709's for other values)
_AVIF_PRIMARIES = {
    1: (0.64, 0.33, 0.3, 0.6, 0.15, 0.06, 0.3127, 0.329),
    4: (0.67, 0.33, 0.21, 0.71, 0.14, 0.08, 0.310, 0.316),
    5: (0.64, 0.33, 0.29, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    6: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    7: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.310, 0.316),
    9: (0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.3290),
    10: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.3333, 0.3333),
    11: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.314, 0.351),
    12: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3127, 0.3290),
    22: (0.630, 0.340, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.3290),
}


def _avif_kr_kb(mc: int, cp: int) -> tuple[np.float32, np.float32]:
    """kr and kb of a matrix libavif converts itself: its table's, or for
    chroma-derived non-constant luminance (12) from the primaries
    (avifColorPrimariesComputeYCoeffs, ITU-T H.273 eq. 32-37), in float32
    as libavif computes them."""
    if mc != 12:
        kr, kb = _AVIF_KR_KB[mc]
        return np.float32(kr), np.float32(kb)
    one = np.float32(1)
    rx, ry, gx, gy, bx, by, wx, wy = (np.float32(v) for v in
                                      _AVIF_PRIMARIES.get(cp,
                                                          _AVIF_PRIMARIES[1]))
    rz, gz, bz, wz = (one - (rx + ry), one - (gx + gy), one - (bx + by),
                      one - (wx + wy))
    den = wy * (rx * (gy * bz - by * gz) + gx * (by * rz - ry * bz)
                + bx * (ry * gz - gy * rz))
    kr = (ry * (wx * (gy * bz - by * gz) + wy * (bx * gz - gx * bz)
                + wz * (gx * by - bx * gy))) / den
    kb = (by * (wx * (ry * gz - gy * rz) + wy * (gx * rz - rx * gz)
                + wz * (rx * gy - gx * ry))) / den
    return kr, kb


def _avif_bilinear(c: np.ndarray, sx: int, sy: int, h: int, w: int
                   ) -> np.ndarray:
    """A chroma plane upsampled to h x w as libavif's own conversion does
    it (avifImageYUVAnyToRGBAnySlow): 9/16, 3/16, 3/16 and 1/16 of the
    nearest sample and its neighbours across and down toward the pixel
    (none at the first pixel, or at the last where it is odd; at 4:2:2 the
    row's own)."""
    jj, ii = np.arange(h)[:, None], np.arange(w)[None, :]
    cj, ci = jj >> sy, ii >> sx
    if not sx and not sy:
        return c[cj, ci]

    def toward(k, n, sub):
        edge = (k == 0) | ((k == n - 1) & (k % 2 == 1))
        return np.where(edge | (not sub), 0, np.where(k % 2 == 1, 1, -1))

    dj, di = toward(jj, h, sy), toward(ii, w, sx)
    f32 = np.float32
    return (c[cj, ci] * f32(9 / 16) + c[cj, ci + di] * f32(3 / 16)
            + c[cj + dj, ci] * f32(3 / 16) + c[cj + dj, ci + di] * f32(1 / 16))


def _avif_rgb_float(planes: list, depth: int, full: bool, mc: int, cp: int,
                    sx: int, sy: int, alpha: np.ndarray | None = None
                    ) -> np.ndarray:
    """libavif's own YUV -> 8-bit RGB (avifImageYUVAnyToRGBAnySlow), for
    the matrices libyuv does not take: each sample to float through
    libavif's unorm tables at the stream's depth, the chroma upsampled
    bilinearly (_avif_bilinear), then kr/kb's equations (FCC, SMPTE 240,
    chroma-derived by other primaries), YCgCo, or YCgCo-Re (H.273 eq.
    58-61 on the chroma rounded back to integers, half up; RGB of depth -
    2 bits),
    clamped to [0, 1], divided by a premultiplied ``alpha`` (a / its
    largest value; 0 where it is 0, at most 1) and scaled: 0.5 + v * 255,
    truncated. The identity matrix is G = Y, B = U, R = V, each by Y's
    bias and range."""
    f32 = np.float32
    y, u, v = planes
    h, w = y.shape
    top = (1 << depth) - 1
    bias_y, range_y, range_uv = (0, top, top) if full else (
        16 << (depth - 8), 219 << (depth - 8), 224 << (depth - 8))
    table = np.arange(top + 1, dtype=f32)
    luma = ((table - f32(bias_y)) / f32(range_y))[y]
    if mc == 0:
        chroma = (table - f32(bias_y)) / f32(range_y)
    else:
        chroma = (table - f32(1 << (depth - 1))) / f32(range_uv)
    cb, cr = (_avif_bilinear(chroma[p], sx, sy, h, w) for p in (u, v))
    if mc == 16:  # YCgCo-Re: integers, RGB already at 8 bits
        cg, co = (np.floor(x * f32(range_uv) + f32(0.5)).astype(np.int64)
                  for x in (cb, cr))
        t = y.astype(np.int64) - (cg >> 1)
        b = np.clip(t - (co >> 1), 0, 255)
        rgb = [np.clip(b + co, 0, 255), np.clip(t + cg, 0, 255), b]
        rgb = [x.astype(f32) / f32(255) for x in rgb]
    elif mc == 0:
        rgb = [cr, luma, cb]
    elif mc == 8:
        t = luma - cb
        rgb = [t + cr, luma + cb, t - cr]
    else:
        one, two = f32(1), f32(2)
        kr, kb = _avif_kr_kb(mc, cp)
        kg = one - kr - kb
        rgb = [luma + (two * (one - kr)) * cr,
               luma - ((two * ((kr * (one - kr) * cr)
                               + (kb * (one - kb) * cb))) / kg),
               luma + (two * (one - kb)) * cb]
    rgb = [np.clip(x, f32(0), f32(1)) for x in rgb]
    if alpha is not None:
        a = alpha.astype(f32) / f32(top)
        rgb = [np.where(a == 0, f32(0), np.where(
            a < 1, np.minimum(x / np.maximum(a, f32(1e-30)), f32(1)), x))
            for x in rgb]
    return np.stack([(f32(0.5) + x * f32(255)).astype(np.uint8)
                     for x in rgb], axis=2)


def _avif_headers(data: bytes) -> tuple:
    """The container, the AV1 headers of its colour cells (and of its alpha
    cells) and the colour conversion they ask for -> (container, infos,
    alpha infos or None, matrix coefficients, colour primaries, full
    range, libyuv kind or None where libavif converts itself). Raises
    NotImplementedError naming a variant read_image refuses, from the
    headers alone (unsupported() calls it too), and _Corrupt where cv2
    gives None. A colour frame whose av1C says monochrome is read as
    monochrome (libavif takes av1C's format, cv2 then copies the Y plane);
    a monochrome frame with alpha fails, as in cv2 (its CopyToMat takes
    gray with alpha for 4 channels)."""
    c = _avif_container(data)
    infos = _avif_image_infos(c)
    info = infos[0]
    if c["grid"] is None and c["ispe"] != (int(info[0]), int(info[1])):
        what = "ispe property" if c["source"] == "item" else "track size"
        raise NotImplementedError(
            f"AVIF whose {what} differs from its AV1 frame's size "
            "(libavif scales the frame to it) is not supported")
    alpha_infos = None
    if c["alpha"] is not None:
        a = c["alpha"]
        # libavif decodes every cell with one libaom decoder where colour
        # and alpha are both grids of more than one cell
        # (avifTilesCanBeDecodedWithSameCodecInstance)
        shared = len(c["cells"]) > 1 and len(a["cells"]) > 1
        alpha_infos = _avif_image_infos(a, alpha=True,
                                        previous=infos[-1] if shared else None)
        size = a["grid"][2:] if a["grid"] is not None else a["ispe"]
        if size != c["ispe"] or alpha_infos[0][2] != info[2]:
            raise _Corrupt("AVIF alpha of another size or depth")
        if c["config_mono"] or info[3]:
            raise _Corrupt("AVIF monochrome with alpha")
    mc, cp, full = _avif_cicp(data, c["nclx"], info)
    kind = None
    if not _avif_mono(c, info):  # cv2 copies a monochrome Y plane as it is
        kind = _avif_libyuv_kind(mc, cp, full)
        # what avifImageYUVToRGB fails on: the identity matrix with
        # subsampled chroma, YCgCo on limited range, YCgCo-Re but from 10
        # bits of full range (to 8), YCgCo-Ro (it needs 9 bits)
        if ((mc == 0 and info[4]) or (mc == 8 and not full)
                or (mc == 16 and (not full or info[2] != 10)) or mc == 17):
            raise _Corrupt(f"libavif does not convert matrix coefficients "
                           f"{mc} of this range, depth or chroma")
        if (c["premultiplied"] and kind is not None and info[2] == 12
                and info[4] and info[5]):
            raise NotImplementedError(
                "AVIF with premultiplied alpha at 12 bits 4:2:0 is not "
                "supported")
    return c, infos, alpha_infos, mc, cp, full, kind


def _avif_mono(c: dict, info: np.ndarray) -> bool:
    """Whether libavif gives cv2 the frame as monochrome: the AV1 frame is,
    or the item's av1C says so."""
    return bool(info[3]) or c["config_mono"]


def _decode_avif(data: bytes) -> np.ndarray:
    """cv2's AvifDecoder over libavif 1.4.2: the primary item's AV1 frame
    (native/av1.cpp, film grain applied as libaom applies it), its alpha
    item decoded too (a failure there fails the read) and dropped; irot,
    imir and clap are not applied, as cv2 does not apply them; then
    avifImageYUVToRGB into 8-bit RGB as libavif does it: 10 and 12 bits
    shifted down to 8, then libyuv's fixed-point conversion with bilinear
    (4:2:0) or linear (4:2:2) chroma upsampling; the identity matrix as
    G = Y, B = U, R = V, above 8 bits through libavif's float unorm
    (0.5 + v / max * 255, truncated); a monochrome frame is its Y plane on
    all three channels, as cv2 copies it, above 8 bits scaled by
    convertTo (v / 2 ** (depth - 8), rounded half to even)."""
    c, infos, alpha_infos, mc, cp, full, kind = _avif_headers(data)
    width, height = c["ispe"]  # the frame's or grid's size (_avif_headers)
    _check_size(width, height)
    planes, last = _avif_planes(c, infos)
    info = infos[0]
    depth = int(info[2])
    alpha = None
    if alpha_infos is not None and c["premultiplied"]:
        alpha = _avif_planes(c["alpha"], alpha_infos, last, count=1)[0][0]
        if alpha.shape != planes[0].shape:
            raise NotImplementedError(
                "AVIF with premultiplied alpha whose size differs from the "
                "colour's (libavif scales it) is not supported")
    elif alpha_infos is not None:
        _avif_check_alpha(c["alpha"])
    if kind is None and not _avif_mono(c, info) and (
            mc != 0 or depth > 8 or not full):
        # libavif's own float conversion, which divides by alpha itself
        return _avif_rgb_float(planes, depth, full, mc, cp, int(info[4]),
                               int(info[5]), alpha)
    rgb = _avif_rgb(c, planes, info, mc, kind, alpha_infos is not None)
    # libyuv's paths (and the identity's copy): alpha divided out after
    return rgb if alpha is None else _avif_unpremultiply(
        rgb, alpha >> (depth - 8))


def _avif_rgb(c: dict, planes: list, info: np.ndarray, mc: int,
              kind: int | None, with_alpha: bool) -> np.ndarray:
    """The decoded planes to 8-bit RGB as cv2 gets them where libavif
    does not convert in float (_decode_avif): a monochrome frame copied,
    the identity matrix at 8 bits of full range copied, libyuv's
    conversions."""
    depth = int(info[2])
    if _avif_mono(c, info):
        y = planes[0]
        if depth > 8:  # Mat::convertTo with scale 2 ** (8 - depth)
            y = np.minimum(np.rint(y / float(1 << (depth - 8))), 255)
        return np.repeat(y.astype(np.uint8)[:, :, None], 3, axis=2)
    sub = 0 if not info[4] else 1 if info[5] else 2
    if depth > 8:
        if with_alpha and (depth == 10 or sub == 1):
            # with alpha libavif takes libyuv's I010/I210/I410 and
            # I012 (its 4:2:0 by the nearest sample) at the depth
            return native.avif_yuv_to_rgb(*planes, 3 if depth == 12 else sub,
                                          kind, depth)
        # avifImageDownshiftTo8bpc, then libyuv at 8 bits
        planes = [p >> (depth - 8) for p in planes]
    if mc == 0:
        return np.stack([planes[2], planes[0], planes[1]], axis=2)
    return native.avif_yuv_to_rgb(*planes, sub, kind)


_DECODERS = {"PNG": _decode_png, "JPEG": _decode_jpeg, "TIFF": _decode_tiff,
             "JPEG 2000": _decode_jp2, "BMP": _decode_bmp, "PNM": _decode_pnm,
             "PAM": _decode_pam, "WebP": _decode_webp,
             "GIF": _decode_gif, "Sun raster": _decode_sunras,
             "PFM": _decode_pfm, "Radiance HDR": _decode_hdr,
             "AVIF": _decode_avif}
