"""Native (C++) libraries, counterpart of ocr_inference_tpu/native: the
geometry library, the ARPA LM scorer, and the image decoders' pixel loops
(the PNG unfilter, JPEG, the TIFF codecs).

``geometry.cpp`` is the port's own copy of the JAX package's library plus
``ocr_fill_contour`` (the filled-contour rasterizer that replaces
cv2.drawContours); ``arpa_lm.cpp`` is a copy of the JAX package's scorer;
``png.cpp`` undoes PNG's scanline filters, ``jpeg.cpp`` decodes JPEG and
``tiff.cpp`` holds the TIFF codecs (LZW, Deflate, PackBits, CCITT,
ThunderScan, SGI Log) and the YCbCr and CIE L*a*b* -> RGB conversions, for
the
port's image reader (io/images.py), which replaces cv2.imread.
Each builds with g++ at first use into ``ocr_inference_tpu_torch/_build/``
(named by the source's hash) and loads through ctypes. There is no
fallback: if a build fails, this raises."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
# per source: tiff.cpp's float conversions (SGI Log, CIE L*a*b*) round as
# libtiff's do only without fused multiply-adds
SOURCE_FLAGS = {"tiff.cpp": ["-ffp-contract=off"]}

_LIB: ctypes.CDLL | None = None
_ARPA_LIB: ctypes.CDLL | None = None
_PNG_LIB: ctypes.CDLL | None = None
_JPEG_LIB: ctypes.CDLL | None = None
_TIFF_LIB: ctypes.CDLL | None = None
BUILD_SECONDS: dict[str, float] = {}

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)


def build_library(source: str = "geometry.cpp") -> Path:
    """Compile ``source`` (a .cpp file of this directory) into
    _build/libocr_<stem>-<hash>.so once per source content and return its
    path; raises if g++ fails. ``BUILD_SECONDS[source]`` records the
    compile time of a build this process made."""
    src = _DIR / source
    flags = GXX_FLAGS + SOURCE_FLAGS.get(source, [])
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    so_path = BUILD_DIR / f"libocr_{src.stem}-{digest.hexdigest()[:16]}.so"
    if so_path.is_file():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        ["g++", *flags, str(src), "-o", tmp], capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {source}:\n{proc.stderr}")
    os.replace(tmp, so_path)
    BUILD_SECONDS[source] = time.perf_counter() - t0
    return so_path


def _load(source: str, sig: dict) -> ctypes.CDLL:
    """Build ``source`` if needed, load it and declare each function's
    ``restype`` and ``argtypes`` from ``sig``. Every failure of the build
    or the load raises RuntimeError: an OSError here (no g++, a build
    directory it cannot write, a library that does not load) is the
    program's, and must not pass for an error of a file the caller named."""
    try:
        lib = ctypes.CDLL(str(build_library(source)))
    except OSError as e:
        raise RuntimeError(f"cannot build or load {source}: {e}") from e
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def native_available() -> bool:
    """True once the geometry library builds and loads (native/__init__.py
    of the JAX package); a failed build raises, as every use does."""
    _lib()
    return True


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    sig = {
        "ocr_find_contours": (ctypes.c_int, [
            _U8P, ctypes.c_int, ctypes.c_int, _I32P, ctypes.c_int64, _I64P,
            ctypes.c_int]),
        "ocr_contour_area": (ctypes.c_double, [_I32P, ctypes.c_int]),
        "ocr_bounding_rect": (None, [_I32P, ctypes.c_int, _I32P]),
        "ocr_convex_hull": (ctypes.c_int, [_I32P, ctypes.c_int, _I32P]),
        "ocr_arc_length": (ctypes.c_double, [_I32P, ctypes.c_int,
                                             ctypes.c_int]),
        "ocr_approx_poly_dp": (ctypes.c_int, [
            _I32P, ctypes.c_int, ctypes.c_double, ctypes.c_int, _I32P]),
        "ocr_min_area_rect": (None, [_I32P, ctypes.c_int, _F64P]),
        "ocr_line_threshold": (ctypes.c_double, [
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int]),
        "ocr_pack_line_bits": (None, [
            _U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _U8P,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U64P,
            _U64P]),
        "ocr_attempt_height": (ctypes.c_int, [
            _U64P, _U64P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]),
        "ocr_masked_crop": (None, [
            _U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _U64P, _U64P,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _U8P, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]),
        "ocr_fill_contour": (None, [
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int64, _I32P,
            ctypes.c_int, ctypes.c_uint8]),
    }
    _LIB = _load("geometry.cpp", sig)
    return _LIB


def _points(contour: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(contour).reshape(-1, 2),
                                dtype=np.int32)


def find_contours(mask: np.ndarray) -> list[np.ndarray]:
    """One outer contour per 8-connected component, top-down scan order,
    points as (N, 1, 2) int32 (cv2 convention)."""
    lib = _lib()
    if mask.dtype != np.uint8:
        mask = (mask != 0).astype(np.uint8)
    mask = np.ascontiguousarray(mask)
    h, w = mask.shape
    max_points = int(4 * h * w + 64)
    max_contours = 65536
    points = np.empty(max_points * 2, np.int32)
    offsets = np.empty(max_contours + 1, np.int64)
    n = lib.ocr_find_contours(
        mask.ctypes.data_as(_U8P), h, w, points.ctypes.data_as(_I32P),
        max_points * 2, offsets.ctypes.data_as(_I64P), max_contours,
    )
    if n < 0:
        raise RuntimeError(f"ocr_find_contours overflow (code {n})")
    return [
        points[2 * offsets[i]: 2 * offsets[i + 1]].reshape(-1, 1, 2).copy()
        for i in range(n)
    ]


def line_threshold(mask: np.ndarray, slice_width: int = 20) -> float:
    """Slice-vote row-grouping threshold (geometry/lines.py
    get_line_threshold; reference line_detection.py:362-421)."""
    if mask.dtype != np.uint8:
        mask = (mask != 0).astype(np.uint8)
    if mask.ndim != 2:
        raise ValueError("line_threshold expects a 2-D mask")
    if mask.strides[1] != 1:
        mask = np.ascontiguousarray(mask)
    h, w = mask.shape
    return float(_lib().ocr_line_threshold(
        mask.ctypes.data_as(_U8P), h, w, mask.strides[0], slice_width
    ))


def contour_area(contour: np.ndarray) -> float:
    pts = _points(contour)
    return float(_lib().ocr_contour_area(pts.ctypes.data_as(_I32P), len(pts)))


def bounding_rect(contour: np.ndarray) -> tuple[int, int, int, int]:
    pts = _points(contour)
    out = np.empty(4, np.int32)
    _lib().ocr_bounding_rect(pts.ctypes.data_as(_I32P), len(pts),
                             out.ctypes.data_as(_I32P))
    return tuple(int(v) for v in out)


def convex_hull(contour: np.ndarray) -> np.ndarray:
    pts = _points(contour)
    out = np.empty((len(pts) + 1) * 2, np.int32)
    n = _lib().ocr_convex_hull(pts.ctypes.data_as(_I32P), len(pts),
                               out.ctypes.data_as(_I32P))
    return out[: 2 * n].reshape(-1, 1, 2).copy()


def min_area_rect(contour: np.ndarray):
    """((cx, cy), (w, h), angle_deg) like cv2 5.x minAreaRect."""
    pts = _points(contour)
    out = np.empty(5, np.float64)
    _lib().ocr_min_area_rect(pts.ctypes.data_as(_I32P), len(pts),
                             out.ctypes.data_as(_F64P))
    return ((float(out[0]), float(out[1])), (float(out[2]), float(out[3])),
            float(out[4]))


def arc_length(contour: np.ndarray, closed: bool = True) -> float:
    pts = _points(contour)
    return float(_lib().ocr_arc_length(pts.ctypes.data_as(_I32P), len(pts),
                                       1 if closed else 0))


def approx_poly_dp(contour: np.ndarray, epsilon: float,
                   closed: bool = True) -> np.ndarray:
    """Douglas-Peucker simplification, cv2.approxPolyDP-shaped (N, 1, 2)."""
    pts = _points(contour)
    out = np.empty(pts.size, np.int32)
    n = _lib().ocr_approx_poly_dp(pts.ctypes.data_as(_I32P), len(pts),
                                  float(epsilon), 1 if closed else 0,
                                  out.ctypes.data_as(_I32P))
    return out[: 2 * n].reshape(-1, 1, 2).copy()


def fill_contour(mask: np.ndarray, contour: np.ndarray, value: int = 255) -> None:
    """In place: cv2.drawContours(mask, [contour], -1, value, -1) on a 2-D
    uint8 mask."""
    if mask.dtype != np.uint8 or mask.ndim != 2 or mask.strides[1] != 1:
        raise ValueError("fill_contour needs a 2-D uint8 row-contiguous mask")
    pts = _points(contour)
    h, w = mask.shape
    _lib().ocr_fill_contour(mask.ctypes.data_as(_U8P), h, w, mask.strides[0],
                            pts.ctypes.data_as(_I32P), len(pts), value)


class PackedLineRoi:
    """Packed-bit state for one line's adaptive-k strip extraction
    (geometry/lines.py _LineRoi; reference line_detection.py:267-327). Bit
    rows are LSB-first u64 words; the accepted attempt's masked crop
    materializes in one fused pass."""

    def __init__(self, roi: np.ndarray, mask: np.ndarray):
        lib = _lib()
        if roi.ndim == 2:
            roi = roi[..., None]
        h, w, c = roi.shape
        if roi.dtype != np.uint8 or (c > 1 and roi.strides[2] != 1) \
                or roi.strides[1] < 0 or roi.strides[0] < 0:
            raise ValueError("PackedLineRoi needs interleaved uint8")
        mask = np.ascontiguousarray(mask)
        self._lib = lib
        self._roi = roi
        self.h, self.w, self.c = h, w, c
        self.nw = (w + 63) // 64
        self.mask_bits = np.zeros(h * self.nw, np.uint64)
        self.nz_bits = np.zeros(c * h * self.nw, np.uint64)
        lib.ocr_pack_line_bits(
            roi.ctypes.data_as(_U8P), roi.strides[0], roi.strides[1], c,
            mask.ctypes.data_as(_U8P), mask.strides[0], h, w, self.nw,
            self.mask_bits.ctypes.data_as(_U64P),
            self.nz_bits.ctypes.data_as(_U64P),
        )

    def attempt_height(self, kw: int, kh: int) -> int:
        return int(self._lib.ocr_attempt_height(
            self.mask_bits.ctypes.data_as(_U64P),
            self.nz_bits.ctypes.data_as(_U64P), self.c, self.h, self.nw, kw,
            kh,
        ))

    def masked_crop(self, kw: int, kh: int) -> np.ndarray:
        out = np.empty(self.h * self.w * self.c, np.uint8)
        oh, ow = ctypes.c_int(0), ctypes.c_int(0)
        self._lib.ocr_masked_crop(
            self._roi.ctypes.data_as(_U8P), self._roi.strides[0],
            self._roi.strides[1], self.c,
            self.mask_bits.ctypes.data_as(_U64P),
            self.nz_bits.ctypes.data_as(_U64P), self.h, self.w, self.nw, kw,
            kh, out.ctypes.data_as(_U8P), ctypes.byref(oh), ctypes.byref(ow),
        )
        h2, w2 = oh.value, ow.value
        if h2 == 0:
            return np.zeros((0, self.w, self.c), np.uint8)
        return out[: h2 * w2 * self.c].reshape(h2, w2, self.c).copy()


# ---------------------------------------------------------------------------
# ARPA LM
# ---------------------------------------------------------------------------

def _arpa_lib() -> ctypes.CDLL:
    global _ARPA_LIB
    if _ARPA_LIB is not None:
        return _ARPA_LIB
    sig = {
        "ocr_arpa_load": (ctypes.c_void_p, [ctypes.c_char_p]),
        "ocr_arpa_free": (None, [ctypes.c_void_p]),
        "ocr_arpa_order": (ctypes.c_int, [ctypes.c_void_p]),
        "ocr_arpa_token_id": (ctypes.c_int32, [ctypes.c_void_p,
                                               ctypes.c_char_p]),
        "ocr_arpa_score": (ctypes.c_double, [
            ctypes.c_void_p, _I32P, ctypes.c_int, ctypes.c_int32]),
    }
    _ARPA_LIB = _load("arpa_lm.cpp", sig)
    return _ARPA_LIB


class NativeArpaLM:
    """The C++ ARPA scorer (ocr_inference_tpu/native/__init__.py:296-362):
    float32 log-prob and backoff tables, Katz backoff, unknown words mapped
    to ``<unk>``; the same interface as decode.arpa_lm.ArpaLM, whose
    float64 tables give scores that differ from these at float32 rounding.
    A missing file raises FileNotFoundError; a failed build or load of
    the library raises RuntimeError."""

    def __init__(self, arpa_path):
        lib = _arpa_lib()
        self._lib = lib
        self._handle = lib.ocr_arpa_load(str(arpa_path).encode())
        if not self._handle:
            raise FileNotFoundError(arpa_path)
        self.order = lib.ocr_arpa_order(self._handle)
        self._id_cache: dict[str, int] = {}

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.ocr_arpa_free(self._handle)
            self._handle = None

    def _tid(self, token: str) -> int:
        tid = self._id_cache.get(token)
        if tid is None:
            tid = self._lib.ocr_arpa_token_id(self._handle, token.encode())
            self._id_cache[token] = tid
        return tid

    def score(self, context: tuple[str, ...], token: str) -> float:
        """log10 P(token | context) with Katz backoff."""
        ids = (ctypes.c_int32 * len(context))(
            *[self._tid(t) for t in context]
        )
        return self._lib.ocr_arpa_score(
            self._handle, ids, len(context), self._tid(token)
        )

    def make_score_fn(self, charset: list[str], add_blank: bool = True):
        """Adapter (prefix_ids, next_id) -> log10 prob for beam_search, with
        the +1 blank shift of the vocab ids when ``add_blank``."""
        tids = [self._tid(c) for c in charset]
        shift = 1 if add_blank else 0

        def fn(prefix_ids: tuple[int, ...], next_id: int) -> float:
            ctx = (ctypes.c_int32 * len(prefix_ids))(
                *[tids[i - shift] for i in prefix_ids]
            )
            return self._lib.ocr_arpa_score(
                self._handle, ctx, len(prefix_ids), tids[next_id - shift]
            )

        return fn


def png_unfilter(data: np.ndarray, h: int, row_bytes: int,
                 bpp: int) -> np.ndarray:
    """Undo PNG's per-scanline filters: ``data`` holds ``h`` rows of one
    filter-type byte and ``row_bytes`` filtered bytes; ``bpp`` is the
    bytes of one complete pixel (at least 1). Returns the (h, row_bytes)
    uint8 raw samples; an unknown filter type raises ValueError."""
    global _PNG_LIB
    if _PNG_LIB is None:
        _PNG_LIB = _load("png.cpp", {"ocr_png_unfilter": (ctypes.c_int64, [
            _U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _U8P])})
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if data.size != h * (row_bytes + 1):
        raise ValueError(f"{data.size} bytes for {h} rows of {row_bytes}")
    out = np.empty((h, row_bytes), np.uint8)
    rc = _PNG_LIB.ocr_png_unfilter(data.ctypes.data_as(_U8P), h, row_bytes,
                                   bpp, out.ctypes.data_as(_U8P))
    if rc < 0:
        raise ValueError(f"unknown PNG filter type on row {-1 - rc}")
    return out


def _jpeg_lib() -> ctypes.CDLL:
    global _JPEG_LIB
    if _JPEG_LIB is None:
        _JPEG_LIB = _load("jpeg.cpp", {
            "ocr_jpeg_header": (ctypes.c_int, [_U8P, ctypes.c_int64, _I32P]),
            "ocr_jpeg_decode": (ctypes.c_int, [
                _U8P, ctypes.c_int64, _U8P, ctypes.c_int64]),
            "ocr_jpeg_tiff_open": (ctypes.c_void_p, [
                _U8P, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]),
            "ocr_jpeg_tiff_close": (None, [ctypes.c_void_p]),
            "ocr_jpeg_tiff": (ctypes.c_int, [
                ctypes.c_void_p, _U8P, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, _I32P, _U8P, ctypes.c_int64]),
        })
    return _JPEG_LIB


def jpeg_header(data: bytes) -> tuple[int, tuple[int, int, int]]:
    """(status, (width, height, components)) of a JPEG file's first frame
    from its headers; status is jpeg.cpp's JPEG_* code (0 ok, 1 a file
    cv2.imread cannot read, 2 and up a variant not decoded here)."""
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(4, np.int32)
    rc = _jpeg_lib().ocr_jpeg_header(buf.ctypes.data_as(_U8P), buf.size,
                                     info.ctypes.data_as(_I32P))
    return rc, (int(info[0]), int(info[1]), int(info[2]))


def jpeg_decode(data: bytes) -> tuple[int, np.ndarray | None]:
    """Decode a JPEG file's bytes with jpeg.cpp: (0, (H, W, 3) uint8 RGB or
    (H, W, 1) gray) or (status, None) as ``jpeg_header`` gives it. ctypes
    releases the GIL for the call."""
    rc, (w, h, nc) = jpeg_header(data)
    if rc:
        return rc, None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((h, w, 1 if nc == 1 else 3), np.uint8)
    rc = _jpeg_lib().ocr_jpeg_decode(buf.ctypes.data_as(_U8P), buf.size,
                                     out.ctypes.data_as(_U8P), out.size)
    return (rc, None) if rc else (0, out)


class JpegTiffTables:
    """The Huffman and quantisation tables of one JPEG-in-TIFF page, as
    libtiff's single decompressor holds them from strip to strip: the
    JPEGTables stream's (``tables``, may be empty), then each strip's own
    definitions. ``status`` is 0, or jpeg.cpp's code for a bogus
    JPEGTables stream. Use it as a context manager, or ``close()`` it."""

    def __init__(self, tables: bytes = b""):
        t = np.frombuffer(tables, np.uint8)
        rc = ctypes.c_int(0)
        self._handle = _jpeg_lib().ocr_jpeg_tiff_open(
            t.ctypes.data_as(_U8P), t.size, ctypes.byref(rc))
        self.status = rc.value

    def close(self) -> None:
        if self._handle:
            _jpeg_lib().ocr_jpeg_tiff_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def header(self, data: bytes, max_height: int = 0, color: int = 0
               ) -> tuple[int, tuple[int, ...]]:
        """(status, (width, height, components, first component's
        horizontal and vertical sampling, 1 when the others sample 1x1))
        of one strip or tile, read for ``decode``'s ``color``; a bogus
        JPEGTables stream's status."""
        if not self._handle:
            return self.status or 1, (0,) * 6
        buf = np.frombuffer(data, np.uint8)
        info = np.zeros(6, np.int32)
        rc = _jpeg_lib().ocr_jpeg_tiff(
            self._handle, buf.ctypes.data_as(_U8P), buf.size, color,
            max_height, info.ctypes.data_as(_I32P), None, 0)
        return rc, tuple(int(v) for v in info)

    def decode(self, data: bytes, color: int, max_height: int = 0
               ) -> tuple[int, np.ndarray | None]:
        """Decode one strip or tile as libtiff has libjpeg decode it: (0,
        (h, w, channels) uint8) or (status, None). ``color`` 1 turns
        YCbCr into RGB; 0 keeps the components as decoded. ``max_height``
        > 0 cuts a taller stream to that many rows."""
        rc, (w, h, nc, *_) = self.header(data, max_height, color)
        if rc:
            return rc, None
        buf = np.frombuffer(data, np.uint8)
        out = np.empty((h, w, 3 if color == 1 else nc), np.uint8)
        info = np.zeros(6, np.int32)
        rc = _jpeg_lib().ocr_jpeg_tiff(
            self._handle, buf.ctypes.data_as(_U8P), buf.size, color,
            max_height, info.ctypes.data_as(_I32P), out.ctypes.data_as(_U8P),
            out.size)
        return (rc, None) if rc else (0, out)


def _tiff_lib() -> ctypes.CDLL:
    global _TIFF_LIB
    if _TIFF_LIB is None:
        coder = (ctypes.c_int64, [_U8P, ctypes.c_int64, _U8P, ctypes.c_int64])
        _TIFF_LIB = _load("tiff.cpp", {
            "ocr_tiff_lzw": (ctypes.c_int64, [
                _U8P, ctypes.c_int64, _U8P, ctypes.c_int64, ctypes.c_int]),
            "ocr_tiff_packbits": coder,
            "ocr_tiff_inflate": (ctypes.c_int64, [
                _U8P, ctypes.c_int64, _U8P, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int)]),
            "ocr_tiff_fax": (ctypes.c_int64, [
                _U8P, ctypes.c_int64, _U8P, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _I32P, ctypes.POINTER(ctypes.c_uint32), _I64P]),
            "ocr_tiff_ycbcr": (None, [_U8P, ctypes.c_int64, _I32P, _U8P]),
            "ocr_tiff_thunder": (ctypes.c_int64, [
                _U8P, ctypes.c_int64, _U8P, ctypes.c_int, ctypes.c_int]),
            "ocr_tiff_sgilog": (ctypes.c_int64, [
                _U8P, ctypes.c_int64, _U8P, ctypes.c_int, ctypes.c_int,
                ctypes.c_int]),
            "ocr_tiff_cielab": (None, [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), _U8P]),
        })
    return _TIFF_LIB


def tiff_unpack(method: str, data: bytes, size: int
                ) -> tuple[np.ndarray, bool]:
    """Decompress one TIFF strip or tile with tiff.cpp as libtiff does:
    ``method`` "lzw", "lzw-old" (pre-TIFF 6 codes), "packbits" or
    "inflate" (Deflate), ``size`` the bytes expected. Returns the ``size``
    bytes libtiff leaves in its buffer (what was decoded before the data
    ended or went bad, zeros after it) and whether libtiff's codec
    succeeds (it undoes a predictor only then)."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(size, np.uint8)
    args = (src.ctypes.data_as(_U8P), src.size, out.ctypes.data_as(_U8P),
            size)
    lib = _tiff_lib()
    if method == "inflate":
        ok = ctypes.c_int(0)
        lib.ocr_tiff_inflate(*args, ctypes.byref(ok))
        return out, bool(ok.value)
    if method in ("lzw", "lzw-old"):
        n = lib.ocr_tiff_lzw(*args, int(method == "lzw-old"))
    else:
        n = lib.ocr_tiff_packbits(*args)
    return out, n == size


def tiff_rows(method: str, data: bytes, width: int, rows: int
              ) -> tuple[np.ndarray, bool]:
    """Decode one strip of a row-at-a-time TIFF codec with tiff.cpp, as
    libtiff decodes it for its RGBA interface: ``method`` "thunder"
    (ThunderScan 4-bit: (rows, (width + 1) // 2) packed pixels), "logl"
    (SGI LogL: (rows, width) gray bytes), "logluv" or "logluv24" (SGI
    LogLuv 32- or 24-bit: (rows, width * 3) RGB bytes). Rows past a fault
    stay zero; the flag says whether every row decoded."""
    src = np.frombuffer(data, np.uint8)
    per = (width + 1) // 2 if method == "thunder" else \
        width if method == "logl" else 3 * width
    out = np.zeros((rows, per), np.uint8)
    args = (src.ctypes.data_as(_U8P), src.size, out.ctypes.data_as(_U8P),
            width, rows)
    lib = _tiff_lib()
    if method == "thunder":
        n = lib.ocr_tiff_thunder(*args)
    else:
        n = lib.ocr_tiff_sgilog(*args, ("logl", "logluv",
                                        "logluv24").index(method))
    return out, n == rows


def tiff_cielab(lab: np.ndarray, white: tuple[float, float, float]
                ) -> np.ndarray:
    """(..., 3) uint8 or uint16 CIE L*a*b* samples (a and b signed) -> RGB
    as libtiff's RGBA interface maps them (tif_color.c, the sRGB display),
    with the reference white's X0, Y0, Z0."""
    lab = np.ascontiguousarray(lab)
    bits = 8 if lab.dtype == np.uint8 else 16
    lab = lab.astype(np.uint8 if bits == 8 else np.uint16, copy=False)
    w = np.asarray(white, np.float32)
    out = np.empty(lab.shape, np.uint8)
    _tiff_lib().ocr_tiff_cielab(lab.ctypes.data, lab.size // 3, bits,
                                w.ctypes.data_as(ctypes.POINTER(
                                    ctypes.c_float)),
                                out.ctypes.data_as(_U8P))
    return out


def tiff_ycbcr(ycc: np.ndarray, tables: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 Y, Cb, Cr -> RGB with tiff.cpp and the (5, 256)
    int32 tables of tif_color.c TIFFYCbCrToRGBInit (Y, Cr->R, Cb->B,
    Cr->G, Cb->G)."""
    ycc = np.ascontiguousarray(ycc, dtype=np.uint8)
    tables = np.ascontiguousarray(tables, dtype=np.int32)
    out = np.empty_like(ycc)
    _tiff_lib().ocr_tiff_ycbcr(ycc.ctypes.data_as(_U8P), ycc.size // 3,
                               tables.ctypes.data_as(_I32P),
                               out.ctypes.data_as(_U8P))
    return out


def tiff_fax(data: bytes, width: int, rows: int, compression: int,
             g3opts: int, fill_order: int, odd: bool = False,
             state: dict | None = None) -> np.ndarray:
    """CCITT-decode one strip or tile (compression 2, 3, 4 or 32771, RLE-W;
    ``odd``: the data starts at an odd file offset, which moves RLE-W's
    16-bit row alignment) into (rows, (width + 7) // 8) packed bits, 1 =
    black, as libtiff decodes it. ``state`` (a dict shared by a page's
    strips and tiles, empty at first) carries what libtiff's codec keeps
    from one to the next: its run arrays and the FAXMODE_NOEOL flag that
    T.4 data ending inside an EOL sets. Damaged or short data does not
    raise: the
    rows before the fault are kept, the rest are what libtiff makes of
    them (zeros past the end), with a warning naming the count. A 2-D row
    that holds an extension code (uncompressed mode, which libtiff does
    not decode) ends there as libtiff ends it, with a warning too."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros((rows, (width + 7) // 8), np.uint8)
    counts = np.zeros(2, np.int64)
    state = {} if state is None else state
    two_d = compression == 4 or (compression == 3 and g3opts & 1)
    nruns = (width + 32) // 32 * 32 * (2 if two_d else 1)
    if state.get("nruns") != nruns:
        state.update(nruns=nruns, noeol=np.zeros(1, np.int32),
                     runs=np.zeros(2 * nruns + 2, np.uint32))
    n = _tiff_lib().ocr_tiff_fax(
        src.ctypes.data_as(_U8P), src.size, out.ctypes.data_as(_U8P), width,
        rows, compression, g3opts, fill_order, int(odd),
        state["noeol"].ctypes.data_as(_I32P),
        state["runs"].ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        counts.ctypes.data_as(_I64P))
    if counts[0]:
        warnings.warn(f"CCITT data holds {counts[0]} uncompressed-mode "
                      "extension code(s), not decoded: each ends its row")
    if n != rows or counts[1]:
        warnings.warn(f"CCITT data damaged or cut short ({counts[1]} "
                      f"warning(s) from libtiff's decoder); {n} of {rows} "
                      "rows read, the rest as libtiff leaves them")
    return out
