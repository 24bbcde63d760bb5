"""Native (C++) libraries, counterpart of ocr_inference_tpu/native: the
geometry library, the ARPA LM scorer, and the image decoders' pixel loops
(the PNG unfilter, JPEG, the TIFF codecs).

``geometry.cpp`` is the port's own copy of the JAX package's library plus
``ocr_fill_contour`` (the filled-contour rasterizer that replaces
cv2.drawContours); ``arpa_lm.cpp`` is a copy of the JAX package's scorer;
``png.cpp`` undoes PNG's scanline filters, ``jpeg.cpp`` decodes JPEG and
``tiff.cpp`` holds the TIFF LZW, PackBits and CCITT decoders, for the
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
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

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
    digest = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode())
    so_path = BUILD_DIR / f"libocr_{src.stem}-{digest.hexdigest()[:16]}.so"
    if so_path.is_file():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        ["g++", *GXX_FLAGS, str(src), "-o", tmp], capture_output=True,
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
    (H, W, 1) gray) or (status, None) as ``jpeg_header`` gives it, status
    6 meaning a progressive file whose blocks libjpeg would smooth. ctypes
    releases the GIL for the call."""
    rc, (w, h, nc) = jpeg_header(data)
    if rc:
        return rc, None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((h, w, 1 if nc == 1 else 3), np.uint8)
    rc = _jpeg_lib().ocr_jpeg_decode(buf.ctypes.data_as(_U8P), buf.size,
                                     out.ctypes.data_as(_U8P), out.size)
    return (rc, None) if rc else (0, out)


def _tiff_lib() -> ctypes.CDLL:
    global _TIFF_LIB
    if _TIFF_LIB is None:
        coder = (ctypes.c_int64, [_U8P, ctypes.c_int64, _U8P, ctypes.c_int64])
        _TIFF_LIB = _load("tiff.cpp", {
            "ocr_tiff_lzw": coder,
            "ocr_tiff_packbits": coder,
            "ocr_tiff_fax": (ctypes.c_int64, [
                _U8P, ctypes.c_int64, _U8P, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int]),
        })
    return _TIFF_LIB


def tiff_unpack(method: str, data: bytes, size: int) -> np.ndarray:
    """Decompress one TIFF strip or tile with tiff.cpp: ``method`` "lzw" or
    "packbits", ``size`` the bytes expected. Returns the bytes decoded (at
    most ``size``); bad LZW codes raise ValueError."""
    fn = getattr(_tiff_lib(), f"ocr_tiff_{method}")
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(size, np.uint8)
    n = fn(src.ctypes.data_as(_U8P), src.size, out.ctypes.data_as(_U8P), size)
    if n < 0:
        raise ValueError(f"bad {method} data")
    return out[:n]


def tiff_fax(data: bytes, width: int, rows: int, compression: int,
             g3opts: int, fill_order: int) -> np.ndarray:
    """CCITT-decode one strip or tile (compression 2, 3 or 4) into
    (rows, (width + 7) // 8) packed bits, 1 = black; data that ends early
    or holds a bad code raises ValueError."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros((rows, (width + 7) // 8), np.uint8)
    n = _tiff_lib().ocr_tiff_fax(src.ctypes.data_as(_U8P), src.size,
                                 out.ctypes.data_as(_U8P), width, rows,
                                 compression, g3opts, fill_order)
    if n != rows:
        raise ValueError(f"CCITT data ends at row {n} of {rows}")
    return out
