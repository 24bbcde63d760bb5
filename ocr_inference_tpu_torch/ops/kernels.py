"""Wrappers of the hand-written Hopper kernels, with their plain versions.

Counterpart of ocr_inference_tpu/ops/pallas_kernels.py. Both Pallas kernels
there binarize with the adaptive Gaussian 51/13 rule; here one CUDA source
(csrc/binarize.cu, entry point ``ocr_binarize``) holds two specialisations
of one kernel:

- ``binarize_tiles``: (N, H, W, 3) RGB u8 page tiles -> (N, H, W) u8
  masks, gray conversion fused in, 64 x 128 outputs a block (replaces
  ``_binarize_kernel`` via ``binarize_tile_pallas`` /
  ``binarize_tiles_pallas``);
- ``binarize_lines``: (B, H, W) gray u8 line canvases -> (B, H, W) u8
  masks, any H and W; a block owns 80 rows (a whole canvas of the
  recognizer's height) and a column strip whose width
  ``line_strip_width`` picks (replaces ``_line_window_kernel`` via
  ``binarize_lines_pallas``; no window stack, no divisor gate).

Both blur in float32 and recheck every pixel within ``RECHECK_EPS`` of its
threshold in the plain version's arithmetic (cv2's own float32 blur,
ops/imaging.py ``blur_cv2``), so they equal it, and cv2, bit for bit;
``binarize_two_tier`` renders that decision in plain PyTorch.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (ops/imaging.py ``adaptive_threshold_gaussian``). Each wrapper
counts its launches in ``LAUNCHES``, and its kernel counts the pixels it
rechecked on the card (``rechecked``).

The kernel library builds at first use with ``nvcc`` into a plain-C shared
library under ``ocr_inference_tpu_torch/_build/`` (named by the source's
hash, so a stale build is never loaded) and is bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ocr_inference_tpu_torch.device import DeviceFault
from ocr_inference_tpu_torch.ops.imaging import (
    BLOCK,
    C,
    HALF,
    adaptive_threshold_gaussian,
    blur_cv2,
    blur_in_order,
    gaussian_kernel_1d,
    rgb_to_gray,
)

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# A float32 blur of 0..255 gray with these taps, in any order, is within
# 1.56e-3 of the exact sum, so the kernels' order and cv2's lie within
# 3.1e-3 of each other (csrc/binarize.cu derives the bound); a pixel whose
# float32 sum lies within this of its threshold is rechecked.
RECHECK_EPS = 2.0 ** -8

# canvas rows a line block owns, and its column strips, widest first
LINE_ROWS = 80
LINE_STRIPS = (128, 64, 32)

# launches of each wrapper's kernel; the CPU path never counts
LAUNCHES = {"binarize_tiles": 0, "binarize_lines": 0}

_LIB: ctypes.CDLL | None = None
BUILD_SECONDS: float | None = None
BUILD_REPORT = ""  # ptxas's registers and spills per kernel
_READY: set = set()       # devices whose constant taps are set
_COUNTERS: dict = {}      # (kernel, device) -> uint64 rechecked counter
_SMS: dict = {}           # device -> SM count
# guards the first-use set-up above and the launch counts: detection and
# recognition launch from different threads in a volume run
_SETUP_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rechecked() -> dict[str, int]:
    """Pixels each kernel has rechecked in float64 since the last
    ``reset_rechecked`` (reading it waits for the card)."""
    out = {k: 0 for k in LAUNCHES}
    for (name, _), counter in _COUNTERS.items():
        out[name] += int(counter.item())
    return out


def reset_rechecked() -> None:
    for counter in _COUNTERS.values():
        counter.zero_()


def line_strip_width(b: int, h: int, w: int, sms: int) -> int:
    """The widest column strip whose grid covers at least one wave of
    ``sms`` blocks; the narrowest where none does."""
    rows = -(-h // LINE_ROWS)
    for strip in LINE_STRIPS:
        if b * rows * -(-w // strip) >= sms:
            return strip
    return LINE_STRIPS[-1]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_library() -> Path:
    """Compile csrc/*.cu into _build/libocr_kernels-<hash>.so (once per
    source content) and return its path. Raises if nvcc fails."""
    global BUILD_SECONDS, BUILD_REPORT
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so_path = BUILD_DIR / f"libocr_kernels-{digest.hexdigest()[:16]}.so"
    if so_path.is_file():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent builders never
    # see a half-written library and there is no lock file to go stale
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    os.replace(tmp, so_path)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_REPORT = proc.stderr
    return so_path


def _library() -> ctypes.CDLL:
    """The built library, loaded and bound (callers hold _SETUP_LOCK)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.ocr_binarize_init.argtypes = [ctypes.c_void_p]
        lib.ocr_binarize_init.restype = ctypes.c_int
        lib.ocr_binarize.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.ocr_binarize.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _ready(device: torch.device) -> ctypes.CDLL:
    """The library, with this device's constant taps, shared-memory limits,
    SM count and recheck counters set up (once per device). The volume
    runner launches from two threads, so the first use is serialised."""
    with _SETUP_LOCK:
        lib = _library()
        if device.index not in _READY:
            taps = np.ascontiguousarray(gaussian_kernel_1d(BLOCK), np.float32)
            err = lib.ocr_binarize_init(taps.ctypes.data)
            if err != 0:
                raise DeviceFault(
                    f"ocr_binarize_init failed: CUDA error {err}")
            _SMS[device.index] = torch.cuda.get_device_properties(
                device).multi_processor_count
            # normal tensors even when the first launch comes from inside
            # an engine's inference_mode: reset_rechecked zeroes them in
            # place from outside it
            with torch.inference_mode(False):
                for name in LAUNCHES:
                    _COUNTERS[(name, device.index)] = torch.zeros(
                        1, dtype=torch.int64, device=device)
            # the counters are zeroed on this thread's stream; the other
            # thread's stream may launch next
            torch.cuda.synchronize(device)
            _READY.add(device.index)
    return lib


def _launch(name: str, src: torch.Tensor, channels: int) -> torch.Tensor:
    if src.dtype != torch.uint8:
        raise TypeError(f"binarize kernel takes uint8, got {src.dtype}")
    src = src.contiguous()
    n, h, w = src.shape[0], src.shape[1], src.shape[2]
    out = torch.empty((n, h, w), dtype=torch.uint8, device=src.device)
    with torch.cuda.device(src.device):
        lib = _ready(src.device)
        counter = _COUNTERS[(name, src.device.index)]
        strip = line_strip_width(n, h, w, _SMS[src.device.index])
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.ocr_binarize(
            src.data_ptr(), out.data_ptr(), counter.data_ptr(), n, h, w,
            channels, strip, RECHECK_EPS, stream,
        )
    if err != 0:
        raise DeviceFault(f"ocr_binarize launch failed: CUDA error {err}")
    with _SETUP_LOCK:
        LAUNCHES[name] += 1
    return out


def binarize_tiles_plain(tiles: torch.Tensor) -> torch.Tensor:
    """Plain version of ``binarize_tiles``: gray, then the 51/13 rule."""
    return adaptive_threshold_gaussian(rgb_to_gray(tiles))


def binarize_tiles(tiles: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 RGB tiles -> (N, H, W) uint8 0/255, each tile
    thresholded with its own replicate border."""
    if tiles.ndim != 4 or tiles.shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) tiles, got {tuple(tiles.shape)}")
    if tiles.device.type == "cpu":
        return binarize_tiles_plain(tiles)
    if tiles.device.type != "cuda":
        raise ValueError(f"unsupported device {tiles.device}")
    return _launch("binarize_tiles", tiles, 3)


def binarize_lines_plain(gray: torch.Tensor) -> torch.Tensor:
    """Plain version of ``binarize_lines``."""
    return adaptive_threshold_gaussian(gray)


def binarize_lines(gray: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 gray canvases -> (B, H, W) uint8 0/255."""
    if gray.ndim != 3:
        raise ValueError(f"expected (B, H, W) canvases, got {tuple(gray.shape)}")
    if gray.device.type == "cpu":
        return binarize_lines_plain(gray)
    if gray.device.type != "cuda":
        raise ValueError(f"unsupported device {gray.device}")
    return _launch("binarize_lines", gray, 1)


# ---------------------------------------------------------------------------
# The kernels' decision in plain PyTorch, and inputs that reach its exact
# tier; used by the tests and chip_smoke.py
# ---------------------------------------------------------------------------

def binarize_two_tier(gray: torch.Tensor) -> tuple[torch.Tensor, int, float]:
    """(..., H, W) uint8 gray -> (mask, rechecked pixels, max |acc32 -
    acc_cv2|): the kernels' two tiers. ``g > clip(rint(acc)) - 13`` holds
    for every g >= 243, and otherwise depends on acc against g + 12.5
    alone; a float32 blur in the kernels' order decides every pixel whose
    sum lies more than ``RECHECK_EPS`` from it, and the rest take the plain
    version's rule on cv2's float32 blur."""
    shape = gray.shape
    g = gray.reshape(-1, shape[-2], shape[-1])
    acc32 = blur_in_order(g, torch.float32)
    acc_cv2 = blur_cv2(g)
    gf = g.to(torch.float32)
    thr = gf + (C - 0.5)
    white = (gf >= 256 - C) | (acc32 < thr - RECHECK_EPS)
    need = ~white & (acc32 <= thr + RECHECK_EPS)
    exact = gf > torch.round(acc_cv2).clamp(0.0, 255.0) - C
    out = torch.where(need, exact, white)
    err = float((acc32 - acc_cv2).abs().max())
    return (torch.where(out, 255, 0).to(torch.uint8).reshape(shape),
            int(need.sum()), err)


def _centre_acc(win: np.ndarray, taps: np.ndarray) -> float:
    """The plain version's float64 sum at the centre of a (51, 51) window."""
    vert = win[0] * taps[0]
    for t in range(1, BLOCK):
        vert = vert + win[t] * taps[t]
    acc = vert[0] * taps[0]
    for j in range(1, BLOCK):
        acc = acc + vert[j] * taps[j]
    return float(acc)


@functools.lru_cache(maxsize=None)
def knife_edge_windows(n: int, seed: int = 0) -> np.ndarray:
    """(n, 51, 51) uint8 gray windows whose blurred centre lies within
    1e-4 of centre + 12.5 (by the plain version's float64 formula), on
    either side: a flat background 13 above the centre value, the residual
    cancelled greedily by nudging the other pixels, largest weight first."""
    rng = np.random.default_rng(seed)
    taps = gaussian_kernel_1d(BLOCK).astype(np.float64)
    weights = np.outer(taps, taps)
    order = [(int(k) // BLOCK, int(k) % BLOCK, float(weights.flat[k]))
             for k in np.argsort(-weights, axis=None)
             if int(k) != HALF * BLOCK + HALF]
    out = []
    while len(out) < n:
        c = int(rng.integers(30, 200))
        win = np.full((BLOCK, BLOCK), c + 13, np.float64)
        win[HALF, HALF] = c
        target = c + (C - 0.5) + float(rng.choice([-5e-5, 5e-5]))
        for _ in range(3):
            r = target - _centre_acc(win, taps)
            for y, x, wt in order:
                if abs(r) < 1e-6:
                    break
                v = float(win[y, x])
                step = min(max(round(r / wt), -20, -v), 20, 255 - v)
                if step:
                    win[y, x] = v + step
                    r -= step * wt
        if abs(_centre_acc(win, taps) - (c + C - 0.5)) < 1e-4:
            out.append(win.astype(np.uint8))
    out = np.stack(out)
    out.flags.writeable = False
    return out


def knife_edge_gray(b: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """(b, h, w) uint8 gray with knife-edge windows (a pool of 64, in
    turn) tiled 52 px apart, so that their 51-px blur windows are disjoint
    and inside the image; the one column and row between windows is 128."""
    step = BLOCK + 1
    wins = knife_edge_windows(64, seed)
    out = np.full((b, h, w), 128, np.uint8)
    centres = [(y, x) for y in range(HALF + 1, h - HALF, step)
               for x in range(HALF + 1, w - HALF, step)]
    for i, (y, x) in enumerate(centres):
        out[:, y - HALF: y + HALF + 1, x - HALF: x + HALF + 1] = \
            wins[i % len(wins)]
    return out
