"""Wrappers of the hand-written Hopper kernels, with their plain versions.

Counterpart of ocr_inference_tpu/ops/pallas_kernels.py. Both Pallas kernels
there binarize with the adaptive Gaussian 51/13 rule; here one CUDA kernel
(csrc/binarize.cu, entry point ``ocr_binarize``) serves both wrappers:

- ``binarize_tiles``: (N, 512, 512, 3) RGB u8 page tiles -> (N, 512, 512)
  u8 masks, gray conversion fused in (replaces ``_binarize_kernel`` via
  ``binarize_tile_pallas`` / ``binarize_tiles_pallas``);
- ``binarize_lines``: (B, H, W) gray u8 line canvases -> (B, H, W) u8
  masks, any W (replaces ``_line_window_kernel`` via
  ``binarize_lines_pallas``; no window stack, no divisor gate).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (ops/imaging.py ``adaptive_threshold_gaussian``). Each wrapper
counts its launches in ``LAUNCHES``.

The kernel library builds at first use with ``nvcc`` into a plain-C shared
library under ``ocr_inference_tpu_torch/_build/`` (named by the source's
hash, so a stale build is never loaded) and is bound with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from ocr_inference_tpu_torch.ops.imaging import (
    adaptive_threshold_gaussian,
    blur_taps,
    rgb_to_gray,
)

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

# launches of each wrapper's kernel; the CPU path never counts
LAUNCHES = {"binarize_tiles": 0, "binarize_lines": 0}

_LIB: ctypes.CDLL | None = None
BUILD_SECONDS: float | None = None
_TAPS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    global BUILD_SECONDS
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
    return so_path


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.ocr_binarize.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.ocr_binarize.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _taps_on(device: torch.device) -> torch.Tensor:
    key = str(device)
    taps = _TAPS.get(key)
    if taps is None:
        taps = blur_taps(device).contiguous()
        _TAPS[key] = taps
    return taps


def _launch(src: torch.Tensor, channels: int) -> torch.Tensor:
    if src.dtype != torch.uint8:
        raise TypeError(f"binarize kernel takes uint8, got {src.dtype}")
    src = src.contiguous()
    n, h, w = src.shape[0], src.shape[1], src.shape[2]
    out = torch.empty((n, h, w), dtype=torch.uint8, device=src.device)
    taps = _taps_on(src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = _library().ocr_binarize(
            src.data_ptr(), out.data_ptr(), taps.data_ptr(), n, h, w,
            channels, stream,
        )
    if err != 0:
        raise RuntimeError(f"ocr_binarize launch failed: CUDA error {err}")
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
    out = _launch(tiles, 3)
    LAUNCHES["binarize_tiles"] += 1
    return out


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
    out = _launch(gray, 1)
    LAUNCHES["binarize_lines"] += 1
    return out
