"""Runtime helpers: the build cache, devices, stage timers and profiles.

Counterpart of ocr_inference_tpu/utils/runtime.py. The port compiles no
XLA programs: its only compile step is the build of its native libraries
(nvcc for csrc/*.cu in ops/kernels.py, g++ for native/*.cpp), each cached
by its source's hash, so ``enable_compilation_cache`` picks where those
builds go. ``trace_profile`` is torch.profiler in place of
jax.profiler.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch

_CACHE_ENABLED = False


def enable_compilation_cache(cache_dir: str | None = None) -> None:
    """Send the kernel and native library builds to ``cache_dir`` (both
    ``ops/kernels.py`` and ``native/__init__.py`` build into it), so that
    later runs with the same sources load them without compiling; None
    keeps the package's own ``_build/``. Idempotent: the first call
    decides, as the JAX function's does."""
    global _CACHE_ENABLED
    if _CACHE_ENABLED:
        return
    if cache_dir is not None:
        from ocr_inference_tpu_torch import native
        from ocr_inference_tpu_torch.ops import kernels

        build_dir = Path(cache_dir)
        build_dir.mkdir(parents=True, exist_ok=True)
        kernels.BUILD_DIR = build_dir
        native.BUILD_DIR = build_dir
    _CACHE_ENABLED = True


def cpu_devices() -> list[torch.device]:
    """The CPU device list: the port runs one CPU device (the JAX function
    lists the host platform's, possibly virtual, devices)."""
    return [torch.device("cpu")]


@contextlib.contextmanager
def stage_timer(record: dict, key: str):
    """Accumulate wall-clock stage timings into a dict (ms)."""
    start = time.perf_counter()
    try:
        yield
    finally:
        record[key] = record.get(key, 0.0) + (time.perf_counter() - start) * 1000


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """torch.profiler around the block, the CPU's activity and, where a
    card is present, CUDA's (CUPTI); on exit it writes a Chrome trace
    ``<pid>.<ns>.pt.trace.json`` under ``log_dir``. Yields the profiler,
    whose ``key_averages()`` and ``events()`` read the same run."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        str(out / f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))
