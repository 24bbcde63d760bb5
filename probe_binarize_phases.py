"""Where the binarize kernel's time goes, phase by phase, on one NVIDIA card.

    python3 probe_binarize_phases.py

Builds a copy of ocr_inference_tpu_torch/csrc/binarize.cu in which thread 0
of every block reads the card's global timer at the start, after staging
the gray tile, after the row pass and at the end, then runs the port's
wrappers on random inputs at the shapes the main path and chip_smoke.py
time: binarize_tiles on (24, 512, 512, 3), binarize_lines on (64, 80, 3000)
and (8, 80, 1024). Prints one JSON line per shape: the kernel's span, the
mean number of blocks resident on an SM, and the mean and 90th percentile
of each phase's time in a block (microseconds). Imports torch, numpy and
the port; nothing of JAX. Exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

STAMPS = ["start", "staged", "rows", "end"]
MAX_BLOCKS = 65536

# (text in the source, text put after it)
PROBES = [
    ("__constant__ float c_taps[kBlock];\n",
     "__device__ unsigned long long g_stamp[%d][5];\n"
     "__device__ __forceinline__ unsigned long long stamp() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n"
     "}\n" % MAX_BLOCKS),
    ("  const size_t plane = (size_t)h * (size_t)w;\n",
     "  const int bid = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * "
     "blockIdx.z);\n"
     "  const unsigned long long t0 = stamp();\n"),
    ("                         align);\n  __syncthreads();\n",
     "  const unsigned long long t1 = stamp();\n"),
    ("    for (int k = 0; k < KV; ++k) vert[(r0 + k) * L::kVertW + v] = "
     "acc[k];\n  }\n  __syncthreads();\n",
     "  const unsigned long long t2 = stamp();\n"),
]
# the block's last statement, before the host-side helpers
END = "  }\n}\n\ntemplate <int TH, int TW, int CH>\ncudaError_t set_smem"
END_PROBE = (
    "  }\n  __syncthreads();\n"
    "  if (tid == 0 && bid < %d) {\n"
    "    unsigned sm;\n"
    "    asm(\"mov.u32 %%0, %%%%smid;\" : \"=r\"(sm));\n"
    "    g_stamp[bid][0] = t0; g_stamp[bid][1] = t1; g_stamp[bid][2] = t2;\n"
    "    g_stamp[bid][3] = stamp(); g_stamp[bid][4] = sm;\n"
    "  }\n}\n\ntemplate <int TH, int TW, int CH>\ncudaError_t set_smem"
    % MAX_BLOCKS)
READERS = (
    'extern "C" {\n'
    "int stamps_read(void* host) {\n"
    "  return (int)cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));\n}\n"
    "int stamps_clear() {\n"
    "  static unsigned long long zero[%d][5];\n"
    "  return (int)cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero));\n}\n"
    % MAX_BLOCKS)


def instrumented(source: str) -> str:
    for anchor, probe in PROBES:
        if source.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        source = source.replace(anchor, anchor + probe)
    for anchor, text in ((END, END_PROBE), ('extern "C" {\n', READERS)):
        if source.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        source = source.replace(anchor, text)
    return source


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_binarize_phases: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from ocr_inference_tpu_torch.ops import kernels

    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "binarize_stamped.cu"
        lib_path = Path(tmp) / "libbinarize_stamped.so"
        src.write_text(instrumented(
            (kernels.CSRC_DIR / "binarize.cu").read_text()))
        proc = subprocess.run(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib_path),
             str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
        lib = ctypes.CDLL(str(lib_path))
        lib.ocr_binarize_init.argtypes = [ctypes.c_void_p]
        lib.ocr_binarize.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.stamps_read.argtypes = [ctypes.c_void_p]
        kernels._LIB = lib  # the wrappers launch the stamped copy
        kernels._READY.clear()

        dev = torch.device("cuda")
        gen = torch.Generator().manual_seed(0)
        cases = {
            "tiles_24x512x512x3": (kernels.binarize_tiles, (24, 512, 512, 3)),
            "lines_64x80x3000": (kernels.binarize_lines, (64, 80, 3000)),
            "lines_8x80x1024": (kernels.binarize_lines, (8, 80, 1024)),
        }
        for name, (fn, shape) in cases.items():
            x = torch.randint(0, 256, shape, dtype=torch.uint8,
                              generator=gen).to(dev)
            for _ in range(3):
                fn(x)
            torch.cuda.synchronize()
            if lib.stamps_clear() != 0:
                raise RuntimeError("stamps_clear failed")
            fn(x)
            torch.cuda.synchronize()
            buf = np.zeros((MAX_BLOCKS, 5), np.uint64)
            if lib.stamps_read(buf.ctypes.data) != 0:
                raise RuntimeError("stamps_read failed")
            blocks = buf[buf[:, 3] > 0].astype(np.int64)
            span = blocks[:, 3].max() - blocks[:, 0].min()
            sms = len(np.unique(blocks[:, 4]))
            resident = (blocks[:, 3] - blocks[:, 0]).sum() / (span * sms)
            phases = {}
            for i, phase in enumerate(["stage", "rows", "columns"]):
                d = (blocks[:, i + 1] - blocks[:, i]) / 1e3
                phases[f"{phase}_us"] = {"mean": float(d.mean()),
                                         "p90": float(np.percentile(d, 90))}
            print(json.dumps({
                "case": name, "shape": list(shape), "blocks": len(blocks),
                "span_us": float(span) / 1e3, "sms": sms,
                "mean_blocks_resident": float(resident), **phases,
                "gpu": subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"], capture_output=True,
                    text=True).stdout.strip(),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
