"""Drive the PyTorch port's page OCR on one NVIDIA card and check it.

    python3 chip_smoke.py

Builds the kernels from the checkout (nvcc for csrc/*.cu, g++ for the
geometry library, started together), then runs four phases and prints one
JSON line for each:

1. build   — seconds of each compiler; registers and spills of each
             kernel as ptxas reports them;
2. kernels — each kernel wrapper against its plain PyTorch version on the
             card: binarize_tiles on (24, 512, 512, 3) random, page-like and
             knife-edge tiles, binarize_lines on the main path's
             (8, 80, 1024), on (64, 80, W) for every width bucket and on
             knife-edge canvases (64, 80, 3000); per case mismatching
             pixels (must be 0), pixels the exact tier rechecked (must be
             > 0 on the knife-edge inputs), the kernel's device time (a
             CUDA graph of calls) and its time per call from Python, the
             plain version's time, the bound and the share of it reached,
             GFLOP/s;
3. f32     — page OCR with the full77f weights in float32, TF32 off, on the
             three fixture pages of tests/data/torch_port, held against the
             JAX package's recorded float32 texts (same line count, CER
             <= 0.5%);
4. bf16    — the main path: build_pipeline(...) at its defaults (bf16) and
             run_ocr on the fixture pages (CER against the ground truth
             <= 2%) and on a 1600x2640 page made as bench.py makes one
             (24 tiles, full-width buckets); pages/s, lines/s, peak memory.
             Kernel launch and recheck counts are zeroed just before this
             phase and read just after it.

Then a ``kernels`` JSON line (per kernel: launches and rechecked pixels in
phase 4, time, plain time, bound, share of the bound), the card's name and
power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failed phase ends the script with a
non-zero code and without that line. Without CUDA it exits non-zero at once.
Imports torch, numpy and the port; nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
FIXTURE = REPO / "tests" / "data" / "torch_port"
WEIGHTS = REPO / "artifacts" / "full77f"
BUCKETS = (512, 1024, 2000, 2500, 3000)

# H100 SXM data-sheet peaks: float32 outside the
# tensor cores and HBM bandwidth, at the full 700 W power limit
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
BINARIZE_FLOP_PER_PX = 2 * 51 * 2  # 51 taps, two passes, mul + add

FAILED: list[str] = []


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def phase(name: str):
    """Decorator: run a phase, print its JSON line, record a failure."""

    def wrap(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs) or {}
                ok = out.pop("_ok", True)
            except Exception as e:  # report, keep going, fail at the end
                out, ok = {"error": f"{type(e).__name__}: {e}"}, False
            out = {"phase": name, "ok": ok,
                   "seconds": round(time.perf_counter() - t0, 3), **out}
            emit(out)
            if not ok:
                FAILED.append(name)
            return out

        return run

    return wrap


def gpu_name_and_limit() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, x, iters: int = 20) -> float:
    """Mean time of one call on the card's clock, CUDA events around
    ``iters`` calls after warm-up; a call whose host side is slower than
    its device work is timed at the host's pace."""
    for _ in range(3):
        fn(x)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, x, iters: int = 50) -> float:
    """Mean device time of one kernel call: ``iters`` calls captured in a
    CUDA graph and replayed between CUDA events, so the wrapper's host
    time does not count."""
    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn(x)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_report(text: str) -> dict:
    """nvcc -Xptxas -v output -> {kernel: "N registers, ... spill ..."}."""
    out, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("spill" in line or "registers" in line):
            out[name] = (out.get(name, "") + " " + line.split(":", 1)[-1]
                         .strip()).strip()
    return out


def binarize_flops(shape) -> int:
    """Operations of the binarize function on this input: 204 a pixel."""
    return int(np.prod(shape[:3])) * BINARIZE_FLOP_PER_PX


def binarize_bound_ms(shape, channels: int) -> tuple[float, str]:
    """Least time for the binarize function on this input: each input byte
    read once and the mask written once over HBM bandwidth, against
    204 flop/pixel at the float32 peak; the larger one bounds it."""
    pixels = int(np.prod(shape[:3]))
    t_bytes = pixels * (channels + 1) / PEAK_HBM_BYTES
    t_ops = binarize_flops(shape) / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bench_page(seed: int = 42) -> np.ndarray:
    """One 1600x2640 page made as bench.py:44-78 makes its volume pages:
    noisy paper, 6-10 dark bands of ink blocks with a small shear, specks."""
    page_h, page_w, n_lines_mean = 1600, 2640, 8
    rng = np.random.default_rng(seed)
    img = np.full((page_h, page_w, 3), 235, np.uint8)
    noise = rng.integers(-12, 12, size=img.shape)
    img = np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)
    n_lines = max(1, n_lines_mean + int(rng.integers(-2, 3)))
    shear = float(rng.uniform(-0.009, 0.009))
    step = page_h // (n_lines + 1)
    for i in range(n_lines):
        h = int(rng.integers(28, min(45, step - 12)))
        x0 = int(rng.integers(80, 240))
        x1 = page_w - int(rng.integers(80, 240))
        y_line = step * (i + 1) + int(rng.integers(-6, 7))
        x = x0
        while x < x1:
            w = min(int(rng.integers(120, 400)), x1 - x)
            y0 = y_line + int(shear * x)
            img[y0: y0 + h, x: x + w] = rng.integers(20, 70, size=(h, w, 3))
            x += w + int(rng.integers(6, 16))
    for _ in range(int(rng.integers(40, 120))):
        sy = int(rng.integers(0, page_h - 3))
        sx = int(rng.integers(0, page_w - 3))
        img[sy: sy + 3, sx: sx + 3] = int(rng.integers(10, 60))
    return img


def full77f_pipeline(dtype: torch.dtype):
    from ocr_inference_tpu_torch.core.data import (
        CharsetEncoder, LineDetectionConfig, OCRModelConfig,
    )
    from ocr_inference_tpu_torch.pipeline import build_pipeline

    meta = json.loads((WEIGHTS / "recognizer.msgpack.json").read_text())
    ocr = OCRModelConfig(
        model_file=str(WEIGHTS / "recognizer.onnx"), architecture="Easter2",
        input_width=3000, input_height=80, input_layer="input",
        output_layer="output", squeeze_channel=True, swap_hw=False,
        encoder=CharsetEncoder.WYLIE, charset=list(meta["charset"]),
        add_blank=True, version="full77f",
    )
    line = LineDetectionConfig(
        checkpoint="", onnx_file=str(WEIGHTS / "lines.onnx"),
        architecture="unet", patch_size=512, classes=["line"],
    )
    return build_pipeline(ocr, line, dtype=dtype)


def run_page(pipe, img):
    from ocr_inference_tpu_torch.core.data import Encoding, OpStatus

    status, payload = pipe.run_ocr(img, target_encoding=Encoding.WYLIE)
    if status != OpStatus.SUCCESS:
        raise RuntimeError(f"run_ocr FAILED: {payload}")
    _, lines, ocr_lines, angle = payload
    return [ln.text for ln in ocr_lines], lines, angle


@phase("build")
def build():
    from ocr_inference_tpu_torch import native
    from ocr_inference_tpu_torch.ops import kernels

    errors: list[BaseException] = []

    def guarded(fn):
        try:
            fn()
        except BaseException as e:  # re-raised below in the main thread
            errors.append(e)

    threads = [threading.Thread(target=guarded, args=(f,))
               for f in (kernels.build_library, native.build_library)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return {"nvcc_s": kernels.BUILD_SECONDS, "gxx_s": native.BUILD_SECONDS,
            "ptxas": ptxas_report(kernels.BUILD_REPORT)}


@phase("kernels")
def check_kernels(results: dict):
    from ocr_inference_tpu_torch.ops import kernels
    from ocr_inference_tpu_torch.ops.tiling import plan_page, preprocess_page, tile_page

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    page = torch.from_numpy(bench_page(7)).to(dev)
    page_tiles = tile_page(preprocess_page(page, plan_page(1600, 2640)))
    knife_tiles = np.repeat(kernels.knife_edge_gray(24, 512, 512)[..., None],
                            3, axis=-1)
    tiles = (kernels.binarize_tiles, kernels.binarize_tiles_plain, 3)
    lines = (kernels.binarize_lines, kernels.binarize_lines_plain, 1)
    cases = {
        "tiles_random": (*tiles, torch.randint(
            0, 256, (24, 512, 512, 3), dtype=torch.uint8, generator=gen)),
        "tiles_page": (*tiles, page_tiles.contiguous()),
        "tiles_knife_edge": (*tiles, torch.from_numpy(knife_tiles)),
        "lines_main_path_8x1024": (*lines, torch.randint(
            0, 256, (8, 80, 1024), dtype=torch.uint8, generator=gen)),
    }
    for w in BUCKETS:
        cases[f"lines_{w}"] = (*lines, torch.randint(
            0, 256, (64, 80, w), dtype=torch.uint8, generator=gen))
    cases["lines_knife_edge_3000"] = (
        *lines, torch.from_numpy(kernels.knife_edge_gray(64, 80, 3000)))
    out = {}
    ok = True
    for name, (fn, plain, channels, x) in cases.items():
        x = x.to(dev)
        kernels.reset_rechecked()
        got = fn(x)
        rechecked = sum(kernels.rechecked().values())
        want = plain(x)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        ok &= bad == 0 and ("knife" not in name or rechecked > 0)
        ms = kernel_ms(fn, x)
        bound_ms, bound_by = binarize_bound_ms(x.shape, channels)
        out[name] = {
            "shape": list(x.shape), "mismatches": bad,
            "max_abs_err": int((got.int() - want.int()).abs().max()),
            "rechecked": rechecked, "kernel_ms": ms,
            "call_ms": cuda_ms(fn, x),
            "plain_ms": cuda_ms(plain, x, iters=3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms,
            "gflops": binarize_flops(x.shape) / ms / 1e6,
        }
    results.update(out)
    return {"_ok": ok, "cases": out, "gpu": gpu_name_and_limit()}


def fixture():
    from ocr_inference_tpu_torch.eval.synthetic import fixture_pages

    record = json.loads((FIXTURE / "texts.json").read_text(encoding="utf-8"))
    pages = fixture_pages(FIXTURE / "pages.npz")
    return pages, {p["name"]: p for p in record["pages"]}


@phase("page_ocr_f32")
def page_ocr_f32():
    from ocr_inference_tpu_torch.eval.cer import cer

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        pipe = full77f_pipeline(torch.float32)
        pages, ref = fixture()
        per_page, ok = {}, True
        for name, img, _ in pages:
            texts, lines, angle = run_page(pipe, img)
            want = ref[name]["jax_f32_texts"]
            page_cer = cer([" ".join(texts)], [" ".join(want)])
            same_count = len(texts) == len(want)
            ok &= same_count and page_cer <= 0.005
            per_page[name] = {
                "lines": len(texts), "jax_lines": len(want),
                "cer_vs_jax_f32": page_cer,
                "texts_identical": texts == want,
                "boxes_identical": [list(ln.bbox.as_tuple()) for ln in lines]
                == ref[name]["jax_f32_boxes"],
                "angle": angle,
            }
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    return {"_ok": ok, "pages": per_page}


@phase("page_ocr_bf16")
def page_ocr_bf16(results: dict):
    from ocr_inference_tpu_torch.eval.cer import cer
    from ocr_inference_tpu_torch.ops import kernels

    pipe = full77f_pipeline(torch.bfloat16)
    pages, _ = fixture()
    big = bench_page(42)
    shapes: dict[str, set] = {"binarize_tiles": set(), "binarize_lines": set()}
    wrapped = {}
    for name in shapes:  # record the shapes the main path gives each kernel
        fn = getattr(kernels, name)
        wrapped[name] = fn

        def recorder(x, _fn=fn, _name=name):
            shapes[_name].add(tuple(x.shape))
            return _fn(x)

        setattr(kernels, name, recorder)
    try:
        run_page(pipe, big)  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        kernels.reset_rechecked()
        preds, refs = [], []
        for name, img, gt in pages:
            texts, _, _ = run_page(pipe, img)
            preds.append(" ".join(texts))
            refs.append(" ".join(gt))
        n_big = 5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lines = 0
        for _ in range(n_big):
            texts, _, _ = run_page(pipe, big)
            lines += len(texts)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        rechecked = kernels.rechecked()
        stages = stage_ms(pipe, big)
    finally:
        for name, fn in wrapped.items():
            setattr(kernels, name, fn)
    n_pages = len(pages) + n_big
    fixture_cer = cer(preds, refs)
    results["launches"] = launches
    results["rechecked"] = rechecked
    results["n_pages"] = n_pages
    results["shapes"] = {k: sorted(v) for k, v in shapes.items()}
    ok = fixture_cer <= 0.02 and all(v > 0 for v in launches.values())
    return {
        "_ok": ok,
        "fixture_cer_vs_ground_truth": fixture_cer,
        "bench_page": {"shape": list(big.shape), "lines": lines // n_big,
                       "pages_per_s": n_big / dt, "lines_per_s": lines / dt,
                       "repeats": n_big, "stage_ms": stages},
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "rechecked": rechecked, "pages_run": n_pages,
        "kernel_shapes": results["shapes"],
        "gpu": gpu_name_and_limit(),
    }


def stage_ms(pipe, img) -> dict:
    """Host-clock time of each run_ocr stage on one page, the card
    synchronized at every stage boundary."""
    times = {}

    def timed(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        status, out = fn(*args)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        if status.name != "SUCCESS":
            raise RuntimeError(f"{name}: {out}")
        return out

    mask = timed("detect_lines", pipe.detect_lines, img)
    rot_img, rot_mask, contours, angle = timed(
        "build_lines", pipe.build_lines, img, mask)
    lines, strips = timed("extract_lines", pipe.extract_lines, rot_img,
                          rot_mask, contours)
    timed("recognize", pipe.run_text_recognition, strips, lines)
    times["page_angle"] = angle
    return times


def kernels_line(results: dict) -> dict:
    """The per-kernel summary: launches and rechecked pixels from the main
    path (phase 4); time, plain time and bound at the main path's largest
    shape for the kernel."""
    from ocr_inference_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    entries = []
    specs = [
        ("binarize_tiles", kernels.binarize_tiles,
         kernels.binarize_tiles_plain, 3,
         "ocr_inference_tpu/ops/pallas_kernels.py:81"),
        ("binarize_lines", kernels.binarize_lines,
         kernels.binarize_lines_plain, 1,
         "ocr_inference_tpu/ops/pallas_kernels.py:102"),
    ]
    for name, fn, plain, channels, replaces in specs:
        shape = max(results["shapes"][name], key=lambda s: int(np.prod(s)))
        x = torch.randint(0, 256, shape, dtype=torch.uint8,
                          generator=gen).to(dev)
        got, want = fn(x), plain(x)
        torch.cuda.synchronize()
        bound_ms, bound_by = binarize_bound_ms(shape, channels)
        ms = kernel_ms(fn, x)
        entries.append({
            "name": name, "route": "cuda",
            "source": "ocr_inference_tpu_torch/csrc/binarize.cu",
            "replaces": replaces,
            "launches": results["launches"][name],
            "max_abs_err": int((got.int() - want.int()).abs().max()),
            "ms": ms, "plain_ms": cuda_ms(plain, x, iters=3),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": list(shape), "bound_share": bound_ms / ms,
            "call_ms": cuda_ms(fn, x),
            "rechecked": results["rechecked"][name],
        })
    return {"kernels": entries}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (REPO / "ocr_inference_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    results: dict = {}
    build()
    if FAILED:
        return 1
    check_kernels(results)
    page_ocr_f32()
    page_ocr_bf16(results)
    if FAILED:
        print(f"chip_smoke: failed phases {FAILED}", file=sys.stderr)
        return 1
    summary = kernels_line(results)
    if any(k["launches"] == 0 or k["max_abs_err"] != 0
           for k in summary["kernels"]):
        emit(summary)
        print("chip_smoke: a kernel did not run or disagreed", file=sys.stderr)
        return 1
    emit(summary)
    print(gpu_name_and_limit(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
