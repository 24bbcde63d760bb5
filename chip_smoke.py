"""Drive the PyTorch port's page and volume OCR on one NVIDIA card and
check it.

    python3 chip_smoke.py

Builds the kernels from the checkout (nvcc for csrc/*.cu, g++ for the
geometry library, the ARPA scorer and the PNG unfilter, all started
together), then runs fourteen phases and prints one JSON line for each:

1. build        — seconds of each compiler; registers and spills of each
                  kernel as ptxas reports them;
2. kernels      — each kernel wrapper against its plain PyTorch version on
                  the card: binarize_tiles on (24, 512, 512, 3) random,
                  page-like and knife-edge tiles, binarize_lines on
                  (8, 80, 1024), on (64, 80, W) for every width bucket and
                  on knife-edge canvases (64, 80, 3000); per case
                  mismatching pixels (must be 0), pixels the exact tier
                  rechecked (must be > 0 on the knife-edge inputs), the
                  kernel's device time (a CUDA graph of calls) and its time
                  per call from Python, the plain version's time, the bound
                  and the share of it reached, GFLOP/s;
3. page_ocr_f32 — page OCR with the full77f weights in float32, TF32 off,
                  on the three fixture pages of tests/data/torch_port, held
                  against the JAX package's recorded float32 texts (same
                  line count, CER <= 0.5%);
4. volume_f32   — the same three pages through VolumeRunner
                  (window_pages=2), float32, TF32 off: texts and line boxes
                  equal to the JAX float32 ones;
5. page_ocr_bf16 — build_pipeline(...) at its defaults (bf16) and run_ocr
                  on the fixture pages (CER against the ground truth <= 2%)
                  and on a 1600x2640 page made as bench.py makes one;
                  pages/s, lines/s, peak memory, the stage split;
6. volume_bf16  — the main path: 48 bench.py pages (a blank page at index 5
                  and a loader that raises at index 20) through
                  VolumeRunner at its defaults, warmed on 8 pages and
                  warm_shapes(), then one timed run exporting PageXML and
                  text per page; the same pages through a plain run_ocr
                  loop; pages/s and lines/s of both, peak memory, the
                  occupancy histogram, stage medians, the adaptive state.
                  Passes when the records come back in order, exactly the
                  two failure entries fail, every page's boxes equal
                  run_ocr's, the volume's CER against run_ocr's texts is at
                  most 0.5%, every padded batch is in {1, 2, 4, 8, 16, 32},
                  every PageXML file parses with one TextLine per line, and
                  each kernel ran and equals its plain version on the
                  largest input the volume gave it;
7. dewarp_f32   — two bench.py config 2 pages (``curved_volume``, 1600x2640,
                  40 px sine) through run_ocr(use_tps=True) in float32,
                  TF32 off: each page's bytes, TPS ratio, gate, band ``b``,
                  ``max_dy``, line counts before and after the warp and
                  boxes equal to the JAX float32 record of
                  tests/data/torch_port/eval_suite.json, texts within 0.5%
                  CER of it; the card's warp against the port's CPU warp on
                  the same inputs (at most one gray level and under 1e-3 of
                  the mask pixels differing, the page's border excluded);
                  LOCAL mode (get_line_images_via_local_tps) on the first
                  page's line data on the card against the CPU: the same
                  strips, shape for shape, under 1e-3 of each strip's
                  values more than one gray level apart (a flipped mask
                  pixel moves a strip pixel between ink and blank);
8. dewarp_volume_bf16 — the main path of the dewarp: bench.py config 2's
                  shape, 24 curved pages through VolumeRunner
                  (geometry_workers=2, use_tps=True) at its defaults, warmed
                  on 4 pages and warm_shapes(), exports in the timed run;
                  the same pages through a run_ocr(use_tps=True) loop;
                  pages/s, lines/s, stage medians (dewarp among them), the
                  stage split of one page, the warps that took the exact
                  path, peak memory. Passes when every page is dewarped and
                  read in order, the boxes equal run_ocr's, the CER against
                  run_ocr's texts is at most 0.5%, the PageXML parses and
                  each kernel ran and equals its plain version on the
                  largest input the volume gave it;
9. eval_suite   — the first 12 pages of the six-distribution eval (two of
                  each) through eval/suite.py run_suite, bf16, canvas width
                  512 as the eval CLI has it: each page's bytes equal the JAX
                  page's (sha256 in the record), the texts within 2% CER of
                  the JAX float32 texts; CER per distribution, the pages the
                  dewarp was applied to;
10. eval_mode_f32 — eval mode with the eval LM, float32, TF32 off: the
                  ARPA built from the eval CLI's corpus (bytes equal to
                  artifacts/full77f/lm.arpa), loaded by the C++ scorer;
                  run_ocr(eval_mode=True) on the three fixture pages (top
                  beam texts within 0.5% CER of the JAX float32 ones of
                  tests/data/torch_port/eval_mode.json, the same boxes), the
                  fused top beams of their strips (within 0.5% CER); per
                  page the logits forward with its readback (device and
                  host ms), the plain batched search and the fused search
                  (host ms); then calibrate_lm on the eval CLI's 16
                  calibration strips at canvas 512: the same strips and
                  the same decision as the JAX record, the grid beside the
                  record's, and its seconds;
11. eval_mode_bf16 — the eval-mode path: build_pipeline(..., kenlm_config)
                  in bf16 at canvas 512, calibrated as above, then the
                  first 12 eval pages through run_suite with the plain and
                  the fused top beam: each within 2% CER of the JAX float32
                  beam texts; cer_beam and cer_beam_lm against the ground
                  truth, the LM columns, peak memory;
12. layout_f32  — layout mode in float32, TF32 off: full77f's recognizer
                  behind the full-width DeepLabV3+ (five classes) with the
                  seeded weights of tests/data/torch_port/layout.json, on
                  its four pages (the fixture pages and bench.py config
                  4's first page): per class at most 1e-3 of the JAX
                  float32 mask's pixels differ (layout_masks.npz, rounded
                  up to a whole pixel); run_ocr gives the record's status,
                  line count and boxes, texts within 0.5% CER;
                  predict_many_async over the four pages gives each
                  page's predict masks; the modern-book layout runner's
                  JSON equals the record's; the bench page's detection
                  time (device, span, wall);
13. layout_bf16 — the layout path at its defaults: 8 bench.py pages
                  through VolumeRunner and a run_ocr loop (pages/s, peak
                  memory; the volume's boxes equal run_ocr's and its CER
                  against run_ocr's texts is at most 0.5%); four pages'
                  masks from predict against predict_many_async (at most
                  1e-3 of a class's pixels); detection device ms per page
                  in layout mode and in line mode on the same page;
14. cli         — the page-OCR CLI (python -m ocr_inference_tpu_torch.cli.cli)
                  on the fixture pages written as PNG, with a model
                  directory pointing at artifacts/full77f: line mode with
                  --save-artifacts (in this process, so that its launches
                  count; each page's text equals bf16 run_ocr's), then as
                  a subprocess --resume (skips every page), --line-mode
                  layout --allow-random-weights (exits 0) and a folder
                  holding a JPEG (exits non-zero, naming it).

Kernel launch and recheck counts are zeroed just before each OCR path is
driven (phases 3-14) and read just after it. Then a ``kernels`` JSON line
(per kernel: launches over the main paths, phases 5, 6, 8, 11, 13 and 14,
and by path,
the shapes each path launched, rechecked pixels, time, plain time, bound
and share of the bound at the largest shape the main paths launched), the
card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failed phase ends the script with a
non-zero code and without that line. Without CUDA it exits non-zero at
once. Imports torch, numpy and the port; nothing of JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
import xml.etree.ElementTree as ET
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


def bench_volume(n_pages: int, seed: int = 42) -> list[np.ndarray]:
    """1600x2640 pages made as bench.py:44-78 makes its volume: noisy
    paper, 6-10 dark bands of ink blocks with a small shear, specks; one
    generator for the whole volume."""
    page_h, page_w, n_lines_mean = 1600, 2640, 8
    rng = np.random.default_rng(seed)
    pages = []
    for _ in range(n_pages):
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
                img[y0: y0 + h, x: x + w] = rng.integers(20, 70,
                                                         size=(h, w, 3))
                x += w + int(rng.integers(6, 16))
        for _ in range(int(rng.integers(40, 120))):
            sy = int(rng.integers(0, page_h - 3))
            sx = int(rng.integers(0, page_w - 3))
            img[sy: sy + 3, sx: sx + 3] = int(rng.integers(10, 60))
        pages.append(img)
    return pages


def bench_page(seed: int = 42) -> np.ndarray:
    """The first page of ``bench_volume`` with this seed."""
    return bench_volume(1, seed)[0]


def full77f_pipeline(dtype: torch.dtype, input_width: int = 3000,
                     kenlm_config=None, line_config=None,
                     allow_random: bool = False, seed: int = 0):
    from ocr_inference_tpu_torch.core.data import (
        CharsetEncoder, LineDetectionConfig, OCRModelConfig,
    )
    from ocr_inference_tpu_torch.pipeline import build_pipeline

    meta = json.loads((WEIGHTS / "recognizer.msgpack.json").read_text())
    ocr = OCRModelConfig(
        model_file=str(WEIGHTS / "recognizer.onnx"), architecture="Easter2",
        input_width=input_width, input_height=80, input_layer="input",
        output_layer="output", squeeze_channel=True, swap_hw=False,
        encoder=CharsetEncoder.WYLIE, charset=list(meta["charset"]),
        add_blank=True, version="full77f",
    )
    line = line_config or LineDetectionConfig(
        checkpoint="", onnx_file=str(WEIGHTS / "lines.onnx"),
        architecture="unet", patch_size=512, classes=["line"],
    )
    return build_pipeline(ocr, line, kenlm_config=kenlm_config, dtype=dtype,
                          allow_random=allow_random, seed=seed)


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

    builds = (kernels.build_library, native.build_library,
              lambda: native.build_library("arpa_lm.cpp"),
              lambda: native.build_library("png.cpp"))
    threads = [threading.Thread(target=guarded, args=(f,)) for f in builds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return {"nvcc_s": kernels.BUILD_SECONDS,
            "gxx_s": native.BUILD_SECONDS,
            "ptxas": ptxas_report(kernels.BUILD_REPORT)}


@phase("kernels")
def check_kernels():
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
    return {"_ok": ok, "cases": out, "gpu": gpu_name_and_limit()}


def fixture():
    from ocr_inference_tpu_torch.eval.synthetic import fixture_pages

    record = json.loads((FIXTURE / "texts.json").read_text(encoding="utf-8"))
    pages = fixture_pages(FIXTURE / "pages.npz")
    return pages, {p["name"]: p for p in record["pages"]}


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions and matmuls in full float32 on the card."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@contextlib.contextmanager
def kernel_recorder(results: dict):
    """While open, every call of a kernel wrapper made while a path is
    counted (``results["path"]``, see counted_path) records its input
    shape under that path and keeps a copy of the largest input the path
    gave it."""
    from ocr_inference_tpu_torch.ops import kernels

    shapes = results.setdefault("shapes", {})
    samples = results.setdefault("samples", {})
    wrapped = {}
    for name in ("binarize_tiles", "binarize_lines"):
        fn = getattr(kernels, name)
        wrapped[name] = fn

        def recorder(x, _fn=fn, _name=name):
            path = results.get("path")
            if path is not None:
                key = (path, _name)
                shapes.setdefault(key, set()).add(tuple(x.shape))
                if key not in samples or x.numel() > samples[key].numel():
                    samples[key] = x.clone()
            return _fn(x)

        setattr(kernels, name, recorder)
    try:
        yield
    finally:
        for name, fn in wrapped.items():
            setattr(kernels, name, fn)


@contextlib.contextmanager
def counted_path(results: dict, path: str):
    """Zero the kernels' launch and recheck counts just before a path is
    driven and read them just after it."""
    from ocr_inference_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    kernels.reset_rechecked()
    results["path"] = path
    try:
        yield
    finally:
        torch.cuda.synchronize()
        results["path"] = None
        results.setdefault("launches", {})[path] = dict(kernels.LAUNCHES)
        results.setdefault("rechecked", {})[path] = kernels.rechecked()


@phase("page_ocr_f32")
def page_ocr_f32(pipe, results: dict):
    from ocr_inference_tpu_torch.eval.cer import cer

    pages, ref = fixture()
    per_page, ok = {}, True
    with no_tf32(), counted_path(results, "page_ocr_f32"):
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
    return {"_ok": ok, "pages": per_page,
            "launches": results["launches"]["page_ocr_f32"]}


@phase("volume_f32")
def volume_f32(pipe, results: dict):
    from ocr_inference_tpu_torch.core.data import Encoding, OpStatus
    from ocr_inference_tpu_torch.pipeline import VolumeRunner

    pages, ref = fixture()
    with no_tf32(), counted_path(results, "volume_f32"):
        records = VolumeRunner(pipe, window_pages=2).run(
            [(name, img) for name, img, _ in pages],
            target_encoding=Encoding.WYLIE)
    per_page, ok = {}, [r.name for r in records] == [p[0] for p in pages]
    for rec in records:
        texts = [ln.text for ln in rec.ocr_lines]
        boxes = [list(ln.bbox.as_tuple()) for ln in rec.lines]
        same = (rec.status == OpStatus.SUCCESS
                and texts == ref[rec.name]["jax_f32_texts"]
                and boxes == ref[rec.name]["jax_f32_boxes"])
        ok &= same
        per_page[rec.name] = {"status": rec.status.name, "lines": len(texts),
                              "texts_and_boxes_equal_jax_f32": same,
                              "angle": rec.angle}
    return {"_ok": ok, "pages": per_page,
            "launches": results["launches"]["volume_f32"]}


@phase("page_ocr_bf16")
def page_ocr_bf16(pipe, results: dict):
    from ocr_inference_tpu_torch.eval.cer import cer

    pages, _ = fixture()
    big = bench_page(42)
    run_page(pipe, big)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_big = 5
    with counted_path(results, "page_ocr_bf16"):
        preds, refs = [], []
        for name, img, gt in pages:
            texts, _, _ = run_page(pipe, img)
            preds.append(" ".join(texts))
            refs.append(" ".join(gt))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lines = 0
        for _ in range(n_big):
            texts, _, _ = run_page(pipe, big)
            lines += len(texts)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    stages = stage_ms(pipe, big)
    launches = results["launches"]["page_ocr_bf16"]
    fixture_cer = cer(preds, refs)
    ok = fixture_cer <= 0.02 and all(v > 0 for v in launches.values())
    return {
        "_ok": ok,
        "fixture_cer_vs_ground_truth": fixture_cer,
        "bench_page": {"shape": list(big.shape), "lines": lines // n_big,
                       "pages_per_s": n_big / dt, "lines_per_s": lines / dt,
                       "repeats": n_big, "stage_ms": stages},
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches,
        "rechecked": results["rechecked"]["page_ocr_bf16"],
        "pages_run": len(pages) + n_big,
        "gpu": gpu_name_and_limit(),
    }


def stage_ms(pipe, img, use_tps: bool = False) -> dict:
    """Host-clock time of each run_ocr stage on one page, the card
    synchronized at every stage boundary; with ``use_tps`` the dewarping
    stage too, and its lines go on."""
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
    rot_img, rot_mask, _, contours, angle = timed(
        "build_lines", pipe.build_lines, img, mask)
    work_img = rot_img
    if use_tps:
        dw = timed("dewarping", pipe.apply_dewarping, rot_img, rot_mask,
                   contours, angle, True)
        work_img, contours = dw.work_img, dw.filtered_contours
    lines, strips = timed("extract_lines", pipe.extract_lines, work_img,
                          rot_mask, contours)
    timed("recognize", pipe.run_text_recognition, strips, lines)
    times["page_angle"] = angle
    return times


VOLUME_PAGES = 48
BLANK_AT, RAISING_AT = 5, 20
ALLOWED_BATCHES = {1, 2, 4, 8, 16, 32}


def _raising_loader():
    raise OSError("unreadable page file")


def plain_reads(pipe, entries, use_tps: bool = False) -> tuple[dict, float]:
    """The volume's pages through run_ocr one by one: name -> (bboxes,
    texts) of the lines whose strips are not empty (the lines VolumeRunner
    keeps, volume.py drops the rest), and the loop's seconds."""
    from ocr_inference_tpu_torch.core.data import Encoding, OpStatus
    from ocr_inference_tpu_torch.pipeline import PipelineObserver

    class Strips(PipelineObserver):
        def stage_end(self, stage, payload):
            if stage == "extract_lines":
                self.kept = [ln.bbox.as_tuple()
                             for ln, s in zip(*payload)
                             if s.shape[0] > 0 and s.shape[1] > 0]

    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for name, img in entries:
        try:
            img = img() if callable(img) else img
        except OSError:
            continue
        obs = Strips()
        status, payload = pipe.run_ocr(img, target_encoding=Encoding.WYLIE,
                                       observer=obs, use_tps=use_tps)
        if status == OpStatus.SUCCESS:
            out[name] = (obs.kept, [ln.text for ln in payload[2]])
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _median(vals):
    vals = sorted(vals)
    return vals[len(vals) // 2] if vals else None


@phase("volume_bf16")
def volume_bf16(pipe, results: dict):
    from ocr_inference_tpu_torch.core.data import Encoding, OpStatus
    from ocr_inference_tpu_torch.eval.cer import cer
    from ocr_inference_tpu_torch.io import PageXMLExporter, TextExporter
    from ocr_inference_tpu_torch.ops import kernels
    from ocr_inference_tpu_torch.pipeline import VolumeRunner

    t0 = time.perf_counter()
    pages = bench_volume(VOLUME_PAGES)
    entries = [(f"page{i:03d}", img) for i, img in enumerate(pages)]
    entries[BLANK_AT] = (entries[BLANK_AT][0],
                         np.full(pages[0].shape, 235, np.uint8))
    entries[RAISING_AT] = (entries[RAISING_AT][0], _raising_loader)
    make_s = time.perf_counter() - t0
    rec_engine = pipe.ocr_inference

    # warm: one run over the first 8 pages, then every streaming shape
    VolumeRunner(pipe).run(entries[:8], target_encoding=Encoding.WYLIE)
    warmed = rec_engine.warm_shapes()
    torch.cuda.synchronize()

    runner = VolumeRunner(pipe)
    exported = []
    with tempfile.TemporaryDirectory() as out_dir:
        exporters = (PageXMLExporter(out_dir), TextExporter(out_dir))

        def export(rec):  # per page, inside the timed run (bench.py)
            if rec.mask is not None and rec.ocr_lines:
                exported.append(exporters[0].export_lines(
                    rec.mask, rec.name, rec.lines, rec.ocr_lines,
                    angle=rec.angle))
                exported.append(exporters[1].export_lines(
                    None, rec.name, rec.lines, rec.ocr_lines))
            rec.mask = None

        rec_engine.occupancy.clear()
        torch.cuda.reset_peak_memory_stats()
        with counted_path(results, "volume_bf16"):
            t0 = time.perf_counter()
            records = runner.run(entries, target_encoding=Encoding.WYLIE,
                                 on_page_done=export)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        occupancy = dict(rec_engine.occupancy)
        xml_lines = {}
        for path in exported:
            if path.endswith(".xml"):
                root = ET.parse(path).getroot()
                xml_lines[Path(path).stem] = sum(
                    1 for el in root.iter() if el.tag.endswith("TextLine"))
    plain, plain_s = plain_reads(pipe, entries)

    names = [name for name, _ in entries]
    failed = {BLANK_AT, RAISING_AT}
    ok_pages = [r for r in records if r.status == OpStatus.SUCCESS]
    checks = {
        "in_order": [r.name for r in records] == names,
        "failures_exact": [i for i, r in enumerate(records)
                           if r.status == OpStatus.FAILED] == sorted(failed),
        "boxes_equal_run_ocr": all(
            r.name in plain
            and [ln.bbox.as_tuple() for ln in r.lines] == plain[r.name][0]
            for r in ok_pages),
        "batches_closed": {b for (_, _, b) in occupancy} <= ALLOWED_BATCHES,
        "pagexml_valid": len(xml_lines) == len(ok_pages) and all(
            xml_lines.get(r.name) == len(r.lines) for r in ok_pages),
    }
    volume_cer = cer(
        [" ".join(ln.text for ln in r.ocr_lines) for r in ok_pages],
        [" ".join(plain.get(r.name, ([], []))[1]) for r in ok_pages])
    checks["cer_vs_run_ocr_le_0.5pct"] = volume_cer <= 0.005

    # each kernel against its plain version on the largest input the
    # volume gave it (these launches come after the counts were read)
    agree = {}
    for name, plain_fn in (("binarize_tiles", kernels.binarize_tiles_plain),
                           ("binarize_lines", kernels.binarize_lines_plain)):
        x = results["samples"].get(("volume_bf16", name))
        if x is None:
            agree[name] = None
            continue
        got = getattr(kernels, name)(x)
        agree[name] = {"shape": list(x.shape),
                       "mismatches": int((got != plain_fn(x)).sum())}
    launches = results["launches"]["volume_bf16"]
    checks["kernels_ran_and_agree"] = all(
        launches[k] > 0 and agree[k] is not None
        and agree[k]["mismatches"] == 0 for k in launches)

    n_lines = sum(len(r.lines) for r in ok_pages)
    timings = {k: _median([r.timings_ms[k] for r in ok_pages
                           if k in r.timings_ms])
               for k in ("detect_dispatch", "detect", "geometry",
                         "recognize")}
    return {
        "_ok": all(checks.values()),
        "checks": checks,
        "entries": len(entries), "pages_ok": len(ok_pages),
        "lines": n_lines,
        "volume": {"seconds": dt, "pages_per_s": len(ok_pages) / dt,
                   "lines_per_s": n_lines / dt},
        "run_ocr_loop": {"seconds": plain_s,
                         "pages_per_s": len(plain) / plain_s,
                         "lines_per_s": sum(len(v[1]) for v in
                                            plain.values()) / plain_s},
        "cer_vs_run_ocr": volume_cer,
        "peak_memory_gib": peak_gib,
        "occupancy": sorted([*k, v] for k, v in occupancy.items()),
        "stage_median_ms": timings,
        "detect_ahead": runner.detect_ahead,
        "adaptive": runner.adaptive,
        "files_exported": len(exported),
        "warm_shapes": warmed,
        "launches": launches,
        "rechecked": results["rechecked"]["volume_bf16"],
        "kernel_vs_plain": agree,
        "make_volume_s": make_s,
        "errors": {r.name: r.error for r in records if r.error},
        "gpu": gpu_name_and_limit(),
    }


def sha256(array: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()


def eval_record() -> dict:
    return json.loads((FIXTURE / "eval_suite.json").read_text(
        encoding="utf-8"))


@contextlib.contextmanager
def dewarp_recorder(keep: bool = False):
    """While open, every warp the pipeline makes (apply_global_tps) records
    its report (the band ``b``, ``max_dy``, the path taken) and, with
    ``keep``, its inputs and outputs. Two geometry threads may call it."""
    from ocr_inference_tpu_torch.pipeline import ocr_pipeline

    calls: list[dict] = []
    lock = threading.Lock()
    real = ocr_pipeline.apply_global_tps

    def recorder(image, line_mask, line_data, **kwargs):
        report: dict = {}
        out = real(image, line_mask, line_data, report=report, **kwargs)
        entry = {"report": report}
        if keep:
            entry["inputs"], entry["outputs"] = (image, line_mask,
                                                 line_data), out
        with lock:
            calls.append(entry)
        return out

    ocr_pipeline.apply_global_tps = recorder
    try:
        yield calls
    finally:
        ocr_pipeline.apply_global_tps = real


def warp_agreement(got, want) -> dict:
    """The card's (gray, mask) warp against the CPU's: the gray levels
    and mask pixels that differ, over the page and inside its border."""
    inner = (slice(1, -1), slice(1, -1))
    diff = np.abs(got[0].astype(int) - want[0].astype(int))
    flips = (got[1] > 0) != (want[1] > 0)
    return {"max_gray_diff": int(diff.max()),
            "max_gray_diff_inner": int(diff[inner].max()),
            "mask_mismatch_inner": float(flips[inner].mean()),
            "mask_mismatch": float(flips.mean())}


def local_tps_agreement(image, line_mask, line_data) -> dict:
    """LOCAL mode (a TPS warp per curved line, then its strip) on the card
    against the same call on the CPU, on a page's own line data: the same
    strips, shape for shape, at the warp's bar. A strip is the page masked
    by the line's warped mask, so a mask pixel that the float order flips
    (the bar allows under 1e-3 of them) moves a strip pixel between ink
    and blank: under 1e-3 of a strip's values may differ by more than one
    gray level."""
    from ocr_inference_tpu_torch.dewarp import get_line_images_via_local_tps

    with no_tf32():
        t0 = time.perf_counter()
        card = get_line_images_via_local_tps(image, line_data)
        card_s = time.perf_counter() - t0
        cpu = get_line_images_via_local_tps(image, line_data, device="cpu")
    shapes_equal = [a.shape == b.shape for a, b in zip(card, cpu)]
    diffs = [np.abs(a.astype(int) - b.astype(int))
             for a, b in zip(card, cpu) if a.shape == b.shape]
    above = [float((d > 1).mean()) for d in diffs]
    return {"lines": len(card), "curved": sum(d["tps"] for d in line_data),
            "shapes_equal": sum(shapes_equal),
            "max_gray_diff": max((int(d.max()) for d in diffs), default=0),
            "values_above_1": sum(int((d > 1).sum()) for d in diffs),
            "max_share_above_1": max(above, default=0.0),
            "card_host_ms": card_s * 1e3,
            "ok": (len(card) == len(cpu) == len(line_data)
                   and all(shapes_equal) and max(above, default=0.0) < 1e-3)}


def stage_capture():
    from ocr_inference_tpu_torch.pipeline import PipelineObserver

    class Capture(PipelineObserver):
        """The contours before the dewarp and its result."""

        lines_before = None
        dewarp = None

        def stage_end(self, stage, payload):
            if stage == "build_line_data":
                self.lines_before = len(payload[3])
            elif stage == "dewarping":
                self.dewarp = payload

    return Capture()


@phase("dewarp_f32")
def dewarp_f32(pipe, results: dict):
    from ocr_inference_tpu_torch.core.data import Encoding, OpStatus
    from ocr_inference_tpu_torch.dewarp import apply_global_tps
    from ocr_inference_tpu_torch.eval.cer import cer
    from ocr_inference_tpu_torch.eval.synthetic import curved_volume

    record = eval_record()["curved"]["pages"]
    pages = curved_volume(len(record))
    runs = []
    with no_tf32(), dewarp_recorder(keep=True) as calls, \
            counted_path(results, "dewarp_f32"):
        for img in pages:
            obs = stage_capture()
            status, payload = pipe.run_ocr(
                img, target_encoding=Encoding.WYLIE, use_tps=True,
                observer=obs)
            runs.append((status, payload, obs))
    per_page, ok = [], len(calls) == len(pages)
    for img, (status, payload, obs), call, want in zip(pages, runs, calls,
                                                        record):
        if status != OpStatus.SUCCESS:
            per_page.append({"status": status.name, "error": payload})
            ok = False
            continue
        _, lines, ocr_lines, angle = payload
        texts = [ln.text for ln in ocr_lines]
        report = call["report"]
        cpu = apply_global_tps(*call["inputs"], device="cpu")
        agree = warp_agreement(call["outputs"], cpu)
        got = {
            "sha256_equal": sha256(img) == want["sha256"],
            "tps_ratio": obs.dewarp.tps_ratio, "applied": obs.dewarp.applied,
            "b": report["b"], "max_dy": report["max_dy"],
            "path": report["path"], "lines_before": obs.lines_before,
            "lines_after": len(obs.dewarp.filtered_contours),
            "lines": len(texts), "angle": angle,
            "boxes_equal_jax_f32": [list(ln.bbox.as_tuple()) for ln in lines]
            == want["jax_f32_boxes"],
            "texts_identical": texts == want["jax_f32_texts"],
            "cer_vs_jax_f32": cer([" ".join(texts)],
                                  [" ".join(want["jax_f32_texts"])]),
            "card_vs_cpu_warp": agree,
        }
        ok &= (got["sha256_equal"] and got["boxes_equal_jax_f32"]
               and got["tps_ratio"] == want["tps_ratio"]
               and got["applied"] == want["applied"]
               and got["b"] == want["b"]
               and abs(got["max_dy"] - want["max_dy"]) < 1e-3
               and got["lines_before"] == want["lines_before"]
               and got["lines_after"] == want["lines_after"]
               and got["cer_vs_jax_f32"] <= 0.005
               and agree["max_gray_diff_inner"] <= 1
               and agree["mask_mismatch_inner"] < 1e-3)
        per_page.append(got)
    local = local_tps_agreement(*calls[0]["inputs"])
    ok &= local["ok"]
    return {"_ok": ok, "pages": per_page, "local_tps": local,
            "warp_device_ms": warp_device_ms(calls[0]["inputs"]),
            "jax_f32": [
        {k: want[k] for k in ("tps_ratio", "applied", "b", "max_dy",
                              "lines_before", "lines_after")}
        for want in record],
        "launches": results["launches"]["dewarp_f32"],
        "gpu": gpu_name_and_limit()}


def warp_device_ms(inputs) -> dict:
    """Device time of the dewarp's card work on one page's inputs: the
    vertical gather warp and the exact 2-D warp, each with its map,
    inputs already on the card (CUDA events over repeated calls)."""
    from ocr_inference_tpu_torch.dewarp import tps
    from ocr_inference_tpu_torch.ops.imaging import rgb_to_gray

    image, mask, line_data = inputs
    h, w = image.shape[:2]
    gray = rgb_to_gray(torch.from_numpy(np.ascontiguousarray(image))).cuda()
    mask_t = torch.from_numpy(np.ascontiguousarray(mask)).cuda()
    fit = tps.global_tps_fit(h, w, line_data)[:3]
    with torch.inference_mode():
        return {
            "shape": [h, w],
            "vertical": cuda_ms(lambda x: tps._warp_pair_vertical(
                x, mask_t, *fit), gray, iters=10),
            "exact": cuda_ms(lambda x: tps._warp_pair(x, mask_t, *fit),
                             gray, iters=10),
        }


DEWARP_PAGES = 24


@phase("dewarp_volume_bf16")
def dewarp_volume_bf16(pipe, results: dict):
    from collections import Counter

    from ocr_inference_tpu_torch.core.data import Encoding, OpStatus
    from ocr_inference_tpu_torch.eval.cer import cer
    from ocr_inference_tpu_torch.eval.synthetic import curved_volume
    from ocr_inference_tpu_torch.io import PageXMLExporter, TextExporter
    from ocr_inference_tpu_torch.ops import kernels
    from ocr_inference_tpu_torch.pipeline import VolumeRunner

    t0 = time.perf_counter()
    pages = curved_volume(DEWARP_PAGES)
    entries = [(f"curved{i:03d}", img) for i, img in enumerate(pages)]
    make_s = time.perf_counter() - t0
    rec_engine = pipe.ocr_inference

    # warm: one run over 4 pages, then every streaming shape
    VolumeRunner(pipe, geometry_workers=2).run(
        entries[:4], use_tps=True, target_encoding=Encoding.WYLIE)
    warmed = rec_engine.warm_shapes()
    torch.cuda.synchronize()

    runner = VolumeRunner(pipe, geometry_workers=2)
    exported = []
    with tempfile.TemporaryDirectory() as out_dir, \
            dewarp_recorder() as calls:
        exporters = (PageXMLExporter(out_dir), TextExporter(out_dir))

        def export(rec):  # per page, inside the timed run (bench.py)
            if rec.mask is not None and rec.ocr_lines:
                exported.append(exporters[0].export_lines(
                    rec.mask, rec.name, rec.lines, rec.ocr_lines,
                    angle=rec.angle))
                exported.append(exporters[1].export_lines(
                    None, rec.name, rec.lines, rec.ocr_lines))
            rec.mask = None

        rec_engine.occupancy.clear()
        torch.cuda.reset_peak_memory_stats()
        with counted_path(results, "dewarp_volume_bf16"):
            t0 = time.perf_counter()
            records = runner.run(entries, use_tps=True,
                                 target_encoding=Encoding.WYLIE,
                                 on_page_done=export)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        occupancy = dict(rec_engine.occupancy)
        paths = Counter(c["report"]["path"] for c in calls)
        max_dy = [c["report"]["max_dy"] for c in calls]
        xml_lines = {}
        for path in exported:
            if path.endswith(".xml"):
                root = ET.parse(path).getroot()
                xml_lines[Path(path).stem] = sum(
                    1 for el in root.iter() if el.tag.endswith("TextLine"))
    plain, plain_s = plain_reads(pipe, entries, use_tps=True)
    split = stage_ms(pipe, pages[0], use_tps=True)

    ok_pages = [r for r in records if r.status == OpStatus.SUCCESS]
    checks = {
        "in_order": [r.name for r in records] == [n for n, _ in entries],
        "all_pages_read": len(ok_pages) == len(entries),
        "every_page_dewarped": len(calls) == len(entries),
        "boxes_equal_run_ocr": all(
            r.name in plain
            and [ln.bbox.as_tuple() for ln in r.lines] == plain[r.name][0]
            for r in ok_pages),
        "batches_closed": {b for (_, _, b) in occupancy} <= ALLOWED_BATCHES,
        "pagexml_valid": len(xml_lines) == len(ok_pages) and all(
            xml_lines.get(r.name) == len(r.lines) for r in ok_pages),
    }
    volume_cer = cer(
        [" ".join(ln.text for ln in r.ocr_lines) for r in ok_pages],
        [" ".join(plain.get(r.name, ([], []))[1]) for r in ok_pages])
    checks["cer_vs_run_ocr_le_0.5pct"] = volume_cer <= 0.005

    agree = {}
    for name, plain_fn in (("binarize_tiles", kernels.binarize_tiles_plain),
                           ("binarize_lines", kernels.binarize_lines_plain)):
        x = results["samples"].get(("dewarp_volume_bf16", name))
        if x is None:
            agree[name] = None
            continue
        got = getattr(kernels, name)(x)
        agree[name] = {"shape": list(x.shape),
                       "mismatches": int((got != plain_fn(x)).sum())}
    launches = results["launches"]["dewarp_volume_bf16"]
    checks["kernels_ran_and_agree"] = all(
        launches[k] > 0 and agree[k] is not None
        and agree[k]["mismatches"] == 0 for k in launches)

    n_lines = sum(len(r.lines) for r in ok_pages)
    timings = {k: _median([r.timings_ms[k] for r in ok_pages
                           if k in r.timings_ms])
               for k in ("detect_dispatch", "detect", "geometry", "dewarp",
                         "recognize")}
    return {
        "_ok": all(checks.values()),
        "checks": checks,
        "entries": len(entries), "pages_ok": len(ok_pages),
        "lines": n_lines,
        "volume": {"seconds": dt, "pages_per_s": len(ok_pages) / dt,
                   "lines_per_s": n_lines / dt},
        "run_ocr_loop": {"seconds": plain_s,
                         "pages_per_s": len(plain) / plain_s,
                         "lines_per_s": sum(len(v[1]) for v in
                                            plain.values()) / plain_s},
        "cer_vs_run_ocr": volume_cer,
        "warp_paths": dict(paths),
        "max_dy_range": [min(max_dy), max(max_dy)] if max_dy else None,
        "stage_ms_one_page": split,
        "peak_memory_gib": peak_gib,
        "occupancy": sorted([*k, v] for k, v in occupancy.items()),
        "stage_median_ms": timings,
        "detect_ahead": runner.detect_ahead,
        "adaptive": runner.adaptive,
        "files_exported": len(exported),
        "warm_shapes": warmed,
        "launches": launches,
        "rechecked": results["rechecked"]["dewarp_volume_bf16"],
        "kernel_vs_plain": agree,
        "make_volume_s": make_s,
        "errors": {r.name: r.error for r in records if r.error},
        "gpu": gpu_name_and_limit(),
    }


EVAL_SMOKE_PAGES = 12


@phase("eval_suite")
def eval_suite(pipe, results: dict):
    from ocr_inference_tpu_torch.eval import suite
    from ocr_inference_tpu_torch.eval.cer import cer
    from ocr_inference_tpu_torch.eval.synthetic import load_glyphs

    record = eval_record()["pages"][:EVAL_SMOKE_PAGES]
    glyphs, charset = load_glyphs(FIXTURE / "pages.npz")
    same_bytes = []

    def check(page, _):
        same_bytes.append(sha256(page.image) == record[page.index]["sha256"])

    t0 = time.perf_counter()
    with counted_path(results, "eval_suite"):
        res = suite.run_suite(pipe, EVAL_SMOKE_PAGES, glyphs, charset,
                              on_page=check)
    dt = time.perf_counter() - t0
    cer_vs_jax = cer(res.predictions, [p["jax_f32_text"] for p in record])
    ok = (len(same_bytes) == EVAL_SMOKE_PAGES and all(same_bytes)
          and cer_vs_jax <= 0.02)
    return {
        "_ok": ok, "pages": EVAL_SMOKE_PAGES,
        "pages_equal_jax_bytes": sum(same_bytes),
        "cer_vs_jax_f32": cer_vs_jax,
        "cer_vs_ground_truth": res.cer,
        "jax_f32_cer_vs_ground_truth": cer(
            [p["jax_f32_text"] for p in record], res.references),
        "per_distribution": res.per_distribution,
        "tps_applied_pages": res.tps_applied_pages,
        "failed_pages": res.failed_pages,
        "lines": res.lines_detected, "suite_s": dt,
        "launches": results["launches"]["eval_suite"],
    }


LM_ARPA = WEIGHTS / "lm.arpa"
EVAL_CANVAS = 512  # the eval CLI's recognizer canvas (--canvas-width)


def eval_lm_pipeline(dtype: torch.dtype, input_width: int = EVAL_CANVAS):
    """full77f with the eval LM (alpha 0.5, beta 0, the CLI's defaults);
    fails unless the C++ scorer serves it."""
    from ocr_inference_tpu_torch.core.data import KenLMConfig
    from ocr_inference_tpu_torch.native import NativeArpaLM

    pipe = full77f_pipeline(dtype, input_width,
                            KenLMConfig(str(LM_ARPA), str(LM_ARPA), None))
    dec = pipe.ocr_inference.ctc_decoder_lm
    if not (dec.has_lm and isinstance(dec._lm, NativeArpaLM)):
        raise RuntimeError("the eval LM did not load into the C++ scorer")
    return pipe


def eval_page_ms(engine, strips) -> dict:
    """One eval-mode page's recognition, split, through the engine's own
    steps that run_batch_beams and calibrate_lm run: the canvas padding
    and batching (``_prepare_batches``, host ms); the logits forward of
    all its batches with the readback (``_queue_logits``), as host
    ms until the last logits are on the host and as device ms between
    CUDA events on the recognizer's stream, the stream held by a spin
    kernel until all of it is queued (so the host's launch pace does not
    count); then the plain batched beam search and the fused search of
    those logits on the host (ms)."""
    t0 = time.perf_counter()
    batches = engine._prepare_batches(strips, pre_pad=False)
    pad_ms = (time.perf_counter() - t0) * 1e3

    with torch.inference_mode(), engine._on_stream():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = [p.get() for _, p in engine._queue_logits(batches)]
        host_ms = (time.perf_counter() - t0) * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~25 ms at 1.98 GHz
        start.record()
        pending = engine._queue_logits(batches)
        end.record()
        for _, p in pending:
            p.get()
    dec, dec_lm = engine.ctc_decoder, engine.ctc_decoder_lm
    t0 = time.perf_counter()
    for lg in logits:
        dec.ctc_beam_decode_batch(lg, use_lm=False, top_k=1)
    plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for lg in logits:
        dec_lm.ctc_beam_decode_batch(lg, use_lm=True, top_k=1)
    fused_ms = (time.perf_counter() - t0) * 1e3
    return {"lines": len(strips), "batches": len(logits),
            "frames": [int(lg.shape[1]) for lg in logits],
            "canvas_pad_ms": pad_ms,
            "logits_device_ms": start.elapsed_time(end),
            "logits_host_ms": host_ms, "plain_search_ms": plain_ms,
            "fused_search_ms": fused_ms}


def beam_texts(beams) -> list[str]:
    return [b[0].text.strip().replace("§", " ") if b else "" for b in beams]


def calibrate_on_card(pipe, lm_record: dict) -> dict:
    """calibrate_lm on the eval CLI's calibration strips, beside the JAX
    float32 record's report."""
    from ocr_inference_tpu_torch.eval import suite
    from ocr_inference_tpu_torch.eval.synthetic import load_glyphs

    glyphs, charset = load_glyphs(FIXTURE / "pages.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    strips, refs, used, attempts = suite.calibration_strips(pipe, glyphs,
                                                            charset)
    t1 = time.perf_counter()
    report = pipe.ocr_inference.calibrate_lm(strips, refs)
    t2 = time.perf_counter()
    want = lm_record["lm_calibration"]
    return {
        "same_strips": (used == lm_record["calib_pages"]
                        and refs == lm_record["calib_refs"]),
        "enabled": report["enabled"], "jax_enabled": want["enabled"],
        "same_decision": report["enabled"] == want["enabled"],
        "report": report, "jax_report": want,
        "grid_vs_jax": [[a, b, c, wc] for (a, b, c), (_, _, wc)
                        in zip(report["grid"], want["grid"])],
        "strip_seconds": t1 - t0, "calibrate_seconds": t2 - t1,
    }


@phase("eval_mode_f32")
def eval_mode_f32(results: dict):
    from ocr_inference_tpu_torch.core.data import Encoding, OpStatus
    from ocr_inference_tpu_torch.eval import suite
    from ocr_inference_tpu_torch.eval.cer import cer
    from ocr_inference_tpu_torch.eval.synthetic import load_glyphs

    _, charset = load_glyphs(FIXTURE / "pages.npz")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        built = suite.build_eval_lm(Path(tmp) / "lm.arpa", charset)
        lm_equal = built.read_bytes() == LM_ARPA.read_bytes()
    build_lm_s = time.perf_counter() - t0
    record = json.loads((FIXTURE / "eval_mode.json").read_text(
        encoding="utf-8"))
    ref = {p["name"]: p for p in record["pages"]}
    pages, _ = fixture()
    pipe = eval_lm_pipeline(torch.float32, input_width=3000)
    engine = pipe.ocr_inference
    per_page, captured, ok = {}, {}, lm_equal
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with no_tf32():
        with counted_path(results, "eval_mode_f32"):
            for name, img, _ in pages:
                cap = suite.StripCapture()
                status, payload = pipe.run_ocr(
                    img, eval_mode=True, target_encoding=Encoding.WYLIE,
                    observer=cap)
                if status != OpStatus.SUCCESS:
                    raise RuntimeError(f"{name}: {payload}")
                _, lines, ocr_lines, _ = payload
                texts = [ln.text for ln in ocr_lines]
                want = ref[name]["jax_f32_beam_texts"]
                fused = beam_texts(engine.run_batch_beams(
                    cap.strips, use_lm=True, top_k=1))
                page_cer = cer([" ".join(texts)], [" ".join(want)])
                fused_cer = cer([" ".join(fused)],
                                [" ".join(ref[name]["jax_f32_fused_texts"])])
                boxes = [list(ln.bbox.as_tuple()) for ln in lines]
                ok &= (len(texts) == len(want) and page_cer <= 0.005
                       and fused_cer <= 0.005
                       and boxes == ref[name]["jax_f32_boxes"])
                captured[name] = cap.strips
                per_page[name] = {
                    "lines": len(texts), "cer_vs_jax_f32_beam": page_cer,
                    "texts_identical": texts == want,
                    "fused_cer_vs_jax_f32": fused_cer,
                    "boxes_identical": boxes == ref[name]["jax_f32_boxes"],
                    "ctc_conf": [ln.ctc_conf for ln in ocr_lines],
                    "jax_ctc_conf": ref[name]["jax_f32_ctc_conf"],
                }
        peak = torch.cuda.max_memory_allocated() / 2**30
        for name, strips in captured.items():
            per_page[name]["ms"] = eval_page_ms(engine, strips)
        del pipe, engine
        calib = calibrate_on_card(eval_lm_pipeline(torch.float32),
                                  eval_record()["lm"])
    ok &= calib["same_decision"] and calib["same_strips"]
    launches = results["launches"]["eval_mode_f32"]
    return {
        "_ok": ok and all(v > 0 for v in launches.values()),
        "lm_bytes_equal": lm_equal, "build_lm_s": build_lm_s,
        "scorer": "NativeArpaLM", "pages": per_page,
        "peak_memory_gib": peak,
        "calibration": calib, "launches": launches,
        "gpu": gpu_name_and_limit(),
    }


@phase("eval_mode_bf16")
def eval_mode_bf16(results: dict):
    from ocr_inference_tpu_torch.eval import suite
    from ocr_inference_tpu_torch.eval.cer import cer
    from ocr_inference_tpu_torch.eval.synthetic import load_glyphs

    record = eval_record()
    pages = record["pages"][:EVAL_SMOKE_PAGES]
    glyphs, charset = load_glyphs(FIXTURE / "pages.npz")
    pipe = eval_lm_pipeline(torch.bfloat16)
    calib = calibrate_on_card(pipe, record["lm"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted_path(results, "eval_mode_bf16"):
        res = suite.run_suite(pipe, EVAL_SMOKE_PAGES, glyphs, charset)
    dt = time.perf_counter() - t0
    beam_vs_jax = cer(res.beam_predictions,
                      [p["jax_f32_beam_text"] for p in pages])
    fused_vs_jax = cer(res.beam_lm_predictions,
                       [p["jax_f32_beam_lm_text"] for p in pages])
    launches = results["launches"]["eval_mode_bf16"]
    ok = (beam_vs_jax <= 0.02 and fused_vs_jax <= 0.02
          and not res.failed_pages
          and all(v > 0 for v in launches.values()))
    return {
        "_ok": ok, "pages": EVAL_SMOKE_PAGES,
        "beam_cer_vs_jax_f32": beam_vs_jax,
        "fused_cer_vs_jax_f32": fused_vs_jax,
        "greedy_cer_vs_jax_f32": cer(
            res.predictions, [p["jax_f32_text"] for p in pages]),
        "lm_columns": suite.lm_columns(pipe, res),
        "jax_f32_cer_beam_12_pages": cer(
            [p["jax_f32_beam_text"] for p in pages], res.references),
        "cer_vs_ground_truth": res.cer, "calibration": calib,
        "suite_s": dt, "pages_per_s": EVAL_SMOKE_PAGES / dt,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "rechecked": results["rechecked"][
            "eval_mode_bf16"],
        "gpu": gpu_name_and_limit(),
    }


def layout_record() -> tuple[dict, dict]:
    """The JAX float32 layout record and its packed (C, H, W/8) masks."""
    record = json.loads((FIXTURE / "layout.json").read_text(encoding="utf-8"))
    with np.load(FIXTURE / "layout_masks.npz") as npz:
        masks = {name: npz[name] for name in npz.files}
    return record, masks


def layout_pipeline(dtype: torch.dtype, record: dict):
    """full77f's recognizer behind the layout DeepLabV3+ (five classes)
    with the record's seeded weights, made from the seed with numpy."""
    from ocr_inference_tpu_torch.core.data import LayoutDetectionConfig

    cfg = LayoutDetectionConfig(checkpoint="", onnx_file="",
                                architecture="deeplabv3", patch_size=512,
                                classes=list(record["classes"]))
    return full77f_pipeline(dtype, line_config=cfg, allow_random=True,
                            seed=record["seed"])


def layout_pages() -> list[tuple[str, np.ndarray]]:
    """The record's pages: the three fixture pages and bench.py config 4's
    first page."""
    pages, _ = fixture()
    return [(n, img) for n, img, _ in pages] + [("bench_cfg4_0",
                                                 bench_page(42))]


def mask_agreement(mask: np.ndarray, want: np.ndarray, classes) -> dict:
    """(H, W, C) 0/255 mask against (C, H, W) 0/1 reference masks: per
    class the reference's pixels, the pixels that differ, and whether
    they are at most 1e-3 of the class's pixels (rounded up to a whole
    pixel)."""
    out = {}
    for c, cls in enumerate(classes):
        ref = want[c] > 0
        differ = int(((mask[:, :, c] > 0) != ref).sum())
        pixels = int(ref.sum())
        out[cls] = {"pixels": pixels, "differ": differ,
                    "ok": differ <= math.ceil(1e-3 * pixels)}
    return out


def detect_device_ms(engine, img, repeats: int = 3) -> dict:
    """One page's detection (``engine.predict``) on the card, warm: the
    device time of its kernels (torch.profiler, the kernel rows alone,
    summed per page: an operator's row repeats its kernels' time), the
    span on the card's clock from the first queued op to the mask copy
    (CUDA events; gaps included), and the host wall time per page from
    the call to the mask on the host (without the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.predict(img)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spans, walls = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        start.record()
        resolve = engine.predict_async(img)
        end.record()
        resolve()
        walls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            engine.predict(img)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    busy = sum(dev_us(e) for e in kernels) / 1e3 / repeats
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    return {"device_ms": busy or None, "span_ms": _median(spans),
            "wall_ms": _median(walls),
            "top_device_ms": [[e.key[:60], dev_us(e) / 1e3 / repeats]
                              for e in top]}


@phase("layout_f32")
def layout_f32(results: dict):
    from ocr_inference_tpu_torch.core.data import Encoding, OpStatus
    from ocr_inference_tpu_torch.eval.cer import cer
    from ocr_inference_tpu_torch.io.artifacts import write_png
    from ocr_inference_tpu_torch.pipeline.modern_layout import (
        ModernBookFormatLayoutDetection,
    )

    record, want_masks = layout_record()
    classes = record["classes"]
    pipe = layout_pipeline(torch.float32, record)
    det = pipe.line_inference
    pages = layout_pages()
    refs = {p["name"]: p for p in record["pages"]}
    per_page, checks = {}, {}
    with no_tf32():
        with counted_path(results, "layout_f32"):
            masks = {}
            for name, img in pages:
                ref = refs[name]
                masks[name] = det.predict(img)
                agree = mask_agreement(masks[name], np.unpackbits(
                    want_masks[name], axis=-1)[..., :img.shape[1]], classes)
                status, payload = pipe.run_ocr(
                    img, target_encoding=Encoding.WYLIE)
                ok = status == OpStatus.SUCCESS
                texts = [ln.text for ln in payload[2]] if ok else []
                boxes = [list(ln.bbox.as_tuple())
                         for ln in payload[1]] if ok else []
                page_cer = cer([" ".join(texts)],
                               [" ".join(ref["jax_f32_texts"])])
                per_page[name] = {
                    "page_equals_record": sha256(img) == ref["sha256"],
                    "masks": agree, "status": status.name,
                    "lines": len(texts), "jax_lines": len(ref["jax_f32_texts"]),
                    "boxes_equal": boxes == ref["jax_f32_boxes"],
                    "cer_vs_jax_f32": page_cer,
                }
                checks[name] = (
                    sha256(img) == ref["sha256"]
                    and all(a["ok"] for a in agree.values())
                    and status.name == ref["status"]
                    and len(texts) == len(ref["jax_f32_texts"])
                    and boxes == ref["jax_f32_boxes"] and page_cer <= 0.005)
            many = det.predict_many_async([img for _, img in pages])
            many_equal = {name: bool(np.array_equal(r(), masks[name]))
                          for (name, _), r in zip(pages, many)}
        with tempfile.TemporaryDirectory() as tmp:
            page_dir = Path(tmp) / "pages"
            page_dir.mkdir()
            for name, img in pages[:3]:
                write_png(page_dir / f"{name}.png", img[..., ::-1])
            modern = ModernBookFormatLayoutDetection(
                pipe.line_config, engine=det).run(str(page_dir),
                                                  str(Path(tmp) / "json"))
        modern = {Path(p).stem: found for p, found in modern.items()}
        timing = detect_device_ms(det, pages[-1][1])
    checks["predict_many_async_equal"] = all(many_equal.values())
    checks["modern_layout_json_equal"] = modern == record["modern_layout"]
    return {
        "_ok": all(checks.values()), "checks": checks, "pages": per_page,
        "seed": record["seed"], "predict_many_equal": many_equal,
        "bench_page_detect_f32": timing,
        "launches": results["launches"]["layout_f32"],
        "gpu": gpu_name_and_limit(),
    }


LAYOUT_VOLUME_PAGES = 8


@phase("layout_bf16")
def layout_bf16(results: dict):
    from ocr_inference_tpu_torch.core.data import Encoding, OpStatus
    from ocr_inference_tpu_torch.eval.cer import cer
    from ocr_inference_tpu_torch.pipeline import VolumeRunner

    record, _ = layout_record()
    classes = record["classes"]
    pipe = layout_pipeline(torch.bfloat16, record)
    det = pipe.line_inference
    pages = bench_volume(LAYOUT_VOLUME_PAGES)
    entries = [(f"layout{i:03d}", img) for i, img in enumerate(pages)]
    VolumeRunner(pipe).run(entries[:2], target_encoding=Encoding.WYLIE)
    pipe.ocr_inference.warm_shapes()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counted_path(results, "layout_bf16"):
        t0 = time.perf_counter()
        records = VolumeRunner(pipe).run(entries,
                                         target_encoding=Encoding.WYLIE)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    plain, plain_s = plain_reads(pipe, entries)

    # a page's mask alone and in one tile stream with three others
    # (chunks of 32 tiles against the page's own 24)
    single = [det.predict(img) for img in pages[:4]]
    many = [r() for r in det.predict_many_async(pages[:4])]
    many_vs_single = [mask_agreement(m, s.transpose(2, 0, 1) > 0, classes)
                      for m, s in zip(many, single)]
    layout_ms = detect_device_ms(det, pages[0])
    del pipe, det
    line_ms = detect_device_ms(
        full77f_pipeline(torch.bfloat16).line_inference, pages[0])

    ok_pages = [r for r in records if r.status == OpStatus.SUCCESS]
    volume_cer = cer(
        [" ".join(ln.text for ln in r.ocr_lines) for r in ok_pages],
        [" ".join(plain.get(r.name, ([], []))[1]) for r in ok_pages])
    checks = {
        "in_order": [r.name for r in records] == [n for n, _ in entries],
        "all_pages_read": len(ok_pages) == len(entries),
        "boxes_equal_run_ocr": all(
            r.name in plain
            and [ln.bbox.as_tuple() for ln in r.lines] == plain[r.name][0]
            for r in ok_pages),
        "cer_vs_run_ocr_le_0.5pct": volume_cer <= 0.005,
        "many_vs_single_le_1e-3": all(a["ok"] for page in many_vs_single
                                      for a in page.values()),
    }
    n_lines = sum(len(r.lines) for r in ok_pages)
    return {
        "_ok": all(checks.values()), "checks": checks,
        "pages": len(entries), "lines": n_lines,
        "volume": {"seconds": dt, "pages_per_s": len(ok_pages) / dt,
                   "lines_per_s": n_lines / dt},
        "run_ocr_loop": {"seconds": plain_s,
                         "pages_per_s": len(plain) / plain_s},
        "cer_vs_run_ocr": volume_cer, "peak_memory_gib": peak_gib,
        "detect_per_page": {"layout_bf16": layout_ms, "line_bf16": line_ms},
        "many_vs_single": many_vs_single,
        "stage_median_ms": {k: _median([r.timings_ms[k] for r in ok_pages
                                        if k in r.timings_ms])
                            for k in ("detect_dispatch", "detect",
                                      "geometry", "recognize")},
        "launches": results["launches"]["layout_bf16"],
        "errors": {r.name: r.error for r in records if r.error},
        "gpu": gpu_name_and_limit(),
    }


def write_model_dirs(root: Path) -> tuple[Path, Path]:
    """A recognizer model directory (model_config.json) and a line model
    directory (one config JSON) that point at artifacts/full77f, in the
    layout of the BDRC model repositories."""
    meta = json.loads((WEIGHTS / "recognizer.msgpack.json").read_text())
    model, lines = root / "model", root / "lines"
    model.mkdir()
    lines.mkdir()
    (model / "model_config.json").write_text(json.dumps({
        "onnx-model": str(WEIGHTS / "recognizer.onnx"),
        "architecture": "Easter2", "input_width": 3000, "input_height": 80,
        "input_layer": "input", "output_layer": "output",
        "squeeze_channel_dim": "yes", "swap_hw": "no", "encoder": "wylie",
        "charset": meta["charset"], "add_blank": "yes",
        "version": "full77f"}))
    (lines / "config.json").write_text(json.dumps({
        "checkpoint": "", "onnx-model": str(WEIGHTS / "lines.onnx"),
        "architecture": "unet", "patch_size": 512, "classes": ["line"]}))
    return model, lines


@phase("cli")
def cli_phase(results: dict):
    from ocr_inference_tpu_torch.cli import cli
    from ocr_inference_tpu_torch.core.data import Encoding
    from ocr_inference_tpu_torch.io.artifacts import write_png
    from ocr_inference_tpu_torch.io.images import read_image

    record, _ = layout_record()
    pages, _ = fixture()
    checks, runs = {}, {}

    def script(*args):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ocr_inference_tpu_torch.cli.cli", *args],
            capture_output=True, text=True, cwd=REPO, timeout=600)
        return proc, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        model, lines = write_model_dirs(root)
        page_dir = root / "pages"
        page_dir.mkdir()
        for name, img, _ in pages:
            write_png(page_dir / f"{name}.png", img[..., ::-1])
        args = ["--model", str(model), "--folder", str(page_dir),
                "--output", str(root / "out"), "--line-model", str(lines),
                "--encoding", "wylie", "--save-artifacts",
                "--artifact-output", str(root / "art"), "--job-id", "smoke"]
        # line mode, in this process so that its launches are counted
        t0 = time.perf_counter()
        with counted_path(results, "cli"):
            rc = cli.main(args)
        runs["line_mode"] = {"rc": rc, "s": time.perf_counter() - t0}
        pipe = full77f_pipeline(torch.bfloat16)
        same = {}
        for name, _, _ in pages:
            img = read_image(page_dir / f"{name}.png")
            _, payload = pipe.run_ocr(img, merge_lines=False,
                                      target_encoding=Encoding.WYLIE)
            want = "".join(f"{ln.text}\n" for ln in payload[2])
            got = root / "art" / "smoke" / f"{name}.png" / "results" / \
                f"{name}.txt"
            same[name] = got.is_file() and got.read_text(
                encoding="utf-8") == want
        del pipe
        checks["line_mode_texts_equal_run_ocr"] = rc == 0 and all(
            same.values())

        proc, s = script(*args, "--resume")
        runs["resume"] = {"rc": proc.returncode, "s": s,
                          "stdout": proc.stdout[-400:]}
        checks["resume_skips_every_page"] = (
            proc.returncode == 1  # the JAX CLI's code when no page ran
            and f"Resuming: {len(pages)} pages already done" in proc.stdout
            and "Text output" not in proc.stdout
            and "OCR failed" not in proc.stdout)

        proc, s = script("--model", str(model), "--folder", str(page_dir),
                         "--output", str(root / "layout"), "--line-mode",
                         "layout", "--allow-random-weights", "--seed",
                         str(record["seed"]))
        runs["layout"] = {"rc": proc.returncode, "s": s,
                          "stderr": proc.stderr[-400:]}
        checks["layout_runs"] = proc.returncode == 0 and all(
            (root / "layout" / f"{name}.txt").is_file()
            for name, _, _ in pages)

        jpeg = page_dir / "scan.jpg"
        jpeg.write_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00")
        proc, s = script("--model", str(model), "--folder", str(page_dir),
                         "--output", str(root / "refused"))
        runs["jpeg"] = {"rc": proc.returncode, "s": s,
                        "stderr": proc.stderr[-400:]}
        checks["jpeg_refused_by_name"] = (
            proc.returncode != 0 and "scan.jpg (JPEG)" in proc.stderr
            and not (root / "refused").exists())
    return {"_ok": all(checks.values()), "checks": checks, "runs": runs,
            "texts_equal": same,
            "launches": results["launches"]["cli"],
            "gpu": gpu_name_and_limit()}


MAIN_PATHS = ("page_ocr_bf16", "volume_bf16", "dewarp_volume_bf16",
              "eval_mode_bf16", "layout_bf16", "cli")


def kernels_line(results: dict) -> dict:
    """The per-kernel summary: launches and rechecked pixels over the main
    paths (bf16 page OCR, the bf16 volume, the dewarped bf16 volume, bf16
    eval mode, the bf16 layout volume and the CLI), with each path's own
    count;
    time, plain time and bound at the largest shape the main paths gave
    the kernel, and the shapes each path gave it."""
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
        shape = max(set().union(*(results["shapes"].get((p, name), ())
                                  for p in MAIN_PATHS)),
                    key=lambda s: int(np.prod(s)))
        x = torch.randint(0, 256, shape, dtype=torch.uint8,
                          generator=gen).to(dev)
        got, want = fn(x), plain(x)
        torch.cuda.synchronize()
        bound_ms, bound_by = binarize_bound_ms(shape, channels)
        ms = kernel_ms(fn, x)
        by_path = {path: results["launches"][path][name]
                   for path in results["launches"]}
        entries.append({
            "name": name, "route": "cuda",
            "source": "ocr_inference_tpu_torch/csrc/binarize.cu",
            "replaces": replaces,
            "launches": sum(by_path[p] for p in MAIN_PATHS),
            "max_abs_err": int((got.int() - want.int()).abs().max()),
            "ms": ms, "plain_ms": cuda_ms(plain, x, iters=3),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": list(shape), "bound_share": bound_ms / ms,
            "call_ms": cuda_ms(fn, x),
            "launches_by_path": by_path,
            "shapes_by_path": {
                p: sorted(results["shapes"].get((p, name), ()))
                for p in results["launches"]},
            "rechecked": sum(results["rechecked"][p][name]
                             for p in MAIN_PATHS),
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
    check_kernels()
    f32 = full77f_pipeline(torch.float32)
    bf16 = full77f_pipeline(torch.bfloat16)
    with kernel_recorder(results):
        page_ocr_f32(f32, results)
        volume_f32(f32, results)
        dewarp_f32(f32, results)
        del f32
        page_ocr_bf16(bf16, results)
        volume_bf16(bf16, results)
        dewarp_volume_bf16(bf16, results)
        del bf16
        # the eval CLI's recognizer canvas (selftrain_cli.py --canvas-width)
        eval_suite(full77f_pipeline(torch.bfloat16, input_width=EVAL_CANVAS),
                   results)
        eval_mode_f32(results)
        eval_mode_bf16(results)
        layout_f32(results)
        layout_bf16(results)
        cli_phase(results)
    if FAILED:
        print(f"chip_smoke: failed phases {FAILED}", file=sys.stderr)
        return 1
    summary = kernels_line(results)
    if any(k["launches"] == 0 or k["max_abs_err"] != 0
           or 0 in k["launches_by_path"].values()
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
