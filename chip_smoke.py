"""Drive the PyTorch port's page and volume OCR, its training, its
``.onnx`` checkpoints and its public surface on one NVIDIA card and check
them.

    python3 chip_smoke.py

Builds the kernels from the checkout (nvcc for csrc/*.cu, g++ for the
geometry library, the ARPA scorer and the image decoders, the AV1 decoder
of AVIF among them, all started together), then runs thirty-one phases
and prints one JSON line for each:

1. build        — seconds of each compiler; registers and spills of each
                  kernel as ptxas reports them;
2. kernels      — each kernel wrapper against its plain PyTorch version on
                  the card: binarize_tiles on (24, 512, 512, 3) random,
                  page-like and knife-edge tiles, binarize_lines on
                  (8, 80, 1024), on (64, 80, W) for every width bucket and
                  on knife-edge canvases (64, 80, 3000), and on whole
                  line images (1, H, W) of the heights the evaluator
                  sends, H in 23, 80, 81, 161, 300 by W in 37, 1024,
                  2999; per case
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
                  shape, 12 curved pages through VolumeRunner
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
                  holding a JPEG 2000 TIFF named .jpg (exits non-zero,
                  naming it);
15. recognizers_f32 — Easter2-Attention, Easter2-Vit and CRNN at full
                  width with the seeded weights of tests/data/torch_port/
                  recognizers.json (build_pipeline's allow_random), float32,
                  TF32 off: the logits of the record's four canvases at the
                  Flax scale within 1e-3 of the JAX float32 logits
                  (recognizer_logits.npz); run_ocr behind the full77f
                  detector on the fixture pages: the record's line counts
                  and boxes, texts within 0.5% CER;
16. recognizers_bf16 — each of them at its defaults (bf16): run_batch of
                  32 bench-page lines against four calls of 8 (equal
                  texts), an 8-page bench volume through VolumeRunner
                  against its run_ocr loop (equal boxes, CER at most 0.5%),
                  lines/s, peak memory, the device ms of one (8, 80, 1024)
                  forward beside the base Easter2's, the bf16 CER against
                  the float32 texts (no bar);
17. serve       — bocr-serve (python -m ocr_inference_tpu_torch.cli
                  .serve_cli) as a process with full77f: 8 bench pages as
                  PNG, a JPEG 2000 TIFF, a malformed line, a blank
                  line and a request after it; one response per image,
                  boxes equal and texts within 0.5% CER of a bf16
                  VolumeRunner's on the same files, the JPEG refused by
                  name, the malformed line
                  answered, exit 0; a --max-queue 2 burst sheds with 429;
                  then the serving loop in this process over an os.pipe
                  with Poisson arrivals as bench.py config 6 drives it (24
                  pages at 4 requests/s): p50/p90 latency, pages/s, shed;
18. eval_cli    — bocr-eval (python -m ocr_inference_tpu_torch.cli
                  .evaluate_cli) with full77f in bf16 on the tests' PNG
                  line dataset (eval/synthetic.py line_dataset, two
                  distributions of 24 lines, 120-180 px tall): each mean
                  CER within 0.5 points of the JAX float32 record; a
                  float32 OCREvaluator in this process, TF32 off: each
                  line's CER within 0.005 of the record's;
19. image_formats — the committed JPEG, TIFF and Adam7 PNG files of
                  tests/data/torch_port/images through read_image: shape
                  and sha256 equal to cv2's decode (images.json; None for
                  the 12-bit JPEG and the NeXT page of images/none/), the
                  decode ms of each (damaged CCITT and Deflate strips,
                  old-style LZW, CIE L*a*b*, ThunderScan, RLE-W, SGI Log,
                  arithmetic-coded and lossless JPEG among them), and a
                  4-thread pool's decode rate against one thread; bocr --folder over the page files in float32
                  (TF32 off): texts within 0.5% CER of the JAX float32
                  record, the same line counts and boxes; bocr in bf16 over
                  them, and the per-page loop's pages/s on the files
                  against their PNG copies; bocr-lines (python -m
                  ocr_inference_tpu_torch.cli.infer_lines_cli) in float32:
                  every Parquet row read back equal to the JAX bocr-lines
                  row (contours, boxes and counts exactly). Since the GIF
                  and WebP slice also GIF (interlaced with a local table,
                  an animation with transparency), WebP (lossy, lossless,
                  lossy with ALPH, an animation), Sun raster, colour PFM
                  and Radiance HDR pages and a bench-size lossy WebP, with
                  their decode ms; one file of each suffix bocr --folder
                  does not glob goes through bocr --image, the rest
                  through read_image and run_ocr in this process. Since
                  the AVIF slice also AVIF pages (cv2's default, lossless,
                  monochrome, Pillow 4:4:4 in two tiles, with alpha; the
                  AV1 decoder native/av1.cpp) and a bench-size AVIF with
                  their decode ms; the AVIF page through bocr --image at
                  0.0 CER with equal boxes against the JAX record. Since
                  the slice of screen-content tools and loop restoration
                  three more AVIF pages (the clean page at Pillow's
                  default, the other at cv2 speed 6, the scanned page at
                  Pillow speed 2) with av1.cpp's counts of the palettes,
                  intra block copies and restoration units they use, the
                  first of them through bocr --image; since the slice of
                  depths and grain four pages of 10 and 12 bits, 4:2:2
                  and film grain; since the slice of grids and sequences
                  a 2x2 grid page and a sequence's first frame (each
                  through bocr --image, with its cells or frames and
                  source) and a lossless JPEG with subsampled components;
20. train_rec_f32 — Easter2 from full77f, five float32 train steps (TF32
                  off) on recognizer_batch batches of full77f's recipe (32
                  canvases of 80x512, binarized on the card by
                  binarize_lines) against the JAX CPU record
                  tests/data/torch_port/training.json: each batch's sha256
                  equal, each loss within REC_BARS of the float32 run and
                  each parameter leaf's change norm as close to the
                  float64 run as the float32 run, or within REC_BARS;
                  the weights written with save_params,
                  read back byte-equal, and run_ocr on the fixture pages;
21. train_seg_f32 — the full77f UNet, three float32 steps on
                  segmentation_batch batches (8 tiles of 512^2, binarized
                  by binarize_tiles) against the same record, SEG_BARS;
22. train_cli   — bocr-train (fine-tuning full77f, float32, batch 32, 20
                  steps) on a 64-line PNG dataset and bocr-train-seg (10
                  steps) on four pages with their line masks, as
                  processes; their weights load into build_pipeline;
                  lines/s and tiles/s;
23. selftrain   — bocr-selftrain in this process: from scratch (40
                  recognizer and 20 UNet steps, 4 eval pages, an order-2
                  LM), then fine-tuning full77f's recognizer 5 steps with
                  full77f's UNet (its eval pages detect and read lines),
                  then --weights on that directory: EVAL.json with the JAX
                  keys each time, and eval-only the fine-tuned run's CERs
                  page by page and its line count;
24. train_rates — device ms of one Easter2 step (32 x 80x512) and one UNet
                  step (8 x 512^2), float32 and bf16, host ms of one
                  batch of each, peak memory;
25. onnx_export — full77f's UNet and Easter2 through the port's
                  torch_export (opset 17, TorchScript exporter, dynamic
                  batch and recognizer width), BatchNorm folded and not:
                  bytes, nodes, op set, export, parse and load seconds;
26. onnx_page_f32 — build_pipeline on the .onnx configs, float32, TF32
                  off: both engines hold an OnnxModule; the fixture pages
                  against the JAX float32 record of an ONNX detector
                  (tests/data/torch_port/onnx.json: no opening) within
                  0.5% CER, equal line counts and boxes; those pages and
                  two bench.py config 4 pages against the port's msgpack
                  float32 path with the same detector settings: every
                  strip's logits within 1e-3, equal texts and boxes; page
                  ms of both, the executor's host ms a call and a node;
27. onnx_volume — 24 config 4 pages through VolumeRunner from the .onnx
                  configs, float32 and then under OCR_ONNX_BF16=1: the
                  float32 texts within 0.5% CER of its run_ocr loop's,
                  equal boxes, bf16 within 2% of float32; pages/s, stage
                  medians, the executor's host ms, peak memory;
28. onnx_weights — the fold-free graphs transplanted into fresh modules
                  (leaves within 1e-6 of full77f's msgpack), the folded
                  ones (logits within 1e-3), write_back of a fold-free
                  graph (initializers bit-equal to the export), an fp16
                  Easter2 export through the executor (within 3e-2 of
                  the .half() module);
29. onnx_cli    — bocr on a model directory naming the .onnx files, in
                  this process: texts equal float32 run_ocr's;
                  compat.ort.InferenceSession's outputs equal the
                  executor's;
30. public_api  — the public surface on a bench.py config 4 page (seed
                  42): ops.binarize at 51/13 (the tile kernel) equal to
                  the plain version bit for bit, gaussian_blur_gray (ksize
                  51, 15) within 1e-4 of the CPU's, adaptive_threshold_
                  gaussian at (31, 10), dilate_rect and erode_rect equal
                  to the CPU's; the three examples' flows at full width
                  through the port's names (line_inference.py: full77f's
                  UNet in float32, predict_many_async, get_contours,
                  create_preview_image, write_png; demo_ocr.py:
                  import_local_model, build_pipeline, an eval-mode page to
                  Parquet, VolumeRunner with the text and PageXML
                  exporters, texts equal bf16 run_ocr's; modern_layout.py:
                  the seeded DeepLabV3+ behind
                  ModernBookFormatLayoutDetection, create_layout_preview);
                  a trace_profile of one bf16 run_ocr of the page holding
                  both binarize kernels' device events: its ten device ops
                  with the most time and the card's busy share over the
                  page's window;
31. mesh        — more than one device: distributed_init into a
                  world-size-1 nccl group on localhost and one all_reduce;
                  float32 page OCR (TF32 off) of the fixture pages and a
                  bench.py config 4 page on a mesh over every visible
                  card, a 2x1 mesh and a 1x2 mesh (the recognizer head
                  split over its model axis) that repeat cuda:0, texts
                  and boxes equal to --mesh off, page ms of each; one
                  full77f Easter2 float32 step (32 canvases of its
                  recipe) on a 2x1 mesh against mesh=None: loss and
                  statistics at the CPU tests' bars, each gradient leaf
                  within a float32 limit that a planted fault (one
                  group's gradient dropped) exceeds; bocr --mesh auto on
                  the fixture pages as PNG (the CLI's mesh over every
                  card, 1x1 on one card), texts equal to --mesh off; a
                  --mesh of one card more than the machine has refused
                  naming the count; the device count.

Kernel launch and recheck counts are zeroed just before each OCR or
training path is driven (phases 3-23, 26, 27, 29, 30 and 31) and read just
after it. Then a ``kernels`` JSON line (per kernel: launches over the main
paths, phases 5, 6, 8, 11, 13, 14, 16, 17, 18, 19's bf16 bocr and
bocr-lines, 20, 21, 23, 26, 27, 29, 30's ops.binarize and examples, and
31's mesh page OCR, mesh step and bocr --mesh auto, and by path,
the shapes each path launched, rechecked pixels, time, plain time, bound
and share of the bound at the largest shape the main paths launched), the
card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failed phase ends the script with a
non-zero code and without that line. Without CUDA it exits non-zero at
once. Imports torch, numpy and the port; nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import re
import socket
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


def full77f_config(input_width: int = 3000):
    from ocr_inference_tpu_torch.core.data import CharsetEncoder, OCRModelConfig

    meta = json.loads((WEIGHTS / "recognizer.msgpack.json").read_text())
    return OCRModelConfig(
        model_file=str(WEIGHTS / "recognizer.onnx"), architecture="Easter2",
        input_width=input_width, input_height=80, input_layer="input",
        output_layer="output", squeeze_channel=True, swap_hw=False,
        encoder=CharsetEncoder.WYLIE, charset=list(meta["charset"]),
        add_blank=True, version="full77f",
    )


def full77f_pipeline(dtype: torch.dtype, input_width: int = 3000,
                     kenlm_config=None, line_config=None,
                     allow_random: bool = False, seed: int = 0,
                     ocr_config=None, mesh=None):
    from ocr_inference_tpu_torch.core.data import LineDetectionConfig
    from ocr_inference_tpu_torch.pipeline import build_pipeline

    line = line_config or LineDetectionConfig(
        checkpoint="", onnx_file=str(WEIGHTS / "lines.onnx"),
        architecture="unet", patch_size=512, classes=["line"],
    )
    return build_pipeline(ocr_config or full77f_config(input_width), line,
                          kenlm_config=kenlm_config, dtype=dtype,
                          allow_random=allow_random, seed=seed, mesh=mesh)


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
              lambda: native.build_library("png.cpp"),
              lambda: native.build_library("jpeg.cpp"),
              lambda: native.build_library("tiff.cpp"),
              lambda: native.build_library("jp2.cpp"),
              lambda: native.build_library("bmp.cpp"),
              lambda: native.build_library("av1.cpp"))
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


LINE_HEIGHTS = (23, 80, 81, 161, 300)
LINE_WIDTHS = (37, 1024, 2999)


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
    # whole line images of their own height, as the evaluator sends them
    for h in LINE_HEIGHTS:
        for w in LINE_WIDTHS:
            cases[f"lines_1x{h}x{w}"] = (*lines, torch.randint(
                0, 256, (1, h, w), dtype=torch.uint8, generator=gen))
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


# the curved volume's pages: few enough to keep the script well inside its
# time limit
DEWARP_PAGES = 12


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
        jpeg.write_bytes(jpeg2000_tiff())
        proc, s = script("--model", str(model), "--folder", str(page_dir),
                         "--output", str(root / "refused"))
        runs["jpeg"] = {"rc": proc.returncode, "s": s,
                        "stderr": proc.stderr[-400:]}
        checks["jpeg2000_tiff_refused_by_name"] = (
            proc.returncode != 0
            and "scan.jpg (JPEG 2000 in TIFF" in proc.stderr
            and not (root / "refused").exists())
    return {"_ok": all(checks.values()), "checks": checks, "runs": runs,
            "texts_equal": same,
            "launches": results["launches"]["cli"],
            "gpu": gpu_name_and_limit()}


# -- the other recognizers, the serving entry point and the eval CLI --

RECOGNIZERS = ("Easter2-Attention", "Easter2-Vit", "CRNN")
REC_VOLUME_PAGES = 8
FORWARD_SHAPE = (8, 80, 1024)
SERVE_PAGES, STREAM_PAGES, STREAM_RPS = 8, 24, 4.0


def recognizer_record() -> tuple[dict, dict]:
    """tests/data/torch_port/recognizers.json and the logits beside it."""
    record = json.loads((FIXTURE / "recognizers.json").read_text(
        encoding="utf-8"))
    with np.load(FIXTURE / "recognizer_logits.npz") as npz:
        return record, {k: npz[k] for k in npz.files}


def seeded_pipeline(arch: str, dtype: torch.dtype, seed: int):
    """full77f's line detector and a recognizer of ``arch`` at full width
    with the seeded weights of ``seed`` (build_pipeline's allow_random)."""
    ocr = full77f_config()
    ocr.architecture, ocr.model_file = arch, ""
    return full77f_pipeline(dtype, ocr_config=ocr, allow_random=True,
                            seed=seed)


def joined_cer(got: list[list[str]], want: list[list[str]]) -> float:
    """Pooled CER of pages' texts, each page's lines joined by spaces."""
    from ocr_inference_tpu_torch.eval.cer import cer

    return cer([" ".join(t) for t in got], [" ".join(t) for t in want])


def forward_ms(model, x: torch.Tensor, iters: int = 10) -> float:
    """Device ms of one forward: ``iters`` calls queued behind a spin
    kernel that holds the stream until all are queued, between CUDA
    events, so the host's launch pace does not count."""
    with torch.inference_mode():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)  # ~0.1 s at 1.98 GHz
        start.record()
        for _ in range(iters):
            model(x)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@phase("recognizers_f32")
def recognizers_f32(results: dict):
    """Each other recognizer at full width with the record's seeded
    weights, float32, TF32 off: logits of the record's canvases at the
    Flax scale against the JAX float32 logits (bar 1e-3); run_ocr on the
    fixture pages against the JAX float32 record (line counts and boxes
    equal, texts within 0.5% CER)."""
    record, logits = recognizer_record()
    pages, _ = fixture()
    x = torch.from_numpy(logits["canvases"]).cuda().float() / 127.5 - 1.0
    texts, out, ok = {}, {}, True
    for arch in RECOGNIZERS:
        pipe = seeded_pipeline(arch, torch.float32, record["seed"])
        with no_tf32(), torch.inference_mode():
            got = pipe.ocr_inference.model(x) / record["head_gain"]
        diff = float(np.abs(got.cpu().numpy() - logits[arch]).max())
        want_pages = record["architectures"][arch]["pages"]
        per_page = {}
        path = f"recognizers_f32/{arch}"
        with no_tf32(), counted_path(results, path):
            for (name, img, _), want in zip(pages, want_pages):
                page_texts, lines, _ = run_page(pipe, img)
                texts[(arch, name)] = page_texts
                boxes = [list(ln.bbox.as_tuple()) for ln in lines]
                page_cer = joined_cer([page_texts], [want["jax_f32_texts"]])
                same = (name == want["name"]
                        and len(page_texts) == len(want["jax_f32_texts"])
                        and boxes == want["jax_f32_boxes"]
                        and page_cer <= 0.005)
                ok &= same
                per_page[name] = {"lines": len(page_texts), "ok": same,
                                  "cer_vs_jax_f32": page_cer,
                                  "texts_identical":
                                      page_texts == want["jax_f32_texts"]}
        ok &= diff <= 1e-3
        out[arch] = {"logits_max_abs_diff": diff,
                     "logits_shape": list(got.shape),
                     "logits_max_abs": float(np.abs(logits[arch]).max()),
                     "pages": per_page,
                     "launches": results["launches"][path]}
        del pipe
    results["recognizer_f32_texts"] = texts
    return {"_ok": ok, "architectures": out, "gpu": gpu_name_and_limit()}


@phase("recognizers_bf16")
def recognizers_bf16(results: dict):
    """Each other recognizer at its defaults (bf16): run_batch of 32 lines
    against four calls of 8 (equal texts); an 8-page bench volume through
    VolumeRunner against its run_ocr loop (equal boxes, CER at most
    0.5%); the device ms of one (8, 80, 1024) forward beside the base
    Easter2's; lines/s, peak memory; bf16 texts on the fixture pages
    against the float32 ones (no bar: seeded weights read no text)."""
    from ocr_inference_tpu_torch.core.data import Encoding, OpStatus
    from ocr_inference_tpu_torch.pipeline import PipelineObserver, VolumeRunner

    record, _ = recognizer_record()
    pages, _ = fixture()
    bench = bench_volume(REC_VOLUME_PAGES, seed=43)
    entries = [(f"rec{i:03d}", img) for i, img in enumerate(bench)]

    class Strips(PipelineObserver):
        def stage_end(self, stage, payload):
            if stage == "extract_lines":
                strips.extend(s for s in payload[1] if s.size)

    strips: list[np.ndarray] = []
    base = full77f_pipeline(torch.bfloat16)
    for _, img in entries:
        base.run_ocr(img, observer=Strips())
        if len(strips) >= 32:
            break
    strips = strips[:32]
    gen = torch.Generator().manual_seed(2)
    x = (torch.randint(0, 2, FORWARD_SHAPE, generator=gen).float() * 2
         - 1).cuda()
    forward = {"Easter2": forward_ms(base.ocr_inference.model, x)}
    del base

    out, ok = {}, len(strips) == 32
    for arch in RECOGNIZERS:
        pipe = seeded_pipeline(arch, torch.bfloat16, record["seed"])
        eng = pipe.ocr_inference
        one = eng.run_batch(strips)
        four = [t for i in range(0, 32, 8) for t in eng.run_batch(
            strips[i: i + 8])]
        VolumeRunner(pipe).run(entries[:2], target_encoding=Encoding.WYLIE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        path = f"recognizers_bf16/{arch}"
        with counted_path(results, path):
            t0 = time.perf_counter()
            records = VolumeRunner(pipe).run(entries,
                                             target_encoding=Encoding.WYLIE)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        plain, plain_s = plain_reads(pipe, entries)
        ok_pages = [r for r in records if r.status == OpStatus.SUCCESS]
        volume_cer = joined_cer(
            [[ln.text for ln in r.ocr_lines] for r in ok_pages],
            [plain.get(r.name, ([], []))[1] for r in ok_pages])
        bf16_texts = [run_page(pipe, img)[0] for _, img, _ in pages]
        f32_texts = [results["recognizer_f32_texts"][(arch, name)]
                     for name, _, _ in pages]
        forward[arch] = forward_ms(eng.model, x)
        n_lines = sum(len(r.lines) for r in ok_pages)
        checks = {
            "batch_invariant_32_vs_4x8": one == four,
            "all_pages_read": len(ok_pages) == len(entries),
            "boxes_equal_run_ocr": all(
                r.name in plain
                and [ln.bbox.as_tuple() for ln in r.lines] == plain[r.name][0]
                for r in ok_pages),
            "cer_vs_run_ocr_le_0.5pct": volume_cer <= 0.005,
        }
        ok &= all(checks.values())
        out[arch] = {
            "checks": checks,
            "batch_32_vs_4x8_differing_lines": sum(
                a != b for a, b in zip(one, four)),
            "volume": {"seconds": dt, "pages_per_s": len(ok_pages) / dt,
                       "lines_per_s": n_lines / dt, "lines": n_lines},
            "run_ocr_loop": {"seconds": plain_s,
                             "pages_per_s": len(plain) / plain_s},
            "cer_vs_run_ocr": volume_cer,
            "bf16_cer_vs_f32_fixture_pages": joined_cer(bf16_texts,
                                                        f32_texts),
            "peak_memory_gib": peak_gib,
            "launches": results["launches"][path],
        }
        del pipe, eng
    return {"_ok": ok, "architectures": out,
            "forward_8x80x1024_device_ms": forward,
            "gpu": gpu_name_and_limit()}


def serve_subprocess(args: list[str], requests: list[str]) -> tuple:
    """bocr-serve as a process fed ``requests`` on stdin -> (completed
    process, its JSON lines, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ocr_inference_tpu_torch.cli.serve_cli",
         *args], input="\n".join(requests) + "\n", capture_output=True,
        text=True, cwd=REPO, timeout=600)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.strip()]
    return proc, lines, time.perf_counter() - t0


def poisson_stream(pipe, paths: list[str], results: dict) -> dict:
    """The serving loop in this process over an os.pipe, as bench.py config
    6 drives it (bench.py:441-540): a feeder thread writes one request per
    page at exponential gaps (STREAM_RPS a second, numpy seed 123); each
    page's latency runs from its request's write to its emit."""
    from ocr_inference_tpu_torch.cli.serve_cli import (
        _LineReader, load_page, serve_loop,
    )
    from ocr_inference_tpu_torch.core.data import Encoding
    from ocr_inference_tpu_torch.pipeline import VolumeRunner

    runner = VolumeRunner(pipe, window_pages=4)
    arrival, done, shed, failed = {}, {}, [], []
    gaps = np.random.default_rng(123).exponential(1.0 / STREAM_RPS,
                                                  len(paths))
    r_fd, w_fd = os.pipe()

    def feeder():
        try:
            for path, gap in zip(paths, gaps):
                time.sleep(gap)
                arrival[path] = time.perf_counter()
                os.write(w_fd, (json.dumps({"image": path}) + "\n").encode())
        finally:
            os.close(w_fd)

    def emit(rec):
        done[rec.name] = time.perf_counter()
        if rec.status.name != "SUCCESS":
            failed.append(rec.name)

    thread = threading.Thread(target=feeder, daemon=True)
    with counted_path(results, "serve"):
        thread.start()
        serve_loop(runner, _LineReader(fd=r_fd), load_page, emit,
                   lambda obj: shed.append(obj), encoding=Encoding.WYLIE)
        thread.join(timeout=60)
    os.close(r_fd)
    lat = sorted((done[p] - arrival[p]) * 1e3 for p in done)
    span = max(done.values()) - min(arrival.values())
    return {"pages": len(paths), "served": len(done), "failed": len(failed),
            "shed": len(shed), "rate_rps": STREAM_RPS,
            "latency_ms_p50": lat[len(lat) // 2],
            "latency_ms_p90": lat[int(0.9 * (len(lat) - 1))],
            "pages_per_s": len(done) / span,
            "_ok": len(done) + len(shed) == len(paths) and not failed
            and not thread.is_alive()}


@phase("serve")
def serve_phase(results: dict):
    """bocr-serve (python -m ocr_inference_tpu_torch.cli.serve_cli) as a
    process with full77f: 8 bench pages as PNG, a JPEG, a malformed line,
    then a blank line (a request after it goes unanswered); one response
    per image, texts within 0.5% CER of a bf16 VolumeRunner's on the same
    files in this process and boxes equal, the JPEG refused by name, the
    malformed line answered with an error, exit 0. A --max-queue 2 burst
    sheds with code 429. Then the serving loop in this process under a
    Poisson stream (no bar)."""
    from ocr_inference_tpu_torch.cli.serve_cli import load_page
    from ocr_inference_tpu_torch.core.data import Encoding
    from ocr_inference_tpu_torch.io.artifacts import write_png
    from ocr_inference_tpu_torch.pipeline import VolumeRunner

    checks, runs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        model, lines = write_model_dirs(root)
        paths = []
        for i, img in enumerate(bench_volume(SERVE_PAGES, seed=44)):
            paths.append(str(root / f"page{i:02d}.png"))
            write_png(paths[-1], img[..., ::-1])
        jpeg = root / "scan.jpg"
        jpeg.write_bytes(jpeg2000_tiff())
        args = ["--model", str(model), "--line-model",
                str(lines / "config.json"), "--encoding", "wylie"]
        requests = ([json.dumps({"image": p}) for p in paths[:4]]
                    + ["{not json"]
                    + [json.dumps({"images": paths[4:] + [str(jpeg)]})]
                    + ["", json.dumps({"image": paths[0]})])
        proc, answers, s = serve_subprocess(args, requests)
        runs["session"] = {"rc": proc.returncode, "s": s,
                           "responses": len(answers),
                           "stderr": proc.stderr[-400:]}

        pipe = full77f_pipeline(torch.bfloat16)
        want = {r.name: r for r in VolumeRunner(pipe, window_pages=4).run(
            [(p, load_page(p)) for p in paths],
            target_encoding=Encoding.WYLIE)}
        pages = {a["image"]: a for a in answers if a.get("image") in want}
        checks["exit_0"] = proc.returncode == 0
        checks["one_response_per_image"] = (
            len(answers) == len(paths) + 2
            and sorted(pages) == sorted(paths))
        checks["boxes_equal_volume_runner"] = all(
            a["status"] == "success"
            and [ln["bbox"] for ln in a["lines"]]
            == [list(ln.bbox.as_tuple()) for ln in want[p].lines]
            for p, a in pages.items())
        served_cer = joined_cer(
            [[ln["text"] for ln in pages[p]["lines"]] for p in paths
             if p in pages],
            [[ln.text for ln in want[p].ocr_lines] for p in paths
             if p in pages])
        checks["cer_vs_volume_runner_le_0.5pct"] = served_cer <= 0.005
        refused = [a for a in answers if a.get("image") == str(jpeg)]
        checks["jpeg2000_tiff_refused_by_name"] = (
            len(refused) == 1 and refused[0]["status"] == "failed"
            and "JPEG 2000 in TIFF" in refused[0]["error"])
        checks["malformed_line_answered"] = any(
            "bad request" in a.get("error", "") for a in answers)

        proc, burst, s = serve_subprocess(
            args + ["--max-queue", "2"],
            [json.dumps({"image": p}) for p in paths[:6]])
        shed = [a for a in burst if a.get("status") == "shed"]
        runs["burst"] = {"rc": proc.returncode, "s": s,
                         "responses": len(burst), "shed": len(shed)}
        checks["burst_sheds_429"] = (
            proc.returncode == 0 and len(burst) == 6 and len(shed) >= 1
            and all(a["code"] == 429 for a in shed))

        stream_paths = []
        for i in range(STREAM_PAGES):
            link = root / f"req_{i:04d}.png"
            os.symlink(paths[i % len(paths)], link)
            stream_paths.append(str(link))
        stream = poisson_stream(pipe, stream_paths, results)
        checks["stream_served"] = stream.pop("_ok")
    return {"_ok": all(checks.values()), "checks": checks, "runs": runs,
            "cer_vs_volume_runner": served_cer, "stream": stream,
            "launches": results["launches"]["serve"],
            "gpu": gpu_name_and_limit()}


@phase("eval_cli")
def eval_cli_phase(results: dict):
    """bocr-eval (python -m ocr_inference_tpu_torch.cli.evaluate_cli) with
    full77f in bf16 on the tests' PNG line dataset: each distribution's
    mean CER within 0.5 points of the JAX float32 record; then a float32
    OCREvaluator in this process (TF32 off): each line's CER within 0.005
    of the record's."""
    from ocr_inference_tpu_torch.cli.evaluate_cli import collect_distributions
    from ocr_inference_tpu_torch.eval.evaluator import OCREvaluator
    from ocr_inference_tpu_torch.eval.synthetic import (
        line_dataset, load_glyphs, write_line_dataset,
    )

    want = recognizer_record()[0]["eval_cli"]
    glyphs, charset = load_glyphs(FIXTURE / "pages.npz")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        model, _ = write_model_dirs(root)
        data = root / "data"
        write_line_dataset(data, line_dataset(glyphs, charset, want["seed"],
                                              want["per_distribution"]))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ocr_inference_tpu_torch.cli.evaluate_cli",
             "--model", str(model), "--dataset", str(data), "--output",
             str(root / "out")], capture_output=True, text=True, cwd=REPO,
            timeout=600)
        cli_s = time.perf_counter() - t0
        scores = (json.loads((root / "out" / "Easter2.json").read_text())
                  if proc.returncode == 0 else {})
        mean_diff = {d: abs(scores[d]["mean_cer"] - w["mean_cer"])
                     for d, w in want["scores"].items() if d in scores}

        with no_tf32(), counted_path(results, "eval_cli"):
            evaluator = OCREvaluator(str(model / "model_config.json"),
                                     dtype=torch.float32)
            per_line = {
                dist: evaluator.evaluate_distribution(dist, images,
                                                      labels).cer_scores
                for dist, (images, labels)
                in collect_distributions(str(data)).items()}
    line_diff = max(abs(per_line.get(d, {}).get(n, float("inf")) - c)
                    for d, w in want["scores"].items()
                    for n, c in w["per_image"].items())
    checks = {
        "cli_exit_0": proc.returncode == 0,
        "bf16_mean_cer_within_0.5_points": len(mean_diff) == len(
            want["scores"]) and max(mean_diff.values()) <= 0.005,
        "f32_line_cer_within_0.005": line_diff <= 0.005,
    }
    return {"_ok": all(checks.values()), "checks": checks,
            "bf16_mean_cer": {d: r["mean_cer"] for d, r in scores.items()},
            "jax_f32_mean_cer": {d: w["mean_cer"]
                                 for d, w in want["scores"].items()},
            "bf16_mean_cer_diff": mean_diff,
            "f32_max_line_cer_diff": line_diff, "cli_s": cli_s,
            "stderr": proc.stderr[-400:] if proc.returncode else "",
            "launches": results["launches"]["eval_cli"],
            "gpu": gpu_name_and_limit()}


# -- the image readers, bocr on JPEG/TIFF pages and bocr-lines --

IMAGE_DIR = FIXTURE / "images"
# the page files of damaged strips and of the TIFF and JPEG variants
# once refused by name (tests/make_torch_port_fixture.py
# damaged_and_variant_files)
REPAIRED_AND_VARIANT_PAGES = (
    "skew_2deg_g4_damaged.tif", "clean_a_g3_cut.tif",
    "clean_b_deflate_badcheck.tif", "clean_a_oldlzw.tif",
    "skew_2deg_lab.tif", "clean_a_arith_prog.jpg", "clean_b_lossless.jpg",
    "clean_b_thunder.tif", "skew_2deg_rlew.tif", "clean_a_logl.tif",
    "skew_2deg_logluv.tif")
# the formats of the GIF and WebP slice
NEWEST_FORMATS = (".gif", ".webp", ".ras", ".pfm", ".hdr")
# the format of the AVIF slice
AVIF_FORMATS = (".avif",)
# the AVIF pages of the slice of screen-content tools and loop
# restoration, and the tools av1.cpp's counts must show in each
TOOL_AVIF_PAGES = {"clean_a_default.avif": ("palette_y", "intrabc"),
                   "clean_b_speed6.avif": ("palette_y",),
                   "skew_2deg_speed2.avif": ("self_guided",)}
# the AVIF pages of the slice of 10 and 12 bits, 4:2:2 and film grain:
# (bit depth, subsampling, grain applied) each must show; the first and
# the last go through bocr --image
DEPTH_AVIF_PAGES = {"clean_a_10bit.avif": (10, "4:2:0", 0),
                    "skew_2deg_12bit.avif": (12, "4:2:0", 0),
                    "clean_b_422.avif": (8, "4:2:2", 0),
                    "skew_2deg_grain.avif": (8, "4:2:0", 1)}
BOCR_IMAGE_DEPTH_AVIF_PAGES = ("clean_a_10bit.avif", "skew_2deg_grain.avif")
# the pages of the slice of AVIF grids and sequences, each through bocr
# --image: (source, colour cells or frames, output width and height, alpha)
GRID_SEQUENCE_AVIF_PAGES = {"clean_a_grid.avif": ("item", 4, (1024, 576),
                                                  False),
                            "skew_2deg_seq.avif": ("track", 3, (1024, 528),
                                                   True)}
# and its lossless JPEG page with subsampled components (bocr --folder)
LOSSLESS_SUBSAMPLED_PAGE = "clean_a_lossless_h2v2.jpg"
# the HTJ2K pages (JPEG 2000 Part 15 HT code-blocks) of the slice that
# reads them: a JPH file (5/3, cleanup passes) and a raw codestream (9/7,
# SigProp and MagRef, tiles, two layers); each goes through bocr --image
HT_PAGES = ("clean_a_ht53.jph", "skew_2deg_ht97.j2k")
# the layered AVIF page (a key frame, then two AV1 inter frames) and the
# inter frames each layered file holds
LAYERED_AVIF_PAGES = {"clean_a_layered.avif": 2}
LAYERED_BENCH_AVIF = ("bench_cfg4_layered.avif", 1)


def avif_structure(path: Path) -> dict:
    """What libavif reads of an AVIF file, as io/images.py finds it: the
    source (primary item or track), the colour cells (a grid's) or the
    track's frames, the output size and whether an alpha image is
    decoded."""
    from ocr_inference_tpu_torch.io.images import _avif_container

    c = _avif_container(path.read_bytes())
    return {"source": c["source"],
            "cells": len(c["cells"]), "frames": c["frames"],
            "grid": None if c["grid"] is None else list(c["grid"]),
            "output": list(c["ispe"]), "alpha": c["alpha"] is not None}


def av1_tool_counts(path: Path) -> dict:
    """av1.cpp's counts of the tools an AVIF file's primary item uses
    (palette Y and UV blocks, intra block copies, Wiener and self-guided
    units, the film grain applied: its Y, Cb and Cr scaling points, chroma
    from luma, overlap, clip, AR lag; native.av1_decode_counts), with the
    frame's bit depth and subsampling; for a layered item the inter
    tools of native.AV1_INTER_COUNTS too)."""
    from ocr_inference_tpu_torch import native
    from ocr_inference_tpu_torch.io.images import _avif_container

    c = _avif_container(path.read_bytes())
    obus, layering = c["cells"][0], c["layering"][0]
    rc, info = native.av1_info(obus, *layering)
    used = {}
    if rc == 0:
        rc, _, used = native.av1_decode_counts(obus, info, *layering)
        used["depth"] = int(info[2])
        used["subsampling"] = "4:0:0" if info[3] else {
            (1, 1): "4:2:0", (1, 0): "4:2:2", (0, 0): "4:4:4"}[
            (int(info[4]), int(info[5]))]
        for k, n in zip(("y", "cb", "cr"), used.pop("grain_points")):
            used[f"grain_{k}_points"] = n
    return {"rc": int(rc), **{k: v for k, v in used.items()
                              if isinstance(v, (int, str))}}


def globbed_by_folder(path: Path) -> bool:
    """Whether bocr --folder and bocr-lines pick a page file up by its name
    (io/dataset.py ImageInferenceDataset.EXTENSIONS, the five of cli.py
    IMAGE_EXTENSIONS); the JPEG 2000, BMP, PNM and PAM page files go
    through bocr --image one at a time, and through bocr-lines under
    ``renamed_page`` names."""
    from ocr_inference_tpu_torch.io.dataset import ImageInferenceDataset

    return path.name.lower().endswith(ImageInferenceDataset.EXTENSIONS)


def renamed_page(name: str) -> str:
    """The name a page file of a format bocr-lines does not glob takes in
    the folder bocr-lines runs over: ``clean_a_97.jp2`` ->
    ``clean_a_97_jp2.png`` (cv2, and the port, read it by content)."""
    stem, ext = name.rsplit(".", 1)
    return f"{stem}_{ext}.png"


def tiny_tiff(compression: int) -> bytes:
    """An 8x8 RGB TIFF of one 192-byte strip (zeros) at offset 122 under
    the given compression; its IFD's 9 entries at 8: width, height, bits,
    compression, photometric RGB, strip offset, samples, rows per strip,
    byte count."""
    import struct

    entries = [(256, 3, 8), (257, 3, 8), (258, 3, 8), (259, 3, compression),
               (262, 3, 2), (273, 4, 122), (277, 3, 3), (278, 3, 8),
               (279, 4, 192)]
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHI", tag, typ, 1) + struct.pack(
            "<HH" if typ == 3 else "<I", *((value, 0) if typ == 3
                                           else (value,)))
        for tag, typ, value in entries) + struct.pack("<I", 0)
    return b"II*\x00" + struct.pack("<I", 8) + ifd + bytes(192)


def jpeg2000_tiff() -> bytes:
    """A TIFF of compression 34712 (JPEG 2000, which libtiff does not
    know; cv2 gives an all-zero page): read_image refuses it by name."""
    return tiny_tiff(34712)


def decode_ms(path: Path, repeats: int = 5) -> float:
    """Median host ms of read_image on one file."""
    from ocr_inference_tpu_torch.io.images import read_image

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        read_image(path)
        times.append((time.perf_counter() - t0) * 1e3)
    return _median(times)


def full_page_copies(root: Path) -> dict:
    """A committed page (pages/clean_a.jpg, 1024x576 once decoded) written
    here in full as a 24-bit BMP, a binary PGM (P5) and PPM (P6), a 16-bit
    PPM, a PAM (P7, GRAYSCALE and RGB) and an ASCII PPM (P3), whose
    committed files are strips of 128-144 rows: each held against the
    samples it holds (a gray file against channel 1 of the page, the RGB
    PAM with red and blue swapped, as cv2 reads it), with its decode ms."""
    import struct

    from ocr_inference_tpu_torch.io.images import read_image

    rgb = read_image(IMAGE_DIR / "pages" / "clean_a.jpg")
    h, w, _ = rgb.shape
    gray = rgb[..., 1]
    gray3 = np.repeat(gray[..., None], 3, axis=2)
    size = b"%d %d\n" % (w, h)
    bgr_rows = rgb[::-1, :, ::-1].tobytes()  # bottom-up, w * 3 % 4 == 0
    bmp = b"BM" + struct.pack("<IHHI", 54 + len(bgr_rows), 0, 0, 54) + \
        struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(bgr_rows), 2835,
                    2835, 0, 0) + bgr_rows

    def pam(depth: int, tupltype: bytes, samples: np.ndarray) -> bytes:
        return b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL 255\nTUPLTYPE " \
            b"%s\nENDHDR\n" % (w, h, depth, tupltype) + samples.tobytes()

    ascii_rows = b"\n".join(b" ".join(b"%d" % v for v in row)
                            for row in rgb.reshape(h, -1).tolist())
    copies = {
        "bmp_24bit.bmp": (bmp, rgb),
        "pgm_p5.pgm": (b"P5\n" + size + b"255\n" + gray.tobytes(), gray3),
        "ppm_p6.ppm": (b"P6\n" + size + b"255\n" + rgb.tobytes(), rgb),
        "ppm_p6_16bit.ppm": (b"P6\n" + size + b"65535\n" + (
            rgb.astype(">u2") * 257).tobytes(), rgb),
        "pam_gray.pam": (pam(1, b"GRAYSCALE", gray), gray3),
        "pam_rgb.pam": (pam(3, b"RGB", rgb), rgb[..., ::-1]),
        "ppm_p3_ascii.ppm": (b"P3\n" + size + b"255\n" + ascii_rows + b"\n",
                             rgb),
    }
    out = {}
    for name, (data, want) in copies.items():
        path = root / name
        path.write_bytes(data)
        got = read_image(path)
        out[name] = {"bytes": len(data), "shape": list(want.shape),
                     "equal_source": got is not None
                     and np.array_equal(got, want),
                     "decode_ms": decode_ms(path, repeats=3)}
    return out


def pool_decode(paths: list[Path], workers: int) -> float:
    """Seconds to decode ``paths`` through a thread pool of ``workers``, as
    io/dataset.py's prefetch does."""
    from concurrent.futures import ThreadPoolExecutor

    from ocr_inference_tpu_torch.io.images import read_image

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(read_image, paths))
    return time.perf_counter() - t0


def page_loop_s(pipe, paths: list[Path]) -> float:
    """Seconds of read_image + run_ocr over the pages (bocr's per-page
    work without the model load), after one warm pass."""
    from ocr_inference_tpu_torch.core.data import Encoding
    from ocr_inference_tpu_torch.io.images import read_image

    for warm in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for path in paths:
            pipe.run_ocr(read_image(path), merge_lines=False,
                         target_encoding=Encoding.WYLIE)
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def unreadable_page_skipped(cli, args: list[str], root: Path,
                            page: Path) -> dict:
    """bocr --folder in float32 over a readable page and an LZMA TIFF
    (cv2's libtiff has no LZMA, so cv2.imread gives None): rc 0, ``Failed
    to load image`` printed for the TIFF, the page's text written."""
    import io

    folder = root / "lzma"
    folder.mkdir()
    (folder / page.name).write_bytes(page.read_bytes())
    lzma = folder / "unreadable_lzma.tif"
    lzma.write_bytes(tiny_tiff(34925))  # LZMA
    printed = io.StringIO()
    t0 = time.perf_counter()
    with no_tf32(), contextlib.redirect_stdout(printed):
        rc = cli.main(args + ["--folder", str(folder), "--output",
                              str(root / "lzma_out"), "--dtype", "float32"])
    out = printed.getvalue()
    text = root / "lzma_out" / f"{page.stem}.txt"
    skipped = f"Failed to load image: {lzma}" in out
    return {"rc": rc, "s": time.perf_counter() - t0, "skipped": skipped,
            "page_read": text.is_file() and bool(
                text.read_text(encoding="utf-8").strip()),
            "ok": rc == 0 and skipped and text.is_file()}


@phase("image_formats")
def image_formats(results: dict):
    """The committed JPEG, TIFF and Adam7 PNG files of tests/data/
    torch_port/images through read_image against cv2's decode (shape and
    sha256 in images.json) and their decode ms; a thread pool's decode
    rate; bocr --folder over the page files in float32 (TF32 off) against
    the JAX float32 record (CER at most 0.5%, the same line count and
    boxes); bocr in bf16 (counted), and the per-page loop's pages/s on the
    files against their PNG copies; bocr-lines in float32 (counted): its
    Parquet files, read back with read_result_parquet, equal the JAX
    bocr-lines rows exactly. The files cover damaged CCITT and Deflate
    strips, old-style LZW, CIE L*a*b*, ThunderScan, RLE-W and SGI Log
    TIFF, arithmetic-coded and lossless JPEG, CMYK and smoothed
    progressive JPEG, JPEG-in-TIFF, YCbCr, CMYK, planar and BigTIFF beside
    the PNG, JPEG and TIFF of earlier slices, and JPEG 2000 (JP2 and raw
    J2K: 9/7 and 5/3, gray, sYCC, SOP/EPH with tile-parts, BYPASS|RESET|
    TERMALL code-blocks), BMP (RLE8, 24-bit), PGM, 16-bit PPM and PAM,
    which bocr --folder does not glob: each goes through bocr --image, in
    float32 and in bf16 (counted). The files of images/none/ (a 12-bit
    JPEG, a NeXT page, a sYCC 4:2:0 JP2, a cut JP2, a BMP of 4-4-4 masks,
    a cut PGM, a PAM of a mismatched tuple type) give None, as cv2. A
    folder holding an LZMA TIFF (cv2 gives None) beside a readable page:
    bocr exits 0, prints ``Failed to load image`` for it and reads the
    page, as the JAX bocr does. The bench-size JP2's decode ms, and the
    per-page loop's pages/s on the new formats against PNG copies. The GIF
    (interlaced with a local table; an animation with transparency), WebP
    (lossy, lossless, lossy with a lossless ALPH chunk, an animation), Sun
    raster, colour PFM and Radiance HDR pages and images/none/'s cut WebP,
    broken GIF and RLE Sun raster; the bench-size lossy WebP's decode ms,
    and the per-page loop's pages/s on those pages against PNG copies.
    Since that slice one page file of each suffix --folder does not glob
    goes through bocr --image (float32 and bf16), the others through
    read_image and run_ocr in this process: each bocr --image loads the
    model. The AVIF pages (cv2's default, a lossless strip, monochrome, a
    Pillow 4:4:4 page of 128x128 superblocks in two tiles, a page with an
    alpha item) and images/none/'s cut AVIF against the record; the AVIF
    page that goes through bocr --image reads at 0.0 CER with equal boxes
    against the JAX float32 record; the bench-size AVIF's decode ms, and
    the per-page loop's pages/s on the AVIF pages against PNG copies.
    Since the slice of screen-content tools and loop restoration the AVIF
    pages of TOOL_AVIF_PAGES too, each with av1.cpp's counts of the tools
    it uses (each must use the tools TOOL_AVIF_PAGES names), the first of
    them through bocr --image. Since the slice of 10 and 12 bits, 4:2:2
    and film grain the pages of DEPTH_AVIF_PAGES, each with its decode ms,
    bit depth, subsampling and film grain counts (each must show the depth,
    subsampling and grain DEPTH_AVIF_PAGES names), those of
    BOCR_IMAGE_DEPTH_AVIF_PAGES through bocr --image at 0.0 CER with equal
    boxes, and the bench-size 10-bit AVIF's decode ms. Since the slice of
    grids and sequences the pages of GRID_SEQUENCE_AVIF_PAGES (a 2x2 grid
    whose output cuts its last row and column of cells; the first frame of
    a three-frame sequence with an alpha track), each with its decode ms
    and structure (avif_structure: the source, cells or frames, output
    size, alpha), each as GRID_SEQUENCE_AVIF_PAGES says and through bocr
    --image at 0.0 CER with equal boxes; and LOSSLESS_SUBSAMPLED_PAGE, a
    lossless JPEG whose G and B are sampled 2x2, with its decode ms.
    Since the slice of HTJ2K the pages of HT_PAGES, each with its decode
    ms, through bocr --image at 0.0 CER with equal boxes, and the
    bench-size HTJ2K file's decode ms (``bench_ht_decode_ms``) beside the
    Part 1 JP2's. Since the slice of layered AVIF the layered page of
    LAYERED_AVIF_PAGES (a key frame, then two AV1 inter frames) and the
    bench-size layered file equal to the record, each with its inter
    frames and av1.cpp's per-tool counts, the page through bocr --image at
    0.0 CER with equal boxes, and the bench-size layered file's decode ms
    (``bench_layered_decode_ms``) beside the intra AVIF's."""
    from ocr_inference_tpu_torch import native
    from ocr_inference_tpu_torch.cli import cli, infer_lines_cli
    from ocr_inference_tpu_torch.core.data import Encoding
    from ocr_inference_tpu_torch.eval.cer import cer
    from ocr_inference_tpu_torch.io.artifacts import write_png
    from ocr_inference_tpu_torch.io.images import read_image
    from ocr_inference_tpu_torch.io.parquet import read_result_parquet

    record = json.loads((FIXTURE / "images.json").read_text(encoding="utf-8"))
    pages_dir = IMAGE_DIR / "pages"
    page_paths = sorted(pages_dir.iterdir())
    image_pages = [p for p in page_paths if not globbed_by_folder(p)]
    newest = [p for p in image_pages if p.suffix in NEWEST_FORMATS]
    avif_pages = [p for p in image_pages if p.suffix in AVIF_FORMATS]
    older_pages = [p for p in image_pages
                   if p not in newest and p not in avif_pages]
    # one page file of each suffix through bocr --image (each run loads
    # the model), the others through read_image -> run_ocr
    cli_pages = [next(p for p in image_pages if p.suffix == ext)
                 for ext in dict.fromkeys(p.suffix for p in image_pages)]
    # and the first page of TOOL_AVIF_PAGES and those of
    # BOCR_IMAGE_DEPTH_AVIF_PAGES
    cli_pages += [pages_dir / n for n in (next(iter(TOOL_AVIF_PAGES)),
                                          *BOCR_IMAGE_DEPTH_AVIF_PAGES,
                                          *GRID_SEQUENCE_AVIF_PAGES,
                                          *HT_PAGES, *LAYERED_AVIF_PAGES)
                  if pages_dir / n not in cli_pages]
    in_process = [p for p in image_pages if p not in cli_pages]
    checks, files = {}, {}
    for rel, want in record["files"].items():
        img = read_image(IMAGE_DIR / rel)
        files[rel] = {
            "kind": want["kind"], "bytes": want["bytes"],
            "shape": want["shape"],
            # images/none/: cv2 gives None
            "equal_cv2": img is None if want["shape"] is None else
            img is not None and list(img.shape) == want["shape"]
            and sha256(img) == want["sha256"],
            "decode_ms": decode_ms(IMAGE_DIR / rel)}
    checks["every_file_equals_cv2"] = all(f["equal_cv2"]
                                          for f in files.values())
    for rel, f in files.items():
        if rel.endswith(".avif") and f["shape"] is not None:
            f["tools"] = av1_tool_counts(IMAGE_DIR / rel)
    checks["tool_avif_pages_use_their_tools"] = all(
        files.get(f"pages/{name}", {}).get("tools", {}).get(tool, 0) > 0
        for name, tools in TOOL_AVIF_PAGES.items() for tool in tools)
    depth_pages = {}
    for name, (depth, sub, grain) in DEPTH_AVIF_PAGES.items():
        f = files.get(f"pages/{name}", {})
        tools = f.get("tools", {})
        depth_pages[name] = {
            "decode_ms": f.get("decode_ms"), "equal_cv2": f.get("equal_cv2"),
            **{k: v for k, v in tools.items()
               if k in ("depth", "subsampling") or k.startswith("grain")}}
        depth_pages[name]["as_expected"] = (
            tools.get("depth"), tools.get("subsampling"),
            tools.get("grain")) == (depth, sub, grain)
    checks["depth_avif_pages_as_expected"] = all(
        p["as_expected"] and p["equal_cv2"] for p in depth_pages.values())
    grid_pages = {}
    for name, (source, count, size, alpha) in \
            GRID_SEQUENCE_AVIF_PAGES.items():
        f = files.get(f"pages/{name}", {})
        got = avif_structure(pages_dir / name) if f else {}
        grid_pages[name] = {"decode_ms": f.get("decode_ms"),
                            "equal_cv2": f.get("equal_cv2"), **got}
        grid_pages[name]["as_expected"] = bool(got) and (
            got["source"], got["cells"] if source == "item"
            else got["frames"], tuple(got["output"]), got["alpha"]) == (
            source, count, size, alpha)
        print(f"{name}: {grid_pages[name]}", flush=True)
    checks["grid_sequence_avif_pages_as_expected"] = all(
        p["as_expected"] and p["equal_cv2"] for p in grid_pages.values())
    # the layered files: equal to the record, each with its inter frames
    # and av1.cpp's per-tool counts
    layered = {}
    for rel, frames in [(f"pages/{n}", k) for n, k in
                        LAYERED_AVIF_PAGES.items()] + [LAYERED_BENCH_AVIF]:
        f = files.get(rel, {})
        tools = f.get("tools", {})
        layered[rel] = {"decode_ms": f.get("decode_ms"),
                        "equal_cv2": f.get("equal_cv2"),
                        "tools": {k: v for k, v in tools.items() if v and (
                            k in native.AV1_INTER_COUNTS or k == "rc")}}
        layered[rel]["as_expected"] = bool(f.get("equal_cv2")) and \
            tools.get("inter_frames") == frames and tools.get("rc") == 0
        print(f"{rel}: {layered[rel]}", flush=True)
    checks["layered_avif_files_equal_record_with_inter_frames"] = all(
        v["as_expected"] for v in layered.values())
    lossless = files.get(f"pages/{LOSSLESS_SUBSAMPLED_PAGE}", {})
    checks["lossless_subsampled_jpeg_equals_cv2"] = bool(
        lossless.get("equal_cv2"))
    with tempfile.TemporaryDirectory() as tmp:
        copies = full_page_copies(Path(tmp))
    checks["full_page_copies_equal_source"] = all(
        c["equal_source"] for c in copies.values())
    work = page_paths * 4
    pool = {f"workers_{n}_s": pool_decode(work, n) for n in (1, 4)}
    pool["speedup_4_over_1"] = pool["workers_1_s"] / pool["workers_4_s"]
    pool["files"] = len(work)

    per_page, runs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        model, lines = write_model_dirs(root)
        args = ["--model", str(model), "--line-model", str(lines),
                "--encoding", "wylie"]
        t0 = time.perf_counter()
        with no_tf32():
            rc = cli.main(args + ["--folder", str(pages_dir), "--output",
                                  str(root / "f32"), "--dtype", "float32"])
        runs["bocr_f32"] = {"rc": rc, "s": time.perf_counter() - t0}
        ok = rc == 0
        t0 = time.perf_counter()
        with no_tf32():
            for path in cli_pages:
                rc = cli.main(args + ["--image", str(path), "--output",
                                      str(root / "f32"), "--dtype",
                                      "float32"])
                ok &= rc == 0
        runs["bocr_image_f32"] = {"files": len(cli_pages), "ok": ok,
                                  "s": time.perf_counter() - t0}
        f32 = full77f_pipeline(torch.float32)
        with no_tf32():
            for path in page_paths:
                want = record["bocr"][path.name]
                _, payload = f32.run_ocr(read_image(path), merge_lines=False,
                                         target_encoding=Encoding.WYLIE)
                out = root / "f32" / f"{path.stem}.txt"
                if path in in_process:  # read_image -> run_ocr
                    texts = [ln.text for ln in payload[2]]
                else:
                    texts = out.read_text(encoding="utf-8").splitlines() \
                        if out.is_file() else []
                boxes = [list(ln.bbox.as_tuple()) for ln in payload[1]]
                page_cer = cer([" ".join(texts)],
                               [" ".join(want["jax_f32_texts"])])
                same = (len(texts) == len(want["jax_f32_texts"])
                        and boxes == want["jax_f32_boxes"])
                ok &= same and page_cer <= 0.005
                per_page[path.name] = {"lines": len(texts),
                                       "via": "run_ocr" if path in in_process
                                       else "bocr",
                                       "jax_lines": len(want["jax_f32_texts"]),
                                       "boxes_equal": boxes ==
                                       want["jax_f32_boxes"],
                                       "cer_vs_jax_f32": page_cer}
        del f32
        checks["bocr_f32_equals_jax_record"] = ok
        # the AVIF page bocr --image read: the JAX record's lines exactly
        avif_cli = [p.name for p in cli_pages if p.suffix in AVIF_FORMATS]
        checks["avif_bocr_image_f32_cer_0_boxes_equal"] = bool(avif_cli) \
            and all(per_page[n]["cer_vs_jax_f32"] == 0.0
                    and per_page[n]["boxes_equal"] for n in avif_cli)
        checks["tool_avif_page_through_bocr_image"] = any(
            n in TOOL_AVIF_PAGES for n in avif_cli)
        checks["depth_avif_pages_through_bocr_image"] = all(
            n in avif_cli for n in BOCR_IMAGE_DEPTH_AVIF_PAGES)
        for n in BOCR_IMAGE_DEPTH_AVIF_PAGES:
            depth_pages[n]["bocr_image_f32"] = per_page.get(n)
        checks["grid_sequence_avif_pages_through_bocr_image"] = all(
            n in avif_cli for n in GRID_SEQUENCE_AVIF_PAGES)
        for n in GRID_SEQUENCE_AVIF_PAGES:
            grid_pages[n]["bocr_image_f32"] = per_page.get(n)
        lossless["bocr_f32"] = per_page.get(LOSSLESS_SUBSAMPLED_PAGE)
        ht_pages = {n: {"decode_ms": files.get(f"pages/{n}", {}).get(
            "decode_ms"), "equal_cv2": files.get(f"pages/{n}", {}).get(
            "equal_cv2"), "bocr_image_f32": per_page.get(n)}
            for n in HT_PAGES}
        for n in LAYERED_AVIF_PAGES:
            layered[f"pages/{n}"]["bocr_image_f32"] = per_page.get(n)
        checks["layered_avif_pages_bocr_image_f32_cer_0_boxes_equal"] = all(
            per_page.get(n, {}).get("via") == "bocr"
            and per_page[n]["cer_vs_jax_f32"] == 0.0
            and per_page[n]["boxes_equal"] for n in LAYERED_AVIF_PAGES)
        checks["ht_pages_bocr_image_f32_cer_0_boxes_equal"] = all(
            p["equal_cv2"] and p["bocr_image_f32"] is not None
            and p["bocr_image_f32"]["via"] == "bocr"
            and p["bocr_image_f32"]["cer_vs_jax_f32"] == 0.0
            and p["bocr_image_f32"]["boxes_equal"]
            for p in ht_pages.values())

        t0 = time.perf_counter()
        bf16 = full77f_pipeline(torch.bfloat16)
        with counted_path(results, "bocr_formats"):
            rc = cli.main(args + ["--folder", str(pages_dir), "--output",
                                  str(root / "bf16")])
            for path in cli_pages:
                rc = rc or cli.main(args + ["--image", str(path),
                                            "--output", str(root / "bf16")])
            in_process_ok = all(
                bf16.run_ocr(read_image(path), merge_lines=False,
                             target_encoding=Encoding.WYLIE)[0].name
                == "SUCCESS" for path in in_process)
        runs["bocr_bf16"] = {"rc": rc, "s": time.perf_counter() - t0,
                             "bocr_image_files": len(cli_pages),
                             "run_ocr_files": len(in_process)}
        checks["bocr_bf16_runs"] = rc == 0 and in_process_ok and all(
            (root / "bf16" / f"{p.stem}.txt").is_file()
            for p in page_paths if p not in in_process)
        png_dir = root / "png"
        png_dir.mkdir()
        for path in page_paths:
            write_png(png_dir / f"{path.name}.png",
                      read_image(path)[..., ::-1])
        png_paths = sorted(png_dir.iterdir())
        runs_s = {"files": [], "png_copies": []}
        for kind in ("files", "png_copies", "png_copies", "files"):
            runs_s[kind].append(page_loop_s(
                bf16, page_paths if kind == "files" else png_paths))
        loop = {f"{k}_s": v for k, v in runs_s.items()}
        loop.update({f"{k}_pages_per_s": len(page_paths) / min(v)
                     for k, v in runs_s.items()})
        # the same over the pages of the variants and damaged strips read
        # since the slice that decodes them
        new = [p for p in page_paths if p.name in REPAIRED_AND_VARIANT_PAGES]
        new_png = [png_dir / f"{p.name}.png" for p in new]
        runs_s = {"files": [], "png_copies": []}
        for kind in ("files", "png_copies", "png_copies", "files"):
            runs_s[kind].append(page_loop_s(
                bf16, new if kind == "files" else new_png))
        loop["repaired_and_variant_pages"] = {
            "pages": len(new), **{f"{k}_s": v for k, v in runs_s.items()},
            **{f"{k}_pages_per_s": len(new) / min(v)
               for k, v in runs_s.items()}}
        # and over the JPEG 2000, BMP, PNM and PAM pages, and the GIF,
        # WebP, Sun raster, PFM and HDR pages
        for key, group in (("jpeg2000_bmp_pnm_pages", older_pages),
                           ("gif_webp_ras_pfm_hdr_pages", newest),
                           ("avif_pages", avif_pages)):
            new_png = [png_dir / f"{p.name}.png" for p in group]
            runs_s = {"files": [], "png_copies": []}
            for kind in ("files", "png_copies", "png_copies", "files"):
                runs_s[kind].append(page_loop_s(
                    bf16, group if kind == "files" else new_png))
            loop[key] = {
                "pages": len(group),
                **{f"{k}_s": v for k, v in runs_s.items()},
                **{f"{k}_pages_per_s": len(group) / min(v)
                   for k, v in runs_s.items()}}
        del bf16

        # bocr-lines globs bocr's five extensions: the other page files go
        # through it under a name it globs, as in the JAX record
        renamed = root / "renamed"
        renamed.mkdir()
        for path in image_pages:
            (renamed / renamed_page(path.name)).write_bytes(path.read_bytes())
        t0 = time.perf_counter()
        with no_tf32(), counted_path(results, "bocr_lines"):
            rc = infer_lines_cli.main([
                "-i", str(pages_dir), "-o", str(root / "parquet"), "-c",
                str(WEIGHTS / "lines.msgpack"), "--dtype", "float32"])
            rc = rc or infer_lines_cli.main([
                "-i", str(renamed), "-o", str(root / "parquet"), "-c",
                str(WEIGHTS / "lines.msgpack"), "--dtype", "float32"])
        runs["bocr_lines_f32"] = {"rc": rc, "s": time.perf_counter() - t0}
        rows = {}
        for name, want in record["bocr_lines"].items():
            path = root / "parquet" / name
            got = read_result_parquet(path) if path.is_file() else None
            if got is None:
                rows[name] = {"read": False}
                continue
            got_contours = [[list(p) for p in c] for c in got["contours"]]
            rows[name] = {
                "num_contours": got["num_contours"],
                "jax_num_contours": want["num_contours"],
                "bboxes_equal": [list(b) for b in got["bboxes"]]
                == want["bboxes"],
                "contours_equal": got_contours == want["contours"],
                "fields_equal": all(got[k] == want[k] for k in (
                    "image_name", "image_width", "image_height",
                    "num_contours"))}
        checks["bocr_lines_rows_equal_jax_record"] = rc == 0 and all(
            r.get("bboxes_equal") and r.get("contours_equal")
            and r.get("fields_equal") for r in rows.values()) and len(
            rows) == len(page_paths)

        skip = unreadable_page_skipped(cli, args, root, page_paths[0])
        runs["bocr_lzma_folder"] = skip
        checks["bocr_skips_lzma_tiff"] = skip["ok"]
    bench_jp2 = files.get("bench_cfg4.jp2", {})
    bench_webp = files.get("bench_cfg4.webp", {})
    bench_avif = files.get("bench_cfg4.avif", {})
    bench_avif10 = files.get("bench_cfg4_10bit.avif", {})
    bench_ht = files.get("bench_cfg4_ht.j2k", {})
    checks["bench_ht_equals_cv2"] = bool(bench_ht.get("equal_cv2"))
    checks["avif_files_in_record"] = sum(
        rel.endswith(".avif") for rel in files) >= 19
    bench_layered = files.get(LAYERED_BENCH_AVIF[0], {})
    return {"_ok": all(checks.values()), "checks": checks, "files": files,
            "bench_jp2_decode_ms": bench_jp2.get("decode_ms"),
            "bench_ht_decode_ms": bench_ht.get("decode_ms"),
            "ht_pages": ht_pages,
            "bench_webp_decode_ms": bench_webp.get("decode_ms"),
            "bench_avif_decode_ms": bench_avif.get("decode_ms"),
            "bench_avif_10bit_decode_ms": bench_avif10.get("decode_ms"),
            "bench_layered_decode_ms": bench_layered.get("decode_ms"),
            "layered_avif": layered,
            "depth_avif_pages": depth_pages,
            "grid_sequence_avif_pages": grid_pages,
            "lossless_subsampled_jpeg": lossless,
            "full_page_copies": copies,
            "pool_decode": pool, "pages": per_page, "runs": runs,
            "page_loop_bf16": loop, "bocr_lines": rows,
            "launches": {p: results["launches"][p]
                         for p in ("bocr_formats", "bocr_lines")},
            "gpu": gpu_name_and_limit()}


# -- training: the train steps, the batches made on the card, the CLIs --

TRAIN_RECORD = FIXTURE / "training.json"
FULL_GLYPHS = {"height": 40, "seed": 7}
TRAIN_LINES, TRAIN_CLI_STEPS, SEG_CLI_STEPS, SEG_CLI_PAGES = 32, 20, 10, 4
# the per-step bars against the record (training.json): each loss within
# bars[0] of the JAX float32 loss, relative; each parameter leaf's change
# norm as close to the record's float64 run as the JAX float32 run is, up
# to a factor of 2, or within bars[1] of it. The JAX float32 run itself
# lies up to 3.3e-3 (Easter2) and 1.57e-2 (the UNet's ConvBN_2 BatchNorm
# bias, whose float32 gradient rounds at 3e-3 of its norm) from float64;
# the port lies within 2.30e-3 and 3.62e-3 of it, on the card (H100) and
# on the CPU alike.
REC_BARS, SEG_BARS = (2e-5, 5e-3), (1e-4, 5e-3)


def flax_params(model) -> dict:
    from ocr_inference_tpu_torch.models.params import flax_variables

    return flax_variables(model)["params"]


def leaf_change_norms(before: dict, after: dict, prefix=()) -> dict:
    """Per parameter leaf, the float64 norm of its change (the record's
    ``change_norms``, tests/make_torch_port_fixture.py)."""
    out = {}
    for k in sorted(before):
        if isinstance(before[k], dict):
            out.update(leaf_change_norms(before[k], after[k], prefix + (k,)))
        else:
            d = after[k].astype(np.float64) - before[k].astype(np.float64)
            out["/".join(prefix + (k,))] = float(np.linalg.norm(d))
    return out


def bound_step(model, opt, make_step, **kwargs):
    """run(batch) -> loss of ``make_step(model, opt, **kwargs)``, the train
    state threaded from one call to the next."""
    from ocr_inference_tpu_torch.training.train import model_state

    step = make_step(model, opt, **kwargs)
    state = model_state(model, opt).as_tuple()

    def run(batch):
        nonlocal state
        state, loss = step(state, batch)
        return loss

    return run


def change_norm_errors(got: dict, want: dict) -> dict:
    """Per step, each parameter leaf's change norm on the card against the
    record's float64 run: ``ours`` its relative distance, ``theirs`` the
    JAX float32 run's, ``vs_jax_f32`` its distance from that run, and
    ``jax_grad_rounding`` how far the JAX float32 gradient's norm lies
    from the float64 one. A leaf the float64 run leaves unmoved (learning
    rate 0) must stay unmoved."""
    out = {}
    for k, ref in want["change_norms_f64"].items():
        if ref == 0.0:
            out[k] = {"ours": 0.0 if got[k] == 0.0 else float("inf"),
                      "theirs": 0.0, "vs_jax_f32": 0.0}
            continue
        jax32, g64 = want["change_norms"][k], want["grad_norms_f64"][k]
        out[k] = {"ours": abs(got[k] - ref) / ref,
                  "theirs": abs(jax32 - ref) / ref,
                  "vs_jax_f32": abs(got[k] - jax32) / jax32,
                  "jax_grad_rounding": abs(want["grad_norms"][k] - g64)
                  / g64 if g64 else None}
    return out


def train_against_record(model, record: dict, step_fn, make_batch,
                         results: dict, path: str, bars: tuple) -> dict:
    """Drive ``step_fn`` on the record's batches (made on the card inside
    the counted path): each batch's sha256 equal to the record's, each
    loss within ``bars[0]`` of the JAX float32 loss, and each parameter
    leaf's change norm as close to the record's float64 run as the JAX
    float32 run is, up to a factor of 2, or within ``bars[1]`` of it."""
    steps, same_batches = [], True
    with no_tf32(), counted_path(results, path):
        for want in record["steps"]:
            batch = make_batch()
            hashes = {k: sha256(v.cpu().numpy()) for k, v in batch.items()}
            before = flax_params(model)
            loss = float(step_fn(batch))
            errs = change_norm_errors(
                leaf_change_norms(before, flax_params(model)), want)
            same_batches &= hashes == want["batch_sha256"]
            over = {k: e["ours"] / max(2 * e["theirs"], bars[1])
                    for k, e in errs.items()}
            worst = max(over, key=over.get)
            steps.append({
                "loss": loss, "jax_loss": want["loss"],
                "loss_rel_err": abs(loss - want["loss"]) / abs(want["loss"]),
                "worst_leaf": worst, "worst_leaf_errs": errs[worst],
                "worst_over_bar": over[worst],
                "change_norm_max_rel_err_vs_f64": max(
                    e["ours"] for e in errs.values()),
                "change_norm_max_rel_err_vs_jax_f32": max(
                    e["vs_jax_f32"] for e in errs.values()),
                "leaves_over_floor": sorted(
                    k for k, e in errs.items() if e["ours"] > bars[1])})
    ok = (same_batches
          and all(st["loss_rel_err"] <= bars[0] for st in steps)
          and all(st["worst_over_bar"] <= 1.0 for st in steps))
    return {"_ok": ok, "batches_equal_jax": same_batches, "bars": bars,
            "loss_max_rel_err": max(st["loss_rel_err"] for st in steps),
            "change_norm_max_rel_err_vs_f64": max(
                st["change_norm_max_rel_err_vs_f64"] for st in steps),
            "change_norm_max_rel_err_vs_jax_f32": max(
                st["change_norm_max_rel_err_vs_jax_f32"] for st in steps),
            "steps": steps, "launches": results["launches"][path]}


@phase("train_rec_f32")
def train_rec_f32(results: dict):
    """Easter2 from full77f, five float32 steps (TF32 off) on
    recognizer_batch batches made on the card, against training.json;
    the weights written with save_params, read back, and read by run_ocr
    on the fixture pages."""
    from ocr_inference_tpu_torch.eval.synthetic import (
        WYLIE_CHARSET_FULL, GlyphSet, recognizer_batch,
    )
    from ocr_inference_tpu_torch.models.params import (
        load_flax_weights, load_params, save_params, to_bytes, flax_variables,
    )
    from ocr_inference_tpu_torch.models.recognition import build_recognizer
    from ocr_inference_tpu_torch.training import (
        make_optimizer, make_train_step,
    )

    record = json.loads(TRAIN_RECORD.read_text())["rec"]
    dev = torch.device("cuda")
    model = build_recognizer("Easter2", len(WYLIE_CHARSET_FULL) + 1).to(dev)
    load_flax_weights(model, WEIGHTS / "recognizer.msgpack")
    step_fn = bound_step(model, make_optimizer(**record["optimizer"]),
                         make_train_step)
    glyphs = GlyphSet(charset=WYLIE_CHARSET_FULL, **FULL_GLYPHS)
    rng = np.random.RandomState(record["seed"])
    recipe = dict(record["recipe"])
    size = recipe.pop("batch")
    out = train_against_record(
        model, record, step_fn,
        lambda: recognizer_batch(rng, glyphs, WYLIE_CHARSET_FULL, size,
                                 device=dev, **recipe),
        results, "train_rec_f32", REC_BARS)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "recognizer.msgpack"
        save_params(model, path, meta={"architecture": "Easter2"})
        back = build_recognizer("Easter2", len(WYLIE_CHARSET_FULL) + 1)
        load_params(back, path)
        round_trip = to_bytes(flax_variables(back)) == path.read_bytes()
        ocr = full77f_config()
        ocr.model_file = str(Path(tmp) / "recognizer.onnx")
        pipe = full77f_pipeline(torch.float32, ocr_config=ocr)
        pages, _ = fixture()
        with no_tf32():
            texts = {name: run_page(pipe, img)[0] for name, img, _ in pages}
        del pipe
    out["_ok"] &= round_trip and all(any(t) for t in texts.values())
    out.update({"save_load_round_trip": round_trip,
                "run_ocr_lines": {k: len(v) for k, v in texts.items()},
                "gpu": gpu_name_and_limit()})
    return out


@phase("train_seg_f32")
def train_seg_f32(results: dict):
    """The full77f UNet (width 32, stem 2), three float32 steps (TF32 off)
    on segmentation_batch batches of 8 tiles of 512^2 made on the card,
    against training.json."""
    from ocr_inference_tpu_torch.eval.synthetic import (
        WYLIE_CHARSET_FULL, GlyphSet, segmentation_batch,
    )
    from ocr_inference_tpu_torch.models.params import load_flax_weights
    from ocr_inference_tpu_torch.models.segmentation import UNet
    from ocr_inference_tpu_torch.training import (
        make_optimizer, make_seg_train_step,
    )

    record = json.loads(TRAIN_RECORD.read_text())["seg"]
    dev = torch.device("cuda")
    model = UNet(classes=1, width=32, stem_stride=2).to(dev)
    load_flax_weights(model, WEIGHTS / "lines.msgpack")
    step_fn = bound_step(model, make_optimizer(**record["optimizer"]),
                         make_seg_train_step)
    glyphs = GlyphSet(charset=WYLIE_CHARSET_FULL, **FULL_GLYPHS)
    rng = np.random.RandomState(record["seed"])
    out = train_against_record(
        model, record, step_fn,
        lambda: segmentation_batch(rng, glyphs, WYLIE_CHARSET_FULL,
                                   record["recipe"]["batch"],
                                   record["recipe"]["patch"], device=dev),
        results, "train_seg_f32", SEG_BARS)
    out["gpu"] = gpu_name_and_limit()
    return out


def _rate(stdout: str, pattern: str) -> float | None:
    import re

    found = re.findall(pattern, stdout)
    return float(found[-1]) if found else None


@phase("train_cli")
def train_cli_phase(results: dict):
    """bocr-train (float32, batch 32, 20 steps, fine-tuning full77f) on a
    64-line PNG dataset from line_dataset, then bocr-train-seg (10 steps)
    on four render_page pages with their line masks, both as processes;
    their weights load into build_pipeline and read a fixture page.
    Neither binarizes (the JAX CLIs train on gray canvases and RGB tiles),
    so this is not a counted path."""
    from ocr_inference_tpu_torch.core.data import LineDetectionConfig
    from ocr_inference_tpu_torch.eval.synthetic import (
        WYLIE_CHARSET_FULL, GlyphSet, line_dataset, load_glyphs,
        render_page,
    )
    from ocr_inference_tpu_torch.io.artifacts import write_png

    glyph_map, charset = load_glyphs(FIXTURE / "pages.npz")
    checks, runs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        model, _ = write_model_dirs(root)
        (model / "weights.msgpack").write_bytes(
            (WEIGHTS / "recognizer.msgpack").read_bytes())
        data = root / "line_data"
        data.mkdir()
        for dist, lines in line_dataset(glyph_map, charset, 11,
                                        TRAIN_LINES).items():
            for name, img, label in lines:
                write_png(data / f"{dist}_{name}.png", img[..., ::-1])
                (data / f"{dist}_{name}.txt").write_text(label + "\n",
                                                         encoding="utf-8")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ocr_inference_tpu_torch.cli.train_cli",
             "--model", str(model), "--data", str(data), "--output",
             str(root / "rec" / "recognizer.msgpack"), "--steps",
             str(TRAIN_CLI_STEPS), "--batch-size", "32", "--width", "512",
             "--log-every", "5"], capture_output=True, text=True, cwd=REPO,
            timeout=600)
        runs["bocr_train"] = {
            "rc": proc.returncode, "s": time.perf_counter() - t0,
            "lines_per_s": _rate(proc.stdout, r"\(([0-9.]+) lines/s\)"),
            "stdout": proc.stdout[-600:], "stderr": proc.stderr[-400:]}
        checks["bocr_train_exit_0"] = proc.returncode == 0

        pages = root / "pages"
        pages.mkdir()
        glyphs = GlyphSet(charset=WYLIE_CHARSET_FULL, **FULL_GLYPHS)
        for i in range(SEG_CLI_PAGES):
            page = render_page(np.random.RandomState(500 + i), glyphs,
                               WYLIE_CHARSET_FULL)
            write_png(pages / f"p{i}.png", page.image[..., ::-1])
            write_png(pages / f"p{i}_mask.png", page.line_mask)
        (root / "seg.json").write_text(json.dumps({
            "checkpoint": "", "onnx-model": "lines.onnx",
            "architecture": "unet", "patch_size": 512, "classes": ["line"]}))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m",
             "ocr_inference_tpu_torch.cli.train_seg_cli", "--config",
             str(root / "seg.json"), "--data", str(pages), "--output",
             str(root / "seg" / "lines.msgpack"), "--steps",
             str(SEG_CLI_STEPS), "--batch-size", "8", "--log-every", "5"],
            capture_output=True, text=True, cwd=REPO, timeout=600)
        seg_s = time.perf_counter() - t0
        runs["bocr_train_seg"] = {
            "rc": proc.returncode, "s": seg_s,
            "tiles_per_s_with_start": SEG_CLI_STEPS * 8 / seg_s,
            "stdout": proc.stdout[-600:], "stderr": proc.stderr[-400:]}
        checks["bocr_train_seg_exit_0"] = proc.returncode == 0

        if all(checks.values()):
            ocr = full77f_config()
            ocr.model_file = str(root / "rec" / "recognizer.onnx")
            line = LineDetectionConfig(
                checkpoint="", onnx_file=str(root / "seg" / "lines.onnx"),
                architecture="unet", patch_size=512, classes=["line"])
            pipe = full77f_pipeline(torch.bfloat16, ocr_config=ocr,
                                    line_config=line)
            name, img, _ = fixture()[0][0]
            status, _ = pipe.run_ocr(img)
            runs["trained_pipeline_status"] = str(status)
            checks["weights_load_into_build_pipeline"] = True
            del pipe
    return {"_ok": all(checks.values()), "checks": checks, "runs": runs,
            "gpu": gpu_name_and_limit()}


# the keys the JAX selftrain writes for these arguments
# (selftrain_cli.py:600-646)
SELFTRAIN_KEYS = {
    "cer", "pages", "failed_pages", "lines_detected", "rec_steps",
    "seg_steps", "rec_loss", "seg_loss", "eval_seconds", "per_page_cer",
    "charset_size", "backend", "provenance", "cer_beam", "cer_beam_lm",
    "lm_order", "lm_alpha", "lm_beta", "lm_fusion_enabled"}
SELFTRAIN_ARGS = ["--rec-steps", "40", "--seg-steps", "20",
                  "--eval-pages", "4", "--lm-order", "2"]
# from full77f, so that the eval pages detect and read lines: the
# recognizer fine-tuned a few steps (bf16), the UNet reused; the eval
# pages degraded so that their CERs are not all 0 (full77f on the CPU:
# 19 lines, CER 0.0216)
EVAL_ARGS = ["--eval-pages", "4", "--lm-order", "2", "--eval-degrade", "0.6"]
FINETUNE_ARGS = ["--resume-rec", str(WEIGHTS), "--weights-seg", str(WEIGHTS),
                 "--rec-steps", "5", "--lr", "3e-5", *EVAL_ARGS]
EVAL_KEYS = ("cer", "cer_beam", "cer_beam_lm", "lines_detected",
             "failed_pages", "rec_loss", "seg_loss", "per_page_cer",
             "eval_seconds")


@phase("selftrain")
def selftrain_phase(results: dict):
    """bocr-selftrain in this process, so that its launches count: from
    scratch, short (SELFTRAIN_ARGS): EVAL.json with the JAX keys; then
    fine-tuning full77f's recognizer with full77f's UNet (FINETUNE_ARGS),
    whose eval reads lines; then --weights on that directory, eval only:
    the same CERs, page by page, and the same line count."""
    import contextlib as ctx
    import io

    from ocr_inference_tpu_torch.cli import selftrain_cli

    torch.cuda.reset_peak_memory_stats()
    runs = {"scratch": SELFTRAIN_ARGS, "finetune": FINETUNE_ARGS,
            "weights": ["--weights", None, *EVAL_ARGS]}
    rcs, evals, seconds = {}, {}, {}
    log = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        with counted_path(results, "selftrain"), ctx.redirect_stderr(log), \
                ctx.redirect_stdout(io.StringIO()):
            for name, args in runs.items():
                out = Path(tmp) / name
                args = [str(Path(tmp) / "finetune") if a is None else a
                        for a in args]
                t0 = time.perf_counter()
                rcs[name] = selftrain_cli.main(["--out", str(out), *args])
                seconds[name] = time.perf_counter() - t0
                evals[name] = json.loads((out / "EVAL.json").read_text()) \
                    if rcs[name] == 0 else {}
    tuned, again = evals["finetune"], evals["weights"]
    degraded = SELFTRAIN_KEYS | {"eval_degrade"}
    checks = {
        "exit_0": all(rc == 0 for rc in rcs.values()),
        "eval_json_has_the_jax_keys": set(evals["scratch"]) == SELFTRAIN_KEYS
        and set(tuned) == degraded and set(again) == degraded,
        "finetuned_reads_lines": tuned.get("lines_detected", 0) > 0
        and tuned.get("cer", 1.0) < 1.0 and tuned.get("rec_steps") == 5,
        "weights_eval_only_same_result": again.get("rec_steps") == 0
        and bool(tuned) and all(again.get(k) == tuned.get(k) for k in (
            "per_page_cer", "cer", "cer_beam", "cer_beam_lm",
            "lines_detected")),
    }
    lines = log.getvalue().splitlines()
    return {"_ok": all(checks.values()), "checks": checks,
            "eval": {name: {k: e.get(k) for k in EVAL_KEYS}
                     for name, e in evals.items()},
            "seconds": seconds,
            "log": [ln for ln in lines if "trained in" in ln],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": results["launches"]["selftrain"],
            "gpu": gpu_name_and_limit()}


def step_ms(step, batch, iters: int = 5) -> dict:
    """One train step's time: CUDA events around ``iters`` steps after two
    warm-up steps (device ms; a step whose host side is slower is timed at
    the host's pace), and the host clock of the same steps."""
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        step(batch)
    end.record()
    torch.cuda.synchronize()
    return {"device_ms": start.elapsed_time(end) / iters,
            "wall_ms": (time.perf_counter() - t0) * 1e3 / iters}


@phase("train_rates")
def train_rates(results: dict):
    """Device ms of one Easter2 step (32 canvases of 80x512) in float32
    (TF32 off) and bf16, of one UNet step (8 tiles of 512^2, float32 and
    selftrain's bf16), host ms to make one batch of each, peak memory."""
    from ocr_inference_tpu_torch.eval.synthetic import (
        WYLIE_CHARSET_FULL, GlyphSet, recognizer_batch, segmentation_batch,
    )
    from ocr_inference_tpu_torch.models.params import load_flax_weights
    from ocr_inference_tpu_torch.models.recognition import build_recognizer
    from ocr_inference_tpu_torch.models.segmentation import UNet
    from ocr_inference_tpu_torch.training import (
        make_optimizer, make_seg_train_step, make_train_step,
    )

    dev = torch.device("cuda")
    glyphs = GlyphSet(charset=WYLIE_CHARSET_FULL, **FULL_GLYPHS)
    rng = np.random.RandomState(7)
    host = {}
    t0 = time.perf_counter()
    rec_batch = recognizer_batch(rng, glyphs, WYLIE_CHARSET_FULL, 32,
                                 width=512, degrade_max=0.7,
                                 shear_max_deg=0.6, curve_max_amp=12.0,
                                 geo_prob=0.35, device=dev)
    torch.cuda.synchronize()
    host["recognizer_batch_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    seg_batch = segmentation_batch(rng, glyphs, WYLIE_CHARSET_FULL, 8,
                                   device=dev)
    torch.cuda.synchronize()
    host["segmentation_batch_ms"] = (time.perf_counter() - t0) * 1e3
    out = {"host": host}
    for name, dtype in (("easter2_f32", torch.float32),
                        ("easter2_bf16", torch.bfloat16)):
        torch.cuda.reset_peak_memory_stats()
        model = build_recognizer("Easter2", len(WYLIE_CHARSET_FULL) + 1)
        load_flax_weights(model, WEIGHTS / "recognizer.msgpack")
        model.to(dev)
        run = bound_step(model, make_optimizer(3e-4, 3000, 100),
                         make_train_step, dtype=dtype)
        with no_tf32():
            out[name] = step_ms(run, rec_batch)
        out[name]["lines_per_s"] = 32e3 / out[name]["device_ms"]
        out[name]["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del model, run
    for name, dtype in (("unet_f32", torch.float32),
                        ("unet_bf16", torch.bfloat16)):
        torch.cuda.reset_peak_memory_stats()
        model = UNet(classes=1, width=32, stem_stride=2)
        load_flax_weights(model, WEIGHTS / "lines.msgpack")
        model.to(dev)
        run = bound_step(model, make_optimizer(3e-4, 400, 50),
                         make_seg_train_step, dtype=dtype)
        with no_tf32():
            out[name] = step_ms(run, seg_batch)
        out[name]["tiles_per_s"] = 8e3 / out[name]["device_ms"]
        out[name]["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del model, run
    out["gpu"] = gpu_name_and_limit()
    return out


# -- .onnx checkpoints: export, the executor's pipelines, weights, CLIs --

ONNX_VOLUME_PAGES, ONNX_BENCH_PAGES = 24, 2
REC_AXES = {"input": {0: "batch", 2: "width"}}
DET_AXES = {"input": {0: "batch"}}


def full77f_modules(load: bool = True) -> dict:
    """full77f's UNet and Easter2, float32, eval mode, on the host; with
    ``load`` False, of its geometry with torch's own random init."""
    from ocr_inference_tpu_torch.models.params import load_flax_weights
    from ocr_inference_tpu_torch.models.recognition import Easter2
    from ocr_inference_tpu_torch.models.segmentation import UNet

    rec_meta = json.loads((WEIGHTS / "recognizer.msgpack.json").read_text())
    det_meta = json.loads((WEIGHTS / "lines.msgpack.json").read_text())
    unet = UNet(1, int(det_meta.get("width", 32)),
                int(det_meta.get("stem_stride", 1)))
    easter2 = Easter2(len(rec_meta["charset"]) + 1)
    if load:
        load_flax_weights(unet, WEIGHTS / "lines.msgpack")
        load_flax_weights(easter2, WEIGHTS / "recognizer.msgpack")
    return {"lines": unet.eval(), "recognizer": easter2.eval()}


def onnx_configs(store: dict, kind: str = "folded"):
    """full77f's configs pointing at the exported files, no msgpack
    beside them."""
    from ocr_inference_tpu_torch.core.data import LineDetectionConfig

    ocr = dataclasses.replace(full77f_config(),
                              model_file=str(store[kind]["recognizer"]))
    line = LineDetectionConfig(
        checkpoint="", onnx_file=str(store[kind]["lines"]),
        architecture="unet", patch_size=512, classes=["line"])
    return ocr, line


@phase("onnx_export")
def onnx_export(store: dict):
    """full77f's UNet and Easter2 through the port's torch_export (opset
    17, the TorchScript exporter), BatchNorm folded (the default) and
    not, dynamic batch (and width for the recognizer); bytes, nodes, op
    set, export seconds, and the seconds to parse and to load (fold the
    constants, move the weights to the card)."""
    from ocr_inference_tpu_torch.onnx import OnnxGraphFunction
    from ocr_inference_tpu_torch.onnx.export_shim import torch_export
    from ocr_inference_tpu_torch.onnx.wire import load_model

    modules = full77f_modules()
    examples = {"lines": (torch.rand(2, 3, 512, 512), DET_AXES),
                "recognizer": (torch.rand(2, 80, 512), REC_AXES)}
    out = {}
    for kind, fold in (("folded", True), ("unfolded", False)):
        d = Path(store["dir"]) / kind
        d.mkdir(parents=True)
        store[kind] = {}
        for name, module in modules.items():
            x, axes = examples[name]
            path = d / f"{name}.onnx"
            t0 = time.perf_counter()
            torch_export(module, x, str(path), do_constant_folding=fold,
                         input_names=["input"], output_names=["output"],
                         dynamic_axes=axes)
            t1 = time.perf_counter()
            model = load_model(path)
            t2 = time.perf_counter()
            fn = OnnxGraphFunction(model)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            store[kind][name] = path
            out[f"{kind}/{name}"] = {
                "bytes": path.stat().st_size,
                "nodes": len(model.graph.nodes),
                "nodes_after_fold": len(fn._steps),
                "ops": sorted({n.op_type for n in model.graph.nodes}),
                "export_s": t1 - t0, "parse_s": t2 - t1, "load_s": t3 - t2,
            }
            del fn
    return {"graphs": out, "gpu": gpu_name_and_limit()}


class TimedGraph:
    """An OnnxGraphFunction with its calls' host seconds and nodes run
    counted (the call's enqueue time; the card's work runs behind it)."""

    def __init__(self, fn):
        self.fn, self.calls, self.host_s, self.nodes = fn, 0, 0.0, 0

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __call__(self, *args):
        t0 = time.perf_counter()
        out = self.fn(*args)
        self.host_s += time.perf_counter() - t0
        self.calls += 1
        self.nodes += self.fn.steps_run
        return out

    def summary(self) -> dict:
        return {"calls": self.calls,
                "host_ms_per_call": 1e3 * self.host_s / max(self.calls, 1),
                "host_us_per_node": 1e6 * self.host_s / max(self.nodes, 1)}


def timed_pipeline(pipe):
    """Put TimedGraph around both engines' graphs; returns them."""
    timers = {}
    for name, engine in (("recognizer", pipe.ocr_inference),
                         ("lines", pipe.line_inference)):
        engine.model.fn = timers[name] = TimedGraph(engine.model.fn)
    return timers


def executor_ms(module, plain, x, iters: int = 5) -> dict:
    """One OnnxModule call on ``x``: its host ms (the enqueue, the card
    idle before it), the nodes it ran, its time on the card's clock, and
    the msgpack module's on the same input."""
    for _ in range(2):
        module(x)
    host = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        module(x)
        host += time.perf_counter() - t0
    torch.cuda.synchronize()
    steps = module.fn.steps_run
    return {"shape": list(x.shape), "host_ms": 1e3 * host / iters,
            "nodes_run": steps, "host_us_per_node": 1e6 * host / iters / steps,
            "device_ms": cuda_ms(module, x, iters=iters),
            "msgpack_device_ms": cuda_ms(plain, x, iters=iters)}


@phase("onnx_page_f32")
def onnx_page_f32(store: dict, results: dict):
    """build_pipeline on the folded .onnx configs (both engines hold an
    OnnxModule), float32, TF32 off: the fixture pages against the JAX
    record of an ONNX detector (onnx.json: texts within 0.5% CER, equal
    line counts and boxes; texts.json, the msgpack path's record, beside
    it); those pages and two bench.py config 4 pages against the port's
    msgpack float32 pipeline with the ONNX detector's settings (no
    opening): recognizer logits of every strip within 1e-3, equal texts
    and boxes; page ms of both; the executor's host ms a call."""
    from ocr_inference_tpu_torch.eval.cer import cer
    from ocr_inference_tpu_torch.onnx import OnnxModule
    from ocr_inference_tpu_torch.pipeline import (
        PipelineObserver,
        build_pipeline,
    )

    class Strips(PipelineObserver):
        def stage_end(self, stage, payload):
            if stage == "extract_lines":
                self.strips = payload[1]

    pages, msgpack_record = fixture()
    onnx_record = {p["name"]: p for p in json.loads(
        (FIXTURE / "onnx.json").read_text(encoding="utf-8"))["pages"]}
    bench = bench_volume(ONNX_BENCH_PAGES, seed=42)
    checks, per_page = {}, {}
    with no_tf32():
        pipe = build_pipeline(*onnx_configs(store), dtype=torch.float32)
        ref = full77f_pipeline(torch.float32)
        ref.line_inference.open_width_frac = 0.0
        checks["engines_hold_onnx_modules"] = isinstance(
            pipe.ocr_inference.model, OnnxModule) and isinstance(
            pipe.line_inference.model, OnnxModule)
        with counted_path(results, "onnx_page_f32"):
            got = {name: run_page(pipe, img) for name, img, _ in pages}
        for name, _, _ in pages:
            texts, lines, _ = got[name]
            boxes = [list(ln.bbox.as_tuple()) for ln in lines]
            want = onnx_record[name]
            page_cer = cer([" ".join(texts)],
                           [" ".join(want["jax_f32_texts"])])
            per_page[name] = {
                "lines": len(texts), "cer_vs_jax_onnx_f32": page_cer,
                "boxes_equal_jax_onnx_f32": boxes == want["jax_f32_boxes"],
                "msgpack_record_lines": len(
                    msgpack_record[name]["jax_f32_texts"]),
                "cer_vs_msgpack_record": cer(
                    [" ".join(texts)],
                    [" ".join(msgpack_record[name]["jax_f32_texts"])]),
            }
            checks[f"{name}_vs_record"] = (
                page_cer <= 0.005 and boxes == want["jax_f32_boxes"]
                and len(texts) == len(want["jax_f32_texts"]))
        logits_err = 0.0
        all_pages = [(n, img) for n, img, _ in pages] + [
            (f"bench{i}", img) for i, img in enumerate(bench)]
        for name, img in all_pages:
            obs_o, obs_r = Strips(), Strips()
            status_o, out_o = pipe.run_ocr(img, observer=obs_o)
            status_r, out_r = ref.run_ocr(img, observer=obs_r)
            same = (status_o.name == status_r.name == "SUCCESS"
                    and [ln.text for ln in out_o[2]]
                    == [ln.text for ln in out_r[2]]
                    and [ln.bbox.as_tuple() for ln in out_o[1]]
                    == [ln.bbox.as_tuple() for ln in out_r[1]])
            lo = pipe.ocr_inference.line_logits(obs_o.strips)
            lr = ref.ocr_inference.line_logits(obs_r.strips)
            err = max((float(np.abs(lo[i] - lr[i]).max()) for i in lo),
                      default=0.0)
            logits_err = max(logits_err, err)
            checks[f"{name}_equals_msgpack_path"] = same and lo.keys() == \
                lr.keys() and err <= 1e-3
            per_page.setdefault(name, {}).update(
                {"strips": len(lo), "logits_max_abs_err": err,
                 "texts_boxes_equal_msgpack_f32": same})
        page_ms = {}
        for label, p in (("onnx", pipe), ("msgpack", ref)):
            run_page(p, bench[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                run_page(p, bench[0])
            torch.cuda.synchronize()
            page_ms[label] = (time.perf_counter() - t0) / 3 * 1e3
        dev = torch.device("cuda")
        executor = {
            "recognizer": executor_ms(
                pipe.ocr_inference.model, ref.ocr_inference.model,
                torch.rand(8, 80, 1024, device=dev) * 2 - 1),
            "lines": executor_ms(
                pipe.line_inference.model, ref.line_inference.model,
                torch.rand(8, 3, 512, 512, device=dev).round()),
        }
    return {"_ok": all(checks.values()), "checks": checks,
            "pages": per_page, "logits_max_abs_err": logits_err,
            "bench_page_ms_f32": page_ms, "executor": executor,
            "launches": results["launches"]["onnx_page_f32"],
            "gpu": gpu_name_and_limit()}


def _volume_run(pipe, entries, results=None, path=None):
    from ocr_inference_tpu_torch.core.data import Encoding
    from ocr_inference_tpu_torch.pipeline import VolumeRunner

    VolumeRunner(pipe).run(entries[:4], target_encoding=Encoding.WYLIE)
    pipe.ocr_inference.warm_shapes()
    timers = timed_pipeline(pipe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctx = counted_path(results, path) if path else contextlib.nullcontext()
    with ctx:
        t0 = time.perf_counter()
        records = VolumeRunner(pipe).run(entries,
                                         target_encoding=Encoding.WYLIE)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    ok = [r for r in records if r.status.name == "SUCCESS"]
    return records, {
        "seconds": dt, "pages_ok": len(ok), "pages_per_s": len(ok) / dt,
        "lines_per_s": sum(len(r.lines) for r in ok) / dt,
        "stage_median_ms": {k: _median([r.timings_ms[k] for r in ok
                                        if k in r.timings_ms])
                            for k in ("detect_dispatch", "detect",
                                      "geometry", "recognize")},
        "executor": {k: t.summary() for k, t in timers.items()},
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }


@phase("onnx_volume")
def onnx_volume(store: dict, results: dict):
    """VolumeRunner over 24 bench.py config 4 pages from the .onnx
    configs, float32 (TF32 off), then under OCR_ONNX_BF16=1: the float32
    texts within 0.5% CER of its own run_ocr loop's, the boxes equal;
    pages/s, stage medians, the executor's host ms a call and a node,
    peak memory. bf16 against float32: the bench pages' ink blocks are
    noise, whose texts flip with the precision, so the CER between the
    two volumes is printed beside the msgpack path's on the same pages,
    and the 2% bar holds on text: the fixture pages through VolumeRunner
    and the first 12 eval pages through run_suite, bf16 against float32
    (and each against the ground truth)."""
    from ocr_inference_tpu_torch.eval import suite
    from ocr_inference_tpu_torch.eval.cer import cer
    from ocr_inference_tpu_torch.eval.synthetic import load_glyphs
    from ocr_inference_tpu_torch.pipeline import build_pipeline

    pages = bench_volume(ONNX_VOLUME_PAGES, seed=42)
    entries = [(f"page{i:03d}", img) for i, img in enumerate(pages)]
    text_pages = [(name, img) for name, img, _ in fixture()[0]]
    glyphs, charset = load_glyphs(FIXTURE / "pages.npz")

    def joined(recs):
        return {r.name: " ".join(ln.text for ln in r.ocr_lines)
                for r in recs if r.status.name == "SUCCESS"}

    def precision_cer(a, b):
        names = sorted(a)
        return cer([b.get(n, "") for n in names], [a[n] for n in names])

    def text_reads(pipe):
        recs = volume_records(pipe, text_pages)
        res = suite.run_suite(pipe, EVAL_SMOKE_PAGES, glyphs, charset)
        return joined(recs), res

    with no_tf32():
        pipe = build_pipeline(*onnx_configs(store), dtype=torch.float32)
        records, f32 = _volume_run(pipe, entries, results, "onnx_volume")
        plain, plain_s = plain_reads(pipe, entries)
        text32, suite32 = text_reads(pipe)
        del pipe
        msgpack = {}
        for label, dtype in (("float32", torch.float32),
                             ("bf16", torch.bfloat16)):
            ref = full77f_pipeline(dtype)
            ref.line_inference.open_width_frac = 0.0
            msgpack[label] = joined(volume_records(ref, entries))
            del ref
    os.environ["OCR_ONNX_BF16"] = "1"
    try:
        pipe16 = build_pipeline(*onnx_configs(store))
    finally:
        del os.environ["OCR_ONNX_BF16"]
    records16, b16 = _volume_run(pipe16, entries)
    text16, suite16 = text_reads(pipe16)
    bf16_graph = pipe16.ocr_inference.model.fn.dtype == torch.bfloat16
    del pipe16

    t32, t16 = joined(records), joined(records16)
    names = sorted(t32)
    f32_cer = cer([t32[n] for n in names],
                  [" ".join(plain.get(n, ([], []))[1]) for n in names])
    text_cer = cer([text16.get(n, "") for n in text32] + suite16.predictions,
                   list(text32.values()) + suite32.predictions)
    checks = {
        "all_pages_read": len(t32) == len(t16) == len(entries),
        "f32_cer_vs_run_ocr_le_0.5pct": f32_cer <= 0.005,
        "f32_boxes_equal_run_ocr": all(
            [ln.bbox.as_tuple() for ln in r.lines] == plain[r.name][0]
            for r in records if r.name in plain),
        "bf16_graph": bf16_graph,
        "bf16_cer_vs_f32_on_text_le_2pct": text_cer <= 0.02,
    }
    return {"_ok": all(checks.values()), "checks": checks,
            "float32": f32, "bf16": b16,
            "run_ocr_loop_f32": {"seconds": plain_s,
                                 "pages_per_s": len(plain) / plain_s},
            "cer_f32_vs_run_ocr": f32_cer,
            "bench_cer_bf16_vs_f32": {
                "onnx": precision_cer(t32, t16),
                "msgpack": precision_cer(msgpack["float32"],
                                         msgpack["bf16"])},
            "text_cer_bf16_vs_f32": text_cer,
            "text_cer_vs_ground_truth": {"float32": suite32.cer,
                                         "bf16": suite16.cer},
            "lines": sum(len(r.lines) for r in records),
            "launches": results["launches"]["onnx_volume"],
            "gpu": gpu_name_and_limit()}


def volume_records(pipe, entries):
    """VolumeRunner's records of ``entries`` at its defaults."""
    from ocr_inference_tpu_torch.core.data import Encoding
    from ocr_inference_tpu_torch.pipeline import VolumeRunner

    return VolumeRunner(pipe).run(entries, target_encoding=Encoding.WYLIE)


def _leaves(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@phase("onnx_weights")
def onnx_weights(store: dict):
    """The exported graphs back into the port's modules on the card, TF32
    off: the fold-free graphs' transplanted leaves against full77f's
    msgpack (within 1e-6), the folded graphs' logits against full77f's
    module (within 1e-3), write_back of a fold-free graph from the
    module's weights (every initializer equal to the exported file's bit
    for bit), and an fp16 export of the Easter2 through the executor
    against the ``.half()`` module's logits (within 3e-2, the fp16 bar of
    tests/test_onnx_fp16.py)."""
    from ocr_inference_tpu_torch.models.params import (
        load_flax_tree,
        read_msgpack,
    )
    from ocr_inference_tpu_torch.onnx import OnnxGraphFunction
    from ocr_inference_tpu_torch.onnx.export_shim import torch_export
    from ocr_inference_tpu_torch.onnx.retroplant import write_back
    from ocr_inference_tpu_torch.onnx.transplant import (
        transplant,
        verify_transplant,
    )
    from ocr_inference_tpu_torch.onnx.wire import load_model

    dev = torch.device("cuda")
    full = {k: m.to(dev) for k, m in full77f_modules().items()}
    fresh = {k: m.to(dev) for k, m in full77f_modules(load=False).items()}
    xs = {"lines": torch.rand(2, 3, 512, 512, device=dev).round(),
          "recognizer": torch.rand(2, 80, 1024, device=dev) * 2 - 1}
    out, checks = {}, {}
    with no_tf32():
        for name, module in full.items():
            want = read_msgpack(WEIGHTS / f"{name}.msgpack")
            t0 = time.perf_counter()
            tree, report = transplant(load_model(store["unfolded"][name]),
                                      fresh[name], None, xs[name])
            t_s = time.perf_counter() - t0
            got, ref = dict(_leaves(tree)), dict(_leaves(want))
            leaf_err = max(float(np.abs(got[k] - ref[k]).max())
                           for k in ref) if got.keys() == ref.keys() \
                else float("inf")
            folded_tree, folded_report = transplant(
                load_model(store["folded"][name]), fresh[name], None,
                xs[name])
            load_flax_tree(fresh[name], folded_tree)
            with torch.no_grad():
                logits_err = float((fresh[name](xs[name])
                                    - module(xs[name])).abs().max())
            folded_report = verify_transplant(
                load_model(store["folded"][name]), fresh[name], folded_tree,
                xs[name], folded_report)
            back = Path(store["dir"]) / f"{name}_back.onnx"
            write_back(str(store["unfolded"][name]), module, None, xs[name],
                       str(back))
            a = load_model(store["unfolded"][name]).graph.initializers
            b = load_model(back).graph.initializers
            bit_equal = a.keys() == b.keys() and all(
                a[k].to_numpy().tobytes() == b[k].to_numpy().tobytes()
                for k in a)
            out[name] = {
                "layers": len(report.entries), "transplant_s": t_s,
                "leaves_max_abs_err_vs_msgpack": leaf_err,
                "folded_logits_max_abs_err": logits_err,
                "folded_layer_max_abs_err": max(
                    (e.max_abs_diff for e in folded_report.entries
                     if e.max_abs_diff is not None), default=None),
                "write_back_bit_equal": bit_equal}
            checks[name] = (leaf_err <= 1e-6 and logits_err <= 1e-3
                            and bit_equal)
        half = full77f_modules()["recognizer"].half().to(dev)
        path = Path(store["dir"]) / "recognizer_fp16.onnx"
        torch_export(half, torch.rand(2, 80, 512, device=dev).half(),
                     str(path), input_names=["input"],
                     output_names=["output"], dynamic_axes=REC_AXES)
        fn = OnnxGraphFunction(load_model(path))
        x = xs["recognizer"].half()
        with torch.no_grad():
            got, want = fn(fn.weights, x)[0], half(x)
        err = float((got.float() - want.float()).abs().max())
        out["fp16_recognizer"] = {
            "logits_max_abs_err": err,
            "logits_max_abs": float(want.float().abs().max()),
            "bytes": path.stat().st_size}
        # tests/test_onnx_fp16.py's executor bar: full77f's logits reach
        # |x| ~ 12, where one fp16 step is 2^-7, and BatchNorm folded into
        # the fp16 conv weights rounds differently from the module's
        checks["fp16"] = err <= 3e-2
    return {"_ok": all(checks.values()), "checks": checks, **out,
            "gpu": gpu_name_and_limit()}


@phase("onnx_cli")
def onnx_cli(store: dict, results: dict):
    """bocr (in this process, so its launches count) on a model directory
    whose model_config.json names the exported recognizer.onnx and a line
    config naming lines.onnx, the fixture pages as PNG, TF32 off: each
    page's text equal to float32 run_ocr's on the same file;
    compat.ort.InferenceSession on the exported recognizer: outputs equal
    to the OnnxModule's graph."""
    from ocr_inference_tpu_torch.cli import cli
    from ocr_inference_tpu_torch.compat import ort
    from ocr_inference_tpu_torch.core.data import Encoding
    from ocr_inference_tpu_torch.io.artifacts import write_png
    from ocr_inference_tpu_torch.io.images import read_image
    from ocr_inference_tpu_torch.pipeline import build_pipeline

    pages, _ = fixture()
    checks = {}
    with tempfile.TemporaryDirectory() as tmp, no_tf32():
        root = Path(tmp)
        model, lines = write_model_dirs(root)
        config = json.loads((model / "model_config.json").read_text())
        config["onnx-model"] = str(store["folded"]["recognizer"])
        (model / "model_config.json").write_text(json.dumps(config))
        config = json.loads((lines / "config.json").read_text())
        config["onnx-model"] = str(store["folded"]["lines"])
        (lines / "config.json").write_text(json.dumps(config))
        page_dir = root / "pages"
        page_dir.mkdir()
        for name, img, _ in pages:
            write_png(page_dir / f"{name}.png", img[..., ::-1])
        t0 = time.perf_counter()
        with counted_path(results, "onnx_cli"):
            rc = cli.main(["--model", str(model), "--folder", str(page_dir),
                           "--output", str(root / "out"), "--line-model",
                           str(lines), "--encoding", "wylie"])
        cli_s = time.perf_counter() - t0
        pipe = build_pipeline(*onnx_configs(store), dtype=torch.float32)
        same = {}
        for name, _, _ in pages:
            img = read_image(page_dir / f"{name}.png")
            # the CLI's defaults: no line merging
            _, payload = pipe.run_ocr(img, merge_lines=False,
                                      target_encoding=Encoding.WYLIE)
            want = "".join(f"{ln.text}\n" for ln in payload[2])
            got = root / "out" / f"{name}.txt"
            same[name] = got.is_file() and got.read_text(
                encoding="utf-8") == want
        checks["bocr_rc_0"] = rc == 0
        checks["bocr_texts_equal_run_ocr_f32"] = all(same.values())
        session = ort.InferenceSession(str(store["folded"]["recognizer"]))
        x = np.random.default_rng(0).uniform(
            -1, 1, (8, 80, 1024)).astype(np.float32)
        got = session.run(None, {"input": x})[0]
        fn = pipe.ocr_inference.model.fn
        want = fn(fn.weights, torch.from_numpy(x).cuda())[0].cpu().numpy()
        checks["ort_session_equals_executor"] = (
            session.get_providers()[0] == "CUDAExecutionProvider"
            and got.shape == want.shape and np.array_equal(got, want))
    return {"_ok": all(checks.values()), "checks": checks,
            "texts_equal": same, "cli_s": cli_s,
            "launches": results["launches"]["onnx_cli"],
            "gpu": gpu_name_and_limit()}


# -- the public surface: the card-side ops, the examples' flows, a profile --

def line_inference_flow(root: Path, lines_dir: Path) -> dict:
    """examples/line_inference.py through the port's names: full77f's UNet
    in float32 (TF32 off), predict_many_async over the fixture pages,
    get_contours, create_preview_image, write_png. Each page's mask
    equals engine.predict's and its preview PNG reads back equal."""
    from ocr_inference_tpu_torch.core.assets import read_line_model_config
    from ocr_inference_tpu_torch.geometry import get_contours
    from ocr_inference_tpu_torch.io.artifacts import write_png
    from ocr_inference_tpu_torch.io.images import read_image
    from ocr_inference_tpu_torch.pipeline.builder import build_detection_engine
    from ocr_inference_tpu_torch.utils import enable_compilation_cache
    from ocr_inference_tpu_torch.utils.preview import create_preview_image

    enable_compilation_cache()
    config = read_line_model_config(str(lines_dir / "config.json"))
    engine = build_detection_engine(config, dtype=torch.float32)
    pages, _ = fixture()
    out, ok = {}, True
    with no_tf32():
        t0 = time.perf_counter()
        resolvers = engine.predict_many_async([img for _, img, _ in pages])
        for (name, img, _), resolve in zip(pages, resolvers):
            mask = resolve()
            contours = get_contours(mask)
            preview = create_preview_image(img.copy(),
                                           line_predictions=list(contours))
            path = root / f"{name}_preview.png"
            write_png(path, preview[..., ::-1])
            same = bool(np.array_equal(mask, engine.predict(img)))
            back = bool(np.array_equal(read_image(path), preview))
            ok &= same and back and len(contours) > 0
            out[name] = {"contours": len(contours),
                         "mask_equals_predict": same,
                         "png_reads_back": back}
        seconds = time.perf_counter() - t0
    return {"ok": ok, "pages": out, "s": seconds}


def demo_ocr_flow(root: Path, model_dir: Path, lines_dir: Path) -> dict:
    """examples/demo_ocr.py through the port's names: import_local_model,
    build_pipeline at its defaults (bf16), one page in eval mode saved
    with save_ocr_lines_parquet, then the fixture pages as PNG through
    VolumeRunner with TextExporter and PageXMLExporter. Each page's texts
    equal bf16 run_ocr's."""
    from ocr_inference_tpu_torch.core.assets import (
        import_local_model,
        read_line_model_config,
    )
    from ocr_inference_tpu_torch.core.data import Encoding, OpStatus
    from ocr_inference_tpu_torch.io.artifacts import write_png
    from ocr_inference_tpu_torch.io.exporter import PageXMLExporter, TextExporter
    from ocr_inference_tpu_torch.io.images import read_image
    from ocr_inference_tpu_torch.io.parquet import read_table, save_ocr_lines_parquet
    from ocr_inference_tpu_torch.pipeline.builder import build_pipeline
    from ocr_inference_tpu_torch.pipeline.volume import VolumeRunner

    model = import_local_model(str(model_dir))
    line_cfg = read_line_model_config(str(lines_dir / "config.json"))
    pipeline = build_pipeline(model.config, line_cfg)
    pages, _ = fixture()
    folder, out = root / "volume", root / "demo_out"
    folder.mkdir()
    out.mkdir()
    paths = []
    for name, img, _ in pages:
        paths.append(folder / f"{name}.png")
        write_png(paths[-1], img[..., ::-1])
    checks = {}
    status, result = pipeline.run_ocr(read_image(paths[0]), eval_mode=True)
    checks["eval_mode_page"] = status == OpStatus.SUCCESS
    if checks["eval_mode_page"]:
        save_ocr_lines_parquet(result[2], out / "ocr_lines.parquet")
        rows = read_table(out / "ocr_lines.parquet")
        checks["parquet_rows"] = [r["text"] for r in rows] == \
            [ln.text for ln in result[2]] and len(rows) > 0
    t0 = time.perf_counter()
    records = VolumeRunner(pipeline).run(
        [(p.name, (lambda p=p: read_image(p))) for p in paths],
        target_encoding=Encoding.UNICODE)
    seconds = time.perf_counter() - t0
    text_exp, xml_exp = TextExporter(str(out)), PageXMLExporter(str(out))
    per_page = {}
    for rec, path in zip(records, paths):
        image = read_image(path)
        texts = [ln.text for ln in rec.ocr_lines]
        st, payload = pipeline.run_ocr(image, target_encoding=Encoding.UNICODE)
        want = [ln.text for ln in payload[2]] if st == OpStatus.SUCCESS else None
        name = path.stem
        text_exp.export_lines(image, name, rec.lines, rec.ocr_lines,
                              angle=rec.angle)
        xml_exp.export_lines(image, name, rec.lines, rec.ocr_lines,
                             angle=rec.angle)
        written = (out / f"{name}.txt").read_text(encoding="utf-8")
        xml_lines = len(ET.parse(out / f"{name}.xml").getroot().findall(
            ".//{*}TextLine"))
        per_page[name] = {
            "status": rec.status.name, "lines": len(texts),
            "texts_equal_run_ocr": texts == want,
            "txt_has_texts": all(t in written for t in texts),
            "xml_text_lines": xml_lines}
        checks[name] = (rec.status == OpStatus.SUCCESS and texts == want
                        and len(texts) > 0 and xml_lines == len(texts)
                        and per_page[name]["txt_has_texts"])
    return {"ok": all(checks.values()), "checks": checks, "pages": per_page,
            "volume_s": seconds}


def modern_layout_flow(root: Path) -> dict:
    """examples/modern_layout.py through the port's names: the seeded
    full-width DeepLabV3+ (the layout record's five classes and seed, at
    the defaults, bf16) behind ModernBookFormatLayoutDetection over the
    fixture pages, then create_layout_preview of each page's mask."""
    from ocr_inference_tpu_torch.core.data import LayoutDetectionConfig
    from ocr_inference_tpu_torch.pipeline.builder import build_detection_engine
    from ocr_inference_tpu_torch.pipeline.modern_layout import (
        ModernBookFormatLayoutDetection,
    )
    from ocr_inference_tpu_torch.io.artifacts import write_png
    from ocr_inference_tpu_torch.utils.preview import create_layout_preview

    record, _ = layout_record()
    config = LayoutDetectionConfig(
        checkpoint="", onnx_file="", architecture="deeplabv3plus",
        patch_size=512, classes=list(record["classes"]))
    det = ModernBookFormatLayoutDetection(config, engine=build_detection_engine(
        config, allow_random=True, seed=record["seed"]))
    pages, _ = fixture()
    page_dir, json_dir = root / "layout_pages", root / "layout_out"
    page_dir.mkdir()
    for name, img, _ in pages:
        write_png(page_dir / f"{name}.png", img[..., ::-1])
    t0 = time.perf_counter()
    found = det.run(str(page_dir), str(json_dir),
                    filter_classes=["image", "line"], batch_size=4)
    seconds = time.perf_counter() - t0
    found = {Path(p).stem: v for p, v in found.items()}
    per_page, ok = {}, set(found) == {n for n, _, _ in pages}
    for name, img, _ in pages:
        on_disk = json.loads((json_dir / f"{name}.json").read_text())
        mask = det.engine.predict(img)
        preview = create_layout_preview(img.copy(), mask, config.classes)
        bboxes = [v["bbox"] for v in found.get(name, {}).values()]
        inside = all(b["x"] >= 0 and b["y"] >= 0
                     and b["x"] + b["w"] <= img.shape[1]
                     and b["y"] + b["h"] <= img.shape[0] for b in bboxes)
        ok &= (on_disk == found.get(name) and inside
               and preview.shape == img.shape and bool((preview != img).any()))
        per_page[name] = {"classes": sorted(found.get(name, {})),
                          "json_equals_run": on_disk == found.get(name),
                          "bboxes_inside": inside,
                          "record_f32_json": record["modern_layout"].get(name)}
    return {"ok": ok, "pages": per_page, "s": seconds}


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BINARIZE_NAME = re.compile(r"binarize_kernel(?:<\d+, \d+, (\d)>|"
                           r"ILi\d+ELi\d+ELi(\d)E)")


def trace_summary(trace: Path, window_name: str) -> dict:
    """From a Chrome trace of trace_profile, over the annotated window:
    the ten device ops with the most time (ms and count), the card's busy
    share (the union of the device events over the window's span), and
    the binarize kernels' device events by specialisation (3: tiles, 1:
    lines)."""
    events = json.loads(trace.read_text())["traceEvents"]
    window = [e for e in events if e.get("name") == window_name
              and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError(f"the trace holds no {window_name} window")
    t0 = float(window[0]["ts"])
    t1 = t0 + float(window[0]["dur"])
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and float(e["ts"]) < t1
              and float(e["ts"]) + float(e.get("dur", 0)) > t0]
    if not device:
        raise RuntimeError("the trace holds no device event in its window")
    totals: dict = {}
    spans = []
    binarize = {"tiles": 0, "lines": 0}
    for e in device:
        name, ts, dur = e["name"], float(e["ts"]), float(e.get("dur", 0))
        ms, n = totals.get(name, (0.0, 0))
        totals[name] = (ms + dur / 1e3, n + 1)
        spans.append((max(ts, t0), min(ts + dur, t1)))
        m = BINARIZE_NAME.search(name)
        if m:
            binarize["tiles" if (m.group(1) or m.group(2)) == "3"
                     else "lines"] += 1
    busy, end = 0.0, t0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(totals.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    return {"window_ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / (t1 - t0), "device_events": len(device),
            "device_ms": sum(ms for ms, _ in totals.values()),
            "binarize_events": binarize, "trace_bytes": trace.stat().st_size,
            "top_device_ops": [[k[:90], ms, n] for k, (ms, n) in top]}


@phase("public_api")
def public_api(results: dict):
    """(a) ops.binarize, gaussian_blur_gray, adaptive_threshold_gaussian,
    dilate_rect and erode_rect of a bench page on the card; (b) the three
    examples' flows; (c) a trace_profile of one bf16 run_ocr."""
    from ocr_inference_tpu_torch import ops
    from ocr_inference_tpu_torch.ops import kernels
    from ocr_inference_tpu_torch.utils import trace_profile

    checks, out = {}, {}
    page = bench_page(42)
    x = torch.from_numpy(page).cuda()
    with counted_path(results, "public_api"):
        got = ops.binarize(x)
    want = kernels.binarize_tiles_plain(x[None])[0]
    checks["binarize_equals_plain"] = bool(
        torch.equal(got, want[..., None].expand(*want.shape, 3)))
    out["binarize"] = {"shape": list(got.shape),
                       "ms": cuda_ms(ops.binarize, x),
                       "plain_ms": cuda_ms(
                           lambda t: kernels.binarize_tiles_plain(t[None]),
                           x, iters=3),
                       "launches": results["launches"]["public_api"]}
    gray = ops.rgb_to_gray(x)
    gray_cpu = gray.cpu()
    for k in (51, 15):
        err = float((ops.gaussian_blur_gray(gray, k).cpu()
                     - ops.gaussian_blur_gray(gray_cpu, k)).abs().max())
        out[f"gaussian_blur_{k}_max_abs_err"] = err
        checks[f"gaussian_blur_{k}"] = err <= 1e-4
    card = ops.adaptive_threshold_gaussian(gray, 255, 31, 10).cpu()
    checks["adaptive_31_10_equals_cpu"] = bool(torch.equal(
        card, ops.adaptive_threshold_gaussian(gray_cpu, 255, 31, 10)))
    mask, mask_cpu = got[..., 0], got[..., 0].cpu()
    for name, fn, args in (("dilate_12x2x10", ops.dilate_rect, (12, 2, 10)),
                           ("erode_3x3x2", ops.erode_rect, (3, 3, 2))):
        checks[f"{name}_equals_cpu"] = bool(torch.equal(
            fn(mask, *args).cpu(), fn(mask_cpu, *args)))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        model_dir, lines_dir = write_model_dirs(root)
        with counted_path(results, "examples"):
            flows = {"line_inference": line_inference_flow(root, lines_dir),
                     "demo_ocr": demo_ocr_flow(root, model_dir, lines_dir),
                     "modern_layout": modern_layout_flow(root)}
        for name, flow in flows.items():
            checks[f"example_{name}"] = flow.pop("ok")
        pipe = full77f_pipeline(torch.bfloat16)
        run_page(pipe, page)  # warm-up
        torch.cuda.synchronize()
        with trace_profile(str(root / "trace")):
            # the page once more before the window: in a process that
            # has profiled before, a new profiler's first kernels can be
            # missing from the trace (seen on the card)
            run_page(pipe, page)
            torch.cuda.synchronize()
            with torch.profiler.record_function("public_api/run_ocr"):
                run_page(pipe, page)
        profile = trace_summary(next((root / "trace").glob("*.json")),
                                "public_api/run_ocr")
    checks["trace_holds_both_binarize_kernels"] = all(
        n > 0 for n in profile["binarize_events"].values())
    return {"_ok": all(checks.values()), "checks": checks, **out,
            "examples": flows, "profile_bench_page_bf16": profile,
            "launches": results["launches"]["examples"],
            "gpu": gpu_name_and_limit()}


# -- more than one device --

# the card the 2x1 and 1x2 meshes repeat
MESH_CARD = "cuda:0"

def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def world_of_one() -> dict:
    """distributed_init from the JAX cluster variables into a world-size-1
    nccl group on localhost, one all_reduce of a CUDA tensor, the group
    destroyed and the variables restored."""
    import torch.distributed as dist

    from ocr_inference_tpu_torch.parallel import distributed_init

    env = {"JAX_COORDINATOR_ADDRESS": f"localhost:{free_port()}",
           "JAX_NUM_PROCESSES": "1", "JAX_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        distributed_init("cuda")
        x = torch.arange(4, dtype=torch.float32, device="cuda")
        dist.all_reduce(x)
        out = {"backend": dist.get_backend(),
               "world_size": dist.get_world_size(), "rank": dist.get_rank(),
               "all_reduce": x.cpu().tolist()}
        dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["ok"] = (out["backend"] == "nccl" and out["world_size"] == 1
                 and out["all_reduce"] == [0.0, 1.0, 2.0, 3.0])
    return out


def mesh_pages(pipe, pages) -> tuple[dict, float]:
    """({page: (texts, boxes)}, median host ms a page, synchronised)."""
    out, times = {}, []
    for name, img, _ in pages:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        texts, lines, _ = run_page(pipe, img)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        out[name] = (texts, [list(ln.bbox.as_tuple()) for ln in lines])
    return out, _median(times)


# the float32 gradient's largest distance per leaf from mesh=None's,
# relative to the leaf's norm: sound 2x1 steps read 6.86e-5 on the card
# (float64 CPU tests hold 1e-5), a step that drops one group's gradient
# reads about 0.5
GRAD_LEAF_LIMIT = 1e-3


def mesh_train_step(results: dict) -> dict:
    """One float32 Easter2 step of full77f on a batch of 32 canvases of
    its recipe (training.json; learning rate 3e-4 without the warmup, so
    that the step moves the weights) on a 2x1 mesh of this card against
    mesh=None, at tests/test_torch_parallel.py's bars where float32 can
    meet them: the loss within rel 1e-6, the running statistics within
    rtol 1e-6 and atol 1e-6; the parameters' mean distance under 1e-3 of
    what Adam's first step can move one (2 lr). Each gradient leaf within
    GRAD_LEAF_LIMIT of its norm, a limit a planted fault (the gradient of
    data group 1 dropped from the sum) must exceed."""
    import copy

    from ocr_inference_tpu_torch.eval.synthetic import (
        WYLIE_CHARSET_FULL, GlyphSet, recognizer_batch,
    )
    from ocr_inference_tpu_torch.models.params import load_flax_weights
    from ocr_inference_tpu_torch.models.recognition import build_recognizer
    from ocr_inference_tpu_torch.parallel import make_mesh
    from ocr_inference_tpu_torch.training import (
        make_optimizer, make_train_step,
    )
    from ocr_inference_tpu_torch.training.train import (
        MeshGradient, model_state, recognizer_loss, value_and_grad,
    )

    class DroppedGroup(MeshGradient):
        """The planted fault: data group 1's gradient left out of the
        sum over the groups."""

        def _grad_of(self, rep, name, grads):
            g = super()._grad_of(rep, name, grads)
            return torch.zeros_like(g) if rep is self.replicas[1] else g

    record = json.loads(TRAIN_RECORD.read_text())["rec"]
    dev = torch.device(MESH_CARD)
    model = build_recognizer("Easter2", len(WYLIE_CHARSET_FULL) + 1).to(dev)
    load_flax_weights(model, WEIGHTS / "recognizer.msgpack")
    recipe = dict(record["recipe"])
    size = recipe.pop("batch")
    glyphs = GlyphSet(charset=WYLIE_CHARSET_FULL, **FULL_GLYPHS)
    mesh = make_mesh(devices=[dev] * 2)
    lr = record["optimizer"]["learning_rate"]
    runs = {}
    with no_tf32(), counted_path(results, "mesh_train"):
        batch = recognizer_batch(np.random.RandomState(record["seed"]),
                                 glyphs, WYLIE_CHARSET_FULL, size,
                                 device=dev, **recipe)
        for name, m in (("off", None), ("2x1", mesh)):
            tm = copy.deepcopy(model)
            opt = make_optimizer(lr, record["optimizer"]["total_steps"], 0)
            step = make_train_step(tm, opt, m)
            _, loss = step(model_state(tm, opt).as_tuple(), batch)
            runs[name] = {"loss": float(loss),
                          "params": dict(tm.named_parameters()),
                          "stats": dict(tm.named_buffers())}
        _, g_off = value_and_grad(copy.deepcopy(model), recognizer_loss(),
                                  batch)
        _, g_mesh = MeshGradient(copy.deepcopy(model), mesh)(
            recognizer_loss(), batch)
        _, g_fault = DroppedGroup(copy.deepcopy(model), mesh)(
            recognizer_loss(), batch)
    off, on = runs["off"], runs["2x1"]
    diffs = [(on["params"][k] - p).detach().abs()
             for k, p in off["params"].items()]
    moved = 2 * lr
    mean_diff = float(sum(d.sum() for d in diffs)) / sum(
        d.numel() for d in diffs)
    stats_ok = all(torch.allclose(on["stats"][k], v, rtol=1e-6, atol=1e-6)
                   for k, v in off["stats"].items())
    stats_err = max(float(((on["stats"][k] - v).abs()
                           / (v.abs() + 1e-6)).max())
                    for k, v in off["stats"].items())
    names = list(off["params"])

    def leaf_errors(grads):
        return {n: float((a - b).norm() / (b.norm() + 1e-30))
                for n, a, b in zip(names, grads, g_off)}

    sound, fault = leaf_errors(g_mesh), leaf_errors(g_fault)
    grad_rel = max(sound.values())
    loss_rel = abs(on["loss"] - off["loss"]) / abs(off["loss"])
    return {"ok": loss_rel <= 1e-6 and mean_diff <= 1e-3 * moved
            and stats_ok and grad_rel <= GRAD_LEAF_LIMIT
            and max(fault.values()) > GRAD_LEAF_LIMIT,
            "loss": on["loss"], "loss_off": off["loss"],
            "loss_rel_err": loss_rel,
            "param_max_diff": max(float(d.max()) for d in diffs),
            "param_mean_diff": mean_diff, "adam_bound": moved,
            "stats_within_rtol_1e-6": stats_ok,
            "stats_max_rel_err": stats_err,
            "grad_max_rel_err_per_leaf": grad_rel,
            "grad_worst_leaf": max(sound, key=sound.get),
            "grad_leaf_limit": GRAD_LEAF_LIMIT,
            "planted_fault_grad_max_rel_err": max(fault.values()),
            "planted_fault_grad_min_rel_err": min(fault.values())}


@phase("mesh")
def mesh_phase(results: dict):
    """More than one device, on this card: a world-size-1 nccl group;
    float32 page OCR (TF32 off) of the fixture pages and a bench page on a
    mesh over every visible card, a 2x1 mesh and a 1x2 mesh (head split)
    of cuda:0, each against --mesh off; one Easter2 step on a 2x1 mesh against mesh=None;
    bocr --mesh auto against --mesh off, and a --mesh of more cards than
    the machine has refused naming the count."""
    from ocr_inference_tpu_torch.cli import cli
    from ocr_inference_tpu_torch.io.artifacts import write_png
    from ocr_inference_tpu_torch.parallel.mesh import local_devices, make_mesh
    from ocr_inference_tpu_torch.parallel.replicas import SplitHead

    checks = {}
    group = world_of_one()
    checks["nccl_world_of_one"] = group.pop("ok")
    pages, _ = fixture()
    cards = local_devices("cuda")
    meshes = {"cards": make_mesh(devices=cards),
              "2x1": make_mesh(devices=[MESH_CARD] * 2),
              "1x2": make_mesh(devices=[MESH_CARD] * 2, model_parallel=2)}
    # the fixture pages (3-4 tiles: one group detects), and a bench.py
    # config 4 page (24 tiles and about 60 lines: every group of the 2x1
    # mesh detects and reads)
    pages = pages + [("bench_42", bench_page(42), None)]
    with no_tf32():
        off = full77f_pipeline(torch.float32)
        mesh_pages(off, pages)  # warm-up: cuDNN plans, allocator
        want, off_ms = mesh_pages(off, pages)
        del off
        page_ms = {"off": off_ms}
        for name, mesh in meshes.items():
            pipe = full77f_pipeline(torch.float32, mesh=mesh)
            with counted_path(results, f"mesh_page/{name}"):
                got, _ = mesh_pages(pipe, pages)
            _, page_ms[name] = mesh_pages(pipe, pages)
            checks[f"{name}_texts_and_boxes_equal_off"] = got == want
            if name == "1x2":
                checks["1x2_head_split"] = isinstance(
                    pipe.ocr_inference._replicas[0].Conv_0, SplitHead)
            del pipe
    train = mesh_train_step(results)
    checks["train_2x1_equal_off"] = train.pop("ok")

    with tempfile.TemporaryDirectory() as tmp, no_tf32():
        root = Path(tmp)
        model, lines = write_model_dirs(root)
        page_dir = root / "pages"
        page_dir.mkdir()
        for name, img, _ in pages[:3]:
            write_png(page_dir / f"{name}.png", img[..., ::-1])

        def args(out, spec):
            return ["--model", str(model), "--folder", str(page_dir),
                    "--output", str(root / out), "--line-model", str(lines),
                    "--encoding", "wylie", "--dtype", "float32",
                    "--mesh", spec]

        rc_off = cli.main(args("off", "off"))
        checks["bocr_mesh_auto_is_every_card"] = cli.build_mesh(
            "auto", "cuda").shape == {"data": len(cards), "model": 1}
        with counted_path(results, "mesh_cli"):
            rc_auto = cli.main(args("auto", "auto"))
        texts_equal = all(
            (root / "auto" / f"{n}.txt").read_text(encoding="utf-8")
            == (root / "off" / f"{n}.txt").read_text(encoding="utf-8")
            for n, _, _ in pages[:3])
        checks["bocr_mesh_auto_equal_off"] = (rc_off == 0 and rc_auto == 0
                                              and texts_equal)
        too_many = len(cards) + 1
        try:
            cli.main(args("many", str(too_many)))
            refusal = "no exit"
        except SystemExit as e:
            refusal = str(e.code)
        checks["too_many_cards_refused"] = (
            f"this machine has {len(cards)}" in refusal
            and not (root / "many").exists())
    return {"_ok": all(checks.values()), "checks": checks,
            "device_count": torch.cuda.device_count(),
            "nccl": group, "page_ms": page_ms,
            "mesh_shapes": {k: m.shape for k, m in meshes.items()},
            "train": train, "refusal": refusal,
            "launches": {p: results["launches"][p] for p in (
                *(f"mesh_page/{k}" for k in meshes), "mesh_train",
                "mesh_cli")},
            "gpu": gpu_name_and_limit()}


def onnx_phases(results: dict) -> None:
    """The five ONNX phases over one temporary directory of exports."""
    with tempfile.TemporaryDirectory() as tmp:
        store = {"dir": tmp}
        onnx_export(store)
        if "onnx_export" in FAILED:
            return
        onnx_page_f32(store, results)
        onnx_volume(store, results)
        onnx_weights(store)
        onnx_cli(store, results)


MAIN_PATHS = ("page_ocr_bf16", "volume_bf16", "dewarp_volume_bf16",
              "eval_mode_bf16", "layout_bf16", "cli", "serve", "eval_cli",
              *(f"recognizers_bf16/{arch}" for arch in RECOGNIZERS),
              "bocr_formats", "bocr_lines", "train_rec_f32", "train_seg_f32",
              "selftrain", "onnx_page_f32", "onnx_volume", "onnx_cli",
              "public_api", "examples", "mesh_page/cards",
              "mesh_page/2x1", "mesh_page/1x2", "mesh_train", "mesh_cli")
# the counted paths that run only some of the kernels: the eval CLI's
# lines are binarized whole and recognized, no page is detected;
# bocr-lines detects and reads no line; the recognizer's training batches
# are line canvases, the UNet's are tiles. bocr-train and bocr-train-seg
# binarize nothing (the JAX CLIs train on gray canvases and RGB tiles), so
# the train_cli phase is not a counted path; selftrain runs both kernels.
# ops.binarize of a page at 51/13 is one tile launch.
PATH_KERNELS = {"eval_cli": ("binarize_lines",),
                "bocr_lines": ("binarize_tiles",),
                "public_api": ("binarize_tiles",),
                "train_rec_f32": ("binarize_lines",),
                "mesh_train": ("binarize_lines",),
                "train_seg_f32": ("binarize_tiles",)}


def idle_kernels(summary: dict) -> list[tuple[str, str]]:
    """(kernel, path) pairs where a counted path that runs the kernel
    launched it no time."""
    return [(k["name"], path) for k in summary["kernels"]
            for path, n in k["launches_by_path"].items()
            if n == 0 and k["name"] in PATH_KERNELS.get(path, (k["name"],))]


def kernels_line(results: dict) -> dict:
    """The per-kernel summary: launches and rechecked pixels over the main
    paths (bf16 page OCR, the bf16 volume, the dewarped bf16 volume, bf16
    eval mode, the bf16 layout volume, the CLI, the serving loop, the eval
    CLI's evaluator and the other recognizers' bf16 volumes), with each
    path's own count;
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
        recognizers_f32(results)
        recognizers_bf16(results)
        serve_phase(results)
        eval_cli_phase(results)
        image_formats(results)
        train_rec_f32(results)
        train_seg_f32(results)
        train_cli_phase(results)
        selftrain_phase(results)
        train_rates(results)
        onnx_phases(results)
        public_api(results)
        mesh_phase(results)
    if FAILED:
        print(f"chip_smoke: failed phases {FAILED}", file=sys.stderr)
        return 1
    summary = kernels_line(results)
    if idle_kernels(summary) or any(
            k["launches"] == 0 or k["max_abs_err"] != 0
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
