"""Drive the PyTorch port's page and volume OCR on one NVIDIA card and
check it.

    python3 chip_smoke.py

Builds the kernels from the checkout (nvcc for csrc/*.cu, g++ for the
geometry library, started together), then runs six phases and prints one
JSON line for each:

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
                  largest input the volume gave it.

Kernel launch and recheck counts are zeroed just before each OCR path is
driven (phases 3-6) and read just after it. Then a ``kernels`` JSON line
(per kernel: launches over the main paths, phases 5 and 6, and by path,
the shapes each path launched, rechecked pixels, time, plain time, bound
and share of the bound at the largest shape the main paths launched), the
card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failed phase ends the script with a
non-zero code and without that line. Without CUDA it exits non-zero at
once. Imports torch, numpy and the port; nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
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
    rot_img, rot_mask, _, contours, angle = timed(
        "build_lines", pipe.build_lines, img, mask)
    lines, strips = timed("extract_lines", pipe.extract_lines, rot_img,
                          rot_mask, contours)
    timed("recognize", pipe.run_text_recognition, strips, lines)
    times["page_angle"] = angle
    return times


VOLUME_PAGES = 48
BLANK_AT, RAISING_AT = 5, 20
ALLOWED_BATCHES = {1, 2, 4, 8, 16, 32}


def _raising_loader():
    raise OSError("unreadable page file")


def plain_reads(pipe, entries) -> tuple[dict, float]:
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
                                       observer=obs)
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


MAIN_PATHS = ("page_ocr_bf16", "volume_bf16")


def kernels_line(results: dict) -> dict:
    """The per-kernel summary: launches and rechecked pixels over the main
    paths (bf16 page OCR and the bf16 volume), with each path's own count;
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
        del f32
        page_ocr_bf16(bf16, results)
        volume_bf16(bf16, results)
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
