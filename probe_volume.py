"""Where the port's volume path differs from page OCR, on one NVIDIA card.

    python3 probe_volume.py

Makes chip_smoke.py's bench.py volume (1600x2640 pages, seed 42) and
prints one JSON line per probe:

1. dispatch  — SegmentationEngine.predict_async alone on the main thread,
               8 pages queued back to back and then resolved: each call's
               host time, whether the card was idle when it returned,
               whether PyTorch's sync debug mode caught a synchronizing
               call in it, each resolver's wait, and the card time of one
               page's upload;
2. batch     — the bf16 recognizer on the same 32 real line canvases:
               Easter2 called on 32 at once against 8 at a time (lines
               whose texts differ, CER), and the engine (calls of
               MODEL_BATCH) in logical batches of 32 and 8 and with other
               neighbours;
3. texts     — CER between texts of the same pages read by: the bf16
               volume and bf16 run_ocr; bf16 run_ocr twice; the float32
               (TF32 off) volume and float32 run_ocr; bf16 and float32
               run_ocr;
4. host      — each step of page OCR on one thread, the card
               synchronized after each (medians over 8 pages), and the busy
               time of each of the volume's threads in one 48-page run;
5. profile   — torch.profiler over a bf16 volume run of 16 pages: the
               card's busy time against the run's wall time, and the top
               CUDA kernels and CPU ops by time.

Imports torch, numpy, chip_smoke and the port; nothing of JAX. Exits
non-zero without CUDA.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def probe_dispatch(pipe, pages) -> dict:
    """predict_async on 8 pages back to back, then their resolvers: host
    ms of each dispatch, whether the card was already idle when it
    returned, and whether PyTorch saw a synchronizing call inside it
    (``torch.cuda.set_sync_debug_mode("error")`` raises on one)."""
    det = pipe.line_inference
    det.predict(pages[0])  # warm
    torch.cuda.synchronize()
    calls, idle, sync_error = [], [], None
    resolvers = []
    for img in pages[:8]:
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            resolvers.append(det.predict_async(img))
        except RuntimeError as e:
            sync_error = str(e)[:300]
            resolvers.append(lambda: None)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        calls.append((time.perf_counter() - t0) * 1e3)
        idle.append(torch.cuda.current_stream().query())
    waits = []
    for resolve in resolvers:
        t0 = time.perf_counter()
        resolve()
        waits.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det.predict(pages[1])
    one_page_ms = (time.perf_counter() - t0) * 1e3
    return {"dispatch_ms": calls, "card_idle_after_dispatch": idle,
            "sync_debug_error": sync_error, "resolve_wait_ms": waits,
            "one_page_predict_ms": one_page_ms,
            "page_upload_ms": upload_ms(pages[1])}


def upload_ms(page: np.ndarray, iters: int = 20) -> float:
    """Card time of one page's pinned, non-blocking upload (the copy
    predict_async queues), CUDA events around ``iters`` copies."""
    staging = torch.from_numpy(page).pin_memory()
    dev = staging.to("cuda", non_blocking=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        dev.copy_(staging, non_blocking=True)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def read_lines(rec, canvases, batch):
    """Texts of ``canvases`` read by the engine in logical batches of
    ``batch`` (each run in Easter2 calls of MODEL_BATCH)."""
    out = []
    for start in range(0, len(canvases), batch):
        chunk = canvases[start: start + batch]
        with rec._on_stream():
            pending = rec._dispatch(chunk[0].shape[1], chunk, batch)
        out.extend(rec._texts(range(len(chunk)), pending).values())
    return out


@torch.inference_mode()
def read_lines_raw(rec, canvases, batch):
    """Texts of ``canvases`` with Easter2 called on ``batch`` canvases at
    once: the model without the engine's fixed call size."""
    from ocr_inference_tpu_torch.decode.ctc import (
        greedy_decode_packed, ids_to_tokens, unpack_greedy_host,
    )
    from ocr_inference_tpu_torch.ops import kernels

    out = []
    for start in range(0, len(canvases), batch):
        chunk = np.stack(canvases[start: start + batch])
        x = kernels.binarize_lines(torch.from_numpy(chunk).cuda())
        x = x.to(torch.float32) / 127.5 - 1.0
        ids, lengths, _ = unpack_greedy_host(
            greedy_decode_packed(rec.model(x)).cpu().numpy())
        out += ["".join(ids_to_tokens(ids[i], int(lengths[i]), rec.charset,
                                      rec.config.add_blank))
                for i in range(len(chunk))]
    return out


def probe_batch(pipe, pages) -> dict:
    """The same 32 line canvases: Easter2 called with 32 against 8 at a
    time, and the engine's texts for them in logical batches of 32 and 8
    and with other neighbours (reversed order)."""
    from ocr_inference_tpu_torch.eval.cer import cer

    rec = pipe.ocr_inference
    canvases = []
    for img in pages:
        status, mask = pipe.detect_lines(img)
        _, (rot_img, rot_mask, _, filtered, _) = pipe.build_lines(img, mask)
        _, (_, strips) = pipe.extract_lines(rot_img, rot_mask, filtered)
        canvases += [rec.prepare_canvas(s) for s in strips if s.size]
    width = max(set(c.shape[1] for c in canvases),
                key=lambda w: sum(c.shape[1] == w for c in canvases))
    same = [c for c in canvases if c.shape[1] == width][:32]
    raw32, raw8 = read_lines_raw(rec, same, 32), read_lines_raw(rec, same, 8)
    t32, t8 = read_lines(rec, same, 32), read_lines(rec, same, 8)
    rev = read_lines(rec, same[::-1], 32)[::-1]
    return {"width": width, "lines": len(same),
            "model_calls_32_vs_8_lines_differ": sum(
                a != b for a, b in zip(raw32, raw8)),
            "model_calls_32_vs_8_cer": cer(raw32, raw8),
            "engine_32_vs_8_lines_differ": sum(
                a != b for a, b in zip(t32, t8)),
            "engine_other_neighbours_lines_differ": sum(
                a != b for a, b in zip(t32, rev)),
            "engine_vs_model_calls_of_8_lines_differ": sum(
                a != b for a, b in zip(t32, raw8))}


def page_texts(pipe, entries) -> dict:
    from ocr_inference_tpu_torch.core.data import Encoding

    out = {}
    for name, img in entries:
        status, payload = pipe.run_ocr(img, target_encoding=Encoding.WYLIE)
        if status.name == "SUCCESS":
            out[name] = " ".join(ln.text for ln in payload[2])
    return out


def volume_texts(pipe, entries) -> dict:
    from ocr_inference_tpu_torch.core.data import Encoding
    from ocr_inference_tpu_torch.pipeline import VolumeRunner

    return {r.name: " ".join(ln.text for ln in r.ocr_lines)
            for r in VolumeRunner(pipe).run(entries,
                                            target_encoding=Encoding.WYLIE)
            if r.status.name == "SUCCESS"}


def versus(a: dict, b: dict) -> float:
    from ocr_inference_tpu_torch.eval.cer import cer

    names = sorted(a)
    return cer([a[n] for n in names], [b[n] for n in names])


def probe_texts(bf16, f32, entries) -> dict:
    vol = volume_texts(bf16, entries)
    page = page_texts(bf16, entries)
    page2 = page_texts(bf16, entries)
    with cs.no_tf32():
        vol32 = volume_texts(f32, entries)
        page32 = page_texts(f32, entries)
    return {"pages": len(page),
            "bf16_volume_vs_bf16_run_ocr": versus(vol, page),
            "bf16_run_ocr_vs_itself": versus(page2, page),
            "f32_volume_vs_f32_run_ocr": versus(vol32, page32),
            "bf16_run_ocr_vs_f32_run_ocr": versus(page, page32)}


def probe_host(pipe, pages, entries) -> dict:
    """Host ms of each step of page OCR, one thread, the card synchronized
    after each step (medians over ``pages``); then the busy time of the
    volume's threads in one bf16 volume run over ``entries``: the main
    thread's dispatches, the geometry threads' stage work and the flush
    thread's canvas padding (``stream_add``) and recognition
    (``stream_run``), against the run's wall time."""
    from ocr_inference_tpu_torch.core.data import Encoding
    from ocr_inference_tpu_torch.pipeline import VolumeRunner

    rec = pipe.ocr_inference
    steps: dict = {}

    def step(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        steps.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    for img in pages:
        resolve = step("detect_dispatch", pipe.detect_lines_async, img)
        _, mask = step("detect_wait", resolve)
        _, (rot_img, rot_mask, _, filtered, _) = step(
            "build_lines", pipe.build_lines, img, mask)
        _, (lines, strips) = step("extract_lines", pipe.extract_lines,
                                  rot_img, rot_mask, filtered)
        step("canvas_padding", lambda: [rec.prepare_canvas(s)
                                        for s in strips if s.size])
        step("recognize_all", pipe.run_text_recognition, strips, lines)
    medians = {k: float(np.median(v)) for k, v in steps.items()}

    busy = {"stream_add": 0.0, "stream_run": 0.0}
    wrapped = {}
    for name in busy:
        fn = getattr(rec, name)
        wrapped[name] = fn

        def timed(*args, _fn=fn, _name=name, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                busy[_name] += (time.perf_counter() - t0) * 1e3

        setattr(rec, name, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records = VolumeRunner(pipe).run(entries,
                                         target_encoding=Encoding.WYLIE)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for name in wrapped:
            delattr(rec, name)
    total = {k: sum(r.timings_ms.get(k, 0.0) for r in records)
             for k in ("detect_dispatch", "geometry")}
    return {"single_thread_median_ms": medians, "volume_pages": len(entries),
            "volume_wall_ms": wall,
            "main_thread_dispatch_ms": total["detect_dispatch"],
            "geometry_threads_ms": total["geometry"],
            "flush_thread_canvas_padding_ms": busy["stream_add"],
            "flush_thread_recognition_ms": busy["stream_run"]}


def probe_profile(pipe, entries) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from ocr_inference_tpu_torch.core.data import Encoding
    from ocr_inference_tpu_torch.pipeline import VolumeRunner

    VolumeRunner(pipe).run(entries[:8], target_encoding=Encoding.WYLIE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        VolumeRunner(pipe).run(entries, target_encoding=Encoding.WYLIE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    busy_us = sum(dev_us(e) for e in events)
    top_dev = sorted(events, key=dev_us, reverse=True)[:12]
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:12]
    return {
        "pages": len(entries), "wall_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e3 / (wall * 1e3),
        "top_device": [[e.key, dev_us(e) / 1e3, e.count] for e in top_dev],
        "top_cpu": [[e.key, e.self_cpu_time_total / 1e3, e.count]
                    for e in top_cpu],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_volume: CUDA is not available", file=sys.stderr)
        return 2
    cs.build()
    if cs.FAILED:
        return 1
    pages = cs.bench_volume(cs.VOLUME_PAGES)
    entries = [(f"page{i:03d}", img) for i, img in enumerate(pages)]
    bf16 = cs.full77f_pipeline(torch.bfloat16)
    f32 = cs.full77f_pipeline(torch.float32)
    emit({"probe": "dispatch", **probe_dispatch(bf16, pages)})
    emit({"probe": "batch", **probe_batch(bf16, pages[:6])})
    emit({"probe": "texts", **probe_texts(bf16, f32, entries)})
    emit({"probe": "host", **probe_host(bf16, pages[:8], entries)})
    emit({"probe": "profile", **probe_profile(bf16, entries[:16])})
    print(cs.gpu_name_and_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
