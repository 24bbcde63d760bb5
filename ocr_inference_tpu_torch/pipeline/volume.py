"""Volume runner: multi-page OCR with cross-page line batching.

Counterpart of ocr_inference_tpu/pipeline/volume.py, behaviour for
behaviour (reference: cli.py:113-139 runs one page at a time, one line per
recognizer call):

- phase 1 (per page, pipelined): detection is queued on the card from the
  main thread up to ``detect_ahead`` pages ahead, while a small pool of
  geometry threads waits for each page's mask and runs the host geometry
  into line strips; page loaders run ahead on a bounded prefetch pool, so a
  volume never holds more than a few decoded pages it has not reached;
- phase 2 (cross-page, streaming): each window's strips join the
  recognizer's width-bucket carry (RecognitionEngine.stream_add); buckets
  run whenever they fill a batch of ``stream_quantum`` lines, and
  under-full buckets carry across windows instead of running batch-1. The
  carry runs on one flush thread, overlapping the next window's detection
  and geometry; held pages are bounded (``max_held_pages``) by
  force-flushing the buckets that block the oldest page;
- phase 3: texts scatter back to their pages and convert encoding, and
  pages are emitted in input order (a page emits once all its lines are
  read and every earlier page has emitted).

Failure isolation is per page: a loader that raises, a ``None`` page, a
blank page or a page the detector rejects fails that page alone. A CUDA
error (``device.is_device_fault``) is not a page's failure: it is sticky,
so it ends the run. The records carry the same payload as
OCRPipeline.run_ocr.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

import numpy as np

from ocr_inference_tpu_torch.core.data import Encoding, Line, OCRLine, OpStatus
from ocr_inference_tpu_torch.device import is_device_fault
from ocr_inference_tpu_torch.pipeline.ocr_pipeline import OCRPipeline


class _PendingPage:
    """One page awaiting line texts from the streaming recognizer."""

    __slots__ = ("rec", "slots", "texts", "remaining", "rec_ms")

    def __init__(self, rec: "PageRecord", tokens: list):
        self.rec = rec
        self.slots = {t: i for i, t in enumerate(tokens)}
        self.texts: list = [None] * len(tokens)
        self.remaining = len(tokens)
        self.rec_ms = 0.0


class _StreamFlusher:
    """Flush-thread state: feeds window strips into the recognizer's
    streaming carry (engines.StreamState), bounds the number of pages held
    waiting on under-full buckets, and finalizes completed pages in input
    order. All methods run on VolumeRunner's single flush worker."""

    def __init__(self, pipeline: OCRPipeline, target_encoding: Encoding,
                 quantum: Optional[int], max_held: int):
        self.p = pipeline
        self.engine = pipeline.ocr_inference
        self.state = self.engine.stream_state()
        self.queue: deque = deque()     # _PendingPage, input order
        self.owner: dict = {}           # token -> _PendingPage
        self.quantum = quantum
        self.max_held = max_held
        self.target_encoding = target_encoding
        self._seq = 0

    def add_window(self, window, final: bool = False) -> list:
        """Ingest one window, run what can run, return completed records."""
        for rec, strips in window:
            tokens = list(range(self._seq, self._seq + len(strips)))
            self._seq += len(strips)
            page = _PendingPage(rec, tokens)
            if rec.status == OpStatus.FAILED:
                page.remaining = 0
            else:
                for tok, strip in zip(tokens, strips):
                    self.engine.stream_add(
                        self.state, tok, strip,
                        pre_pad=self.p.use_line_prepadding,
                    )
                    self.owner[tok] = page
            self.queue.append(page)

        # bound held pages: when more than max_held pages wait on carried
        # buckets, force-flush the buckets blocking the oldest ones (their
        # remainders run at power-of-two shapes, engines.stream_run)
        force: list = []
        if not final:
            unresolved = [pg for pg in self.queue if pg.remaining]
            excess = len(unresolved) - self.max_held
            if excess > 0:
                for pg in unresolved[:excess]:
                    force.extend(
                        t for t, i in pg.slots.items()
                        if pg.texts[i] is None
                    )

        t0 = time.perf_counter()
        err = None
        try:
            texts = self.engine.stream_run(
                self.state, final=final, force_tokens=force,
                quantum=self.quantum,
            )
        except Exception as e:
            if is_device_fault(e):
                raise
            texts, err = {}, f"recognition failed: {e}"
        ms = (time.perf_counter() - t0) * 1000
        if err is not None:
            # every page still holding unresolved lines fails together
            self.state = self.engine.stream_state()
            self.owner.clear()
            for pg in self.queue:
                if pg.remaining:
                    pg.rec.status, pg.rec.error = OpStatus.FAILED, err
                    pg.remaining = 0
        elif texts:
            share = ms / len(texts)
            for tok, text in texts.items():
                pg = self.owner.pop(tok)
                pg.texts[pg.slots[tok]] = text
                pg.remaining -= 1
                pg.rec_ms += share

        done = []
        while self.queue and self.queue[0].remaining == 0:
            done.append(self._finalize(self.queue.popleft()))
        return done

    def _finalize(self, page: "_PendingPage") -> "PageRecord":
        rec = page.rec
        rec.timings_ms["recognize"] = page.rec_ms
        if rec.status == OpStatus.FAILED:
            return rec
        encoding = (Encoding.WYLIE.name
                    if self.target_encoding == Encoding.WYLIE
                    else Encoding.UNICODE.name)
        rec.ocr_lines = [
            OCRLine(
                guid=info.guid,
                text=self.p._convert_text(
                    (text or "").strip().replace("§", " "),
                    self.target_encoding,
                ),
                encoding=encoding,
            )
            for text, info in zip(page.texts, rec.lines)
        ]
        return rec


@dataclass
class PageRecord:
    name: str
    status: OpStatus
    error: Optional[str] = None
    mask: Optional[np.ndarray] = None
    lines: list[Line] = field(default_factory=list)
    ocr_lines: list[OCRLine] = field(default_factory=list)
    angle: float = 0.0
    timings_ms: dict[str, float] = field(default_factory=dict)


class VolumeRunner:
    """Cross-page batched execution of an OCRPipeline."""

    def __init__(
        self,
        pipeline: OCRPipeline,
        window_pages: int = 8,
        prefetch_workers: Optional[int] = None,
        geometry_workers: Optional[int] = None,
        detect_ahead: Optional[int] = None,
        stream_quantum: Optional[int] = None,
        max_held_pages: int = 16,
        adaptive: Optional[bool] = None,
    ):
        # On a 1-2 core host extra threads only time-slice the same core,
        # so the pools shrink to one worker each there.
        ncpu = os.cpu_count() or 1
        if geometry_workers is None:
            geometry_workers = 2 if ncpu > 2 else 1
        if prefetch_workers is None:
            prefetch_workers = 2 if ncpu > 2 else 1
        self.pipeline = pipeline
        self.window_pages = max(1, window_pages)
        self.prefetch_workers = max(1, prefetch_workers)
        self.geometry_workers = max(1, geometry_workers)
        # Pages whose detection may be queued on the card beyond the ones
        # whose geometry is resolving, so the card has the next pages'
        # work while the geometry threads wait on page i's mask. Each page
        # in flight holds its tile stack on the card. OCR_DETECT_AHEAD
        # overrides the default of 8.
        if detect_ahead is None:
            detect_ahead = int(os.environ.get("OCR_DETECT_AHEAD", "8"))
        self.detect_ahead = max(self.geometry_workers + 1, detect_ahead)
        # streaming recognition knobs (see _StreamFlusher): quantum None =
        # the engine default (RecognitionEngine.STREAM_QUANTUM); max held
        # pages bounds both emission delay and the memory of waiting records
        self.stream_quantum = stream_quantum
        self.max_held_pages = max(1, max_held_pages)
        # Adaptive dispatch: when the rolling emit throughput falls below
        # 60% of its p75 for two windows in a row, escalate once (sticky):
        # detect_ahead deepens to 16, and a detector with a packed-upload
        # switch turns it on. The port's detector has none (it binarizes
        # on the card), so that branch does nothing here. OCR_ADAPTIVE=0
        # turns the monitor off.
        if adaptive is None:
            adaptive = os.environ.get("OCR_ADAPTIVE", "1") == "1"
        self.adaptive_enabled = adaptive
        self.adaptive = {"enabled": adaptive, "escalated": False,
                         "events": []}

    # -- phase 1: one page to strips --

    def _start_detect(self, name: str, image: np.ndarray):
        """Queue page detection on the card; returns (record, resolver).

        Errors at dispatch fail the record alone, except a device fault."""
        rec = PageRecord(name=name, status=OpStatus.SUCCESS)
        t0 = time.perf_counter()
        try:
            resolver = self.pipeline.detect_lines_async(image)
        except Exception as e:
            if is_device_fault(e):
                raise
            rec.status = OpStatus.FAILED
            rec.error = f"page failed: {e}"
            resolver = None
        rec.timings_ms["detect_dispatch"] = (time.perf_counter() - t0) * 1000
        return rec, resolver

    def _page_to_strips(self, rec: PageRecord, image: np.ndarray, resolver, *,
                        use_tps: bool, tps_threshold: float,
                        merge_lines: bool, k_factor: float,
                        bbox_tolerance: float):
        """Wait for a queued detection and run the host geometry chain, with
        the TPS dewarp when asked (its warp runs on the card, on a stream
        that this thread holds from the pipeline's pool of warp streams for
        the warp's duration; ``timings_ms["dewarp"]`` is its share of the
        geometry time).

        While this host work runs, the next pages' detection is already
        queued on the card (see run())."""
        p = self.pipeline
        if rec.status == OpStatus.FAILED or resolver is None:
            return rec, []
        t0 = time.perf_counter()
        try:
            image = np.ascontiguousarray(image)
            status, mask = resolver()
            rec.timings_ms["detect"] = (
                (time.perf_counter() - t0) * 1000
                + rec.timings_ms.get("detect_dispatch", 0.0)
            )
            if status == OpStatus.FAILED:
                rec.status, rec.error = status, str(mask)
                return rec, []
            status, result = p.build_lines(image, mask)
            if status == OpStatus.FAILED:
                rec.status, rec.error = status, str(result)
                return rec, []
            rot_img, rot_mask, _, filtered, angle = result
            t_dw = time.perf_counter()
            status, dewarp = p.apply_dewarping(
                rot_img, rot_mask, filtered, angle,
                use_tps=use_tps, tps_threshold=tps_threshold,
            )
            rec.timings_ms["dewarp"] = (time.perf_counter() - t_dw) * 1000
            if status == OpStatus.FAILED:
                rec.status, rec.error = status, str(dewarp)
                return rec, []
            status, result = p.extract_lines(
                dewarp.work_img, rot_mask, dewarp.filtered_contours,
                merge_lines=merge_lines, k_factor=k_factor,
                bbox_tolerance=bbox_tolerance,
            )
            if status == OpStatus.FAILED:
                rec.status, rec.error = status, str(result)
                return rec, []
            sorted_lines, strips = result
            # drop degenerate strips with their lines (reference behavior:
            # inference.py:630-632 skips empty strips)
            kept = [
                (s, l)
                for s, l in zip(strips, sorted_lines)
                if s.shape[0] > 0 and s.shape[1] > 0
            ]
            strips = [s for s, _ in kept]
            sorted_lines = [l for _, l in kept]
            rec.mask = rot_mask
            rec.lines = sorted_lines
            rec.angle = float(angle)
            rec.timings_ms["geometry"] = (
                (time.perf_counter() - t0) * 1000
                + rec.timings_ms.get("detect_dispatch", 0.0)
                - rec.timings_ms["detect"]
            )
            return rec, strips
        except Exception as e:  # page isolation
            if is_device_fault(e):
                raise
            rec.status = OpStatus.FAILED
            rec.error = f"page failed: {e}"
            return rec, []

    # -- main entry --

    def run(
        self,
        images: Iterable[tuple[str, np.ndarray]] | Iterable[tuple[str, Callable[[], np.ndarray]]],
        target_encoding: Encoding = Encoding.UNICODE,
        use_tps: bool = False,
        tps_threshold: float = 0.25,
        merge_lines: bool = True,
        k_factor: float = 2.5,
        bbox_tolerance: float = 4.0,
        on_page_done: Optional[Callable[[PageRecord], Any]] = None,
    ) -> list[PageRecord]:
        """Process the volume; ``images`` yields (name, array) or
        (name, loader_callable) pairs — callables let disk decode overlap
        device work. Results come back in input order; ``on_page_done``
        fires as each window completes. ``use_tps=True`` dewarps the pages
        whose share of curved lines exceeds ``tps_threshold`` on the
        geometry threads, as run_ocr does."""
        results: list[PageRecord] = []

        def materialize(item):
            name, img = item
            if callable(img):
                try:
                    img = img()
                except Exception as e:  # loader isolation: bad file != dead volume
                    img = e
            return name, img

        # adaptive-dispatch monitor: per-emit instantaneous throughput vs
        # its own p75; two consecutive collapses trigger the one-time
        # escalation (see __init__). Runs on the main thread (emit is only
        # called there).
        tput_hist: list[float] = []
        last_emit = [time.perf_counter()]

        def note_progress(n: int):
            if n <= 0 or not self.adaptive_enabled:
                return
            now = time.perf_counter()
            dt = now - last_emit[0]
            last_emit[0] = now
            if dt <= 0:
                return
            tput_hist.append(n / dt)
            if self.adaptive["escalated"] or len(tput_hist) < 5:
                return
            peak = sorted(tput_hist)[int(0.75 * (len(tput_hist) - 1))]
            if tput_hist[-1] < 0.6 * peak and tput_hist[-2] < 0.6 * peak:
                det = getattr(self.pipeline, "line_inference", None)
                event = {
                    "page": len(results),
                    "tput_recent": round(tput_hist[-1], 2),
                    "tput_p75": round(peak, 2),
                    "detect_ahead": {"from": self.detect_ahead, "to": 16},
                }
                self.detect_ahead = max(self.detect_ahead, 16)
                if det is not None and not getattr(det, "pack_input", True):
                    det.pack_input = True
                    event["pack_input"] = True
                self.adaptive["escalated"] = True
                self.adaptive["events"].append(event)

        def emit(recs: list[PageRecord]):
            results.extend(recs)
            if on_page_done:
                for r in recs:
                    on_page_done(r)
            note_progress(len(recs))

        # one background flush worker keeps recognition overlapping the
        # next window's detection and host geometry; its streaming carry
        # spans windows (see _StreamFlusher)
        flusher = _StreamFlusher(
            self.pipeline, target_encoding, self.stream_quantum,
            self.max_held_pages,
        )
        flush_pool = ThreadPoolExecutor(max_workers=1)
        pending = None

        def start_flush(window, final: bool = False):
            nonlocal pending
            if pending is not None:
                emit(pending.result())
            pending = flush_pool.submit(flusher.add_window, window, final)

        window: list[tuple[PageRecord, list[np.ndarray]]] = []
        load_pool = ThreadPoolExecutor(max_workers=self.prefetch_workers)
        queue: deque = deque()
        depth = max(self.prefetch_workers + 1, 2)  # bounded decode lookahead
        try:
            items = iter(images)

            def loaded():
                for item in items:
                    queue.append(load_pool.submit(materialize, item))
                    if len(queue) >= depth:
                        yield queue.popleft().result()
                while queue:
                    yield queue.popleft().result()

            # Detection for upcoming pages stays queued on the card while
            # host geometry runs on a small thread pool (the native library
            # and torch's CPU ops release the GIL), results drained in
            # input order.
            geo_pool = ThreadPoolExecutor(max_workers=self.geometry_workers)
            inflight: deque = deque()

            def process(fut):
                nonlocal window
                window.append(fut.result())
                if len(window) >= self.window_pages:
                    start_flush(window)
                    window = []

            def failed_entry(rec):
                return geo_pool.submit(lambda: (rec, []))

            try:
                for name, img in loaded():
                    if img is None or isinstance(img, Exception):
                        detail = f": {img}" if img is not None else ""
                        fut = failed_entry(
                            PageRecord(
                                name=name, status=OpStatus.FAILED,
                                error=f"load failed{detail}",
                            )
                        )
                    else:
                        # dispatch on the main thread: the card runs the
                        # pages' detection in input order
                        rec, resolver = self._start_detect(name, img)
                        fut = geo_pool.submit(
                            self._page_to_strips, rec, img, resolver,
                            use_tps=use_tps, tps_threshold=tps_threshold,
                            merge_lines=merge_lines, k_factor=k_factor,
                            bbox_tolerance=bbox_tolerance,
                        )
                    inflight.append(fut)
                    # self.detect_ahead is read fresh each iteration so the
                    # adaptive escalation deepens the queue mid-run
                    while len(inflight) > self.detect_ahead:
                        process(inflight.popleft())
                while inflight:
                    process(inflight.popleft())
            finally:
                geo_pool.shutdown(wait=False)
            # final flush: the (possibly empty) partial window plus every
            # bucket still carried in the streaming state
            start_flush(window, final=True)
            if pending is not None:
                emit(pending.result())
        finally:
            flush_pool.shutdown(wait=False)
            load_pool.shutdown(wait=False)
        return results
