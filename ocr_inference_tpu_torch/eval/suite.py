"""The six-distribution eval suite: synthetic pages with exact ground truth
through the whole pipeline, scored by CER.

Counterpart of the eval loop of ocr_inference_tpu/cli/selftrain_cli.py
(:470-552) with greedy decoding: page ``p`` is drawn from one generator,
``RandomState(5 + 10000)``, rendered, distorted and degraded as
``SUITE[p % 6]`` says, in the CLI's order, and read with
``run_ocr(..., target_encoding=WYLIE, use_tps=...)``. The beam and LM
columns wait for the port's beams (ROADMAP item 4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np

from ocr_inference_tpu_torch.core.data import Encoding, OpStatus
from ocr_inference_tpu_torch.eval.cer import cer, cer_bootstrap_ci
from ocr_inference_tpu_torch.eval.synthetic import (
    degrade_page,
    distort_page,
    render_page,
)

# (name, degrade level, shear degrees, curve amplitude px, use_tps), in the
# CLI's round-robin order (selftrain_cli.py:484-491)
SUITE = (
    ("clean", 0.0, 0.0, 0.0, False),
    ("degrade_03", 0.3, 0.0, 0.0, False),
    ("degrade_06", 0.6, 0.0, 0.0, False),
    ("shear_05", 0.0, 0.5, 0.0, False),
    ("skew_2deg", 0.0, 2.0, 0.0, False),
    ("curve_tps", 0.0, 0.0, 10.0, True),
)
SEED = 5           # EVAL_r05's seed: its eval pages use RandomState(5 + 10000)
PAGES = 150        # EVAL_r05's page count
SEED_OFFSET = 10_000


@dataclass
class EvalPage:
    index: int
    dist: str
    use_tps: bool
    image: np.ndarray      # (H, W, 3) uint8 RGB
    texts: list[str]       # ground truth per line, reading order


def eval_pages(n_pages: int, glyphs: dict, charset) -> Iterator[EvalPage]:
    """The suite's pages, made as the CLI makes them with its default
    uniform text (one generator for page, distortion and degradation
    draws)."""
    rng = np.random.RandomState(SEED + SEED_OFFSET)
    for p in range(n_pages):
        img, texts = render_page(rng, glyphs, charset)
        name, level, shear, curve, use_tps = SUITE[p % len(SUITE)]
        if shear or curve:
            img = distort_page(img, rng, shear_deg=shear, curve_amp=curve)
        img = degrade_page(img, rng, level)
        yield EvalPage(p, name, use_tps, img, texts)


@dataclass
class SuiteResult:
    cer: float
    cer_ci95: tuple[float, float]
    per_distribution: dict[str, dict]
    per_page_cer: list[float]
    predictions: list[str]
    references: list[str]
    lines_detected: int
    failed_pages: list[int]
    tps_applied_pages: list[int]
    dists: list[str]


def run_suite(pipeline, n_pages: int, glyphs: dict, charset,
              on_page: Optional[Callable[[EvalPage, str], None]] = None
              ) -> SuiteResult:
    """Read the first ``n_pages`` suite pages with ``pipeline.run_ocr`` and
    score them: pooled CER with its bootstrap 95% CI, CER per distribution
    and per page, lines read, the pages that failed and the pages the TPS
    dewarp was applied to. ``on_page(page, prediction)`` is called after
    each page."""
    from ocr_inference_tpu_torch.pipeline.ocr_pipeline import PipelineObserver

    class Dewarp(PipelineObserver):
        applied = False

        def stage_end(self, stage, payload):
            if stage == "dewarping":
                self.applied = bool(payload.applied)

    preds, refs, dists, per_page = [], [], [], []
    lines, failed, tps_applied = 0, [], []
    for page in eval_pages(n_pages, glyphs, charset):
        obs = Dewarp()
        status, payload = pipeline.run_ocr(
            page.image, target_encoding=Encoding.WYLIE, observer=obs,
            use_tps=page.use_tps,
        )
        if status == OpStatus.SUCCESS:
            lines += len(payload[2])
            pred = " ".join(ln.text for ln in payload[2])
        else:
            failed.append(page.index)
            pred = ""
        if obs.applied:
            tps_applied.append(page.index)
        ref = " ".join(page.texts)
        preds.append(pred)
        refs.append(ref)
        dists.append(page.dist)
        per_page.append(cer([pred], [ref]))
        if on_page is not None:
            on_page(page, pred)
    per_dist = {}
    for name, *_ in SUITE:
        sel = [i for i, d in enumerate(dists) if d == name]
        if sel:
            per_dist[name] = {
                "pages": len(sel),
                "cer": cer([preds[i] for i in sel], [refs[i] for i in sel]),
            }
    return SuiteResult(
        cer=cer(preds, refs), cer_ci95=cer_bootstrap_ci(preds, refs),
        per_distribution=per_dist, per_page_cer=per_page,
        predictions=preds, references=refs, lines_detected=lines,
        failed_pages=failed, tps_applied_pages=tps_applied, dists=dists,
    )
