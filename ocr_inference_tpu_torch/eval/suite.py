"""The six-distribution eval suite: synthetic pages with exact ground truth
through the whole pipeline, scored by CER.

Counterpart of the eval loop of ocr_inference_tpu/cli/selftrain_cli.py
(:386-466, :470-552, :632-645): page ``p`` is drawn from one generator,
``RandomState(5 + 10000)``, rendered, distorted and degraded as
``SUITE[p % 6]`` says, in the CLI's order, and read with
``run_ocr(..., target_encoding=WYLIE, use_tps=...)`` (greedy decoding).

When the recognizer has an n-gram LM (``build_pipeline(...,
kenlm_config=...)``), each page's extracted strips are also read with the
top beam, plain and fused (``run_batch_beams(use_lm=False/True,
top_k=1)``), for the CLI's ``cer_beam`` and ``cer_beam_lm`` columns. The
CLI's LM is ``build_eval_lm``'s (it is artifacts/full77f/lm.arpa byte for
byte), and ``calibrate`` tunes its fusion weights on the CLI's calibration
strips before the pages are read.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np

from ocr_inference_tpu_torch.core.data import Encoding, OpStatus
from ocr_inference_tpu_torch.decode.ngram_builder import build_char_arpa
from ocr_inference_tpu_torch.eval.cer import cer, cer_bootstrap_ci
from ocr_inference_tpu_torch.eval.synthetic import (
    degrade_page,
    distort_page,
    render_page,
    sample_tokens,
)
from ocr_inference_tpu_torch.pipeline.ocr_pipeline import PipelineObserver

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
# the CLI's LM and its calibration at their defaults (selftrain_cli.py
# --lm-order 3, --lm-corpus-lines 500, --lm-calib-lines 16; :392, :441)
LM_ORDER, LM_CORPUS_LINES, LM_SEED_OFFSET = 3, 500, 77
CALIB_LINES, CALIB_SEED_OFFSET, CALIB_ATTEMPTS = 16, 31_337, 50


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


def build_eval_lm(out_path: str | Path, charset) -> Path:
    """The CLI's LM: an order-3 token ARPA over 500 lines of
    ``sample_tokens`` from ``RandomState(5 + 77)`` (selftrain_cli.py:
    386-406)."""
    rng = np.random.RandomState(SEED + LM_SEED_OFFSET)
    corpus = [" ".join(sample_tokens(rng, charset))
              for _ in range(LM_CORPUS_LINES)]
    return build_char_arpa(corpus, out_path, order=LM_ORDER, tokens=True)


class StripCapture(PipelineObserver):
    """Keeps whether the page was dewarped and the strips extract_lines
    cut from it (the CLI's StripCapture), so the beam reads reuse the
    page's detection and geometry."""

    def __init__(self):
        self.applied = False
        self.strips: list = []

    def stage_end(self, stage, payload):
        if stage == "dewarping":
            self.applied = bool(payload.applied)
        elif stage == "extract_lines":
            self.strips = payload[1]


def calibration_strips(pipeline, glyphs: dict, charset,
                       n_lines: int = CALIB_LINES):
    """The CLI's calibration set (selftrain_cli.py:439-459): pages from
    ``RandomState(5 + 31337)``, read with ``run_ocr``; the strips of the
    pages whose line count equals the rendered count, until ``n_lines``
    strips (at most 50 pages). Returns (strips, references, the indices of
    the pages used, pages tried)."""
    rng = np.random.RandomState(SEED + CALIB_SEED_OFFSET)
    strips, refs, used, attempts = [], [], [], 0
    while len(strips) < n_lines and attempts < CALIB_ATTEMPTS:
        attempts += 1
        img, texts = render_page(rng, glyphs, charset)
        img = degrade_page(img, rng, 0.0)
        obs = StripCapture()
        status, _ = pipeline.run_ocr(img, target_encoding=Encoding.WYLIE,
                                     observer=obs)
        if status != OpStatus.SUCCESS or len(obs.strips) != len(texts):
            continue  # detection merged or split lines: refs cannot pair
        strips.extend(obs.strips)
        refs.extend(texts)
        used.append(attempts - 1)
    return strips[:n_lines], refs[:n_lines], used, attempts


def calibrate(pipeline, glyphs: dict, charset) -> dict:
    """Tune the recognizer's fusion weights on the CLI's calibration
    strips (``RecognitionEngine.calibrate_lm``); returns its report."""
    strips, refs, _, _ = calibration_strips(pipeline, glyphs, charset)
    return pipeline.ocr_inference.calibrate_lm(strips, refs)


def _beam_text(beams) -> str:
    return beams[0].text.strip().replace("§", " ") if beams else ""


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
    # top-1 beam texts, plain and fused, when the recognizer has an LM
    beam_predictions: Optional[list[str]] = None
    beam_lm_predictions: Optional[list[str]] = None
    cer_beam: Optional[float] = None
    cer_beam_lm: Optional[float] = None


def lm_columns(pipeline, result: SuiteResult,
               calibration: Optional[dict] = None) -> dict:
    """The CLI's LM columns (selftrain_cli.py:632-645): ``cer_beam``,
    ``cer_beam_lm``, the LM's order, the fusion weights and state after
    calibration, and the calibration report when one ran."""
    engine = pipeline.ocr_inference
    dec = engine.ctc_decoder_lm
    out = {
        "cer_beam": result.cer_beam, "cer_beam_lm": result.cer_beam_lm,
        "lm_order": dec._lm.order if dec is not None and dec.has_lm else None,
        "lm_alpha": dec.lm_alpha if dec is not None else None,
        "lm_beta": dec.lm_beta if dec is not None else None,
        "lm_fusion_enabled": engine.lm_fusion_enabled,
    }
    if calibration is not None:
        out["lm_calibration"] = calibration
    return out


def run_suite(pipeline, n_pages: int, glyphs: dict, charset,
              on_page: Optional[Callable[[EvalPage, str], None]] = None
              ) -> SuiteResult:
    """Read the first ``n_pages`` suite pages with ``pipeline.run_ocr`` and
    score them: pooled CER with its bootstrap 95% CI, CER per distribution
    and per page, lines read, the pages that failed and the pages the TPS
    dewarp was applied to. When the recognizer has an LM, each page's
    strips are also read with the top beam, plain and fused (the fused
    read is a plain beam while fusion is disabled), and scored pooled.
    ``on_page(page, prediction)`` is called after each page."""
    engine = pipeline.ocr_inference
    beams = engine.ctc_decoder_lm is not None
    preds, refs, dists, per_page = [], [], [], []
    beam_preds, beam_lm_preds = [], []
    lines, failed, tps_applied = 0, [], []
    for page in eval_pages(n_pages, glyphs, charset):
        obs = StripCapture()
        status, payload = pipeline.run_ocr(
            page.image, target_encoding=Encoding.WYLIE, observer=obs,
            use_tps=page.use_tps,
        )
        beam = beam_lm = ""
        if status == OpStatus.SUCCESS:
            lines += len(payload[2])
            pred = " ".join(ln.text for ln in payload[2])
            if beams and obs.strips:
                beam = " ".join(_beam_text(b) for b in engine.run_batch_beams(
                    obs.strips, use_lm=False, top_k=1))
                beam_lm = " ".join(_beam_text(b) for b in
                                   engine.run_batch_beams(
                                       obs.strips, use_lm=True, top_k=1))
        else:
            failed.append(page.index)
            pred = ""
        beam_preds.append(beam)
        beam_lm_preds.append(beam_lm)
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
    beam_fields = {}
    if beams:
        beam_fields = {
            "beam_predictions": beam_preds,
            "beam_lm_predictions": beam_lm_preds,
            "cer_beam": cer(beam_preds, refs),
            "cer_beam_lm": cer(beam_lm_preds, refs),
        }
    return SuiteResult(
        cer=cer(preds, refs), cer_ci95=cer_bootstrap_ci(preds, refs),
        per_distribution=per_dist, per_page_cer=per_page,
        predictions=preds, references=refs, lines_detected=lines,
        failed_pages=failed, tps_applied_pages=tps_applied, dists=dists,
        **beam_fields,
    )
