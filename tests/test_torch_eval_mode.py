"""Eval mode of the port (beams, the LM and its calibration) against the
JAX package's, on the CPU in float32 with the full77f weights and the
eval LM (artifacts/full77f/lm.arpa): ``RecognitionEngine.run_batch_beams``
plain and fused, ``calibrate_lm`` and the gate it sets, and
``run_ocr(eval_mode=True)`` on the three fixture pages with and without an
LM.

The forwards sum in other orders than XLA's, so the logits differ in the
last float32 bits. Texts and tokens are compared exactly. A beam's score
is a log-sum-exp over alignments of sums of per-frame log-probabilities,
so it can move by at most the sum over frames of the largest per-frame
log-probability difference between the two packages' logits of that
line; each score is held to that bound, computed from both packages'
logits of the same strip. (It reaches 5e-5 on 256-frame lines: more than
1e-5 of a score near -3.4.) The bound widens with any drift of the
forward, so each score is also held to SCORE_CEILING, twice the largest
difference measured: a drifting forward fails here instead of loosening
the bound."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_inference_tpu.core import data as jdata
from ocr_inference_tpu.pipeline.builder import build_pipeline as jax_build
from ocr_inference_tpu.pipeline.ocr_pipeline import (
    PipelineObserver as JaxObserver,
)
from ocr_inference_tpu_torch.core import data
from ocr_inference_tpu_torch.eval.synthetic import fixture_pages
from ocr_inference_tpu_torch.native import NativeArpaLM
from ocr_inference_tpu_torch.pipeline import build_pipeline
from tests.make_torch_port_fixture import OUT, full77f_configs

REPO = Path(__file__).resolve().parents[1]
LM = REPO / "artifacts" / "full77f" / "lm.arpa"
SCORE_CEILING = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes at once; two intra-op
    threads each keep them from oversubscribing the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _configs(mod):
    return full77f_configs(mod.OCRModelConfig, mod.LineDetectionConfig,
                           mod.CharsetEncoder.WYLIE)


@pytest.fixture(scope="module")
def pipes():
    """(port, JAX) full77f pipelines with the eval LM, float32."""
    ours = build_pipeline(
        *_configs(data), kenlm_config=data.KenLMConfig(str(LM), str(LM),
                                                       None),
        dtype=torch.float32, device="cpu")
    theirs = jax_build(
        *_configs(jdata), kenlm_config=jdata.KenLMConfig(str(LM), str(LM),
                                                         None),
        dtype=jnp.float32)
    return ours, theirs


@pytest.fixture(scope="module")
def strips(pipes):
    """The fixture pages' extracted strips (from the JAX pipeline) and
    their ground truth, paired by reading order."""
    class Capture(JaxObserver):
        strips = None

        def stage_end(self, stage, payload):
            if stage == "extract_lines":
                self.strips = payload[1]

    out, refs = [], []
    for _, img, texts in fixture_pages(OUT / "pages.npz"):
        cap = Capture()
        pipes[1].run_ocr(img, target_encoding=jdata.Encoding.WYLIE,
                         observer=cap)
        assert len(cap.strips) == len(texts)
        out.extend(cap.strips)
        refs.extend(texts)
    return out, refs


def _jax_logits(engine, lines, pre_pad: bool = False) -> dict:
    """{line index: (T, V) logits} from the JAX engine's eval forward (the
    calls its calibrate_lm makes)."""
    prepared = [(i, engine._prepare_host(img, pre_pad))
                for i, img in enumerate(lines)]
    out = {}
    for width, b, idxs, arr in engine._batch_iter(prepared):
        fn = engine._forward_fn(b, width, want_logits=True)
        logits = np.asarray(fn(engine.variables, arr))
        for row, idx in enumerate(idxs):
            out[idx] = logits[row]
    return out


def _log_softmax(x):
    x = np.asarray(x, np.float64)
    x = x - x.max(axis=-1, keepdims=True)
    return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))


def _bounds(pipes, lines, pre_pad: bool = False) -> list[float]:
    """Per line: the most its beams' scores can move between the two
    packages, sum over frames of max |log-prob difference|, plus float64
    slack, and never more than SCORE_CEILING."""
    ours = pipes[0].ocr_inference.line_logits(lines, pre_pad)
    theirs = _jax_logits(pipes[1].ocr_inference, lines, pre_pad)
    bounds = []
    for i in range(len(lines)):
        # the forwards agree to the transplant bar (tests/test_transplant.py)
        np.testing.assert_allclose(ours[i], theirs[i], atol=1e-3)
        diff = np.abs(_log_softmax(ours[i]) - _log_softmax(theirs[i]))
        bounds.append(min(float(diff.max(axis=-1).sum()) + 1e-9,
                          SCORE_CEILING))
    return bounds


@pytest.fixture(scope="module")
def score_bounds(pipes, strips):
    return _bounds(pipes, strips[0])


def _compare_beams(got, want, top_k, bounds):
    assert len(got) == len(want) == len(bounds)
    for g, w, bound in zip(got, want, bounds):
        assert len(g) == len(w) and 0 < len(g) <= top_k
        assert [(b.text, b.tokens) for b in g] == \
            [(b.text, b.tokens) for b in w]
        for gb, wb in zip(g, w):
            assert abs(gb.logit_score - wb.logit_score) <= bound, (gb, wb)
        if w[0].lm_score is None:
            assert all(b.lm_score is None for b in g)
        else:
            # the LM part depends on the tokens alone: the same float32
            # tables sum the same terms
            assert [b.lm_score for b in g] == [b.lm_score for b in w]


@pytest.mark.parametrize("use_lm", [False, True])
def test_run_batch_beams_equals_jax(pipes, strips, score_bounds, use_lm):
    ours, theirs = pipes[0].ocr_inference, pipes[1].ocr_inference
    assert ours.lm_fusion_enabled and theirs.lm_fusion_enabled
    assert isinstance(ours.ctc_decoder_lm._lm, NativeArpaLM)
    lines = strips[0][:6]
    got = ours.run_batch_beams(lines, use_lm=use_lm, top_k=5)
    want = theirs.run_batch_beams(lines, use_lm=use_lm, top_k=5)
    _compare_beams(got, want, 5, score_bounds[:6])
    assert (got[0][0].lm_score is not None) == use_lm
    # one line through the single-line entry point (pre-padded, as JAX)
    _compare_beams([ours.run_beam_code(lines[0])],
                   [theirs.run_beam_code(lines[0])], 10,
                   _bounds(pipes, lines[:1], pre_pad=True))


def test_line_logits_come_from_batches_of_the_model_batch(pipes, strips):
    """The logits forward runs Easter2 in calls of MODEL_BATCH canvases
    and returns the real rows only: a line's logits do not depend on the
    lines that share its batch."""
    eng = pipes[0].ocr_inference
    lines = strips[0][:5]
    together = eng.line_logits(lines)
    alone = eng.line_logits(lines[2:3])
    assert sorted(together) == list(range(5))
    assert together[2].dtype == np.float32
    np.testing.assert_array_equal(together[2], alone[0])


def test_calibrate_lm_gives_the_jax_report_and_gates_fusion(pipes, strips):
    """calibrate_lm on the fixture strips: the JAX report (grid CERs to 5
    digits, the decision and the weights it leaves), and the gate: with
    fusion off, use_lm=True reads plain beams."""
    ours, theirs = pipes[0].ocr_inference, pipes[1].ocr_inference
    lines, refs = strips
    try:
        got = ours.calibrate_lm(lines, refs)
        want = theirs.calibrate_lm(lines, refs)
        assert got == want
        assert ours.lm_fusion_enabled == theirs.lm_fusion_enabled == \
            want["enabled"]
        dec, jdec = ours.ctc_decoder_lm, theirs.ctc_decoder_lm
        assert (dec.lm_alpha, dec.lm_beta) == (jdec.lm_alpha, jdec.lm_beta)
        assert got["lines"] == len(lines) and len(got["grid"]) == 12

        plain = ours.run_batch_beams(lines[:3], use_lm=False, top_k=3)
        ours.lm_fusion_enabled = False
        gated = ours.run_batch_beams(lines[:3], use_lm=True, top_k=3)
        assert [[(b.tokens, b.logit_score, b.lm_score) for b in bs]
                for bs in gated] == \
            [[(b.tokens, b.logit_score, b.lm_score) for b in bs]
             for bs in plain]
        ours.lm_fusion_enabled = True
        fused = ours.run_batch_beams(lines[:3], use_lm=True, top_k=3)
        assert all(bs[0].lm_score is not None for bs in fused)
    finally:
        for eng in (ours, theirs):
            eng.lm_fusion_enabled = True
            eng.ctc_decoder_lm.lm_alpha, eng.ctc_decoder_lm.lm_beta = 0.5, 0.0


def test_calibrate_lm_without_an_lm_disables_fusion(pipes):
    from ocr_inference_tpu_torch.pipeline.engines import RecognitionEngine

    eng = pipes[0].ocr_inference
    bare = RecognitionEngine(eng.model, eng.config, eng.device)
    assert bare.ctc_decoder_lm is None
    assert bare.calibrate_lm([], []) == {"enabled": False,
                                         "reason": "no LM loaded"}
    assert not bare.lm_fusion_enabled


@pytest.fixture(scope="module")
def page_runs(pipes):
    """run_ocr(eval_mode=True) on the fixture pages: the port with and
    without an LM, and the JAX package."""
    ours, theirs = pipes
    bare = build_pipeline(*_configs(data), dtype=torch.float32, device="cpu")
    runs = []
    for name, img, _ in fixture_pages(OUT / "pages.npz"):
        runs.append((
            name,
            ours.run_ocr(img, eval_mode=True,
                         target_encoding=data.Encoding.WYLIE),
            bare.run_ocr(img, eval_mode=True,
                         target_encoding=data.Encoding.WYLIE),
            theirs.run_ocr(img, eval_mode=True,
                           target_encoding=jdata.Encoding.WYLIE),
        ))
    return runs


@pytest.mark.parametrize("with_lm", [True, False])
def test_run_ocr_eval_mode_equals_jax(page_runs, score_bounds, with_lm):
    bounds = iter(score_bounds)  # the pages' strips, in reading order
    for name, with_run, bare_run, (jst, want) in page_runs:
        st, got = with_run if with_lm else bare_run
        assert st.name == jst.name == "SUCCESS", (name, got)
        assert [ln.bbox.as_tuple() for ln in got[1]] == \
            [ln.bbox.as_tuple() for ln in want[1]], name
        assert [ln.text for ln in got[2]] == [ln.text for ln in want[2]]
        assert got[3] == want[3]
        for ln, jln in zip(got[2], want[2]):
            bound = next(bounds)
            assert ln.encoding == jln.encoding == "WYLIE"
            assert np.abs(np.subtract(ln.logits, jln.logits)).max() <= bound
            # ctc_conf = exp(score / len): moves by a factor of at most
            # exp(bound / len) <= exp(bound)
            assert abs(np.log(ln.ctc_conf) - np.log(jln.ctc_conf)) <= bound
            # run_ocr never fuses the LM (run_text_recognition_eval's
            # use_lm defaults to False), with or without one loaded
            assert ln.lm_scores is None and jln.lm_scores is None
            assert 0.0 < ln.ctc_conf <= 1.0


def test_eval_mode_texts_are_the_top_beams_in_unicode(pipes, page_runs):
    """The default target encoding converts the top beam's Wylie text, and
    the top beam of a fixture page is close to its greedy text."""
    ours = pipes[0]
    name, img, _ = fixture_pages(OUT / "pages.npz")[0]
    st, uni = ours.run_ocr(img, eval_mode=True)
    assert st == data.OpStatus.SUCCESS
    wylie = [ln.text for ln in page_runs[0][1][1][2]]
    assert [ln.text for ln in uni[2]] == \
        [ours.converter.toUnicode(t) for t in wylie]
    assert all(ln.encoding == "UNICODE" for ln in uni[2])


def test_eval_mode_record_is_the_ports_float32_reading(page_runs, pipes):
    """tests/data/torch_port/eval_mode.json (the JAX record chip_smoke.py
    holds the card against): the port's float32 CPU eval-mode texts and
    boxes, and its fused top beams of the same strips."""
    import json

    record = json.loads((OUT / "eval_mode.json").read_text(encoding="utf-8"))
    ours = pipes[0]
    for (name, (st, got), _, _), ref in zip(page_runs, record["pages"]):
        assert name == ref["name"] and st == data.OpStatus.SUCCESS
        assert [ln.text for ln in got[2]] == ref["jax_f32_beam_texts"]
        assert [list(ln.bbox.as_tuple()) for ln in got[1]] == \
            ref["jax_f32_boxes"]
    name, img, _ = fixture_pages(OUT / "pages.npz")[0]
    strips = ours.extract_lines(*_work(ours, img))[1][1]
    fused = ours.ocr_inference.run_batch_beams(strips, use_lm=True, top_k=1)
    assert [b[0].text.strip().replace("§", " ") for b in fused] == \
        record["pages"][0]["jax_f32_fused_texts"]


def _work(pipe, img):
    """(work image, rotated mask, contours) of a page, for extract_lines."""
    _, mask = pipe.detect_lines(img)
    _, (rot_img, rot_mask, _, contours, _) = pipe.build_lines(img, mask)
    return rot_img, rot_mask, contours
