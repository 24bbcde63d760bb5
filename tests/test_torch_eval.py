"""The port's eval suite (ocr_inference_tpu_torch/eval) against the JAX
package's eval/synthetic.py, eval/cer.py and the eval loop of
cli/selftrain_cli.py: the page generator's pieces byte for byte with cv2
and the JAX functions, the suite's pages against the JAX record of
tests/data/torch_port/eval_suite.json (made by
tests/make_torch_port_fixture.py eval_suite), and the suite's texts on the
CPU in float32 against the JAX float32 texts."""

import importlib
import json

import cv2
import numpy as np
import pytest
import torch

from ocr_inference_tpu.eval import synthetic as J
from ocr_inference_tpu.eval.cer import CERScorer as JaxCERScorer
from ocr_inference_tpu.eval.cer import cer_bootstrap_ci as jax_bootstrap_ci
from ocr_inference_tpu_torch.core import data
from ocr_inference_tpu_torch.eval import suite
from ocr_inference_tpu_torch.eval import synthetic as S
from ocr_inference_tpu_torch.ops.imaging import remap_linear_u8
from ocr_inference_tpu_torch.pipeline import build_pipeline
from tests.make_torch_port_fixture import (
    EVAL_CANVAS, EVAL_SEED, EVAL_SUITE, OUT, full77f_configs, sha256,
)

# the module: the package exports the function cer under that name, as
# the JAX package's eval/__init__.py does
pcer = importlib.import_module("ocr_inference_tpu_torch.eval.cer")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes at once; two intra-op
    threads each keep them from oversubscribing the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def record():
    return json.loads((OUT / "eval_suite.json").read_text(encoding="utf-8"))


@pytest.fixture(scope="module")
def glyphs():
    """(port glyph dict, charset, JAX GlyphSet): the stored bitmaps are the
    JAX GlyphSet's."""
    got, charset = S.load_glyphs(OUT / "pages.npz")
    gs = J.GlyphSet(charset=J.WYLIE_CHARSET_FULL, height=40, seed=7)
    assert charset == list(J.WYLIE_CHARSET_FULL)
    for tok in charset:
        np.testing.assert_array_equal(got[tok], gs.glyph(tok))
    return got, charset, gs


def _page(glyphs, seed):
    got, charset, gs = glyphs
    return J.render_page(np.random.RandomState(seed), gs, charset).image


@pytest.mark.parametrize("seed", [1234, 99])
def test_markov_sampler_tokens_equal_jax(seed):
    charset = J.WYLIE_CHARSET_FULL
    ours, theirs = S.MarkovSampler(charset, seed=seed), \
        J.MarkovSampler(charset, seed=seed)
    assert ours.successors == theirs.successors
    r1, r2 = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(20):
        assert ours(r1, charset) == theirs(r2, charset)
    assert r1.randint(1 << 30) == r2.randint(1 << 30)


def test_markov_lines_render_as_jax(glyphs):
    """Markov tokens drawn as render_page draws them, rendered as strips
    and as ground truth: byte-equal with JAX, the same draws consumed."""
    got, charset, gs = glyphs
    ours, theirs = S.MarkovSampler(charset), J.MarkovSampler(charset)
    r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(6):
        tokens = ours(r1, charset, (4, 10), (1, 4))
        assert tokens == theirs(r2, charset, (4, 10), (1, 4))
        np.testing.assert_array_equal(
            S.render_line_strip(tokens, got, r1),
            J.render_line_strip(tokens, gs, r2))
        assert S.tokens_to_text(tokens) == J.tokens_to_text(tokens)
    assert r1.randint(1 << 30) == r2.randint(1 << 30)


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_fill_circle_equals_cv2_circle(radius):
    """Every center in and around a small canvas: the page edges clip the
    circle as cv2 clips it."""
    for cy in range(-4, 11):
        for cx in range(-4, 13):
            want = np.zeros((7, 9, 3), np.uint8)
            got = want.copy()
            cv2.circle(want, (cx, cy), radius, (235, 235, 235), -1)
            S.fill_circle(got, (cx, cy), radius, 235)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("level", [0.0, 0.3, 0.6])
def test_degrade_page_equals_jax(glyphs, level):
    img = _page(glyphs, 11)
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    np.testing.assert_array_equal(S.degrade_page(img, r1, level),
                                  J.degrade_page(img, r2, level))
    assert r1.randint(1 << 30) == r2.randint(1 << 30)  # the same draws


@pytest.mark.parametrize("shear,curve,seed", [
    (0.0, 10.0, 0), (0.5, 0.0, 0), (0.5, 0.0, 1), (2.0, 0.0, 0),
    (2.0, 0.0, 1),
])
def test_distort_page_equals_jax(glyphs, shear, curve, seed):
    img = _page(glyphs, 12)
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    if shear:  # the seeds give both signs of the rotation
        sign = 1 if np.random.RandomState(seed).randint(2) else -1
        assert sign == (-1, 1)[seed]
    np.testing.assert_array_equal(
        S.distort_page(img, r1, shear_deg=shear, curve_amp=curve),
        J.distort_page(img, r2, shear_deg=shear, curve_amp=curve))
    assert r1.randint(1 << 30) == r2.randint(1 << 30)


@pytest.mark.parametrize("channels", [0, 3])
def test_remap_linear_u8_equals_cv2(channels):
    rng = np.random.default_rng(channels)
    h, w = 61, 150
    shape = (h, w, channels) if channels else (h, w)
    img = rng.integers(0, 256, shape, np.uint8)
    mx = rng.uniform(-3, w + 2, (h, w)).astype(np.float32)
    my = rng.uniform(-3, h + 2, (h, w)).astype(np.float32)
    mx[0, :4] = [0.5, w - 1, w - 0.5, -0.5]  # ties and the edges
    for border in (235, 0):
        want = cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT,
                         borderValue=(border,) * 3)
        got = remap_linear_u8(torch.from_numpy(img), torch.from_numpy(mx),
                              torch.from_numpy(my), border).numpy()
        np.testing.assert_array_equal(got, want)


def test_cer_and_bootstrap_ci_equal_jax():
    rng = np.random.RandomState(0)
    refs = ["".join(rng.choice(list("abcd "), size=rng.randint(5, 40)))
            for _ in range(30)]
    preds = [r[: len(r) - rng.randint(0, 3)] + "x" * rng.randint(0, 2)
             for r in refs]
    preds[3] = ""
    assert pcer.CERScorer().compute(preds, refs) == \
        JaxCERScorer().compute(preds, refs)
    assert pcer.cer_bootstrap_ci(preds, refs) == \
        jax_bootstrap_ci(preds, refs)
    assert pcer.cer_bootstrap_ci(preds, refs, n_boot=50, seed=3) == \
        jax_bootstrap_ci(preds, refs, n_boot=50, seed=3)
    assert pcer.cer_bootstrap_ci([], []) == jax_bootstrap_ci([], [])
    with pytest.raises(ValueError):
        pcer.cer_bootstrap_ci(["a"], [])


def test_suite_table_is_the_cli_suite(record):
    assert suite.SUITE == EVAL_SUITE
    assert [tuple(row) for row in record["suite"]] == list(EVAL_SUITE)
    assert suite.SEED == record["seed"] == EVAL_SEED
    assert suite.PAGES == len(record["pages"]) == 150


def test_eval_pages_equal_the_jax_pages(glyphs, record):
    """The first 24 pages (four of each distribution): bytes, ground truth
    and distribution equal to the JAX pages'. probe_eval.py, run on the
    GPU, checks all 150."""
    got, charset, _ = glyphs
    n = 0
    for page in suite.eval_pages(24, got, charset):
        want = record["pages"][page.index]
        assert page.dist == want["dist"]
        assert page.use_tps == (page.dist == "curve_tps")
        assert list(page.image.shape) == want["shape"]
        assert sha256(page.image) == want["sha256"], page.index
        assert sha256(" ".join(page.texts)) == want["gt_sha256"]
        n += 1
    assert n == 24


def test_suite_reads_the_jax_texts_in_float32(glyphs, record):
    """The first six pages, one of each distribution, through run_suite on
    the CPU in float32 with the suite's canvas width: the JAX float32
    texts, and the scores computed from them."""
    got, charset, _ = glyphs
    pipe = build_pipeline(
        *full77f_configs(data.OCRModelConfig, data.LineDetectionConfig,
                         data.CharsetEncoder.WYLIE, input_width=EVAL_CANVAS),
        dtype=torch.float32, device="cpu")
    seen = []
    result = suite.run_suite(pipe, 6, got, charset,
                             on_page=lambda p, t: seen.append(p.index))
    want = record["pages"][:6]
    assert seen == list(range(6))
    assert result.predictions == [p["jax_f32_text"] for p in want]
    assert result.per_page_cer == [p["jax_f32_cer"] for p in want]
    assert result.lines_detected == sum(p["lines"] for p in want)
    assert result.failed_pages == []
    # the curve_tps pages never trip the gate (ROADMAP item 3)
    assert result.tps_applied_pages == [] == [
        i for i, p in enumerate(want) if p["tps_applied"]]
    assert list(result.per_distribution) == [row[0] for row in EVAL_SUITE]
    assert result.cer == pcer.cer(result.predictions, result.references)
    lo, hi = result.cer_ci95
    assert lo <= result.cer <= hi
    assert result.dists == [row[0] for row in EVAL_SUITE]


@pytest.fixture(scope="module")
def lm_suite(glyphs, record, tmp_path_factory):
    """The eval loop with the CLI's LM on the CPU in float32: the LM built
    by the suite, calibrated on the CLI's calibration strips, then the
    first three pages read greedy, with the plain beam and fused."""
    got, charset, _ = glyphs
    arpa = suite.build_eval_lm(tmp_path_factory.mktemp("lm") / "lm.arpa",
                               charset)
    pipe = build_pipeline(
        *full77f_configs(data.OCRModelConfig, data.LineDetectionConfig,
                         data.CharsetEncoder.WYLIE, input_width=EVAL_CANVAS),
        kenlm_config=data.KenLMConfig(str(arpa), str(arpa), None),
        dtype=torch.float32, device="cpu")
    strips, refs, used, attempts = suite.calibration_strips(pipe, got,
                                                            charset)
    report = pipe.ocr_inference.calibrate_lm(strips, refs)
    result = suite.run_suite(pipe, 3, got, charset)
    return arpa, pipe, (strips, refs, used, attempts), report, result


def test_suite_lm_is_the_eval_lm(lm_suite, record):
    arpa = lm_suite[0]
    assert arpa.read_bytes() == (OUT.parents[2] / record["lm"]["arpa"]
                                 ).read_bytes()


def test_suite_calibration_gives_the_jax_report(lm_suite, record):
    """The CLI's calibration strips and the calibrate_lm report of the JAX
    float32 record: the same pages used, references, grid and decision."""
    _, pipe, (strips, refs, used, attempts), report, _ = lm_suite
    lm = record["lm"]
    assert used == lm["calib_pages"] and attempts == lm["calib_attempts"]
    assert len(strips) == suite.CALIB_LINES == lm["calib_lines"]
    assert refs == lm["calib_refs"]
    assert report == lm["lm_calibration"]
    assert pipe.ocr_inference.lm_fusion_enabled == lm["lm_fusion_enabled"]


def test_suite_beam_columns_equal_the_jax_beams(lm_suite, record):
    """The first three pages' plain and fused top beams are the JAX
    float32 ones, and the LM columns are the CLI's."""
    _, pipe, _, report, result = lm_suite
    want = record["pages"][:3]
    assert result.predictions == [p["jax_f32_text"] for p in want]
    assert result.beam_predictions == [p["jax_f32_beam_text"] for p in want]
    assert result.beam_lm_predictions == \
        [p["jax_f32_beam_lm_text"] for p in want]
    assert result.cer_beam == pcer.cer(result.beam_predictions,
                                       result.references)
    cols = suite.lm_columns(pipe, result, report)
    lm = record["lm"]
    assert cols["lm_order"] == lm["order"] == 3
    assert (cols["lm_alpha"], cols["lm_beta"], cols["lm_fusion_enabled"]) \
        == (lm["lm_alpha"], lm["lm_beta"], lm["lm_fusion_enabled"])
    assert cols["lm_calibration"] == lm["lm_calibration"]
    assert (cols["cer_beam"], cols["cer_beam_lm"]) == (result.cer_beam,
                                                       result.cer_beam_lm)


def test_suite_without_an_lm_has_no_beam_columns(glyphs):
    """A recognizer without an LM reads greedy only, as the CLI does
    without --lm-order."""
    got, charset, _ = glyphs
    pipe = build_pipeline(
        *full77f_configs(data.OCRModelConfig, data.LineDetectionConfig,
                         data.CharsetEncoder.WYLIE, input_width=EVAL_CANVAS),
        dtype=torch.float32, device="cpu")
    result = suite.run_suite(pipe, 1, got, charset)
    assert result.beam_predictions is None and result.cer_beam is None
