"""The port's page OCR (build_pipeline -> run_ocr, on the CPU in float32)
against the JAX package's on the same weights and pages."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_inference_tpu.core import data as jdata
from ocr_inference_tpu.eval.synthetic import (
    WYLIE_CHARSET, WYLIE_CHARSET_FULL, GlyphSet, distort_page, render_page,
)
from ocr_inference_tpu.pipeline.builder import build_pipeline as jax_build
from ocr_inference_tpu_torch.core import data
from ocr_inference_tpu_torch.eval.synthetic import fixture_pages
from ocr_inference_tpu_torch.pipeline import build_pipeline
from tests import make_refpipe_fixture as fx
from tests.make_torch_port_fixture import PAGES, full77f_configs

REPO = Path(__file__).resolve().parents[1]
REFPIPE = REPO / "tests" / "data" / "refpipe"
FIXTURE = REPO / "tests" / "data" / "torch_port"


def _refpipe_configs(mod):
    ocr = mod.OCRModelConfig(
        model_file=str(REFPIPE / "recognizer.onnx"), architecture="Easter2",
        input_width=fx.CANVAS, input_height=fx.INPUT_H, input_layer="input",
        output_layer="output", squeeze_channel=True, swap_hw=False,
        encoder=mod.CharsetEncoder.WYLIE, charset=list(WYLIE_CHARSET),
        add_blank=True, version="refpipe",
    )
    line = mod.LineDetectionConfig(
        checkpoint="", onnx_file=str(REFPIPE / "lines.onnx"),
        architecture="unet", patch_size=512, classes=["line"],
    )
    return ocr, line


@pytest.fixture(scope="module")
def refpipe_runs():
    ours = build_pipeline(*_refpipe_configs(data), dtype=torch.float32,
                          device="cpu")
    theirs = jax_build(*_refpipe_configs(jdata), dtype=jnp.float32)
    glyphs = GlyphSet(height=fx.GLYPH_H, seed=7)
    rng = np.random.RandomState(20_260)
    runs = []
    for _ in range(2):
        page = render_page(rng, glyphs, WYLIE_CHARSET, n_lines=(3, 5),
                           page_w=512, align="left",
                           n_syllables=fx.N_SYLLABLES,
                           syllable_len=fx.SYLLABLE_LEN)
        runs.append((
            ours.run_ocr(page.image, target_encoding=data.Encoding.WYLIE),
            theirs.run_ocr(page.image, target_encoding=jdata.Encoding.WYLIE),
        ))
    return runs


@pytest.mark.parametrize("page", [0, 1])
def test_refpipe_pages_same_lines_boxes_texts(refpipe_runs, page):
    (st, got), (jst, want) = refpipe_runs[page]
    assert st == data.OpStatus.SUCCESS, got
    assert jst == jdata.OpStatus.SUCCESS, want
    np.testing.assert_array_equal(got[0], want[0])  # rotated line mask
    assert [ln.bbox.as_tuple() for ln in got[1]] == \
        [ln.bbox.as_tuple() for ln in want[1]]
    assert [ln.text for ln in got[2]] == [ln.text for ln in want[2]]
    assert got[3] == want[3]


def test_fixture_pages_rebuild_render_page_bytes():
    glyphs = GlyphSet(charset=WYLIE_CHARSET_FULL, height=40, seed=7)
    rebuilt = fixture_pages(FIXTURE / "pages.npz")
    assert [p[0] for p in rebuilt] == [name for name, _, _ in PAGES]
    for (name, seed, shear), (_, img, texts) in zip(PAGES, rebuilt):
        page = render_page(np.random.RandomState(seed), glyphs,
                           WYLIE_CHARSET_FULL)
        want = page.image
        if shear:
            want = distort_page(want, np.random.RandomState(seed + 1000),
                                shear_deg=shear)
        np.testing.assert_array_equal(img, want)
        assert texts == page.texts


def test_full77f_fixture_pages_match_recorded_jax_f32_texts():
    record = json.loads((FIXTURE / "texts.json").read_text(encoding="utf-8"))
    pipe = build_pipeline(
        *full77f_configs(data.OCRModelConfig, data.LineDetectionConfig,
                         data.CharsetEncoder.WYLIE),
        dtype=torch.float32, device="cpu",
    )
    for (name, img, _), ref in zip(fixture_pages(FIXTURE / "pages.npz"),
                                   record["pages"]):
        status, payload = pipe.run_ocr(img, target_encoding=data.Encoding.WYLIE)
        assert status == data.OpStatus.SUCCESS, payload
        _, lines, ocr_lines, angle = payload
        assert [ln.text for ln in ocr_lines] == ref["jax_f32_texts"], name
        assert [list(ln.bbox.as_tuple()) for ln in lines] == \
            ref["jax_f32_boxes"], name
        assert angle == pytest.approx(ref["jax_angle"], abs=1e-9)


def test_unicode_output_matches_jax_converter():
    from ocr_inference_tpu.text import Converter as JaxConverter
    from ocr_inference_tpu_torch.text import Converter

    record = json.loads((FIXTURE / "texts.json").read_text(encoding="utf-8"))
    for page in record["pages"]:
        for text in page["jax_f32_texts"]:
            assert Converter().toUnicode(text) == JaxConverter().toUnicode(text)
