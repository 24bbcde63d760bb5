"""The port's page OCR (build_pipeline -> run_ocr, on the CPU in float32)
against the JAX package's on the same weights and pages: whole pages, each
stage's payload on the same page and mask, the observer's events, line
pre-padding, and pages given as strided views."""

import dataclasses
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
from ocr_inference_tpu.pipeline.ocr_pipeline import (
    OCRPipeline as JaxOCRPipeline,
    PipelineObserver as JaxObserver,
)
from ocr_inference_tpu_torch.core import data
from ocr_inference_tpu_torch.eval.synthetic import fixture_pages
from ocr_inference_tpu_torch.pipeline import (
    OCRPipeline,
    PipelineObserver,
    VolumeRunner,
    build_pipeline,
)
from tests import make_refpipe_fixture as fx
from tests.make_torch_port_fixture import PAGES, full77f_configs

REPO = Path(__file__).resolve().parents[1]
REFPIPE = REPO / "tests" / "data" / "refpipe"
FIXTURE = REPO / "tests" / "data" / "torch_port"


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes at once; two intra-op
    threads each keep them from oversubscribing the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


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
def refpipes():
    """(port, JAX) pipelines on the refpipe weights, float32, and two
    refpipe pages."""
    ours = build_pipeline(*_refpipe_configs(data), dtype=torch.float32,
                          device="cpu")
    theirs = jax_build(*_refpipe_configs(jdata), dtype=jnp.float32)
    glyphs = GlyphSet(height=fx.GLYPH_H, seed=7)
    rng = np.random.RandomState(20_260)
    pages = [
        render_page(rng, glyphs, WYLIE_CHARSET, n_lines=(3, 5), page_w=512,
                    align="left", n_syllables=fx.N_SYLLABLES,
                    syllable_len=fx.SYLLABLE_LEN).image
        for _ in range(2)
    ]
    return ours, theirs, pages


@pytest.fixture(scope="module")
def refpipe_runs(refpipes):
    ours, theirs, pages = refpipes
    return [
        (ours.run_ocr(page, target_encoding=data.Encoding.WYLIE),
         theirs.run_ocr(page, target_encoding=jdata.Encoding.WYLIE))
        for page in pages
    ]


@pytest.fixture(scope="module")
def full77f():
    return build_pipeline(
        *full77f_configs(data.OCRModelConfig, data.LineDetectionConfig,
                         data.CharsetEncoder.WYLIE),
        dtype=torch.float32, device="cpu",
    )


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


def test_full77f_fixture_pages_match_recorded_jax_f32_texts(full77f):
    record = json.loads((FIXTURE / "texts.json").read_text(encoding="utf-8"))
    pipe = full77f
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


# ---------------------------------------------------------------------------
# Stage payloads, observer events, pre-padding, strided pages
# ---------------------------------------------------------------------------

def _line_mask(shape, deg: float) -> np.ndarray:
    """A line mask of four bands sheared by ``deg`` degrees, the second
    cut into two chunks (so reading order merges them)."""
    h, w = shape[:2]
    mask = np.zeros((h, w), np.uint8)
    slope = np.tan(np.deg2rad(deg))
    for i in range(4):
        y0 = 60 + i * (h - 160) // 4
        for x in range(40, w - 40):
            if i == 1 and w // 2 - 30 <= x < w // 2:
                continue
            y = int(y0 + slope * x)
            mask[y: y + 32, x] = 255
    return mask


def _lines(lines):
    return [(ln.bbox.as_tuple(), ln.center, ln.contour.tolist())
            for ln in lines]


def _fixture_page(name):
    return dict((n, img) for n, img, _ in
                fixture_pages(FIXTURE / "pages.npz"))[name]


@pytest.mark.parametrize("deg", [0.0, 2.0])
def test_stage_payloads_match_jax_stages(refpipes, deg):
    """build_lines (the 5-tuple), apply_dewarping and extract_lines under
    THRESHOLD and PEAKS give the JAX stages' payloads on the same page and
    mask; at 2 degrees the page is deskewed first."""
    ours, theirs, _ = refpipes
    img = _fixture_page("clean_a")
    mask = _line_mask(img.shape, deg)
    st, got = ours.build_lines(img, mask)
    jst, want = theirs.build_lines(img, mask)
    assert st.name == jst.name == "SUCCESS"
    assert len(got) == len(want) == 5
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert [c.tolist() for c in got[2]] == [c.tolist() for c in want[2]]
    assert [c.tolist() for c in got[3]] == [c.tolist() for c in want[3]]
    assert got[4] == want[4]
    assert (abs(got[4]) > 0.5) == (deg > 0)

    st, dw = ours.apply_dewarping(got[0], got[1], got[3], got[4])
    jst, jdw = theirs.apply_dewarping(want[0], want[1], want[3], want[4])
    assert st.name == jst.name == "SUCCESS"
    assert [f.name for f in dataclasses.fields(dw)] == \
        [f.name for f in dataclasses.fields(jdw)]
    for f in dataclasses.fields(dw):
        a, b = getattr(dw, f.name), getattr(jdw, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        elif f.name == "filtered_contours":
            assert [c.tolist() for c in a] == [c.tolist() for c in b]
        else:
            assert a == b, f.name

    for sorting in ("THRESHOLD", "PEAKS"):
        st, (lines, strips) = ours.extract_lines(
            dw.work_img, got[1], dw.filtered_contours,
            line_sorting=data.LineSorting[sorting])
        jst, (jlines, jstrips) = theirs.extract_lines(
            jdw.work_img, want[1], jdw.filtered_contours,
            line_sorting=jdata.LineSorting[sorting])
        assert st.name == jst.name == "SUCCESS"
        assert _lines(lines) == _lines(jlines), sorting
        assert len(strips) == len(jstrips) == 4
        for a, b in zip(strips, jstrips):
            np.testing.assert_array_equal(a, b)


def test_tps_and_eval_mode_raise_until_ported(refpipes):
    ours, _, pages = refpipes
    with pytest.raises(NotImplementedError, match="ROADMAP item 3"):
        ours.apply_dewarping(pages[0], pages[0][..., 0], [], 0.0,
                             use_tps=True)
    with pytest.raises(NotImplementedError, match="ROADMAP item 3"):
        ours.run_ocr(pages[0], use_tps=True)
    with pytest.raises(NotImplementedError, match="ROADMAP item 4"):
        ours.run_ocr(pages[0], eval_mode=True)
    with pytest.raises(NotImplementedError, match="ROADMAP item 3"):
        VolumeRunner(ours).run([("p", pages[0])], use_tps=True)


@pytest.mark.parametrize("prepad", [False, True])
def test_line_prepadding_matches_jax(refpipes, prepad):
    ours, theirs, pages = refpipes
    mine = OCRPipeline(ours.ocr_inference, ours.line_inference,
                       use_line_prepadding=prepad)
    jax_pipe = JaxOCRPipeline(theirs.ocr_inference, theirs.line_inference,
                              use_line_prepadding=prepad)
    ours.ocr_inference.occupancy.clear()
    theirs.ocr_inference.occupancy.clear()
    for page in pages:
        st, got = mine.run_ocr(page, target_encoding=data.Encoding.WYLIE)
        jst, want = jax_pipe.run_ocr(page,
                                     target_encoding=jdata.Encoding.WYLIE)
        assert st.name == jst.name == "SUCCESS", (got, want)
        assert [ln.text for ln in got[2]] == [ln.text for ln in want[2]]
    # run_batch's (bucket, real lines, padded batch) calls, as JAX counts them
    assert ours.ocr_inference.occupancy == theirs.ocr_inference.occupancy


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            self.events = []

        def stage_start(self, stage):
            self.events.append(("start", stage))

        def stage_end(self, stage, payload):
            self.events.append(("end", stage, type(payload).__name__))

        def stage_failed(self, stage, error):
            self.events.append(("failed", stage, error))

    return Recorder()


def test_observer_events_match_jax(refpipes):
    """The stage events around run_ocr, on a page that reads and on a
    blank page that fails at build_line_data."""
    ours, theirs, pages = refpipes
    blank = np.full_like(pages[0], 235)
    for page in (pages[0], blank):
        mine, jax_obs = _recorder(PipelineObserver), _recorder(JaxObserver)
        st, _ = ours.run_ocr(page, observer=mine)
        jst, _ = theirs.run_ocr(page, observer=jax_obs)
        assert st.name == jst.name
        assert mine.events == jax_obs.events
    assert mine.events[-1] == ("failed", "build_line_data",
                               "No lines detected")


@pytest.mark.parametrize("name", ["clean_a", "skew_2deg"])
def test_strided_page_views_read_as_the_page(full77f, name):
    """The BGR->RGB idiom ``bgr[..., ::-1]`` (a negative channel stride)
    and a column-sliced view give the contiguous page's lines and texts,
    with and without deskew."""
    page = _fixture_page(name)
    want = full77f.run_ocr(page, target_encoding=data.Encoding.WYLIE)
    bgr = np.ascontiguousarray(page[..., ::-1])
    wide = np.pad(page, ((0, 0), (40, 40), (0, 0)), constant_values=255)
    views = {"reversed_channels": bgr[..., ::-1],
             "column_slice": wide[:, 40:-40]}
    for kind, view in views.items():
        assert not view.flags.c_contiguous
        np.testing.assert_array_equal(view, page)
        st, got = full77f.run_ocr(view, target_encoding=data.Encoding.WYLIE)
        assert st == want[0] == data.OpStatus.SUCCESS, (kind, got)
        assert [ln.bbox.as_tuple() for ln in got[1]] == \
            [ln.bbox.as_tuple() for ln in want[1][1]], kind
        assert [ln.text for ln in got[2]] == \
            [ln.text for ln in want[1][2]], kind
        assert got[3] == want[1][3]
        # the stage called alone takes the view too
        mask = full77f.detect_lines(page)[1]
        assert full77f.build_lines(view, mask)[0] == data.OpStatus.SUCCESS
