"""The port's public signatures against the JAX package's: the ones that
differed (RecognitionEngine.run's ``use_lm``, render_page's
``token_sampler``, its SyntheticPage result and the generator's default
charset, the geometry
functions' JAX parameters, the builders' positional order), each held
against the JAX function on the same inputs on the CPU."""

import inspect

import numpy as np
import pytest
import torch

from ocr_inference_tpu.eval import synthetic as J
from ocr_inference_tpu.geometry import backend as jgeo
from ocr_inference_tpu.geometry import lines as jlines
from ocr_inference_tpu.pipeline import builder as jbuilder
from ocr_inference_tpu_torch.core import data
from ocr_inference_tpu_torch.eval import synthetic as S
from ocr_inference_tpu_torch.geometry import backend as geo
from ocr_inference_tpu_torch.geometry import lines
from ocr_inference_tpu_torch.pipeline import builder
from tests.make_torch_port_fixture import OUT, full77f_configs


@pytest.fixture(scope="module")
def glyphs():
    got, charset = S.load_glyphs(OUT / "pages.npz")
    return got, charset, J.GlyphSet(charset=J.WYLIE_CHARSET_FULL, height=40,
                                     seed=7)


def test_recognition_engine_run_takes_use_lm():
    """JAX ``run(line_image, pre_pad=False, use_lm=False)`` ignores
    ``use_lm``; so does the port."""
    ocr_cfg, _ = full77f_configs(data.OCRModelConfig, data.LineDetectionConfig,
                                 data.CharsetEncoder.WYLIE, input_width=512)
    engine = builder.build_recognition_engine(ocr_cfg, dtype=torch.float32,
                                              device="cpu")
    strip = np.random.RandomState(0).randint(0, 255, (40, 300, 3), np.uint8)
    text = engine.run(strip)
    assert engine.run(strip, use_lm=True) == text
    assert engine.run(strip, False, True) == text


def test_default_charset_is_the_jax_one():
    assert S.WYLIE_CHARSET == J.WYLIE_CHARSET
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    assert S.sample_tokens(r1) == J.sample_tokens(r2)
    assert S.MarkovSampler().successors == J.MarkovSampler().successors


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_markov_pages_byte_equal_jax(glyphs, seed):
    """render_page with a MarkovSampler: the same page bytes and texts as
    the JAX page of the same seed."""
    got, charset, gs = glyphs
    ours = S.render_page(np.random.RandomState(seed), got, tuple(charset),
                         token_sampler=S.MarkovSampler(tuple(charset)))
    theirs = J.render_page(np.random.RandomState(seed), gs, tuple(charset),
                           token_sampler=J.MarkovSampler(tuple(charset)))
    np.testing.assert_array_equal(ours.image, theirs.image)
    assert ours.texts == theirs.texts
    uniform = S.render_page(np.random.RandomState(seed), got, tuple(charset))
    assert uniform.texts != ours.texts


@pytest.mark.parametrize("charset", ["base", "full"])
@pytest.mark.parametrize("seed", [0, 7, 31])
def test_render_page_returns_the_jax_synthetic_page(glyphs, charset, seed):
    """render_page returns a SyntheticPage (image, line_mask, texts,
    token_lines) equal to the JAX one, from a GlyphSet and, for the fixture
    charset, from its glyph dict; the mask is one solid rectangle a
    line."""
    cs = J.WYLIE_CHARSET if charset == "base" else J.WYLIE_CHARSET_FULL
    theirs = J.render_page(np.random.RandomState(seed),
                           J.GlyphSet(charset=cs, height=40, seed=7), cs)
    sources = [S.GlyphSet(charset=cs, height=40, seed=7)]
    if charset == "full":
        sources.append(glyphs[0])
    for source in sources:
        ours = S.render_page(np.random.RandomState(seed), source, cs)
        assert isinstance(ours, S.SyntheticPage)
        np.testing.assert_array_equal(ours.image, theirs.image)
        np.testing.assert_array_equal(ours.line_mask, theirs.line_mask)
        assert ours.texts == theirs.texts
        assert ours.token_lines == theirs.token_lines
    rows = np.flatnonzero(ours.line_mask.any(axis=1))
    assert set(np.unique(ours.line_mask)) == {0, 255} and len(rows)


def _mask_page():
    mask = np.zeros((200, 300), np.uint8)
    for y in (30, 80, 130):
        mask[y: y + 20, 20:280] = 255
    img = np.random.RandomState(1).randint(0, 255, (200, 300, 3), np.uint8)
    return img, mask


@pytest.mark.parametrize("rgb_mask", [None, True, False])
@pytest.mark.parametrize("three_channel_in", [False, True])
def test_build_raw_line_data_takes_rgb_mask(rgb_mask, three_channel_in):
    img, mask = _mask_page()
    if three_channel_in:
        mask = np.stack([mask, mask // 2, mask], axis=2)
    kw = {} if rgb_mask is None else {"rgb_mask": rgb_mask}
    ours = lines.build_raw_line_data(img, mask, **kw)
    theirs = jlines.build_raw_line_data(img, mask, **kw)
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert ours[1].shape == theirs[1].shape
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert len(ours[2]) == len(theirs[2])
    for a, b in zip(ours[2], theirs[2]):
        np.testing.assert_array_equal(a, b)
    assert ours[3] == theirs[3]


@pytest.mark.parametrize("threshold,calc", [(20, True), (5, False),
                                            (500, False)])
def test_sort_lines_by_threshold_takes_threshold(threshold, calc):
    img, mask = _mask_page()
    mask[35:45, 150:160] = 0
    _, rot, contours, _ = lines.build_raw_line_data(img, mask, rgb_mask=False)
    ours, t1 = lines.sort_lines_by_threshold(
        rot, [lines.build_line_data(c) for c in contours], threshold, calc)
    theirs, t2 = jlines.sort_lines_by_threshold(
        rot, [jlines.build_line_data(c) for c in contours],
        threshold=threshold, calculate_threshold=calc)
    assert t1 == t2
    assert calc or t1 == threshold

    def boxes(found):
        return [(b.x, b.y, b.w, b.h) for b in (ln.bbox for ln in found)]

    assert boxes(ours) == boxes(theirs)


@pytest.mark.parametrize("kind", ["points", "points2d", "mask", "empty"])
def test_bounding_rect_takes_points_or_mask(kind):
    rng = np.random.RandomState(4)
    if kind == "points":
        arg = rng.randint(0, 100, (17, 1, 2)).astype(np.int32)
    elif kind == "points2d":
        arg = rng.randint(0, 100, (17, 2)).astype(np.int32)
    elif kind == "mask":
        arg = np.zeros((40, 60), np.uint8)
        arg[7:19, 11:50] = 255
    else:
        arg = np.zeros((40, 60), np.uint8)
    assert geo.bounding_rect(arg) == tuple(jgeo.bounding_rect(arg))


@pytest.mark.parametrize("name", ["build_pipeline", "build_recognition_engine",
                                  "build_detection_engine"])
def test_builders_take_the_jax_positional_order(name):
    """The JAX parameters come first, in the JAX order; the port's own
    (device, seed) follow."""
    ours = list(inspect.signature(getattr(builder, name)).parameters)
    theirs = list(inspect.signature(getattr(jbuilder, name)).parameters)
    assert ours[: len(theirs)] == theirs
    assert ours[len(theirs):] == ["device", "seed"]


def test_builder_positional_call_and_mesh_refusal():
    _, line_cfg = full77f_configs(data.OCRModelConfig, data.LineDetectionConfig,
                                  data.CharsetEncoder.WYLIE)
    eng = builder.build_detection_engine(line_cfg, False, torch.float32, None,
                                         "cpu")
    assert next(eng.model.parameters()).dtype == torch.float32
    with pytest.raises(NotImplementedError, match="mesh"):
        builder.build_detection_engine(line_cfg, False, torch.float32,
                                       object(), "cpu")
