"""Layout mode of the port against the JAX package on the CPU: the
DeepLabV3+ building blocks and the full-width model on the same numpy
inputs and weights (float32), the layout SegmentationEngine, run_ocr in
layout mode, the modern-book layout runner, the seeded weights, the
builder and the config readers.

Tolerances: layers atol 1e-4 (float32, values of order 1-10); the
full-width DeepLabV3+ logits atol 1e-3 (the bar of tests/test_transplant.py);
masks equal on every pixel whose JAX softmax is more than 1e-4 from the
0.8 threshold (float32 convolutions sum in another order in XLA and
PyTorch, and the logits differ by up to 3e-5, which moves a probability
by at most 1e-5)."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from ocr_inference_tpu.core import data as jdata
from ocr_inference_tpu.models import layers as jl
from ocr_inference_tpu.models.params import init_segmentation
from ocr_inference_tpu.models.segmentation import (
    DeepLabV3Plus as FlaxDeepLab,
    ResNetEncoder as FlaxEncoder,
)
from ocr_inference_tpu.pipeline import OCRPipeline as JaxPipeline
from ocr_inference_tpu.pipeline.builder import build_recognition_engine as jax_rec
from ocr_inference_tpu.pipeline.engines import SegmentationEngine as JaxEngine
from ocr_inference_tpu.pipeline.modern_layout import (
    ModernBookFormatLayoutDetection as JaxModern,
)
from ocr_inference_tpu_torch.core import data
from ocr_inference_tpu_torch.eval.synthetic import fixture_pages
from ocr_inference_tpu_torch.io.artifacts import write_png
from ocr_inference_tpu_torch.models import layers as tl
from ocr_inference_tpu_torch.models.params import (
    flax_shapes,
    load_flax_tree,
    seeded_flax_params,
)
from ocr_inference_tpu_torch.models.segmentation import (
    DeepLabV3Plus,
    ResNetEncoder,
)
from ocr_inference_tpu_torch.pipeline import OCRPipeline
from ocr_inference_tpu_torch.pipeline.builder import (
    build_detection_engine,
    build_pipeline,
    build_recognition_engine,
    default_layout_config,
    default_line_config,
    seeded_variables,
)
from ocr_inference_tpu_torch.pipeline.engines import SegmentationEngine
from ocr_inference_tpu_torch.pipeline.modern_layout import (
    ModernBookFormatLayoutDetection,
)
from tests.image_writers import jpeg2000_tiff
from tests.make_torch_port_fixture import (
    LAYOUT_CLASSES,
    full77f_configs,
    packed_mask_sha256,
)
from tests.test_torch_pipeline import _refpipe_configs

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "data" / "torch_port"
RECORD = json.loads((FIXTURE / "layout.json").read_text(encoding="utf-8"))
CPU = torch.device("cpu")
THRESHOLD = 0.8


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes at once; two intra-op
    threads each keep them from oversubscribing the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _random_tree(module, seed):
    """Seeded weights with random BatchNorm statistics, scales and biases,
    so that no layer is an identity."""
    tree = seeded_flax_params(flax_shapes(module), seed)
    rng = np.random.default_rng(seed + 100)

    def visit(node, owner):
        for key, val in node.items():
            if isinstance(val, dict):
                visit(val, key)
            elif key in ("scale", "var"):
                node[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
            elif key in ("bias", "mean"):
                node[key] = rng.normal(0, 0.3, val.shape).astype(np.float32)

    visit(tree, "")
    return tree


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _pair_close(flax_module, torch_module, x, seed=0, atol=1e-4):
    tree = _random_tree(torch_module, seed)
    load_flax_tree(torch_module.eval(), tree)
    want = flax_module.apply(tree, x)
    with torch.no_grad():
        got = torch_module(_nchw(x))
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=atol,
                                       rtol=1e-5)
    else:
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=atol,
                                   rtol=1e-5)


@pytest.mark.parametrize("kernel,stride,dilation,act,hw", [
    (7, 2, 1, True, (64, 64)),    # the stem: SAME pads (2, 3)
    (7, 2, 1, True, (61, 50)),
    (3, 2, 1, True, (32, 32)),    # stride-2 3x3: SAME pads (0, 1)
    (3, 2, 1, False, (33, 31)),
    (3, 1, 6, True, (20, 20)),    # ASPP rate 6
    (3, 1, 18, True, (16, 16)),   # ASPP rate 18 on a 16x16 map
    (1, 1, 1, True, (9, 13)),
    (3, 1, 1, True, (17, 12)),
])
def test_convbn_matches_flax(kernel, stride, dilation, act, hw):
    x = np.random.default_rng(kernel + stride).normal(
        size=(2, *hw, 5)).astype(np.float32)
    flax_module = jl.ConvBN(7, (kernel, kernel), strides=(stride, stride),
                            dilation=(dilation, dilation),
                            act=fnn.relu if act else None)
    _pair_close(flax_module, tl.ConvBN(5, 7, kernel, stride, dilation, act),
                x)


@pytest.mark.parametrize("cin,features,stride,hw", [
    (8, 8, 1, (16, 16)),     # identity shortcut
    (8, 16, 2, (16, 16)),    # 1x1 strided projection
    (8, 16, 2, (15, 11)),
    (8, 12, 1, (10, 10)),    # projection for channels only
])
def test_residual_block_matches_flax(cin, features, stride, hw):
    x = np.random.default_rng(features).normal(
        size=(2, *hw, cin)).astype(np.float32)
    _pair_close(jl.ResidualBlock(features, strides=(stride, stride)),
                tl.ResidualBlock(cin, features, stride), x)


@pytest.mark.parametrize("hw", [(16, 16), (9, 13)])
def test_aspp_matches_flax(hw):
    x = np.random.default_rng(1).normal(size=(2, *hw, 24)).astype(np.float32)
    _pair_close(jl.ASPP(16), tl.ASPP(24, 16), x)


@pytest.mark.parametrize("shape,hw", [
    ((1, 16, 16, 8), (128, 128)),   # ASPP -> low: x8
    ((1, 128, 128, 5), (512, 512)),  # logits -> tile: x4
    ((2, 6, 10, 4), (48, 80)),       # non-square
    ((1, 5, 7, 3), (20, 28)),
])
def test_resize_feature_is_jax_bilinear_resize(shape, hw):
    """jax.image.resize(..., "bilinear") upsampling by an integer factor
    equals align_corners=False bilinear with clamped borders: within 2e-6
    in float32 (values to 15). In bf16 JAX resizes in bf16 and PyTorch
    rounds a float32 result once; measured: up to one bf16 ulp of the
    output (0.0625 at magnitudes 8-16) apart, held to 2^-6 of the input's
    largest magnitude."""
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32) * 3
    want = np.asarray(jl.resize_feature(jnp.asarray(x), *hw))
    got = _nhwc(tl.resize_feature(_nchw(x), *hw))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    want16 = np.asarray(jl.resize_feature(jnp.asarray(x, jnp.bfloat16), *hw)
                        .astype(jnp.float32))
    got16 = _nhwc(tl.resize_feature(_nchw(x).bfloat16(), *hw).float())
    assert np.abs(got16 - want16).max() <= 2.0 ** -6 * np.abs(x).max()


def test_resnet_encoder_matches_flax():
    """Full widths (64-512), both outputs: stride 4 and stride 32."""
    x = (np.random.default_rng(3).random((1, 64, 96, 3)) > 0.3).astype(
        np.float32)
    _pair_close(FlaxEncoder(dtype=jnp.float32), ResNetEncoder(), x,
                atol=1e-3)


@pytest.fixture(scope="module")
def deeplab():
    """The full-width DeepLabV3+ with the record's seeded weights: (Flax
    module, variables, the port's module), float32."""
    model = DeepLabV3Plus(len(LAYOUT_CLASSES)).eval()
    tree = seeded_variables(model, RECORD["seed"])
    load_flax_tree(model, tree)
    return FlaxDeepLab(classes=len(LAYOUT_CLASSES), dtype=jnp.float32), \
        tree, model


@pytest.mark.parametrize("hw", [(128, 128), (512, 512)])
def test_deeplab_full_width_logits_match_flax(deeplab, hw):
    flax_model, tree, model = deeplab
    x = (np.random.default_rng(hw[0]).random((1, *hw, 3)) > 0.3).astype(
        np.float32)
    want = np.asarray(flax_model.apply(tree, x))
    with torch.no_grad():
        got = _nhwc(model(_nchw(x)))
    assert got.shape == want.shape == (1, *hw, 5)
    assert np.abs(want).max() > 1.0  # the head's gain: logits not tiny
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def _page(name, rows=512):
    pages = {n: img for n, img, _ in fixture_pages(FIXTURE / "pages.npz")}
    return np.ascontiguousarray(pages[name][:rows])


def _jax_probs(engine, img):
    """The JAX engine's per-pixel softmax of a page that needs no resize
    and no padding, (H, W, C)."""
    from ocr_inference_tpu.ops import tiling as jt

    plan, tiles, _ = engine._dispatch_tiles(img)
    probs = jax.nn.softmax(engine._run_tiles(tiles), axis=-1)
    return np.asarray(jt.stitch_tiles(probs, plan.y_steps))


@pytest.fixture(scope="module")
def layout_engines(deeplab):
    flax_model, tree, model = deeplab
    ours = SegmentationEngine(model, CPU, mode="layout",
                              classes=LAYOUT_CLASSES)
    theirs = JaxEngine(flax_model, tree, mode="layout",
                       classes=LAYOUT_CLASSES)
    return ours, theirs


def test_layout_engine_masks_match_jax_engine(layout_engines):
    """A 512x1024 page (two tiles) through both engines: (H, W, C) masks
    0/255, equal away from the threshold; at least two classes cover
    pixels, so the comparison is not of empty masks."""
    ours, theirs = layout_engines
    img = _page("clean_a")
    got, want = ours.predict(img), theirs.predict(img)
    assert got.shape == want.shape == (512, 1024, 5)
    assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 255}
    assert sum((want[:, :, c] > 0).any() for c in range(5)) >= 2
    near = np.abs(_jax_probs(theirs, img) - THRESHOLD) <= 1e-4
    differ = got != want
    assert not (differ & ~near).any()
    assert differ.sum() <= 1e-4 * got.size


def test_predict_many_async_equals_predict(layout_engines):
    """Two pages of different sizes (2 + 1 tiles) in one tile stream,
    through the batched generator and so predict_many_async, give each
    page's own predict masks."""
    ours, _ = layout_engines
    pages = [_page("clean_a"), _page("clean_b")[:, :512]]
    single = [ours.predict(p) for p in pages]
    batched = list(ours.predict_many_batched(
        [(i, p) for i, p in enumerate(pages)], batch_size=2))
    assert [k for k, _, _ in batched] == [0, 1]
    for (_, img, mask), a, p in zip(batched, single, pages):
        assert img is p
        np.testing.assert_array_equal(mask, a)
    assert ours.predict_many_async([]) == []


class _CallSizes(torch.nn.Module):
    """Records each call's batch size; returns the first ``classes``
    channels as logits."""

    def __init__(self, classes):
        super().__init__()
        self.classes, self.calls = classes, []

    def forward(self, x):
        self.calls.append(x.shape[0])
        return x[:, : self.classes]


@pytest.mark.parametrize("mode,n,calls", [
    ("layout", 40, [8] * 5),     # chunks of 32 and 8: calls of 8
    ("layout", 24, [8] * 3),
    ("layout", 3, [8]),
    ("line", 40, [32, 32]),      # one call a chunk, as before
    ("line", 24, [24]),
    ("line", 3, [8]),
])
def test_model_call_sizes(mode, n, calls):
    """Layout mode runs every model call at LAYOUT_MODEL_BATCH tiles, so a
    page's masks do not depend on the pages that share its tile stream;
    line mode keeps one call a chunk (the tile count rounded up to 8, at
    most 32)."""
    model = _CallSizes(3 if mode == "layout" else 1)
    engine = SegmentationEngine(model, CPU, mode=mode,
                                classes=["a", "b", "c"])
    out = engine._run_tiles(torch.zeros((n, 64, 64, 3), dtype=torch.uint8))
    assert model.calls == calls and out.shape[0] == n


class JaxLineChannelLayoutModel(fnn.Module):
    """3-class layout model whose 'line' channel is an ink-density
    detector (tests/test_pipeline.py:100); the other channels stay
    silent."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        dark = 1.0 - jnp.mean(x, axis=-1, keepdims=True)
        density = fnn.avg_pool(dark, (9, 41), strides=(1, 1), padding="SAME")
        line = (density - 0.35) * 40.0
        silent = jnp.full_like(line, -8.0)
        return jnp.concatenate([silent, line, silent], axis=-1)


class LineChannelLayoutModel(torch.nn.Module):
    """The torch twin: SAME average pooling over a 9 x 41 window, zeros
    counted (Flax's count_include_pad)."""

    def forward(self, x):
        dark = 1.0 - x.mean(dim=1, keepdim=True)
        density = F.avg_pool2d(dark, (9, 41), stride=1, padding=(4, 20),
                               count_include_pad=True)
        line = (density - 0.35) * 40.0
        silent = torch.full_like(line, -8.0)
        return torch.cat([silent, line, silent], dim=1)


def test_run_ocr_layout_mode_matches_jax():
    """run_ocr with a layout detector takes its "line" channel; with the
    refpipe recognizer both packages read the same lines, boxes and texts
    on a fixture page; VolumeRunner follows the same stage."""
    from ocr_inference_tpu_torch.pipeline import VolumeRunner

    classes = ["background", "line", "margin"]
    ocr_cfg, _ = _refpipe_configs(data)
    rec = build_recognition_engine(ocr_cfg, dtype=torch.float32, device="cpu")
    ours = OCRPipeline(rec, SegmentationEngine(
        LineChannelLayoutModel(), CPU, mode="layout", classes=classes))
    jocr_cfg, _ = _refpipe_configs(jdata)
    model = JaxLineChannelLayoutModel()
    theirs = JaxPipeline(
        jax_rec(jocr_cfg, dtype=jnp.float32),
        JaxEngine(model, model.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 512, 512, 3))),
                  mode="layout", classes=classes))
    img = _page("clean_b", rows=504)
    st, got = ours.run_ocr(img, target_encoding=data.Encoding.WYLIE)
    jst, want = theirs.run_ocr(img, target_encoding=jdata.Encoding.WYLIE)
    assert st.name == jst.name == "SUCCESS", (got, want)
    assert len(got[1]) >= 3
    assert [ln.bbox.as_tuple() for ln in got[1]] == \
        [ln.bbox.as_tuple() for ln in want[1]]
    assert [ln.text for ln in got[2]] == [ln.text for ln in want[2]]
    np.testing.assert_array_equal(ours.detect_lines(img)[1],
                                  theirs.detect_lines(img)[1])
    (vol,) = VolumeRunner(ours).run([("p", img)],
                                    target_encoding=data.Encoding.WYLIE)
    assert [ln.text for ln in vol.ocr_lines] == [ln.text for ln in got[2]]


class JaxBandLayoutModel(fnn.Module):
    """Dark pixels in the top band are header, in the bottom band footer
    (tests/test_modern_layout.py)."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        h = x.shape[1]
        dark = 1.0 - jnp.mean(x, axis=-1)
        rows = jnp.arange(h)[None, :, None] / h
        header = jnp.where((rows < 0.3) & (dark > 0.3), 8.0, -8.0)
        footer = jnp.where((rows > 0.7) & (dark > 0.3), 8.0, -8.0)
        return jnp.stack([jnp.zeros_like(header), header, footer], axis=-1)


class BandLayoutModel(torch.nn.Module):
    def forward(self, x):
        h = x.shape[2]
        dark = 1.0 - x.mean(dim=1)
        rows = (torch.arange(h, dtype=torch.float32) / h)[None, :, None]
        header = torch.where((rows < 0.3) & (dark > 0.3), 8.0, -8.0)
        footer = torch.where((rows > 0.7) & (dark > 0.3), 8.0, -8.0)
        return torch.stack([torch.zeros_like(header), header, footer], dim=1)


def test_modern_layout_json_matches_jax(tmp_path):
    """The same PNG and JPEG pages through both runners: the same JSON
    files; the filter-class error keeps its text; an arithmetic-coded JPEG
    page is refused by name before any page runs."""
    import cv2

    classes = ["background", "header", "footer"]
    pages = tmp_path / "pages"
    pages.mkdir()
    for i, (top, bottom) in enumerate(((30, 460), (80, 400))):
        img = np.full((512, 640 + 200 * i, 3), 240, np.uint8)
        img[top: top + 30, 100:400] = 30
        img[bottom: bottom + 30, 150:500] = 30
        write_png(pages / f"p{i}.png", img)
        cv2.imwrite(str(pages / f"q{i}.jpg"), img[::-1],
                    [cv2.IMWRITE_JPEG_QUALITY, 85])
    cfg = data.LayoutDetectionConfig("", "", "deeplabv3", 512, classes)
    ours = ModernBookFormatLayoutDetection(cfg, engine=SegmentationEngine(
        BandLayoutModel(), CPU, mode="layout", classes=classes))
    model = JaxBandLayoutModel()
    theirs = JaxModern(
        jdata.LayoutDetectionConfig("", "", "deeplabv3", 512, classes),
        engine=JaxEngine(model, model.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 512, 512, 3))),
                         mode="layout", classes=classes))
    for filt in (None, ["header"]):
        got = ours.run(str(pages), str(tmp_path / "ours"), filter_classes=filt,
                       batch_size=2)
        want = theirs.run(str(pages), str(tmp_path / "jax"),
                          filter_classes=filt, batch_size=2)
        assert got == want and set(got[str(pages / "p0.png")]) == (
            set(classes) if filt is None else {"header"})
        assert len(got) == 4
        for name in ("p0", "p1", "q0", "q1"):
            assert (tmp_path / "ours" / f"{name}.json").read_text() == \
                (tmp_path / "jax" / f"{name}.json").read_text()
    with pytest.raises(ValueError, match="not part of the model's classes"):
        ours.run(str(pages), str(tmp_path / "x"), filter_classes=["sidebar"])
    (pages / "scan.jpg").write_bytes(jpeg2000_tiff())
    with pytest.raises(NotImplementedError,
                       match="scan.jpg .JPEG 2000 in TIFF"):
        ours.run(str(pages), str(tmp_path / "y"))
    assert not (tmp_path / "y").exists()


def test_seeded_flax_params_are_reproducible_and_load_into_both():
    model = DeepLabV3Plus(5)
    shapes = flax_shapes(model)
    a, b = seeded_flax_params(shapes, 7), seeded_flax_params(shapes, 7)
    other = seeded_flax_params(shapes, 8)
    leaves_a = jax.tree_util.tree_leaves_with_path(a)
    template = jax.eval_shape(
        lambda: init_segmentation(FlaxDeepLab(classes=5), 64))
    leaves_t = jax.tree_util.tree_leaves_with_path(template)
    assert [p for p, _ in leaves_a] == [p for p, _ in leaves_t]
    assert all(v.shape == t.shape and v.dtype == np.float32
               for (_, v), (_, t) in zip(leaves_a, leaves_t))
    for (_, x), (_, y) in zip(leaves_a, jax.tree_util.tree_leaves_with_path(b)):
        np.testing.assert_array_equal(x, y)
    kernel = a["params"]["ASPP_0"]["ConvBN_5"]["Conv_0"]["kernel"]
    std = np.sqrt(1.0 / np.prod(kernel.shape[:-1])) / 0.87962566103423978
    assert np.abs(kernel).max() <= 2 * std
    assert abs(kernel.std() / std - 0.87962566103423978) < 0.01
    assert not np.array_equal(
        kernel, other["params"]["ASPP_0"]["ConvBN_5"]["Conv_0"]["kernel"])
    bn = a["params"]["ConvBN_1"]["BatchNorm_0"]
    stats = a["batch_stats"]["ConvBN_1"]["BatchNorm_0"]
    assert (bn["scale"] == 1).all() and (bn["bias"] == 0).all()
    assert (stats["mean"] == 0).all() and (stats["var"] == 1).all()
    assert (a["params"]["Conv_0"]["bias"] == 0).all()
    load_flax_tree(model, a)  # strict: every key and shape
    x = np.ones((1, 64, 64, 3), np.float32)
    assert np.isfinite(np.asarray(FlaxDeepLab(classes=5, dtype=jnp.float32)
                                  .apply(a, x))).all()


def test_builder_layout_and_random_weights(tmp_path):
    """A layout config builds DeepLabV3+ in layout mode; without weights
    the builders raise unless allow_random is given; a fresh UNet takes
    the stem-2 default with its opening; an architecture named deeplab
    in a line config builds a one-class DeepLabV3+."""
    layout = default_layout_config()
    with pytest.raises(FileNotFoundError, match="allow_random"):
        build_detection_engine(layout, device="cpu")
    det = build_detection_engine(layout, dtype=torch.float32, device="cpu",
                                 allow_random=True, seed=RECORD["seed"])
    assert det.mode == "layout" and det.classes == LAYOUT_CLASSES
    assert isinstance(det.model, DeepLabV3Plus)
    assert det.model.Conv_0.weight.dtype == torch.float32
    unet = build_detection_engine(default_line_config(), device="cpu",
                                  allow_random=True)
    assert unet.mode == "line" and unet.model.stem_stride == 2
    assert unet.open_width_frac == 0.02
    assert unet.model.ConvBN_1.Conv_0.weight.dtype == torch.bfloat16
    line_deeplab = data.LineDetectionConfig("", "", "deeplabv3", 512,
                                            ["line"])
    eng = build_detection_engine(line_deeplab, device="cpu",
                                 allow_random=True)
    assert eng.mode == "line" and eng.model.Conv_0.out_channels == 1
    ocr_cfg, _ = full77f_configs(data.OCRModelConfig,
                                 data.LineDetectionConfig,
                                 data.CharsetEncoder.WYLIE)
    missing = data.OCRModelConfig(**{**ocr_cfg.__dict__,
                                     "model_file": str(tmp_path / "x.onnx")})
    with pytest.raises(FileNotFoundError):
        build_pipeline(missing, layout, device="cpu")
    pipe = build_pipeline(missing, layout, device="cpu", allow_random=True)
    assert pipe.line_inference.mode == "layout"
    assert isinstance(pipe.line_config, data.LayoutDetectionConfig)


def test_layout_record_on_cpu(deeplab):
    """The JAX float32 record of tests/data/torch_port/layout.json (and its
    masks, layout_masks.npz), on its first fixture page: the port's masks
    (at most 1e-4 of a class's pixels apart, rounded up to a whole pixel),
    and run_ocr's lines, boxes and texts with the full77f recognizer."""
    _, _, model = deeplab
    ocr_cfg, _ = full77f_configs(data.OCRModelConfig,
                                 data.LineDetectionConfig,
                                 data.CharsetEncoder.WYLIE)
    layout = data.LayoutDetectionConfig("", "", "deeplabv3", 512,
                                        LAYOUT_CLASSES)
    pipe = OCRPipeline(
        build_recognition_engine(ocr_cfg, dtype=torch.float32, device="cpu"),
        SegmentationEngine(model, CPU, mode="layout", classes=LAYOUT_CLASSES),
        layout)
    ref = RECORD["pages"][0]
    img = {n: im for n, im, _ in fixture_pages(FIXTURE / "pages.npz")}[
        ref["name"]]
    mask = pipe.line_inference.predict(img)
    with np.load(FIXTURE / "layout_masks.npz") as npz:
        want = np.unpackbits(npz[ref["name"]], axis=-1)[..., :img.shape[1]]
    for c, cls in enumerate(LAYOUT_CLASSES):
        pixels = int(want[c].sum())
        assert pixels == ref["classes"][cls]["pixels"]
        assert packed_mask_sha256(want[c]) == \
            ref["classes"][cls]["packed_mask_sha256"]
        differ = int(((mask[:, :, c] > 0) != (want[c] > 0)).sum())
        assert differ <= np.ceil(1e-4 * pixels), cls
    status, payload = pipe.run_ocr(img, target_encoding=data.Encoding.WYLIE)
    assert status.name == ref["status"] == "SUCCESS"
    assert [list(ln.bbox.as_tuple()) for ln in payload[1]] == \
        ref["jax_f32_boxes"]
    assert [ln.text for ln in payload[2]] == ref["jax_f32_texts"]
    assert [r["seed"] for r in RECORD["skipped_seeds"]] == \
        list(range(RECORD["seed"]))


def test_config_readers_match_jax(tmp_path):
    """The port's JSON config readers give the JAX readers' configs."""
    from ocr_inference_tpu.core import assets as jassets
    from ocr_inference_tpu_torch.core import assets

    model_dir = tmp_path / "model"
    model_dir.mkdir()
    (model_dir / "model_config.json").write_text(json.dumps({
        "onnx-model": "rec.onnx", "architecture": "Easter2",
        "input_width": 2000, "input_height": 80, "input_layer": "input",
        "output_layer": "output", "squeeze_channel_dim": "yes",
        "swap_hw": "no", "encoder": "wylie", "charset": "abc",
        "add_blank": "yes", "version": "1.0"}))
    line = {"checkpoint": "l.pth", "onnx-model": "l.onnx",
            "architecture": "unet", "patch_size": 512, "classes": ["line"]}
    (tmp_path / "line.json").write_text(json.dumps(line))
    layout = {k: v for k, v in line.items() if k != "architecture"}
    layout["classes"] = LAYOUT_CLASSES
    (tmp_path / "layout.json").write_text(json.dumps(layout))
    got = assets.import_local_model(str(model_dir))
    want = jassets.import_local_model(str(model_dir))
    assert (got.name, got.path) == (want.name, want.path)
    g, w = got.config.__dict__, want.config.__dict__
    assert g.pop("encoder").name == w.pop("encoder").name
    assert g == w
    for reader in ("read_line_model_config", "read_layout_model_config"):
        path = str(tmp_path / ("line.json" if "line" in reader
                               else "layout.json"))
        assert getattr(assets, reader)(path).__dict__ == \
            getattr(jassets, reader)(path).__dict__
    assert assets.read_layout_model_config(
        str(tmp_path / "layout.json")).architecture == "deeplabv3"
    assert assets.import_local_model(str(tmp_path / "none")) is None
    for name in ("a/b/page.01.png", "page", "x.tar.gz"):
        assert assets.get_filename(name) == jassets.get_filename(name)
    assert assets.get_charset("abc") == jassets.get_charset("abc")
