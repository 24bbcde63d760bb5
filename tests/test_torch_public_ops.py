"""The public surface the port adds for the JAX package's users, held
against the JAX functions on the CPU (cv2 where the JAX function is
cv2): core types and constants, ``ops``, ``ops_host``, the geometry
helpers, ``utils.runtime`` and the transplant's JAX names.

Bars: every uint8 result byte-equal; ``gaussian_blur_gray`` within 1e-4
of the JAX float32 convolution; ``normalize``/``sigmoid`` within 1e-6.
The JAX ``ops.binarize`` blurs in XLA float32, whose ties can depart
from cv2; the port follows cv2, so there it may differ from JAX only on
pixels where JAX differs from cv2.
"""

import dataclasses
import json
import sys
from enum import Enum
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_inference_tpu import ops_host as j_host
from ocr_inference_tpu.core import config as j_config
from ocr_inference_tpu.core import data as j_data
from ocr_inference_tpu.geometry import backend as j_geo
from ocr_inference_tpu.geometry import lines as j_lines
from ocr_inference_tpu.ops import imaging as j_img
from ocr_inference_tpu.ops import packing as j_pack
from ocr_inference_tpu.pipeline import engines as j_engines
from ocr_inference_tpu_torch import native, ops_host
from ocr_inference_tpu_torch.core import config, data
from ocr_inference_tpu_torch.eval.synthetic import fixture_pages
from ocr_inference_tpu_torch.geometry import backend as geo
from ocr_inference_tpu_torch.geometry import lines
from ocr_inference_tpu_torch.ops import imaging, kernels, packing
from ocr_inference_tpu_torch.pipeline import engines
from ocr_inference_tpu_torch.utils import runtime

FIXTURE = Path(__file__).resolve().parent / "data" / "torch_port"


@pytest.fixture(scope="module")
def pages():
    """The fixture pages with the JAX float32 layout masks of
    layout_masks.npz as (H, W, 5) uint8 0/255 stacks (background, image,
    line, caption, margin)."""
    with np.load(FIXTURE / "layout_masks.npz") as npz:
        out = []
        for name, img, _ in fixture_pages(FIXTURE / "pages.npz"):
            bits = np.unpackbits(npz[name], axis=-1)[..., :img.shape[1]]
            out.append((name, img, np.ascontiguousarray(
                bits.transpose(1, 2, 0)) * np.uint8(255)))
        return out


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# core
# ---------------------------------------------------------------------------

ENUMS = ["OpStatus", "Encoding", "CharsetEncoder", "ExportFormat", "LineMode",
         "LineMerge", "LineSorting", "OCRArchitecture", "TPSMode", "Language"]
DATACLASSES = ["LayoutData", "OCRData", "OCResult", "OCRSettings",
               "PipelineResult", "BBox", "Line", "OCRLine", "KenLMConfig"]


@pytest.mark.parametrize("name", ENUMS)
def test_enums_equal_jax(name):
    got, want = getattr(data, name), getattr(j_data, name)
    assert [(m.name, m.value) for m in got] == \
        [(m.name, m.value) for m in want]


def _fields(cls):
    return [(f.name, str(f.type), f.default,
             f.default_factory() if callable(f.default_factory) else None)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", DATACLASSES)
def test_dataclasses_equal_jax(name):
    assert _fields(getattr(data, name)) == _fields(getattr(j_data, name))


def _plain(value):
    """Constants with enum members as (class name, member name)."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, Enum):
        return (type(value).__name__, value.name)
    return value


CONSTANTS = ["MODEL_DICT", "COLOR_DICT", "LANGUAGES", "ENCODINGS",
             "CHARSETENCODER", "OCR_ARCHITECTURES", "EXPORTERS", "LINE_MODES",
             "LINE_MERGE", "LINE_SORTING", "TPS_MODE", "PATCH_SIZE",
             "CLAMP_WIDTH", "CLAMP_HEIGHT", "BINARIZE_BLOCK", "BINARIZE_C",
             "LINE_CLASS_THRESHOLD", "LAYOUT_CLASS_THRESHOLD",
             "DEFAULT_K_FACTOR", "DEFAULT_BBOX_TOLERANCE",
             "DEFAULT_TPS_THRESHOLD"]


@pytest.mark.parametrize("name", CONSTANTS)
def test_config_constants_equal_jax(name):
    assert _plain(getattr(config, name)) == _plain(getattr(j_config, name))


def test_settings_and_results_build_as_in_jax():
    settings = data.OCRSettings(
        data.LineMode.LINE, data.LineMerge.MERGE, data.LineSorting.THRESHOLD,
        2.5, 4.0, False, True, data.TPSMode.GLOBAL, data.Encoding.UNICODE)
    assert settings.tps_mode is config.TPS_MODE["global"]
    result = data.PipelineResult(np.zeros((2, 2), np.uint8), [], [], 0.0)
    assert result.metrics == {} and result.metrics is not \
        data.PipelineResult(result.mask, [], [], 0.0).metrics


# ---------------------------------------------------------------------------
# ops: elementwise, blur, threshold, binarize, morphology, packing
# ---------------------------------------------------------------------------

def test_normalize_and_sigmoid_within_1e6_of_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    x = (rng.standard_normal((5, 77)) * 6).astype(np.float32)
    np.testing.assert_allclose(imaging.normalize(_t(img)).numpy(),
                               np.asarray(j_img.normalize(img)), atol=1e-6)
    np.testing.assert_allclose(imaging.sigmoid(_t(x)).numpy(),
                               np.asarray(j_img.sigmoid(x)), atol=1e-6)
    assert imaging.normalize(_t(img)).dtype == torch.float32


@pytest.mark.parametrize("ksize, sigma", [(3, 0.0), (15, 0.0), (51, 0.0),
                                          (15, 2.5), (31, 4.0)])
def test_gaussian_blur_gray_within_1e4_of_jax(pages, ksize, sigma):
    gray = cv2.cvtColor(pages[0][1][:256], cv2.COLOR_RGB2GRAY)
    got = imaging.gaussian_blur_gray(_t(gray), ksize, sigma).numpy()
    want = np.asarray(j_img.gaussian_blur_gray(gray, ksize, sigma))
    assert got.dtype == np.float32 and got.shape == gray.shape
    assert np.abs(got - want).max() <= 1e-4


def test_gaussian_blur_gray_takes_a_batch_and_refuses_even_ksize():
    rng = np.random.default_rng(1)
    gray = rng.integers(0, 256, (2, 21, 30), dtype=np.uint8)
    batch = imaging.gaussian_blur_gray(_t(gray), 9).numpy()
    for i in range(2):
        np.testing.assert_array_equal(
            batch[i], imaging.gaussian_blur_gray(_t(gray[i]), 9).numpy())
    with pytest.raises(ValueError, match="odd"):
        imaging.gaussian_blur_gray(_t(gray), 8)


THRESHOLDS = [(51, 13), (31, 10), (15, 5), (11, 2)]


def _cv2_threshold(gray, block, c):
    return cv2.adaptiveThreshold(gray, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                                 cv2.THRESH_BINARY, block, c)


@pytest.mark.parametrize("block, c", THRESHOLDS)
def test_adaptive_threshold_equals_cv2(block, c):
    """Seeded gray of a canvas's height and of odd sizes; the fixture
    pages go through it in the binarize test below."""
    rng = np.random.default_rng(block)
    grays = [rng.integers(0, 256, shape, dtype=np.uint8)
             for shape in ((80, 300), (37, 61), (5, 3))]
    for gray in grays:
        got = imaging.adaptive_threshold_gaussian(_t(gray), 255, block, c)
        np.testing.assert_array_equal(got.numpy(),
                                      _cv2_threshold(gray, block, c))
    # the one-argument form stays the 51/13 rule the kernels' callers use
    np.testing.assert_array_equal(
        imaging.adaptive_threshold_gaussian(_t(grays[0])).numpy(),
        _cv2_threshold(grays[0], 51, 13))


@pytest.mark.parametrize("block, c", THRESHOLDS)
def test_binarize_equals_cv2_and_departs_from_jax_only_where_jax_does(
        pages, block, c):
    """51/13 goes through the kernel wrapper (its plain version on the
    CPU) and equals ops_host.binarize_host, which is cv2; the other
    thresholds are torch ops that equal cv2, and differ from the JAX
    XLA blur only on pixels where that departs from cv2."""
    for _, img, _ in pages:
        got = imaging.binarize(_t(img), True, block, c).numpy()
        want = j_host.binarize_host(img, True, block, c)
        np.testing.assert_array_equal(got, want)
        jax_bw = np.asarray(j_img.binarize(jnp.asarray(img), True, block,
                                           float(c)))
        departs = jax_bw != want
        assert not ((got != jax_bw) & ~departs).any(), int(departs.sum())


def test_binarize_51_13_counts_as_the_kernel_path_and_global_threshold():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
    kernels.reset_launches()
    got = imaging.binarize(_t(img)).numpy()
    np.testing.assert_array_equal(
        got, np.repeat(kernels.binarize_tiles_plain(_t(img)[None])[0]
                       .numpy()[..., None], 3, axis=-1))
    assert kernels.LAUNCHES["binarize_tiles"] == 0  # the CPU never counts
    flat = imaging.binarize(_t(img), adaptive=False).numpy()
    np.testing.assert_array_equal(flat, j_host.binarize_host(img, False))
    np.testing.assert_array_equal(flat, np.asarray(j_img.binarize(img, False)))


MORPH = [(12, 2, 10), (3, 3, 1), (1, 5, 2), (4, 1, 3), (6, 7, 2)]


@pytest.mark.parametrize("kh, kw, iterations", MORPH)
def test_dilate_and_erode_equal_jax_and_cv2(kh, kw, iterations):
    rng = np.random.default_rng(kh * 10 + kw)
    mask = (rng.random((41, 57)) > 0.85).astype(np.uint8) * 255
    kernel = np.ones((kh, kw), np.uint8)
    for arr in (mask, np.repeat(mask[..., None], 3, -1)):
        dil = imaging.dilate_rect(_t(arr), kh, kw, iterations).numpy()
        ero = imaging.erode_rect(_t(arr), kh, kw, iterations).numpy()
        np.testing.assert_array_equal(
            dil, cv2.dilate(arr, kernel, iterations=iterations))
        np.testing.assert_array_equal(
            ero, cv2.erode(arr, kernel, iterations=iterations))
        np.testing.assert_array_equal(
            dil, np.asarray(j_img.dilate_rect(arr, kh, kw, iterations)))
        np.testing.assert_array_equal(
            ero, np.asarray(j_img.erode_rect(arr, kh, kw, iterations)))


@pytest.mark.parametrize("shape", [(3, 5), (2, 4, 33), (7, 64), (1, 200)])
def test_pack_bits_host_and_unpack_bits_device_equal_jax(shape):
    rng = np.random.default_rng(len(shape))
    bits = rng.random(shape) > 0.5
    packed = packing.pack_bits_host(bits)
    np.testing.assert_array_equal(packed, j_pack.pack_bits_host(bits))
    assert packed.dtype == np.int32
    got = packing.unpack_bits_device(_t(packed), shape[-1]).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_pack.unpack_bits_device(jnp.asarray(packed),
                                                  shape[-1])))
    np.testing.assert_array_equal(got, bits.astype(np.uint8))
    # either packer's words unpack with the other package's unpacker
    np.testing.assert_array_equal(
        packing.unpack_mask(packed, shape[-1]), bits.astype(np.uint8))


# ---------------------------------------------------------------------------
# ops_host
# ---------------------------------------------------------------------------

def _image(h, w, c=3, seed=0):
    rng = np.random.default_rng(seed)
    shape = (h, w) if c == 0 else (h, w, c)
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("block, c, adaptive", [(51, 13, True),
                                                (31, 10, True),
                                                (51, 13, False)])
def test_binarize_host_equals_jax(block, c, adaptive):
    img = _image(53, 88)
    np.testing.assert_array_equal(
        ops_host.binarize_host(img, adaptive, block, c),
        j_host.binarize_host(img, adaptive, block, c))


def test_normalize_and_sigmoid_host_equal_jax():
    img = _image(9, 11)
    x = np.linspace(-20, 20, 101)
    np.testing.assert_array_equal(ops_host.normalize_host(img),
                                  j_host.normalize_host(img))
    np.testing.assert_array_equal(ops_host.sigmoid_host(x),
                                  j_host.sigmoid_host(x))


RESIZES = [((40, 60, 3), (91, 17)), ((40, 60, 0), (30, 80)),
           ((33, 100, 3), (100, 33)), ((64, 64, 1), (64, 64)),
           ((7, 500, 3), (1000, 80))]


@pytest.mark.parametrize("shape, target", RESIZES)
def test_resize_family_equals_jax(shape, target):
    img = _image(*shape, seed=shape[1])
    tw, th = target
    np.testing.assert_array_equal(ops_host.resize_image(img, tw, th),
                                  j_host.resize_image(img, tw, th))
    for fn, arg in (("resize_to_height", th), ("resize_to_width", tw)):
        got, scale = getattr(ops_host, fn)(img, arg)
        want, jscale = getattr(j_host, fn)(img, arg)
        np.testing.assert_array_equal(got, want)
        assert scale == jscale


def test_resize_image_refuses_float():
    with pytest.raises(TypeError, match="uint8"):
        ops_host.resize_image(np.zeros((4, 4), np.float32), 8, 8)


PAGES = [(300, 700), (700, 300), (600, 1300), (520, 4500), (2600, 900),
         (512, 512)]


@pytest.mark.parametrize("hw", PAGES)
def test_tiling_helpers_equal_jax(hw):
    img = _image(*hw, seed=hw[0])
    for fn in ("calculate_steps", "get_paddings"):
        assert getattr(ops_host, fn)(img, 512) == getattr(j_host, fn)(img, 512)
    assert ops_host.calculate_paddings(img, 3, 2, 256) == \
        j_host.calculate_paddings(img, 3, 2, 256)
    np.testing.assert_array_equal(ops_host.pad_image(img, 5, 7, 9),
                                  j_host.pad_image(img, 5, 7, 9))
    got = ops_host.preprocess_image(img)
    want = j_host.preprocess_image(img)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    tiles, ys = ops_host.tile_image(got[0])
    jtiles, jys = j_host.tile_image(want[0])
    assert ys == jys and len(tiles) == len(jtiles)
    np.testing.assert_array_equal(np.stack(tiles), np.stack(jtiles))
    np.testing.assert_array_equal(
        ops_host.stitch_predictions(np.stack(tiles), ys), got[0])
    r, sx, sy = ops_host.resize_clamp(img)
    jr, jsx, jsy = j_host.resize_clamp(img)
    np.testing.assert_array_equal(r, jr)
    assert (sx, sy) == (jsx, jsy)


def test_polar_helpers_equal_jax():
    rng = np.random.default_rng(4)
    x, y = rng.standard_normal(20), rng.standard_normal(20)
    for got, want in zip(ops_host.cart2pol(x, y), j_host.cart2pol(x, y)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(ops_host.pol2cart(x, y), j_host.pol2cart(x, y)):
        np.testing.assert_array_equal(got, want)


LINES = [((40, 300, 3), 3000, 80, "black"), ((90, 120, 3), 512, 80, "white"),
         ((25, 2999, 3), 3000, 80, "black"), ((80, 40, 0), 1024, 80, "white"),
         ((120, 1500, 3), 1024, 80, "black")]


@pytest.mark.parametrize("shape, tw, th, padding", LINES)
def test_line_canvas_helpers_equal_jax(shape, tw, th, padding):
    img = _image(*shape, seed=shape[1])
    # the band that fits: the width path where the width scale is smaller
    fn = "pad_to_width" if tw / shape[1] <= th / shape[0] else "pad_to_height"
    np.testing.assert_array_equal(getattr(ops_host, fn)(img, tw, th, padding),
                                  getattr(j_host, fn)(img, tw, th, padding))
    np.testing.assert_array_equal(ops_host.pad_ocr_line(img, tw, th, padding),
                                  j_host.pad_ocr_line(img, tw, th, padding))
    got = engines.pad_ocr_line_host(img, tw, th, padding)
    np.testing.assert_array_equal(
        got, j_engines.pad_ocr_line_host(img, tw, th, padding))
    assert got.ndim == 3


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def test_backend_switches_and_native_available():
    assert geo.use_native() is True and native.native_available() is True
    geo.set_backend(None)
    geo.set_backend(True)
    with pytest.raises(ValueError, match="no cv2 geometry backend"):
        geo.set_backend(False)
    assert lines.get_rotation_angle_from_lines is \
        lines.calculate_rotation_angle_from_lines
    assert lines.sort_lines_by_threshold2 is lines.sort_lines_by_threshold


def test_moments_centroid_and_is_inside_equal_jax(pages):
    for _, _, mask in pages:
        for cnt in lines.get_contours(mask[..., 2]):
            assert geo.moments_centroid(cnt) == j_geo.moments_centroid(cnt)
    square = np.array([[[0, 0]], [[0, 0]]], np.int32)
    assert geo.moments_centroid(square) == j_geo.moments_centroid(square)
    for pt in [(1, 1), (0, 5), (5.5, 2), (-1, 3)]:
        assert lines.is_inside_rectangle(pt, [0, 0, 5, 5]) == \
            j_lines.is_inside_rectangle(pt, [0, 0, 5, 5])


def test_mask_n_crop_equals_jax():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    img[..., 1][:, 7] = 0  # one channel zero along a column
    mask = np.zeros((40, 50), np.uint8)
    mask[5:30, 3:45] = 255
    mask[12] = 0  # an interior zero row
    mask[:, 20] = 0  # and column
    cases = [(img, mask), (img[..., 0], mask), (img, np.dstack([mask] * 3)),
             (img, mask.astype(np.float32) * 0.999)]
    for image, m in cases:
        np.testing.assert_array_equal(lines.mask_n_crop(image, m),
                                      j_lines.mask_n_crop(image, m))


def test_get_line_threshold_equals_jax(pages):
    for _, _, mask in pages:
        line = mask[..., 2]
        assert lines.get_line_threshold(line) == \
            j_lines.get_line_threshold(line)
        bgr = np.ascontiguousarray(np.dstack([line, line // 2, line]))
        assert lines.get_line_threshold(bgr, 16) == \
            j_lines.get_line_threshold(bgr, 16)


def _same(got, want):
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_get_text_area_and_filter_contours_equal_jax(pages):
    for _, img, mask in pages:
        line = np.ascontiguousarray(mask[::2, ::2, 2])  # resized back up
        got = lines.get_text_area(img, line)
        want = j_lines.get_text_area(img, line)
        for g, w in zip(got, want):
            _same(g, w)
        filtered = lines.filter_contours_by_area(got[0], got[2])
        jfiltered = j_lines.filter_contours_by_area(want[0], want[2])
        assert len(filtered) == len(jfiltered) > 0
        for g, w in zip(filtered, jfiltered):
            np.testing.assert_array_equal(g, w)
    blank = np.zeros((40, 60), np.uint8)
    assert lines.get_text_area(img, blank) == (None, None, None)


def test_post_process_prediction_equals_jax(pages):
    for _, img, mask in pages:
        line = np.ascontiguousarray(mask[..., 2])
        got = lines.post_process_prediction(img, line)
        want = j_lines.post_process_prediction(img, line)
        for g, w in zip(got[:3], want[:3]):
            _same(g, w)
        assert got[3] == want[3]
    assert lines.post_process_prediction(
        img, np.zeros(img.shape[:2], np.uint8)) == (None,) * 4


# ---------------------------------------------------------------------------
# utils.runtime, the transplant's JAX names
# ---------------------------------------------------------------------------

def test_stage_timer_accumulates_and_cpu_devices():
    record = {}
    for _ in range(3):
        with runtime.stage_timer(record, "stage"):
            sum(range(1000))
    first = record["stage"]
    with runtime.stage_timer(record, "stage"):
        pass
    assert record["stage"] >= first > 0 and list(record) == ["stage"]
    assert runtime.cpu_devices() == [torch.device("cpu")]


def test_trace_profile_writes_a_trace_naming_the_op(tmp_path, monkeypatch):
    # torch.profiler imports torch._dynamo, which looks up third-party
    # module names; a stub package without a __spec__ that another test
    # file left in sys.modules (tests/reference_oracle.py stubs
    # onnxruntime, torchvision, ...) makes that lookup raise, so hide
    # those here (an extension's own submodules, torch._C._dynamo among
    # them, lack a __spec__ too, under a package that has one)
    def stub(name):
        return getattr(sys.modules.get(name), "__spec__", True) is None

    for name in list(sys.modules):
        if name != "__main__" and stub(name.split(".")[0]):
            monkeypatch.delitem(sys.modules, name)
    a = torch.randn(64, 64)
    with runtime.trace_profile(str(tmp_path / "trace")) as prof:
        torch.mm(a, a)
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_enable_compilation_cache_sends_both_builds_once(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(runtime, "_CACHE_ENABLED", False)
    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    runtime.enable_compilation_cache(str(tmp_path / "cache"))
    assert kernels.BUILD_DIR == native.BUILD_DIR == tmp_path / "cache"
    assert (tmp_path / "cache").is_dir()
    runtime.enable_compilation_cache(str(tmp_path / "other"))  # idempotent
    assert native.BUILD_DIR == tmp_path / "cache"
    assert not (tmp_path / "other").exists()
    built = native.build_library("png.cpp")
    assert built.parent == tmp_path / "cache" and built.is_file()


def test_enable_compilation_cache_none_keeps_the_build_dir(monkeypatch):
    monkeypatch.setattr(runtime, "_CACHE_ENABLED", False)
    before = (kernels.BUILD_DIR, native.BUILD_DIR)
    runtime.enable_compilation_cache()
    assert (kernels.BUILD_DIR, native.BUILD_DIR) == before
    assert before[0].name == "_build"


def test_flax_execution_order_equals_jax():
    """A small Easter2 (conv, BatchNorm and the squeeze-excite Dense
    layers), the modules of tests/torch_onnx_graphs.py."""
    import jax

    from ocr_inference_tpu.onnx import transplant as j_tp
    from ocr_inference_tpu_torch.models.params import flax_variables
    from ocr_inference_tpu_torch.onnx import transplant as tp
    from tests.torch_onnx_graphs import H, W, _easter2, _port_easter2

    x = np.random.RandomState(0).randn(2, H, W).astype(np.float32)
    module = _port_easter2()
    variables = jax.tree_util.tree_map(jnp.asarray, flax_variables(module))
    want = j_tp.flax_execution_order(_easter2(), variables, jnp.asarray(x))
    got = tp.flax_execution_order(module, None, x)
    assert tp.FlaxLayer is tp.PortLayer
    assert [(l.kind, l.path, l.has_bias, l.epsilon) for l in got] == \
        [(l.kind, tuple(l.path), l.has_bias, l.epsilon) for l in want]
