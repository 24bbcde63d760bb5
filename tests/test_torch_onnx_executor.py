"""The port's ONNX executor (onnx/runner.py) against the JAX package's on
the same graphs and inputs: the exporter-style golden graph
(tests/onnx_exporter_sim.py), the tf2onnx dialect (tests/tf_exporter_sim.py),
fp16 and quantized graphs, TorchScript exports of the JAX package's torch
twins, and TorchScript exports of the port's own UNet, DeepLabV3+, Easter2
(base, attention, vit) and CRNN with dynamic batch and width.

Tolerances: 1e-4 in float32, 1e-2 in fp16 (the JAX fp16 test's scale).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ocr_inference_tpu.onnx.runner import OnnxGraphFunction as JaxGraph
from ocr_inference_tpu.onnx.runner import load_onnx_module as jax_load
from ocr_inference_tpu.onnx.wire import load_model as jax_load_model
from ocr_inference_tpu_torch.models.recognition import CRNN, Easter2
from ocr_inference_tpu_torch.models.segmentation import DeepLabV3Plus, UNet
from ocr_inference_tpu_torch.onnx.export_shim import torch_export
from ocr_inference_tpu_torch.onnx.runner import (
    OnnxGraphFunction,
    load_onnx_module,
)
from ocr_inference_tpu_torch.onnx.wire import load_model
from tests import onnx_exporter_sim as sim
from tests.torch_onnx_graphs import TWINS, randomize_bn, twin_case

F32_TOL, F16_TOL = 1e-4, 1e-2


def _jax(path, x):
    fn = JaxGraph(jax_load_model(path))
    return np.asarray(fn(fn.weights, x)[0], dtype=np.float32)


def _port(path, x, **kw):
    fn = OnnxGraphFunction(load_model(path), device="cpu", **kw)
    return fn(fn.weights, torch.from_numpy(x))[0].float().numpy()



@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes at once; two intra-op
    threads each keep them from oversubscribing the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    d = tmp_path_factory.mktemp("twins")
    return {name: twin_case(name, d) for name in TWINS}


@pytest.mark.parametrize("name", TWINS)
def test_twin_exports_match_jax(twins, name):
    case = twins[name]
    want = _jax(case.path, case.graph_x)
    got = _port(case.path, case.graph_x)
    tol = F16_TOL if name.startswith("fp16") else F32_TOL
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < tol
    # and the torch twin, the JAX test's own oracle
    assert np.max(np.abs(got - case.ref)) < (3e-2 if tol == F16_TOL
                                             else 1e-3)


def test_fp16_graph_runs_in_fp16(twins):
    case = twins["fp16_easter2"]
    fn = OnnxGraphFunction(load_model(case.path), device="cpu")
    assert {t.dtype for t in fn.weights.values()} == {torch.float16}
    (out,) = fn(fn.weights, torch.from_numpy(case.graph_x))
    assert out.dtype == torch.float16


def _golden(d):
    """TorchNet of tests/test_onnx_golden.py in exporter style: conv ->
    bn -> relu -> maxpool -> conv -> gap -> flatten -> gemm, one weight
    in a sidecar file, initializers repeated as inputs, batch dim_param."""
    g = torch.Generator().manual_seed(7)

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g) * scale + shift).numpy()

    w1 = r(8, 3, 3, 3, scale=0.3)
    (d / "weights.bin").write_bytes(b"\x00" * 16 + w1.tobytes())
    arrays = {"conv1.bias": r(8, scale=0.1), "bn.weight": np.abs(r(8)) + 0.5,
              "bn.bias": r(8, scale=0.2), "bn.mean": r(8, scale=0.3),
              "bn.var": np.abs(r(8)) + 0.7, "conv2.weight": r(4, 8, 3, 3,
                                                              scale=0.2),
              "conv2.bias": r(4, scale=0.1), "fc.weight": r(5, 4, scale=0.5),
              "fc.bias": r(5, scale=0.1)}
    inits = [sim.tensor("conv1.weight", w1, storage="external", external={
        "location": "weights.bin", "offset": 16, "length": w1.nbytes})]
    inits += [sim.tensor(k, v.astype(np.float32),
                         storage="floats" if k.startswith("bn") else "raw")
              for k, v in arrays.items()]
    nodes = [
        sim.node("Conv", ["input", "conv1.weight", "conv1.bias"], ["c1"],
                 pads=[1, 1, 1, 1], kernel_shape=[3, 3]),
        sim.node("BatchNormalization",
                 ["c1", "bn.weight", "bn.bias", "bn.mean", "bn.var"],
                 ["b1"], epsilon=1e-5),
        sim.node("Relu", ["b1"], ["r1"]),
        sim.node("MaxPool", ["r1"], ["m1"], kernel_shape=[2, 2],
                 strides=[2, 2]),
        sim.node("Conv", ["m1", "conv2.weight", "conv2.bias"], ["c2"],
                 kernel_shape=[3, 3]),
        sim.node("GlobalAveragePool", ["c2"], ["g1"]),
        sim.node("Flatten", ["g1"], ["f1"], axis=1),
        sim.node("Gemm", ["f1", "fc.weight", "fc.bias"], ["output"],
                 transB=1),
    ]
    inputs = [sim.value_info("input", ("batch", 3, 16, 16))] + [
        sim.value_info(k, v.shape) for k, v in arrays.items()]
    path = d / "golden.onnx"
    path.write_bytes(sim.model(nodes, inits, inputs,
                               [sim.value_info("output", ("batch", 5))]))
    return path


def _quantized(d):
    rng = np.random.default_rng(11)
    inits = [
        sim.tensor("w_q", rng.integers(-127, 128, (4, 3, 3, 3)).astype(
            np.int8)),
        sim.tensor("w_scale", rng.uniform(0.005, 0.02, 4).astype(np.float32)),
        sim.tensor("w_zp", rng.integers(-8, 8, 4).astype(np.int8)),
        sim.tensor("act_scale", np.array(0.05, np.float32)),
        sim.tensor("act_zp", np.array(128, np.uint8)),
    ]
    nodes = [
        sim.node("DequantizeLinear", ["w_q", "w_scale", "w_zp"], ["w_f"],
                 axis=0),
        sim.node("Conv", ["input", "w_f"], ["c"], kernel_shape=[3, 3],
                 pads=[1, 1, 1, 1]),
        sim.node("Relu", ["c"], ["r"]),
        sim.node("QuantizeLinear", ["r", "act_scale", "act_zp"], ["q"]),
        sim.node("DequantizeLinear", ["q", "act_scale", "act_zp"],
                 ["output"]),
    ]
    path = d / "quant.onnx"
    path.write_bytes(sim.model(nodes, inits,
                               [sim.value_info("input", (1, 3, 8, 8))],
                               [sim.value_info("output", (1, 4, 8, 8))]))
    return path


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_golden_graph_matches_jax_at_every_batch(tmp_path, batch):
    path = _golden(tmp_path)
    fn = OnnxGraphFunction(load_model(path), device="cpu")
    assert fn.input_names == ["input"]  # initializers are not feeds
    x = np.random.default_rng(batch).normal(
        size=(batch, 3, 16, 16)).astype(np.float32)
    assert np.max(np.abs(_port(path, x) - _jax(path, x))) < F32_TOL


def test_quantized_graph_matches_jax(tmp_path):
    path = _quantized(tmp_path)
    x = np.random.default_rng(2).normal(size=(1, 3, 8, 8)).astype(
        np.float32)
    got, want = _port(path, x), _jax(path, x)
    # a quantization step is 0.05: a rounding tie may land either side
    assert np.mean(np.abs(got - want) > F32_TOL) < 0.01
    assert np.max(np.abs(got - want)) <= 0.05 + F32_TOL


PORT_MODELS = {
    "unet_stem2": (lambda: UNet(1, 8, 2), (2, 3, 64, 64), {0: "b"}),
    "deeplab": (lambda: DeepLabV3Plus(5), (1, 3, 64, 64), {0: "b"}),
    "crnn": (lambda: CRNN(11, 32, 8), (2, 32, 64), {0: "b", 2: "w"}),
    **{f"easter2_{v}": (lambda v=v: Easter2(17, 16, 16, 0.125, v),
                        (2, 16, 64), {0: "b", 2: "w"})
       for v in ("base", "attention", "vit")},
}


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("name", sorted(PORT_MODELS))
def test_port_model_exports_match_jax_and_the_module(tmp_path, name, fold):
    """The port's own modules exported with dynamic batch (and width for
    the recognizers): the port's executor equals the module itself at the
    export's shape and at another batch and width, and JAX's executor on
    the folded export (the fold-free one differs only by BatchNorm nodes,
    which the twins' fold-free exports hold against JAX)."""
    make, shape, dyn = PORT_MODELS[name]
    torch.manual_seed(3)
    module = make().eval()
    randomize_bn(module)
    path = str(tmp_path / f"{name}.onnx")
    torch_export(module, torch.rand(*shape), path, do_constant_folding=fold,
                 input_names=["input"], output_names=["output"],
                 dynamic_axes={"input": dyn})
    fn = OnnxGraphFunction(load_model(path), device="cpu")
    other = (shape[0] + 1,) + shape[1:-1] + (
        shape[-1] * (2 if 2 in dyn else 1),)
    for s in (shape, other):
        x = np.random.default_rng(len(s)).random(s).astype(np.float32)
        got = fn(fn.weights, torch.from_numpy(x))[0].numpy()
        with torch.no_grad():
            own = module(torch.from_numpy(x)).numpy()
        assert np.max(np.abs(got - own)) < F32_TOL
        if s == shape and fold:
            assert np.max(np.abs(got - _jax(path, x))) < F32_TOL


def _line_recognizer(d, keep_channel_axis: bool):
    """(B, 1, H, W) -> (B, T, V), with or without a kept singleton axis
    (tests/test_onnx_golden.py _write_line_recognizer)."""
    g = torch.Generator().manual_seed(3)
    h, v = 8, 6
    inits = {"w1": torch.randn(4, 1, h, 3, generator=g) * 0.3,
             "b1": torch.randn(4, generator=g) * 0.1,
             "w2": torch.randn(v, 4, 1, 1, generator=g) * 0.5,
             "b2": torch.randn(v, generator=g) * 0.1}
    nodes = [
        sim.node("Conv", ["input", "w1", "b1"], ["c1"], kernel_shape=[h, 3],
                 pads=[0, 1, 0, 1]),
        sim.node("Relu", ["c1"], ["r1"]),
        sim.node("Conv", ["r1", "w2", "b2"], ["c2"], kernel_shape=[1, 1]),
        sim.node("Transpose", ["c2"], ["t1"], perm=[0, 3, 2, 1]),
    ]
    out = "t1"
    if not keep_channel_axis:
        nodes.append(sim.node("Squeeze", ["t1"], ["sq"], axes=[2]))
        out = "sq"
    path = d / f"rec_{keep_channel_axis}.onnx"
    path.write_bytes(sim.model(
        nodes, [sim.tensor(k, t.numpy()) for k, t in inits.items()],
        [sim.value_info("input", ("batch", 1, h, "width"))],
        [sim.value_info(out, ("batch", "time", v))]))
    return path, out


@pytest.mark.parametrize("keep_channel_axis", [False, True])
def test_line_layout_matches_jax_module(tmp_path, keep_channel_axis):
    """OnnxModule's recognizer layout: (B, H, W) in, (B, T, V) out, batch
    of 1 kept, singleton channel axis dropped; as JAX's module.apply."""
    path, out = _line_recognizer(tmp_path, keep_channel_axis)
    kw = dict(layout="line", input_layer="input", output_layer=out,
              squeeze_channel=False, vocab_size=6)
    jm, pm = jax_load(path, **kw), load_onnx_module(path, device="cpu", **kw)
    for b in (1, 2):
        x = np.random.default_rng(b).normal(size=(b, 8, 32)).astype(
            np.float32)
        want = np.asarray(jm.apply(jm.variables, x))
        got = pm(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (b, 32, 6)
        assert got.dtype == np.float32
        assert np.max(np.abs(got - want)) < F32_TOL


def test_recognizer_vocab_transpose_and_swap_hw(twins):
    """A (B, V, T) graph comes out (B, T, V) when vocab_size says so, and
    swap_hw feeds a channels-last graph, as JAX's module does."""
    base = twins["easter2_fold"]
    kw = dict(layout="line", vocab_size=17)
    jm, pm = jax_load(base.path, **kw), load_onnx_module(base.path,
                                                         device="cpu", **kw)
    want = np.asarray(jm.apply(jm.variables, base.graph_x))
    got = pm(torch.from_numpy(base.graph_x)).numpy()
    assert got.shape == want.shape == (2, 16, 17)
    assert np.max(np.abs(got - want)) < F32_TOL
    tf = twins["tf_easter2"]
    pm = load_onnx_module(tf.path, "line", swap_hw=True, vocab_size=17,
                          device="cpu")
    got = pm(torch.from_numpy(tf.port_x)).numpy()
    assert np.max(np.abs(got - tf.ref)) < 1e-3


def test_segmentation_layouts(twins):
    """"nchw" passes the engine's tiles through; "nhwc->nchw" is JAX's
    layout, NHWC in and out."""
    case = twins["unet"]
    pm = load_onnx_module(case.path, "nchw", device="cpu")
    got = pm(torch.from_numpy(case.graph_x)).numpy()
    assert np.max(np.abs(got - case.ref)) < 1e-3
    jm = jax_load(case.path, layout="nhwc->nchw")
    want = np.asarray(jm.apply(jm.variables, case.jax_x))
    pm = load_onnx_module(case.path, "nhwc->nchw", device="cpu")
    got = pm(torch.from_numpy(case.jax_x)).numpy()
    assert np.max(np.abs(got - want)) < F32_TOL


def test_bf16_mode_casts_weights_and_returns_float32(twins, monkeypatch):
    """dtype=bfloat16 (or OCR_ONNX_BF16=1): every float weight and
    constant in bf16, the activations kept there, float32 out within
    bf16 tolerance of the float32 run."""
    case = twins["unet"]
    f32 = load_onnx_module(case.path, device="cpu")
    monkeypatch.setenv("OCR_ONNX_BF16", "1")
    b16 = load_onnx_module(case.path, device="cpu")
    assert b16.fn.dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for t in b16.fn.weights.values()
               if t.is_floating_point())
    x = torch.from_numpy(case.graph_x)
    got16, got32 = b16(x), f32(x)
    assert got16.dtype == torch.float32
    assert float((got16 - got32).abs().max()) < 0.1 * float(
        got32.abs().max())


def test_load_time_folding_and_shape_reuse(tmp_path):
    """Constant shape chains fold at load time; the host values of the
    rest are computed once per input shape set, so a second call with
    the same shapes evaluates fewer nodes, and a new shape gives the right
    answer."""
    torch.manual_seed(0)
    module = Easter2(17, 16, 16, 0.125).eval()
    path = str(tmp_path / "e.onnx")
    torch_export(module, torch.rand(2, 16, 64), path,
                 input_names=["input"], output_names=["output"],
                 dynamic_axes={"input": {0: "b", 2: "w"}})
    model = load_model(path)
    fn = OnnxGraphFunction(model, device="cpu")
    assert len(fn._steps) < len(model.graph.nodes)
    assert not any(s.node.op_type == "Constant" for s in fn._steps)
    x = torch.rand(3, 16, 96)
    fn(fn.weights, x)
    first = fn.steps_run
    fn(fn.weights, x)
    assert fn.steps_run < first
    y = torch.rand(1, 16, 32)
    with torch.no_grad():
        assert float((fn(fn.weights, y)[0] - module(y)).abs().max()) < 1e-5
