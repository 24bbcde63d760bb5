"""The port's ONNX wire codec, inspect CLI and export shim against the JAX
package's.

The graphs come from tests/onnx_exporter_sim.py, an exporter-style writer
that shares no code with either codec: packed dims, float_data and
raw_data storage, external data in one and in two sidecar files at
nonzero offsets, initializers repeated as graph inputs (pre-IR4),
dim_param axes, doc strings to skip, several opset domains, int8
weights behind DequantizeLinear. Parsed fields must be equal, encoders
must give equal bytes, and the inspect CLI must print the same text.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ocr_inference_tpu.cli import inspect_onnx_cli as jax_inspect
from ocr_inference_tpu.onnx import export_shim as jax_shim
from ocr_inference_tpu.onnx import wire as jax_wire
from ocr_inference_tpu_torch.cli import inspect_onnx_cli as port_inspect
from ocr_inference_tpu_torch.onnx import export_shim as port_shim
from ocr_inference_tpu_torch.onnx import wire as port_wire
from tests import onnx_exporter_sim as sim


def _golden(d):
    """A conv/bn/pool/gemm graph in exporter style, one weight in a
    sidecar file at offset 16, every initializer also a graph input."""
    rng = np.random.default_rng(7)
    w1 = rng.normal(size=(8, 3, 3, 3)).astype(np.float32)
    (d / "weights.bin").write_bytes(b"\x00" * 16 + w1.tobytes() + b"\xff" * 8)
    arrays = {
        "conv1.bias": rng.normal(size=8), "bn.weight": rng.random(8) + 0.5,
        "bn.bias": rng.normal(size=8), "bn.mean": rng.normal(size=8),
        "bn.var": rng.random(8) + 0.7, "fc.weight": rng.normal(size=(5, 8)),
        "fc.bias": rng.normal(size=5),
    }
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    storage = {"bn.weight": "floats", "bn.bias": "floats",
               "fc.weight": "floats"}
    inits = [sim.tensor("conv1.weight", w1, storage="external", external={
        "location": "weights.bin", "offset": 16, "length": w1.nbytes})]
    inits += [sim.tensor(k, v, storage=storage.get(k, "raw"))
              for k, v in arrays.items()]
    inits.append(sim.tensor("axes", np.array([2, 3], np.int64)))
    nodes = [
        sim.node("Conv", ["input", "conv1.weight", "conv1.bias"], ["c1"],
                 pads=[1, 1, 1, 1], kernel_shape=[3, 3]),
        sim.node("BatchNormalization",
                 ["c1", "bn.weight", "bn.bias", "bn.mean", "bn.var"],
                 ["b1"], epsilon=1e-5),
        sim.node("Relu", ["b1"], ["r1"]),
        sim.node("MaxPool", ["r1"], ["m1"], kernel_shape=[2, 2],
                 strides=[2, 2]),
        sim.node("ReduceMean", ["m1"], ["g1"], axes=[2, 3], keepdims=0),
        sim.node("Gemm", ["g1", "fc.weight", "fc.bias"], ["output"],
                 transB=1, alpha=1.0),
    ]
    shapes = {"conv1.weight": w1.shape, **{k: v.shape
                                           for k, v in arrays.items()}}
    inputs = [sim.value_info("input", ("batch", 3, 16, 16))] + [
        sim.value_info(k, s) for k, s in shapes.items()]
    path = d / "golden.onnx"
    path.write_bytes(sim.model(nodes, inits, inputs,
                               [sim.value_info("output", ("batch", 5))]))
    return path


def _multi_file(d):
    """Two initializers in two sidecar files, each at a nonzero offset."""
    rng = np.random.default_rng(11)
    w = rng.normal(size=(6, 3, 3, 3)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    (d / "weights_0.bin").write_bytes(b"\x00" * 32 + w.tobytes())
    (d / "weights_1.bin").write_bytes(b"\xaa" * 8 + b.tobytes() + b"\xbb" * 4)
    inits = [
        sim.tensor("w", w, storage="external", external={
            "location": "weights_0.bin", "offset": 32, "length": w.nbytes}),
        sim.tensor("b", b, storage="external", external={
            "location": "weights_1.bin", "offset": 8, "length": b.nbytes}),
    ]
    nodes = [sim.node("Conv", ["input", "w", "b"], ["output"],
                      pads=[1, 1, 1, 1], kernel_shape=[3, 3])]
    path = d / "multi.onnx"
    path.write_bytes(sim.model(
        nodes, inits, [sim.value_info("input", ("batch", 3, 16, 16))],
        [sim.value_info("output", ("batch", 6, 16, 16))], opset=11))
    return path


def _quantized(d):
    """int8 per-channel weights behind DequantizeLinear, a QDQ pair on the
    activation."""
    rng = np.random.default_rng(3)
    inits = [
        sim.tensor("w_q", rng.integers(-127, 128, (4, 3, 3, 3)).astype(
            np.int8)),
        sim.tensor("w_scale", rng.uniform(0.005, 0.02, 4).astype(np.float32)),
        sim.tensor("w_zp", rng.integers(-8, 8, 4).astype(np.int8)),
        sim.tensor("s", np.array(0.05, np.float32)),
        sim.tensor("zp", np.array(128, np.uint8)),
    ]
    nodes = [
        sim.node("DequantizeLinear", ["w_q", "w_scale", "w_zp"], ["w_f"],
                 axis=0),
        sim.node("Conv", ["input", "w_f"], ["c"], kernel_shape=[3, 3],
                 pads=[1, 1, 1, 1]),
        sim.node("QuantizeLinear", ["c", "s", "zp"], ["q"]),
        sim.node("DequantizeLinear", ["q", "s", "zp"], ["output"]),
    ]
    path = d / "quant.onnx"
    path.write_bytes(sim.model(
        nodes, inits, [sim.value_info("input", (1, 3, 8, 8))],
        [sim.value_info("output", (1, 4, 8, 8))]))
    return path


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wire")
    return {"golden": _golden(d), "multi_file": _multi_file(d),
            "quantized": _quantized(d)}


def _graph_fields(g):
    """Every parsed field of a wire.Graph as plain data (initializers as
    numpy arrays, attribute values recursively)."""
    def attr(a):
        v = a.value
        if isinstance(v, np.ndarray):
            return ("tensor", v.dtype.str, v.shape, v.tobytes())
        if a.g is not None:
            return ("graph", _graph_fields(a.g))
        return (a.type, v)

    return {
        "name": g.name,
        "nodes": [(n.op_type, n.name, n.domain, list(n.inputs),
                   list(n.outputs),
                   {k: attr(a) for k, a in n.attributes.items()})
                  for n in g.nodes],
        "inits": {k: (t.to_numpy().dtype.str, t.to_numpy().shape,
                      t.to_numpy().tobytes())
                  for k, t in g.initializers.items()},
        "inputs": [(v.name, v.elem_type, list(v.shape)) for v in g.inputs],
        "outputs": [(v.name, v.elem_type, list(v.shape)) for v in g.outputs],
    }


@pytest.mark.parametrize("name", ["golden", "multi_file", "quantized"])
def test_load_model_fields_equal_jax(graphs, name):
    """load_model (external data resolved, weight DequantizeLinear folded)
    gives the JAX package's fields exactly."""
    want = jax_wire.load_model(graphs[name])
    got = port_wire.load_model(graphs[name])
    assert (got.ir_version, got.producer, got.opset) == (
        want.ir_version, want.producer, want.opset)
    assert _graph_fields(got.graph) == _graph_fields(want.graph)


def test_parse_model_without_resolving_equal_jax(graphs):
    """parse_model alone leaves the external tensors unresolved, as JAX's
    does, and both raise the same error when one is read."""
    raw = graphs["golden"].read_bytes()
    got, want = port_wire.parse_model(raw), jax_wire.parse_model(raw)
    t_got = got.graph.initializers["conv1.weight"]
    t_want = want.graph.initializers["conv1.weight"]
    assert (t_got.data_location, t_got.external_data) == (
        t_want.data_location, t_want.external_data)
    with pytest.raises(ValueError, match="not resolved"):
        t_got.to_numpy()
    assert port_wire.fold_dequantize(port_wire.load_model(
        graphs["quantized"]).graph) == 0  # already folded at load


ENCODE_CASES = {
    "tensor_f32": lambda w: w.encode_tensor(
        "t", np.arange(12, dtype=np.float32).reshape(3, 4)),
    "tensor_f16": lambda w: w.encode_tensor(
        "h", np.linspace(-2, 2, 6).astype(np.float16)),
    "tensor_i64_scalar": lambda w: w.encode_tensor("s", np.int64(-3)),
    "tensor_u8": lambda w: w.encode_tensor("u", np.arange(5, dtype=np.uint8)),
    "node_attrs": lambda w: w.encode_node(
        "Conv", ["x", "w", ""], ["y"], name="c", kernel_shape=[3, 3],
        pads=[1, 0, 1, 0], group=2, alpha=0.5, mode="nearest",
        scales=[1.0, 2.0], value=np.ones((2,), np.float32)),
    "value_info": lambda w: w.encode_value_info(
        "input", 1, ["batch", 3, 32, 64]),
    "model": lambda w: w.encode_model(
        [w.encode_node("Relu", ["x"], ["y"])],
        [w.encode_tensor("k", np.ones(3, np.float32))],
        [w.encode_value_info("x", 1, [1, 3])],
        [w.encode_value_info("y", 1, [1, 3])], graph_name="g", opset=13),
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_encoders_give_jax_bytes(case):
    assert ENCODE_CASES[case](port_wire) == ENCODE_CASES[case](jax_wire)


def test_replace_initializers_gives_jax_bytes(graphs):
    """In-place weight surgery (new values, an added initializer, a
    re-pointed node input) writes the same bytes as JAX's."""
    raw = graphs["golden"].read_bytes()
    rng = np.random.default_rng(1)
    arrays = {"fc.bias": rng.normal(size=5).astype(np.float64),
              "bn.var": rng.random(8).astype(np.float32)}
    kwargs = dict(additions={"extra": np.arange(4, dtype=np.int64)},
                  input_renames={(1, 4): "extra"})
    got = port_wire.replace_initializers(raw, arrays, **kwargs)
    assert got == jax_wire.replace_initializers(raw, arrays, **kwargs)
    with pytest.raises(KeyError, match="nope"):
        port_wire.replace_initializers(raw, {"nope": np.zeros(1)})


@pytest.mark.parametrize("nodes", [False, True])
def test_inspect_cli_prints_what_jax_prints(graphs, capsys, nodes):
    for path in graphs.values():
        args = [str(path)] + (["--nodes"] if nodes else [])
        assert jax_inspect.main(args) == 0
        want = capsys.readouterr().out
        assert port_inspect.main(args) == 0
        assert capsys.readouterr().out == want
        assert "inputs (1):" in want


def test_export_shim_hands_torch_bytes_through(tmp_path):
    """The port's shim and JAX's let the same TorchScript export through
    byte for byte, and the port's parser reads it."""
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1),
                            torch.nn.ReLU()).eval()
    x = torch.randn(1, 3, 8, 8)
    port_shim.torch_export(m, x, str(tmp_path / "port.onnx"))
    jax_shim.torch_export(m, x, str(tmp_path / "jax.onnx"))
    raw = (tmp_path / "port.onnx").read_bytes()
    assert raw == (tmp_path / "jax.onnx").read_bytes()
    model = port_wire.parse_model(raw)
    assert [n.op_type for n in model.graph.nodes] == ["Conv", "Relu"]
