"""Each ONNX lowering of the port (onnx/ops.py) against the JAX package's
(ocr_inference_tpu/onnx/ops.py) on the same single-node graphs and the
same seeded inputs, through both executors; float32, tolerance 1e-5.

The attribute cases are the ones where a lowering is most likely to go
wrong: auto_pad SAME_UPPER / SAME_LOWER, pool ceil_mode and
count_include_pad, Resize nearest / linear / cubic up AND down (the JAX
function antialiases when downscaling and uses Keys a = -0.5), GRU with
linear_before_reset 0 and 1 in every direction, LSTM, per-channel
QuantizeLinear / DequantizeLinear, negative Gather and Slice indices.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ocr_inference_tpu.onnx.runner import OnnxGraphFunction as JaxGraph
from ocr_inference_tpu_torch.onnx.runner import OnnxGraphFunction
from ocr_inference_tpu_torch.onnx.wire import (
    encode_model,
    encode_node,
    encode_tensor,
    encode_value_info,
    parse_model,
)

TOL = 1e-5
F32, I64 = 1, 7


def _rng(name: str):
    return np.random.default_rng(sum(map(ord, name)))


def _f(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _i(*values):
    return np.array(values, np.int64)


def _unary(op, x, **attrs):
    return [("N", op, ["x"], ["y"], attrs)], {}, {"x": x}, ["y"]


def _with_params(op, x, params: dict, data_names=("x",), **attrs):
    """One node whose inputs are ``x`` then the named initializers."""
    names = list(data_names) + list(params)
    return ([("N", op, names, ["y"], attrs)], params, {"x": x}, ["y"])


def _rnn(op, rng, lbr=None, direction="forward", hidden=4, as_inputs=False):
    gates = 3 if op == "GRU" else 4
    dirs = 2 if direction == "bidirectional" else 1
    x = _f(rng, 5, 2, 3)  # (T, B, I)
    w = _f(rng, dirs, gates * hidden, 3) * 0.5
    r = _f(rng, dirs, gates * hidden, hidden) * 0.5
    b = _f(rng, dirs, 2 * gates * hidden) * 0.3
    attrs = {"hidden_size": hidden, "direction": direction}
    if lbr is not None:
        attrs["linear_before_reset"] = lbr
    feeds = {"x": x, "w": w, "r": r, "b": b} if as_inputs else {"x": x}
    inits = {} if as_inputs else {"w": w, "r": r, "b": b}
    outs = ["y", "yh"] if op == "GRU" else ["y", "yh", "yc"]
    return [("N", op, ["x", "w", "r", "b"], outs, attrs)], inits, feeds, outs


def _cases():
    c = {}
    r = _rng
    # -- convolutions --
    for auto in ("SAME_UPPER", "SAME_LOWER"):
        for k in (3, 4):
            rng = r(f"conv{auto}{k}")
            c[f"conv_{auto.lower()}_k{k}_s2"] = _with_params(
                "Conv", _f(rng, 1, 3, 9, 10), {"w": _f(rng, 4, 3, k, k)},
                auto_pad=auto, strides=[2, 2])
    rng = r("conv_asym")
    c["conv_pads_asym_bias"] = _with_params(
        "Conv", _f(rng, 2, 3, 8, 8),
        {"w": _f(rng, 4, 3, 3, 3), "b": _f(rng, 4)}, pads=[0, 1, 2, 1])
    rng = r("conv_group")
    c["conv_group_dilation"] = _with_params(
        "Conv", _f(rng, 1, 4, 12, 12), {"w": _f(rng, 6, 2, 3, 3)},
        group=2, dilations=[2, 2], pads=[2, 2, 2, 2])
    rng = r("conv1d")
    c["conv1d_stride"] = _with_params(
        "Conv", _f(rng, 2, 5, 17), {"w": _f(rng, 3, 5, 5), "b": _f(rng, 3)},
        strides=[2], pads=[2, 1])
    # -- pools --
    rng = r("pool")
    x = _f(rng, 1, 2, 7, 9)
    c["maxpool_ceil"] = _unary("MaxPool", x, kernel_shape=[3, 3],
                               strides=[2, 2], ceil_mode=1)
    c["maxpool_pads"] = _unary("MaxPool", x, kernel_shape=[3, 2],
                               strides=[1, 2], pads=[1, 0, 1, 1])
    c["maxpool_same_upper"] = _unary("MaxPool", x, kernel_shape=[2, 2],
                                     strides=[2, 2], auto_pad="SAME_UPPER")
    for incl in (0, 1):
        c[f"avgpool_ceil_pads_incl{incl}"] = _unary(
            "AveragePool", x, kernel_shape=[3, 3], strides=[2, 2],
            pads=[1, 1, 1, 1], ceil_mode=1, count_include_pad=incl)
    c["avgpool_same_lower"] = _unary("AveragePool", x, kernel_shape=[3, 3],
                                     strides=[2, 2], auto_pad="SAME_LOWER")
    c["global_avg_pool"] = _unary("GlobalAveragePool", x)
    c["global_max_pool"] = _unary("GlobalMaxPool", x)
    # -- resize --
    rng = r("resize")
    img = _f(rng, 1, 2, 6, 8)
    for mode in ("nearest", "linear", "cubic"):
        for tag, size in (("up", [1, 2, 11, 13]), ("down", [1, 2, 4, 3])):
            c[f"resize_{mode}_{tag}_sizes"] = (
                [("N", "Resize", ["x", "", "", "sizes"], ["y"],
                  {"mode": mode})], {"sizes": _i(*size)}, {"x": img}, ["y"])
        c[f"resize_{mode}_scales"] = (
            [("N", "Resize", ["x", "", "scales"], ["y"], {"mode": mode})],
            {"scales": np.array([1, 1, 2.0, 0.5], np.float32)}, {"x": img},
            ["y"])
    for mode in ("nearest", "linear"):
        c[f"upsample_{mode}"] = (
            [("N", "Upsample", ["x", "scales"], ["y"], {"mode": mode})],
            {"scales": np.array([1, 1, 2.0, 3.0], np.float32)}, {"x": img},
            ["y"])
    # -- recurrent --
    for lbr in (0, 1):
        for direction in ("forward", "reverse", "bidirectional"):
            c[f"gru_lbr{lbr}_{direction}"] = _rnn(
                "GRU", r(f"gru{lbr}{direction}"), lbr, direction)
    c["gru_lbr1_weights_as_inputs"] = _rnn("GRU", r("gru_in"), 1,
                                           "bidirectional", as_inputs=True)
    for direction in ("forward", "reverse", "bidirectional"):
        c[f"lstm_{direction}"] = _rnn("LSTM", r(f"lstm{direction}"),
                                      direction=direction)
    # -- quantization --
    rng = r("quant")
    xq = _f(rng, 2, 3, 4) * 4
    scale3 = rng.uniform(0.02, 0.1, 3).astype(np.float32)
    for zp_name, zp in (("int8", np.array([-3, 0, 5], np.int8)),
                        ("uint8", np.array([120, 128, 130], np.uint8))):
        c[f"quantize_per_channel_{zp_name}"] = _with_params(
            "QuantizeLinear", xq, {"s": scale3, "zp": zp}, axis=1)
    c["quantize_no_zero_point"] = _with_params(
        "QuantizeLinear", np.abs(xq), {"s": np.array(0.05, np.float32)})
    c["dequantize_per_channel"] = (
        [("N", "DequantizeLinear", ["q", "s", "zp"], ["y"], {"axis": 1})],
        {"s": scale3, "zp": np.array([-3, 0, 5], np.int8)},
        {"q": rng.integers(-128, 128, (2, 3, 4)).astype(np.int8)}, ["y"])
    # -- normalisation --
    rng = r("norm")
    xn = _f(rng, 2, 5, 4, 3)
    c["batchnorm"] = _with_params(
        "BatchNormalization", xn,
        {"s": _f(rng, 5), "b": _f(rng, 5), "m": _f(rng, 5),
         "v": np.abs(_f(rng, 5)) + 0.5}, epsilon=1e-3)
    c["instancenorm"] = _with_params("InstanceNormalization", xn,
                                     {"s": _f(rng, 5), "b": _f(rng, 5)})
    c["layernorm"] = _with_params("LayerNormalization", xn,
                                  {"s": _f(rng, 4, 3), "b": _f(rng, 4, 3)},
                                  axis=2, epsilon=1e-6)
    # -- small ops --
    rng = r("small")
    xs = _f(rng, 3, 4, 5)
    c["argmax_keepdims"] = _unary("ArgMax", xs, axis=1, keepdims=1)
    c["argmax_drop"] = _unary("ArgMax", xs, axis=-1, keepdims=0)
    c["cast_to_int32"] = _unary("Cast", xs * 10, to=6)
    c["shape_start_end_gather_neg"] = (
        [("A", "Shape", ["x"], ["s"], {"start": 1, "end": 3}),
         ("B", "Gather", ["s", "i"], ["g"], {"axis": 0}),
         ("C", "Reshape", ["x", "t"], ["y0"], {}),
         ("D", "Mul", ["y0", "k"], ["y"], {})],
        {"i": np.array(-1, np.int64), "t": _i(0, -1),
         "k": np.array(2.0, np.float32)}, {"x": xs}, ["y", "g"])
    c["gather_negative_indices"] = _with_params(
        "Gather", xs, {"i": _i(-1, 0, -3)}, axis=1)
    c["slice_negative_steps"] = _with_params(
        "Slice", xs, {"st": _i(-1, 1), "en": _i(-10, 5), "ax": _i(1, 2),
                      "sp": _i(-2, 2)})
    c["slice_clamped_ends"] = _with_params(
        "Slice", xs, {"st": _i(1), "en": _i(2 ** 62), "ax": _i(-1)})
    c["squeeze_unsqueeze"] = (
        [("A", "Unsqueeze", ["x", "a"], ["u"], {}),
         ("B", "Squeeze", ["u", "b"], ["y"], {})],
        {"a": _i(0, -1), "b": _i(-1)}, {"x": xs}, ["y"])
    c["concat_split"] = (
        [("A", "Concat", ["x", "x"], ["cc"], {"axis": -1}),
         ("B", "Split", ["cc", "sp"], ["y1", "y2"], {"axis": 2})],
        {"sp": _i(3, 7)}, {"x": xs}, ["y1", "y2"])
    c["expand_tile"] = (
        [("A", "Expand", ["x", "e"], ["ex"], {}),
         ("B", "Tile", ["ex", "t"], ["y"], {})],
        {"e": _i(2, 3, 1, 5), "t": _i(1, 2, 1, 1)},
        {"x": _f(rng, 3, 1, 5)}, ["y"])
    for mode in ("constant", "reflect", "edge"):
        c[f"pad_{mode}"] = (
            [("N", "Pad", ["x", "p", "v"], ["y"], {"mode": mode})],
            {"p": _i(0, 1, 2, 0, 2, 1), "v": np.array(1.5, np.float32)},
            {"x": xs}, ["y"])
    c["where_clip_softmax"] = (
        [("A", "Greater", ["x", "z"], ["m"], {}),
         ("B", "Where", ["m", "x", "z"], ["w"], {}),
         ("C", "Clip", ["w", "lo", "hi"], ["cl"], {}),
         ("D", "Softmax", ["cl"], ["y"], {"axis": 1})],
        {"z": np.array(0.1, np.float32), "lo": np.array(-0.5, np.float32),
         "hi": np.array(0.8, np.float32)}, {"x": xs}, ["y"])
    c["einsum"] = ([("N", "Einsum", ["x", "x2"], ["y"],
                     {"equation": "bij,bjk->bik"})], {},
                   {"x": xs, "x2": _f(rng, 3, 5, 2)}, ["y"])
    c["gemm_trans_alpha_beta"] = (
        [("N", "Gemm", ["x", "w", "b"], ["y"],
          {"transA": 1, "transB": 1, "alpha": 0.5, "beta": 2.0})],
        {"w": _f(rng, 6, 4), "b": _f(rng, 6)}, {"x": _f(rng, 4, 3)}, ["y"])
    c["matmul_batched"] = _with_params("MatMul", xs, {"w": _f(rng, 5, 7)})
    for red in ("Mean", "Sum", "Max", "Min", "Prod"):
        c[f"reduce_{red.lower()}"] = _unary(f"Reduce{red}", xs, axes=[0, 2],
                                            keepdims=0)
    c["range_constant_of_shape"] = (
        [("A", "Shape", ["x"], ["s"], {}),
         ("B", "ConstantOfShape", ["s"], ["o"],
          {"value": np.array([0.5], np.float32)}),
         ("C", "Range", ["r0", "r1", "r2"], ["rg"], {}),
         ("D", "Cast", ["rg"], ["rf"], {"to": F32}),
         ("E", "Add", ["x", "o"], ["xo"], {}),
         ("F", "Add", ["xo", "rf"], ["y"], {})],
        {"r0": np.array(1, np.int64), "r1": np.array(11, np.int64),
         "r2": np.array(2, np.int64)}, {"x": xs}, ["y"])
    c["flatten"] = _unary("Flatten", xs, axis=2)
    xd = _f(rng, 2, 8, 4, 6)
    c["space_to_depth"] = _unary("SpaceToDepth", xd, blocksize=2)
    for mode in ("DCR", "CRD"):
        c[f"depth_to_space_{mode.lower()}"] = _unary(
            "DepthToSpace", xd, blocksize=2, mode=mode)
    c["mod_pow_int"] = (
        [("A", "Mod", ["a", "b"], ["m"], {}),
         ("C", "Pow", ["a", "k"], ["p"], {})],
        {"k": np.array(2, np.int64)},
        {"a": _i(7, -7, 9, 10), "b": _i(3, 3, -4, 5)}, ["m", "p"])
    for op in ("Relu", "Sigmoid", "Tanh", "Exp", "Abs", "Neg", "Floor",
               "Ceil", "Round", "Erf", "Softplus", "Sin", "Cos"):
        c[f"unary_{op.lower()}"] = _unary(op, xs * 2)
    for op in ("Log", "Sqrt"):
        c[f"unary_{op.lower()}"] = _unary(op, np.abs(xs) + 0.1)
    for op, attrs in (("LeakyRelu", {"alpha": 0.2}), ("Elu", {"alpha": 0.7}),
                      ("HardSigmoid", {"alpha": 0.3, "beta": 0.4}),
                      ("LogSoftmax", {"axis": -1})):
        c[f"unary_{op.lower()}"] = _unary(op, xs, **attrs)
    c["prelu_min_max"] = (
        [("A", "PRelu", ["x", "s"], ["p"], {}),
         ("B", "Max", ["p", "x"], ["mx"], {}),
         ("C", "Min", ["mx", "z"], ["y"], {})],
        {"s": np.array([0.1, 0.2, 0.3, 0.4, 0.5], np.float32),
         "z": np.array(0.3, np.float32)}, {"x": xs}, ["y"])
    return c


CASES = _cases()


def _model(nodes, inits: dict, feeds: dict, outputs):
    buf = encode_model(
        [encode_node(op, ins, outs, name=name, **attrs)
         for name, op, ins, outs, attrs in nodes],
        [encode_tensor(k, v) for k, v in inits.items()],
        [encode_value_info(k, F32, list(v.shape)) for k, v in feeds.items()],
        [encode_value_info(o, F32, [1]) for o in outputs],
        opset=17,
    )
    return parse_model(buf)


@pytest.mark.parametrize("name", sorted(CASES))
def test_lowering_matches_jax(name):
    nodes, inits, feeds, outputs = CASES[name]
    model = _model(nodes, inits, feeds, outputs)
    jax_fn = JaxGraph(model)
    want = [np.asarray(o) for o in jax_fn(jax_fn.weights,
                                          *feeds.values())]
    port = OnnxGraphFunction(model, device="cpu")
    got = [o.numpy() for o in port(port.weights, *feeds.values())]
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
        else:
            assert g.dtype == w.dtype or (g.dtype.kind == w.dtype.kind
                                          and w.dtype.itemsize <= 4)
            np.testing.assert_array_equal(g, w)


def test_integer_div_truncates_as_onnx_says():
    """Div of integers is integer division toward zero (ONNX); the JAX
    lowering divides in floats (jnp.divide), so its quotients are held
    truncated (ROADMAP §3)."""
    feeds = {"a": _i(7, -7, 9, 10, 3), "b": _i(3, 3, -4, 5, 7)}
    model = _model([("N", "Div", ["a", "b"], ["y"], {})], {}, feeds, ["y"])
    jax_fn = JaxGraph(model)
    want = np.trunc(np.asarray(jax_fn(jax_fn.weights, *feeds.values())[0]))
    port = OnnxGraphFunction(model, device="cpu")
    got = port(port.weights, *feeds.values())[0].numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("c_out", [4, 3])
def test_conv_transpose_matches_jax_with_its_kernel_axes_swapped(c_out):
    """ConvTranspose: ONNX's kernel is (C_in, C_out / group, kH, kW); the
    JAX lowering reads it as (C_out, C_in, ...) (ROADMAP §3), so it gets
    the kernel with those axes swapped. Asymmetric pads, output_padding,
    stride 2 and a bias; torch's conv_transpose2d is the third opinion."""
    rng = _rng(f"convt{c_out}")
    x, w, b = _f(rng, 1, 4, 5, 6), _f(rng, 4, c_out, 3, 3), _f(rng, c_out)
    attrs = {"strides": [2, 2], "pads": [1, 0, 0, 1],
             "output_padding": [1, 1]}

    def model(kernel):
        return _model([("N", "ConvTranspose", ["x", "w", "b"], ["y"],
                        attrs)], {"w": kernel, "b": b}, {"x": x}, ["y"])

    jax_fn = JaxGraph(model(np.ascontiguousarray(w.transpose(1, 0, 2, 3))))
    want = np.asarray(jax_fn(jax_fn.weights, x)[0])
    port = OnnxGraphFunction(model(w), device="cpu")
    got = port(port.weights, x)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    full = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x), torch.from_numpy(w), stride=2)
    full = torch.nn.functional.pad(full, (0, 1, 0, 1))[:, :, 1:, :-1]
    full = full + torch.from_numpy(b)[:, None, None]
    np.testing.assert_allclose(got, full.numpy(), rtol=0, atol=TOL)


def test_missing_ops_are_listed_by_name():
    model = _model([("A", "NonZero", ["x"], ["n"], {}),
                    ("B", "TopK", ["x", "k"], ["v", "i"], {}),
                    ("C", "Relu", ["x"], ["y"], {})],
                   {"k": _i(1)}, {"x": np.ones((2, 2), np.float32)}, ["y"])
    with pytest.raises(NotImplementedError, match=r"\['NonZero', 'TopK'\]"):
        OnnxGraphFunction(model, device="cpu")


def test_rnn_limits_are_refused():
    """What the recurrent lowerings do not compute raises, never a wrong
    answer: sequence lengths, clipping."""
    rng = _rng("limits")
    nodes, inits, feeds, outs = _rnn("GRU", rng, 1)
    nodes[0][4]["clip"] = 3.0
    with pytest.raises(NotImplementedError, match="clip"):
        OnnxGraphFunction(_model(nodes, inits, feeds, outs), device="cpu")
    nodes, inits, feeds, outs = _rnn("LSTM", rng)
    nodes = [(n, op, ins + ["lens"], o, a) for n, op, ins, o, a in nodes]
    with pytest.raises(NotImplementedError, match="sequence_lens"):
        OnnxGraphFunction(_model(
            nodes, {**inits, "lens": np.array([5, 5], np.int32)}, feeds,
            outs), device="cpu")
