"""ONNX operator -> torch lowering registry.

Counterpart of ocr_inference_tpu/onnx/ops.py, with the same op set. Each
lowering takes (node, inputs) and returns a tuple of outputs, laid out as
ONNX defines them (NCHW images, (T, D, B, H) recurrent outputs).

The executor (onnx/runner.py) hands a lowering its inputs in two kinds:

- data inputs are torch tensors (on the card, or on the CPU when the
  executor folds a node on the host), ``None`` for an omitted optional
  input;
- parameter inputs, the positions ``PARAMS`` lists for the op (a Reshape's
  target, a Slice's starts, a Pad's pads, ...), are whatever value the
  graph holds: a host numpy array when it is a constant or comes from a
  shape computation, which is the rule for every exporter this repo has
  seen. ``_ints``/``_floats`` read either kind.

Shape, Size, Constant, ConstantOfShape and Range return host numpy arrays,
so the shape chains exporters emit stay on the host.

Where the JAX lowering departs from the ONNX specification, this module
follows the JAX function, which is its oracle (ROADMAP §3 lists these):

- Resize and Upsample resample as ``jax.image.resize`` does, whatever
  ``coordinate_transformation_mode`` says: half-pixel centres, a
  triangle (linear) or Keys a = -0.5 (cubic) kernel renormalised at the
  borders, and when downscaling that kernel widened by the inverse scale
  (antialiasing); nearest takes ``floor((i + 0.5) * in / out)``.
- Pools with ``ceil_mode`` extend the high side until the last window is
  whole, and the average divides by the kernel size under
  ``count_include_pad``, by the count of real elements otherwise.

The recurrences run through torch's RNN (cuDNN's on the card) with the
gates reordered where the function is the same: GRU with
``linear_before_reset=1`` (ONNX z, r, h -> torch r, z, n) and LSTM (ONNX
i, o, f, c -> torch i, f, g, o). GRU with ``linear_before_reset=0``, the
ONNX default, applies the reset gate before the hidden matmul, which
``torch.gru`` cannot express, so it runs as a step loop.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ocr_inference_tpu_torch.onnx.wire import TENSOR_DTYPES, Node

REGISTRY: dict[str, Callable] = {}

# input positions the executor passes through as they are held (host
# arrays as a rule) instead of as tensors
PARAMS: dict[str, frozenset] = {
    "Shape": frozenset({0}), "Size": frozenset({0}),
    "Reshape": frozenset({1}), "Squeeze": frozenset({1}),
    "Unsqueeze": frozenset({1}), "Split": frozenset({1}),
    "Slice": frozenset({1, 2, 3, 4}), "Expand": frozenset({1}),
    "Tile": frozenset({1}), "Pad": frozenset({1, 2, 3}),
    "Resize": frozenset({1, 2, 3}), "Upsample": frozenset({1}),
    "ConstantOfShape": frozenset({0}), "Range": frozenset({0, 1, 2}),
    "Clip": frozenset({1, 2}),
    **{f"Reduce{r}": frozenset({1})
       for r in ("Mean", "Sum", "Max", "Min", "Prod")},
}

TORCH_DTYPES = {
    "float32": torch.float32, "uint8": torch.uint8, "int8": torch.int8,
    "uint16": torch.uint16, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool, "float16": torch.float16,
    "float64": torch.float64, "uint32": torch.uint32, "uint64": torch.uint64,
}


def register(name: str):
    def deco(fn):
        REGISTRY[name] = fn
        return fn

    return deco


def _ints(v) -> list[int]:
    """A parameter input (host array, tensor, list or scalar) -> ints."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return [int(i) for i in np.asarray(v).reshape(-1)]


def _floats(v) -> list[float]:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return [float(i) for i in np.asarray(v).reshape(-1)]


def _opt(inputs, i):
    """Input ``i`` or None when omitted (absent or named '')."""
    return inputs[i] if len(inputs) > i else None


def _tuple(v, n: int):
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _same_pads(size: int, k: int, stride: int, dilation: int,
               lower: bool) -> tuple[int, int]:
    """auto_pad SAME: the output ceil(size / stride), the odd pixel after
    (SAME_UPPER, XLA's SAME) or before (SAME_LOWER)."""
    k_eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    small = total // 2
    return (total - small, small) if lower else (small, total - small)


def _spatial_pads(node: Node, x: torch.Tensor, kernel, strides, dilations):
    """((lo, hi), ...) per spatial axis from auto_pad / pads."""
    spatial = x.ndim - 2
    auto = node.attr("auto_pad", "NOTSET")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        return [_same_pads(x.shape[2 + i], kernel[i], strides[i],
                           dilations[i], auto == "SAME_LOWER")
                for i in range(spatial)]
    pads = node.attr("pads")
    if pads is None:
        return [(0, 0)] * spatial
    return [(pads[i], pads[i + spatial]) for i in range(spatial)]


def _torch_pad(pads) -> list[int]:
    """[(lo, hi) per axis, first axis first] -> F.pad's reversed list."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


# ---------------------------------------------------------------------------
# Elementwise / activation
# ---------------------------------------------------------------------------

for _name, _fn in {
    "Relu": torch.relu,
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
    "Exp": torch.exp,
    "Log": torch.log,
    "Sqrt": torch.sqrt,
    "Abs": torch.abs,
    "Neg": torch.neg,
    "Floor": torch.floor,
    "Ceil": torch.ceil,
    "Round": torch.round,  # half to even, as jnp.round
    "Erf": torch.erf,
    "Softplus": F.softplus,
    "Identity": lambda x: x,
    "Not": torch.logical_not,
    "Sin": torch.sin,
    "Cos": torch.cos,
}.items():
    REGISTRY[_name] = lambda node, inputs, f=_fn: (f(inputs[0]),)


@register("LeakyRelu")
def _leaky_relu(node, inputs):
    x = inputs[0]
    return (torch.where(x >= 0, x, node.attr("alpha", 0.01) * x),)


@register("Elu")
def _elu(node, inputs):
    x = inputs[0]
    alpha = node.attr("alpha", 1.0)
    return (torch.where(x >= 0, x, alpha * (torch.exp(x) - 1)),)


@register("HardSigmoid")
def _hard_sigmoid(node, inputs):
    alpha = node.attr("alpha", 0.2)
    beta = node.attr("beta", 0.5)
    return (torch.clamp(alpha * inputs[0] + beta, 0, 1),)


@register("PRelu")
def _prelu(node, inputs):
    x, slope = inputs
    return (torch.where(x >= 0, x, slope * x),)


@register("Clip")
def _clip(node, inputs):
    x = inputs[0]
    lo, hi = _opt(inputs, 1), _opt(inputs, 2)
    lo = _floats(lo)[0] if lo is not None else node.attr("min")
    hi = _floats(hi)[0] if hi is not None else node.attr("max")
    if lo is not None:
        x = torch.clamp(x, min=lo)
    if hi is not None:
        x = torch.clamp(x, max=hi)
    return (x,)


@register("Softmax")
def _softmax(node, inputs):
    return (torch.softmax(inputs[0], dim=node.attr("axis", -1)),)


@register("LogSoftmax")
def _log_softmax(node, inputs):
    return (torch.log_softmax(inputs[0], dim=node.attr("axis", -1)),)


def _div(a, b):
    """ONNX Div: integer operands divide truncating toward zero."""
    if a.is_floating_point() or b.is_floating_point():
        return torch.div(a, b)
    return torch.div(a, b, rounding_mode="trunc")


def _variadic(fn):
    return lambda *xs: functools.reduce(fn, xs)


for _name, _fn in {
    "Add": torch.add,
    "Sub": torch.sub,
    "Mul": torch.mul,
    "Div": _div,
    "Pow": torch.pow,
    "Min": _variadic(torch.minimum),
    "Max": _variadic(torch.maximum),
    "Equal": torch.eq,
    "Greater": torch.gt,
    "GreaterOrEqual": torch.ge,
    "Less": torch.lt,
    "LessOrEqual": torch.le,
    "And": torch.logical_and,
    "Or": torch.logical_or,
}.items():
    REGISTRY[_name] = lambda node, inputs, f=_fn: (f(*inputs),)


@register("Mod")
def _mod(node, inputs):
    fn = torch.fmod if node.attr("fmod", 0) else torch.remainder
    return (fn(inputs[0], inputs[1]),)


@register("Where")
def _where(node, inputs):
    return (torch.where(inputs[0].bool(), inputs[1], inputs[2]),)


# ---------------------------------------------------------------------------
# Shape plumbing
# ---------------------------------------------------------------------------

@register("Shape")
def _shape(node, inputs):
    shape = list(inputs[0].shape)
    start, end = node.attr("start", 0), node.attr("end")
    shape = shape[start:end] if end is not None else shape[start:]
    return (np.asarray(shape, dtype=np.int64),)


@register("Size")
def _size(node, inputs):
    return (np.asarray(int(np.prod(inputs[0].shape)), dtype=np.int64),)


@register("Reshape")
def _reshape(node, inputs):
    x = inputs[0]
    shape = _ints(inputs[1])
    if node.attr("allowzero", 0) == 0:  # 0 copies the input's dim
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return (x.reshape(shape),)


@register("Transpose")
def _transpose(node, inputs):
    x = inputs[0]
    perm = node.attr("perm")
    if perm is None:
        perm = list(reversed(range(x.ndim)))
    return (x.permute(*perm),)


def _axes(node, inputs):
    v = _opt(inputs, 1)
    return _ints(v) if v is not None else node.attr("axes")


@register("Squeeze")
def _squeeze(node, inputs):
    x = inputs[0]
    axes = _axes(node, inputs)
    if axes is None:
        axes = [i for i, d in enumerate(x.shape) if d == 1]
    keep = [d for i, d in enumerate(x.shape)
            if i not in {a % x.ndim for a in axes}]
    return (x.reshape(keep),)


@register("Unsqueeze")
def _unsqueeze(node, inputs):
    x = inputs[0]
    axes = _axes(node, inputs)
    rank = x.ndim + len(axes)
    for a in sorted(a % rank for a in axes):
        x = x.unsqueeze(a)
    return (x,)


@register("SpaceToDepth")
def _space_to_depth(node, inputs):
    """ONNX order: output channel (bi * k + bj) * C + c."""
    k = int(node.attr("blocksize"))
    x = inputs[0]
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // k, k, w // k, k).permute(0, 3, 5, 1, 2, 4)
    return (x.reshape(n, c * k * k, h // k, w // k),)


@register("DepthToSpace")
def _depth_to_space(node, inputs):
    k = int(node.attr("blocksize"))
    x = inputs[0]
    n, c, h, w = x.shape
    if node.attr("mode", "DCR") == "DCR":
        x = x.reshape(n, k, k, c // (k * k), h, w).permute(0, 3, 4, 1, 5, 2)
    else:  # CRD, torch pixel_shuffle's order
        x = x.reshape(n, c // (k * k), k, k, h, w).permute(0, 1, 4, 2, 5, 3)
    return (x.reshape(n, c // (k * k), h * k, w * k),)


@register("Flatten")
def _flatten(node, inputs):
    x = inputs[0]
    axis = node.attr("axis", 1)
    axis = axis + x.ndim if axis < 0 else axis
    lead = int(np.prod(x.shape[:axis]))
    return (x.reshape(lead, -1),)


@register("Concat")
def _concat(node, inputs):
    return (torch.cat([i for i in inputs if i is not None],
                      dim=node.attr("axis")),)


@register("Split")
def _split(node, inputs):
    x = inputs[0]
    axis = node.attr("axis", 0)
    sizes = _opt(inputs, 1)
    sizes = _ints(sizes) if sizes is not None else node.attr("split")
    if sizes is None:  # equal parts, the last one smaller (opset 18)
        n = len(node.outputs)
        part = -(-x.shape[axis] // n)
        sizes = [part] * (n - 1) + [x.shape[axis] - part * (n - 1)]
    return tuple(torch.split(x, sizes, dim=axis))


@register("Gather")
def _gather(node, inputs):
    x, idx = inputs
    axis = node.attr("axis", 0) % x.ndim
    n = x.shape[axis]
    flat = idx.reshape(-1).long()
    flat = torch.where(flat < 0, flat + n, flat)
    out = torch.index_select(x, axis, flat)
    return (out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                        + tuple(x.shape[axis + 1:])),)


@register("Slice")
def _slice(node, inputs):
    x = inputs[0]
    if len(inputs) > 1:
        starts, ends = _ints(inputs[1]), _ints(inputs[2])
        axes = _opt(inputs, 3)
        axes = _ints(axes) if axes is not None else list(range(len(starts)))
        steps = _opt(inputs, 4)
        steps = _ints(steps) if steps is not None else [1] * len(starts)
    else:
        starts, ends = node.attr("starts"), node.attr("ends")
        axes = node.attr("axes") or list(range(len(starts)))
        steps = [1] * len(starts)
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax %= x.ndim
        start, stop, step = slice(st, en, sp).indices(x.shape[ax])
        if step > 0:
            idx = [slice(None)] * x.ndim
            idx[ax] = slice(start, stop, step)
            x = x[tuple(idx)]
        else:  # torch slices forward only
            keep = torch.arange(start, stop, step, device=x.device)
            x = torch.index_select(x, ax, keep)
    return (x,)


@register("Expand")
def _expand(node, inputs):
    x = inputs[0]
    target = torch.broadcast_shapes(tuple(x.shape), tuple(_ints(inputs[1])))
    return (x.expand(target),)


@register("Tile")
def _tile(node, inputs):
    return (inputs[0].repeat(*_ints(inputs[1])),)


@register("Cast")
def _cast(node, inputs):
    return (inputs[0].to(TORCH_DTYPES[TENSOR_DTYPES[node.attr("to")]]),)


@register("Constant")
def _constant(node, inputs):
    for key, dtype in (("value", None), ("value_float", np.float32),
                       ("value_int", np.int64), ("value_floats", np.float32),
                       ("value_ints", np.int64)):
        v = node.attr(key)
        if v is not None:
            return (np.array(v, dtype=dtype),)
    raise ValueError(f"Constant node {node.name} has no value")


@register("ConstantOfShape")
def _constant_of_shape(node, inputs):
    value = node.attr("value")
    fill = value.ravel()[0] if value is not None else np.float32(0)
    return (np.full(_ints(inputs[0]), fill),)


@register("Range")
def _range(node, inputs):
    """The output keeps the start's dtype."""
    dtype = np.asarray(inputs[0]).dtype
    start, limit, delta = (np.asarray(v).item() for v in inputs)
    return (np.arange(start, limit, delta).astype(dtype),)


def _pad_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """Source index of each padded position along one axis."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)  # reflect without repeating the edge pixel
    i = torch.remainder(i, period) if period else torch.zeros_like(i)
    return torch.where(i >= n, period - i, i)


@register("Pad")
def _pad(node, inputs):
    x = inputs[0]
    if len(inputs) > 1 and inputs[1] is not None:
        pads = _ints(inputs[1])
        cval = _opt(inputs, 2)
        cval = _floats(cval)[0] if cval is not None else 0.0
        axes = _opt(inputs, 3)
    else:
        pads, cval, axes = node.attr("pads"), node.attr("value", 0.0), None
    rank = x.ndim
    axes = [a % rank for a in _ints(axes)] if axes is not None \
        else list(range(rank))
    per_axis = [(0, 0)] * rank
    for j, a in enumerate(axes):
        per_axis[a] = (pads[j], pads[j + len(axes)])
    mode = node.attr("mode", "constant")
    if mode == "constant":
        return (F.pad(x, _torch_pad(per_axis), value=cval),)
    if mode not in ("reflect", "edge"):
        raise NotImplementedError(f"Pad mode {mode!r}")
    for a, (lo, hi) in enumerate(per_axis):
        if lo or hi:
            x = torch.index_select(
                x, a, _pad_index(x.shape[a], lo, hi, mode, x.device))
    return (x,)


# ---------------------------------------------------------------------------
# Reductions / linear algebra
# ---------------------------------------------------------------------------

def _reduce(fn):
    def run(node, inputs):
        x = inputs[0]
        axes = node.attr("axes")
        if axes is None and _opt(inputs, 1) is not None:
            axes = _ints(inputs[1])
        keep = bool(node.attr("keepdims", 1))
        if not axes:
            if node.attr("noop_with_empty_axes", 0):
                return (x,)
            axes = list(range(x.ndim))
        return (fn(x, sorted(a % x.ndim for a in axes), keep),)

    return run


def _prod(x, axes, keep):
    for a in reversed(axes):
        x = torch.prod(x, dim=a, keepdim=keep)
    return x


REGISTRY["ReduceMean"] = _reduce(lambda x, a, k: x.mean(dim=a, keepdim=k))
REGISTRY["ReduceSum"] = _reduce(lambda x, a, k: x.sum(dim=a, keepdim=k))
REGISTRY["ReduceMax"] = _reduce(lambda x, a, k: x.amax(dim=a, keepdim=k))
REGISTRY["ReduceMin"] = _reduce(lambda x, a, k: x.amin(dim=a, keepdim=k))
REGISTRY["ReduceProd"] = _reduce(_prod)


@register("ArgMax")
def _argmax(node, inputs):
    out = torch.argmax(inputs[0], dim=node.attr("axis", 0),
                       keepdim=bool(node.attr("keepdims", 1)))
    return (out.to(torch.int64),)


@register("MatMul")
def _matmul(node, inputs):
    return (torch.matmul(inputs[0], inputs[1]),)


@register("Gemm")
def _gemm(node, inputs):
    a, b = inputs[0], inputs[1]
    if node.attr("transA", 0):
        a = a.T
    if node.attr("transB", 0):
        b = b.T
    out = node.attr("alpha", 1.0) * (a @ b)
    c = _opt(inputs, 2)
    if c is not None:
        out = out + node.attr("beta", 1.0) * c
    return (out,)


@register("Einsum")
def _einsum(node, inputs):
    return (torch.einsum(node.attr("equation"), *inputs),)


# ---------------------------------------------------------------------------
# Convolution / pooling / normalization (NCHW as ONNX defines)
# ---------------------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _bias_shape(spatial: int):
    return (1, -1) + (1,) * spatial


@register("Conv")
def _conv(node, inputs):
    x, w, b = inputs[0], inputs[1], _opt(inputs, 2)
    spatial = x.ndim - 2
    strides = _tuple(node.attr("strides"), spatial)
    dilations = _tuple(node.attr("dilations"), spatial)
    pads = _spatial_pads(node, x, w.shape[2:], strides, dilations)
    if all(lo == hi for lo, hi in pads):
        padding = tuple(lo for lo, _ in pads)
    else:
        x, padding = F.pad(x, _torch_pad(pads)), 0
    out = _CONV[spatial](x, w, b, stride=strides, padding=padding,
                         dilation=dilations, groups=node.attr("group", 1))
    return (out,)


@register("ConvTranspose")
def _conv_transpose(node, inputs):
    x, w, b = inputs[0], inputs[1], _opt(inputs, 2)
    spatial = x.ndim - 2
    if node.attr("group", 1) != 1:
        raise NotImplementedError("grouped ConvTranspose")
    strides = _tuple(node.attr("strides"), spatial)
    dilations = _tuple(node.attr("dilations"), spatial)
    pads = node.attr("pads") or [0] * (2 * spatial)
    extra = _tuple(node.attr("output_padding", 0), spatial)
    # the unpadded transposed convolution, output_padding zeros at the
    # end, then the pads cropped; the bias after (it covers every output)
    out = _CONV_T[spatial](x, w, None, stride=strides, dilation=dilations)
    out = F.pad(out, _torch_pad([(0, e) for e in extra]))
    idx = [slice(None), slice(None)]
    for i in range(spatial):
        idx.append(slice(pads[i], out.shape[2 + i] - pads[i + spatial]))
    out = out[tuple(idx)]
    if b is not None:
        out = out + b.reshape(_bias_shape(spatial))
    return (out,)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_pads(node: Node, x: torch.Tensor, kernel, strides):
    """Per-axis (lo, hi) pads of a pool: auto_pad SAME (upper, as XLA's
    SAME for both spellings, as the JAX lowering has it), else the pads
    attribute extended on the high side under ceil_mode until the last
    window is whole (ops.py:550-561)."""
    spatial = x.ndim - 2
    if node.attr("auto_pad", "NOTSET") in ("SAME_UPPER", "SAME_LOWER"):
        return [_same_pads(x.shape[2 + i], kernel[i], strides[i], 1, False)
                for i in range(spatial)]
    pads = _spatial_pads(node, x, kernel, strides, (1,) * spatial)
    if node.attr("ceil_mode", 0):
        for i, (lo, hi) in enumerate(pads):
            rem = (x.shape[2 + i] + lo + hi - kernel[i]) % strides[i]
            if rem:
                pads[i] = (lo, hi + strides[i] - rem)
    return pads


def _pool(node, inputs, average: bool):
    x = inputs[0]
    spatial = x.ndim - 2
    kernel = _tuple(node.attr("kernel_shape"), spatial)
    strides = _tuple(node.attr("strides"), spatial)
    pads = _torch_pad(_pool_pads(node, x, kernel, strides))
    if not average:
        xp = F.pad(x, pads, value=float("-inf"))
        return (_MAX_POOL[spatial](xp, kernel, strides),)
    size = math.prod(kernel)
    sums = _AVG_POOL[spatial](F.pad(x, pads), kernel, strides) * size
    if node.attr("count_include_pad", 0):
        return (sums / size,)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    counts = _AVG_POOL[spatial](F.pad(ones, pads), kernel, strides) * size
    return (sums / counts,)


@register("MaxPool")
def _max_pool(node, inputs):
    return _pool(node, inputs, average=False)


@register("AveragePool")
def _avg_pool(node, inputs):
    return _pool(node, inputs, average=True)


@register("GlobalAveragePool")
def _global_avg_pool(node, inputs):
    x = inputs[0]
    return (x.mean(dim=tuple(range(2, x.ndim)), keepdim=True),)


@register("GlobalMaxPool")
def _global_max_pool(node, inputs):
    x = inputs[0]
    return (x.amax(dim=tuple(range(2, x.ndim)), keepdim=True),)


def batch_norm_fold(scale, bias, mean, var, eps: float):
    """BatchNormalization as x * a + b, its statistics folded in float32
    (stable when the graph runs in reduced precision)."""
    f32 = torch.float32
    a = scale.to(f32) / torch.sqrt(var.to(f32) + eps)
    return a, bias.to(f32) - mean.to(f32) * a


@register("BatchNormalization")
def _batch_norm(node, inputs):
    x = inputs[0]
    a, b = batch_norm_fold(*inputs[1:5], node.attr("epsilon", 1e-5))
    return _scale_bias(node, [x, a, b])


@register("_ScaleBias")
def _scale_bias(node, inputs):
    """x * a + b per channel (axis 1), applied in the activation's dtype:
    the executor's load-time form of a BatchNormalization whose
    statistics are constants."""
    x, a, b = inputs
    shape = _bias_shape(x.ndim - 2)
    return (x * a.reshape(shape).to(x.dtype) + b.reshape(shape).to(x.dtype),)


@register("InstanceNormalization")
def _instance_norm(node, inputs):
    x, scale, bias = inputs
    eps = node.attr("epsilon", 1e-5)
    axes = tuple(range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    shape = _bias_shape(x.ndim - 2)
    return ((x - mean) / torch.sqrt(var + eps) * scale.reshape(shape)
            + bias.reshape(shape),)


@register("LayerNormalization")
def _layer_norm(node, inputs):
    x, scale, bias = inputs[0], inputs[1], _opt(inputs, 2)
    axis = node.attr("axis", -1) % x.ndim
    eps = node.attr("epsilon", 1e-5)
    axes = tuple(range(axis, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    out = (x - mean) / torch.sqrt(var + eps) * scale
    if bias is not None:
        out = out + bias
    return (out,)


def _q_params(node, inputs, rank: int):
    """(scale, zero_point) reshaped onto the quantization axis (default 1)
    when per channel; scalars pass through."""
    scale, zp = inputs[1], _opt(inputs, 2)
    if scale.ndim >= 1 and scale.numel() > 1:
        shape = [1] * rank
        shape[int(node.attr("axis", 1)) % rank] = -1
        scale = scale.reshape(shape)
        if zp is not None:
            zp = zp.reshape(shape)
    return scale, zp


@register("DequantizeLinear")
def _dequantize_linear(node, inputs):
    """y = (x - zero_point) * scale, in float32."""
    x = inputs[0]
    scale, zp = _q_params(node, inputs, max(x.ndim, 1))
    xf = x.to(torch.float32)
    if zp is not None:
        xf = xf - zp.to(torch.float32)
    return (xf * scale.to(torch.float32),)


@register("QuantizeLinear")
def _quantize_linear(node, inputs):
    """y = saturate(round(x / scale) + zero_point): rounding half to even,
    the range of the zero point's dtype (uint8 without one)."""
    x = inputs[0]
    scale, zp = _q_params(node, inputs, max(x.ndim, 1))
    y = torch.round(x / scale.to(torch.float32))
    out_dtype = zp.dtype if zp is not None else torch.uint8
    if zp is not None:
        y = y + zp.to(torch.float32)
    info = torch.iinfo(out_dtype)
    return (torch.clamp(y, info.min, info.max).to(out_dtype),)


@register("Dropout")
def _dropout(node, inputs):
    return (inputs[0],)


# -- Resize / Upsample as jax.image.resize ----------------------------------

def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x)).astype(np.float32)


@functools.lru_cache(maxsize=128)
def resize_weights(m: int, n: int, method: str) -> np.ndarray:
    """The (m, n) float32 matrix taking an axis of m samples to n, as
    jax.image.resize's compute_weight_mat builds it (antialias on):
    half-pixel centres, the kernel widened by 1 / scale when downscaling,
    each column normalised to sum 1, columns sampling outside the input
    zero."""
    kernel = _triangle if method == "linear" else _keys_cubic
    f32 = np.float32
    inv_scale = f32(1.0 / (n / m))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None])
    w = kernel(x / kernel_scale)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def jax_resize(x: torch.Tensor, sizes, mode: str) -> torch.Tensor:
    """``jax.image.resize(x, sizes, method)`` for method nearest, linear
    (bilinear) or cubic (bicubic), antialiased, every axis whose size
    changes resampled."""
    for d, n in enumerate(sizes):
        m = x.shape[d]
        if m == n:
            continue
        if mode == "nearest":
            src = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5))
                           * np.float32(m) / np.float32(n)).astype(np.int64)
            x = torch.index_select(x, d, torch.from_numpy(src).to(x.device))
            continue
        w = torch.from_numpy(resize_weights(m, n, mode)).to(x.device, x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x


_RESIZE_MODES = {"nearest": "nearest", "linear": "linear", "cubic": "cubic"}


@register("Resize")
def _resize(node, inputs):
    x = inputs[0]
    mode = node.attr("mode", "nearest")
    if mode not in _RESIZE_MODES:
        raise NotImplementedError(f"Resize mode {mode!r}")
    sizes = _opt(inputs, 3)
    scales = _opt(inputs, 2) if len(inputs) > 2 else _opt(inputs, 1)
    if sizes is not None and np.size(np.asarray(sizes)):
        sizes = _ints(sizes)
    elif scales is not None and np.size(np.asarray(scales)):
        sizes = [int(d * s) for d, s in zip(x.shape, _floats(scales))]
    else:
        raise ValueError("Resize without sizes/scales")
    return (jax_resize(x, sizes, mode),)


@register("Upsample")
def _upsample(node, inputs):
    x = inputs[0]
    scales = _floats(inputs[1]) if len(inputs) > 1 \
        else [float(s) for s in node.attr("scales")]
    mode = node.attr("mode", "nearest")
    if mode not in ("nearest", "linear"):
        raise NotImplementedError(f"Upsample mode {mode!r}")
    return (jax_resize(x, [int(d * s) for d, s in zip(x.shape, scales)],
                       mode),)


# ---------------------------------------------------------------------------
# Recurrent (CRNN)
# ---------------------------------------------------------------------------

def check_rnn(node, inputs, state_inputs: int):
    """Refuse what the lowering does not compute: sequence lengths,
    peepholes, clipping, batch-first layout, other activations."""
    if _opt(inputs, 4) is not None:
        raise NotImplementedError(f"{node.op_type} with sequence_lens")
    if len(inputs) > 5 + state_inputs and inputs[5 + state_inputs] \
            is not None:
        raise NotImplementedError(f"{node.op_type} with peepholes")
    for key in ("clip", "activations"):
        if node.attr(key) is not None:
            raise NotImplementedError(f"{node.op_type} with {key}")
    if node.attr("layout", 0):
        raise NotImplementedError(f"{node.op_type} with layout=1")


def _gate_blocks(w: torch.Tensor, order, gates: int) -> torch.Tensor:
    parts = torch.chunk(w, gates, dim=1)
    return torch.cat([parts[i] for i in order], dim=1)


def torch_gate_order(w, r, b, order, gates: int):
    """An ONNX recurrence's W (D, gates * H, I), R (D, gates * H, H) and
    B (D, 2 * gates * H) with their gate blocks in ``order``; B's input
    and hidden halves each."""
    w, r = _gate_blocks(w, order, gates), _gate_blocks(r, order, gates)
    if b is not None:
        b = torch.cat([_gate_blocks(half, order, gates)
                       for half in torch.chunk(b, 2, dim=1)], dim=1)
    return w, r, b


# ONNX gate order -> torch's
GRU_ORDER = (1, 0, 2)  # z, r, h -> r, z, n
LSTM_ORDER = (0, 2, 3, 1)  # i, o, f, c -> i, f, g, o


def _torch_rnn(kind: str, node, x, w, r, b, states):
    """torch.gru / torch.lstm over weights already in torch's gate order;
    returns the ONNX outputs (Y (T, D, B, H), Y_h, [Y_c])."""
    hidden = node.attr("hidden_size")
    direction = node.attr("direction", "forward")
    dirs = w.shape[0]
    gates = 3 if kind == "gru" else 4
    seq, batch = x.shape[0], x.shape[1]
    if b is None:
        b = torch.zeros((dirs, 2 * gates * hidden), dtype=x.dtype,
                        device=x.device)
    params = []
    for d in range(dirs):
        params += [w[d], r[d], b[d, : gates * hidden], b[d, gates * hidden:]]
    zeros = torch.zeros((dirs, batch, hidden), dtype=x.dtype,
                        device=x.device)
    h0 = states[0] if states[0] is not None else zeros
    xs = x.flip(0) if direction == "reverse" else x
    if kind == "gru":
        y, hn = torch.gru(xs, h0.contiguous(), params, True, 1, 0.0, False,
                          dirs == 2, False)
        extra = ()
    else:
        c0 = states[1] if states[1] is not None else zeros
        y, hn, cn = torch.lstm(xs, (h0.contiguous(), c0.contiguous()),
                               params, True, 1, 0.0, False, dirs == 2, False)
        extra = (cn,)
    if direction == "reverse":
        y = y.flip(0)
    y = y.reshape(seq, batch, dirs, hidden).permute(0, 2, 1, 3)
    return (y, hn) + extra


def _gru_steps(node, x, w, r, b, h0):
    """GRU with linear_before_reset=0 (reset before the hidden matmul),
    one step at a time in ONNX's z, r, h gate order."""
    hidden = node.attr("hidden_size")
    direction = node.attr("direction", "forward")
    seq, batch = x.shape[0], x.shape[1]
    ys, hs = [], []
    for d in range(w.shape[0]):
        wz, wr, wh = torch.chunk(w[d], 3)
        rz, rr, rh = torch.chunk(r[d], 3)
        bd = b[d] if b is not None else torch.zeros(
            6 * hidden, dtype=x.dtype, device=x.device)
        wbz, wbr, wbh, rbz, rbr, rbh = torch.chunk(bd, 6)
        h = h0[d] if h0 is not None else torch.zeros(
            (batch, hidden), dtype=x.dtype, device=x.device)
        reverse = d == 1 or direction == "reverse"
        out = [None] * seq
        for t in (range(seq - 1, -1, -1) if reverse else range(seq)):
            xt = x[t]
            z = torch.sigmoid(xt @ wz.T + wbz + h @ rz.T + rbz)
            rg = torch.sigmoid(xt @ wr.T + wbr + h @ rr.T + rbr)
            hh = torch.tanh(xt @ wh.T + wbh + (rg * h) @ rh.T + rbh)
            h = (1 - z) * hh + z * h
            out[t] = h
        ys.append(torch.stack(out))
        hs.append(h)
    return torch.stack(ys, dim=1), torch.stack(hs)


@register("GRU")
def _gru(node, inputs):
    check_rnn(node, inputs, 1)
    x, w, r, b, h0 = (inputs[0], inputs[1], inputs[2], _opt(inputs, 3),
                      _opt(inputs, 5))
    if not node.attr("linear_before_reset", 0):
        return _gru_steps(node, x, w, r, b, h0)
    return _torch_rnn("gru", node, x,
                      *torch_gate_order(w, r, b, GRU_ORDER, 3), (h0,))


@register("_TorchGRU")
def _torch_gru(node, inputs):
    """GRU (linear_before_reset=1) whose constant weights the executor put
    in torch's gate order at load time."""
    return _torch_rnn("gru", node, inputs[0], inputs[1], inputs[2],
                      _opt(inputs, 3), (_opt(inputs, 5),))


@register("LSTM")
def _lstm(node, inputs):
    check_rnn(node, inputs, 2)
    x, w, r, b = inputs[0], inputs[1], inputs[2], _opt(inputs, 3)
    return _torch_rnn("lstm", node, x,
                      *torch_gate_order(w, r, b, LSTM_ORDER, 4),
                      (_opt(inputs, 5), _opt(inputs, 6)))


@register("_TorchLSTM")
def _torch_lstm(node, inputs):
    """LSTM whose constant weights the executor put in torch's gate order
    at load time."""
    return _torch_rnn("lstm", node, inputs[0], inputs[1], inputs[2],
                      _opt(inputs, 3), (_opt(inputs, 5), _opt(inputs, 6)))
