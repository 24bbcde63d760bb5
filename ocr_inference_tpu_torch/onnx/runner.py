"""ONNX graph executor: the graph's nodes evaluated in order through torch.

Counterpart of ocr_inference_tpu/onnx/runner.py. Together with ``wire``
(parser) and ``ops`` (lowerings) it takes the place of the reference's
onnxruntime sessions (reference: BDRC/inference.py:128, 294): a ``.onnx``
file loads directly and runs on the card as torch ops (cuDNN convolutions
and RNNs, cuBLAS matmuls).

Values live in two places:

- on the host, as numpy arrays: integer initializers and those of at most
  16 elements (runner.py:56-62), and everything computed from them and
  from input shapes alone (the Shape/Gather/Concat chains exporters
  emit);
- on the device, as tensors: the float weights, moved once at load, and
  everything computed from the graph's inputs.

At load time every node whose inputs are all constants (host constants or
weights) is evaluated once and dropped, so constant shape chains,
weight-routing Identity/Transpose nodes and the like are gone before the
first call. A BatchNormalization whose statistics are constants becomes
one per-channel scale and bias, folded in float32 (``_ScaleBias``); a GRU
(``linear_before_reset=1``) or LSTM with constant weights gets them in
torch's gate order once (``_TorchGRU``/``_TorchLSTM``). At call time the
host values that depend on the input shapes only are computed the first
time a set of input shapes is seen and reused after that.

``dtype`` (or ``OCR_ONNX_BF16=1``) runs the graph in reduced precision:
every float initializer and float constant is cast to it, and so is every
Cast to a float type, so that the activations stay in it; the module's
outputs come back float32 (runner.py:45-55, 210).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ocr_inference_tpu_torch.device import resolve_device
from ocr_inference_tpu_torch.onnx import ops as onnx_ops
from ocr_inference_tpu_torch.onnx.wire import Graph, Model, Node, load_model

_SHAPE_ONLY = ("Shape", "Size")  # read an input's shape, never its values
_FLOAT_CASTS = (1, 10, 11, 16)  # TensorProto float32, float16, float64, bf16
_SHAPE_CACHE = 64  # input-shape sets whose host values are kept


def _is_host_const(arr: np.ndarray) -> bool:
    return np.issubdtype(arr.dtype, np.integer) or arr.size <= 16


class _Step:
    __slots__ = ("index", "node", "fn", "params")

    def __init__(self, index: int, node: Node):
        self.index = index
        self.node = node
        self.fn = onnx_ops.REGISTRY[node.op_type]
        self.params = onnx_ops.PARAMS.get(node.op_type, frozenset())


class OnnxGraphFunction:
    """A callable ``(weights, *inputs) -> outputs`` over an ONNX graph, on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, model: Model,
                 input_names: Optional[Sequence[str]] = None,
                 output_names: Optional[Sequence[str]] = None,
                 dtype: Optional[torch.dtype] = None,
                 device: str | torch.device | None = None):
        self.model = model
        self.graph: Graph = model.graph
        self.dtype = dtype
        self.device = resolve_device(device)
        missing = [n.op_type for n in self.graph.nodes
                   if n.op_type not in onnx_ops.REGISTRY]
        if missing:
            raise NotImplementedError(
                f"unsupported ONNX ops: {sorted(set(missing))}")
        # pre-IR4 exporters list every initializer as a graph input too;
        # anything with an initializer is a weight or constant, never a feed
        self.input_names = list(input_names or [
            vi.name for vi in self.graph.inputs
            if vi.name not in self.graph.initializers])
        self.output_names = list(
            output_names or [vi.name for vi in self.graph.outputs])
        self.const_weights: dict[str, np.ndarray] = {}
        self.weights: dict[str, torch.Tensor] = {}
        for name, t in self.graph.initializers.items():
            arr = np.array(t.to_numpy())
            if _is_host_const(arr):
                self.const_weights[name] = arr
            else:
                self.weights[name] = self._tensor(arr, self.device)
        nodes = self._fold([n for n in self.graph.nodes])
        self._steps = [_Step(i, self._rewrite(n)) for i, n in enumerate(nodes)]
        # host constants that runtime nodes take as data, on the device once
        self._device_consts: dict[str, torch.Tensor] = {}
        for step in self._steps:
            for pos, name in enumerate(step.node.inputs):
                if (name in self.const_weights and pos not in step.params
                        and name not in self._device_consts):
                    self._device_consts[name] = self._tensor(
                        self.const_weights[name], self.device)
        self._shape_cache: OrderedDict = OrderedDict()
        self.steps_run = 0  # nodes evaluated by the last call

    # -- load time --

    def _tensor(self, arr: np.ndarray, device: torch.device) -> torch.Tensor:
        """A host array as a tensor on ``device``; floats in the compute
        dtype when one is set."""
        t = torch.from_numpy(np.array(arr, copy=True)).to(device)
        if self.dtype is not None and t.is_floating_point():
            t = t.to(self.dtype)
        return t

    def _known(self, name: str) -> bool:
        return (not name or name in self.const_weights
                or name in self.weights)

    def _fold(self, nodes: list[Node]) -> list[Node]:
        """Evaluate every node whose inputs are all constants now; return
        the nodes left."""
        kept = []
        for node in nodes:
            if node.op_type.startswith("_") or not all(
                    self._known(i) for i in node.inputs):
                kept.append(node)
                continue
            values = [self.const_weights[i] if i in self.const_weights
                      else self.weights.get(i) for i in node.inputs]
            outs = self._eval(_Step(-1, node), values, {})
            for name, value in zip(node.outputs, outs):
                if not name:
                    continue
                if isinstance(value, np.ndarray):
                    self.const_weights[name] = value
                else:
                    self.weights[name] = value
        return kept

    def _const(self, name: str):
        """A load-time value as a tensor on the device, or None."""
        if not name:
            return None
        if name in self.weights:
            return self.weights[name]
        if name in self.const_weights:
            return self._tensor(self.const_weights[name], self.device)
        return None

    def _rewrite(self, node: Node) -> Node:
        """Load-time forms of BatchNormalization with constant statistics
        and of GRU/LSTM with constant weights (see the module docstring)."""
        op = node.op_type
        if op == "BatchNormalization" and all(
                self._known(i) for i in node.inputs[1:5]):
            stats = [self._const(i) for i in node.inputs[1:5]]
            a, b = onnx_ops.batch_norm_fold(*stats,
                                            node.attr("epsilon", 1e-5))
            names = [f"{node.outputs[0]}::{k}" for k in ("scale", "bias")]
            for name, t in zip(names, (a, b)):  # the graph's float type
                self.weights[name] = t.to(self.dtype or stats[0].dtype)
            return Node("_ScaleBias", node.name, node.domain,
                        [node.inputs[0], *names], node.outputs[:1], {})
        rnn = {"GRU": ("_TorchGRU", onnx_ops.GRU_ORDER, 3, 1),
               "LSTM": ("_TorchLSTM", onnx_ops.LSTM_ORDER, 4, 2)}.get(op)
        if rnn is None or not all(self._known(i) for i in node.inputs[1:4]):
            return node
        if op == "GRU" and not node.attr("linear_before_reset", 0):
            return node  # the step loop reads ONNX's own gate order
        kind, order, gates, states = rnn
        onnx_ops.check_rnn(node, [i or None for i in node.inputs], states)
        w, r, b = (self._const(i) for i in (node.inputs[1:4] + [""] * 3)[:3])
        inputs = list(node.inputs)
        for pos, t in enumerate(onnx_ops.torch_gate_order(w, r, b, order,
                                                          gates), start=1):
            if t is not None:
                inputs[pos] = f"{node.outputs[0] or node.name}::{kind}{pos}"
                self.weights[inputs[pos]] = t.contiguous()
        return Node(kind, node.name, node.domain, inputs, node.outputs,
                    node.attributes)

    # -- evaluation --

    def _eval(self, step: _Step, values: list, dev_vals: dict):
        """Run one node. With every data input on the host (numpy or
        absent), on the host, returning numpy; otherwise on the device,
        host data inputs moved there first."""
        node = step.node
        host = all(v is None or isinstance(v, np.ndarray) or pos in
                   step.params for pos, v in enumerate(values))
        if host and node.op_type not in _SHAPE_ONLY:
            args = [v if pos in step.params or v is None
                    else torch.from_numpy(np.array(v, copy=True))
                    for pos, v in enumerate(values)]
            outs = step.fn(node, args)
            return tuple(o.numpy() if isinstance(o, torch.Tensor) else o
                         for o in outs)
        args = []
        for pos, (name, v) in enumerate(zip(node.inputs, values)):
            if isinstance(v, np.ndarray) and pos not in step.params:
                t = self._device_consts.get(name)
                if t is None:
                    t = dev_vals.get(name)
                if t is None:
                    t = dev_vals[name] = self._tensor(v, self.device)
                v = t
            args.append(v)
        if self.dtype is not None and node.op_type == "Cast" and \
                node.attr("to") in _FLOAT_CASTS:
            return (args[0].to(self.dtype),)
        return step.fn(node, args)

    @torch.no_grad()
    def __call__(self, weights: dict, *inputs):
        env: dict = dict(self.const_weights)
        env.update(weights)
        for name, value in zip(self.input_names, inputs):
            env[name] = torch.as_tensor(value, device=self.device)
        key = tuple((tuple(env[n].shape), env[n].dtype)
                    for n in self.input_names)
        cached = self._shape_cache.get(key)
        record = cached is None
        if record:
            cached = self._shape_cache[key] = ({}, set(), {})
            if len(self._shape_cache) > _SHAPE_CACHE:
                self._shape_cache.popitem(last=False)
        host_vals, skip, dev_vals = cached
        env.update(host_vals)
        run = 0
        for step in self._steps:
            if step.index in skip:
                continue
            node = step.node
            try:
                values = [env[i] if i else None for i in node.inputs]
            except KeyError as e:
                raise KeyError(
                    f"node {node.op_type}:{node.name} missing input {e}"
                ) from None
            outs = self._eval(step, values, dev_vals)
            run += 1
            for out_name, out_val in zip(node.outputs, outs):
                if out_name:
                    env[out_name] = out_val
            if record and all(isinstance(o, np.ndarray) for o in outs) and (
                    node.op_type in _SHAPE_ONLY or not any(
                        isinstance(v, torch.Tensor) for v in values)):
                # values before the skip mark: another thread's call may
                # read this entry while it is being recorded
                host_vals.update(zip(node.outputs, outs))
                skip.add(step.index)
        self.steps_run = run
        return tuple(env[n] if isinstance(env[n], torch.Tensor)
                     else torch.as_tensor(env[n], device=self.device)
                     for n in self.output_names)


class OnnxModule(torch.nn.Module):
    """An ONNX graph behind the ``model(x)`` call the port's engines make.

    ``layout``:

    - ``"nchw"``: the segmentation engine's (N, 3, H, W) float tiles in,
      the graph's NCHW logits out, float32;
    - ``"nhwc->nchw"``: the JAX engines' NHWC tiles, transposed for the
      graph and back (runner.py:161-165);
    - ``"line"``: the recognition engine's (B, H, W) canvases in [-1, 1];
      ``swap_hw`` / ``squeeze_channel`` adapt them to the graph's input
      as the reference does (inference.py:407-411, 422-426), and the
      output is normalised to (B, T, V) float32: singleton non-batch axes
      dropped, an unbatched output given its batch axis, a (B, V, T)
      output transposed when ``vocab_size`` says so (runner.py:166-189).
    """

    def __init__(self, fn: OnnxGraphFunction, layout: str = "nchw",
                 swap_hw: bool = False, squeeze_channel: bool = True,
                 vocab_size: Optional[int] = None):
        super().__init__()
        if layout not in ("nchw", "nhwc->nchw", "line"):
            raise ValueError(f"unknown layout {layout}")
        self.fn = fn
        self.layout = layout
        self.swap_hw = swap_hw
        self.squeeze_channel = squeeze_channel
        self.vocab_size = vocab_size

    @property
    def variables(self) -> dict:
        return self.fn.weights

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fn.dtype is not None:
            x = x.to(self.fn.dtype)
        if self.layout == "nchw":
            (out,) = self.fn(self.fn.weights, x)
            return out.float()
        if self.layout == "nhwc->nchw":
            (out,) = self.fn(self.fn.weights, x.permute(0, 3, 1, 2))
            return out.permute(0, 2, 3, 1).float()
        if self.swap_hw:
            x = x.transpose(1, 2)
        if not self.squeeze_channel:
            x = x[:, None]
        (logits,) = self.fn(self.fn.weights, x)
        while logits.ndim > 3:
            extra = [i for i in range(1, logits.ndim) if logits.shape[i] == 1]
            if not extra:
                raise ValueError("cannot normalize recognizer output "
                                 f"{tuple(logits.shape)}")
            logits = logits.squeeze(extra[0])
        if logits.ndim == 2:  # one unbatched example
            logits = logits[None]
        if (self.vocab_size is not None and logits.shape[-1] != self.vocab_size
                and logits.shape[1] == self.vocab_size):
            logits = logits.transpose(1, 2)
        return logits.float()


def load_onnx_module(
    path: str | Path,
    layout: str = "nchw",
    input_layer: Optional[str] = None,
    output_layer: Optional[str] = None,
    swap_hw: bool = False,
    squeeze_channel: bool = True,
    vocab_size: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    device: str | torch.device | None = None,
) -> OnnxModule:
    """Load an ``.onnx`` file into an engine-pluggable module on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for). The graph runs in
    float32 unless ``dtype`` is given or ``OCR_ONNX_BF16=1`` is set
    (then bfloat16); outputs are float32 either way."""
    if dtype is None and os.environ.get("OCR_ONNX_BF16", "0") == "1":
        dtype = torch.bfloat16
    fn = OnnxGraphFunction(
        load_model(path),
        input_names=[input_layer] if input_layer else None,
        output_names=[output_layer] if output_layer else None,
        dtype=dtype, device=device)
    return OnnxModule(fn, layout=layout, swap_hw=swap_hw,
                      squeeze_channel=squeeze_channel, vocab_size=vocab_size)
