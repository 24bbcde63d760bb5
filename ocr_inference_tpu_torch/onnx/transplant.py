"""ONNX -> port weight transplant with per-layer verification.

Counterpart of ocr_inference_tpu/onnx/transplant.py on the port's modules.
The executor (onnx/runner.py) runs a published ``.onnx`` checkpoint as a
graph; this module takes the second, independent path: it imports the
checkpoint's WEIGHTS into the port's own module of the same architecture,
as the Flax-named variable tree ``models/params.py load_flax_tree`` reads,
so the same parameters run through both implementations and per-layer
diffs between the two cross-validate executor and module.

Matching: the graph's weighted ops in node order (exporters emit
topologically, tracing the forward) against the module's weighted layers
in execution order, recorded with forward hooks on a real forward pass
(the JAX package uses ``nn.intercept_methods``). The tree starts from
``flax_variables(module)`` and takes every matched value; the exporter
idioms handled are those of the JAX transplant (:1-24, :417-638):

- Conv kernels OIHW/OIW -> HWIO/WIO; a tf2onnx 1-D conv run as 2-D;
- BatchNorm folded into the conv's bias (torch eval-mode export): the
  BatchNorm becomes an exact identity with a bias (mean 0, var 1 - eps so
  the denominator is exactly 1, scale 1, bias = the folded bias);
- a standalone BatchNormalization: its variance shifted by
  eps_onnx - eps_flax, so both normalizations agree exactly; a keras /
  tf2onnx Mul+Add decomposition becomes the same identity-with-bias form;
- Gemm transB and MatMul+Add pairs -> Dense kernels (in, out), reshaped
  onto DenseGeneral's (C, heads, d) attention kernels;
- a GRU node's directions split into the GRUCells' six gates (ONNX
  z|r|h), Wb + Rb folded into the input-side r and z biases;
- LayerNorm, whose epsilon must already agree.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from torch import nn

from ocr_inference_tpu_torch.models.params import flax_variables
from ocr_inference_tpu_torch.onnx import wire


# ---------------------------------------------------------------------------
# ONNX side: weighted ops in graph order
# ---------------------------------------------------------------------------

@dataclass
class WeightedOp:
    kind: str  # "conv" | "bn" | "dense" | "gru"
    node: wire.Node
    kernel: Optional[np.ndarray] = None
    bias: Optional[np.ndarray] = None
    scale: Optional[np.ndarray] = None
    mean: Optional[np.ndarray] = None
    var: Optional[np.ndarray] = None
    epsilon: float = 1e-5
    trans_b: bool = False
    output: str = ""
    # graph-side tensor names feeding this op (as written in node.inputs;
    # may be Identity/Transpose-routed — retroplant resolves them back to
    # the underlying initializers)
    input_names: dict = field(default_factory=dict)
    # gru: recurrent kernel R (num_dirs, 3H, H); kernel holds W
    # (num_dirs, 3H, I), bias holds B (num_dirs, 6H)
    rec_kernel: Optional[np.ndarray] = None
    num_dirs: int = 1
    linear_before_reset: bool = False
    # bn synthesized from a keras/tf2onnx-style Mul+Add decomposition; the
    # graph holds folded per-channel constants, not the four BN statistics.
    # const_shapes records the on-wire constant shapes (e.g. (C, 1) or
    # (1, C, 1, 1)) so retroplant can write back in the exporter's layout.
    decomposed: bool = False
    const_shapes: dict = field(default_factory=dict)


def onnx_weighted_ops(model: wire.Model) -> list[WeightedOp]:
    """Conv / BatchNormalization / Gemm / MatMul(+Add) / GRU ops carrying
    weights, in graph node order."""
    graph = model.graph
    inits = {name: t.to_numpy() for name, t in graph.initializers.items()}
    # non-folding exports route weights through Identity/Constant nodes,
    # and Linear-on-3D weights through a Transpose ((out,in) initializer ->
    # MatMul's (in,out) operand) — resolve all three so the weighted-op scan
    # sees the tensor the consuming node actually receives
    for node in graph.nodes:
        if node.op_type == "Identity" and node.inputs[0] in inits:
            inits[node.outputs[0]] = inits[node.inputs[0]]
        elif node.op_type == "Transpose" and node.inputs[0] in inits:
            w = inits[node.inputs[0]]
            perm = node.attr("perm") or list(range(w.ndim))[::-1]
            inits[node.outputs[0]] = np.transpose(w, perm)
        elif node.op_type == "Constant" and node.outputs[0] not in inits:
            t = node.attr("value")
            if t is not None:
                inits[node.outputs[0]] = np.asarray(t)
    ops: list[WeightedOp] = []
    consumed_adds: set[int] = set()
    nodes = graph.nodes
    for idx, node in enumerate(nodes):
        if idx in consumed_adds:
            continue
        if node.op_type == "Conv" and node.inputs[1] in inits:
            ops.append(
                WeightedOp(
                    "conv",
                    node,
                    kernel=inits[node.inputs[1]],
                    bias=inits.get(node.inputs[2])
                    if len(node.inputs) > 2
                    else None,
                    output=node.outputs[0],
                    input_names={
                        "kernel": node.inputs[1],
                        **(
                            {"bias": node.inputs[2]}
                            if len(node.inputs) > 2
                            else {}
                        ),
                    },
                )
            )
        elif node.op_type == "BatchNormalization":
            ops.append(
                WeightedOp(
                    "bn",
                    node,
                    scale=inits[node.inputs[1]],
                    bias=inits[node.inputs[2]],
                    mean=inits[node.inputs[3]],
                    var=inits[node.inputs[4]],
                    epsilon=float(node.attr("epsilon", 1e-5)),
                    output=node.outputs[0],
                    input_names={
                        "scale": node.inputs[1],
                        "bias": node.inputs[2],
                        "mean": node.inputs[3],
                        "var": node.inputs[4],
                    },
                )
            )
        elif node.op_type == "Gemm" and node.inputs[1] in inits:
            ops.append(
                WeightedOp(
                    "dense",
                    node,
                    kernel=inits[node.inputs[1]],
                    bias=inits.get(node.inputs[2])
                    if len(node.inputs) > 2
                    else None,
                    trans_b=bool(node.attr("transB", 0)),
                    output=node.outputs[0],
                    input_names={
                        "kernel": node.inputs[1],
                        **(
                            {"bias": node.inputs[2]}
                            if len(node.inputs) > 2
                            else {}
                        ),
                    },
                )
            )
        elif node.op_type == "LayerNormalization" and node.inputs[1] in inits:
            ops.append(
                WeightedOp(
                    "ln",
                    node,
                    scale=inits[node.inputs[1]],
                    bias=inits.get(node.inputs[2])
                    if len(node.inputs) > 2 and node.inputs[2]
                    else None,
                    epsilon=float(node.attr("epsilon", 1e-5)),
                    output=node.outputs[0],
                    input_names={
                        "scale": node.inputs[1],
                        **(
                            {"bias": node.inputs[2]}
                            if len(node.inputs) > 2 and node.inputs[2]
                            else {}
                        ),
                    },
                )
            )
        elif node.op_type == "GRU" and node.inputs[1] in inits:
            w = inits[node.inputs[1]]  # (num_dirs, 3H, I), gates z|r|h
            ops.append(
                WeightedOp(
                    "gru",
                    node,
                    kernel=w,
                    rec_kernel=inits[node.inputs[2]],
                    bias=inits.get(node.inputs[3])
                    if len(node.inputs) > 3 and node.inputs[3]
                    else None,
                    num_dirs=w.shape[0],
                    linear_before_reset=bool(
                        node.attr("linear_before_reset", 0)
                    ),
                    output=node.outputs[0] if node.outputs else "",
                    input_names={
                        "kernel": node.inputs[1],
                        "rec_kernel": node.inputs[2],
                        **(
                            {"bias": node.inputs[3]}
                            if len(node.inputs) > 3 and node.inputs[3]
                            else {}
                        ),
                    },
                )
            )
        elif (
            node.op_type == "Mul"
            and len(node.inputs) == 2
            and sum(i in inits for i in node.inputs) == 1
        ):
            # keras/tf2onnx idiom: BatchNorm decomposed into
            # Mul(x, gamma/sqrt(var+eps)) + Add(., beta - mean*scale) with
            # per-channel broadcast constants. Synthesize a "bn" op whose
            # statistics make the Flax BatchNorm the exact same affine map
            # (mean 0, stored var 1 - eps so the denominator is exactly 1).
            s_name = next(i for i in node.inputs if i in inits)
            s = inits[s_name]
            if not (s.size > 1 and s.size == max(s.shape, default=0)):
                continue  # not a per-channel constant
            for jdx in range(idx + 1, min(idx + 3, len(nodes))):
                nxt = nodes[jdx]
                if (
                    nxt.op_type == "Add"
                    and node.outputs[0] in nxt.inputs
                    and any(i in inits for i in nxt.inputs)
                ):
                    b_name = next(i for i in nxt.inputs if i in inits)
                    b = inits[b_name]
                    if b.shape != s.shape:
                        break
                    c = s.size
                    ops.append(
                        WeightedOp(
                            "bn",
                            node,
                            scale=s.reshape(c).astype(np.float32),
                            bias=b.reshape(c).astype(np.float32),
                            mean=np.zeros(c, np.float32),
                            var=np.full(c, 1.0 - _FLAX_BN_EPS, np.float32),
                            epsilon=_FLAX_BN_EPS,
                            output=nxt.outputs[0],
                            input_names={"scale": s_name, "bias": b_name},
                            decomposed=True,
                            const_shapes={
                                "scale": s.shape, "bias": b.shape,
                            },
                        )
                    )
                    consumed_adds.add(jdx)
                    break
        elif node.op_type == "MatMul" and node.inputs[1] in inits:
            op = WeightedOp(
                "dense", node, kernel=inits[node.inputs[1]],
                output=node.outputs[0],
                input_names={"kernel": node.inputs[1]},
            )
            # fuse the canonical MatMul+Add bias pattern the torch exporter
            # writes for Linear
            for jdx in range(idx + 1, min(idx + 3, len(nodes))):
                nxt = nodes[jdx]
                if (
                    nxt.op_type == "Add"
                    and node.outputs[0] in nxt.inputs
                    and any(i in inits for i in nxt.inputs)
                ):
                    bias_name = next(i for i in nxt.inputs if i in inits)
                    op.bias = inits[bias_name]
                    op.output = nxt.outputs[0]
                    op.input_names["bias"] = bias_name
                    consumed_adds.add(jdx)
                    break
            ops.append(op)
    return ops


# ---------------------------------------------------------------------------
# Port side: weighted layers in execution order
# ---------------------------------------------------------------------------

@dataclass
class PortLayer:
    kind: str  # "conv" | "bn" | "dense" | "gru" | "ln"
    path: tuple[str, ...]  # the Flax path of the layer's variables
    has_bias: bool = False
    folded_from_conv: bool = False  # set during matching
    epsilon: Optional[float] = None  # ln only


def _kind(mod: nn.Module) -> Optional[str]:
    if isinstance(mod, (nn.Conv1d, nn.Conv2d)):
        return "conv"
    if isinstance(mod, nn.modules.batchnorm._BatchNorm):
        return "bn"
    if isinstance(mod, nn.Linear):
        return "dense"
    if isinstance(mod, nn.LayerNorm):
        return "ln"
    if isinstance(mod, nn.GRU):
        return "gru"
    return None


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype or x.dtype)


def _module_input(module: nn.Module, sample_x) -> torch.Tensor:
    """``sample_x`` on the module's device, in its parameters' dtype."""
    p = next(module.parameters())
    return _as_tensor(sample_x, p.device, p.dtype)


def execution_order(module: nn.Module, sample_x) -> list[PortLayer]:
    """Weighted leaf layers (Conv, BatchNorm, Linear, LayerNorm, GRU) in
    execution order, recorded with forward hooks around a real forward
    pass. An ``nn.GRU`` stands for the Flax GRUCells it holds
    (``GRUCell_{2 * layer + reverse}`` beside it): layer by layer, the
    forward cell before the reverse one, each matched against one
    direction of an ONNX GRU node."""
    seen: list[PortLayer] = []
    names = {mod: name for name, mod in module.named_modules()}
    hooks = []

    def record(mod, args, out):
        kind = _kind(mod)
        path = tuple(names[mod].split("."))
        if kind == "gru":
            dirs = 2 if mod.bidirectional else 1
            for k in range(mod.num_layers * dirs):
                seen.append(PortLayer("gru", path[:-1] + (f"GRUCell_{k}",)))
        elif not seen or seen[-1].path != path:
            has_bias = kind == "bn" or getattr(mod, "bias", None) is not None
            seen.append(PortLayer(
                kind, path, has_bias=has_bias,
                epsilon=mod.eps if kind == "ln" else None))

    for mod in names:
        if _kind(mod) is not None:
            hooks.append(mod.register_forward_hook(record))
    try:
        with torch.no_grad():
            module(_module_input(module, sample_x))
    finally:
        for h in hooks:
            h.remove()
    return seen


# the JAX package's names (transplant.py:282, :295)
FlaxLayer = PortLayer


def flax_execution_order(module: nn.Module, variables, sample_x,
                         **apply_kwargs) -> list[PortLayer]:
    """``execution_order`` under the JAX signature. The order does not
    depend on the weights, so ``variables`` and the Flax ``apply``
    keywords (``train``, ``mutable``) change nothing: the module runs
    one forward in eval mode."""
    del variables, apply_kwargs
    return execution_order(module, sample_x)


# ---------------------------------------------------------------------------
# Matching + assignment
# ---------------------------------------------------------------------------

def _set_in(tree: dict, path: tuple[str, ...], leaf_name: str, value,
            reshape_ok: bool = False):
    node = tree
    for p in path:
        node = node[p]
    old = node[leaf_name]
    value = np.asarray(value)
    if tuple(old.shape) != tuple(value.shape):
        # DenseGeneral packs the embed dim into (heads, head_dim) axes; a
        # row-major reshape of the 2-D exporter matrix is exactly torch's
        # contiguous head packing, so size-preserving reshapes are sound
        # for dense kernels/biases (and only requested for them)
        if reshape_ok and old.size == value.size:
            value = value.reshape(old.shape)
        else:
            raise ValueError(
                f"shape mismatch at {'/'.join(path)}/{leaf_name}: "
                f"port {tuple(old.shape)} vs onnx {tuple(value.shape)}")
    node[leaf_name] = np.ascontiguousarray(value, dtype=old.dtype)


def _peek_in(tree: dict, path: tuple[str, ...], leaf_name: str):
    node = tree
    for p in path:
        node = node[p]
    return node[leaf_name]


def _conv_kernel_to_flax(kernel: np.ndarray) -> np.ndarray:
    if kernel.ndim == 4:  # OIHW -> HWIO
        return kernel.transpose(2, 3, 1, 0)
    if kernel.ndim == 3:  # OIW -> WIO
        return kernel.transpose(2, 1, 0)
    raise ValueError(f"unsupported conv kernel rank {kernel.ndim}")


@dataclass
class TransplantEntry:
    flax_path: str
    onnx_node: str
    onnx_output: str
    kind: str
    folded: bool = False
    max_abs_diff: Optional[float] = None
    # where to compare: a folded conv's graph output includes the BN bias,
    # so it is checked against the BatchNorm's output, not the conv's
    verify_path: str = ""

    def __post_init__(self):
        if not self.verify_path:
            self.verify_path = self.flax_path


@dataclass
class TransplantReport:
    entries: list[TransplantEntry] = field(default_factory=list)
    final_max_abs_diff: Optional[float] = None

    def failed(self, tol: float) -> list[TransplantEntry]:
        """The verified layers whose diff exceeds ``tol``."""
        return [e for e in self.entries
                if e.max_abs_diff is not None and e.max_abs_diff > tol]

    def __str__(self) -> str:
        lines = [
            f"{e.flax_path:55s} <- {e.kind:5s} {e.onnx_node or e.onnx_output}"
            + (" [folded-bn]" if e.folded else "")
            + (f"  maxdiff={e.max_abs_diff:.3e}"
               if e.max_abs_diff is not None else "")
            for e in self.entries
        ]
        if self.final_max_abs_diff is not None:
            lines.append(f"{'FINAL OUTPUT':55s} maxdiff="
                         f"{self.final_max_abs_diff:.3e}")
        return "\n".join(lines)


# flax.linen.BatchNorm's epsilon, which the port's BatchNorm shares
# (models/layers.py BN_EPS): the transplant shifts the variance by
# eps_onnx - eps_flax so both normalizations agree exactly
_FLAX_BN_EPS = 1e-5


def _expect(ops, oi: int, kind: str, path_str: str) -> WeightedOp:
    if oi >= len(ops) or ops[oi].kind != kind:
        raise ValueError(
            f"graph op {oi} is {ops[oi].kind if oi < len(ops) else 'EOF'}, "
            f"expected {kind} for {path_str}")
    return ops[oi]


def transplant(model: wire.Model, module: nn.Module, variables,
               sample_x) -> tuple[dict, TransplantReport]:
    """Import the graph's weights into a Flax variable tree of the port's
    ``module``: ``variables`` (``flax_variables(module)`` when None) is
    the template, copied. Returns (tree, report); ``load_flax_tree(module,
    tree)`` loads it. Raises on any unmatched or shape-incompatible layer:
    a transplant is all-or-nothing."""
    ops = onnx_weighted_ops(model)
    layers = execution_order(module, sample_x)
    tree = copy.deepcopy(flax_variables(module) if variables is None
                         else variables)
    params = tree.setdefault("params", {})
    batch_stats = tree.get("batch_stats", {})
    report = TransplantReport()

    def set_gru_direction(path: tuple[str, ...], op: WeightedOp, d: int):
        """Direction ``d`` of an ONNX GRU node onto the GRUCell at
        ``path``. ONNX gate order is z|r|h over rows of W/R; B is [Wb_z
        Wb_r Wb_h Rb_z Rb_r Rb_h]. The cell computes r and z with one
        input-side bias (Wb + Rb fold together) and n = tanh(in(x) + r *
        hn(h)) with hn's own bias: ONNX's linear_before_reset=1 form."""
        if not op.linear_before_reset:
            raise ValueError(
                "GRU with linear_before_reset=0 does not map onto a GRU "
                "cell (reset applied after the hidden matmul)")
        hidden = op.rec_kernel.shape[-1]
        w, r = op.kernel[d], op.rec_kernel[d]
        b = (op.bias[d] if op.bias is not None
             else np.zeros(6 * hidden, np.float32))
        wz, wr, wh = np.split(w, 3, axis=0)
        rz, rr, rh = np.split(r, 3, axis=0)
        wbz, wbr, wbh, rbz, rbr, rbh = np.split(b, 6)
        for sub, kernel, bias in (
            ("iz", wz.T, wbz + rbz), ("ir", wr.T, wbr + rbr),
            ("in", wh.T, wbh), ("hz", rz.T, None), ("hr", rr.T, None),
            ("hn", rh.T, rbh),
        ):
            _set_in(params, path + (sub,), "kernel", kernel)
            if bias is not None:
                _set_in(params, path + (sub,), "bias", bias)

    oi = li = 0
    gru_dir = 0  # direction cursor within the current (bidirectional) GRU op
    while li < len(layers):
        layer = layers[li]
        path_str = "/".join(layer.path)
        if layer.kind == "conv":
            op = _expect(ops, oi, "conv", path_str)
            kernel = _conv_kernel_to_flax(op.kernel)
            want = _peek_in(params, layer.path, "kernel")
            if kernel.ndim == want.ndim + 1 and kernel.shape[0] == 1:
                # tf2onnx runs 1-D convs as 2-D inside an Unsqueeze/Conv/
                # Squeeze chain: HWIO (1, K, I, O) -> WIO (K, I, O)
                kernel = kernel[0]
            _set_in(params, layer.path, "kernel", kernel)
            folded = False
            if op.bias is not None:
                if layer.has_bias:
                    _set_in(params, layer.path, "bias", op.bias)
                elif (li + 1 < len(layers) and layers[li + 1].kind == "bn"
                      and (oi + 1 >= len(ops) or ops[oi + 1].kind != "bn")):
                    # the exporter folded the BatchNorm into the conv bias
                    bn = layers[li + 1]
                    c = op.bias.shape[0]
                    _set_in(params, bn.path, "scale", np.ones(c, np.float32))
                    _set_in(params, bn.path, "bias",
                            op.bias.astype(np.float32))
                    _set_in(batch_stats, bn.path, "mean",
                            np.zeros(c, np.float32))
                    _set_in(batch_stats, bn.path, "var",
                            np.full(c, 1.0 - _FLAX_BN_EPS, np.float32))
                    bn.folded_from_conv = True
                    folded = True
                else:
                    raise ValueError(f"conv bias with no home at {path_str}")
            report.entries.append(TransplantEntry(
                path_str, op.node.name, op.output, "conv", folded=folded,
                verify_path="/".join(layers[li + 1].path) if folded else ""))
            oi += 1
        elif layer.kind == "bn":
            if layer.folded_from_conv:
                report.entries.append(
                    TransplantEntry(path_str, "", "", "bn", folded=True))
            else:
                op = _expect(ops, oi, "bn", path_str)
                _set_in(params, layer.path, "scale", op.scale)
                _set_in(params, layer.path, "bias", op.bias)
                _set_in(batch_stats, layer.path, "mean", op.mean)
                _set_in(batch_stats, layer.path, "var",
                        op.var + (op.epsilon - _FLAX_BN_EPS))
                report.entries.append(
                    TransplantEntry(path_str, op.node.name, op.output, "bn"))
                oi += 1
        elif layer.kind == "gru":
            op = _expect(ops, oi, "gru", path_str)
            set_gru_direction(layer.path, op, gru_dir)
            # the GRU node's raw Y layout (seq, dirs, batch, H) aligns with
            # no layer output: the final-output diff covers it
            report.entries.append(TransplantEntry(
                path_str, op.node.name, "", f"gru[d{gru_dir}]"))
            gru_dir += 1
            if gru_dir >= op.num_dirs:
                gru_dir = 0
                oi += 1
        elif layer.kind == "dense":
            op = _expect(ops, oi, "dense", path_str)
            kernel = op.kernel
            if op.node.op_type == "Gemm" and op.trans_b:
                kernel = kernel.T  # (out, in) -> (in, out)
            _set_in(params, layer.path, "kernel", kernel, reshape_ok=True)
            if op.bias is not None:
                _set_in(params, layer.path, "bias", op.bias, reshape_ok=True)
            report.entries.append(
                TransplantEntry(path_str, op.node.name, op.output, "dense"))
            oi += 1
        elif layer.kind == "ln":
            op = _expect(ops, oi, "ln", path_str)
            # LayerNorm's epsilon sits inside a data-dependent variance:
            # there is no stored statistic to shift, so the module's own
            # epsilon must already agree with the checkpoint's
            if layer.epsilon is not None and \
                    abs(layer.epsilon - op.epsilon) > 1e-12:
                raise ValueError(
                    f"LayerNorm epsilon mismatch at {path_str}: port "
                    f"{layer.epsilon} vs onnx {op.epsilon}; construct the "
                    f"module with eps={op.epsilon}")
            _set_in(params, layer.path, "scale", op.scale)
            if op.bias is not None:
                _set_in(params, layer.path, "bias", op.bias)
            report.entries.append(
                TransplantEntry(path_str, op.node.name, op.output, "ln"))
            oi += 1
        li += 1

    if oi != len(ops):
        raise ValueError(
            f"{len(ops) - oi} weighted graph ops left unmatched "
            f"(first: {ops[oi].kind} {ops[oi].node.name})")
    return tree, report


# ---------------------------------------------------------------------------
# Verification: per-layer diffs between the two implementations
# ---------------------------------------------------------------------------

def verify_transplant(model: wire.Model, module: nn.Module, variables,
                      sample_x, report: TransplantReport,
                      graph_input=None) -> TransplantReport:
    """Fill the report with per-layer max-abs diffs between the graph
    executor's intermediate tensors and the port module's layer outputs
    (the module loaded with ``variables``, on a copy), plus the
    final-output diff. ``graph_input`` overrides the array fed to the
    graph when its layout differs from the module's input."""
    from ocr_inference_tpu_torch.models.params import load_flax_tree
    from ocr_inference_tpu_torch.onnx.runner import OnnxGraphFunction

    mod = copy.deepcopy(module).eval()
    load_flax_tree(mod, variables, "transplanted variables")
    x = _module_input(mod, sample_x)
    device = x.device
    outputs: dict[str, torch.Tensor] = {}

    def capture(name):
        def hook(m, args, out):
            outputs.setdefault(name.replace(".", "/"), out)
        return hook

    hooks = [m.register_forward_hook(capture(name))
             for name, m in mod.named_modules() if _kind(m) is not None]
    try:
        with torch.no_grad():
            final_port = mod(x)
    finally:
        for h in hooks:
            h.remove()

    wanted = [e.onnx_output for e in report.entries if e.onnx_output]
    gx = _as_tensor(graph_input if graph_input is not None else sample_x,
                    device)
    fn = OnnxGraphFunction(model, output_names=wanted, device=device)
    got = dict(zip(wanted, fn(fn.weights, gx)))
    for entry in report.entries:
        port = outputs.get(entry.verify_path)
        if not entry.onnx_output or entry.onnx_output not in got or \
                not isinstance(port, torch.Tensor):
            continue
        g, p = got[entry.onnx_output].float(), port.float()
        # the same layout as a rule; a channels-last graph tensor
        # (tf2onnx) is tried transposed as well, the smaller diff kept
        candidates = [g]
        if g.ndim == p.ndim and g.ndim in (3, 4):
            candidates.append(g.permute(0, 3, 1, 2) if g.ndim == 4
                              else g.transpose(1, 2))
        diffs = [float((c - p).abs().max()) for c in candidates
                 if c.shape == p.shape]
        if diffs:
            entry.max_abs_diff = min(diffs)

    final_fn = OnnxGraphFunction(model, device=device)
    final = final_fn(final_fn.weights, gx)[0].float()
    out = final_port.float()
    if final.ndim == out.ndim and final.shape != out.shape:
        # a (B, V, T) recognizer or a channels-last segmenter graph
        final = (final.permute(0, 3, 1, 2) if final.ndim == 4
                 else final.transpose(1, 2))
    report.final_max_abs_diff = float((final - out).abs().max())
    return report
