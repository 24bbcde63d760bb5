"""Port -> ONNX weight write-back (the transplant, reversed).

Counterpart of ocr_inference_tpu/onnx/retroplant.py. ``onnx/transplant.py``
imports an exporter-produced ``.onnx`` checkpoint's weights into the
port's module of the same architecture; this module goes the other way:
it reads a module's (trained) weights, as the Flax variable tree
``flax_variables(module)`` gives them, out into the graph's initializer
tensors, producing a real ``.onnx`` checkpoint that any ONNX runtime can
execute with those weights.

Alignment reuses the transplant's machinery: weighted graph ops in node
order against the module's weighted layers in execution order; each
assignment is the exact inverse of the transplant's (conv HWIO -> OIHW,
Gemm transB, DenseGeneral head-packing reshapes, the BatchNorm epsilon
shift, GRU gate splits). Graphs whose BatchNorm the exporter folded
(``do_constant_folding=True``) are refused: fold-free exports carry the
BatchNorm statistics the write-back needs.

Scope: the conv families (UNet, DeepLabV3+, Easter2 with its attention
variants). CRNN cannot round-trip through the TorchScript exporter: its
fold-free exports route the GRU gate weights through Slice/Concat
constant chains with no initializer slot to write into, and its folded
exports fold the BatchNorms (refused above); the GRU inverse below still
serves graphs whose GRU weights are initializer-backed.
"""

from __future__ import annotations

import numpy as np

from ocr_inference_tpu_torch.models.params import flax_variables
from ocr_inference_tpu_torch.onnx import wire
from ocr_inference_tpu_torch.onnx.transplant import (
    _FLAX_BN_EPS,
    execution_order,
    onnx_weighted_ops,
)


def _routing_map(graph: wire.Graph) -> dict[str, tuple[str, list[int] | None]]:
    """Map every name a weighted op may consume to the underlying
    initializer: resolved_name -> (initializer_name, perm) where the
    consumed tensor equals ``transpose(initializer, perm)`` (perm=None for
    identity routing). Mirrors the Identity/Transpose/Constant resolution
    in onnx_weighted_ops; Constant-routed weights map to no initializer
    and are rejected at write-back time."""
    route: dict[str, tuple[str, list[int] | None]] = {
        name: (name, None) for name in graph.initializers
    }
    shapes = {name: list(t.dims) for name, t in graph.initializers.items()}
    for node in graph.nodes:
        if node.op_type == "Identity" and node.inputs[0] in route:
            route[node.outputs[0]] = route[node.inputs[0]]
            shapes[node.outputs[0]] = shapes[node.inputs[0]]
        elif node.op_type == "Transpose" and node.inputs[0] in route:
            src, perm0 = route[node.inputs[0]]
            rank = len(shapes[node.inputs[0]])
            perm = node.attr("perm") or list(range(rank))[::-1]
            perm = [int(p) for p in perm]
            if perm0 is not None:
                # value = T_perm(T_perm0(init)) = T_composed(init)
                perm = [perm0[p] for p in perm]
            route[node.outputs[0]] = (src, perm)
            shapes[node.outputs[0]] = [
                shapes[node.inputs[0]][p] for p in perm
            ]
    return route


def _conv_kernel_to_onnx(kernel: np.ndarray) -> np.ndarray:
    """Inverse of transplant._conv_kernel_to_flax."""
    kernel = np.asarray(kernel)
    if kernel.ndim == 4:  # HWIO -> OIHW
        return kernel.transpose(3, 2, 0, 1)
    if kernel.ndim == 3:  # WIO -> OIW
        return kernel.transpose(2, 1, 0)
    raise ValueError(f"unsupported conv kernel rank {kernel.ndim}")


def _get_in(tree: dict, path: tuple[str, ...], leaf: str) -> np.ndarray:
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node[leaf])


class RetroplantError(ValueError):
    pass


class Retroplanted(dict):
    """The write-back plan: a ``{initializer_name: array}`` dict (so it
    still reads like the original mapping), plus the de-aliasing needed
    when the exporter deduplicated identical tensors (fresh BN statistics
    are all zeros/ones, so several layers share ONE initializer slot —
    writing distinct trained values back requires giving each consumer
    its own): ``additions`` are new initializers to append and
    ``input_renames`` re-points ``(node_index, input_position)`` at them.
    """

    additions: dict[str, np.ndarray]
    input_renames: dict[tuple[int, int], str]


def retroplant(
    model: wire.Model,
    module,
    variables,
    sample_x,
) -> Retroplanted:
    """Read ``variables`` (a Flax variable tree of ``module``;
    ``flax_variables(module)`` when None) out into ``{initializer_name:
    array}`` for the graph's weighted ops, plus a de-aliasing plan for
    exporter-deduplicated slots (see Retroplanted). All-or-nothing: raises
    on any unmatched layer, folded-BN conv, or Constant-routed weight."""
    ops = onnx_weighted_ops(model)
    layers = execution_order(module, sample_x)
    route = _routing_map(model.graph)

    tree = flax_variables(module) if variables is None else variables
    params = tree.get("params", tree)
    batch_stats = tree.get("batch_stats", {})

    # emission order matters: entries resolve to initializers below, and
    # exporter-deduplicated slots are de-aliased per consuming node input
    entries: list[tuple[object, str, str, np.ndarray]] = []

    def emit(op, slot: str, value: np.ndarray):
        name = op.input_names.get(slot)
        if name is None:
            raise RetroplantError(
                f"{op.kind} node {op.node.name!r} records no graph name "
                f"for its {slot!r} tensor"
            )
        entries.append((op, slot, name, np.asarray(value)))

    oi = 0
    li = 0
    gru_dirs: list[dict[str, np.ndarray]] = []
    while li < len(layers):
        layer = layers[li]
        path_str = "/".join(layer.path)

        def expect(kind: str):
            if oi >= len(ops) or ops[oi].kind != kind:
                raise RetroplantError(
                    f"graph op {oi} is "
                    f"{ops[oi].kind if oi < len(ops) else 'EOF'}, "
                    f"expected {kind} for {path_str}"
                )
            return ops[oi]

        if layer.kind == "conv":
            op = expect("conv")
            kernel = _conv_kernel_to_onnx(
                _get_in(params, layer.path, "kernel"))
            if op.kernel is not None and kernel.ndim + 1 == op.kernel.ndim \
                    and op.kernel.shape[2] == 1:
                # tf2onnx 1-D-conv-as-2-D slot: OIW -> OI1W
                kernel = kernel[:, :, None, :]
            emit(op, "kernel", kernel)
            if op.bias is not None:
                if not layer.has_bias:
                    raise RetroplantError(
                        f"conv at {path_str}: graph carries an "
                        "exporter-folded BatchNorm bias — re-export with "
                        "do_constant_folding=False so BN statistics have "
                        "initializer slots to write back into"
                    )
                emit(op, "bias", _get_in(params, layer.path, "bias"))
            elif layer.has_bias:
                raise RetroplantError(
                    f"conv at {path_str} has a bias but the graph node "
                    "has no bias input"
                )
            oi += 1
        elif layer.kind == "bn":
            op = expect("bn")
            if op.decomposed:
                # tf2onnx/keras Mul+Add decomposition: fold the trained BN
                # into the graph's two per-channel constants, in the
                # exporter's on-wire constant shapes
                scale = _get_in(params, layer.path, "scale")
                bias = _get_in(params, layer.path, "bias")
                mean = _get_in(batch_stats, layer.path, "mean")
                var = _get_in(batch_stats, layer.path, "var")
                s = scale / np.sqrt(var + _FLAX_BN_EPS)
                b = bias - mean * s
                emit(op, "scale", s.reshape(op.const_shapes["scale"]))
                emit(op, "bias", b.reshape(op.const_shapes["bias"]))
            else:
                emit(op, "scale", _get_in(params, layer.path, "scale"))
                emit(op, "bias", _get_in(params, layer.path, "bias"))
                emit(op, "mean", _get_in(batch_stats, layer.path, "mean"))
                # transplant: flax_var = onnx_var + (eps_onnx - eps_flax)
                emit(
                    op, "var",
                    _get_in(batch_stats, layer.path, "var")
                    - (op.epsilon - _FLAX_BN_EPS),
                )
            oi += 1
        elif layer.kind == "dense":
            op = expect("dense")
            kernel = _get_in(params, layer.path, "kernel")
            if op.node.op_type == "Gemm" and op.trans_b:
                # slot holds (out, in); flax holds (in, out)-shaped data
                kernel = kernel.reshape(op.kernel.T.shape).T
            else:
                # DenseGeneral packs (heads, head_dim) axes — the row-major
                # reshape is the exact inverse of the transplant's
                kernel = kernel.reshape(op.kernel.shape)
            emit(op, "kernel", kernel)
            if op.bias is not None:
                emit(op, "bias",
                     _get_in(params, layer.path, "bias").reshape(
                         op.bias.shape))
            oi += 1
        elif layer.kind == "ln":
            op = expect("ln")
            if (
                layer.epsilon is not None
                and abs(layer.epsilon - op.epsilon) > 1e-12
            ):
                raise RetroplantError(
                    f"LayerNorm epsilon mismatch at {path_str}: flax "
                    f"{layer.epsilon} vs onnx {op.epsilon}"
                )
            emit(op, "scale", _get_in(params, layer.path, "scale"))
            if op.bias is not None:
                emit(op, "bias", _get_in(params, layer.path, "bias"))
            oi += 1
        elif layer.kind == "gru":
            op = expect("gru")
            if not op.linear_before_reset:
                raise RetroplantError(
                    "GRU with linear_before_reset=0 does not map onto a "
                    "GRU cell"
                )
            hidden = op.rec_kernel.shape[-1]
            sub = {
                s: _get_in(params, layer.path + (s,), "kernel")
                for s in ("iz", "ir", "in", "hz", "hr", "hn")
            }
            b = {
                s: _get_in(params, layer.path + (s,), "bias")
                for s in ("iz", "ir", "in", "hn")
            }
            w = np.concatenate([sub["iz"].T, sub["ir"].T, sub["in"].T], 0)
            r = np.concatenate([sub["hz"].T, sub["hr"].T, sub["hn"].T], 0)
            # transplant folded Wb+Rb into the input-side z/r biases; the
            # split back is non-unique — putting the whole sum on Wb and 0
            # on Rb is numerically identical (they are only ever added)
            zeros = np.zeros(hidden, np.float32)
            bias = np.concatenate(
                [b["iz"], b["ir"], b["in"], zeros, zeros, b["hn"]]
            )
            gru_dirs.append({"w": w, "r": r, "b": bias})
            if len(gru_dirs) >= op.num_dirs:
                emit(op, "kernel",
                     np.stack([d["w"] for d in gru_dirs]))
                emit(op, "rec_kernel",
                     np.stack([d["r"] for d in gru_dirs]))
                if op.bias is not None:
                    emit(op, "bias",
                         np.stack([d["b"] for d in gru_dirs]))
                gru_dirs = []
                oi += 1
        li += 1

    if oi != len(ops):
        raise RetroplantError(
            f"{len(ops) - oi} weighted graph ops left unmatched "
            f"(first: {ops[oi].kind} {ops[oi].node.name})"
        )

    # resolve routed names back to initializers, inverting any Transpose;
    # de-alias exporter-deduplicated slots (several layers' identical fresh
    # tensors — BN zeros/ones — share ONE initializer; trained values
    # differ, so each extra consumer gets its own appended initializer)
    out = Retroplanted()
    out.additions = {}
    out.input_renames = {}
    claims: dict[str, np.ndarray] = {}
    node_index = {id(n): i for i, n in enumerate(model.graph.nodes)}
    occ_seen: dict[tuple[int, str], int] = {}
    counter = 0
    for op, slot, name, value in entries:
        if name not in route:
            raise RetroplantError(
                f"weight tensor {name!r} is not initializer-backed "
                "(Constant-node weights cannot be written back)"
            )
        src, perm = route[name]
        init_value = (
            np.transpose(value, np.argsort(perm)) if perm is not None
            else value
        )
        key = (id(op.node), name)
        occ = occ_seen.get(key, 0)
        occ_seen[key] = occ + 1
        if src not in claims:
            claims[src] = init_value
            out[src] = init_value
            continue
        if np.array_equal(claims[src], init_value):
            continue
        if perm is not None:
            raise RetroplantError(
                f"initializer {src!r} is shared through a Transpose route "
                "with conflicting written-back values — cannot de-alias"
            )
        positions = [
            i for i, nm in enumerate(op.node.inputs) if nm == name
        ]
        if occ >= len(positions):
            raise RetroplantError(
                f"cannot locate the {slot!r} input of node "
                f"{op.node.name!r} to de-alias shared weight {name!r}"
            )
        counter += 1
        new_name = f"{src}__retroplant{counter}"
        slot_dtype = model.graph.initializers[src].to_numpy().dtype
        out.additions[new_name] = np.asarray(init_value, dtype=slot_dtype)
        out.input_renames[(node_index[id(op.node)], positions[occ])] = (
            new_name
        )
    return out


def write_back(
    model_path,
    module,
    variables,
    sample_x,
    out_path,
) -> dict[str, np.ndarray]:
    """Splice ``variables`` (``flax_variables(module)`` when None) into the
    checkpoint at ``model_path`` and write the result to ``out_path``.
    Returns the initializer mapping used."""
    from pathlib import Path

    with open(model_path, "rb") as f:
        raw = f.read()
    model = wire.parse_model(raw)
    wire._resolve_graph_external(model.graph, Path(model_path).parent)
    mapping = retroplant(model, module, variables, sample_x)
    new_bytes = wire.replace_initializers(
        raw, mapping,
        additions=mapping.additions, input_renames=mapping.input_renames,
    )
    with open(out_path, "wb") as f:
        f.write(new_bytes)
    return mapping
