"""ONNX graph inspector: dump inputs/outputs/nodes of an .onnx file.

Counterpart of ocr_inference_tpu/cli/inspect_onnx_cli.py
(``bocr-inspect``), with the same output. It replaces the reference's
DebugOnnx.ipynb workflow (its one cell loads a graph with onnxruntime and
prints node names to debug the per-model ``input_layer``/``output_layer``
config keys, reference: DebugOnnx.ipynb cell 1; the keys it feeds are
read by BDRC/utils.py:349-393). It runs on the port's own wire parser, so
no onnx/onnxruntime install is needed.

Usage:
    python -m ocr_inference_tpu_torch.cli.inspect_onnx_cli model.onnx
    python -m ocr_inference_tpu_torch.cli.inspect_onnx_cli model.onnx --nodes

The first prints the summary and the graph's I/O; ``--nodes`` adds the
full node table.
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter

from ocr_inference_tpu_torch.onnx.wire import load_model

_ELEM_TYPES = {
    1: "f32", 2: "u8", 3: "i8", 4: "u16", 5: "i16", 6: "i32", 7: "i64",
    9: "bool", 10: "f16", 11: "f64", 12: "u32", 13: "u64", 16: "bf16",
}


def _shape(vi) -> str:
    dims = ["?" if d is None else str(d) for d in vi.shape]
    return f"{_ELEM_TYPES.get(vi.elem_type, vi.elem_type)}[{','.join(dims)}]"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Inspect an ONNX graph (inputs, outputs, ops, weights)"
    )
    parser.add_argument("model", help="Path to the .onnx file")
    parser.add_argument("--nodes", action="store_true",
                        help="Print the full node table")
    args = parser.parse_args(argv)

    model = load_model(args.model)
    g = model.graph
    print(f"graph: {g.name or '(unnamed)'}")
    print(f"producer: {model.producer or '(unknown)'}  opset: {model.opset}  "
          f"ir: {model.ir_version}")

    feeds = [vi for vi in g.inputs if vi.name not in g.initializers]
    print(f"\ninputs ({len(feeds)}):")
    for vi in feeds:
        print(f"  {vi.name}: {_shape(vi)}")
    print(f"outputs ({len(g.outputs)}):")
    for vi in g.outputs:
        print(f"  {vi.name}: {_shape(vi)}")

    n_params = sum(
        t.to_numpy().size for t in g.initializers.values()
    )
    print(f"\ninitializers: {len(g.initializers)} tensors, "
          f"{n_params:,} parameters")

    ops = Counter(n.op_type for n in g.nodes)
    print(f"ops ({len(g.nodes)} nodes): "
          + ", ".join(f"{op}x{c}" for op, c in ops.most_common()))

    if args.nodes:
        print("\nnodes:")
        for i, n in enumerate(g.nodes):
            print(f"  [{i}] {n.op_type} ({n.name or '-'}) "
                  f"{list(n.inputs)} -> {list(n.outputs)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
