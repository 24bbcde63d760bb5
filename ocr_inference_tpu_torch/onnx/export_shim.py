"""``torch.onnx.export`` without the ``onnx`` package.

Counterpart of ocr_inference_tpu/onnx/export_shim.py on the port's own
wire codec. torch's TorchScript exporter serializes the proto in C++; it
imports ``onnx`` only to reload the bytes and scan them for custom-domain
functions, and for optional checks. ``install`` registers a minimal
``onnx`` stand-in whose ``load_model_from_string`` parses the real bytes
(so the scan sees the true node domains) and whose ``SerializeToString``
hands them back unchanged.

``torch_export`` exports one of the port's modules (or any torch module)
through the legacy exporter (``dynamo=False``), the toolchain the
published BDRC checkpoints carry the idioms of: BatchNorm folded into the
conv under ``do_constant_folding=True``, Gemm with transB, value-info
naming.
"""

from __future__ import annotations

import importlib.util
import sys
import types

from ocr_inference_tpu_torch.onnx import wire


class _NodeView:
    """NodeProto-shaped view over a wire.Node for torch's function scan."""

    def __init__(self, node: wire.Node):
        self.domain = node.domain
        self.op_type = node.op_type
        self.attribute = [
            types.SimpleNamespace(
                g=_GraphView(a.g) if a.g is not None else None)
            for a in node.attributes.values()
        ]


class _GraphView:
    def __init__(self, graph: wire.Graph):
        self.node = [_NodeView(n) for n in graph.nodes]


class _Functions(list):
    def extend(self, items):  # torch extends only when custom ops exist
        if items:
            raise NotImplementedError(
                "onnx export shim: onnxscript custom functions are not "
                "supported (install the real onnx package for those graphs)")


class _ModelProtoView:
    """Parsed, read-only ModelProto view; serializes to the original
    bytes."""

    def __init__(self, data: bytes):
        self._data = data
        self.graph = _GraphView(wire.parse_model(data).graph)
        self.functions = _Functions()

    def SerializeToString(self) -> bytes:  # noqa: N802 (protobuf's name)
        return self._data


def install() -> bool:
    """Register the stand-in as ``sys.modules['onnx']`` unless an ``onnx``
    module is already imported or installed (then torch uses that one).
    Returns True: ``torch.onnx.export`` is usable either way."""
    if "onnx" in sys.modules or importlib.util.find_spec("onnx") is not None:
        return True
    mod = types.ModuleType("onnx")
    mod.load_model_from_string = _ModelProtoView
    mod.load_from_string = _ModelProtoView
    mod.__ocr_inference_tpu_torch_shim__ = True
    sys.modules["onnx"] = mod
    return True


def torch_export(module, example_input, path: str, opset_version: int = 17,
                 **kwargs) -> str:
    """Export ``module`` in eval mode through the TorchScript exporter
    (``dynamo=False``) to ``path``; ``kwargs`` go to ``torch.onnx.export``
    (``do_constant_folding``, ``dynamic_axes``, names). Returns ``path``."""
    import torch

    install()
    module = module.eval()
    with torch.no_grad():
        torch.onnx.export(module, example_input, path,
                          opset_version=opset_version, dynamo=False, **kwargs)
    return path
