"""ONNX support on torch: the wire-format parser and writer, op lowerings,
and a graph executor (in place of onnxruntime); counterpart of
ocr_inference_tpu/onnx."""

from ocr_inference_tpu_torch.onnx.runner import (  # noqa: F401
    OnnxGraphFunction,
    OnnxModule,
    load_onnx_module,
)
from ocr_inference_tpu_torch.onnx.wire import (  # noqa: F401
    Model,
    encode_model,
    encode_node,
    encode_tensor,
    encode_value_info,
    load_model,
    parse_model,
)
