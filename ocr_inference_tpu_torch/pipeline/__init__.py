"""Page OCR pipeline: engines, stages and the builder."""

from ocr_inference_tpu_torch.pipeline.builder import build_pipeline  # noqa: F401
from ocr_inference_tpu_torch.pipeline.ocr_pipeline import OCRPipeline  # noqa: F401
