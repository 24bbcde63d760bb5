"""Evaluation: the CER metric, the OCR evaluator, the eval suite and the
synthetic pages."""

from ocr_inference_tpu_torch.eval.cer import CERScorer, cer, levenshtein  # noqa: F401
from ocr_inference_tpu_torch.eval.evaluator import OCREvaluator  # noqa: F401
