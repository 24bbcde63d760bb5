"""Pixel-pipeline constants, copied from ocr_inference_tpu/core/config.py
:137-146 (reference defaults: utils.py:796 binarize block 51 / C 13,
inference.py:170 line threshold 0.9)."""

BINARIZE_BLOCK = 51
BINARIZE_C = 13
LINE_CLASS_THRESHOLD = 0.9
