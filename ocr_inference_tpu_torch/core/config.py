"""Pixel-pipeline constants and name maps, copied from
ocr_inference_tpu/core/config.py:63, :84 and :137-146 (reference defaults:
utils.py:796 binarize block 51 / C 13, inference.py:170/263 thresholds
0.9/0.8, inference.py:732 k_factor 2.5 / bbox_tolerance 4.0). That module
imports pyarrow, so the port keeps its own copy."""

from ocr_inference_tpu_torch.core.data import CharsetEncoder, LineSorting

BINARIZE_BLOCK = 51
BINARIZE_C = 13
LINE_CLASS_THRESHOLD = 0.9
LAYOUT_CLASS_THRESHOLD = 0.8
DEFAULT_K_FACTOR = 2.5
DEFAULT_BBOX_TOLERANCE = 4.0

CHARSETENCODER = {"wylie": CharsetEncoder.WYLIE, "stack": CharsetEncoder.STACK}

LINE_SORTING = {"threshold": LineSorting.THRESHOLD, "peaks": LineSorting.PEAKS}
