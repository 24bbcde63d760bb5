"""Pixel-pipeline constants, name maps and result schemas, copied from
ocr_inference_tpu/core/config.py:63, :84, :89-131 and :137-146 (reference
defaults: utils.py:796 binarize block 51 / C 13, inference.py:170/263
thresholds 0.9/0.8, inference.py:732 k_factor 2.5 / bbox_tolerance 4.0).
That module imports pyarrow, so the port keeps its own copy, with the
Parquet schemas as plain field descriptions (io/parquet.py writes them):
``(name, type)`` pairs, a type being "string", "int32", "int16",
"float32", ``("list", type)`` or ``("struct", ((name, type), ...))``, every
field nullable as pyarrow's default fields are."""

from ocr_inference_tpu_torch.core.data import CharsetEncoder, LineSorting

BINARIZE_BLOCK = 51
BINARIZE_C = 13
LINE_CLASS_THRESHOLD = 0.9
LAYOUT_CLASS_THRESHOLD = 0.8
DEFAULT_K_FACTOR = 2.5
DEFAULT_BBOX_TOLERANCE = 4.0

CHARSETENCODER = {"wylie": CharsetEncoder.WYLIE, "stack": CharsetEncoder.STACK}

LINE_SORTING = {"threshold": LineSorting.THRESHOLD, "peaks": LineSorting.PEAKS}

LINE_DETECTION_SCHEMA = (
    ("image_name", "string"),
    ("image_width", "int32"),
    ("image_height", "int32"),
    ("num_contours", "int32"),
    ("contours", ("list", ("list", ("struct", (("x", "int32"),
                                               ("y", "int32")))))),
    ("bboxes", ("list", ("struct", (("x", "int32"), ("y", "int32"),
                                    ("w", "int32"), ("h", "int32"))))),
)

OCR_LINES_SCHEMA = (
    ("guid", "string"),
    ("text", "string"),
    ("encoding", "string"),
    ("ctc_conf", "float32"),
    ("norm_logp", "float32"),
    ("n_beams", "int16"),
    ("logits", ("list", "float32")),
    ("lm_scores", ("list", "float32")),
)
