"""The static registry, name maps, result schemas and pixel-pipeline
constants, copied from ocr_inference_tpu/core/config.py:25-146 (reference:
Config.py:18-115; defaults: utils.py:713 patch 512, utils.py:741 clamp
4096x2048, utils.py:796 binarize block 51 / C 13, inference.py:170/263
thresholds 0.9/0.8, inference.py:732 k_factor 2.5 / bbox_tolerance 4.0 /
tps 0.25). ``MODEL_DICT`` is data: the port downloads nothing.
That module imports pyarrow, so the port keeps its own copy, with the
Parquet schemas as plain field descriptions (io/parquet.py writes them):
``(name, type)`` pairs, a type being "string", "int32", "int16",
"float32", ``("list", type)`` or ``("struct", ((name, type), ...))``, every
field nullable as pyarrow's default fields are."""

from ocr_inference_tpu_torch.core.data import (
    CharsetEncoder,
    Encoding,
    ExportFormat,
    Language,
    LineMerge,
    LineMode,
    LineSorting,
    OCRArchitecture,
    TPSMode,
)

# HuggingFace model registry (reference: Config.py:18-30)
MODEL_DICT = {
    "Lines_v2": "BDRC/PhotiLines_v2",
    "Photi_v2": "BDRC/Photi-v2",
    "Woodblock": "BDRC/Woodblock",
    "UCHAN": "BDRC/BigUCHAN_v1",
    "DergeTenjur": "BDRC/DergeTenjur",
    "GoogleBooks_C": "BDRC/GoogleBooks_C_v1",
    "GoogleBooks_E": "BDRC/GoogleBooks_E_v1",
    "Norbuketaka_C": "BDRC/Norbuketaka_C_V1",
    "Norbuketaka_E": "BDRC/Norbuketaka_E_V1",
    "Drutsa-A_E": "BDRC/Drutsa-A_E_v1",
    "ModernBooks": "BDRC/ModernBookFormat",
}

# Layout class overlay colors (reference: Config.py:37-48)
COLOR_DICT = {
    "background": "0, 0, 0",
    "image": "45, 255, 0",
    "text": "255, 243, 0",
    "margin": "0, 0, 255",
    "caption": "255, 100, 243",
    "table": "0, 255, 0",
    "pagenr": "0, 100, 15",
    "header": "255, 0, 0",
    "footer": "255, 255, 100",
    "line": "0, 100, 255",
}

LANGUAGES = {
    "en": Language.ENGLISH,
    "de": Language.GERMAN,
    "fr": Language.FRENCH,
    "bo": Language.TIBETAN,
    "ch": Language.CHINESE,
}

ENCODINGS = {"unicode": Encoding.UNICODE, "wylie": Encoding.WYLIE}

CHARSETENCODER = {"wylie": CharsetEncoder.WYLIE, "stack": CharsetEncoder.STACK}

# Architecture name -> family (reference: Config.py:71-77)
OCR_ARCHITECTURES = {
    "Easter2": OCRArchitecture.EASTER2,
    "Easter2b": OCRArchitecture.EASTER2,
    "Easter2-Vit": OCRArchitecture.EASTER2,
    "Easter2-Attention": OCRArchitecture.EASTER2,
    "CRNN": OCRArchitecture.CRNN,
}

EXPORTERS = {
    "xml": ExportFormat.XML,
    "json": ExportFormat.JSON,
    "text": ExportFormat.TXT,
}

LINE_MODES = {"line": LineMode.LINE, "layout": LineMode.LAYOUT}

LINE_MERGE = {"merge": LineMerge.MERGE, "stack": LineMerge.STACK}

LINE_SORTING = {"threshold": LineSorting.THRESHOLD, "peaks": LineSorting.PEAKS}

TPS_MODE = {"local": TPSMode.LOCAL, "global": TPSMode.GLOBAL}

PATCH_SIZE = 512
CLAMP_WIDTH = 4096
CLAMP_HEIGHT = 2048
BINARIZE_BLOCK = 51
BINARIZE_C = 13
LINE_CLASS_THRESHOLD = 0.9
LAYOUT_CLASS_THRESHOLD = 0.8
DEFAULT_K_FACTOR = 2.5
DEFAULT_BBOX_TOLERANCE = 4.0
DEFAULT_TPS_THRESHOLD = 0.25

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
