"""The typed data model, copied from ocr_inference_tpu/core/data.py
(reference: BDRC/data.py) field for field and value for value, so configs,
settings and results read the same in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Any, Optional
from uuid import UUID, uuid1

import numpy as np


class OpStatus(Enum):
    """Per-stage operation status (reference: BDRC/data.py:17)."""

    SUCCESS = 0
    FAILED = 1


class Encoding(Enum):
    """Output text encoding (reference: BDRC/data.py:24)."""

    UNICODE = 0
    WYLIE = 1


class CharsetEncoder(Enum):
    """Charset unit convention of a recognizer (reference: BDRC/data.py:31)."""

    WYLIE = 0
    STACK = 1


class ExportFormat(Enum):
    """Export formats (reference: BDRC/data.py:38)."""

    TXT = 0
    XML = 1
    JSON = 2


class LineMode(Enum):
    """Line vs layout segmentation front-end (reference: BDRC/data.py:46)."""

    LINE = 0
    LAYOUT = 1


class LineMerge(Enum):
    """Line chunk merge strategy (reference: BDRC/data.py:53)."""

    MERGE = 0
    STACK = 1


class LineSorting(Enum):
    """Reading-order sorting algorithm (reference: BDRC/data.py:60)."""

    THRESHOLD = 0
    PEAKS = 1


class OCRArchitecture(Enum):
    """Recognizer families (reference: BDRC/data.py:67)."""

    EASTER2 = 0
    CRNN = 1


class TPSMode(Enum):
    """Dewarping scope (reference: BDRC/data.py:74)."""

    GLOBAL = 0
    LOCAL = 1


class Language(Enum):
    """UI languages kept for config parity (reference: BDRC/data.py:81)."""

    ENGLISH = 0
    GERMAN = 1
    FRENCH = 2
    TIBETAN = 3
    CHINESE = 4


def generate_guid(clock_seq: int) -> UUID:
    """UUID with fixed clock sequence (reference: BDRC/line_detection.py:20)."""
    return uuid1(clock_seq=clock_seq)


@dataclass
class BBox:
    """Axis-aligned box, x/y/w/h ints (reference: BDRC/data.py:104)."""

    x: int
    y: int
    w: int
    h: int

    def as_tuple(self) -> tuple[int, int, int, int]:
        return (self.x, self.y, self.w, self.h)


@dataclass
class RotatedBBox:
    """Min-area rotated box (reference: BDRC/data.py:112)."""

    center: tuple[float, float]
    width: float
    height: float
    angle: float
    points: np.ndarray  # (4, 2) int32


@dataclass
class Line:
    """A detected text line (reference: BDRC/data.py:121)."""

    guid: UUID
    contour: np.ndarray  # (N, 1, 2) int32, cv2 convention
    bbox: BBox
    center: tuple[int, int]


@dataclass
class OCRLine:
    """A recognized text line (reference: BDRC/data.py:131)."""

    guid: UUID
    text: str
    encoding: str
    ctc_conf: Optional[float] = None
    logits: Optional[list[float]] = None
    lm_scores: Optional[list[float]] = None


@dataclass
class LayoutData:
    """Layout analysis output (reference: BDRC/data.py:143)."""

    image: np.ndarray
    rotation: float
    images: list[BBox]
    text_bboxes: list[BBox]
    lines: list[Line]
    captions: list[BBox]
    margins: list[BBox]
    predictions: dict[str, np.ndarray]


@dataclass
class OCRData:
    """Per-image OCR payload (reference: BDRC/data.py:157)."""

    guid: UUID
    image_path: str
    image_name: str
    image: np.ndarray
    ocr_lines: Optional[list[OCRLine]]
    lines: Optional[list[Line]]
    preview: Optional[np.ndarray]
    angle: float


@dataclass
class DewarpingResult:
    """Stage-3 result (reference: BDRC/data.py:171)."""

    work_img: np.ndarray
    work_mask: np.ndarray
    filtered_contours: list
    page_angle: float
    applied: bool
    tps_ratio: Optional[float] = None
    dewarped_img: Optional[np.ndarray] = None
    dewarped_mask: Optional[np.ndarray] = None


@dataclass
class LineDetectionConfig:
    """Line segmentation model config (reference: BDRC/data.py:184)."""

    checkpoint: str
    onnx_file: str
    architecture: str
    patch_size: int
    classes: list[str]


@dataclass
class LayoutDetectionConfig:
    """Layout segmentation model config (reference: BDRC/data.py:193)."""

    checkpoint: str
    onnx_file: str
    architecture: str
    patch_size: int
    classes: list[str]


@dataclass
class OCRModelConfig:
    """Recognizer model config (reference: BDRC/data.py:203)."""

    model_file: str
    architecture: str
    input_width: int
    input_height: int
    input_layer: str
    output_layer: str
    squeeze_channel: bool
    swap_hw: bool
    encoder: CharsetEncoder
    charset: list[str]
    add_blank: bool
    version: str


@dataclass
class OCResult:
    """Full per-image OCR result (reference: BDRC/data.py:229)."""

    guid: UUID
    mask: np.ndarray
    lines: list[Line]
    text: list[OCRLine]
    angle: float


@dataclass
class OCRModel:
    """Named model + config handle (reference: BDRC/data.py:250)."""

    guid: UUID
    name: str
    path: str
    config: OCRModelConfig


@dataclass
class OCRSettings:
    """User settings bundle (reference: BDRC/data.py:260)."""

    line_mode: LineMode
    line_merge: LineMerge
    line_sorting: LineSorting
    k_factor: float
    bbox_tolerance: float
    dewarping: bool
    merge_lines: bool
    tps_mode: TPSMode
    output_encoding: Encoding


@dataclass
class EvaluationSet:
    """CER evaluation result set (reference: BDRC/data.py:275)."""

    distribution: str
    image_paths: list[str]
    label_paths: list[str]
    cer_scores: dict[str, float]


@dataclass
class KenLMConfig:
    """n-gram LM config (reference: BDRC/data.py:283). ``alpha``/``beta``
    are the shallow-fusion weights: fused score = alpha * ln p_lm + beta per
    emitted token (core/data.py:274-288)."""

    kenlm_file: str | Path
    arpa_file: str | Path
    unigrams: Optional[list[str]]
    alpha: float = 0.5
    beta: float = 0.0


@dataclass
class ArtifactConfig:
    """Artifact saving behavior (reference: BDRC/data.py:290)."""

    enabled: bool = True
    granularity: str = "standard"  # "minimal" | "standard"
    save_detection: bool = True
    save_dewarping: bool = True


@dataclass
class BatchConfig:
    """Recognition batching knobs (copy of the JAX BatchConfig): lines are
    padded into static width buckets and run as batches."""

    width_buckets: tuple[int, ...] = (512, 1024, 2000, 2500, 3000)
    max_lines_per_batch: int = 64


@dataclass
class PipelineResult:
    """Structured replacement for the reference's 4-element list return
    (reference: BDRC/inference.py:818-823)."""

    mask: np.ndarray
    lines: list[Line]
    ocr_lines: list[OCRLine]
    angle: float
    metrics: dict[str, Any] = field(default_factory=dict)
