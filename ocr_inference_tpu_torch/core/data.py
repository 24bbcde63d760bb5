"""The part of the typed data model the page and volume OCR paths use.

Copied from ocr_inference_tpu/core/data.py (reference: BDRC/data.py), field
for field, so configs and results read the same in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from pathlib import Path
from typing import Optional
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


class LineSorting(Enum):
    """Reading-order sorting algorithm (reference: BDRC/data.py:60)."""

    THRESHOLD = 0
    PEAKS = 1


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
class OCRModel:
    """Named model + config handle (reference: BDRC/data.py:250)."""

    guid: UUID
    name: str
    path: str
    config: OCRModelConfig


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
