"""The page OCR pipeline: detection -> geometry -> recognition.

Counterpart of ocr_inference_tpu/pipeline/ocr_pipeline.py (reference:
BDRC/inference.py:432-826) with ``use_tps=False``: the same stage methods,
the same (OpStatus, payload) returns and the same SUCCESS payload
``[rot_mask, sorted_lines, ocr_lines, page_angle]``. The dewarp stage is a
pass-through without TPS, so it is not a stage here.
"""

from __future__ import annotations

import numpy as np

from ocr_inference_tpu_torch.core.data import (
    CharsetEncoder,
    Encoding,
    Line,
    OCRLine,
    OpStatus,
)
from ocr_inference_tpu_torch.geometry.lines import (
    build_line_data,
    build_raw_line_data,
    extract_line_images,
    filter_line_contours,
    sort_lines_by_threshold,
)
from ocr_inference_tpu_torch.pipeline.engines import (
    RecognitionEngine,
    SegmentationEngine,
)
from ocr_inference_tpu_torch.text import Converter


class OCRPipeline:
    """Page OCR over the two device engines."""

    def __init__(self, ocr_engine: RecognitionEngine,
                 detection_engine: SegmentationEngine):
        self.ocr_inference = ocr_engine
        self.line_inference = detection_engine
        self.encoder = ocr_engine.config.encoder
        self.converter = Converter()

    def detect_lines(self, image: np.ndarray):
        """Stage 1: line mask (reference: inference.py:488-506)."""
        return OpStatus.SUCCESS, self.line_inference.predict(image)

    def build_lines(self, image: np.ndarray, line_mask: np.ndarray):
        """Stage 2: deskew + contours (reference: inference.py:508-533)."""
        rot_img, rot_mask, line_contours, page_angle = build_raw_line_data(
            image, line_mask
        )
        if len(line_contours) == 0:
            return OpStatus.FAILED, "No lines detected"
        filtered = filter_line_contours(rot_mask, line_contours)
        if len(filtered) == 0:
            return OpStatus.FAILED, "No valid lines after filtering"
        return OpStatus.SUCCESS, (rot_img, rot_mask, filtered, page_angle)

    def extract_lines(self, work_img, rot_mask, filtered_contours,
                      merge_lines=True, k_factor=2.5, bbox_tolerance=4.0):
        """Stage 4: reading order + line strips
        (reference: inference.py:591-616)."""
        line_data = [build_line_data(x) for x in filtered_contours]
        sorted_lines, _ = sort_lines_by_threshold(
            rot_mask, line_data, group_lines=merge_lines
        )
        line_images = extract_line_images(
            work_img, sorted_lines, k_factor, bbox_tolerance
        )
        if not line_images:
            return OpStatus.FAILED, "No valid line images extracted"
        return OpStatus.SUCCESS, (sorted_lines, line_images)

    def _convert_text(self, pred: str, target_encoding: Encoding) -> str:
        if self.encoder == CharsetEncoder.WYLIE and target_encoding == Encoding.UNICODE:
            return self.converter.toUnicode(pred)
        if self.encoder == CharsetEncoder.STACK and target_encoding == Encoding.WYLIE:
            return self.converter.toWylie(pred)
        return pred

    def run_text_recognition(self, line_images: list, sorted_lines: list[Line],
                             target_encoding: Encoding = Encoding.UNICODE):
        """Stage 5: one bucketed recognition pass for the page
        (reference: inference.py:618-666)."""
        keep = [
            (img, info)
            for img, info in zip(line_images, sorted_lines)
            if img.shape[0] > 0 and img.shape[1] > 0
        ]
        if not keep:
            return OpStatus.SUCCESS, []
        imgs, infos = zip(*keep)
        raw_texts = self.ocr_inference.run_batch(list(imgs))
        encoding = (Encoding.WYLIE.name if target_encoding == Encoding.WYLIE
                    else Encoding.UNICODE.name)
        return OpStatus.SUCCESS, [
            OCRLine(
                guid=info.guid,
                text=self._convert_text(
                    text.strip().replace("§", " "), target_encoding
                ),
                encoding=encoding,
            )
            for text, info in zip(raw_texts, infos)
        ]

    def run_ocr(self, image: np.ndarray, k_factor: float = 2.5,
                bbox_tolerance: float = 4.0, merge_lines: bool = True,
                target_encoding: Encoding = Encoding.UNICODE):
        """Full page OCR (reference: inference.py:732-826) with per-stage
        failure isolation. SUCCESS payload is
        [rot_mask, sorted_lines, ocr_lines, page_angle]; a FAILED payload
        is the error message."""

        def run_stage(error_prefix: str, fn, *args, **kwargs):
            try:
                status, result = fn(*args, **kwargs)
            except Exception as e:  # isolate the stage, report its error
                return False, f"{error_prefix}: {e}"
            return status != OpStatus.FAILED, result

        if image is None:
            return OpStatus.FAILED, "Input image is None"
        ok, line_mask = run_stage("Line detection failed", self.detect_lines,
                                  image)
        if not ok:
            return OpStatus.FAILED, line_mask
        ok, result = run_stage("Line data building failed", self.build_lines,
                               image, line_mask)
        if not ok:
            return OpStatus.FAILED, result
        rot_img, rot_mask, filtered_contours, page_angle = result
        ok, result = run_stage(
            "Line extraction failed", self.extract_lines, rot_img, rot_mask,
            filtered_contours, merge_lines=merge_lines, k_factor=k_factor,
            bbox_tolerance=bbox_tolerance,
        )
        if not ok:
            return OpStatus.FAILED, result
        sorted_lines, line_images = result
        ok, ocr_lines = run_stage(
            "OCR processing failed", self.run_text_recognition, line_images,
            sorted_lines, target_encoding=target_encoding,
        )
        if not ok:
            return OpStatus.FAILED, ocr_lines
        return OpStatus.SUCCESS, [rot_mask, sorted_lines, ocr_lines,
                                  float(page_angle)]
