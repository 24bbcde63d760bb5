"""The page OCR pipeline: detection -> geometry -> dewarp -> recognition.

Counterpart of ocr_inference_tpu/pipeline/ocr_pipeline.py (reference:
BDRC/inference.py:432-826): the same stage methods, the same (OpStatus,
payload) returns and the same SUCCESS payload ``[rot_mask, sorted_lines,
ocr_lines, page_angle]``, with observer events around each stage. The TPS
dewarp (``use_tps=True``) warps the page on the detection engine's device,
each warp in flight on a CUDA stream of its own. ``eval_mode=True`` reads
the lines with the CTC beam search (``run_text_recognition_eval``).

Differences from the JAX pipeline: a page that is a strided view (such as
``bgr[..., ::-1]``) is copied to a contiguous array once at the entry
points, and a CUDA error (``device.is_device_fault``) is raised out of
``run_ocr`` instead of becoming the page's FAILED status, since every later
call on the card would fail too.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import numpy as np
import torch

from ocr_inference_tpu_torch.core.data import (
    CharsetEncoder,
    DewarpingResult,
    Encoding,
    LayoutDetectionConfig,
    Line,
    LineDetectionConfig,
    LineSorting,
    OCRLine,
    OpStatus,
)
from ocr_inference_tpu_torch.device import is_device_fault
from ocr_inference_tpu_torch.dewarp import apply_global_tps, check_for_tps
from ocr_inference_tpu_torch.geometry.lines import (
    build_line_data,
    build_raw_line_data,
    extract_line_images,
    filter_line_contours,
    sort_lines_by_peaks,
    sort_lines_by_threshold,
)
from ocr_inference_tpu_torch.pipeline.engines import (
    RecognitionEngine,
    SegmentationEngine,
)
from ocr_inference_tpu_torch.text import Converter


class PipelineObserver:
    """Stage-event protocol for observability around ``run_ocr``
    (ocr_pipeline.py:44-61): subscribers (audit loggers, artifact dumpers)
    derive what they need from the raw stage payloads."""

    def stage_start(self, stage: str) -> None:  # pragma: no cover - protocol
        pass

    def stage_end(self, stage: str, payload) -> None:  # pragma: no cover
        pass

    def stage_failed(self, stage: str, error: str) -> None:  # pragma: no cover
        pass


_NULL_OBSERVER = PipelineObserver()


class OCRPipeline:
    """Page OCR over the two device engines."""

    def __init__(
        self,
        ocr_engine: RecognitionEngine,
        detection_engine: SegmentationEngine,
        line_config: LineDetectionConfig | LayoutDetectionConfig | None = None,
        use_line_prepadding: bool = False,
    ):
        self.ocr_inference = ocr_engine
        self.line_inference = detection_engine
        self.line_config = line_config
        self.encoder = ocr_engine.config.encoder
        self.converter = Converter()
        self.use_line_prepadding = use_line_prepadding
        self.ready = detection_engine is not None and ocr_engine is not None
        # CUDA streams for the dewarp's card work, one per warp in flight:
        # two geometry threads' warps queue behind neither each other nor
        # the detection work queued ahead on the default stream. A stream
        # goes back to the list once its warp has waited for its copies,
        # so the streams (and the memory cached on them) are reused.
        self._warp_streams: list = []
        self._warp_streams_lock = threading.Lock()

    @contextlib.contextmanager
    def _warp_stream(self, device: torch.device):
        if device.type != "cuda":
            yield None
            return
        with self._warp_streams_lock:
            stream = (self._warp_streams.pop() if self._warp_streams
                      else torch.cuda.Stream(device))
        try:
            yield stream
        finally:
            with self._warp_streams_lock:
                self._warp_streams.append(stream)

    def update_ocr_model(self, engine: RecognitionEngine):
        """Swap the recognizer (reference: inference.py:465-467)."""
        self.ocr_inference = engine
        self.encoder = engine.config.encoder

    def update_line_detection(
        self,
        engine: SegmentationEngine,
        config: LineDetectionConfig | LayoutDetectionConfig | None = None,
    ):
        """Swap the detector (reference: inference.py:469-482)."""
        self.line_inference = engine
        self.line_config = config

    # ==================== Stage methods ====================

    def detect_lines_async(self, image: np.ndarray):
        """Stage 1, dispatched: the page's work is queued on the card now;
        the returned zero-arg resolver waits only for the packed mask's
        copy to the host. A layout detector's mask gives its "line"
        channel (ocr_pipeline.py:102-116)."""
        resolver = self.line_inference.predict_async(image)
        if self.line_inference.mode == "layout":
            line = self.line_inference.classes.index("line")
            return lambda: (OpStatus.SUCCESS,
                            np.ascontiguousarray(resolver()[:, :, line]))
        return lambda: (OpStatus.SUCCESS, resolver())

    def detect_lines(self, image: np.ndarray):
        """Stage 1: line mask (reference: inference.py:488-506)."""
        return self.detect_lines_async(image)()

    def build_lines(self, image: np.ndarray, line_mask: np.ndarray):
        """Stage 2: deskew + contours (reference: inference.py:508-533)."""
        image = np.ascontiguousarray(image)
        rot_img, rot_mask, line_contours, page_angle = build_raw_line_data(
            image, line_mask, rgb_mask=False
        )
        if len(line_contours) == 0:
            return OpStatus.FAILED, "No lines detected"
        filtered_contours = filter_line_contours(rot_mask, line_contours)
        if len(filtered_contours) == 0:
            return OpStatus.FAILED, "No valid lines after filtering"
        return OpStatus.SUCCESS, (
            rot_img,
            rot_mask,
            line_contours,
            filtered_contours,
            page_angle,
        )

    def apply_dewarping(
        self,
        rot_img: np.ndarray,
        rot_mask: np.ndarray,
        filtered_contours: list,
        page_angle: float,
        use_tps: bool = False,
        tps_threshold: float = 0.25,
    ):
        """Stage 3: optional TPS dewarp (reference: inference.py:535-589;
        ocr_pipeline.py:152-194). Without TPS, or when at most
        ``tps_threshold`` of the lines are curved, the inputs pass through;
        otherwise the page and mask are warped on the card (gray page,
        mask in {0, 255}) and deskewed and cut into contours again."""
        if not use_tps:
            return OpStatus.SUCCESS, DewarpingResult(
                work_img=rot_img,
                work_mask=rot_mask,
                filtered_contours=filtered_contours,
                page_angle=page_angle,
                applied=False,
            )

        ratio, tps_line_data = check_for_tps(rot_img, filtered_contours)
        if ratio <= tps_threshold:
            return OpStatus.SUCCESS, DewarpingResult(
                work_img=rot_img,
                work_mask=rot_mask,
                filtered_contours=filtered_contours,
                page_angle=page_angle,
                applied=False,
                tps_ratio=ratio,
            )

        device = self.line_inference.device
        with self._warp_stream(device) as stream:
            dewarped_img, dewarped_mask = apply_global_tps(
                rot_img, rot_mask, tps_line_data, device=device,
                stream=stream,
            )
        dew_rot_img, dew_rot_mask, line_contours, new_page_angle = (
            build_raw_line_data(dewarped_img, dewarped_mask, rgb_mask=False)
        )
        new_filtered = filter_line_contours(dew_rot_mask, line_contours)

        return OpStatus.SUCCESS, DewarpingResult(
            work_img=dew_rot_img,
            work_mask=dew_rot_mask,
            filtered_contours=new_filtered,
            page_angle=new_page_angle,
            applied=True,
            tps_ratio=ratio,
            dewarped_img=dewarped_img,
            dewarped_mask=dewarped_mask,
        )

    def extract_lines(
        self,
        work_img: np.ndarray,
        rot_mask: np.ndarray,
        filtered_contours: list,
        merge_lines: bool = True,
        k_factor: float = 2.5,
        bbox_tolerance: float = 4.0,
        line_sorting: LineSorting = LineSorting.THRESHOLD,
    ):
        """Stage 4: reading order + line strips
        (reference: inference.py:591-616). ``line_sorting`` picks the
        slice-vote sort (THRESHOLD) or the projection-profile peaks
        (PEAKS)."""
        line_data = [build_line_data(x) for x in filtered_contours]
        sort_fn = (
            sort_lines_by_peaks
            if line_sorting == LineSorting.PEAKS
            else sort_lines_by_threshold
        )
        sorted_lines, _ = sort_fn(rot_mask, line_data, group_lines=merge_lines)
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
        raw_texts = self.ocr_inference.run_batch(
            list(imgs), pre_pad=self.use_line_prepadding
        )
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

    def run_text_recognition_eval(
        self,
        line_images: list,
        sorted_lines: list[Line],
        target_encoding: Encoding = Encoding.UNICODE,
        top_k_beams: int = 10,
        use_lm: bool = False,
    ):
        """Stage 5 (eval mode): beams and confidences (reference:
        inference.py:668-726; ocr_pipeline.py:275-331). The text is the top
        beam's; ``ctc_conf`` is exp(score / text length); ``logits`` holds
        the top beams' scores and ``lm_scores`` their LM parts when the LM
        was fused."""
        keep = [
            (img, info)
            for img, info in zip(line_images, sorted_lines)
            if img.shape[0] > 0 and img.shape[1] > 0
        ]
        if not keep:
            return OpStatus.SUCCESS, []
        imgs, infos = zip(*keep)
        all_beams = self.ocr_inference.run_batch_beams(
            list(imgs), pre_pad=self.use_line_prepadding, use_lm=use_lm,
            top_k=top_k_beams,
        )
        encoding = (Encoding.WYLIE.name if target_encoding == Encoding.WYLIE
                    else Encoding.UNICODE.name)
        ocr_lines = []
        for beams, info in zip(all_beams, infos):
            if not beams:
                continue
            beams = beams[:top_k_beams]
            pred = beams[0].text.strip().replace(" ", "")
            pred = pred.replace("§", " ")
            # length-normalized confidence (reference: inference.py:707-720)
            length = max(len(beams[0].text), 1)
            ocr_lines.append(
                OCRLine(
                    guid=info.guid,
                    text=self._convert_text(pred, target_encoding),
                    encoding=encoding,
                    ctc_conf=float(math.exp(beams[0].logit_score / length)),
                    logits=[float(b.logit_score) for b in beams],
                    lm_scores=(
                        [float(b.lm_score) for b in beams]
                        if beams[0].lm_score is not None
                        else None
                    ),
                )
            )
        return OpStatus.SUCCESS, ocr_lines

    def run_ocr(
        self,
        image: np.ndarray,
        k_factor: float = 2.5,
        bbox_tolerance: float = 4.0,
        merge_lines: bool = True,
        use_tps: bool = False,
        tps_threshold: float = 0.25,
        target_encoding: Encoding = Encoding.UNICODE,
        eval_mode: bool = False,
        observer: Optional[PipelineObserver] = None,
        line_sorting: LineSorting = LineSorting.THRESHOLD,
    ):
        """Full page OCR (reference: inference.py:732-826): stages 1-5 with
        per-stage failure isolation; SUCCESS payload is
        [rot_mask, sorted_lines, ocr_lines, page_angle], a FAILED payload
        the error message. ``observer`` receives stage start/end/failed
        events with the raw payloads. As in the JAX pipeline, the lines of a
        dewarped page are sorted against the mask from before the warp.
        ``eval_mode`` reads the lines with the beam search
        (``run_text_recognition_eval``) instead of greedy decoding."""
        obs = observer or _NULL_OBSERVER

        def run_stage(stage: str, error_prefix: str, fn, *args, **kwargs):
            """One stage with failure isolation + observer events; returns
            (ok, payload) where payload is the error string when not ok."""
            obs.stage_start(stage)
            try:
                status, result = fn(*args, **kwargs)
            except Exception as e:
                if is_device_fault(e):
                    raise
                msg = f"{error_prefix}: {str(e)}"
                obs.stage_failed(stage, msg)
                return False, msg
            if status == OpStatus.FAILED:
                obs.stage_failed(stage, str(result))
                return False, result
            obs.stage_end(stage, result)
            return True, result

        try:
            if not self.ready:
                return OpStatus.FAILED, "OCR pipeline not ready"
            if image is None:
                return OpStatus.FAILED, "Input image is None"
            image = np.ascontiguousarray(image)

            ok, result = run_stage(
                "line_detection", "Line detection failed",
                self.detect_lines, image,
            )
            if not ok:
                return OpStatus.FAILED, result
            line_mask = result

            ok, result = run_stage(
                "build_line_data", "Line data building failed",
                self.build_lines, image, line_mask,
            )
            if not ok:
                return OpStatus.FAILED, result
            rot_img, rot_mask, _, filtered_contours, page_angle = result

            ok, result = run_stage(
                "dewarping", "Line processing failed",
                self.apply_dewarping, rot_img, rot_mask, filtered_contours,
                page_angle, use_tps=use_tps, tps_threshold=tps_threshold,
            )
            if not ok:
                return OpStatus.FAILED, result
            dewarp_result = result

            ok, result = run_stage(
                "extract_lines", "Line extraction failed",
                self.extract_lines, dewarp_result.work_img, rot_mask,
                dewarp_result.filtered_contours, merge_lines=merge_lines,
                k_factor=k_factor, bbox_tolerance=bbox_tolerance,
                line_sorting=line_sorting,
            )
            if not ok:
                return OpStatus.FAILED, result
            sorted_lines, line_images = result

            recognize = (
                self.run_text_recognition_eval
                if eval_mode
                else self.run_text_recognition
            )
            ok, ocr_lines = run_stage(
                "ocr_inference", "OCR processing failed",
                recognize, line_images, sorted_lines,
                target_encoding=target_encoding,
            )
            if not ok:
                return OpStatus.FAILED, ocr_lines

            return OpStatus.SUCCESS, [
                rot_mask,
                sorted_lines,
                ocr_lines,
                float(page_angle),
            ]
        except Exception as e:
            if is_device_fault(e):
                raise
            return OpStatus.FAILED, f"OCR pipeline failed: {str(e)}"
