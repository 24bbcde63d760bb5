"""Instrumented page runs: a PipelineObserver that owns every side effect.

Copy of ocr_inference_tpu/pipeline/runner.py on the port's pipeline.

The reference implements observability by re-stating the whole stage sequence
with audit/artifact calls interleaved (reference: BDRC/pipeline.py:30-195).
Here the flow lives in OCRPipeline.run_ocr alone; this module only SUBSCRIBES
to its stage events. ``PageObserver`` derives audit metadata from the raw
stage payloads and dumps artifacts through a declarative per-stage table, and
``run_ocr_with_artifacts`` wraps one page run with the job-level bookkeeping
(exports, metrics). The on-disk contract — audit.log JSONL stage names,
artifact names/subdirs, metrics.json keys, results exports — matches the
reference.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Tuple

import numpy as np

from ocr_inference_tpu_torch.core.data import (
    ArtifactConfig,
    Encoding,
    Line,
    LineSorting,
    OpStatus,
)
from ocr_inference_tpu_torch.io.artifacts import ArtifactManager, AuditLogger
from ocr_inference_tpu_torch.io.exporter import PageXMLExporter, TextExporter
from ocr_inference_tpu_torch.pipeline.ocr_pipeline import (
    OCRPipeline,
    PipelineObserver,
)


def serialize_contours(contours) -> List:
    return [c.tolist() for c in contours]


def serialize_lines(lines: List[Line]) -> List:
    return [
        {
            "guid": str(ln.guid),
            "bbox": {"x": ln.bbox.x, "y": ln.bbox.y, "w": ln.bbox.w, "h": ln.bbox.h},
            "center": ln.center,
        }
        for ln in lines
    ]


class PageObserver(PipelineObserver):
    """Audit + artifact side effects for one page, driven by stage events.

    Audit records keep the reference's stage names and metadata keys; the
    artifact tree keeps its names and subdirs (reference artifact calls:
    BDRC/pipeline.py:87-163). The observer also accumulates the payload
    facts the job-level metrics need (line counts, dewarping flag, angle).
    """

    def __init__(
        self,
        artifact_manager: Optional[ArtifactManager] = None,
        audit_logger: Optional[AuditLogger] = None,
        artifact_config: Optional[ArtifactConfig] = None,
    ):
        self.artifacts = artifact_manager
        self.audit = audit_logger
        self.config = artifact_config
        self.tps_threshold: Optional[float] = None  # recorded in tps_analysis
        # facts harvested from payloads, consumed by run_ocr_with_artifacts
        self.page_angle: float = 0.0
        self.dewarping_applied: bool = False
        self.lines_detected: int = 0
        self.lines_processed: int = 0

    # -- event protocol --

    def stage_start(self, stage: str) -> None:
        if self.audit:
            self.audit.log_stage_start(stage)

    def stage_failed(self, stage: str, error: str) -> None:
        if self.audit:
            self.audit.log_error(error, stage=stage)

    def stage_end(self, stage: str, payload: Any) -> None:
        meta = getattr(self, f"_on_{stage}", lambda p: None)(payload)
        if self.audit:
            self.audit.log_stage_end(stage, status="success", metadata=meta)

    # -- per-stage payload handlers (meta derivation + artifact dumps) --

    def _save_detection(self) -> bool:
        return bool(self.artifacts and self.config and self.config.save_detection)

    def _on_line_detection(self, mask: np.ndarray) -> dict:
        if self._save_detection():
            self.artifacts.save_image("line_mask", mask, "detection")
        return {"mask_shape": mask.shape}

    def _on_build_line_data(self, payload) -> dict:
        _, rot_mask, contours, filtered, angle = payload
        self.page_angle = float(angle)
        if self._save_detection():
            self.artifacts.save_image("rotated_mask", rot_mask, "detection")
            for name, cnts in (
                ("contours_raw", contours),
                ("contours_filtered", filtered),
            ):
                self.artifacts.save_json(
                    name,
                    {"count": len(cnts), "contours": serialize_contours(cnts)},
                    "detection",
                )
        return {
            "rotation_angle": angle,
            "contour_count": len(contours),
            "filtered_count": len(filtered),
        }

    def _on_dewarping(self, result) -> dict:
        self.dewarping_applied = bool(result.applied)
        save = self.artifacts and self.config and self.config.save_dewarping
        if save and result.tps_ratio is not None:
            self.artifacts.save_json(
                "tps_analysis",
                {
                    "ratio": float(result.tps_ratio),
                    "threshold": self.tps_threshold,
                    "applied": result.applied,
                },
                "dewarping",
            )
            if result.applied and result.dewarped_mask is not None:
                self.artifacts.save_image(
                    "dewarped_mask", result.dewarped_mask, "dewarping"
                )
        return {
            "tps_ratio": result.tps_ratio,
            "dewarping_applied": result.applied,
        }

    def _on_extract_lines(self, payload) -> dict:
        sorted_lines, _ = payload
        self.lines_detected = len(sorted_lines)
        if self.artifacts and self.config:
            self.artifacts.save_json(
                "lines",
                {
                    "count": len(sorted_lines),
                    "lines": serialize_lines(sorted_lines),
                },
                "lines",
            )
        return {"lines_extracted": len(sorted_lines)}

    def _on_ocr_inference(self, ocr_lines) -> dict:
        self.lines_processed = len(ocr_lines)
        if self.audit:
            for idx in range(len(ocr_lines)):
                self.audit.log_operation(
                    f"ocr_line_{idx + 1}", stage="ocr_inference"
                )
        return {"lines_processed": len(ocr_lines)}


def run_ocr_with_artifacts(
    pipeline: OCRPipeline,
    image: np.ndarray,
    image_name: str,
    k_factor: float = 2.5,
    bbox_tolerance: float = 4.0,
    merge_lines: bool = True,
    use_tps: bool = False,
    tps_threshold: float = 0.25,
    target_encoding: Encoding = Encoding.UNICODE,
    artifact_manager: Optional[ArtifactManager] = None,
    audit_logger: Optional[AuditLogger] = None,
    artifact_config: Optional[ArtifactConfig] = None,
    line_sorting: LineSorting = LineSorting.THRESHOLD,
) -> Tuple[OpStatus, Any]:
    """One observed page run: run_ocr under a PageObserver, then exports and
    metrics (reference surface: BDRC/pipeline.py:30-195)."""
    started = time.perf_counter()
    observer = PageObserver(artifact_manager, audit_logger, artifact_config)
    observer.tps_threshold = tps_threshold

    if audit_logger:
        audit_logger.log_stage_start(
            "ocr_pipeline",
            metadata={
                "image_name": image_name,
                "image_shape": image.shape,
                "k_factor": k_factor,
                "bbox_tolerance": bbox_tolerance,
                "merge_lines": merge_lines,
                "use_tps": use_tps,
                "target_encoding": str(target_encoding),
            },
        )
    if artifact_manager:
        artifact_manager.create_directory_structure()
        artifact_manager.save_config()

    status, result = pipeline.run_ocr(
        image,
        k_factor=k_factor,
        bbox_tolerance=bbox_tolerance,
        merge_lines=merge_lines,
        use_tps=use_tps,
        tps_threshold=tps_threshold,
        target_encoding=target_encoding,
        observer=observer,
        line_sorting=line_sorting,
    )
    if status == OpStatus.FAILED:
        if audit_logger:
            audit_logger.log_stage_end("ocr_pipeline", status="failure")
        return status, result

    rot_mask, sorted_lines, ocr_lines, page_angle = result

    if artifact_manager:
        results_dir = str(artifact_manager.get_results_dir())
        TextExporter(results_dir).export_lines(
            image, image_name, sorted_lines, ocr_lines
        )
        PageXMLExporter(results_dir).export_lines(
            image, image_name, sorted_lines, ocr_lines, angle=page_angle
        )

    if audit_logger:
        audit_logger.log_stage_end("ocr_pipeline", status="success")
    if artifact_manager:
        artifact_manager.save_metrics(
            {
                "total_duration_ms": (time.perf_counter() - started) * 1000,
                "lines_detected": observer.lines_detected,
                "lines_processed": observer.lines_processed,
                "dewarping_applied": observer.dewarping_applied,
                "rotation_angle": page_angle,
                "image_name": image_name,
            }
        )
    return OpStatus.SUCCESS, (rot_mask, sorted_lines, ocr_lines, page_angle)
