"""Artifact manager + audit logger (observability on-disk contract).

Copy of ocr_inference_tpu/io/artifacts.py: the same directory layout,
manifest, metrics and JSONL audit schema as the reference (reference:
BDRC/artifact_manager.py, BDRC/audit_logger.py), so downstream tooling
reads either implementation's output. Images are written by ``write_png``
(stdlib zlib) in place of cv2.imwrite.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import zlib
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

SUBDIR_NAMES = ["detection", "dewarping", "lines", "results"]


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path, image: np.ndarray) -> None:
    """Write an 8-bit gray (H, W) / (H, W, 1) or 3-channel (H, W, 3) image
    as PNG, as cv2.imwrite does: a 3-channel array is taken as BGR, so its
    channels are reversed into the file's RGB."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color_type = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
        img = img[..., ::-1]
    else:
        raise ValueError(f"write_png takes gray or 3-channel images, got "
                         f"shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.empty((h, rows.shape[1] + 1), np.uint8)
    raw[:, 0] = 0  # filter type None on every row
    raw[:, 1:] = rows
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", header))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


class ArtifactManager:
    """Structured artifact storage (reference: artifact_manager.py:20-139)."""

    def __init__(
        self,
        base_output_dir: str,
        job_id: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
    ):
        self.base_output_dir = Path(base_output_dir)
        self.job_id = job_id or (
            f"{datetime.now().strftime('%Y%m%d_%H%M%S')}_{os.urandom(3).hex()}"
        )
        self.job_dir = self.base_output_dir / self.job_id
        self.config = config or {}
        self.manifest: List[Dict[str, str]] = []
        self.page_metrics: Dict[str, Dict[str, Any]] = {}
        self.current_page: Optional[str] = None
        self._base_dir: Path = self.job_dir

    @property
    def subdirs(self) -> Dict[str, Path]:
        return {name: self._base_dir / name for name in SUBDIR_NAMES}

    def create_directory_structure(self):
        self.job_dir.mkdir(parents=True, exist_ok=True)

    def set_current_page(self, page_name: str):
        self.current_page = page_name
        self._base_dir = self.job_dir / page_name
        self._base_dir.mkdir(parents=True, exist_ok=True)

    def _ensure_subdir(self, subdir: str) -> Path:
        if subdir not in SUBDIR_NAMES:
            raise ValueError(f"Unknown subdirectory: {subdir}")
        path = self.subdirs[subdir]
        path.mkdir(parents=True, exist_ok=True)
        return path

    def get_results_dir(self) -> Path:
        return self._ensure_subdir("results")

    def _add_to_manifest(self, name: str, artifact_type: str, path: str):
        self.manifest.append(
            {
                "name": name,
                "type": artifact_type,
                "path": path,
                "timestamp": datetime.now().isoformat(),
            }
        )

    def save_config(self):
        path = self.job_dir / "config.json"
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.config, f, indent=2, default=str)
        self._add_to_manifest("config.json", "configuration", str(path))

    def save_image(self, name: str, image: np.ndarray, subdir: str,
                   fmt: str = "png") -> Path:
        if fmt != "png":
            raise ValueError(f"only png images are written, not {fmt}")
        path = self._ensure_subdir(subdir) / f"{name}.{fmt}"
        write_png(path, image)
        self._add_to_manifest(name, "image", str(path))
        return path

    def save_json(self, name: str, data: Any, subdir: str) -> Path:
        path = self._ensure_subdir(subdir) / f"{name}.json"
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2, default=str)
        self._add_to_manifest(name, "json", str(path))
        return path

    def save_numpy(self, name: str, array: np.ndarray, subdir: str) -> Path:
        path = self._ensure_subdir(subdir) / f"{name}.npy"
        np.save(path, array)
        self._add_to_manifest(name, "numpy", str(path))
        return path

    def save_text(self, name: str, text: str, subdir: str, ext: str = "txt") -> Path:
        path = self._ensure_subdir(subdir) / f"{name}.{ext}"
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        self._add_to_manifest(name, "text", str(path))
        return path

    def generate_manifest(self) -> Path:
        path = self.job_dir / "manifest.json"
        with open(path, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "job_id": self.job_id,
                    "created": datetime.now().isoformat(),
                    "artifacts": self.manifest,
                },
                f,
                indent=2,
            )
        return path

    def save_metrics(self, metrics: Dict[str, Any]) -> Path:
        if self.current_page:
            self.page_metrics[self.current_page] = metrics
            return self.job_dir / "metrics.json"
        path = self.job_dir / "metrics.json"
        with open(path, "w", encoding="utf-8") as f:
            json.dump(metrics, f, indent=2, default=str)
        return path

    def save_aggregate_metrics(self) -> Path:
        total_duration = sum(
            m.get("total_duration_ms", 0) for m in self.page_metrics.values()
        )
        total_lines = sum(
            m.get("lines_detected", 0) for m in self.page_metrics.values()
        )
        successful = sum(
            1 for m in self.page_metrics.values() if m.get("status") != "failed"
        )
        aggregate = {
            "job_summary": {
                "total_pages": len(self.page_metrics),
                "successful_pages": successful,
                "total_duration_ms": total_duration,
                "avg_duration_per_page_ms": (
                    total_duration / len(self.page_metrics)
                    if self.page_metrics
                    else 0
                ),
                "total_lines_detected": total_lines,
            },
            "per_page_metrics": self.page_metrics,
        }
        path = self.job_dir / "metrics.json"
        with open(path, "w", encoding="utf-8") as f:
            json.dump(aggregate, f, indent=2, default=str)
        return path

    # -- resume support (new; reference had none, SURVEY §5.3-5.4) --

    def completed_pages(self) -> set[str]:
        """Pages with a written metrics entry from a previous run of the same
        job dir — the idempotent-resume check used by the batch CLI."""
        path = self.job_dir / "metrics.json"
        if not path.is_file():
            return set()
        try:
            data = json.loads(path.read_text(encoding="utf-8"))
        except json.JSONDecodeError:
            return set()
        per_page = data.get("per_page_metrics", {})
        return {k for k, v in per_page.items() if v.get("status") != "failed"}


class JSONFormatter(logging.Formatter):
    """JSON-lines log record formatter (reference: audit_logger.py:10-24)."""

    def format(self, record: logging.LogRecord) -> str:
        log_obj = {
            "timestamp": datetime.now(timezone.utc).isoformat().replace(
                "+00:00", "Z"
            ),
            "level": record.levelname,
            "message": record.getMessage(),
        }
        for key in ("job_id", "stage", "operation", "status", "metadata"):
            if hasattr(record, key):
                log_obj[key] = getattr(record, key)
        if record.exc_info:
            log_obj["exception"] = self.formatException(record.exc_info)
        return json.dumps(log_obj, default=str)


class AuditLogger:
    """Structured per-job audit logger (reference: audit_logger.py:27-64)."""

    def __init__(self, job_id: str, log_file: Path):
        self.job_id = job_id
        self.logger = logging.getLogger(f"ocr_audit_{job_id}")
        self.logger.setLevel(logging.INFO)
        self.logger.handlers.clear()
        self.logger.propagate = False
        log_file = Path(log_file)
        log_file.parent.mkdir(parents=True, exist_ok=True)
        handler = logging.FileHandler(log_file, encoding="utf-8")
        handler.setFormatter(JSONFormatter())
        self.logger.addHandler(handler)

    def log(self, level: str, message: str, exc_info: bool = False, **kwargs):
        extra = {
            "job_id": self.job_id,
            **{k: v for k, v in kwargs.items() if v is not None},
        }
        getattr(self.logger, level.lower())(message, extra=extra, exc_info=exc_info)

    def log_stage_start(self, stage: str, metadata: Optional[Dict] = None):
        self.log(
            "INFO",
            f"Starting stage: {stage}",
            stage=stage,
            operation="stage_start",
            metadata=metadata,
        )

    def log_stage_end(
        self, stage: str, status: str = "success", metadata: Optional[Dict] = None
    ):
        self.log(
            "INFO",
            f"Completed stage: {stage}",
            stage=stage,
            operation="stage_end",
            status=status,
            metadata=metadata,
        )

    def log_operation(
        self, operation: str, stage: Optional[str] = None, status: str = "success"
    ):
        self.log(
            "INFO",
            f"Operation: {operation}",
            stage=stage,
            operation=operation,
            status=status,
        )

    def log_error(
        self,
        error_msg: str,
        stage: Optional[str] = None,
        operation: Optional[str] = None,
        exc_info: bool = True,
    ):
        self.log(
            "ERROR",
            error_msg,
            stage=stage,
            operation=operation,
            status="failure",
            exc_info=exc_info,
        )
