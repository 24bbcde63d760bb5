"""Persistence: exporters, artifact manager, audit logger."""

from ocr_inference_tpu_torch.io.artifacts import (  # noqa: F401
    ArtifactManager,
    AuditLogger,
    JSONFormatter,
)
from ocr_inference_tpu_torch.io.exporter import (  # noqa: F401
    Exporter,
    JsonExporter,
    PageXMLExporter,
    TextExporter,
)
