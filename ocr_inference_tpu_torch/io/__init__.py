"""Persistence: exporters, Parquet writers, artifact manager, audit logger,
the image dataset."""

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
from ocr_inference_tpu_torch.io.parquet import (  # noqa: F401
    read_result_parquet,
    save_ocr_lines_parquet,
    write_result_parquet,
)
from ocr_inference_tpu_torch.io.dataset import ImageInferenceDataset  # noqa: F401
