"""Page and volume OCR: engines, stages, the builder and the volume runner."""

from ocr_inference_tpu_torch.pipeline.builder import build_pipeline  # noqa: F401
from ocr_inference_tpu_torch.pipeline.engines import (  # noqa: F401
    RecognitionEngine,
    SegmentationEngine,
    pad_ocr_line_host,
)
from ocr_inference_tpu_torch.pipeline.modern_layout import (  # noqa: F401
    ModernBookFormatLayoutDetection,
)
from ocr_inference_tpu_torch.pipeline.ocr_pipeline import (  # noqa: F401
    OCRPipeline,
    PipelineObserver,
)
from ocr_inference_tpu_torch.pipeline.runner import (  # noqa: F401
    run_ocr_with_artifacts,
)
from ocr_inference_tpu_torch.pipeline.volume import (  # noqa: F401
    PageRecord,
    VolumeRunner,
)
