"""Runtime utilities (build cache, devices, profiling) and previews."""

from ocr_inference_tpu_torch.utils.runtime import (  # noqa: F401
    cpu_devices,
    enable_compilation_cache,
    stage_timer,
    trace_profile,
)
from ocr_inference_tpu_torch.utils.preview import (  # noqa: F401
    create_layout_preview,
    create_preview_image,
    draw_bbox,
    draw_rotated_bbox,
    generate_line_preview,
)
