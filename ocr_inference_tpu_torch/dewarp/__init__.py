"""Thin-plate-spline dewarping: host fit, warp on the card."""

from ocr_inference_tpu_torch.dewarp.tps import (  # noqa: F401
    apply_global_tps,
    check_for_tps,
    check_line_tps,
    fit_tps,
    get_global_tps_line,
    get_line_images_via_local_tps,
    run_tps,
    tps_transform_points,
)
