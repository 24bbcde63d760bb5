"""Host-side line geometry: contours, skew, reading order, extraction."""

from ocr_inference_tpu_torch.geometry.lines import (  # noqa: F401
    bbox_to_original,
    build_line_data,
    build_raw_line_data,
    calculate_rotation_angle_from_lines,
    contour_to_cv,
    contour_to_original,
    extract_line_images,
    filter_line_contours,
    get_contours,
    get_line_image,
    get_text_bbox,
    get_union_bbox,
    group_line_chunks,
    optimize_contour,
    rotate_contour,
    rotate_from_angle,
    sort_bbox_centers,
    sort_lines_by_peaks,
    sort_lines_by_threshold,
)
