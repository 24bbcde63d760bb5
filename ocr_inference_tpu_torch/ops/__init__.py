"""Image ops on tensors, tiling, packing and the kernel wrappers."""

from ocr_inference_tpu_torch.ops.imaging import (  # noqa: F401
    adaptive_threshold_gaussian,
    bilinear_sample,
    binarize,
    dilate_rect,
    erode_rect,
    gaussian_blur_gray,
    gaussian_kernel_1d,
    normalize,
    remap,
    resize_bilinear,
    rgb_to_gray,
    rotate_from_angle,
    rotation_matrix,
    sigmoid,
    warp_affine,
)
from ocr_inference_tpu_torch.ops.tiling import (  # noqa: F401
    PagePlan,
    bucket_for_width,
    crop_padding,
    pad_ocr_line,
    plan_page,
    pre_pad_line,
    preprocess_page,
    stitch_tiles,
    tile_page,
)
