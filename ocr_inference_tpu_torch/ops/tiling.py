"""Page tiling / stitching and line-canvas padding, counterpart of
ocr_inference_tpu/ops/tiling.py (reference: BDRC/utils.py:497-560,
713-778, 818-899) plus the host canvas pad of ops_host.py:223.

Tile functions are reshapes/permutes of tensors on any device; the plan is
host arithmetic so every shape is known before the device work starts.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ocr_inference_tpu_torch.ops.imaging import resize_bilinear, resize_linear_u8


@dataclass(frozen=True)
class PagePlan:
    """Host-side plan for one page: resize to (resized_h, resized_w), pad to
    (padded_h, padded_w) with 255, tile into y_steps x x_steps patches
    (reference: BDRC/utils.py:741-778)."""

    orig_h: int
    orig_w: int
    resized_h: int
    resized_w: int
    padded_h: int
    padded_w: int
    patch_size: int

    @property
    def pad_x(self) -> int:
        return self.padded_w - self.resized_w

    @property
    def pad_y(self) -> int:
        return self.padded_h - self.resized_h

    @property
    def x_steps(self) -> int:
        return self.padded_w // self.patch_size

    @property
    def y_steps(self) -> int:
        return self.padded_h // self.patch_size

    @property
    def n_tiles(self) -> int:
        return self.x_steps * self.y_steps


def plan_page(
    h: int,
    w: int,
    patch_size: int = 512,
    clamp_width: int = 4096,
    clamp_height: int = 2048,
    clamp_size: bool = True,
) -> PagePlan:
    """The reference clamp rules (BDRC/utils.py:764-776): wide pages clamp
    to clamp_width, tall pages to clamp_height, short pages upscale to
    patch_size height; then pad up to a multiple of patch_size."""
    rh, rw = h, w
    if clamp_size and w > h and w > clamp_width:
        scale = clamp_width / w
        rw, rh = clamp_width, int(h * scale)
    elif clamp_size and h > w and h > clamp_height:
        scale = clamp_height / h
        rh, rw = clamp_height, int(w * scale)
    elif h < patch_size:
        scale = patch_size / h
        rh, rw = patch_size, int(w * scale)
    ph = math.ceil(rh / patch_size) * patch_size
    pw = math.ceil(rw / patch_size) * patch_size
    return PagePlan(h, w, rh, rw, ph, pw, patch_size)


def preprocess_page(image: torch.Tensor, plan: PagePlan) -> torch.Tensor:
    """Resize per plan and pad bottom/right with 255 (BDRC/utils.py:741-778)."""
    img = image
    if (plan.resized_h, plan.resized_w) != (plan.orig_h, plan.orig_w):
        img = resize_bilinear(img, plan.resized_h, plan.resized_w)
    out = torch.full(
        (plan.padded_h, plan.padded_w) + tuple(img.shape[2:]), 255,
        dtype=img.dtype, device=img.device,
    )
    out[: plan.resized_h, : plan.resized_w] = img
    return out


def tile_page(padded: torch.Tensor, patch_size: int = 512) -> torch.Tensor:
    """(H, W[, C]) -> (N, patch, patch[, C]) in row-major tile order
    (reference np.split order, BDRC/utils.py:713-721)."""
    h, w = padded.shape[0], padded.shape[1]
    ys, xs = h // patch_size, w // patch_size
    rest = tuple(padded.shape[2:])
    x = padded.reshape((ys, patch_size, xs, patch_size) + rest)
    x = x.transpose(1, 2)
    return x.reshape((ys * xs, patch_size, patch_size) + rest)


def stitch_tiles(tiles: torch.Tensor, y_steps: int) -> torch.Tensor:
    """Inverse of tile_page: (N, p, p[, C]) -> (H, W[, C])."""
    n, p = tiles.shape[0], tiles.shape[1]
    x_steps = n // y_steps
    rest = tuple(tiles.shape[3:])
    x = tiles.reshape((y_steps, x_steps, p, p) + rest).transpose(1, 2)
    return x.reshape((y_steps * p, x_steps * p) + rest)


def crop_padding(image: torch.Tensor, pad_x: int, pad_y: int) -> torch.Tensor:
    """Strip the bottom/right padding (BDRC/utils.py:1100-1108)."""
    return image[: image.shape[0] - pad_y, : image.shape[1] - pad_x]


def bucket_for_width(
    w: int, h: int, target_height: int, buckets: tuple[int, ...]
) -> int:
    """Smallest width bucket that fits the line once scaled to
    target_height (ops/tiling.py:190-205)."""
    scaled_w = max(1, int(w * (target_height / max(h, 1))))
    for b in buckets:
        if scaled_w <= b:
            return b
    return buckets[-1]


def _center_band(img: torch.Tensor, target: int, axis: int, value: int):
    lead = (target - img.shape[axis]) // 2
    parts = []
    for n in (lead, target - img.shape[axis] - lead):
        shape = list(img.shape)
        shape[axis] = n
        parts.append(torch.full(shape, value, dtype=torch.uint8,
                                device=img.device))
    return torch.cat([parts[0], img, parts[1]], dim=axis)


def pad_ocr_line(
    img: torch.Tensor,
    target_width: int = 3000,
    target_height: int = 80,
    padding: str = "black",
) -> torch.Tensor:
    """Aspect-preserving pad of a (H, W[, C]) uint8 line strip into the
    recognizer canvas, byte-equal with ops_host.pad_ocr_line
    (BDRC/utils.py:818-899): resize to the target width (centered
    vertically) or height (centered horizontally) with cv2's integer
    INTER_LINEAR, pad with black/white, then resize to the exact canvas.
    Ties go to the width path."""
    h, w = img.shape[0], img.shape[1]
    value = 255 if padding == "white" else 0
    if target_width / w <= target_height / h:
        new_h = int(h * (target_width / w))
        out = _center_band(
            resize_linear_u8(img, new_h, target_width), target_height, 0,
            value,
        )
    else:
        new_w = int(w * (target_height / h))
        out = _center_band(
            resize_linear_u8(img, target_height, new_w), target_width, 1,
            value,
        )
    return resize_linear_u8(out, target_height, target_width)
