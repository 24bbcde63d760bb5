"""Preview drawing, counterpart of ocr_inference_tpu/utils/preview.py
(reference: BDRC/utils.py:704-710, 902-962 and
LayoutDetection.create_preview_image, inference.py:210-261).

The JAX module draws with cv2; here each call is the port's cv2-equal
code, byte for byte:

- cv2.rectangle and cv2.polylines at thickness >= 2 (``PolyLine``: one
  clipped ``ThickLine`` a side, closed, each with a round cap at its
  end) -> ops/drawing.py ``line``;
- cv2.drawContours(..., thickness=-1) of one contour ->
  geometry/backend.py ``fill_contour`` (the native rasterizer);
- cv2.addWeighted(mask, a, image, 1 - a, 0, image) -> float32
  ``fma(mask, a, fma(image, 1 - a, 0))`` rounded half to even and
  saturated, cv2's vector loop.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ocr_inference_tpu_torch.core.config import COLOR_DICT
from ocr_inference_tpu_torch.core.data import BBox, RotatedBBox
from ocr_inference_tpu_torch.geometry import backend as geo
from ocr_inference_tpu_torch.ops import drawing
from ocr_inference_tpu_torch.ops.imaging import fma32


def _pixel(image: np.ndarray, color) -> tuple:
    """cv2's colour for this image: its first channels' components, 0
    beyond the ones given."""
    channels = 1 if image.ndim == 2 else image.shape[2]
    comps = tuple(int(v) for v in color) + (0,) * channels
    return comps[0] if image.ndim == 2 else comps[:channels]


def _closed_polyline(image: np.ndarray, points, color, thickness: int) -> None:
    """cv2.polylines(image, [points], True, color, thickness) for thickness
    >= 2: from the last point round, each side clipped as cv2.line clips
    it and drawn with a cap at its end."""
    pts = [(int(x), int(y)) for x, y in np.asarray(points).reshape(-1, 2)]
    p0 = pts[-1]
    for p in pts:
        drawing.line(image, p0, p, color, thickness, flags=2)
        p0 = p


def draw_bbox(image: np.ndarray, bbox: BBox, color=(0, 255, 0), thickness=2):
    """cv2.rectangle of the box's corners, in place (reference:
    BDRC/utils.py:902-904); a negative thickness fills it, both corners
    included."""
    x0, y0, x1, y1 = bbox.x, bbox.y, bbox.x + bbox.w, bbox.y + bbox.h
    if thickness < 0:
        image[max(y0, 0): max(y1 + 1, 0), max(x0, 0): max(x1 + 1, 0)] = \
            _pixel(image, color)
    else:
        _closed_polyline(image, [(x0, y0), (x1, y0), (x1, y1), (x0, y1)],
                         _pixel(image, color), thickness)
    return image


def draw_rotated_bbox(image: np.ndarray, obb: RotatedBBox,
                      color=(0, 0, 255), thickness=2):
    """cv2.polylines of the box's points, closed, in place (reference:
    BDRC/utils.py:907-915)."""
    _closed_polyline(image, obb.points, _pixel(image, color), thickness)
    return image


def _fill(image: np.ndarray, contour: np.ndarray, color) -> None:
    """cv2.drawContours(image, [contour], -1, color, -1), in place."""
    pixel = _pixel(image, color)
    if image.ndim == 2:
        geo.fill_contour(image, contour, pixel)
        return
    # the fill's pixels, rasterized in the contour's bounding box when the
    # box lies inside the image (the fill moves with whole-pixel shifts)
    x, y, w, h = geo.bounding_rect(np.asarray(contour))
    if x < 0 or y < 0 or x + w > image.shape[1] or y + h > image.shape[0]:
        x, y, h, w = 0, 0, image.shape[0], image.shape[1]
    cover = np.zeros((h, w), np.uint8)
    geo.fill_contour(cover, np.asarray(contour) - np.int32([x, y]), 1)
    image[y: y + h, x: x + w][cover > 0] = pixel


def generate_line_preview(prediction: np.ndarray,
                          filtered_contours: list[np.ndarray]) -> np.ndarray:
    """Filled-contour preview mask (reference: BDRC/utils.py:704-710); a
    2-D prediction takes the colour's first component, 255."""
    preview = np.zeros(shape=prediction.shape, dtype=np.uint8)
    for cnt in filtered_contours:
        _fill(preview, cnt, (255, 0, 0))
    return preview


def _color(name: str) -> tuple[int, int, int]:
    return tuple(int(x) for x in COLOR_DICT[name].split(","))


def _add_weighted(mask: np.ndarray, alpha: float, image: np.ndarray) -> None:
    """cv2.addWeighted(mask, alpha, image, 1 - alpha, 0, image) on uint8,
    in place: alpha, beta and gamma as float32, ``fma(mask, alpha,
    fma(image, beta, gamma))`` with one rounding each, then rounded half
    to even and saturated."""
    a = torch.tensor(alpha, dtype=torch.float32)
    b = torch.tensor(1.0 - alpha, dtype=torch.float32)
    m = torch.from_numpy(mask).to(torch.float32)
    img = torch.from_numpy(image).to(torch.float32)
    out = fma32(m, a, fma32(img, b, torch.zeros(())))
    image[...] = torch.round(out).clamp(0, 255).to(torch.uint8).numpy()


def create_preview_image(
    image: np.ndarray,
    image_predictions: Optional[list] = None,
    line_predictions: Optional[list] = None,
    caption_predictions: Optional[list] = None,
    margin_predictions: Optional[list] = None,
    alpha: float = 0.4,
) -> np.ndarray:
    """Blend per-class contour overlays onto the page, in place
    (reference: BDRC/utils.py:918-962): each contour filled on its own
    in its class's colour, later ones over earlier ones."""
    mask = np.zeros(image.shape, dtype=np.uint8)
    for preds, name in [
        (image_predictions, "image"),
        (line_predictions, "line"),
        (caption_predictions, "caption"),
        (margin_predictions, "margin"),
    ]:
        for cnt in preds or ():
            _fill(mask, cnt, _color(name))
    _add_weighted(mask, alpha, image)
    return image


def create_layout_preview(image: np.ndarray, layout_mask: np.ndarray,
                          classes: list[str], alpha: float = 0.4) -> np.ndarray:
    """Layout-engine preview from an (H, W, C) class mask
    (reference: LayoutDetection.create_preview_image, inference.py:210-261)."""
    from ocr_inference_tpu_torch.geometry import get_contours, optimize_contour

    def class_contours(channel: np.ndarray, size_thresh: int = 200):
        binary = np.where(channel > 200, 255, 0).astype(np.uint8)
        if binary.sum() == 0:
            return []
        contours = [optimize_contour(c) for c in get_contours(binary)]
        return [c for c in contours if geo.contour_area(c) > size_thresh]

    named = {}
    for idx, name in enumerate(classes):
        if name == "background" or idx >= layout_mask.shape[2]:
            continue
        named[name] = class_contours(layout_mask[:, :, idx])

    return create_preview_image(
        image,
        image_predictions=named.get("image"),
        line_predictions=named.get("line"),
        caption_predictions=named.get("caption"),
        margin_predictions=named.get("margin"),
        alpha=alpha,
    )
