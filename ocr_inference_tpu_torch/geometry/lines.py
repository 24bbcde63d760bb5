"""Line geometry on the host: skew, contours, reading order, line strips.

The part of ocr_inference_tpu/geometry/lines.py that ``build_lines`` and
``extract_lines`` reach (reference: BDRC/line_detection.py), with its cv2
pixel calls replaced:

- cv2.warpAffine (lines.py:54-55) by ops/imaging.py ``rotate_from_angle``;
- cv2.drawContours(..., -1) (lines.py:227) by the native filled-contour
  rasterizer (byte-equal with cv2);
- cv2.cvtColor of a 3-channel mask is not needed: the detection engine
  returns the mask 2-D.

Topology runs in the native library (geometry/backend.py).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ocr_inference_tpu_torch.core.data import BBox, Line, generate_guid
from ocr_inference_tpu_torch.geometry import backend as geo
from ocr_inference_tpu_torch.native import PackedLineRoi
from ocr_inference_tpu_torch.ops import imaging


def get_contours(image: np.ndarray):
    """All contours, no hierarchy (reference: line_detection.py:33-44)."""
    return geo.find_contours(image.astype(np.uint8))


def optimize_contour(cnt: np.ndarray, e: float = 0.001) -> np.ndarray:
    """Polygon simplification, epsilon 0.001*arclen
    (reference: line_detection.py:47-59)."""
    return geo.approx_poly_dp(cnt, e * geo.arc_length(cnt, True), True)


def rotate_from_angle(image: np.ndarray, angle: float) -> np.ndarray:
    """Rotate a uint8 page or mask about its center, black border
    (reference: line_detection.py:62-76)."""
    return imaging.rotate_from_angle(torch.from_numpy(image), angle).numpy()


def calculate_rotation_angle_from_lines(
    line_mask: np.ndarray, max_angle: float = 5.0
) -> float:
    """Page skew from line contour orientations (reference:
    line_detection.py:145-185; cv2 5.x angle convention normalized to the
    line tilt in (-45, 45], as geometry/lines.py:96-125 does)."""
    contours = get_contours(line_mask)
    mask_threshold = line_mask.shape[0] * line_mask.shape[1] * 0.001
    contours = [x for x in contours if geo.contour_area(x) > mask_threshold]
    if not contours:
        return 0.0
    tilts = []
    for cnt in contours:
        a = geo.min_area_rect(cnt)[2]
        if a <= -45.0:
            a += 90.0
        elif a > 45.0:
            a -= 90.0
        tilts.append(a)
    cands = [t for t in tilts if t != 0.0 and abs(t) < max_angle]
    if not cands:
        return 0.0
    return float(np.mean(cands))


def build_line_data(contour: np.ndarray, optimize: bool = True) -> Line:
    """Contour -> Line with bbox + center (reference: line_detection.py:188)."""
    if optimize:
        contour = optimize_contour(contour)
    x, y, w, h = geo.bounding_rect(contour)
    return Line(
        guid=generate_guid(clock_seq=23),
        contour=contour,
        bbox=BBox(x, y, w, h),
        center=(x + w // 2, y + h // 2),
    )


def build_raw_line_data(
    image: np.ndarray, line_mask: np.ndarray, rot_threshold: float = 0.5
):
    """Deskew + contour extraction (reference: line_detection.py:212-244;
    the |angle| gate of geometry/lines.py:170-175). Returns
    (rotated_image, rotated mask, contours, angle) for a 2-D mask."""
    angle = calculate_rotation_angle_from_lines(line_mask)
    if abs(angle) > rot_threshold:
        out_mask = rotate_from_angle(line_mask, angle)
        out_img = rotate_from_angle(image, angle)
    else:
        out_mask, out_img = line_mask, image
    line_contours = [
        x for x in get_contours(out_mask) if geo.contour_area(x) > 10
    ]
    return out_img, out_mask, line_contours, angle


def filter_line_contours(
    image: np.ndarray, line_contours, threshold: float = 0.01
) -> list:
    """Keep w > 1% page width and h > 10 px (line_detection.py:247-264)."""
    filtered = []
    for cnt in line_contours:
        _, _, w, h = geo.bounding_rect(cnt)
        if w > image.shape[1] * threshold and h > 10:
            filtered.append(cnt)
    return filtered


# ---------------------------------------------------------------------------
# Line-strip extraction (ROI-local, adaptive k)
# ---------------------------------------------------------------------------

class _LineRoi:
    """Retry-invariant ROI state for one line's strip extraction
    (geometry/lines.py:198-236): the padded ROI around the contour (the
    dilation support of one contour is local), its filled contour mask, and
    the native packed-bit attempt state."""

    def __init__(self, image: np.ndarray, contour: np.ndarray, bbox_h: int,
                 k_factor: float):
        k0 = int(bbox_h * k_factor)
        kw0 = max(k0, 1)
        kh0 = max(int(k0 * k_factor), 1)
        x, y, w, h = geo.bounding_rect(contour)
        pad_x, pad_y = kw0 // 2 + 1, kh0 // 2 + 1
        x0, y0 = max(0, x - pad_x), max(0, y - pad_y)
        x1 = min(image.shape[1], x + w + pad_x)
        y1 = min(image.shape[0], y + h + pad_y)
        roi = image[y0:y1, x0:x1]
        mask = np.zeros(roi.shape[:2], dtype=np.uint8)
        shifted = contour - np.array([[[x0, y0]]], dtype=contour.dtype)
        geo.fill_contour(mask, shifted, 255)
        self._packed = PackedLineRoi(roi, mask)

    def attempt(self, bbox_h: int, k: float):
        """One dilation attempt -> (strip_height, crop_fn), with the
        reference's np.delete semantics (geometry/lines.py:238-287)."""
        k_size = int(bbox_h * k)
        kw = max(k_size, 1)
        kh = max(int(k_size * k), 1)
        packed = self._packed
        return packed.attempt_height(kw, kh), lambda: packed.masked_crop(kw, kh)


def get_line_image(
    image: np.ndarray,
    contour: np.ndarray,
    bbox_h: int,
    bbox_tolerance: float = 2.5,
    k_factor: float = 1.2,
) -> tuple[np.ndarray, float]:
    """Adaptive strip extraction: shrink k by 0.1 (max 10 tries) until the
    strip height fits bbox_h * tolerance (reference:
    line_detection.py:291-327, with the binary search over the monotone
    k grid of geometry/lines.py:330-384)."""
    try:
        roi = _LineRoi(image, contour, bbox_h, k_factor)
        tol = bbox_h * bbox_tolerance
        cands = [k_factor]
        t = k_factor
        truncated_k = None
        for _ in range(10):
            t -= 0.1
            if t <= 0.1:
                truncated_k = t
                break
            cands.append(t)
        height, crop = roi.attempt(bbox_h, cands[0])
        if height <= tol:
            return crop(), cands[0]
        lo, hi = 1, len(cands) - 1
        best = None
        while lo <= hi:
            mid = (lo + hi) // 2
            h_m, crop_m = roi.attempt(bbox_h, cands[mid])
            if h_m <= tol:
                best = (mid, crop_m)
                hi = mid - 1
            else:
                lo = mid + 1
        if best is not None:
            return best[1](), cands[best[0]]
        if len(cands) > 1:
            _, crop = roi.attempt(bbox_h, cands[-1])
        final_k = truncated_k if truncated_k is not None else cands[-1]
        return crop(), final_k
    except Exception as e:  # parity: never let one line kill a page
        print(f"Error in get_line_image: {e}", file=sys.stderr)
        return np.zeros((bbox_h, bbox_h * 2, 3), dtype=np.uint8), k_factor


def extract_line_images(
    image: np.ndarray,
    line_data: list[Line],
    default_k: float = 1.7,
    bbox_tolerance: float = 3,
) -> list[np.ndarray]:
    """Strips for sorted lines, carrying the adapted k forward
    (reference: line_detection.py:330-359)."""
    current_k = default_k
    line_images = []
    for line in line_data:
        _, _, _, h = geo.bounding_rect(line.contour)
        line_img, adapted_k = get_line_image(
            image, line.contour, h, bbox_tolerance=bbox_tolerance,
            k_factor=current_k,
        )
        line_images.append(line_img)
        current_k = adapted_k
    return line_images


# ---------------------------------------------------------------------------
# Reading order
# ---------------------------------------------------------------------------

def sort_bbox_centers(
    bbox_centers: list[tuple[int, int]], line_threshold: float = 20
) -> list[list[tuple[int, int]]]:
    """Group centers into rows by running-mean y distance; rows sorted by x
    and the row list reversed (reference: line_detection.py:424-486)."""
    if not bbox_centers:
        return []
    rows: list[list[tuple[int, int]]] = []
    current: list[tuple[int, int]] = []
    for center in bbox_centers:
        if current:
            mean_y = np.mean([c[1] for c in current])
            if abs(mean_y - center[1]) > line_threshold:
                current.sort(key=lambda c: c[0])
                rows.append(current.copy())
                current.clear()
        current.append(center)
    if current:
        rows.append(current)
    for row in rows:
        row.sort(key=lambda c: c[0])
    return list(reversed(rows))


def group_line_chunks(sorted_bbox_centers, lines: list[Line]) -> list[Line]:
    """Merge same-row chunks via the convex hull of their stacked contours
    (reference: line_detection.py:489-548; first match wins)."""
    by_center: dict = {}
    for line in lines:
        by_center.setdefault(line.center, line)
    new_lines: list[Line] = []
    for row in sorted_bbox_centers:
        if len(row) > 1:
            stack = [by_center[c].contour for c in row if c in by_center]
            if not stack:
                continue
            stacked = geo.convex_hull(np.vstack(stack))
            x, y, w, h = geo.bounding_rect(stacked)
            new_lines.append(Line(
                guid=generate_guid(clock_seq=23),
                contour=stacked,
                bbox=BBox(x, y, w, h),
                center=(x + w // 2, y + h // 2),
            ))
        else:
            new_lines.extend(by_center[c] for c in row if c in by_center)
    return new_lines


def sort_lines_by_threshold(
    line_mask: np.ndarray,
    lines: list[Line],
    group_lines: bool = True,
) -> tuple[list[Line], float]:
    """Reading-order sort with the slice-vote threshold + optional chunk
    merge (reference: line_detection.py:551-634)."""
    centers = [line.center for line in lines]
    threshold = geo.line_threshold(line_mask)
    sorted_centers = sort_bbox_centers(centers, line_threshold=threshold)
    if group_lines:
        new_lines = group_line_chunks(sorted_centers, lines)
    else:
        new_lines = [
            line
            for row in sorted_centers
            for c in row
            for line in lines
            if line.center == c
        ]
    return new_lines, threshold
