"""Line geometry on the host: skew, contours, reading order, line strips.

The part of ocr_inference_tpu/geometry/lines.py that the pipeline stages
(both reading orders) and the exporters reach (reference:
BDRC/line_detection.py, BDRC/utils.py), with its cv2 pixel calls
replaced:

- cv2.warpAffine (lines.py:54-55) by ops/imaging.py ``rotate_from_angle``;
- cv2.drawContours(..., -1) (lines.py:227) by the native filled-contour
  rasterizer (byte-equal with cv2);
- cv2.cvtColor(BGR2GRAY) of a 3-channel mask (lines.py:559) by
  ops/imaging.py ``rgb_to_gray`` on the reversed channels (cv2's
  fixed-point weights, byte-equal); the detection engine itself returns
  the mask 2-D.

Topology runs in the native library (geometry/backend.py).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ocr_inference_tpu_torch.core.data import (
    BBox,
    Line,
    RotatedBBox,
    generate_guid,
)
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
    image: np.ndarray, line_mask: np.ndarray, rot_threshold: float = 0.5,
    rgb_mask: bool = True,
):
    """Deskew + contour extraction (reference: line_detection.py:212-244;
    the |angle| gate of geometry/lines.py:170-175). Returns
    (rotated_image, rotated mask, contours, angle). A 3-channel mask is
    read as BGR and made gray first; ``rgb_mask=True`` (the JAX default)
    returns the mask in 3 channels, and the pipeline passes False."""
    if line_mask.ndim == 3:
        line_mask = bgr_to_gray(line_mask)
    angle = calculate_rotation_angle_from_lines(line_mask)
    if abs(angle) > rot_threshold:
        out_mask = rotate_from_angle(line_mask, angle)
        out_img = rotate_from_angle(image, angle)
    else:
        out_mask, out_img = line_mask, image
    line_contours = [
        x for x in get_contours(out_mask) if geo.contour_area(x) > 10
    ]
    if rgb_mask:
        out_mask = np.repeat(out_mask[..., None], 3, axis=2)
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


def get_line_image_from_mask(
    image: np.ndarray,
    mask: np.ndarray,
    bbox_h: int,
    bbox_tolerance: float = 2.5,
    k_factor: float = 1.2,
) -> tuple[np.ndarray, float]:
    """Adaptive strip extraction from an explicit full-page mask, for the
    local-TPS path where the mask has been warped (geometry/lines.py:
    302-340; reference: line_detection.py:291-327): dilate the mask with a
    rect of ``int(bbox_h * k)`` by ``int(int(bbox_h * k) * k)``, mask and
    crop the page, and shrink k by 0.1 (at most 10 times) until the strip
    is at most ``bbox_h * bbox_tolerance`` tall. A mask pixel counts where
    it is nonzero. The native packed-bit ROI over the whole page does the
    dilate + mask_n_crop of the JAX loop."""
    try:
        roi = PackedLineRoi(np.ascontiguousarray(image),
                            np.ascontiguousarray(mask))

        def kernel(k: float) -> tuple[int, int]:
            k_size = int(bbox_h * k)
            return max(k_size, 1), max(int(k_size * k), 1)

        tmp_k = kept_k = k_factor
        height = roi.attempt_height(*kernel(tmp_k))
        attempts = 0
        while height > bbox_h * bbox_tolerance and attempts < 10:
            tmp_k -= 0.1
            if tmp_k <= 0.1:
                break
            kept_k = tmp_k
            height = roi.attempt_height(*kernel(tmp_k))
            attempts += 1
        return roi.masked_crop(*kernel(kept_k)), tmp_k
    except Exception as e:  # parity: never let one line kill a page
        print(f"Error in get_line_image_from_mask: {e}", file=sys.stderr)
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
    threshold: float = 20,
    calculate_threshold: bool = True,
    group_lines: bool = True,
) -> tuple[list[Line], float]:
    """Reading-order sort with the slice-vote threshold (or ``threshold``
    when ``calculate_threshold`` is False) + optional chunk merge
    (reference: line_detection.py:551-634)."""
    centers = [line.center for line in lines]
    if calculate_threshold:
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


def bgr_to_gray(image: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(image, COLOR_BGR2GRAY) for (H, W, 3) uint8, byte-equal:
    the RGB weights on the reversed channels."""
    if image.dtype != np.uint8:
        raise TypeError(f"bgr_to_gray takes uint8, got {image.dtype}")
    rgb = np.ascontiguousarray(image[..., ::-1])
    return imaging.rgb_to_gray(torch.from_numpy(rgb)).numpy()


def sort_lines_by_peaks(
    line_mask: np.ndarray,
    lines: list[Line],
    group_lines: bool = True,
) -> tuple[list[Line], float]:
    """Reading order via horizontal projection-profile peaks, the
    LineSorting.PEAKS algorithm (geometry/lines.py:550-610): lines join
    their nearest row-sum peak, rows read top to bottom, chunks left to
    right. Returns (lines, min peak gap)."""
    if line_mask.ndim == 3:
        line_mask = bgr_to_gray(line_mask)
    if not lines:
        return [], 0.0

    profile = (line_mask > 0).sum(axis=1).astype(np.float64)
    heights = [line.bbox.h for line in lines]
    min_gap = max(int(np.median(heights) * 0.75), 4)
    k = max(min_gap // 2 * 2 + 1, 3)
    kernel = np.ones(k) / k
    smooth = np.convolve(profile, kernel, mode="same")

    floor = smooth.max() * 0.2
    peaks: list[int] = []
    for y in range(1, len(smooth) - 1):
        if smooth[y] < floor:
            continue
        if smooth[y] >= smooth[y - 1] and smooth[y] > smooth[y + 1]:
            if peaks and y - peaks[-1] < min_gap:
                if smooth[y] > smooth[peaks[-1]]:
                    peaks[-1] = y
                continue
            peaks.append(y)
    if not peaks:  # degenerate mask: single row
        peaks = [int(np.argmax(smooth))]

    rows: dict[int, list[tuple[int, int]]] = {i: [] for i in range(len(peaks))}
    arr = np.asarray(peaks)
    for line in lines:
        idx = int(np.argmin(np.abs(arr - line.center[1])))
        rows[idx].append(line.center)
    sorted_centers = [
        sorted(rows[i], key=lambda c: c[0])
        for i in range(len(peaks))
        if rows[i]
    ]
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
    return new_lines, float(min_gap)


# ---------------------------------------------------------------------------
# Misc geometry used by exporters
# ---------------------------------------------------------------------------

def rotate_contour(
    cnt: np.ndarray, center: tuple[int, int], angle: float
) -> np.ndarray:
    """Rotate contour points about a center by angle degrees, polar form
    (geometry/lines.py:615-637; reference: BDRC/utils.py:636-658). Each
    rotated coordinate is truncated toward zero relative to the center, as
    the reference's assignment into its int array does."""
    cx, cy = center
    cnt_norm = cnt - [cx, cy]
    coords = cnt_norm[:, 0, :].astype(np.float64)
    thetas = np.rad2deg(np.arctan2(coords[:, 1], coords[:, 0]))
    rhos = np.hypot(coords[:, 0], coords[:, 1])
    thetas = np.deg2rad((thetas + angle) % 360)
    xs = rhos * np.cos(thetas)
    ys = rhos * np.sin(thetas)
    out = cnt_norm.copy()
    out[:, 0, 0] = xs.astype(out.dtype)
    out[:, 0, 1] = ys.astype(out.dtype)
    return (out + [cx, cy]).astype(np.int32)


def get_text_bbox(lines: list[Line]) -> BBox:
    """Text-area bbox from line bboxes (geometry/lines.py:640-648),
    with the reference's max-w / last-line-h semantics."""
    all_bboxes = [line.bbox for line in lines]
    min_x = min(b.x for b in all_bboxes)
    min_y = min(b.y for b in all_bboxes)
    max_w = max(b.w for b in all_bboxes)
    max_h = all_bboxes[-1].y + all_bboxes[-1].h
    return BBox(min_x, min_y, max_w, max_h)


def get_union_bbox(contours: list[np.ndarray]):
    """Union axis-aligned + rotated bbox over contours
    (geometry/lines.py:651-664)."""
    if len(contours) == 0:
        return None, None
    all_points = np.vstack(contours)
    x, y, w, h = geo.bounding_rect(all_points)
    bbox = BBox(x, y, w, h)
    (cx, cy), (width, height), angle = geo.min_area_rect(all_points)
    points = geo.box_points(((cx, cy), (width, height), angle)).astype(np.int32)
    return bbox, RotatedBBox((float(cx), float(cy)), width, height, angle,
                             points)


def contour_to_cv(contour) -> np.ndarray:
    """[(x, y), ...] -> cv2-shaped (N, 1, 2) int32 contour
    (geometry/lines.py:673-677)."""
    return np.asarray(contour, dtype=np.int32).reshape(-1, 1, 2)


def contour_to_original(contour, scale_x: float, scale_y: float):
    """Rescale [(x, y), ...] from detection to original resolution
    (geometry/lines.py:680-686)."""
    return [
        (int(round(x / scale_x)), int(round(y / scale_y))) for x, y in contour
    ]


def bbox_to_original(bbox, scale_x: float, scale_y: float):
    """Rescale an (x, y, w, h) rect from detection to original resolution
    (geometry/lines.py:689-700)."""
    x, y, w, h = bbox
    return (
        int(round(x / scale_x)),
        int(round(y / scale_y)),
        int(round(w / scale_x)),
        int(round(h / scale_y)),
    )
