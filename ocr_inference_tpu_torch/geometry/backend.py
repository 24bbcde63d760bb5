"""Topology primitives, served by the port's native C++ library only.

Counterpart of ocr_inference_tpu/geometry/backend.py without its cv2
fallback (the card machine has no OpenCV): every primitive goes to
``ocr_inference_tpu_torch.native`` (geometry.cpp), whose parity with cv2 the
JAX package pins (tests/test_geometry_backend.py) and this port's tests
re-check against the JAX backend. So ``use_native`` is always True and
``set_backend`` refuses the cv2 backend.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ocr_inference_tpu_torch import native


def use_native() -> bool:
    """True: the C++ library serves every primitive (backend.py:53-71)."""
    return True


def set_backend(native: Optional[bool]) -> None:
    """The JAX switch between the C++ library and cv2 (backend.py:74-76):
    None and True keep the library; False raises, the port has no cv2
    backend."""
    if native is False:
        raise ValueError("the port has no cv2 geometry backend: "
                         "set_backend takes None or True")


def find_contours(mask: np.ndarray) -> Sequence[np.ndarray]:
    """Outer contours of a binary mask in cv2.findContours(RETR_LIST,
    CHAIN_APPROX_SIMPLE) order (bottom-up), points (N, 1, 2) int32."""
    return list(reversed(native.find_contours(mask)))


def contour_area(contour: np.ndarray) -> float:
    return native.contour_area(contour)


def line_threshold(mask: np.ndarray, slice_width: int = 20) -> float:
    return native.line_threshold(mask, slice_width)


def _is_point_array(arr: np.ndarray) -> bool:
    """Contours are (N, 1, 2) or (N, 2) integer point lists; 2-D uint8 or
    float arrays are images (geometry/backend.py:78-84)."""
    if arr.ndim == 3:
        return True
    return arr.ndim == 2 and arr.shape[1] == 2 and arr.dtype.kind in "iu" \
        and arr.dtype.itemsize >= 2


def bounding_rect(points_or_mask: np.ndarray) -> tuple[int, int, int, int]:
    """(x, y, w, h) of a contour's points, or of the nonzero pixels of a
    2-D image (cv2.boundingRect accepts both)."""
    arr = np.asarray(points_or_mask)
    if _is_point_array(arr):
        return native.bounding_rect(arr)
    rows = np.flatnonzero(arr.any(axis=1))
    cols = np.flatnonzero(arr.any(axis=0))
    if rows.size == 0:
        return (0, 0, 0, 0)
    return (int(cols[0]), int(rows[0]), int(cols[-1] - cols[0] + 1),
            int(rows[-1] - rows[0] + 1))


def convex_hull(points: np.ndarray) -> np.ndarray:
    return native.convex_hull(points)


def min_area_rect(points: np.ndarray):
    """((cx, cy), (w, h), angle) in cv2 5.x's convention."""
    return native.min_area_rect(points)


def box_points(rect) -> np.ndarray:
    """Corner points of a ((cx, cy), (w, h), angle) rect (cv2.boxPoints
    order; the JAX backend's native branch, backend.py:160-177)."""
    (cx, cy), (w, h), angle = rect
    a = np.deg2rad(angle)
    ux = np.array([np.cos(a), np.sin(a)])
    uy = np.array([-np.sin(a), np.cos(a)])
    c = np.array([cx, cy])
    half_w, half_h = w / 2.0, h / 2.0
    corners = np.stack([
        c - ux * half_w - uy * half_h,
        c + ux * half_w - uy * half_h,
        c + ux * half_w + uy * half_h,
        c - ux * half_w + uy * half_h,
    ])
    return corners.astype(np.float32)


def arc_length(contour: np.ndarray, closed: bool = True) -> float:
    return native.arc_length(contour, closed)


def approx_poly_dp(contour: np.ndarray, epsilon: float,
                   closed: bool = True) -> np.ndarray:
    return native.approx_poly_dp(contour, epsilon, closed)


def fill_contour(mask: np.ndarray, contour: np.ndarray, value: int = 255) -> None:
    """cv2.drawContours(mask, [contour], -1, value, -1), in place."""
    native.fill_contour(mask, contour, value)


def moments_centroid(contour: np.ndarray) -> tuple[int, int]:
    """Polygon centroid via Green's theorem (cv2.moments m10/m00, m01/m00;
    backend.py:194-209, its native branch; reference call site:
    BDRC/utils.py:695-697)."""
    pts = np.asarray(contour).reshape(-1, 2).astype(np.float64)
    x, y = pts[:, 0], pts[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    cross = x * yn - xn * y
    a = cross.sum() / 2.0
    if a == 0.0:
        return int(x.mean()), int(y.mean())
    cx = ((x + xn) * cross).sum() / (6.0 * a)
    cy = ((y + yn) * cross).sum() / (6.0 * a)
    return int(cx), int(cy)
