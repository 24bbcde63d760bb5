"""Topology primitives, served by the port's native C++ library only.

Counterpart of ocr_inference_tpu/geometry/backend.py without its cv2
fallback (the card machine has no OpenCV): every primitive goes to
``ocr_inference_tpu_torch.native`` (geometry.cpp), whose parity with cv2 the
JAX package pins (tests/test_geometry_backend.py) and this port's tests
re-check against the JAX backend.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ocr_inference_tpu_torch import native


def find_contours(mask: np.ndarray) -> Sequence[np.ndarray]:
    """Outer contours of a binary mask in cv2.findContours(RETR_LIST,
    CHAIN_APPROX_SIMPLE) order (bottom-up), points (N, 1, 2) int32."""
    return list(reversed(native.find_contours(mask)))


def contour_area(contour: np.ndarray) -> float:
    return native.contour_area(contour)


def line_threshold(mask: np.ndarray, slice_width: int = 20) -> float:
    return native.line_threshold(mask, slice_width)


def bounding_rect(points: np.ndarray) -> tuple[int, int, int, int]:
    """(x, y, w, h) of a contour's points (cv2.boundingRect)."""
    return native.bounding_rect(np.asarray(points))


def convex_hull(points: np.ndarray) -> np.ndarray:
    return native.convex_hull(points)


def min_area_rect(points: np.ndarray):
    """((cx, cy), (w, h), angle) in cv2 5.x's convention."""
    return native.min_area_rect(points)


def arc_length(contour: np.ndarray, closed: bool = True) -> float:
    return native.arc_length(contour, closed)


def approx_poly_dp(contour: np.ndarray, epsilon: float,
                   closed: bool = True) -> np.ndarray:
    return native.approx_poly_dp(contour, epsilon, closed)


def fill_contour(mask: np.ndarray, contour: np.ndarray, value: int = 255) -> None:
    """cv2.drawContours(mask, [contour], -1, value, -1), in place."""
    native.fill_contour(mask, contour, value)
