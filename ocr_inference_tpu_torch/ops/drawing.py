"""cv2's drawing routines that the synthetic glyphs use, in cv2's own
integer arithmetic.

The JAX package draws each glyph of its synthetic script with three cv2
calls (eval/synthetic.py:62-103): ``cv2.line`` and ``cv2.ellipse`` arcs at
thickness 2-3 and the filled ``cv2.circle``, all LINE_8 without a shift.
cv2 draws them in 16-bit fixed point (imgproc/drawing.cpp):

- a thick line is clipped to the image grown by its thickness, then
  drawn as a filled convex quadrilateral about the segment (``ThickLine``
  -> ``FillConvexPoly``, its outline drawn first with the fixed-point
  ``Line2``) plus round caps, the filled ``Circle`` of radius
  ``(thickness + 1) // 2`` at each end the flags ask for;
- an arc is ``ellipse2Poly``'s polyline, its points from cv2's table of
  sines at whole degrees (single precision), each segment a thick line
  with a cap at its end (``PolyLine``);
- the filled circle is the midpoint routine of ``fill_circle``.

Every function draws in place on an (H, W) or (H, W, C) uint8 array and
equals the cv2 call byte for byte (tests/test_torch_train_data.py holds
each primitive and every glyph against cv2). Python ints stand in for
cv2's int64 arithmetic; ``_round`` is cvRound (half to even) and
``_trunc_div`` C's division.
"""

from __future__ import annotations

import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
HALF_ONE = XY_ONE >> 1
DBL_EPSILON = 2.220446049250313e-16

# drawing.cpp's SinTable: sin of 0..450 whole degrees, as float literals
# of seven decimals
SIN_TABLE = np.round(np.sin(np.radians(np.arange(451))), 7).astype(np.float32)


def _round(v: float) -> int:
    """cvRound: to the nearest integer, halves to even."""
    return int(round(v))


def _trunc_div(n: int, d: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(n) // abs(d)
    return q if (n >= 0) == (d >= 0) else -q


def _put(img: np.ndarray, x: int, y: int, color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def clip_line(w: int, h: int, p1: list, p2: list) -> bool:
    """cv2.clipLine for an image of size (w, h) in whatever units the
    points are in; clips ``p1``/``p2`` ([x, y] lists) in place and tells
    whether anything of the segment is left."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False
    x1, y1 = p1
    x2, y2 = p2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    p1[:] = [x1, y1]
    p2[:] = [x2, y2]
    return (c1 | c2) == 0


def line2(img: np.ndarray, pt1, pt2, color) -> None:
    """cv2's ``Line2``, with which ``FillConvexPoly`` draws a polygon's
    outline: a one-pixel LINE_8 line between two points in 16-bit fixed
    point, stepped along its major axis from the first point's rounded
    position, plus the rounded end point."""
    h, w = img.shape[:2]
    p1, p2 = [int(pt1[0]), int(pt1[1])], [int(pt2[0]), int(pt2[1])]
    if not clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2):
        return
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    major_x = abs(dx) > abs(dy)
    if (dx < 0) if major_x else (dy < 0):  # run forward on the major axis
        x1, x2, y1, y2 = x2, x1, y2, y1
        dx, dy = -dx, -dy
    if major_x:
        step = _trunc_div(dy << XY_SHIFT, dx | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        step = _trunc_div(dx << XY_SHIFT, dy | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += HALF_ONE
    y1 += HALF_ONE
    _put(img, (x2 + HALF_ONE) >> XY_SHIFT, (y2 + HALF_ONE) >> XY_SHIFT, color)
    if major_x:
        x1 >>= XY_SHIFT
        for _ in range(ecount + 1):
            _put(img, x1, y1 >> XY_SHIFT, color)
            x1 += 1
            y1 += step
    else:
        y1 >>= XY_SHIFT
        for _ in range(ecount + 1):
            _put(img, x1 >> XY_SHIFT, y1, color)
            x1 += step
            y1 += 1


def fill_convex_poly(img: np.ndarray, pts, color, shift: int = 0) -> None:
    """cv2.fillConvexPoly(img, pts, color, LINE_8, shift): the outline
    with ``Line2``, then the scanlines between the polygon's two edge
    chains."""
    v = [(int(x), int(y)) for x, y in pts]
    npts = len(v)
    h, w = img.shape[:2]
    delta = (1 << shift) >> 1
    up = XY_SHIFT - shift
    p0 = (v[-1][0] << up, v[-1][1] << up)
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (x, y) in enumerate(v):
        if y < ymin:
            ymin, imin = y, i
        ymax, xmax, xmin = max(ymax, y), max(xmax, x), min(xmin, x)
        p = (x << up, y << up)
        if shift == 0:
            raise NotImplementedError("fill_convex_poly draws shift > 0 only")
        line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per edge chain: [vertex index, direction, x, dx, last row]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y < e[4]:
                continue
            idx0, di = e[0], e[1]
            idx = (idx0 + di) % npts
            while True:
                more = edges > 0
                edges -= 1
                if not more:
                    break
                ty = (v[idx][1] + delta) >> shift
                if ty > y:
                    xs, xe = v[idx0][0] << up, v[idx][0] << up
                    e[4] = ty
                    e[3] = _trunc_div((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                    e[2] = xs
                    e[0] = idx
                    break
                idx0 = idx
                idx = (idx + di) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            xx1 = (edge[left][2] + HALF_ONE) >> XY_SHIFT
            xx2 = (edge[right][2] + HALF_ONE) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0): min(xx2, w - 1) + 1] = color
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def circle_spans(radius: int) -> list[tuple[int, int, int]]:
    """The rows of cv2's filled circle (its ``Circle`` midpoint routine,
    LINE_8, no shift): (dy, dx_lo, dx_hi) spans about the center, which
    overlap where cv2 draws a row twice."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    spans = []
    while dx >= dy:
        spans += [(-dy, -dx, dx), (dy, -dx, dx), (-dx, -dy, dy), (dx, -dy, dy)]
        dy += 1
        err += plus
        plus += 2
        step = 0 if err <= 0 else -1
        err -= minus & step
        dx += step
        minus -= step & 2
    return spans


def fill_circle(image: np.ndarray, center: tuple[int, int], radius: int,
                color) -> None:
    """In place: cv2.circle(image, center, radius, color, -1), clipped at
    the image edges as cv2 clips it."""
    h, w = image.shape[:2]
    cx, cy = center
    for dy, lo, hi in circle_spans(radius):
        y = cy + dy
        if 0 <= y < h:
            x0, x1 = max(cx + lo, 0), min(cx + hi, w - 1)
            if x0 <= x1:
                image[y, x0: x1 + 1] = color


def thick_line(img: np.ndarray, p0, p1, color, thickness: int, flags: int,
               shift: int) -> None:
    """cv2's ``ThickLine`` for thickness >= 2, LINE_8: the quadrilateral
    about the segment, then a round cap at p0 (flags & 1) and at p1
    (flags & 2)."""
    if thickness < 2:
        raise NotImplementedError("thick_line draws thickness >= 2 only")
    up = XY_SHIFT - shift
    p0 = (int(p0[0]) << up, int(p0[1]) << up)
    p1 = (int(p1[0]) << up, int(p1[1]) << up)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > DBL_EPSILON:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = _round(dy * r), _round(dx * r)
        quad = [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
                (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)]
        fill_convex_poly(img, quad, color, XY_SHIFT)
    cap = (thickness + HALF_ONE) >> XY_SHIFT
    for i, p in enumerate((p0, p1)):
        if flags & (i + 1):
            center = ((p[0] + HALF_ONE) >> XY_SHIFT,
                      (p[1] + HALF_ONE) >> XY_SHIFT)
            fill_circle(img, center, cap, color)


def line(img: np.ndarray, pt1, pt2, color, thickness: int,
         flags: int = 3) -> None:
    """cv2.line(img, pt1, pt2, color, thickness) for thickness >= 2: the
    segment clipped to the image grown by ``thickness`` on every side
    (nothing is drawn when none of it is left), then ``thick_line`` with
    the caps ``flags`` asks for (both for cv2.line; cv2.polylines draws
    each side so, with the cap at its end, flags 2)."""
    h, w = img.shape[:2]
    m = thickness
    p1 = [int(pt1[0]) + m, int(pt1[1]) + m]
    p2 = [int(pt2[0]) + m, int(pt2[1]) + m]
    if clip_line(w + 2 * m, h + 2 * m, p1, p2):
        thick_line(img, (p1[0] - m, p1[1] - m), (p2[0] - m, p2[1] - m),
                   color, thickness, flags, 0)


def ellipse2poly(center, axes, angle: int, arc_start: int, arc_end: int,
                 delta: int) -> list[tuple[float, float]]:
    """cv2's double ``ellipse2Poly``: the arc's points every ``delta``
    degrees, the last at ``arc_end``, from the single-precision sine
    table."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start += 360
        arc_end += 360
    while arc_end > 360:
        arc_end -= 360
        arc_start -= 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    a = angle + (360 if angle < 0 else 0)
    beta, alpha = float(SIN_TABLE[a]), float(SIN_TABLE[450 - a])
    cx, cy = float(center[0]), float(center[1])
    aw, ah = float(axes[0]), float(axes[1])
    pts = []
    for i in range(arc_start, arc_end + delta, delta):
        ang = min(i, arc_end)
        if ang < 0:
            ang += 360
        x = aw * float(SIN_TABLE[450 - ang])
        y = ah * float(SIN_TABLE[ang])
        pts.append((cx + x * alpha - y * beta, cy + x * beta + y * alpha))
    if len(pts) == 1:
        pts = [(cx, cy)] * 2
    return pts


def ellipse(img: np.ndarray, center, axes, angle: int, start_angle: int,
            end_angle: int, color, thickness: int) -> None:
    """cv2.ellipse(img, center, axes, angle, start, end, color, thickness)
    for whole-degree angles and thickness >= 2 (``EllipseEx`` ->
    ``PolyLine``)."""
    c = (int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT)
    ax = (abs(int(axes[0])) << XY_SHIFT, abs(int(axes[1])) << XY_SHIFT)
    size = (max(ax) + HALF_ONE) >> XY_SHIFT
    delta = 90 if size < 3 else 30 if size < 10 else 18 if size < 15 else 5
    v, prev = [], None
    for px, py in ellipse2poly(c, ax, _round(angle), _round(start_angle),
                               _round(end_angle), delta):
        bx = _round(px / XY_ONE) << XY_SHIFT
        by = _round(py / XY_ONE) << XY_SHIFT
        pt = (bx + _round(px - bx), by + _round(py - by))
        if pt != prev:
            v.append(pt)
            prev = pt
    if len(v) == 1:
        v = [c, c]
    # PolyLine, not closed: caps at both ends of the first segment, then
    # at the end of each later one
    flags = 3
    for p0, p1 in zip(v, v[1:]):
        thick_line(img, p0, p1, color, thickness, flags, XY_SHIFT)
        flags = 2
