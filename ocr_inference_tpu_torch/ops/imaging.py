"""Dense image ops as plain PyTorch functions on tensors.

Counterpart of ocr_inference_tpu/ops/imaging.py plus the cv2 pixel calls the
JAX package makes on the host (geometry/lines.py:54-55 warpAffine,
ops_host.py:58 resize). Every function takes tensors on any device and
returns tensors on the same device:

- ``normalize`` / ``sigmoid``: elementwise (imaging.py:32-39);
- ``rgb_to_gray``: cv2 5.x RGB2GRAY, 15-bit fixed point (imaging.py:42-51);
- ``gaussian_kernel_1d``: cv2.getGaussianKernel taps;
- ``gaussian_blur_gray``: the separable Gaussian blur with a replicate
  border at any odd ksize (imaging.py:72-92), summed in float64;
- ``adaptive_threshold_gaussian``: cv2.adaptiveThreshold GAUSSIAN_C at any
  block size and C (imaging.py:95-112); at 51/13 the plain version of the
  binarize kernels (ops/kernels.py);
- ``binarize``: RGB -> 3-channel 0/255 (imaging.py:115-131); at 51/13 it
  runs the binarize kernel on a card tensor;
- ``dilate_rect`` / ``erode_rect``: cv2.dilate / cv2.erode with a rect
  kernel (imaging.py:294-336);
- ``resize_bilinear``: the JAX float resize (imaging.py:138-176) used on
  page tensors and the detection post chain;
- ``resize_linear_u8``: cv2.resize INTER_LINEAR on uint8 in cv2's own
  integer arithmetic (what pad_ocr_line needs, ops_host.py:58);
- ``warp_affine`` / ``rotate_from_angle``: cv2 5.x warpAffine INTER_LINEAR
  with a constant border, byte for byte (geometry/lines.py:54-55);
- ``bilinear_sample`` / ``remap``: the JAX float sampler with the strict
  border and its resample (imaging.py:204-257, :343-357), which the TPS
  dewarp runs on the card;
- ``remap_linear_u8``: cv2 5.x remap INTER_LINEAR with float32 maps and a
  constant border on uint8, byte for byte (what the eval pages' curve
  distortion needs, eval/synthetic.py:228-236).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ocr_inference_tpu_torch.core.config import BINARIZE_BLOCK as BLOCK
from ocr_inference_tpu_torch.core.config import BINARIZE_C

C = float(BINARIZE_C)
HALF = BLOCK // 2


def normalize(image: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1] (reference: BDRC/utils.py:781-793)."""
    return image.to(torch.float32) / 255.0


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Logistic sigmoid (reference: BDRC/utils.py:563-573)."""
    return torch.sigmoid(x)


def rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 RGB -> (...) uint8 gray:
    ``(R*9798 + G*19235 + B*3735 + 16384) >> 15`` (cv2 5.x, bit-exact)."""
    img = image.to(torch.int32)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return ((r * 9798 + g * 19235 + b * 3735 + 16384) >> 15).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(ksize: int = BLOCK, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel: sigma<=0 -> 0.3*((ksize-1)*0.5 - 1) + 0.8;
    float32 taps, as the JAX package computes them."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def blur_in_order(gray: torch.Tensor, dtype: torch.dtype, ksize: int = BLOCK,
                  sigma: float = 0.0) -> torch.Tensor:
    """(B, H, W) gray -> (B, H, W) Gaussian blur in ``dtype`` with a
    replicate border and ``gaussian_kernel_1d(ksize, sigma)``'s float32
    taps: over rows (the vertical pass, ``L @ gray``), then over columns
    (``@ R``), each tap added in order t = 0..ksize-1 as a separately
    rounded product and sum (no fused multiply-add)."""
    h, w = gray.shape[-2], gray.shape[-1]
    half = ksize // 2
    g = gray.to(dtype)
    taps = torch.from_numpy(gaussian_kernel_1d(ksize, sigma)).to(
        device=g.device, dtype=dtype)
    rows = torch.arange(h, device=g.device)
    cols = torch.arange(w, device=g.device)
    acc = None
    for t in range(ksize):
        idx = (rows + (t - half)).clamp(0, h - 1)
        term = g[:, idx, :] * taps[t]
        acc = term if acc is None else acc + term
    vert = acc
    acc = None
    for t in range(ksize):
        idx = (cols + (t - half)).clamp(0, w - 1)
        term = vert[:, :, idx] * taps[t]
        acc = term if acc is None else acc + term
    return acc


# cv2 5.x's float32 separable filter runs its row pass in 8- and then 4-
# pixel vector steps with FMA and the rest of a row in scalar code (product
# and sum rounded apart); its column pass fuses in 8-pixel steps only
ROW_FMA_STEP, COL_FMA_STEP = 4, 8


def blur_cv2(gray: torch.Tensor, ksize: int = BLOCK,
             sigma: float = 0.0) -> torch.Tensor:
    """(B, H, W) gray -> (B, H, W) float32: cv2.GaussianBlur of the float
    image with ``gaussian_kernel_1d(ksize, sigma)``'s taps and
    BORDER_REPLICATE | BORDER_ISOLATED, in cv2 5.x's own float32
    arithmetic (at 51 the Gaussian mean of cv2.adaptiveThreshold):

    - the row pass first: per output column the taps left to right,
      each fused (``fma32``) for columns below 4 * (W // 4) and a rounded
      product added with a rounding beyond (the scalar tail);
    - then the column pass: the centre row times the centre tap, then for
      j = 1..ksize // 2 the rows j above and below added (one rounding)
      and multiplied in, fused for columns below 8 * (W // 8);
    - a one-row image has no column pass, a one-column image no row
      pass.

    Bit for bit cv2's on integer gray from ksize 9 up (11 up with sigma
    <= 0, where cv2 5.0 takes fixed taps up to 9 and the JAX package, and
    so this port, computes them); below 9 cv2 runs other filter loops."""
    b, h, w = gray.shape
    half = ksize // 2
    taps = torch.from_numpy(gaussian_kernel_1d(ksize, sigma)).to(gray.device)
    g = gray.to(torch.float32)
    rows = g
    if w > 1:
        cols = torch.arange(w, device=g.device)
        fused = ROW_FMA_STEP * (w // ROW_FMA_STEP)

        def tap(t, part):
            return g[:, :, (cols[part] + (t - half)).clamp(0, w - 1)]

        head_cols, tail_cols = slice(0, fused), slice(fused, w)
        head = tap(0, head_cols) * taps[0]
        tail = tap(0, tail_cols) * taps[0]
        # a fused row tap in float64 is exact before its one rounding: the
        # integer gray times a tap of at least 2^-21 (at 51 each is at
        # least 2^-12) plus a partial sum that is 0 or at least the
        # smallest tap spans under 53 bits
        taps64 = taps.to(torch.float64)
        for t in range(1, ksize):
            head = (tap(t, head_cols).to(torch.float64) * taps64[t]
                    + head.to(torch.float64)).to(torch.float32)
            tail = tail + tap(t, tail_cols) * taps[t]
        rows = torch.cat([head, tail], dim=2)
    if h == 1:
        return rows
    r = torch.arange(h, device=g.device)
    fused = COL_FMA_STEP * (w // COL_FMA_STEP)
    acc = rows * taps[half]
    head, tail = acc[:, :, :fused], acc[:, :, fused:]
    for j in range(1, half + 1):
        pair = (rows[:, (r + j).clamp(max=h - 1)]
                + rows[:, (r - j).clamp(min=0)])
        if fused:
            head = fma32(pair[:, :, :fused], taps[half + j], head)
        if fused < w:
            tail = tail + pair[:, :, fused:] * taps[half + j]
    return torch.cat([head, tail], dim=2)


def gaussian_blur_gray(gray: torch.Tensor, ksize: int,
                       sigma: float = 0.0) -> torch.Tensor:
    """(..., H, W) gray -> (..., H, W) float32: the separable Gaussian blur
    at an odd ``ksize`` with a replicate border and the JAX float32 taps
    (imaging.py:72-92), each image with its own border. Summed in float64
    and rounded once, so it lies within half a float32 step of the exact
    blur, and the CPU and the card compute it alike. (cv2's own float32
    order, which ``adaptive_threshold_gaussian`` needs, lies up to 1e-4
    from the exact blur at ksize 51.)"""
    if ksize % 2 != 1:
        raise ValueError(f"ksize must be odd, got {ksize}")
    shape = gray.shape
    out = blur_in_order(gray.reshape(-1, shape[-2], shape[-1]),
                        torch.float64, ksize, sigma)
    return out.to(torch.float32).reshape(shape)


def adaptive_threshold_gaussian(gray: torch.Tensor, max_value: float = 255.0,
                                block_size: int = BLOCK,
                                c: float = C) -> torch.Tensor:
    """(..., H, W) uint8 gray -> (..., H, W) uint8 0/``max_value``:
    cv2.adaptiveThreshold(ADAPTIVE_THRESH_GAUSSIAN_C, THRESH_BINARY) with
    the JAX signature (imaging.py:95-112), each image blurred with its own
    replicate border: ``blur_cv2``'s float32 mean rounded half to even
    and clipped to 0..255, and ``max_value`` where gray > mean - c.

    At 51/13 this is the plain version of the binarize kernels
    (csrc/binarize.cu), which blur in float32 in their own order and
    recompute, in exactly this arithmetic, every pixel whose sum lies near
    its threshold, so they equal this bit for bit."""
    shape = gray.shape
    h, w = shape[-2], shape[-1]
    g = gray.reshape(-1, h, w)
    mean = torch.round(blur_cv2(g, block_size)).clamp(0.0, 255.0)
    out = torch.where(g.to(torch.float32) > mean - c, max_value, 0.0)
    return out.to(torch.uint8).reshape(shape)


def binarize(image: torch.Tensor, adaptive: bool = True,
             block_size: int = BLOCK, c: float = C) -> torch.Tensor:
    """(H, W, 3) uint8 RGB -> (H, W, 3) uint8 0/255, the mask repeated to
    three channels (imaging.py:115-131; reference: BDRC/utils.py:796-815).

    Adaptive 51/13, the pipeline's rule, runs the binarize kernel
    (ops/kernels.py ``binarize_tiles`` on the page as one tile of any
    size): on a card tensor the hand-written kernel, on a CPU tensor its
    plain version. Any other block size or C is ``adaptive_threshold_gaussian``
    in torch ops, and ``adaptive=False`` the global threshold gray > 120,
    as the JAX package computes both in XLA rather than Pallas."""
    if adaptive and block_size == BLOCK and c == C:
        from ocr_inference_tpu_torch.ops import kernels

        bw = kernels.binarize_tiles(image[None])[0]
    elif adaptive:
        bw = adaptive_threshold_gaussian(rgb_to_gray(image), 255.0,
                                         block_size, c)
    else:
        bw = torch.where(rgb_to_gray(image) > 120, 255, 0).to(torch.uint8)
    return bw[..., None].expand(*bw.shape, 3).contiguous()


# ---------------------------------------------------------------------------
# Resize
# ---------------------------------------------------------------------------

def resize_bilinear(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(H, W[, C]) bilinear resize with the JAX package's float arithmetic
    (imaging.py:138-176: half-pixel centers, clamped borders, float32,
    round for integer outputs). Identity at scale 1."""
    h, w = image.shape[0], image.shape[1]
    if (h, w) == (height, width):
        return image
    dev = image.device
    img = image.to(torch.float32)
    ys = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) * (
        h / height) - 0.5
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) * (
        w / width) - 0.5
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    wy = torch.where(y0f < 0, 0.0, ys - y0f)
    wx = torch.where(x0f < 0, 0.0, xs - x0f)
    y0 = y0f.to(torch.int64).clamp(0, h - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x0 = x0f.to(torch.int64).clamp(0, w - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    if img.ndim == 3:
        wx_, wy_ = wx[None, :, None], wy[:, None, None]
    else:
        wx_, wy_ = wx[None, :], wy[:, None]
    top = img[y0][:, x0] * (1 - wx_) + img[y0][:, x1] * wx_
    bot = img[y1][:, x0] * (1 - wx_) + img[y1][:, x1] * wx_
    out = top * (1 - wy_) + bot * wy_
    if not image.dtype.is_floating_point:
        info = torch.iinfo(image.dtype)
        out = torch.round(out).clamp(info.min, info.max)
    return out.to(image.dtype)


def _linear_coeffs(dst: int, src: int, clamp_weights: bool, device):
    """cv2 resize INTER_LINEAR tap indices and 11-bit weights along one axis:
    ``f = float32((d + 0.5) * src/dst - 0.5)``, ``s = floor(f)``,
    weights ``rint((1 - f) * 2048)`` and ``rint(f * 2048)`` in float32.
    cv2 zeroes the fraction at the borders of the horizontal pass only; the
    vertical pass clamps the row indices and keeps its fraction."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        lo = s < 0
        f[lo], s[lo] = 0.0, 0
        hi = s >= src - 1
        f[hi], s[hi] = 0.0, src - 1
    c0 = np.rint((np.float32(1.0) - f) * np.float32(2048.0)).astype(np.int64)
    c1 = np.rint(f * np.float32(2048.0)).astype(np.int64)
    s0 = np.clip(s, 0, src - 1)
    s1 = np.clip(s + 1, 0, src - 1)
    return [torch.from_numpy(a).to(device) for a in (s0, s1, c0, c1)]


def resize_linear_u8(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """cv2.resize(INTER_LINEAR) on a (H, W[, C]) uint8 tensor, in cv2's own
    integer arithmetic: a horizontal pass with 11-bit weights into int32
    rows, then the vertical pass as cv2's SIMD path rounds it,
    ``((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16) + 2 >> 2``."""
    h, w = image.shape[0], image.shape[1]
    if (h, w) == (height, width):
        return image.clone()
    dev = image.device
    src = image.to(torch.int64)
    if src.ndim == 2:
        src = src[..., None]
    xs0, xs1, a0, a1 = _linear_coeffs(width, w, True, dev)
    ys0, ys1, b0, b1 = _linear_coeffs(height, h, False, dev)
    rows = src[:, xs0] * a0[None, :, None] + src[:, xs1] * a1[None, :, None]
    r0, r1 = rows[ys0], rows[ys1]
    out = (((r0 >> 4) * b0[:, None, None]) >> 16) + (
        ((r1 >> 4) * b1[:, None, None]) >> 16)
    out = ((out + 2) >> 2).clamp(0, 255).to(torch.uint8)
    return out if image.ndim == 3 else out[..., 0]


def resize_nearest_u8(image: np.ndarray, height: int, width: int
                      ) -> np.ndarray:
    """cv2.resize(INTER_NEAREST) of a (H, W[, C]) array: destination
    pixel (y, x) takes source pixel (min(floor(y / fy), H - 1),
    min(floor(x / fx), W - 1)) with fx = width / W and fy = height / H in
    double precision, as cv2's ``resizeNN`` computes them."""
    h, w = image.shape[:2]
    ifx, ify = 1.0 / (width / w), 1.0 / (height / h)
    xs = np.minimum(np.floor(np.arange(width) * ifx).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(height) * ify).astype(np.int64), h - 1)
    return image[ys][:, xs]


# ---------------------------------------------------------------------------
# Affine rotate (cv2.getRotationMatrix2D + warpAffine)
# ---------------------------------------------------------------------------

def rotation_matrix(center: tuple[float, float], angle_deg: float) -> np.ndarray:
    """cv2.getRotationMatrix2D with scale 1 (2x3, forward map)."""
    a = math.radians(angle_deg)
    alpha, beta = math.cos(a), math.sin(a)
    cx, cy = center
    return np.array(
        [
            [alpha, beta, (1 - alpha) * cx - beta * cy],
            [-beta, alpha, beta * cx + (1 - alpha) * cy],
        ],
        dtype=np.float64,
    )


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2.invertAffineTransform, in float64."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    return np.array([
        [a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
        [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]],
    ])


# cv2 5.x's warpAffine runs its vector loop over 16 output pixels at a time
# and computes the rest of each row in scalar code with other roundings
WARP_VECTOR_PIXELS = 16


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add ``a * b + c`` with one rounding, on
    tensors of any device.

    The product of two float32 values is exact in float64, so only the
    float64 sum rounds before the final rounding to float32. That double
    rounding can differ from one rounding only where the float64 sum lands
    exactly on a float32 midpoint while the exact sum does not; the sum's
    error, found exactly with TwoSum, then moves it one float64 step
    toward the exact value. The midpoint test reads the low 29 bits of the
    float64, which is right for normal float32 results; the warp's calls
    have one float32 factor that is an integer, so the exact sum is a
    multiple of 2**-149 and, below the normal range, exact in float64, and
    ``blur_cv2``'s column pass sums non-negative blurred gray, whose
    results are 0 or normal."""
    p = a.to(torch.float64) * b.to(torch.float64)
    cd = c.to(torch.float64)
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    low = s.view(torch.int64) & ((1 << 29) - 1)
    fix = (low == (1 << 28)) & (err != 0)
    if bool(fix.any()):
        toward = torch.where(err > 0, math.inf, -math.inf).to(s)
        s = torch.where(fix, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def warp_affine(
    image: torch.Tensor,
    m: np.ndarray,
    out_h: int,
    out_w: int,
    border_value: float = 0.0,
) -> torch.Tensor:
    """cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT) of a (H, W[, C]) uint8
    tensor, byte for byte; ``m`` is the forward 2x3 map as cv2 takes it.

    cv2 5.x's arithmetic: the inverse map in float64, cast to float32. In
    the vector loop the source x is ``fma(x, i00, i01*y + i02)``, the row
    term rounded without FMA; in the scalar rest of each row (x past the
    last whole group of ``WARP_VECTOR_PIXELS``) it is
    ``fma(x, i00, i01*y) + i02``; y likewise. The blend is
    ``v0 = fma(a, p01 - p00, p00)``, ``v1 = fma(a, p11 - p10, p10)``,
    ``fma(b, v1 - v0, v0)``, rounded half to even."""
    dev = image.device
    inv = _invert_affine(np.asarray(m, np.float64)).astype(np.float32)
    src = image if image.ndim == 3 else image[..., None]
    src = src.to(torch.float32)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    vector = xs < (out_w // WARP_VECTOR_PIXELS) * WARP_VECTOR_PIXELS

    def source(i0, i1, i2):
        i0 = torch.tensor(i0, device=dev)
        row = ys * float(i1)
        in_loop = fma32(xs, i0, row + float(i2))
        in_tail = fma32(xs, i0, row) + float(i2)
        return torch.where(vector, in_loop, in_tail)

    out = _blend_linear(src, source(*inv[0]), source(*inv[1]),
                        float(border_value)).to(image.dtype)
    return out if image.ndim == 3 else out[..., 0]


def _blend_linear(src: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                  border) -> torch.Tensor:
    """cv2 5.x's bilinear sample of a (H, W, C) float32 image at float32
    coordinates: taps at ``floor``, a tap outside the image reads
    ``border``, the blend
    ``v0 = fma(a, p01 - p00, p00)``, ``v1 = fma(a, p11 - p10, p10)``,
    ``fma(b, v1 - v0, v0)`` rounded half to even and clipped to uint8."""
    h, w = src.shape[0], src.shape[1]
    ix, iy = torch.floor(sx), torch.floor(sy)
    a = (sx - ix)[..., None]
    b = (sy - iy)[..., None]
    ix, iy = ix.to(torch.int64), iy.to(torch.int64)

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = src[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        return torch.where(ok[..., None], v, border)

    p00, p01 = tap(iy, ix), tap(iy, ix + 1)
    p10, p11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
    v0 = fma32(a, p01 - p00, p00)
    v1 = fma32(a, p11 - p10, p10)
    return torch.round(fma32(b, v1 - v0, v0)).clamp(0, 255).to(torch.uint8)


def rotate_from_angle(image: torch.Tensor, angle: float) -> torch.Tensor:
    """Rotate about (cols/2, rows/2), keeping the canvas, black border
    (reference: BDRC/line_detection.py:62-76)."""
    rows, cols = image.shape[0], image.shape[1]
    m = rotation_matrix((cols / 2, rows / 2), angle)
    return warp_affine(image, m, rows, cols, border_value=0.0)


# ---------------------------------------------------------------------------
# Morphology
# ---------------------------------------------------------------------------

def _rect_max(mask: torch.Tensor, kh: int, kw: int, iterations: int,
              sign: float) -> torch.Tensor:
    """``sign`` * the max of ``sign`` * mask over a kh x kw window, the
    window's rows from i - kh // 2 to i + kh - 1 - kh // 2 (cv2's centre
    anchor), outside pixels ignored, ``iterations`` times; (H, W) or
    (H, W, C), any dtype float32 holds exactly."""
    x = mask.to(torch.float32) * sign
    x = (x[None] if x.ndim == 2 else x.permute(2, 0, 1))[None]
    pad = (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2)
    for _ in range(iterations):
        x = F.max_pool2d(F.pad(x, pad, value=-math.inf), (kh, kw), stride=1)
    x = (x[0, 0] if mask.ndim == 2 else x[0].permute(1, 2, 0)) * sign
    return x.to(mask.dtype)


def dilate_rect(mask: torch.Tensor, kh: int, kw: int,
                iterations: int = 1) -> torch.Tensor:
    """cv2.dilate with a kh x kw all-ones rect kernel, anchor at its centre
    (imaging.py:294-314; reference: BDRC/line_detection.py:280-285)."""
    return _rect_max(mask, kh, kw, iterations, 1.0)


def erode_rect(mask: torch.Tensor, kh: int, kw: int,
               iterations: int = 1) -> torch.Tensor:
    """cv2.erode with a rect kernel, the border ignored (imaging.py:
    317-336)."""
    return _rect_max(mask, kh, kw, iterations, -1.0)


# ---------------------------------------------------------------------------
# Remap (general float-coordinate resample)
# ---------------------------------------------------------------------------

def bilinear_sample(image: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """Sample a (H, W[, C]) image at float32 coordinates (ys, xs) with
    bilinear interpolation and the strict border -> float32 (..., [C])
    (imaging.py:204-257 with ``strict_border=True``, border 0): any
    coordinate outside [0, size-1] gives 0 with no blending, as
    scipy.ndimage.map_coordinates(order=1, mode='constant') does
    (reference: BDRC/image_dewarping.py:64-72)."""
    h, w = image.shape[0], image.shape[1]
    img = image.to(torch.float32)
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0f, xs - x0f
    y0, x0 = y0f.to(torch.int64), x0f.to(torch.int64)
    y1, x1 = y0 + 1, x0 + 1

    def corner(yi, xi, wgt):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        if img.ndim == 3:
            valid, wgt = valid[..., None], wgt[..., None]
        return torch.where(valid, vals, 0.0) * wgt

    out = (
        corner(y0, x0, (1 - wy) * (1 - wx))
        + corner(y0, x1, (1 - wy) * wx)
        + corner(y1, x0, wy * (1 - wx))
        + corner(y1, x1, wy * wx)
    )
    inside = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    if img.ndim == 3:
        inside = inside[..., None]
    return torch.where(inside, out, 0.0)


def remap(image: torch.Tensor, map_y: torch.Tensor, map_x: torch.Tensor
          ) -> torch.Tensor:
    """Pull-resample ``out[i, j] = image(map_y[i, j], map_x[i, j])`` with the
    strict border; integer images are rounded half to even and clipped
    (imaging.py:343-357)."""
    out = bilinear_sample(image, map_y, map_x)
    if not image.dtype.is_floating_point:
        info = torch.iinfo(image.dtype)
        out = torch.round(out).clamp(info.min, info.max)
    return out.to(image.dtype)


def remap_linear_u8(image: torch.Tensor, map_x: torch.Tensor,
                    map_y: torch.Tensor, border_value: int = 0
                    ) -> torch.Tensor:
    """cv2.remap(image, map_x, map_y, INTER_LINEAR, BORDER_CONSTANT,
    border_value) for a (H, W[, C]) uint8 image and float32 maps, the same
    border value in every channel; byte for byte with cv2 5.x, which
    samples as its warpAffine does (``_blend_linear``)."""
    src = (image if image.ndim == 3 else image[..., None]).to(torch.float32)
    out = _blend_linear(src, map_x.to(torch.float32),
                        map_y.to(torch.float32), float(border_value))
    return out if image.ndim == 3 else out[..., 0]
