"""Host (numpy) twins of the reference's image-op surface, counterpart of
ocr_inference_tpu/ops_host.py (reference: BDRC/utils.py:438-899).

Every function takes and returns numpy arrays on the host, as the JAX
module does; its cv2 calls are the port's cv2-equal torch ops run on CPU
tensors:

- cv2.adaptiveThreshold / cv2.threshold (``binarize_host``) ->
  ops/imaging.py ``binarize``, the binarize kernels' plain version at
  51/13;
- cv2.resize(INTER_LINEAR) of uint8 images (the resize family and the
  line canvas) -> ops/imaging.py ``resize_linear_u8``, cv2's integer
  arithmetic byte for byte.

The device twins of the tiling and the canvas are ops/tiling.py.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ocr_inference_tpu_torch.ops import imaging


def binarize_host(
    img: np.ndarray, adaptive: bool = True, block_size: int = 51, c: int = 13
) -> np.ndarray:
    """Adaptive Gaussian binarization of an RGB uint8 image, 3-channel
    0/255 output (reference: BDRC/utils.py:796-815); ``adaptive=False`` is
    the global threshold at 120."""
    return imaging.binarize(torch.from_numpy(np.ascontiguousarray(img)),
                            adaptive, block_size, c).numpy()


def normalize_host(image: np.ndarray) -> np.ndarray:
    """[0,255] -> [0,1] float32 (reference: BDRC/utils.py:781-793)."""
    return image.astype(np.float32) / 255.0


def sigmoid_host(x):
    """(reference: BDRC/utils.py:563-573)."""
    return 1.0 / (1.0 + np.exp(-x))


# ---------------------------------------------------------------------------
# Resize family (reference: BDRC/utils.py:438-495). The non-target dimension
# truncates (int()), matching the reference; interpolation is INTER_LINEAR.
# ---------------------------------------------------------------------------


def resize_image(image: np.ndarray, target_width: int,
                 target_height: int) -> np.ndarray:
    """cv2.resize(image, (target_width, target_height), INTER_LINEAR) of a
    (H, W[, C]) uint8 image (reference: BDRC/utils.py:438-443); one
    channel comes back 2-D, as from cv2."""
    if image.dtype != np.uint8:
        raise TypeError(f"resize_image takes uint8, got {image.dtype}")
    out = imaging.resize_linear_u8(
        torch.from_numpy(np.ascontiguousarray(image)), target_height,
        target_width).numpy()
    return out[..., 0] if out.ndim == 3 and out.shape[2] == 1 else out


def resize_to_height(image: np.ndarray, target_height: int) -> tuple[np.ndarray, float]:
    """Aspect-preserving resize to a height; returns (image, scale)
    (reference: BDRC/utils.py:457-474)."""
    scale = target_height / image.shape[0]
    return resize_image(image, int(image.shape[1] * scale), target_height), scale


def resize_to_width(image: np.ndarray,
                    target_width: int = 2048) -> tuple[np.ndarray, float]:
    """Aspect-preserving resize to a width; returns (image, scale)
    (reference: BDRC/utils.py:477-494)."""
    scale = target_width / image.shape[1]
    return resize_image(image, target_width, int(image.shape[0] * scale)), scale


# ---------------------------------------------------------------------------
# Tiling arithmetic + page preprocessing (reference: BDRC/utils.py:497-560,
# 713-778). ops/tiling.py computes the same layout on tensors.
# ---------------------------------------------------------------------------


def calculate_steps(image: np.ndarray, patch_size: int = 512) -> tuple[int, int]:
    """(x_steps, y_steps) patch grid covering the image
    (reference: BDRC/utils.py:497-515)."""
    h, w = image.shape[:2]
    return math.ceil(w / patch_size), math.ceil(h / patch_size)


def calculate_paddings(
    image: np.ndarray, x_steps: int, y_steps: int, patch_size: int = 512
) -> tuple[int, int]:
    """(pad_x, pad_y) filling a given patch grid
    (reference: BDRC/utils.py:517-538)."""
    h, w = image.shape[:2]
    return x_steps * patch_size - w, y_steps * patch_size - h


def get_paddings(image: np.ndarray, patch_size: int = 512) -> tuple[int, int]:
    """(pad_x, pad_y) to the next patch multiple
    (reference: BDRC/utils.py:732-738)."""
    return calculate_paddings(image, *calculate_steps(image, patch_size), patch_size)


def pad_image(
    image: np.ndarray, pad_x: int, pad_y: int, pad_value: int = 0
) -> np.ndarray:
    """Constant-pad bottom/right (reference: BDRC/utils.py:540-560)."""
    return np.pad(
        image,
        ((0, pad_y), (0, pad_x), (0, 0)),
        mode="constant",
        constant_values=pad_value,
    )


def preprocess_image(
    image: np.ndarray,
    patch_size: int = 512,
    clamp_width: int = 4096,
    clamp_height: int = 2048,
    clamp_size: bool = True,
) -> tuple[np.ndarray, int, int]:
    """Clamp oversized pages, upscale short ones to >= patch_size, white-pad
    to a patch multiple; returns (image, pad_x, pad_y)
    (reference: BDRC/utils.py:741-778)."""
    h, w = image.shape[:2]
    if clamp_size and w > h and w > clamp_width:
        image, _ = resize_to_width(image, clamp_width)
    elif clamp_size and h > w and h > clamp_height:
        image, _ = resize_to_height(image, clamp_height)
    elif h < patch_size:
        image, _ = resize_to_height(image, patch_size)
    pad_x, pad_y = get_paddings(image, patch_size)
    return pad_image(image, pad_x, pad_y, pad_value=255), pad_x, pad_y


def tile_image(padded_img: np.ndarray,
               patch_size: int = 512) -> tuple[list[np.ndarray], int]:
    """Row-major patch_size² tiles of an exactly-padded image; returns
    (tiles, y_steps) (reference: BDRC/utils.py:713-721)."""
    h, w = padded_img.shape[:2]
    ys, xs = h // patch_size, w // patch_size
    grid = padded_img.reshape(ys, patch_size, xs, patch_size, -1).swapaxes(1, 2)
    tiles = grid.reshape(ys * xs, patch_size, patch_size, *padded_img.shape[2:])
    return list(tiles), ys


def stitch_predictions(prediction: np.ndarray, y_steps: int) -> np.ndarray:
    """Inverse of tile_image over a (N, p, p[, C]) prediction stack
    (reference: BDRC/utils.py:724-729)."""
    n, p = prediction.shape[0], prediction.shape[1]
    xs = n // y_steps
    grid = prediction.reshape(y_steps, xs, *prediction.shape[1:]).swapaxes(1, 2)
    return grid.reshape(y_steps * p, xs * p, *prediction.shape[3:])


def resize_clamp(
    img: np.ndarray, patch_size: int = 512, max_w: int = 4096, max_h: int = 2048
) -> tuple[np.ndarray, float, float]:
    """Clamp/upscale with exact per-axis scale factors; returns
    (image, scale_x, scale_y), the target shape rounded as the reference's
    torch-path clamp rounds it (BDRC/utils.py:967-1000)."""
    h, w = img.shape[:2]
    if w > h and w > max_w:
        scale = max_w / w
    elif h > w and h > max_h:
        scale = max_h / h
    elif h < patch_size:
        scale = patch_size / h
    else:
        return img, 1.0, 1.0
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    return resize_image(img, new_w, new_h), new_w / w, new_h / h


# ---------------------------------------------------------------------------
# Polar helpers + line-canvas padding (reference: BDRC/utils.py:624-633,
# 818-899). The device twin of the canvas is ops/tiling.py:pad_ocr_line.
# ---------------------------------------------------------------------------


def pol2cart(theta, rho):
    """(reference: BDRC/utils.py:624-627)."""
    return rho * np.cos(theta), rho * np.sin(theta)


def cart2pol(x, y):
    """(reference: BDRC/utils.py:630-633)."""
    return np.arctan2(y, x), np.hypot(x, y)


def _center_band(img: np.ndarray, target: int, axis: int, padding: str) -> np.ndarray:
    fill = 255 if padding == "white" else 0
    lead = (target - img.shape[axis]) // 2
    shapes = []
    for n in (lead, target - img.shape[axis] - lead):
        shape = list(img.shape)
        shape[axis] = n
        shapes.append(np.full(shape, fill, dtype=np.uint8))
    return np.concatenate([shapes[0], img, shapes[1]], axis=axis)


def pad_to_width(
    img: np.ndarray, target_width: int, target_height: int, padding: str
) -> np.ndarray:
    """Resize to target width, center between horizontal bands
    (reference: BDRC/utils.py:818-845)."""
    tmp, _ = resize_to_width(img, target_width)
    return _center_band(tmp, target_height, 0, padding)


def pad_to_height(
    img: np.ndarray, target_width: int, target_height: int, padding: str
) -> np.ndarray:
    """Resize to target height, center between vertical bands
    (reference: BDRC/utils.py:848-876)."""
    tmp, _ = resize_to_height(img, target_height)
    return _center_band(tmp, target_width, 1, padding)


def pad_ocr_line(
    img: np.ndarray,
    target_width: int = 3000,
    target_height: int = 80,
    padding: str = "black",
) -> np.ndarray:
    """Aspect-preserving pad of a line strip into the recognizer canvas
    (reference: BDRC/utils.py:879-899). Ties go to the width path."""
    if target_width / img.shape[1] <= target_height / img.shape[0]:
        out = pad_to_width(img, target_width, target_height, padding)
    else:
        out = pad_to_height(img, target_width, target_height, padding)
    return resize_image(out, target_width, target_height)
