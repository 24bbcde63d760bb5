"""The port's binarize kernel wrappers against the JAX Pallas kernels and
cv2.

On the CPU the wrappers run their plain PyTorch versions, which must be
bit-exact with ``binarize_tiles_pallas`` / ``binarize_lines_pallas`` (run
in interpret mode, as tests/test_pallas_engines.py runs them) and with
cv2.adaptiveThreshold. The CUDA kernel itself is held against the plain
version on the card (the ``cuda``-marked test; chip_smoke.py phase 2).
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_inference_tpu.ops import pallas_kernels as pk
from ocr_inference_tpu_torch.ops import kernels


def _page_like(rng, shape):
    img = np.full(shape, 235, np.uint8)
    h, w = shape[1], shape[2]
    x0 = min(40, w // 4)
    for y in range(h // 8, max(h - 30, h // 8 + 1), max(h // 4, 31)):
        band = img[:, y: y + 26, x0: w - x0]
        band[...] = rng.integers(20, 70, band.shape)
    noise = rng.integers(-10, 10, shape)
    return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["random", "page"])
def test_tiles_plain_matches_pallas_tile_kernel(kind):
    rng = np.random.default_rng(1)
    shape = (2, 512, 512, 3)
    t = (rng.integers(0, 256, shape, dtype=np.uint8) if kind == "random"
         else _page_like(rng, shape))
    want = np.asarray(pk.binarize_tiles_pallas(jnp.asarray(t)))
    got = kernels.binarize_tiles(torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [512, 1024, 2000])
def test_lines_plain_matches_pallas_line_kernel(width):
    rng = np.random.default_rng(width)
    g = rng.integers(0, 256, (2, 80, width), dtype=np.uint8)
    want = np.asarray(pk.binarize_lines_pallas(jnp.asarray(g)))
    got = kernels.binarize_lines(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(80, 512), (80, 2500), (80, 3000),
                                   (512, 512), (80, 51), (57, 333)])
def test_plain_matches_cv2_adaptive_threshold(shape):
    rng = np.random.default_rng(sum(shape))
    for g in (rng.integers(0, 256, shape, dtype=np.uint8),
              _page_like(rng, (1,) + shape)[0]):
        want = cv2.adaptiveThreshold(
            g, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C, cv2.THRESH_BINARY, 51, 13
        )
        got = kernels.binarize_lines(torch.from_numpy(g)[None]).numpy()[0]
        np.testing.assert_array_equal(got, want)


def test_tiles_fuse_cv2_gray_conversion():
    rng = np.random.default_rng(5)
    t = rng.integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)
    gray = cv2.cvtColor(t[0], cv2.COLOR_RGB2GRAY)
    want = cv2.adaptiveThreshold(
        gray, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C, cv2.THRESH_BINARY, 51, 13
    )
    got = kernels.binarize_tiles(torch.from_numpy(t)).numpy()[0]
    np.testing.assert_array_equal(got, want)


def test_cpu_path_counts_no_launch_and_checks_shapes():
    kernels.reset_launches()
    kernels.binarize_lines(torch.zeros((1, 80, 64), dtype=torch.uint8))
    kernels.binarize_tiles(torch.zeros((1, 64, 64, 3), dtype=torch.uint8))
    assert kernels.LAUNCHES == {"binarize_tiles": 0, "binarize_lines": 0}
    with pytest.raises(ValueError):
        kernels.binarize_tiles(torch.zeros((1, 64, 64), dtype=torch.uint8))
    with pytest.raises(ValueError):
        kernels.binarize_lines(torch.zeros((80, 64), dtype=torch.uint8))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    rng = np.random.default_rng(2)
    dev = torch.device("cuda")
    tiles = torch.from_numpy(
        rng.integers(0, 256, (4, 512, 512, 3), dtype=np.uint8)).to(dev)
    before = dict(kernels.LAUNCHES)
    np.testing.assert_array_equal(
        kernels.binarize_tiles(tiles).cpu().numpy(),
        kernels.binarize_tiles_plain(tiles).cpu().numpy(),
    )
    for w in (512, 1024, 2000, 2500, 3000):
        g = torch.from_numpy(
            rng.integers(0, 256, (8, 80, w), dtype=np.uint8)).to(dev)
        np.testing.assert_array_equal(
            kernels.binarize_lines(g).cpu().numpy(),
            kernels.binarize_lines_plain(g).cpu().numpy(),
        )
    assert kernels.LAUNCHES["binarize_tiles"] == before["binarize_tiles"] + 1
    assert kernels.LAUNCHES["binarize_lines"] == before["binarize_lines"] + 5
