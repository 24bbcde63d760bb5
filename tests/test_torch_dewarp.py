"""The port's TPS dewarp (ocr_inference_tpu_torch/dewarp, on the CPU)
against the JAX package's dewarp/tps.py on the same inputs: the fit, the
maps, both warps and the choice between them, the curvature analysis,
apply_global_tps, run_tps and LOCAL mode, and the float sampler.

The JAX side is pinned to its device warp (``OCR_TPS_HOST=0``): the port
has no host warp. The warps are held to the JAX tests' own bar
(tests/test_dewarp.py:106-157): at most one gray level, and under 1e-3 of
the mask pixels differing, with the page's border left out. The JAX test
leaves out the edge columns, where the strict domain test decides on float
artifacts of an identity map (x = -1e-15 or w - 1 + 1e-15); the corner
anchors make the map the identity at the first and last rows too, and
there two float orders put y = h - 1 on either side of the domain's edge
(127.00002 against 127 on the overshooting fit below)."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_inference_tpu.dewarp import tps as T
from ocr_inference_tpu.geometry import lines as G
from ocr_inference_tpu.ops import imaging as jimg
from ocr_inference_tpu.ops.packing import pack_bits_host, unpack_mask
from ocr_inference_tpu_torch.dewarp import tps as P
from ocr_inference_tpu_torch.geometry import lines as PG
from ocr_inference_tpu_torch.ops import imaging


@pytest.fixture(autouse=True)
def _jax_device_warp(monkeypatch):
    monkeypatch.setenv("OCR_TPS_HOST", "0")


def _corners(h, w):
    return np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float64) * [h, w]


def _sine_fit(h, w, n=8, amp=18.0, y=140.0):
    """An x-preserving TPS, as the global dewarp fits one
    (test_dewarp.py:114-121)."""
    xs = np.linspace(20, w - 20, n)
    src = np.stack([y + amp * np.sin(xs / 40.0), xs], -1)
    dst = np.stack([np.full(n, y), xs], -1)
    return T.fit_tps(np.concatenate([src, _corners(h, w)]),
                     np.concatenate([dst, _corners(h, w)]))


def _random_page(h=256, w=384, seed=5):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (h, w), np.uint8)
    mask = ((rng.random((h, w)) > 0.6) * 255).astype(np.uint8)
    return img, mask


def _jax_args(img, mask, control, weights, affine):
    return (jnp.asarray(img), jnp.asarray(pack_bits_host(mask > 0)),
            jnp.asarray(control, np.float32),
            jnp.asarray(weights, np.float32),
            jnp.asarray(affine, np.float32))


def _hold_warp(got_img, got_mask, want_img, want_mask):
    """The test_dewarp.py bar, the page's border excluded."""
    inner = (slice(1, -1), slice(1, -1))
    diff = np.abs(np.asarray(got_img).astype(int)
                  - np.asarray(want_img).astype(int))[inner]
    assert diff.max() <= 1
    assert np.mean((np.asarray(got_mask) > 0)[inner]
                   != (np.asarray(want_mask) > 0)[inner]) < 1e-3


def _curved_line_page(h=300, w=800, amp=40, line_y=150, thickness=12,
                      x0=40, x1=None):
    """One sine-curved dark line (test_dewarp.py:29-38)."""
    x1 = w - 40 if x1 is None else x1
    img = np.full((h, w, 3), 230, dtype=np.uint8)
    mask = np.zeros((h, w), dtype=np.uint8)
    xs = np.arange(x0, x1)
    ys = (line_y + amp * np.sin((xs - x0) / max(x1 - x0, 1) * np.pi)
          ).astype(int)
    for x, y in zip(xs, ys):
        img[y: y + thickness, x] = 40
        mask[y: y + thickness, x] = 255
    return img, mask


def _straight_line_page():
    img = np.full((200, 600, 3), 230, dtype=np.uint8)
    mask = np.zeros((200, 600), dtype=np.uint8)
    mask[90:110, 30:570] = 255
    img[mask > 0] = 40
    return img, mask


# ---------------------------------------------------------------------------
# fit, maps, warps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_fit_tps_equals_jax(alpha):
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 300, size=(9, 2))
    dst = src + rng.normal(0, 5, size=(9, 2))
    for got, want in zip(P.fit_tps(src, dst, alpha),
                         T.fit_tps(src, dst, alpha)):
        np.testing.assert_array_equal(got, want)
    pts = rng.uniform(0, 300, size=(20, 2))
    np.testing.assert_array_equal(
        P.tps_transform_points(pts, *P.fit_tps(src, dst, alpha)),
        T.tps_transform_points(pts, *T.fit_tps(src, dst, alpha)))


def test_grid_maps_within_1e3_px_of_jax():
    h, w = 256, 384
    rng = np.random.default_rng(1)
    src = rng.uniform(0, 256, size=(7, 2))
    dst = src + rng.normal(0, 6, size=(7, 2))
    fit = T.fit_tps(np.concatenate([src, _corners(h, w)]),
                    np.concatenate([dst, _corners(h, w)]))
    jy, jx = T._tps_grid_device(*[jnp.asarray(a, np.float32) for a in fit],
                                h, w)
    py, px = P._tps_grid(*fit, h, w, "cpu")
    assert np.abs(py.numpy() - np.asarray(jy)).max() < 1e-3
    assert np.abs(px.numpy() - np.asarray(jx)).max() < 1e-3
    control, weights, affine = fit
    jy1 = T._tps_grid_y(jnp.asarray(control, np.float32),
                        jnp.asarray(weights[:, 0], np.float32),
                        jnp.asarray(affine[:, 0], np.float32), h, w)
    py1 = P._tps_grid_y(control, weights[:, 0], affine[:, 0], h, w, "cpu")
    assert np.abs(py1.numpy() - np.asarray(jy1)).max() < 1e-3


def test_vertical_warp_matches_jax():
    img, mask = _random_page()
    fit = _sine_fit(*img.shape)
    jw, jm, jdy = T._warp_pair_vertical(*_jax_args(img, mask, *fit), b=64)
    pw, pm, pdy = P._warp_pair_vertical(torch.from_numpy(img),
                                        torch.from_numpy(mask), *fit)
    assert abs(float(pdy) - float(jdy)) < 1e-3
    assert float(pdy) <= 63
    _hold_warp(pw.numpy(), pm.numpy(), np.asarray(jw),
               unpack_mask(np.asarray(jm), img.shape[1]))
    assert set(np.unique(pm.numpy())) <= {0, 255}


def test_exact_warp_matches_jax():
    img, mask = _random_page(seed=9)
    h, w = img.shape
    rng = np.random.default_rng(3)
    src = rng.uniform(20, 230, size=(6, 2))
    dst = src + rng.normal(0, 4, size=(6, 2))  # moves x too
    fit = T.fit_tps(np.concatenate([src, _corners(h, w)]),
                    np.concatenate([dst, _corners(h, w)]))
    jw, jm = T._warp_pair(*_jax_args(img, mask, *fit))
    pw, pm = P._warp_pair(torch.from_numpy(img), torch.from_numpy(mask), *fit)
    _hold_warp(pw.numpy(), pm.numpy(), np.asarray(jw),
               unpack_mask(np.asarray(jm), w))


def _overshooting_line_data(h=128, w=128):
    """Two close control points pulled in opposite directions: the fitted
    TPS moves rows by 41 px where the JAX band rule allows 31."""
    xs = (w / 2 - 2, w / 2 + 2)
    inp = [[h / 2 + 10, xs[0]], [h / 2 - 10, xs[1]]]
    out = [[h / 2, xs[0]], [h / 2, xs[1]]]
    return [{"contour": None, "tps": True, "input_pts": inp,
             "output_pts": out, "max_yd": 20.0}]


def test_overshooting_tps_takes_the_exact_path_in_both():
    h = w = 128
    line_data = _overshooting_line_data(h, w)
    control, weights, affine, band = P.global_tps_fit(h, w, line_data)
    assert band == 32
    img, mask = _random_page(h, w, seed=2)
    _, _, jdy = T._warp_pair_vertical(
        *_jax_args(img, mask, control, weights, affine), b=band)
    _, _, pdy = P._warp_pair_vertical(torch.from_numpy(img),
                                      torch.from_numpy(mask), control,
                                      weights, affine)
    assert float(jdy) > band - 1 and float(pdy) > band - 1
    report = {}
    got = P.apply_global_tps(img, mask, line_data, device="cpu",
                             report=report)
    want = T.apply_global_tps(img, mask, line_data)
    assert report["path"] == "exact" and report["b"] == band
    _hold_warp(got[0], got[1], *want)


# ---------------------------------------------------------------------------
# curvature analysis
# ---------------------------------------------------------------------------

def _pages():
    return {
        "curved": _curved_line_page(),
        "straight": _straight_line_page(),
        # a short line at the left edge: slice starts < 0, the full-page
        # branch with numpy's wraparound slicing
        "left_edge": _curved_line_page(x0=0, x1=120, amp=15),
        # a short line at the right edge: slices past the page width
        "right_edge": _curved_line_page(x0=700, x1=800, amp=15),
    }


@pytest.mark.parametrize("name", ["curved", "straight", "left_edge",
                                  "right_edge"])
def test_check_line_tps_equals_jax(name):
    img, mask = _pages()[name]
    contours = G.get_contours(mask)
    assert contours
    for cnt in contours:
        assert P.check_line_tps(img, cnt) == T.check_line_tps(img, cnt)


def test_check_line_tps_edge_cases_take_both_branches():
    img, mask = _pages()["left_edge"]
    cnt = G.get_contours(mask)[0]
    x, _, w, _ = cv2.boundingRect(cnt)
    assert x + w // 4 - 40 < 0  # the full-page branch
    img, mask = _pages()["curved"]
    cnt = G.get_contours(mask)[0]
    x, _, w, _ = cv2.boundingRect(cnt)
    assert x + w // 4 - 40 >= 0 and x + w <= img.shape[1]  # the ROI branch


def test_check_for_tps_and_global_line_equal_jax():
    img, mask = _curved_line_page()
    img2, mask2 = _straight_line_page()
    contours = list(G.get_contours(mask)) + [
        c + np.array([[[100, 0]]], np.int32) for c in G.get_contours(mask2)
    ]
    got_ratio, got = P.check_for_tps(img, contours)
    want_ratio, want = T.check_for_tps(img, contours)
    assert got_ratio == want_ratio == 0.5
    for a, b in zip(got, want):
        assert {k: v for k, v in a.items() if k != "contour"} == \
            {k: v for k, v in b.items() if k != "contour"}
    assert P.get_global_tps_line(got) == T.get_global_tps_line(want)


def test_apply_global_tps_matches_jax():
    img, mask = _curved_line_page()
    _, line_data = T.check_for_tps(img, list(G.get_contours(mask)))
    report = {}
    got_img, got_mask = P.apply_global_tps(img, mask, line_data,
                                           device="cpu", report=report)
    want_img, want_mask = T.apply_global_tps(img, mask, line_data)
    assert report["path"] == "vertical"
    assert got_img.shape == want_img.shape == img.shape[:2]
    assert got_img.dtype == got_mask.dtype == np.uint8
    assert set(np.unique(got_mask)) <= {0, 255}
    _hold_warp(got_img, got_mask, want_img, want_mask)


# ---------------------------------------------------------------------------
# run_tps and LOCAL mode
# ---------------------------------------------------------------------------

def test_run_tps_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 255, (64, 80, 3), np.uint8)
    src = [[10, 10], [10, 70], [32, 40], [54, 10], [54, 70]]
    dst = [[12, 10], [9, 70], [30, 42], [55, 10], [54, 68]]
    got = P.run_tps(img, src, dst, device="cpu")
    want = T.run_tps(img, src, dst)
    assert got.shape == want.shape == img.shape
    diff = np.abs(got.astype(int) - np.asarray(want).astype(int))[:, 1:-1]
    assert diff.max() <= 1
    gray = img[..., 0]  # a 2-D image is warped as RGB, as cv2 makes it
    assert P.run_tps(gray, src, src, device="cpu").shape == (64, 80, 3)


def test_local_tps_strips_match_jax():
    img, mask = _curved_line_page()
    img2, mask2 = _straight_line_page()
    page = img.copy()
    page[220:240, 30:570] = 40
    full_mask = mask.copy()
    full_mask[220:240, 30:570] = 255
    contours = list(G.get_contours(full_mask))
    _, line_data = T.check_for_tps(page, contours)
    assert sorted(d["tps"] for d in line_data) == [False, True]
    got = P.get_line_images_via_local_tps(page, line_data, device="cpu")
    want = T.get_line_images_via_local_tps(page, line_data)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_dewarp_entry_points_run_on_cuda_unless_asked(monkeypatch):
    """Like every entry point of the port, the dewarp runs on cuda unless
    the caller passes device="cpu": without a card it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img, mask = _curved_line_page()
    _, line_data = P.check_for_tps(img, list(G.get_contours(mask)))
    src = [[10, 10], [10, 70], [32, 40]]
    calls = [
        lambda: P.run_tps(img, src, src),
        lambda: P.apply_global_tps(img, mask, line_data),
        lambda: P.get_line_images_via_local_tps(img, line_data),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("k_factor", [1.2, 2.5])
def test_get_line_image_from_mask_equals_jax(k_factor):
    img, mask = _curved_line_page()
    soft = cv2.GaussianBlur(mask, (5, 5), 0)  # values between 0 and 255
    got = PG.get_line_image_from_mask(img, soft, 20, bbox_tolerance=2.0,
                                      k_factor=k_factor)
    want = G.get_line_image_from_mask(img, soft, 20, bbox_tolerance=2.0,
                                      k_factor=k_factor)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [0, 3])
def test_bilinear_sample_and_remap_match_jax(channels):
    """The strict-border sampler (border 0), as the dewarp calls it."""
    rng = np.random.default_rng(4)
    shape = (40, 50, channels) if channels else (40, 50)
    img = rng.integers(0, 256, shape, np.uint8)
    ys = rng.uniform(-2, 42, (30, 35)).astype(np.float32)
    xs = rng.uniform(-2, 52, (30, 35)).astype(np.float32)
    ys[0, :5] = [0.0, 39.0, -0.0, 39.5, 38.999]  # on and past the edges
    got = imaging.bilinear_sample(torch.from_numpy(img), torch.from_numpy(ys),
                                  torch.from_numpy(xs))
    want = jimg.bilinear_sample(jnp.asarray(img), jnp.asarray(ys),
                                jnp.asarray(xs), 0.0, strict_border=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    got = imaging.remap(torch.from_numpy(img), torch.from_numpy(ys),
                        torch.from_numpy(xs))
    want = jimg.remap(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs))
    assert got.dtype == torch.uint8
    assert np.abs(got.numpy().astype(int)
                  - np.asarray(want).astype(int)).max() <= 1
