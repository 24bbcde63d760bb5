"""The port's pixel ops against the JAX package's functions and the cv2
calls they replace."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_inference_tpu import ops_host
from ocr_inference_tpu.geometry import backend as jgeo
from ocr_inference_tpu.ops import imaging as jimg
from ocr_inference_tpu.ops import packing as jpack
from ocr_inference_tpu.ops import tiling as jtil
from ocr_inference_tpu_torch.geometry import backend as geo
from ocr_inference_tpu_torch.ops import imaging, packing, tiling


def test_rgb_to_gray_matches_cv2_and_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (64, 97, 3), dtype=np.uint8)
    got = imaging.rgb_to_gray(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    np.testing.assert_array_equal(got, np.asarray(jimg.rgb_to_gray(img)))


@pytest.mark.parametrize("hw", [(700, 1100), (1600, 2640), (300, 900),
                                (5000, 1200), (900, 5000), (512, 512)])
def test_plan_tile_stitch_crop_match_jax(hw):
    plan = tiling.plan_page(*hw)
    jplan = jtil.plan_page(*hw)
    assert (plan.resized_h, plan.resized_w, plan.padded_h, plan.padded_w) \
        == (jplan.resized_h, jplan.resized_w, jplan.padded_h, jplan.padded_w)
    if hw[0] * hw[1] > 2_000_000:
        return  # the plan is the point for the clamped pages
    rng = np.random.default_rng(hw[0])
    img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    padded = tiling.preprocess_page(torch.from_numpy(img), plan)
    jpadded = np.asarray(jtil.preprocess_page(jnp.asarray(img), jplan))
    np.testing.assert_array_equal(padded.numpy(), jpadded)
    tiles = tiling.tile_page(padded)
    np.testing.assert_array_equal(
        tiles.numpy(), np.asarray(jtil.tile_page(jnp.asarray(jpadded))))
    pred = tiles[..., 0].float()
    merged = tiling.crop_padding(tiling.stitch_tiles(pred, plan.y_steps),
                                 plan.pad_x, plan.pad_y)
    jmerged = jtil.crop_padding(
        jtil.stitch_tiles(jnp.asarray(pred.numpy()), jplan.y_steps),
        jplan.pad_x, jplan.pad_y)
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jmerged))


def test_resize_bilinear_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (300, 420, 3), dtype=np.uint8)
    got = imaging.resize_bilinear(torch.from_numpy(img), 512, 716).numpy()
    want = np.asarray(jimg.resize_bilinear(jnp.asarray(img), 512, 716))
    np.testing.assert_array_equal(got, want)
    m = (rng.random((256, 333)) > 0.5).astype(np.float32)
    got = imaging.resize_bilinear(torch.from_numpy(m), 400, 500).numpy()
    want = np.asarray(jimg.resize_bilinear(jnp.asarray(m), 400, 500))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("width", [1, 31, 32, 33, 2640])
def test_pack_mask_matches_jax_layout(width):
    rng = np.random.default_rng(width)
    m = rng.random((3, 7, width)) > 0.5
    got = packing.pack_mask(torch.from_numpy(m)).numpy()
    want = np.asarray(jpack.pack_mask(jnp.asarray(m)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(packing.unpack_mask(got, width),
                                  m.astype(np.uint8))


@pytest.mark.parametrize("channels", [3, 1])
def test_pad_ocr_line_byte_equal_with_host_cv2(channels):
    """cv2's integer INTER_LINEAR, reproduced: byte-equal on strips that
    take the height path (upscale and downscale) and the width path."""
    rng = np.random.default_rng(channels)
    sizes = [(40, 300), (61, 917), (23, 849), (95, 500), (130, 2000),
             (52, 3100), (80, 512), (33, 1200), (75, 47)]
    for h, w in sizes:
        shape = (h, w, 3) if channels == 3 else (h, w)
        strip = rng.integers(0, 256, shape, dtype=np.uint8)
        for target in (512, 1024, 2000, 3000):
            want = ops_host.pad_ocr_line(strip, target, 80)
            got = tiling.pad_ocr_line(torch.from_numpy(strip), target, 80)
            np.testing.assert_array_equal(got.numpy(), want)


def test_bucket_for_width_matches_jax():
    buckets = (512, 1024, 2000, 2500, 3000)
    for w, h in [(100, 40), (1000, 40), (1300, 52), (5000, 30), (7, 0)]:
        assert tiling.bucket_for_width(w, h, 80, buckets) == \
            jtil.bucket_for_width(w, h, 80, buckets)


@pytest.mark.parametrize("angle", [-1.985, 2.0, 0.7, -4.4])
def test_rotate_from_angle_against_cv2_warp_affine(angle):
    """cv2 5.x warpAffine, byte for byte."""
    rng = np.random.default_rng(int(abs(angle) * 10))
    for img in (rng.integers(0, 256, (350, 510, 3), dtype=np.uint8),
                np.where(rng.random((350, 510)) > 0.6, 255, 0).astype(np.uint8)):
        h, w = img.shape[:2]
        m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1)
        want = cv2.warpAffine(img, m, (w, h), borderValue=(0, 0, 0))
        got = imaging.rotate_from_angle(torch.from_numpy(img), angle).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [333, 1024, 1601])
def test_warp_affine_row_tail_against_cv2(width):
    """Widths whose rows end after cv2's vector loop in 13, 0 and 1
    scalar pixels; a paper-coloured border, as rotate_page uses."""
    rng = np.random.default_rng(width)
    for angle, channels in ((1.3, 3), (-2.7, 1), (7.9, 3)):
        shape = (200, width, 3) if channels == 3 else (200, width)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        m = cv2.getRotationMatrix2D((width / 2, 100), angle, 1)
        want = cv2.warpAffine(img, m, (width, 200),
                              borderValue=(235, 235, 235))
        got = imaging.warp_affine(torch.from_numpy(img), m, 200, width, 235)
        np.testing.assert_array_equal(got.numpy(), want)


def test_fma32_rounds_once():
    """fma32 against the exact a*b + c rounded once to float32, on random
    operands and on sums built to fall on a float32 midpoint."""
    from fractions import Fraction

    rng = np.random.default_rng(9)
    a = rng.uniform(-1, 1, 400).astype(np.float32)
    b = rng.integers(-255, 256, 400).astype(np.float32)
    c = rng.uniform(-300, 300, 400).astype(np.float32)
    # exact sums of a few ulps
    c[:100] = -(a[:100].astype(np.float64) * b[:100]).astype(np.float32)
    # 1 + 2**-24 + 2**-54: float64 rounds it onto the float32 midpoint
    # 1 + 2**-24, from where a second rounding would give 1.0
    a[100:102] = np.float32(5237765 * 2.0**-54)
    b[100:102] = (205, -205)
    c[100:102] = (1.0, -1.0)
    got = imaging.fma32(*map(torch.from_numpy, (a, b, c))).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        dist = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(dist)
        nearest = [v for v, d in zip(cands, dist) if d == best]
        if len(nearest) > 1:  # a tie: the even one
            nearest = [v for v in nearest
                       if int(np.float32(v).view(np.int32)) % 2 == 0]
        assert g == nearest[0], (x, y, z)


def _polygons(rng, n):
    out = []
    for i in range(n):
        h, w = int(rng.integers(20, 120)), int(rng.integers(20, 200))
        if i % 2:
            k = int(rng.integers(3, 12))
            out.append(((h, w), rng.integers(0, [w, h], (k, 1, 2)).astype(np.int32)))
            continue
        m = np.zeros((h, w), np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            x, y = int(rng.integers(0, w - 5)), int(rng.integers(0, h - 5))
            m[y: y + int(rng.integers(3, 30)), x: x + int(rng.integers(3, 80))] = 255
        m = cv2.warpAffine(m, cv2.getRotationMatrix2D(
            (w / 2, h / 2), float(rng.uniform(-20, 20)), 1), (w, h))
        for c in geo.find_contours(m):
            out.append(((h, w), c))
            out.append(((h, w), geo.approx_poly_dp(c, 2.0)))
            out.append(((h, w), geo.convex_hull(c)))
    return out


def test_fill_contour_byte_equal_with_cv2_draw_contours():
    rng = np.random.default_rng(11)
    polys = _polygons(rng, 200)
    assert len(polys) > 300
    for (h, w), c in polys:
        want = np.zeros((h, w), np.uint8)
        cv2.drawContours(want, [c], -1, 255, -1)
        got = np.zeros((h, w), np.uint8)
        geo.fill_contour(got, c, 255)
        np.testing.assert_array_equal(got, want)


def test_geometry_backend_matches_jax_native_backend():
    rng = np.random.default_rng(4)
    m = np.zeros((300, 700), np.uint8)
    for y in range(30, 280, 50):
        x0 = int(rng.integers(10, 60))
        m[y: y + int(rng.integers(12, 30)), x0: x0 + int(rng.integers(200, 600))] = 255
    m = cv2.warpAffine(m, cv2.getRotationMatrix2D((350, 150), 1.5, 1), (700, 300))
    got = geo.find_contours(m)
    want = jgeo.find_contours(m)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert geo.bounding_rect(a) == jgeo.bounding_rect(b)
        assert geo.contour_area(a) == jgeo.contour_area(b)
        assert geo.min_area_rect(a) == jgeo.min_area_rect(b)
        np.testing.assert_array_equal(geo.convex_hull(a), jgeo.convex_hull(b))
        np.testing.assert_array_equal(geo.approx_poly_dp(a, 1.5),
                                      jgeo.approx_poly_dp(b, 1.5))
    assert geo.line_threshold(m) == jgeo.line_threshold(m)
