"""The port's synthetic training data against the JAX package's, byte for
byte, on the CPU: cv2's drawing primitives (ops/drawing.py) against cv2,
every glyph of ``GlyphSet`` against the JAX glyph set at several heights
and seeds, and ``extraction_matched_strip``, ``recognizer_batch`` and
``segmentation_batch`` (canvases 80x128, tiles 128^2) against the JAX
arrays, the same generator draws consumed."""

import cv2
import numpy as np
import pytest
import torch

from ocr_inference_tpu.eval import synthetic as J
from ocr_inference_tpu_torch.eval import synthetic as S
from ocr_inference_tpu_torch.ops import drawing as D
from ocr_inference_tpu_torch.ops.imaging import resize_nearest_u8
from tests.make_torch_port_fixture import OUT

FULL = J.WYLIE_CHARSET_FULL


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def glyph_sets():
    return (J.GlyphSet(charset=FULL, height=40, seed=7),
            S.GlyphSet(charset=FULL, height=40, seed=7))


# -- cv2's drawing --

def _canvas(rng):
    h, w = (int(v) for v in rng.integers(5, 40, 2))
    return np.zeros((h, w), np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_thick_line_equals_cv2(seed):
    """Thickness 2-3 between points in and around the image."""
    rng = np.random.default_rng(seed)
    for _ in range(400):
        want = _canvas(rng)
        got = want.copy()
        t = int(rng.integers(2, 4))
        p1 = tuple(int(v) for v in rng.integers(-6, 46, 2))
        p2 = tuple(int(v) for v in rng.integers(-6, 46, 2))
        cv2.line(want, p1, p2, 255, t)
        D.line(got, p1, p2, 255, t)
        np.testing.assert_array_equal(got, want, err_msg=f"{p1} {p2} {t}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ellipse_arcs_equal_cv2(seed):
    """Arcs from 0 to 180-359 degrees, thickness 2-3, axes 2-25, centers in
    and around the image (every arc step: 90, 30, 18 and 5 degrees)."""
    rng = np.random.default_rng(seed)
    for _ in range(300):
        want = _canvas(rng)
        got = want.copy()
        t = int(rng.integers(2, 4))
        c = tuple(int(v) for v in rng.integers(-3, 43, 2))
        ax = tuple(int(v) for v in rng.integers(2, 26, 2))
        end = int(rng.integers(180, 360))
        cv2.ellipse(want, c, ax, 0, 0, end, 255, t)
        D.ellipse(got, c, ax, 0, 0, end, 255, t)
        np.testing.assert_array_equal(got, want, err_msg=f"{c} {ax} {end}")


@pytest.mark.parametrize("seed", [0, 1])
def test_fill_convex_poly_in_fixed_point_equals_cv2(seed):
    rng = np.random.default_rng(seed)
    for _ in range(300):
        want = _canvas(rng)
        got = want.copy()
        pts = rng.integers(-4 << 16, 44 << 16, (int(rng.integers(3, 7)), 2))
        hull = cv2.convexHull(pts.astype(np.int32))[:, 0]
        cv2.fillConvexPoly(want, hull, 255, cv2.LINE_8, 16)
        D.fill_convex_poly(got, hull, 255, 16)
        np.testing.assert_array_equal(got, want)


def test_sine_table_and_arc_points_equal_cv2():
    """cv2's single-precision sine table, read back through ellipse2Poly
    at a radius of 1e8, and the arc points at every step size."""
    a = 10 ** 8
    pts = cv2.ellipse2Poly((0, 0), (a, a), 0, 0, 360, 1)
    np.testing.assert_array_equal(
        pts[:360, 1], np.rint(a * D.SIN_TABLE[:360].astype(np.float64)))
    for delta in (5, 18, 30, 90):
        for end in (180, 270, 359):
            want = cv2.ellipse2Poly((10, 12), (7, 5), 0, 0, end, delta)
            got = [(int(round(x)), int(round(y))) for x, y in
                   D.ellipse2poly((10, 12), (7, 5), 0, 0, end, delta)]
            dedup = [p for i, p in enumerate(got) if i == 0 or p != got[i - 1]]
            assert dedup == [tuple(p) for p in want]


def test_resize_nearest_equals_cv2():
    rng = np.random.default_rng(0)
    for _ in range(100):
        h, w = (int(v) for v in rng.integers(1, 200, 2))
        oh, ow = (int(v) for v in rng.integers(1, 400, 2))
        img = rng.integers(0, 256, (h, w, 2)).astype(np.uint8)
        want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(resize_nearest_u8(img, oh, ow), want)


# -- the glyph set --

@pytest.mark.parametrize("height", [24, 40, 64])
@pytest.mark.parametrize("seed", [0, 7])
def test_every_glyph_equals_the_jax_glyph(height, seed):
    theirs = J.GlyphSet(charset=FULL, height=height, seed=seed)
    ours = S.GlyphSet(charset=FULL, height=height, seed=seed)
    for token in FULL:
        np.testing.assert_array_equal(ours.glyph(token), theirs.glyph(token),
                                      err_msg=token)


def test_committed_bitmaps_are_the_glyph_set():
    """tests/data/torch_port/pages.npz holds GlyphSet(FULL, 40, 7)."""
    committed, charset = S.load_glyphs(OUT / "pages.npz")
    gs = S.GlyphSet(charset=tuple(charset), height=40, seed=7)
    assert set(committed) == set(FULL)
    for token, bitmap in committed.items():
        np.testing.assert_array_equal(gs.glyph(token), bitmap)


# -- the training samples and batches --

@pytest.mark.parametrize("shear,curve", [(0.0, 0.0), (0.6, 12.0),
                                         (0.0, 5.0)])
def test_extraction_matched_strips_equal_jax(glyph_sets, shear, curve):
    theirs, ours = glyph_sets
    r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(4):
        want, want_tokens = J.extraction_matched_strip(
            r1, theirs, FULL, shear_deg=shear, curve_amp=curve)
        got, tokens = S.extraction_matched_strip(
            r2, ours, FULL, shear_deg=shear, curve_amp=curve)
        assert tokens == want_tokens
        np.testing.assert_array_equal(got, want)
    assert r1.randint(1 << 30) == r2.randint(1 << 30)


def test_context_canvases_distort_and_degrade_as_jax(glyph_sets):
    """degrade_page and distort_page on page-context canvases (the
    extraction's, two lines at page pitch in a 48 px margin)."""
    theirs, _ = glyph_sets
    rng = np.random.RandomState(9)
    for shear, curve, level in ((0.6, 12.0, 0.7), (0.3, 0.0, 0.4),
                                (0.0, 8.0, 0.0)):
        page = J.render_page(rng, theirs, FULL, n_lines=(2, 3), page_w=600)
        r1, r2 = np.random.RandomState(4), np.random.RandomState(4)
        want = J.degrade_page(J.distort_page(page.image, r1, shear, curve),
                              r1, level)
        got = S.degrade_page(S.distort_page(page.image, r2, shear, curve),
                             r2, level)
        np.testing.assert_array_equal(got, want)
        assert r1.randint(1 << 30) == r2.randint(1 << 30)


@pytest.mark.parametrize("augment", [False, True])
def test_recognizer_batch_equals_jax(glyph_sets, augment):
    """Canvases 80x128 (the labels overflow and the strips are redrawn,
    consuming the generator as JAX does), with full77f's recipe or
    none."""
    theirs, ours = glyph_sets
    kw = (dict(degrade_max=0.7, shear_max_deg=0.6, curve_max_amp=12.0,
               geo_prob=0.35) if augment else {})
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(2):
        want = J.recognizer_batch(r1, theirs, FULL, 3, width=128,
                                  max_label=24, **kw)
        got = S.recognizer_batch(r2, ours, FULL, 3, width=128, max_label=24,
                                 device="cpu", **kw)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert r1.randint(1 << 30) == r2.randint(1 << 30)


@pytest.mark.parametrize("batch", [3, 5])
def test_segmentation_batch_equals_jax(glyph_sets, batch):
    theirs, ours = glyph_sets
    r1, r2 = np.random.RandomState(6), np.random.RandomState(6)
    want = J.segmentation_batch(r1, theirs, FULL, batch, patch=128)
    got = S.segmentation_batch(r2, ours, FULL, batch, patch=128,
                               device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert r1.randint(1 << 30) == r2.randint(1 << 30)


def test_batches_need_cuda_unless_cpu_is_asked(glyph_sets):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, ours = glyph_sets
    rng = np.random.RandomState(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.recognizer_batch(rng, ours, FULL, 1, width=128)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.segmentation_batch(rng, ours, FULL, 1, patch=128)
