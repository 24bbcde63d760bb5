"""The port's preview drawing (utils/preview.py) against the JAX package's
cv2 drawing, byte for byte, on seeded boxes and on the fixture pages with
their JAX float32 layout masks (tests/data/torch_port/layout_masks.npz)."""

from pathlib import Path

import numpy as np
import pytest

from ocr_inference_tpu.core import data as j_data
from ocr_inference_tpu.geometry import get_contours as j_get_contours
from ocr_inference_tpu.utils import preview as j_preview
from ocr_inference_tpu_torch.core import data
from ocr_inference_tpu_torch.eval.synthetic import fixture_pages
from ocr_inference_tpu_torch.geometry import get_contours
from ocr_inference_tpu_torch.utils import preview

FIXTURE = Path(__file__).resolve().parent / "data" / "torch_port"
CLASSES = ["background", "image", "line", "caption", "margin"]


@pytest.fixture(scope="module")
def pages():
    """[(name, RGB page, (H, W, 5) uint8 0/255 JAX layout mask)]."""
    with np.load(FIXTURE / "layout_masks.npz") as npz:
        out = []
        for name, img, _ in fixture_pages(FIXTURE / "pages.npz"):
            bits = np.unpackbits(npz[name], axis=-1)[..., :img.shape[1]]
            out.append((name, img, np.ascontiguousarray(
                bits.transpose(1, 2, 0)) * np.uint8(255)))
        return out


def _canvas(seed: int, gray: bool):
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(20, 90, 2))
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return rng, (img[..., 0].copy() if gray else img)


@pytest.mark.parametrize("thickness", [2, 3, 5, -1])
@pytest.mark.parametrize("gray", [False, True])
def test_draw_bbox_equals_cv2(thickness, gray):
    for seed in range(40):
        rng, img = _canvas(seed, gray)
        h, w = img.shape[:2]
        box = [int(rng.integers(-6, w)), int(rng.integers(-6, h)),
               int(rng.integers(0, 50)), int(rng.integers(0, 50))]
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        got = preview.draw_bbox(img.copy(), data.BBox(*box), color, thickness)
        want = j_preview.draw_bbox(img.copy(), j_data.BBox(*box), color,
                                   thickness)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thickness", [2, 3, 4])
@pytest.mark.parametrize("gray", [False, True])
def test_draw_rotated_bbox_equals_cv2(thickness, gray):
    """Corners inside, near and outside the image: each side is clipped
    as cv2 5.x clips it."""
    for seed in range(40):
        rng, img = _canvas(seed, gray)
        h, w = img.shape[:2]
        pts = np.stack([rng.integers(-30, w + 30, 4),
                        rng.integers(-30, h + 30, 4)], 1).astype(np.int32)
        args = ((0.0, 0.0), 1.0, 1.0, 0.0, pts)
        got = preview.draw_rotated_bbox(img.copy(), data.RotatedBBox(*args),
                                        thickness=thickness)
        want = j_preview.draw_rotated_bbox(img.copy(),
                                           j_data.RotatedBBox(*args),
                                           thickness=thickness)
        np.testing.assert_array_equal(got, want)


def test_generate_line_preview_equals_cv2(pages):
    for _, _, mask in pages:
        line = np.ascontiguousarray(mask[..., 2])
        contours = get_contours(line)
        assert contours
        for pred in (line, mask[..., :3]):
            got = preview.generate_line_preview(pred, contours)
            want = j_preview.generate_line_preview(pred, contours)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("alpha", [0.4, 0.7])
def test_create_preview_image_equals_cv2(pages, alpha):
    """Every class drawn with its contours; the blend is cv2.addWeighted
    in place."""
    for _, img, mask in pages:
        contours = {c: list(get_contours(np.ascontiguousarray(mask[..., i])))
                    for i, c in enumerate(CLASSES)}
        kwargs = {f"{c}_predictions": contours[c]
                  for c in ("image", "line", "caption", "margin")}
        # later classes paint over earlier ones where contours overlap
        kwargs["caption_predictions"] = contours["line"][:2]
        page = img.copy()
        got = preview.create_preview_image(page, alpha=alpha, **kwargs)
        want = j_preview.create_preview_image(img.copy(), alpha=alpha,
                                              **kwargs)
        assert got is page
        np.testing.assert_array_equal(got, want)


def test_line_inference_flow_equals_jax(pages):
    """examples/line_inference.py's drawing: contours of a line mask, then
    create_preview_image with them as line predictions."""
    for _, img, mask in pages:
        line = np.ascontiguousarray(mask[..., 2])
        contours = get_contours(line)
        for got_c, want_c in zip(contours, j_get_contours(line)):
            np.testing.assert_array_equal(got_c, want_c)
        got = preview.create_preview_image(img.copy(),
                                           line_predictions=list(contours))
        want = j_preview.create_preview_image(img.copy(),
                                              line_predictions=list(contours))
        np.testing.assert_array_equal(got, want)


def test_create_layout_preview_equals_cv2(pages):
    for _, img, mask in pages:
        got = preview.create_layout_preview(img.copy(), mask, CLASSES)
        want = j_preview.create_layout_preview(img.copy(), mask, CLASSES)
        np.testing.assert_array_equal(got, want)
        assert (got != img).any()
    # a class the mask lacks, and a class order of its own
    _, img, mask = pages[0]
    classes = ["line", "background", "margin", "image", "caption", "extra"]
    np.testing.assert_array_equal(
        preview.create_layout_preview(img.copy(), mask, classes, 0.3),
        j_preview.create_layout_preview(img.copy(), mask, classes, 0.3))
