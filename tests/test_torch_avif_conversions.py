"""The port's AVIF reader (io/images.py) on the colour conversions libavif
makes without libyuv, against ``cv2.cvtColor(cv2.imread(path),
cv2.COLOR_BGR2RGB)`` (cv2 5.0's AvifDecoder over libavif 1.4.2), byte for
byte and None for None: FCC, SMPTE 240, YCgCo, YCgCo-Re and YCgCo-Ro, the
chroma-derived matrix by each colour primaries, the identity matrix on
limited range, and colour premultiplied by its alpha (prem). libavif's own
encoder (tests/image_writers.py libavif_encode) writes the files; the
scanned page's text over smooth colour, at sizes that are odd where it
matters."""

import cv2
import numpy as np
import pytest

from ocr_inference_tpu_torch.io.images import read_image, unsupported
from tests.image_writers import libavif_encode, ycbcr_planes
from tests.test_torch_avif import _cv2_rgb, _scan


def _page(h: int = 65, w: int = 97) -> np.ndarray:
    rng = np.random.default_rng(0)
    small = rng.integers(0, 256, (7, 9, 3), np.uint8)
    colour = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
    text = _scan()[:h, :w]
    return np.where(text < 128, text, colour).astype(np.uint8)


def _same(path, data):
    path.write_bytes(data)
    want, got = _cv2_rgb(path), read_image(path)
    if want is None:
        assert got is None
    else:
        assert got is not None and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert unsupported(path) is None
    return want


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("full", [True, False], ids=["full", "limited"])
@pytest.mark.parametrize("layout", ["444", "420", "422"])
@pytest.mark.parametrize("matrix", [4, 7, 8, 16, 17])
def test_matrices_libavif_converts(tmp_path, matrix, layout, full, depth):
    """FCC (4) and SMPTE 240 (7) through kr and kb, YCgCo (8) on full
    range, YCgCo-Re (16) from 10 bits of full range: libavif's float
    conversion at the stream's depth with its bilinear chroma. YCgCo on
    limited range, YCgCo-Re from other depths or ranges, and YCgCo-Ro
    (16 and 17 need 10 and 9 bits for 8-bit RGB) give None, as in cv2."""
    data = libavif_encode(ycbcr_planes(_page(), layout, depth), depth,
                          layout, full_range=full, matrix=matrix, speed=9)
    want = _same(tmp_path / "m.avif", data)
    readable = {4: True, 7: True, 8: full, 16: full and depth == 10,
                17: False}[matrix]
    assert (want is not None) == readable


@pytest.mark.parametrize("primaries", [0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 11,
                                       12, 22, 23])
def test_chroma_derived_matrix(tmp_path, primaries):
    """Matrix 12 (chroma-derived non-constant luminance): libyuv's BT.709,
    BT.601 or BT.2020 constants for those primaries, else kr and kb from
    the primaries (BT.709's for values libavif has no entry for)."""
    for layout in ("444", "420"):
        data = libavif_encode(ycbcr_planes(_page(), layout, 8), 8, layout,
                              matrix=12, primaries=primaries, speed=9)
        assert _same(tmp_path / "c.avif", data) is not None


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_identity_on_limited_range(tmp_path, depth):
    """The identity matrix on limited range: each channel by Y's bias and
    range through libavif's float unorm; ramps through every sample value
    reach its clamps."""
    planes = [p | (p >> (depth - 8)) for p in ycbcr_planes(_page(), "444",
                                                          depth)]
    for quality in (60, 100):
        data = libavif_encode(planes, depth, "444", full_range=False,
                              matrix=0, speed=9, quality=quality)
        assert _same(tmp_path / "i.avif", data) is not None
    ramp = (np.arange(65 * 97) % (1 << depth)).reshape(65, 97)
    ramp = ramp.astype(np.uint16)
    data = libavif_encode([ramp, ramp[::-1], ramp[:, ::-1]], depth, "444",
                          full_range=False, matrix=0, speed=9, quality=100)
    assert _same(tmp_path / "i.avif", data) is not None


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("layout,matrix,full", [
    ("420", 6, True), ("444", 1, False), ("422", 9, True), ("444", 0, True),
    ("444", 0, False), ("420", 4, True), ("444", 8, True)])
def test_premultiplied_alpha(tmp_path, layout, matrix, full, depth):
    """Colour premultiplied by its alpha (a prem reference): libyuv's
    conversions, then its ARGBUnattenuate at 8 bits (a reciprocal table;
    alpha 1 wraps to 0 above 127); libavif's float conversions divide by
    the alpha at its depth themselves. Alpha 0, 1 and 255 in bands, the
    rest seeded; 12-bit 4:2:0 through libyuv stays refused by name."""
    rng = np.random.default_rng(depth)
    alpha = rng.integers(0, 256, (65, 97)).astype(np.uint16)
    alpha[:, :10], alpha[:, 10:20], alpha[:, 20:30] = 255, 0, 1
    alpha = alpha << (depth - 8) | (alpha >> (16 - depth))
    data = libavif_encode(ycbcr_planes(_page(), layout, depth), depth,
                          layout, full_range=full, matrix=matrix, speed=9,
                          alpha=alpha, premultiplied=True)
    path = tmp_path / "p.avif"
    if depth == 12 and layout == "420" and matrix == 6:  # libyuv's
        path.write_bytes(data)
        assert _cv2_rgb(path) is not None
        with pytest.raises(NotImplementedError, match="premultiplied"):
            read_image(path)
        assert "premultiplied" in unsupported(path)
        return
    assert _same(path, data) is not None
