"""The port's JPEG reader (io/images.py read_image, native/jpeg.cpp)
against ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` on files that
cv2 and PIL write here: byte-equal at every sampling factor cv2.imwrite
offers, baseline and progressive, with restart intervals, optimised
Huffman tables, gray, EXIF orientations 1-8, odd sizes and truncated
files; the variants it does not decode are refused by name."""

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from ocr_inference_tpu_torch.io.images import image_format, read_image

# cv2.IMWRITE_JPEG_SAMPLING_FACTOR values: 4:1:1, 4:2:0, 4:2:2, 4:4:0, 4:4:4
SAMPLING = {"411": 0x411111, "420": 0x221111, "422": 0x211111,
            "440": 0x121111, "444": 0x111111}


def _cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _assert_same_as_cv2(path):
    want = _cv2_rgb(path)
    got = read_image(path)
    assert want is not None
    assert got is not None and got.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _page(h, w, seed=0, gray=False):
    """Smooth colour gradients with noise: every channel and the chroma
    planes carry detail, so upsampling and colour conversion show."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(x / 7.0) * 90 + 128, np.cos(y / 5.0) * 90 + 128,
                     (x * 3 + y * 5) % 256], -1)
    img = (base + rng.randint(-40, 40, (h, w, 3))).clip(0, 255)
    img = img.astype(np.uint8)
    return img[..., 0] if gray else img


def _write(path, img, quality=90, sampling="420", progressive=0, restart=0,
           optimize=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
              cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
              cv2.IMWRITE_JPEG_OPTIMIZE, optimize]
    assert cv2.imwrite(str(path), img, params)
    return path


@pytest.mark.parametrize("size", [(1, 1), (7, 13), (17, 33), (40, 64)])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("progressive", [0, 1])
def test_sampling_factors_and_progressive(tmp_path, size, sampling,
                                          progressive):
    for restart in (0, 2):
        path = _write(tmp_path / "p.jpg", _page(*size), sampling=sampling,
                      progressive=progressive, restart=restart)
        assert image_format(path) == "JPEG"
        _assert_same_as_cv2(path)


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_large_page_1023x1601(tmp_path, sampling):
    img = _page(1023, 1601, seed=3)
    for progressive in (0, 1):
        _assert_same_as_cv2(_write(tmp_path / "big.jpg", img,
                                   sampling=sampling,
                                   progressive=progressive))


@pytest.mark.parametrize("quality", [1, 10, 50, 95, 100])
@pytest.mark.parametrize("optimize", [0, 1])
def test_qualities_and_optimised_huffman(tmp_path, quality, optimize):
    img = _page(57, 91, seed=quality)
    for progressive in (0, 1):
        _assert_same_as_cv2(_write(tmp_path / "q.jpg", img, quality=quality,
                                   optimize=optimize,
                                   progressive=progressive))


@pytest.mark.parametrize("restart", [1, 3, 7])
@pytest.mark.parametrize("gray", [False, True])
def test_restart_intervals_and_gray(tmp_path, restart, gray):
    img = _page(75, 130, seed=restart, gray=gray)
    for progressive in (0, 1):
        _assert_same_as_cv2(_write(tmp_path / "r.jpg", img, restart=restart,
                                   progressive=progressive))


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("progressive", [False, True])
def test_pil_encoder(tmp_path, subsampling, progressive):
    """PIL's encoder: its own quantisation and Huffman tables, optimised
    or not, and gray."""
    img = _page(45, 77, seed=subsampling)
    for optimize in (False, True):
        path = tmp_path / "pil.jpg"
        Image.fromarray(img).save(path, "JPEG", quality=80,
                                  subsampling=subsampling,
                                  progressive=progressive, optimize=optimize)
        _assert_same_as_cv2(path)
    Image.fromarray(img).convert("L").save(path, "JPEG", quality=80,
                                           progressive=progressive)
    _assert_same_as_cv2(path)


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 90), w=st.integers(1, 90),
       quality=st.integers(1, 100), sampling=st.sampled_from(sorted(SAMPLING)),
       progressive=st.integers(0, 1), restart=st.integers(0, 4),
       seed=st.integers(0, 1000))
def test_drawn_sizes_and_qualities(tmp_path_factory, h, w, quality, sampling,
                                   progressive, restart, seed):
    path = tmp_path_factory.mktemp("hyp") / "h.jpg"
    _assert_same_as_cv2(_write(path, _page(h, w, seed), quality=quality,
                               sampling=sampling, progressive=progressive,
                               restart=restart))


@pytest.mark.parametrize("orientation", range(0, 10))
@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
def test_exif_orientation(tmp_path, orientation, fmt):
    """EXIF orientation 1-8 (and the out-of-range 0 and 9) as cv2 applies
    it: from a JPEG's APP1 segment and from a PNG's eXIf chunk."""
    img = _page(20, 30, seed=orientation)
    exif = Image.Exif()
    exif[0x0112] = orientation
    path = tmp_path / ("o.jpg" if fmt == "JPEG" else "o.png")
    kw = {"quality": 95} if fmt == "JPEG" else {}
    Image.fromarray(img).save(path, fmt, exif=exif.tobytes(), **kw)
    _assert_same_as_cv2(path)
    if orientation in (5, 6, 7, 8):
        assert read_image(path).shape[:2] == (30, 20)


def test_truncated_and_unreadable_files(tmp_path):
    """cv2.imread decodes a JPEG cut inside its scan (the missing blocks
    mid-gray) and gives None for one cut inside its headers; so does the
    reader. A progressive file cut after its first scans, which libjpeg
    smooths, is refused by name."""
    path = tmp_path / "t.jpg"
    for restart in (0, 2):
        data = _write(path, _page(64, 80), restart=restart).read_bytes()
        for cut in (10, 100, 400, len(data) // 2, len(data) - 10,
                    len(data) - 2):
            path.write_bytes(data[:cut])
            want = _cv2_rgb(path)
            got = read_image(path)
            if want is None:
                assert got is None, cut
            else:
                np.testing.assert_array_equal(got, want)
        assert read_image(path) is not None
    path.write_bytes(b"\xff\xd8\xff\xe0garbage")
    assert _cv2_rgb(path) is None and read_image(path) is None
    data = _write(path, _page(64, 80), progressive=1).read_bytes()
    path.write_bytes(data[: len(data) // 2])
    assert _cv2_rgb(path) is not None
    with pytest.raises(NotImplementedError, match="progressive JPEG"):
        read_image(path)


def _patched_sof(data: bytes, marker: int | None = None,
                 precision: int | None = None) -> bytes:
    """A baseline JPEG with its SOF0 marker or sample precision changed."""
    at = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[at + 1] = marker
    if precision is not None:
        out[at + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("variant,name", [
    ({"marker": 0xC9}, "arithmetic-coded JPEG"),
    ({"marker": 0xCA}, "arithmetic-coded JPEG"),
    ({"marker": 0xC3}, "lossless JPEG"),
    ({"precision": 12}, "12- or 16-bit"),
])
def test_variants_refused_by_name(tmp_path, variant, name):
    data = _write(tmp_path / "b.jpg", _page(16, 16)).read_bytes()
    path = tmp_path / "v.jpg"
    path.write_bytes(_patched_sof(data, **variant))
    with pytest.raises(NotImplementedError, match=name):
        read_image(path)


def test_cmyk_refused_by_name(tmp_path):
    path = tmp_path / "cmyk.jpg"
    Image.fromarray(_page(16, 24)).convert("CMYK").save(path, "JPEG")
    assert _cv2_rgb(path) is not None  # cv2 reads it
    with pytest.raises(NotImplementedError, match="CMYK"):
        read_image(path)

