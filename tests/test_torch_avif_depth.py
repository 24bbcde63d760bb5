"""The port's AVIF reader (io/images.py over native/av1.cpp) on pages of
10 and 12 bits, of AV1 profile 2 (4:2:2) and with film grain, against
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` (cv2 5.0's
AvifDecoder over libavif 1.4.2 and libaom 3.14.1), byte for byte and None
for None. cv2 writes 10 and 12 bits from uint16 (at quality 100 a
lossless 4:4:4 frame with the identity matrix; monochrome from gray; alpha
from BGRA); Pillow writes 4:2:2 and libaom's film grain (its 16 test
vectors, and the denoiser's estimate); libavif's own encoder, the one cv2
bundles, writes what neither does: 4:2:2 and 4:4:4 above 8 bits, limited
range, BT.709 and BT.2020, and film grain above 8 bits. Sizes are odd
where it matters (libaom pads a frame to even sizes before it adds grain),
seeded cuts and byte flips of each kind give what cv2 gives, and av1.cpp's
counts show the files reach each tool at 10 bits and at 4:2:2."""

import numpy as np
import pytest
import cv2

from ocr_inference_tpu_torch import native
from ocr_inference_tpu_torch.io.images import (
    _avif_container, read_image, unsupported,
)
from tests.image_writers import libavif_encode, ycbcr_planes
from tests.test_torch_avif import (
    _clean, _counts, _cv2_avif, _cv2_rgb, _few_colours, _pil_avif, _same,
    _scan,
)


def _info(data: bytes) -> np.ndarray:
    rc, info = native.av1_info(_avif_container(data)["cells"][0])
    assert rc == 0
    return info


def _deep(img: np.ndarray, depth: int) -> np.ndarray:
    """An 8-bit image widened to ``depth`` bits, its low bits set from the
    image itself so that they are not all zero."""
    wide = img.astype(np.uint16) << (depth - 8)
    return wide | (img.astype(np.uint16) >> (16 - depth))


def _colourful() -> np.ndarray:
    """A 97x131 crop of the scanned page's text over smooth random colour
    (the page itself is gray, so its chroma says little)."""
    rng = np.random.default_rng(7)
    small = rng.integers(0, 256, (15, 19, 3), np.uint8)
    colour = cv2.resize(small, (131, 97), interpolation=cv2.INTER_CUBIC)
    text = _scan()[:97, :131]
    return np.where(text < 128, text, colour).astype(np.uint8)


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("quality,speed", [(30, 6), (60, 9), (90, 4),
                                           (100, 9)])
def test_cv2_depths(tmp_path, depth, quality, speed):
    """cv2's files of 10 and 12 bits (profile 0 and 2) of the scanned page
    and of colour, at several qualities and speeds; quality 100 is a
    lossless 4:4:4 frame with the identity matrix (libavif's float unorm
    to 8 bits)."""
    for img in (_scan()[:97, :333], _colourful()):
        data = _cv2_avif(_deep(img, depth), cv2.IMWRITE_AVIF_DEPTH, depth,
                         cv2.IMWRITE_AVIF_QUALITY, quality,
                         cv2.IMWRITE_AVIF_SPEED, speed)
        info = _info(data)
        assert info[2] == depth
        if quality == 100:
            assert info[7] == 0 and info[4:6].tolist() == [0, 0]
            assert info[10] >> 9 & 1  # coded lossless
        assert _same(tmp_path / "x.avif", data) is not None


def test_every_sample_of_the_identity_matrix(tmp_path):
    """Lossless ramps through every 10- and 12-bit value: the identity
    matrix's float unorm and monochrome's rounding (half to even) at each
    value."""
    for depth in (10, 12):
        ramp = (np.arange(97 * 131) % (1 << depth)).reshape(97, 131)
        ramp = ramp.astype(np.uint16)
        for img in (np.dstack([ramp, ramp[::-1], ramp[:, ::-1]]), ramp):
            data = _cv2_avif(img, cv2.IMWRITE_AVIF_DEPTH, depth,
                             cv2.IMWRITE_AVIF_QUALITY, 100)
            assert _same(tmp_path / "x.avif", data) is not None


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("quality", [60, 100])
def test_monochrome_from_gray(tmp_path, depth, quality):
    """cv2's monochrome files from uint16 gray: the Y plane scaled to 8
    bits as cv2 copies it."""
    gray = cv2.cvtColor(_scan()[:120, :257], cv2.COLOR_RGB2GRAY)
    data = _cv2_avif(_deep(gray, depth), cv2.IMWRITE_AVIF_DEPTH, depth,
                     cv2.IMWRITE_AVIF_QUALITY, quality)
    assert _info(data)[3] == 1
    assert _same(tmp_path / "x.avif", data) is not None


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("quality", [60, 100])
def test_alpha_at_depth(tmp_path, depth, quality):
    """cv2's BGRA files of 10 and 12 bits: the alpha item decoded and
    dropped, the colour through libyuv's I010 (10 bits) or I012 (12 bits,
    4:2:0 by the nearest sample) as libavif takes them with alpha."""
    page = _colourful()
    alpha = np.linspace(0, 255, page.shape[1]).astype(np.uint8)
    rgba = np.dstack([page, np.broadcast_to(alpha, page.shape[:2])])
    data = _cv2_avif(_deep(rgba, depth), cv2.IMWRITE_AVIF_DEPTH, depth,
                     cv2.IMWRITE_AVIF_QUALITY, quality)
    assert _avif_container(data)["alpha"] is not None
    assert _same(tmp_path / "x.avif", data) is not None


@pytest.mark.parametrize("speed", [None, 2, 9])
def test_pillow_422(tmp_path, speed):
    """Pillow's 4:2:2 (AV1 profile 2, 8 bits) at its default speed and at
    speeds 2 and 9, on the clean and scanned pages and on colour: chroma
    halved only across, libyuv's linear 4:2:2 upsampling."""
    save = {"subsampling": "4:2:2"}
    if speed is not None:
        save["speed"] = speed
    for img in (_clean()[:, :257], _scan()[:97, :301], _colourful()):
        data = _pil_avif(img, **save)
        info = _info(data)
        assert info[4:6].tolist() == [1, 0]
        assert _same(tmp_path / "x.avif", data) is not None


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2", "4:4:4"])
def test_film_grain(tmp_path, subsampling):
    """libaom's film grain test vectors (scaling points of Y alone, of all
    planes, chroma scaled from luma; AR lags 2 and 3; with and without
    overlap) and the grain libaom's denoiser estimates, at an odd size:
    synthesised and added as libaom adds it to the frame cv2 gets."""
    page = _colourful()
    for vector in (1, 4, 6, 12, 15, 16):
        data = _pil_avif(page, speed=9, subsampling=subsampling,
                         advanced={"film-grain-test": str(vector)})
        assert _counts(data)["grain"] == 1
        assert _same(tmp_path / "x.avif", data) is not None
    scan = _scan()[:301, :411]
    data = _pil_avif(scan, speed=6, subsampling=subsampling,
                     advanced={"denoise-noise-level": "25"})
    # libaom's denoiser does not take 4:2:2 and then writes no grain
    assert _counts(data)["grain"] == (subsampling != "4:2:2")
    assert _same(tmp_path / "x.avif", data) is not None


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("layout", ["420", "422", "444"])
def test_libavif_layouts(tmp_path, depth, layout):
    """libavif's encoder on every depth and layout: full and limited range,
    BT.601, BT.709 and BT.2020 constants, with and without alpha (which
    above 8 bits takes libyuv's I010, I210, I410 and I012), and film grain
    at the depth (clipped to the restricted range at limited range)."""
    page = _colourful()
    planes = ycbcr_planes(page, layout, depth)
    alpha = np.full(page.shape[:2], 77 << (depth - 8))
    for matrix, full in ((6, True), (1, False), (9, True), (9, False)):
        for a in (None, alpha):
            data = libavif_encode(planes, depth, layout, full, matrix,
                                  speed=9, alpha=a)
            assert _same(tmp_path / "x.avif", data) is not None
    for full in (True, False):
        data = libavif_encode(planes, depth, layout, full, 1, speed=9,
                              options={"film-grain-test": "3"})
        used = _counts(data)
        assert used["grain"] == 1 and used["grain_clip"] == (not full)
        assert _same(tmp_path / "x.avif", data) is not None


def test_monochrome_with_alpha_gives_none(tmp_path):
    """A monochrome frame with an alpha item: cv2's AvifDecoder fails it
    (its copy takes gray with alpha for four channels), at every depth."""
    gray = cv2.cvtColor(_colourful(), cv2.COLOR_RGB2GRAY)
    for depth in (8, 10, 12):
        data = libavif_encode(ycbcr_planes(np.dstack([gray] * 3), "400",
                                           depth), depth, "400", speed=9,
                              alpha=np.full(gray.shape, 9 << (depth - 8)))
        assert _same(tmp_path / "x.avif", data) is None


KINDS = {
    "cv2_10": lambda: _cv2_avif(_deep(_scan()[:120, :300], 10),
                                cv2.IMWRITE_AVIF_DEPTH, 10),
    "cv2_12_lossless": lambda: _cv2_avif(
        _deep(_colourful(), 12), cv2.IMWRITE_AVIF_DEPTH, 12,
        cv2.IMWRITE_AVIF_QUALITY, 100),
    "pillow_422": lambda: _pil_avif(_scan()[:120, :300], speed=9,
                                    subsampling="4:2:2"),
    "grain_420": lambda: _pil_avif(_colourful(), speed=9,
                                   advanced={"film-grain-test": "4"}),
    "grain_10_422": lambda: libavif_encode(
        ycbcr_planes(_colourful(), "422", 10), 10, "422", speed=9,
        options={"film-grain-test": "2"}),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_cuts_and_flips(tmp_path, kind):
    """Seeded cuts and byte corruptions of each kind of file: each equals
    cv2, or gives None where cv2 gives None; a corruption that makes the
    headers declare a refused variant raises NotImplementedError naming
    it."""
    base = KINDS[kind]()
    rng = np.random.default_rng(sum(map(ord, kind)))
    path = tmp_path / "x.avif"
    outcomes = {"equal": 0, "none": 0, "refused": 0}
    for i in range(40):
        data = bytearray(base)
        if i % 3 == 0:
            data = data[:int(rng.integers(1, len(data)))]
        elif i % 3 == 1:
            data[int(rng.integers(0, len(data)))] ^= 1 << int(
                rng.integers(0, 8))
        else:
            at = int(rng.integers(len(data) // 2, len(data)))
            data[at] = int(rng.integers(0, 256))
        path.write_bytes(bytes(data))
        try:
            got = read_image(path)
        except NotImplementedError as e:
            assert unsupported(path) == str(e).split(": ", 1)[1]
            outcomes["refused"] += 1
            continue
        want = _cv2_rgb(path)
        if want is None:
            assert got is None, i
            outcomes["none"] += 1
        else:
            np.testing.assert_array_equal(got, want, err_msg=str(i))
            outcomes["equal"] += 1
    assert outcomes["none"] >= 20, outcomes


def test_the_files_reach_every_tool(tmp_path):
    """At 10 bits and at 4:2:2, files whose counts show a Y and a UV
    palette, an intra block copy, a Wiener and a self-guided unit; and
    grain with and without chroma scaled from luma and overlap."""
    blurred = cv2.GaussianBlur(np.random.default_rng(0).integers(
        0, 256, (96, 96, 3), np.uint8), (0, 0), 1.5)
    scan, clean = _scan()[:256, :384], _clean()[:, :512]
    files = {
        "10 bits": [
            _cv2_avif(_deep(clean, 10), cv2.IMWRITE_AVIF_DEPTH, 10,
                      cv2.IMWRITE_AVIF_SPEED, 2),
            libavif_encode(ycbcr_planes(_few_colours(5), "444", 10), 10,
                           "444", quality=95),
            libavif_encode(ycbcr_planes(blurred, "422", 10), 10, "422",
                           speed=2),
            libavif_encode(ycbcr_planes(scan, "420", 10), 10, "420",
                           speed=0)],
        "4:2:2": [
            _pil_avif(_few_colours(5), quality=95, subsampling="4:2:2"),
            _pil_avif(clean, subsampling="4:2:2", speed=6),
            _pil_avif(blurred, speed=2, subsampling="4:2:2"),
            _pil_avif(np.ascontiguousarray(_scan()[100:356, 300:700]),
                      subsampling="4:2:2", speed=0)],
    }
    for name, datas in files.items():
        total = {}
        for data in datas:
            _same(tmp_path / "x.avif", data)
            for k, v in _counts(data).items():
                if isinstance(v, int):
                    total[k] = total.get(k, 0) + v
        for k in ("palette_y", "palette_uv", "intrabc", "wiener",
                  "self_guided"):
            assert total[k] >= 1, (name, total)
    page = _colourful()
    grain = [_counts(_pil_avif(page, speed=9,
                               advanced={"film-grain-test": str(v)}))
             for v in (1, 2, 15)]
    assert [g["grain_overlap"] for g in grain] == [0, 1, 1]
    assert [g["grain_from_luma"] for g in grain] == [0, 0, 1]
