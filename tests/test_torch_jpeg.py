"""The port's JPEG reader (io/images.py read_image, native/jpeg.cpp)
against ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` on files that
cv2 and PIL write here: byte-equal at every sampling factor cv2.imwrite
offers, baseline and progressive, with restart intervals, optimised
Huffman tables, gray, CMYK and YCCK, EXIF orientations 1-8, odd sizes,
truncated files (progressive ones smoothed as libjpeg smooths them),
complete progressive files with scans left out, and corrupt data; headers
once refused by name (arithmetic, lossless, 12-bit) now read as cv2 reads
them (test_torch_jpeg_variants.py: real files of each)."""

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from ocr_inference_tpu_torch.io.images import (
    image_format, read_image, unsupported,
)
from tests.image_writers import drop_scans, jpeg_scans

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
    smooths, decodes as cv2 decodes it (it was refused by name before the
    reader smoothed)."""
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
    _assert_same_as_cv2(path)


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


def _lossless_scan(data: bytes) -> bytes:
    """A baseline JPEG's scan header made a lossless one's (predictor 1,
    Se 0, no point transform), as libjpeg checks it for a lossless frame."""
    out = bytearray(data)
    at = data.index(b"\xff\xda")
    ns = out[at + 4]
    out[at + 5 + 2 * ns: at + 8 + 2 * ns] = b"\x01\x00\x00"
    return bytes(out)


@pytest.mark.parametrize("variant,name", [
    ({"marker": 0xC9}, "arithmetic-coded JPEG"),
    ({"marker": 0xCA}, "arithmetic-coded JPEG"),
    ({"marker": 0xC3}, "lossless JPEG"),
    ({"precision": 12}, "12- or 16-bit"),
])
def test_variants_once_refused_by_name(tmp_path, variant, name):
    """These headers were refused by name. A baseline file's SOF made SOF9
    or SOF10 now decodes its Huffman data as arithmetic-coded data, as
    libjpeg does; made lossless it gives None with a sequential scan
    header (libjpeg fails on it) and with a lossless one (a JFIF YCbCr
    frame, which libjpeg-turbo does not convert in lossless mode); at 12
    bits it gives None (OpenCV reads 8 bits). Equal to cv2 each time, and
    unsupported() names none of them (test_torch_jpeg_variants.py has
    real files of each)."""
    data = _write(tmp_path / "b.jpg", _page(16, 16)).read_bytes()
    path = tmp_path / "v.jpg"
    patched = _patched_sof(data, **variant)
    if variant.get("marker") == 0xC3:
        path.write_bytes(patched)
        assert _cv2_rgb(path) is None and read_image(path) is None
        patched = _lossless_scan(patched)
    path.write_bytes(patched)
    want, got = _cv2_rgb(path), read_image(path)
    if want is None:
        assert got is None, name
    else:
        np.testing.assert_array_equal(got, want)
    assert unsupported(path) is None


def test_cmyk_refused_by_name(tmp_path):
    """Once refused by name, a CMYK JPEG (PIL writes Adobe's inverted
    CMYK) now decodes as cv2 decodes it: libjpeg's CMYK, then OpenCV's
    icvCvt_CMYK2BGR_8u_C4C3R. test_cmyk_and_ycck covers the layouts."""
    path = tmp_path / "cmyk.jpg"
    Image.fromarray(_page(16, 24)).convert("CMYK").save(path, "JPEG")
    _assert_same_as_cv2(path)


def _cmyk_file(path, img, ycck, **save):
    """PIL's CMYK JPEG (Adobe transform 0); with ``ycck`` its transform
    byte set to 2, which libjpeg decodes as YCCK (PIL cannot write YCCK)."""
    Image.fromarray(img).convert("CMYK").save(path, "JPEG", **save)
    if ycck:
        data = bytearray(path.read_bytes())
        data[data.index(b"Adobe") + 11] = 2
        path.write_bytes(bytes(data))
    return path


@pytest.mark.parametrize("ycck", [False, True])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("size", [(1, 1), (16, 24), (37, 53), (9, 200)])
def test_cmyk_and_ycck(tmp_path, ycck, progressive, subsampling, size):
    """Four components, the first sampled 1x1, 2x1 or 2x2 (PIL's
    subsampling for CMYK)."""
    img = _page(*size, seed=size[0])
    for quality in (50, 95):
        _assert_same_as_cv2(_cmyk_file(tmp_path / "c.jpg", img, ycck,
                                       quality=quality,
                                       subsampling=subsampling,
                                       progressive=progressive))


def test_cmyk_truncated(tmp_path):
    img = _page(40, 56, seed=2)
    for progressive in (False, True):
        data = _cmyk_file(tmp_path / "c.jpg", img, False,
                          progressive=progressive).read_bytes()
        for cut in range(len(data) // 4, len(data), len(data) // 7):
            path = tmp_path / "t.jpg"
            path.write_bytes(data[:cut])
            want, got = _cv2_rgb(path), read_image(path)
            assert (want is None) == (got is None), cut
            if want is not None:
                np.testing.assert_array_equal(got, want)


def _cuts(data: bytes) -> list[int]:
    """Cut points across a progressive file: inside every scan (a third
    and two thirds in), right after it, and inside each scan header."""
    cuts = []
    for start, end, _ in jpeg_scans(data):
        cuts += [start + 3, start + (end - start) // 3,
                 start + 2 * (end - start) // 3, end]
    return sorted(set(c for c in cuts if c < len(data)))


@pytest.mark.parametrize("encoder,sampling", [
    ("cv2", "gray"), ("cv2", "444"), ("cv2", "420"), ("cv2", "422"),
    ("cv2", "411"), ("cv2", "440"), ("pil", "gray"), ("pil", "444"),
    ("pil", "420"), ("pil", "422")])
@pytest.mark.parametrize("size", [(8, 16), (17, 9), (64, 80), (130, 90)])
def test_smoothed_progressive_truncations(tmp_path, encoder, sampling, size):
    """libjpeg-turbo 3.1 smooths a progressive file whose scans leave one
    of the first 10 coefficients of a component unsent or short of bits
    (jdcoefct.c decompress_smooth_data: the 5x5 DC neighbourhood, the
    previous scan's coefficient bits past the last good iMCU row). Cut
    after the DC scan, inside AC first scans and refinements, and inside
    the scan headers (cv2 gives None there, and so does the reader);
    narrow pictures of two block columns included."""
    img = _page(*size, seed=size[1], gray=sampling == "gray")
    path = tmp_path / "p.jpg"
    if encoder == "cv2":
        data = _write(path, img, sampling="420" if sampling == "gray"
                      else sampling, progressive=1).read_bytes()
    else:
        Image.fromarray(img).save(path, "JPEG", quality=85, progressive=True,
                                  subsampling={"gray": 0, "444": 0, "422": 1,
                                               "420": 2}[sampling])
        data = path.read_bytes()
    for cut in _cuts(data):
        path.write_bytes(data[:cut])
        want, got = _cv2_rgb(path), read_image(path)
        assert (want is None) == (got is None), cut
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=str(cut))


@pytest.mark.parametrize("sampling", ["gray", "444", "420", "440"])
@pytest.mark.parametrize("restart", [0, 3])
def test_smoothed_progressive_with_scans_left_out(tmp_path, sampling,
                                                  restart):
    """A complete progressive file whose scans leave bits unsent: each
    scan left out in turn, and every refinement scan left out."""
    img = _page(45, 70, seed=restart, gray=sampling == "gray")
    data = _write(tmp_path / "p.jpg", img, sampling="420" if sampling ==
                  "gray" else sampling, progressive=1,
                  restart=restart).read_bytes()
    path = tmp_path / "d.jpg"
    variants = [drop_scans(data, lambda j, h, i=i: j == i)
                for i in range(len(jpeg_scans(data)))]
    variants.append(drop_scans(data, lambda j, h: h["ah"] > 0))
    for blob in variants:
        path.write_bytes(blob)
        _assert_same_as_cv2(path)


@pytest.mark.parametrize("seed", range(4))
def test_corrupt_data(tmp_path, seed):
    """Bytes flipped anywhere and files cut short, baseline and
    progressive, with and without restarts, gray, colour and CMYK: the
    reader gives what cv2 gives, None included (bad Huffman codes, bogus
    segment lengths and markers, tables a scan finds undefined). The
    damage may make a frame arithmetic-coded or lossless by its headers,
    and then libjpeg and the reader part: those cases are left out."""
    rng = np.random.RandomState(seed)
    path = tmp_path / "f.jpg"
    for trial in range(150):
        kind = trial % 6
        img = _page(rng.randint(1, 60), rng.randint(1, 60), seed=trial,
                    gray=kind == 5)
        if kind == 4:
            data = _cmyk_file(path, img, False, quality=80,
                              progressive=bool(trial % 2)).read_bytes()
        else:
            data = _write(path, img, sampling=sorted(SAMPLING)[trial % 5],
                          progressive=kind % 2,
                          restart=(kind // 2) * 2).read_bytes()
        data = bytearray(data)
        for _ in range(rng.randint(1, 4)):
            data[rng.randint(2, len(data))] = rng.randint(0, 256)
        if rng.rand() < 0.3:
            data = data[: rng.randint(2, len(data))]
        path.write_bytes(bytes(data))
        want = _cv2_rgb(path)
        try:
            got = read_image(path)
        except NotImplementedError as e:
            assert "arithmetic" in str(e) or "lossless" in str(e), trial
            continue
        assert (want is None) == (got is None), trial
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=str(trial))

