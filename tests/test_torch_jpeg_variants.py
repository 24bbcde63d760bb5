"""The JPEG variants once refused by name (io/images.py read_image,
native/jpeg.cpp) against ``cv2.cvtColor(cv2.imread(path),
cv2.COLOR_BGR2RGB)``, on files written by tests/image_writers.py's
encoders (cv2 and PIL write none of them): arithmetic-coded sequential and
progressive JPEG (T.81 Annex D, with restarts and DAC conditioning),
lossless JPEG (Annex H: predictors 1-7, point transforms, precisions 2-16,
restarts) and 12-bit DCT JPEG, in .jpg files and in JPEG-in-TIFF strips,
intact, cut and corrupted: byte-equal with cv2, or None where cv2 gives
None (12-bit frames, lossless frames libjpeg-turbo would have to convert
or that are wider than 8 bits); unsupported() names none of them."""

import cv2
import numpy as np
import pytest

from ocr_inference_tpu_torch.io.images import read_image, unsupported
from tests.image_writers import (
    jpeg_arith, jpeg_dct, jpeg_lossless, write_tiff,
)

ADOBE = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00"
JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def _cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _as_cv2(path) -> bool:
    """read_image(path) equal to cv2's decode, or None with it."""
    want = _cv2_rgb(path)
    got = read_image(path)
    if want is None or got is None:
        return want is None and got is None
    return want.shape == got.shape and bool((want == got).all())


def _page(h, w, nc, seed):
    """Smooth planes with noise, one a component."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.sin(x / 6.0) * 70 + np.cos(y / 4.0) * 60 + 128
    return [(base * (1 - 0.3 * c) + 60 * c + rng.rand(h, w) * 25).clip(
        0, 255) for c in range(nc)]


def _subsampled(planes, sampling):
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    return [p[:: vmax // v, :: hmax // h] for p, (h, v) in zip(planes,
                                                                 sampling)]


ARITH = [
    (1, None, False, 0, None), (1, None, True, 0, None),
    (3, None, False, 0, None), (3, [(2, 2), (1, 1), (1, 1)], False, 0, None),
    (3, [(2, 1), (1, 1), (1, 1)], True, 0, None),
    (3, [(2, 2), (1, 1), (1, 1)], True, 7, None),
    (3, [(1, 2), (1, 1), (1, 1)], False, 4,
     {("L", 0): 1, ("U", 0): 4, ("K", 0): 3}),
    (1, None, True, 5, {("L", 0): 0, ("U", 0): 15, ("K", 0): 63}),
    (4, None, False, 0, None), (4, [(2, 2), (1, 1), (1, 1), (2, 2)], True,
                                0, None),
]


@pytest.mark.parametrize("size", [(1, 1), (13, 21), (37, 53), (64, 80)])
@pytest.mark.parametrize("case", ARITH, ids=lambda c: "nc%d-%s-%s-r%d-%s" % (
    c[0], "".join(f"{h}{v}" for h, v in c[1] or [(1, 1)]),
    "prog" if c[2] else "seq", c[3], "dac" if c[4] else "std"))
def test_arithmetic(tmp_path, case, size):
    """Arithmetic-coded JPEG (SOF9 one interleaved scan, SOF10 libjpeg's
    default progressive script with successive approximation) of gray,
    YCbCr and CMYK pages at several samplings, with restart intervals and
    DAC conditioning: jdarith.c's decode, byte-equal with cv2; cv2's own
    decode is near the source page, so the encoder is T.81's."""
    nc, sampling, progressive, restart, dac = case
    sampling = sampling or [(1, 1)] * nc
    planes = _page(*size, nc, seed=size[0] + nc)
    data = jpeg_arith(_subsampled(planes, sampling), sampling, progressive,
                      restart, dac, size=size,
                      adobe=0 if nc == 4 else None)
    path = tmp_path / "a.jpg"
    path.write_bytes(data)
    assert _as_cv2(path) and unsupported(path) is None
    if nc == 1 and size[0] > 8:
        err = np.abs(read_image(path)[..., 0].astype(float) - planes[0])
        assert err.mean() < 6


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("nc", [1, 3])
def test_arithmetic_cut_and_corrupted(tmp_path, progressive, nc):
    """300 seeded corruptions and cuts of arithmetic-coded files: zeros
    fed past a marker or the end of the data, magnitude and spectral
    overflows (JWRN_ARITH_BAD_CODE) leaving blocks alone up to the next
    restart, as libjpeg does."""
    sampling = [(2, 2), (1, 1), (1, 1)][:nc] if nc == 3 else [(1, 1)]
    planes = _page(40, 56, nc, seed=nc)
    data = jpeg_arith(_subsampled(planes, sampling), sampling, progressive,
                      restart=6 if nc == 3 else 0, size=(40, 56))
    scan = data.index(b"\xff\xda")
    rng = np.random.RandomState(nc + 2 * progressive)
    path = tmp_path / "c.jpg"
    bad = []
    for k in range(300):
        d = bytearray(data)
        if rng.rand() < 0.5:
            for _ in range(rng.randint(1, 4)):
                d[rng.randint(scan, len(d))] ^= int(rng.randint(1, 256))
        if rng.rand() < 0.5:
            d = d[: rng.randint(scan, len(d))]
        path.write_bytes(bytes(d))
        if not _as_cv2(path):
            bad.append(k)
    assert bad == []


def _with_markers(data: bytes, jfif=False, adobe=None) -> bytes:
    head = (JFIF if jfif else b"") + (ADOBE + bytes([adobe])
                                      if adobe is not None else b"")
    return data[:2] + head + data[2:]


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("precision,pt", [(8, 0), (8, 3), (2, 0), (6, 1),
                                          (12, 0), (16, 2)])
@pytest.mark.parametrize("nc", [1, 3, 4])
def test_lossless(tmp_path, predictor, precision, pt, nc):
    """Lossless JPEG (SOF3) of random samples at every predictor and
    point transform, restarts every 3 rows: jdlossls.c's undifferencing.
    OpenCV reads 8-bit samples and libjpeg-turbo converts no colours in
    lossless mode, so RGB and CMYK frames of 8 bits or fewer decode
    (samples not scaled: a 6-bit frame reads 0-63), and gray frames and
    frames of more than 8 bits give None, as cv2."""
    rng = np.random.RandomState(predictor * 31 + precision + nc)
    samples = rng.randint(0, 1 << precision, (19, 27, nc))
    samples[5:12] = samples[5:6]  # rows a predictor gets right
    path = tmp_path / "l.jpg"
    path.write_bytes(jpeg_lossless(samples, precision, predictor, pt,
                                   restart_rows=3))
    assert _as_cv2(path) and unsupported(path) is None
    if nc == 3 and precision <= 8:
        np.testing.assert_array_equal(read_image(path),
                                      samples >> pt << pt)


@pytest.mark.parametrize("nc,jfif,adobe", [
    (3, True, None), (3, False, 0), (3, False, 1), (4, False, 0),
    (4, False, 2), (3, False, None)])
def test_lossless_colour_spaces(tmp_path, nc, jfif, adobe):
    """A JFIF marker or Adobe transform 1 makes three components YCbCr
    and transform 2 makes four YCCK, which libjpeg-turbo does not convert
    in lossless mode: None, as cv2; RGB (transform 0, or none) and CMYK
    decode."""
    samples = np.random.RandomState(nc).randint(0, 256, (9, 14, nc))
    path = tmp_path / "l.jpg"
    path.write_bytes(_with_markers(jpeg_lossless(samples, 8, 4), jfif,
                                   adobe))
    assert _as_cv2(path) and unsupported(path) is None
    assert (read_image(path) is None) == (jfif or adobe not in (None, 0))


def test_lossless_cut_corrupted_and_refused(tmp_path):
    """300 seeded corruptions and cuts of a lossless file (a row begun
    after the data ran out is 2^(P-1), rows with bad codes are what
    libjpeg makes of them); arithmetic-coded lossless (SOF11) and a
    restart interval that is not whole rows give None, as cv2; a frame
    with a subsampled component is refused by name."""
    rng = np.random.RandomState(7)
    samples = rng.randint(0, 256, (24, 30, 3))
    samples[:, 10:20] = 90
    data = jpeg_lossless(samples, 8, 6, restart_rows=4)
    scan = data.index(b"\xff\xda")
    path = tmp_path / "l.jpg"
    bad = []
    for k in range(300):
        d = bytearray(data)
        if rng.rand() < 0.5:
            for _ in range(rng.randint(1, 4)):
                d[rng.randint(scan, len(d))] ^= int(rng.randint(1, 256))
        if rng.rand() < 0.5:
            d = d[: rng.randint(scan, len(d))]
        path.write_bytes(bytes(d))
        if not _as_cv2(path):
            bad.append(k)
    assert bad == []
    d = bytearray(data)
    d[d.index(b"\xff\xc3") + 1] = 0xCB
    path.write_bytes(bytes(d))
    assert _cv2_rgb(path) is None and read_image(path) is None
    d = bytearray(data)
    at = d.index(b"\xff\xdd")
    d[at + 5] += 1  # 4 rows and one sample
    path.write_bytes(bytes(d))
    assert _cv2_rgb(path) is None and read_image(path) is None
    d = bytearray(data)
    d[d.index(b"\xff\xc3") + 11] = 0x21
    path.write_bytes(bytes(d))
    assert _cv2_rgb(path) is not None
    with pytest.raises(NotImplementedError, match="lossless JPEG with "
                       "subsampled components"):
        read_image(path)
    assert "subsampled" in unsupported(path)


@pytest.mark.parametrize("nc", [1, 3])
@pytest.mark.parametrize("progressive", [False, True])
def test_twelve_bit(tmp_path, nc, progressive):
    """12-bit DCT JPEG (SOF1, 16-bit quantisation tables; SOF2 by header)
    decodes in libjpeg-turbo only through jpeg12_read_scanlines, which
    OpenCV 5.0 does not call: None, as cv2, and not refused by name."""
    planes = [p * 16 for p in _page(24, 40, nc, seed=nc)]
    data = bytearray(jpeg_dct(planes, 12))
    if progressive:
        data[data.index(b"\xff\xc1") + 1] = 0xC2
    path = tmp_path / "t.jpg"
    path.write_bytes(bytes(data))
    assert _cv2_rgb(path) is None
    assert read_image(path) is None and unsupported(path) is None


def _tiff_of(path, streams, photometric, spp, rows, tile=None, tags=None):
    shape = {"tile": tile} if tile else {"rows_per_strip": rows}
    h = rows * len(streams) if not tile else 32
    w = 48 if not tile else 64
    write_tiff(path, [dict(samples=np.zeros((h, w, spp), np.uint8), bits=8,
                           photometric=photometric, compression=7,
                           chunks=streams, tags=tags or {}, **shape)])


@pytest.mark.parametrize("kind", ["gray", "rgb", "ycbcr", "ycbcr_tiles"])
@pytest.mark.parametrize("progressive", [False, True])
def test_arithmetic_in_tiff(tmp_path, kind, progressive):
    """Arithmetic-coded JPEG-in-TIFF strips and tiles (gray, RGB, YCbCr
    turned into RGB by libjpeg as libtiff asks): equal to cv2, intact and
    with 100 corrupted copies of one strip."""
    nc = 1 if kind == "gray" else 3
    sampling = [(2, 2), (1, 1), (1, 1)] if "ycbcr" in kind else \
        [(1, 1)] * nc
    tile = (32, 16) if kind == "ycbcr_tiles" else None
    blocks = [(16, 48)] * 3 if not tile else [(16, 32)] * 4
    streams = []
    for i, size in enumerate(blocks):
        planes = _page(*size, nc, seed=i)
        streams.append(jpeg_arith(_subsampled(planes, sampling), sampling,
                                  progressive, size=size,
                                  ids=[82, 71, 66] if kind == "rgb"
                                  else None))
    phot = {"gray": 1, "rgb": 2}.get(kind, 6)
    tags = {530: (3, [2, 2])} if phot == 6 else {}
    path = tmp_path / "a.tif"
    _tiff_of(path, streams, phot, nc, 16, tile, tags)
    assert _as_cv2(path) and unsupported(path) is None
    rng = np.random.RandomState(len(kind))
    for k in range(100):
        bad = list(streams)
        i = rng.randint(len(bad))
        d = bytearray(bad[i])
        d[rng.randint(len(d) // 3, len(d))] ^= int(rng.randint(1, 256))
        bad[i] = bytes(d[: len(d) if rng.rand() < 0.5 else
                         rng.randint(len(d) // 3, len(d))])
        _tiff_of(path, bad, phot, nc, 16, tile, tags)
        assert _as_cv2(path), k


@pytest.mark.parametrize("kind,precision,ok", [
    ("gray", 8, True), ("rgb", 8, True), ("gray", 6, False),
    ("ycbcr", 8, False), ("twelve", 12, False)])
def test_lossless_and_twelve_bit_in_tiff(tmp_path, kind, precision, ok):
    """Lossless strips decode in an 8-bit TIFF page when they are 8-bit
    and the page asks libjpeg for no colour conversion (gray, RGB); a
    lossless strip of other precision or in a YCbCr page, and a 12-bit DCT
    strip, fail libtiff's JPEGPreDecode: None, as cv2."""
    rng = np.random.RandomState(precision)
    nc = 1 if kind in ("gray", "twelve") else 3
    if kind == "twelve":
        streams = [jpeg_dct([p * 16 for p in _page(16, 48, 1, seed=i)], 12)
                   for i in range(2)]
    else:
        streams = [jpeg_lossless(rng.randint(0, 1 << precision,
                                             (16, 48, nc)), precision, 7)
                   for _ in range(2)]
    phot = {"gray": 1, "twelve": 1, "rgb": 2, "ycbcr": 6}[kind]
    path = tmp_path / "l.tif"
    _tiff_of(path, streams, phot, nc, 16,
             tags={530: (3, [1, 1])} if phot == 6 else {})
    assert _as_cv2(path) and unsupported(path) is None
    assert (read_image(path) is not None) == ok
