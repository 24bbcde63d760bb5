"""The port's AVIF reader (io/images.py over native/av1.cpp) against
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` (cv2 5.0's
AvifDecoder over libavif 1.4.2 and libaom 3.14.1), byte for byte and None
for None: the committed files, cv2's files at every quality and speed
that keeps screen-content tools off, sizes that are not multiples of 8,
monochrome and alpha, Pillow's 4:4:4 and 4:2:0 files in several tiles and
at limited range, seeded noise, libaom's coding tools switched on one at a
time (quantiser matrices, segmentation, delta q and lf, ...), and seeded
cuts and corruptions. The variants the reader refuses are made by the
tools that write them and raise NotImplementedError naming them, with
unsupported() saying the same."""

import io
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from ocr_inference_tpu_torch import native
from ocr_inference_tpu_torch.io.images import (
    _avif_container, image_format, read_image, unsupported,
)

IMAGES = Path(__file__).parent / "data" / "torch_port" / "images"
RECORD = Path(__file__).parent / "data" / "torch_port" / "images.json"


def _cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _same(path, data=None):
    """read_image equals cv2 (an image or None), image_format says AVIF
    and unsupported() has nothing to say; returns cv2's image."""
    if data is not None:
        path.write_bytes(data)
    want, got = _cv2_rgb(path), read_image(path)
    if want is None:
        assert got is None, path.name
    else:
        assert got is not None and got.shape == want.shape, path.name
        np.testing.assert_array_equal(got, want, err_msg=path.name)
    assert unsupported(path) is None
    return want


def _scan():
    """The scanned fixture page (RGB): cv2 keeps screen-content tools off
    on it at every speed."""
    return _cv2_rgb(IMAGES / "pages" / "skew_2deg.jpg")


def _cv2_avif(img, *params):
    """cv2's AVIF of an RGB, RGBA or gray image."""
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    ok, buf = cv2.imencode(".avif", np.ascontiguousarray(img), list(params))
    assert ok
    return buf.tobytes()


def _pil_avif(img, **save):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "AVIF", **save)
    return buf.getvalue()


def _tools(data: bytes) -> int:
    """The coding tools the primary item's frame header declares (av1.cpp
    ocr_av1_info's info[10])."""
    rc, info = native.av1_info(_avif_container(data)["color"])
    assert rc == 0
    return int(info[10])


def test_committed_avif_files():
    """Every committed AVIF file decodes to cv2's shape and sha256 of the
    record, and to cv2's own decode; the cut one gives None."""
    import hashlib

    record = json.loads(RECORD.read_text(encoding="utf-8"))["files"]
    names = [rel for rel in record if rel.endswith(".avif")]
    assert len(names) >= 7
    for rel in names:
        want = record[rel]
        got = read_image(IMAGES / rel)
        if want["shape"] is None:
            assert got is None and _cv2_rgb(IMAGES / rel) is None, rel
            continue
        assert list(got.shape) == want["shape"], rel
        assert hashlib.sha256(np.ascontiguousarray(got).tobytes()) \
            .hexdigest() == want["sha256"], rel
        np.testing.assert_array_equal(got, _cv2_rgb(IMAGES / rel),
                                      err_msg=rel)
        assert image_format(IMAGES / rel) == "AVIF"
        assert unsupported(IMAGES / rel) is None


@pytest.mark.parametrize("quality", [0, 10, 30, 50, 70, 90, 100])
def test_cv2_qualities(tmp_path, quality):
    """cv2's files at each quality (100 is lossless: 4:4:4, identity
    matrix, WHT) on strips of the scanned page, at sizes that are not
    multiples of 8."""
    page = _scan()
    for h, w in ((1, 1), (7, 65), (63, 129), (129, 7), (100, 300)):
        y0 = 40 if h < 100 else 0
        _same(tmp_path / "x.avif",
              _cv2_avif(page[y0:y0 + h, :w], cv2.IMWRITE_AVIF_QUALITY,
                        quality))


@pytest.mark.parametrize("speed", [5, 6, 7, 8, 9, 10])
def test_cv2_speeds(tmp_path, speed):
    """cv2's encoder speeds 5-10 (other partitions, transform sets and
    intra tools) on a strip of the scanned page."""
    _same(tmp_path / "x.avif", _cv2_avif(
        _scan()[:160, :448], cv2.IMWRITE_AVIF_QUALITY, 60,
        cv2.IMWRITE_AVIF_SPEED, speed))


@pytest.mark.parametrize("kind", ["mono_cv2", "mono_pillow", "alpha_cv2",
                                  "alpha_pillow", "limited_420",
                                  "limited_444"])
def test_monochrome_alpha_and_range(tmp_path, kind):
    """A gray page (monochrome AV1: Y on all three channels, as cv2 copies
    it), an alpha item (decoded and dropped), and Pillow's limited-range
    files (libyuv's limited-range constants)."""
    page = _scan()[:200, :333]
    gray = cv2.cvtColor(page, cv2.COLOR_RGB2GRAY)
    alpha = np.linspace(0, 255, page.shape[1]).astype(np.uint8)
    rgba = np.dstack([page, np.broadcast_to(alpha, gray.shape)])
    data = {
        "mono_cv2": lambda: _cv2_avif(gray),
        "mono_pillow": lambda: _pil_avif(gray, speed=9),
        "alpha_cv2": lambda: _cv2_avif(rgba),
        "alpha_pillow": lambda: _pil_avif(rgba, speed=9),
        "limited_420": lambda: _pil_avif(page, speed=9, range="limited"),
        "limited_444": lambda: _pil_avif(page, speed=9, range="limited",
                                         subsampling="4:4:4"),
    }[kind]()
    if kind.startswith("alpha"):
        assert _avif_container(data)["alpha"] is not None
    assert _same(tmp_path / "x.avif", data) is not None


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:0"])
def test_pillow_superblocks_and_tiles(tmp_path, subsampling):
    """Pillow's files (128x128 superblocks, matrix unspecified) in one,
    two and four tiles, and at sizes that are not multiples of 8."""
    page = _scan()
    counts = set()
    for tiles in (0, 1, 2):
        data = _pil_avif(page, subsampling=subsampling, speed=8,
                         tile_rows=tiles, tile_cols=tiles)
        rc, info = native.av1_info(_avif_container(data)["color"])
        assert info[11] == 128
        counts.add(int(info[12]))
        _same(tmp_path / "x.avif", data)
    assert max(counts) >= 4 and len(counts) >= 2, counts
    for h, w in ((1, 129), (65, 63), (129, 65)):
        _same(tmp_path / "x.avif", _pil_avif(
            page[:h, :w], subsampling=subsampling, speed=9))


@pytest.mark.parametrize("seed", range(6))
def test_seeded_noise(tmp_path, seed):
    """Noise, raw and blurred, at seeded sizes and qualities: every
    transform type and size, the directional modes, CFL and filter
    intra."""
    rng = np.random.default_rng(seed)
    for _ in range(3):
        h, w = (int(v) for v in rng.integers(1, 160, 2))
        noise = rng.integers(0, 256, (h, w, 3), np.uint8)
        for img in (noise, cv2.GaussianBlur(noise, (0, 0), 2.5)):
            _same(tmp_path / "x.avif", _cv2_avif(
                img, cv2.IMWRITE_AVIF_QUALITY, int(rng.integers(0, 101))))


# libaom options through Pillow's ``advanced``, with the tool bit of
# ocr_av1_info that shows it took (None: no bit to show). libavif encodes
# stills in libaom's all-intra mode, where aq-mode (segmentation) does not
# take: no tool here writes a segmented frame.
TOOLS = [
    ({"enable-qm": "1", "qm-min": "0", "qm-max": "15"}, 1),
    ({"deltaq-mode": "3"}, 4),
    ({"deltaq-mode": "2", "delta-lf-mode": "1"}, 8),
    ({"tune": "iq"}, 1 | 4),
    ({"reduced-tx-type-set": "1"}, 32),
    ({"enable-chroma-deltaq": "1"}, None),
    ({"sharpness": "5"}, None),
    ({"enable-cdef": "0"}, None),
    ({"enable-filter-intra": "0"}, None),
    ({"enable-intra-edge-filter": "0"}, None),
    ({"enable-tx64": "0"}, None),
    ({"enable-smooth-intra": "0"}, None),
    ({"enable-rect-partitions": "0"}, None),
]


@pytest.mark.parametrize("options,bit", TOOLS,
                         ids=["-".join(o) for o, _ in TOOLS])
def test_libaom_coding_tools(tmp_path, options, bit):
    """Quantiser matrices, segmentation, delta q and delta lf, the reduced
    transform set and the other tools libaom turns on or off, in 4:2:0 and
    4:4:4."""
    page = _scan()[:256, :512]
    for subsampling in ("4:2:0", "4:4:4"):
        data = _pil_avif(page, subsampling=subsampling, speed=6,
                         quality=60, advanced=options)
        if bit is not None:
            assert _tools(data) & bit, options
        _same(tmp_path / "x.avif", data)


@pytest.mark.parametrize("kind", ["cv2", "pillow_tiles", "alpha", "mono"])
def test_avif_cuts_and_corruptions(tmp_path, kind):
    """Seeded cuts and byte corruptions of each kind of file: each equals
    cv2, or gives None where cv2 gives None. A corruption that makes the
    AV1 headers declare a refused variant (screen-content tools, more than
    8 bits, ...), or an ispe larger than the frame (cv2 then reads past the
    frame into libaom's buffer), raises NotImplementedError naming it."""
    page = _scan()
    base = {
        "cv2": lambda: _cv2_avif(page[:120, :300]),
        "pillow_tiles": lambda: _pil_avif(page[:200, :300], speed=9,
                                          subsampling="4:4:4", tile_rows=1,
                                          tile_cols=1),
        "alpha": lambda: _cv2_avif(np.dstack(
            [page[:120, :200], np.full((120, 200), 200, np.uint8)])),
        "mono": lambda: _cv2_avif(cv2.cvtColor(page[:100, :200],
                                               cv2.COLOR_RGB2GRAY)),
    }[kind]()
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


def _refusal(path, data, words):
    path.write_bytes(data)
    with pytest.raises(NotImplementedError, match=words) as e:
        read_image(path)
    assert unsupported(path) == str(e.value).split(": ", 1)[1]
    assert image_format(path) == "AVIF"


def _rename_box(data: bytes, old: bytes, new: bytes, nth: int = 0) -> bytes:
    at = -1
    for _ in range(nth + 1):
        at = data.index(old, at + 1)
    return data[:at] + new + data[at + 4:]


def test_refused_variants(tmp_path):
    """Each refused variant made by a tool that writes it: Pillow's default
    on the clean bitmap page sets screen-content tools; Pillow at speed 2
    on the scanned page restores loops (a restoration type other than
    NONE); Pillow's 4:2:2 is AV1 profile 2; cv2 writes 10 bits from
    uint16; libaom's film-grain test vector adds grain; a grid item, an
    image sequence and a layered item are made by editing cv2's file."""
    path = tmp_path / "x.avif"
    clean = _cv2_rgb(IMAGES / "pages" / "clean_b_24.bmp")
    _refusal(path, _pil_avif(clean), "screen-content tools")
    page = _scan()
    _refusal(path, _pil_avif(page[:200, :300], speed=2), "loop restoration")
    _refusal(path, _pil_avif(page[:64, :96], subsampling="4:2:2", speed=9),
             "profile 2")
    _refusal(path, _cv2_avif(page[:64, :96].astype(np.uint16) * 4,
                             cv2.IMWRITE_AVIF_DEPTH, 10), "more than 8 bits")
    _refusal(path, _pil_avif(page[:64, :96], speed=9,
                             advanced={"film-grain-test": "1"}), "film grain")
    base = _cv2_avif(page[:64, :96])
    assert _same(tmp_path / "ok.avif", base) is not None
    _refusal(path, _rename_box(base, b"av01", b"grid"), "grid")
    _refusal(path, base[:8] + b"avis" + base[12:], "sequences")
    _refusal(path, _rename_box(base, b"colr", b"lsel"), "layered")


def test_avif_sniffing(tmp_path):
    """AVIF is told by the ftyp box's brands, major or compatible, under
    any file name, as libavif tells it for cv2."""
    data = _cv2_avif(_scan()[:40, :60])
    assert data[8:12] == b"avif"
    path = tmp_path / "page.png"
    path.write_bytes(data)
    assert image_format(path) == "AVIF"
    assert _same(path) is not None
    # major brand mif1 with avif among the compatible ones
    ftyp_end = int.from_bytes(data[:4], "big")
    brands = data[16:ftyp_end]
    assert b"avif" in brands
    _same(tmp_path / "mif1.avif", data[:8] + b"mif1" + data[12:])
    assert image_format(tmp_path / "mif1.avif") == "AVIF"
    # no AVIF brand at all: not AVIF, and cv2 does not read it
    other = data[:8] + b"heic" + data[12:16] + brands.replace(
        b"avif", b"heic") + data[ftyp_end:]
    (tmp_path / "heic.avif").write_bytes(other)
    assert image_format(tmp_path / "heic.avif") != "AVIF"
    assert read_image(tmp_path / "heic.avif") is None
    assert _cv2_rgb(tmp_path / "heic.avif") is None


def test_avif_decodes_on_threads(tmp_path):
    """Files decoded on a thread pool (as the CLIs' page loaders decode
    them; ctypes lets go of the GIL) equal their one-at-a-time decode."""
    from concurrent.futures import ThreadPoolExecutor

    page = _scan()
    paths = []
    for i, (h, w, q) in enumerate(((200, 333, 30), (160, 512, 60),
                                   (99, 257, 90), (128, 128, 100))):
        paths.append(tmp_path / f"{i}.avif")
        paths[-1].write_bytes(_cv2_avif(page[:h, :w],
                                        cv2.IMWRITE_AVIF_QUALITY, q))
    alone = [read_image(p) for p in paths]
    with ThreadPoolExecutor(4) as pool:
        for _ in range(3):
            for got, want in zip(pool.map(read_image, paths * 2),
                                 alone * 2):
                np.testing.assert_array_equal(got, want)
