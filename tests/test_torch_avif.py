"""The port's AVIF reader (io/images.py over native/av1.cpp) against
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` (cv2 5.0's
AvifDecoder over libavif 1.4.2 and libaom 3.14.1), byte for byte and None
for None: the committed files, cv2's and Pillow's files at every quality
and speed on the clean and scanned pages (screen-content tools, palette
and intra block copy, below speed 9 on clean pages; loop restoration,
Wiener and self-guided, at the slowest speeds on scanned ones), seeded
pages of few colours, sizes that are not multiples of 8, monochrome and
alpha, Pillow's 4:4:4 and 4:2:0 files in several tiles and at limited
range, seeded noise, libaom's coding tools switched on one at a time
(quantiser matrices, segmentation, delta q and lf, ...), and seeded cuts
and corruptions. av1.cpp's counts (native.av1_decode_counts) show the
files reach each tool. The variants the reader refuses are made by the
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
    on it at every speed; libaom restores loops on it at the slowest."""
    return _cv2_rgb(IMAGES / "pages" / "skew_2deg.jpg")


def _clean(name="clean_b_24.bmp"):
    """A clean fixture page (RGB), bilevel text: libaom turns
    screen-content tools on for it below speed 9."""
    return _cv2_rgb(IMAGES / "pages" / name)


def _counts(data: bytes) -> dict:
    """How often the primary item's frame used each tool av1.cpp counts
    (palette Y and UV blocks by size, intra block copies, Wiener and
    self-guided units)."""
    obus = _avif_container(data)["cells"][0]
    rc, info = native.av1_info(obus)
    assert rc == 0
    rc, _, used = native.av1_decode_counts(obus, info)
    assert rc == 0
    return used


def _few_colours(k: int, mono: bool = False) -> np.ndarray:
    """A seeded page of few colours: 128 rows of the clean page's text
    (which turns screen-content tools on) over 64 rows of repeated 32x32
    tiles of k colours with evenly spaced luma, each pixel's colour drawn
    at random."""
    rng = np.random.default_rng(k)
    levels = np.linspace(16, 240, k).astype(np.uint8)
    tiles = [rng.integers(0, k, (32, 32)) for _ in range(3)]
    index = np.block([[tiles[int(rng.integers(0, 3))] for _ in range(4)]
                      for _ in range(2)])
    text = _clean()[:128, 300:428]
    if mono:
        return np.concatenate([text[..., 0], levels[index]])
    chroma = rng.integers(96, 160, (k, 2), np.uint8)
    ycc = np.stack([levels[index], chroma[index, 0], chroma[index, 1]], -1)
    return np.concatenate([text, cv2.cvtColor(ycc, cv2.COLOR_YCrCb2RGB)])


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
    rc, info = native.av1_info(_avif_container(data)["cells"][0])
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


@pytest.mark.parametrize("speed", range(11))
def test_cv2_speeds(tmp_path, speed):
    """cv2's encoder speeds 0-10 (other partitions, transform sets and
    intra tools; loop restoration at 0) on a strip of the scanned page,
    and on a crop of the clean page (palettes and intra block copies below
    9)."""
    _same(tmp_path / "x.avif", _cv2_avif(
        _scan()[:160, :448], cv2.IMWRITE_AVIF_QUALITY, 60,
        cv2.IMWRITE_AVIF_SPEED, speed))
    data = _cv2_avif(_clean()[:, 300:556], cv2.IMWRITE_AVIF_SPEED, speed)
    _same(tmp_path / "x.avif", data)
    if speed < 9:
        assert _counts(data)["palette_y"] > 0


@pytest.mark.parametrize("speed", ["default"] + [str(s) for s in range(11)])
def test_pillow_speeds(tmp_path, speed):
    """Pillow's default and its speeds 0-10 on crops of the two clean
    pages (palettes, and intra block copies of repeated glyphs) and of the
    scanned page (loop restoration at the slowest speeds)."""
    save = {} if speed == "default" else {"speed": int(speed)}
    used = []
    for img in (_clean()[:, 300:556], _clean("clean_a_adam7.png")[:192, :512],
                _scan()[200:456, 300:556]):
        data = _pil_avif(img, **save)
        _same(tmp_path / "x.avif", data)
        used.append(_counts(data))
    if speed not in ("9", "10"):
        assert used[0]["palette_y"] and used[1]["palette_y"], used
    if speed not in ("8", "9", "10"):
        assert used[1]["intrabc"], used
    if speed in ("0", "1", "2"):
        assert used[2]["self_guided"] + used[2]["wiener"], used


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4", "mono"])
def test_palettes_of_every_size(tmp_path, subsampling):
    """Seeded pages of 2 to 8 colours: Y palettes of every size 2-8, UV
    palettes (of every size in 4:4:4; V's colours delta coded or not), the
    colour cache from the neighbours, and the colour map past a block's
    edge."""
    save = {} if subsampling == "mono" else {"subsampling": subsampling}
    y_sizes, uv_sizes = np.zeros(7, int), np.zeros(7, int)
    for k in range(2, 9):
        data = _pil_avif(_few_colours(k, subsampling == "mono"),
                         quality=95, **save)
        _same(tmp_path / "x.avif", data)
        used = _counts(data)
        y_sizes += used["palette_y_sizes"]
        uv_sizes += used["palette_uv_sizes"]
    assert y_sizes.all(), y_sizes
    if subsampling == "4:4:4":
        assert uv_sizes.all(), uv_sizes
    else:
        assert uv_sizes.any() == (subsampling == "4:2:0"), uv_sizes


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4", "mono"])
def test_intra_block_copy(tmp_path, subsampling):
    """Clean pages of repeated glyphs: intra block copies (whole-pixel DVs
    from the neighbours' candidates or the default one superblock up,
    bilinear half pixels of 4:2:0 chroma, blocks below 8x8, transform
    trees of inter transform sizes and types), beside palettes, at
    Pillow's default and cv2's speed 0-8 settings."""
    page = _clean("clean_a_adam7.png")
    if subsampling == "mono":
        page = page[..., 0]
    save = {} if subsampling == "mono" else {"subsampling": subsampling}
    used = {"intrabc": 0, "intrabc_sub8": 0}
    for img in (page[:256, :512], page[320:576, 512:]):
        for data in (_pil_avif(img, **save), _pil_avif(img, speed=2, **save)):
            _same(tmp_path / "x.avif", data)
            for k in used:
                used[k] += _counts(data)[k]
    assert used["intrabc"] >= 20 and used["intrabc_sub8"] >= 1, used


@pytest.mark.parametrize("speed", [0, 1, 2])
def test_loop_restoration(tmp_path, speed):
    """Scanned crops at Pillow's slowest speeds (self-guided units, the
    r = 0 parameter sets among them) and blurred noise (Wiener units), in
    4:2:0, 4:4:4 and monochrome: stripes of 64 rows with the deblocked
    rows past them, units of 64 to 256 samples and the last unit's
    remainder."""
    page = _scan()
    rng = np.random.default_rng(speed)
    blurred = cv2.GaussianBlur(rng.integers(0, 256, (96, 136, 3), np.uint8),
                               (0, 0), 1.5)
    used = {"wiener": 0, "self_guided": 0}
    for img, save in ((page[:200, :256], {}),
                      (page[100:300, 500:756], {"subsampling": "4:4:4"}),
                      (page[200:456, 0:200, 0], {}),
                      (blurred, {}), (blurred, {"subsampling": "4:4:4"})):
        data = _pil_avif(img, speed=speed, quality=50, **save)
        _same(tmp_path / "x.avif", data)
        for k in used:
            used[k] += _counts(data)[k]
    assert used["wiener"] and used["self_guided"], used


def test_the_files_reach_every_tool(tmp_path):
    """One file of each kind above: their counts show a Y palette, a UV
    palette, an intra block copy, a Wiener and a self-guided unit."""
    files = [_pil_avif(_few_colours(5), quality=95, subsampling="4:4:4"),
             _pil_avif(_clean("clean_a_adam7.png")[:192, :512]),
             _pil_avif(_scan()[:200, :256], speed=0),
             _pil_avif(cv2.GaussianBlur(np.random.default_rng(0).integers(
                 0, 256, (96, 96, 3), np.uint8), (0, 0), 1.5), speed=2)]
    total = {}
    for data in files:
        _same(tmp_path / "x.avif", data)
        for k, v in _counts(data).items():
            if isinstance(v, int):
                total[k] = total.get(k, 0) + v
    for k in ("palette_y", "palette_uv", "intrabc", "wiener", "self_guided"):
        assert total[k] >= 1, total


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
        rc, info = native.av1_info(_avif_container(data)["cells"][0])
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


@pytest.mark.parametrize("kind", ["cv2", "pillow_tiles", "alpha", "mono",
                                  "palette", "intra_block_copy",
                                  "loop_restoration"])
def test_avif_cuts_and_corruptions(tmp_path, kind):
    """Seeded cuts and byte corruptions of each kind of file: each equals
    cv2, or gives None where cv2 gives None. A corruption that makes the
    AV1 headers declare a refused variant (more than 8 bits, film grain,
    ...), or an ispe other than the frame's size (libavif scales the frame
    to it), raises NotImplementedError naming it."""
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
        "palette": lambda: _pil_avif(_few_colours(6), quality=95,
                                     subsampling="4:4:4"),
        "intra_block_copy": lambda: _pil_avif(
            _clean("clean_a_adam7.png")[:192, :512]),
        "loop_restoration": lambda: _pil_avif(page[:200, :256], speed=0),
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


def test_reduced_header_of_a_video_gives_none(tmp_path):
    """A reduced sequence header whose still_picture bit is 0 (a corruption
    a seeded fuzz of byte flips against cv2 found): libaom fails it, so
    cv2 gives None, and so does the port, where it used to decode the
    frame."""
    data = _pil_avif(_scan()[:64, :96], speed=9)
    at = data.index(_avif_container(data)["cells"][0])
    assert data[at:at + 3] == b"\x12\x00\x0a"  # delimiter, sequence header
    assert data[at + 4] & 0x18 == 0x18  # still_picture, reduced header
    path = tmp_path / "x.avif"
    _same(path, data)
    assert _same(path, data[:at + 4] + bytes([data[at + 4] ^ 0x10])
                 + data[at + 5:]) is None


def _edit(data: bytes, box: bytes, offset: int, fn) -> bytes:
    """``data`` with the byte ``offset`` bytes after box type ``box``'s
    name replaced by fn(byte)."""
    at = data.index(box) + 4 + offset
    return data[:at] + bytes([fn(data[at])]) + data[at + 1:]


# Container and header cases a seeded fuzz of byte flips against cv2
# found, each with cv2's result: None, or the image (equal to the port's),
# or "gray" (the Y plane on all three channels). libavif fails a meta box
# of a version other than 0, a nested box of size 0, a pixi of no planes,
# an iloc entry of item 0 or of an item twice, an iref reference from or
# to item 0, an ipma association of index 0 marked essential and an alpha
# item without av1C; it skips an iref of a version past 1 (the alpha item
# is then not linked) and reads a reference's fields on from its box
# header whatever the box's size says; it stops at the meta box, so a
# wrong mdat size does not matter; it takes a colour frame whose av1C says
# monochrome as monochrome (None with alpha). libaom fails an OBU header
# without a size field (its reserved bit it ignores), a tile list OBU, a
# metadata OBU without a type (the temporal delimiter's header turned into
# these), and a sequence header of an undefined level (here 2.2: the byte
# after mdat's name + 5 is the second of the sequence header, whose top
# bits end the level).
CONTAINER_CASES = {
    "mdat_size_short": ("plain", b"mdat", -1, lambda b: b - 2, "image"),
    "iloc_item_0": ("alpha", b"iloc", 23, lambda b: 0, None),
    "iloc_item_twice": ("alpha", b"iloc", 23, lambda b: 1, None),
    "level_2_2": ("plain", b"mdat", 5, lambda b: b | 0x80, None),
    "obu_reserved_bit": ("plain", b"mdat", 0, lambda b: b | 1, "image"),
    "obu_tile_list": ("plain", b"mdat", 0, lambda b: 0x42, None),
    "obu_empty_metadata": ("plain", b"mdat", 0, lambda b: 0x2a, None),
    "obu_without_size": ("plain", b"mdat", 0, lambda b: b & ~2, None),
    "ipma_essential_index_0": ("plain", b"ipma", 14, lambda b: 0x80, None),
    "iref_from_0": ("alpha", b"auxl", 1, lambda b: 0, None),
    "iref_to_0": ("alpha", b"auxl", 5, lambda b: 0, None),
    "iref_to_unknown_item": ("alpha", b"auxl", 5, lambda b: 3, "image"),
    "alpha_without_av1c": ("alpha", b"ipma", 20, lambda b: 0x04, None),
    "meta_version_1": ("plain", b"meta", 0, lambda b: 1, None),
    "meta_version_2": ("plain", b"meta", 0, lambda b: 2, None),
    "ipma_size_0": ("alpha", b"ipma", -1, lambda b: 0, None),
    "pixi_no_planes": ("plain", b"pixi", 4, lambda b: 0, None),
    "iref_version_8": ("alpha", b"iref", 0, lambda b: 8, "image"),
    "iref_reference_box_short": ("alpha", b"auxl", -1, lambda b: b - 2,
                                 "image"),
    "av1c_mono_420": ("plain", b"av1C", 2, lambda b: b | 0x10, "gray"),
    "av1c_mono_limited": ("limited", b"av1C", 2, lambda b: b | 0x10, "gray"),
    "av1c_mono_444": ("444", b"av1C", 2, lambda b: b | 0x10, "gray"),
    "av1c_mono_alpha": ("alpha", b"av1C", 2, lambda b: b | 0x10, None),
}


@pytest.mark.parametrize("case", CONTAINER_CASES)
def test_container_cases_the_fuzz_found(tmp_path, case):
    """Each container case of CONTAINER_CASES (a meta version, a nested
    box of size 0, a pixi of no planes, an iref libavif skips or reads
    past its reference box's size, av1C's monochrome flag over a colour
    frame) reads as cv2 reads it, where the port read it otherwise."""
    kind, box, offset, fn, want = CONTAINER_CASES[case]
    page = (_scan()[:64, :96] * [1.0, 0.8, 0.6]).astype(np.uint8)  # tinted
    base = {
        "plain": lambda: _pil_avif(page, speed=9),
        "limited": lambda: _pil_avif(page, speed=9, range="limited"),
        "444": lambda: _pil_avif(page, speed=9, subsampling="4:4:4"),
        "alpha": lambda: _cv2_avif(np.dstack(
            [page, np.full(page.shape[:2], 200, np.uint8)])),
    }[kind]()
    if case == "level_2_2":  # the sequence header, of level 2.0, first
        at = base.index(b"mdat") + 4
        assert base[at:at + 3] == b"\x12\x00\x0a" and base[at + 5] < 0x40
    got = _same(tmp_path / "x.avif", _edit(base, box, offset, fn))
    if want is None:
        assert got is None
    else:
        assert got is not None
        assert (got == got[..., :1]).all() == (want == "gray")


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
    """Each refused variant made by editing cv2's file: a layered item and
    an ispe other than the frame's size. The variants read since read
    equal to cv2 (a grid item and an image sequence, made by the same
    edits, give None as cv2 does): Pillow's default on
    the clean bitmap page sets screen-content tools; Pillow at speed 2 on
    the scanned page restores loops; Pillow's 4:2:2 is AV1 profile 2; cv2
    writes 10 bits from uint16; libaom's film-grain test vector adds
    grain."""
    path = tmp_path / "x.avif"
    clean = _cv2_rgb(IMAGES / "pages" / "clean_b_24.bmp")
    assert _same(path, _pil_avif(clean)) is not None
    page = _scan()
    data = _pil_avif(page[:200, :300], speed=2)
    assert _same(path, data) is not None
    assert _counts(data)["self_guided"] + _counts(data)["wiener"] > 0
    data = _pil_avif(page[:64, :96], subsampling="4:2:2", speed=9)
    assert native.av1_info(_avif_container(data)["cells"][0])[1][4:6].tolist() \
        == [1, 0]
    assert _same(path, data) is not None
    data = _cv2_avif(page[:64, :96].astype(np.uint16) * 4,
                     cv2.IMWRITE_AVIF_DEPTH, 10)
    assert native.av1_info(_avif_container(data)["cells"][0])[1][2] == 10
    assert _same(path, data) is not None
    data = _pil_avif(page[:64, :96], speed=9,
                     advanced={"film-grain-test": "1"})
    assert _counts(data)["grain"] == 1
    assert _same(path, data) is not None
    base = _cv2_avif(page[:64, :96])
    assert _same(tmp_path / "ok.avif", base) is not None
    # a grid item without dimg cells, and the major brand avis without a
    # moov: once refused by name, now None as cv2 gives
    assert _same(path, _rename_box(base, b"av01", b"grid")) is None
    assert _same(path, base[:8] + b"avis" + base[12:]) is None
    # colr renamed lsel: a layer past AV1's four (and not essential),
    # once refused by name as layered, now None as cv2 gives
    assert _same(path, _rename_box(base, b"colr", b"lsel")) is None
    at = base.index(b"ispe") + 12  # its height
    for height in (63, 65):
        _refusal(path, base[:at] + height.to_bytes(4, "big") + base[at + 4:],
                 "ispe property differs")


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
