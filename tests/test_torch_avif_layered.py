"""Layered AVIF pages (libavif's extraLayerCount: a key frame, then AV1
inter frames) read by the port's AVIF reader (io/images.py, native/av1.cpp)
as cv2.imread reads them: each file libavif writes here decodes to
libavif's own Y, U and V planes bit for bit (tests/image_writers.py
libavif_decode) and to cv2's pixels; lsel, a1op and a1lx are taken as
libavif takes them; layered grid cells, and cuts and byte flips of the
inter frame and of the layer boxes, agree with cv2 (or its None). The
inter tools av1.cpp counts (native.AV1_INTER_COUNTS) each show in some
agreeing file, but dual filters, which no file here allows. Items made
of an image sequence's samples (libaom with its lookahead: alt-ref
frames, compound prediction, skip mode, frames shown again) are held
against libavif and cv2 too."""

import functools

import cv2
import numpy as np
import pytest

from ocr_inference_tpu_torch import native
from ocr_inference_tpu_torch.io.images import (
    _avif_container, _avif_samples, _avif_top, _avif_tracks, _AvifMeta,
    read_image, unsupported,
)
from tests.image_writers import (
    avif_add_property, avif_move_item, iloc_fields, isobmff_boxes,
    layered_avif_bytes, libavif_decode, libavif_encode,
    libavif_encode_grid, libavif_sequence_bytes,
)


def _page(h: int, w: int, seed: int) -> np.ndarray:
    """Page-like strokes: dark bars on white."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 235, np.uint8)
    for _ in range(h * w // 400):
        y, x = rng.integers(0, h - 8), rng.integers(0, w - 20)
        img[y:y + rng.integers(2, 8), x:x + rng.integers(2, 20)] = \
            rng.integers(20, 90)
    return img


def _layers(n: int, h: int = 96, w: int = 128, dx: int = 2, dy: int = 1,
            layout: str = "420", depth: int = 8, seed: int = 7,
            rotate: float = 0.0) -> list[list[np.ndarray]]:
    """n layers of one page, each shifted by (dx, dy) (or turned by
    ``rotate`` degrees) from the last, so that motion search finds real
    motion; chroma of a dotted grid."""
    pad = 16 + max(16, (n - 1) * max(dx, dy))  # room for every shift
    base = _page(h + 2 * pad, w + 2 * pad, seed)
    out = []
    for k in range(n):
        if rotate:
            m = cv2.getRotationMatrix2D(((w + 2 * pad) / 2, (h + 2 * pad) / 2),
                                        rotate * k, 1.0 + 0.01 * k)
            y = cv2.warpAffine(base, m, (w + 2 * pad, h + 2 * pad),
                               borderMode=cv2.BORDER_REFLECT)[pad:pad + h,
                                                              pad:pad + w]
        else:
            y = base[16 + dy * k:16 + dy * k + h, 16 + dx * k:16 + dx * k + w]
        y = y.astype(np.uint16) << (depth - 8)
        if layout == "400":
            out.append([y])
            continue
        sx, sy = {"420": (1, 1), "422": (1, 0), "444": (0, 0)}[layout]
        c = np.full(((h + sy) >> sy, (w + sx) >> sx), 128 << (depth - 8),
                    np.uint16)
        c[k % 3::3, ::5] = 96 << (depth - 8)
        out.append([y, c, c[::-1].copy()])
    return out


# name -> (layers, layered_avif_bytes keywords)
CONFIGS = {
    "speed9_2": (_layers(2), dict(speed=9)),
    "speed10_3": (_layers(3, 64, 64), dict(speed=10, qualities=[
        10, 30, 60])),
    "options": (_layers(3, 128, 96, dx=1), dict(speed=2, qualities=[
        20, 50, 80], options={"enable-ref-frame-mvs": 0,
                              "enable-dual-filter": 1,
                              "enable-masked-comp": 1,
                              "enable-dist-wtd-comp": 1})),
    "speed6_3": (_layers(3), dict(speed=6, qualities=[20, 50, 80])),
    "speed4_4": (_layers(4), dict(speed=4, qualities=[20, 40, 60, 80])),
    "speed0_3": (_layers(3), dict(speed=0, qualities=[20, 50, 80])),
    "speed8_odd": (_layers(2, 75, 97), dict(speed=8)),
    "depth10": (_layers(2, depth=10), dict(depth=10, speed=6)),
    "depth12": (_layers(3, depth=12), dict(depth=12, speed=5,
                                           qualities=[20, 50, 80])),
    "yuv444": (_layers(2, layout="444"), dict(layout="444", speed=6)),
    "yuv422_12": (_layers(2, layout="422", depth=12),
                  dict(layout="422", depth=12, speed=6)),
    "mono": (_layers(3, layout="400"), dict(layout="400", speed=3,
                                            qualities=[20, 50, 80])),
    "mono10": (_layers(2, layout="400", depth=10),
               dict(layout="400", depth=10, speed=7)),
    "alpha": (_layers(2), dict(speed=6, alpha=[
        _page(96, 128, 3), _page(96, 128, 4)])),
    "obmc": (_layers(3, dx=3), dict(speed=0, qualities=[30, 50, 80],
                                    options={"enable-obmc": 1})),
    "warped": (_layers(2, dx=3), dict(speed=5, qualities=[30, 80], options={
        "enable-warped-motion": 1})),
    "interintra": (_layers(3, dx=1, dy=2), dict(speed=0, qualities=[
        20, 40, 80], options={"enable-interintra-comp": 1})),
    "rotated": (_layers(2, 128, 160, rotate=1.5), dict(speed=3, qualities=[
        30, 80], options={"enable-global-motion": 1})),
    "scaled_half": (_layers(2), dict(speed=6, qualities=[30, 80],
                                     scaling=[(1, 2), (1, 1)])),
    "scaled_3_4": (_layers(3), dict(speed=6, qualities=[30, 50, 80],
                                    scaling=[(3, 4), (3, 4), (1, 1)])),
}

# image sequences libavif writes (libaom with its lookahead: alt-ref
# frames, compound prediction, skip mode, frames shown again), their
# samples joined into one still item: libaom decodes such an item in one
# call and gives its last shown frame, as for a layered item
SEQUENCES = {
    "seq_speed0": (_layers(8, dx=2), dict(speed=0)),
    "seq_speed0_q80": (_layers(8, dx=2), dict(speed=0, quality=80)),
    "seq_speed0_q70": (_layers(8, dx=3, seed=3), dict(speed=0, quality=70)),
    "seq_speed0_q40": (_layers(8, dx=3, seed=3), dict(speed=0, quality=40)),
    "seq_speed1": (_layers(10, dx=1), dict(speed=1)),
    "seq_speed2": (_layers(8, dx=3, seed=3), dict(speed=2, quality=40)),
    "seq_speed3": (_layers(16, dx=1), dict(speed=3, options={
        "enable-global-motion": 1})),
    "seq_speed4": (_layers(8, dx=2), dict(speed=4)),
    "seq_speed5": (_layers(8, dx=3, seed=2), dict(speed=5, quality=70)),
    "seq_speed6": (_layers(8, dx=2), dict(speed=6)),
}

# the counter no file here reaches: libaom wrote no sequence header that
# allows two interpolation filters (enable_dual_filter 0 in every file,
# its enable-dual-filter option notwithstanding)
UNREACHED = {"dual_filter"}


@functools.lru_cache(maxsize=None)
def _file(name: str) -> bytes:
    layers, kw = CONFIGS[name]
    return layered_avif_bytes(layers, **kw)


@functools.lru_cache(maxsize=None)
def _sequence_items(name: str) -> tuple[bytes, ...]:
    """Each prefix of a sequence's samples as the payload of a still
    item (a libavif AVIF of the first frame, its item moved)."""
    frames, kw = SEQUENCES[name]
    data = libavif_sequence_bytes(frames, **kw)
    top = _avif_top(data)[0]
    track = next(t for t in _avif_tracks(data, *top[b"moov"])
                 if t["stbl"] is not None)
    samples = [data[at:at + n] for at, n in _avif_samples(data,
                                                          track["stbl"])]
    still = libavif_encode(frames[0], 8, "420", speed=9)
    item = _primary(still)
    return tuple(avif_move_item(still, item, b"".join(samples[:k]))
                 for k in range(1, len(samples) + 1))


def _decode(data: bytes):
    c = _avif_container(data)
    (cell,), (layering,) = c["cells"], c["layering"]
    rc, info = native.av1_info(cell, *layering)
    assert rc == 0
    rc, planes, used = native.av1_decode_counts(cell, info, *layering)
    assert rc == 0
    return planes, used


def _same_as_cv2(tmp_path, data: bytes, name: str = "x.avif",
                 refused: bool = False):
    """read_image equals cv2 (an image or None); with ``refused``, a
    refusal by name of a frame libavif scales to the ispe (an lsel layer
    coded smaller) where cv2 reads one also passes."""
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path))
    if refused and want is not None:
        try:
            read_image(path)
        except NotImplementedError as e:
            assert "ispe property differs" in str(e), name
            return want
    got = read_image(path)
    if want is None:
        assert got is None, name
        return None
    want = cv2.cvtColor(want, cv2.COLOR_BGR2RGB)
    assert got is not None, name
    np.testing.assert_array_equal(got, want, err_msg=name)
    assert unsupported(path) is None
    return want


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_planes_equal_libavif_and_pixels_cv2(tmp_path, name):
    data = _file(name)
    want = libavif_decode(data)
    planes, used = _decode(data)
    assert want is not None and len(planes) == len(want)
    for p, (got, ref) in enumerate(zip(planes, want)):
        assert got.shape == ref.shape, (name, p)
        np.testing.assert_array_equal(got, ref, err_msg=f"{name} plane {p}")
    assert used["inter_frames"] == len(CONFIGS[name][0]) - 1
    assert _same_as_cv2(tmp_path, data) is not None


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_sequence_items_equal_libavif(tmp_path, name):
    """Every prefix of a libavif sequence's samples, as one item, decodes
    to libavif's planes (the last frame shown by then); the whole one to
    cv2's pixels."""
    items = _sequence_items(name)
    for k, data in enumerate(items):
        want = libavif_decode(data)
        planes, _ = _decode(data)
        assert want is not None and len(planes) == len(want)
        for p, (got, ref) in enumerate(zip(planes, want)):
            np.testing.assert_array_equal(got, ref,
                                          err_msg=f"{name}[:{k + 1}] {p}")
    assert _same_as_cv2(tmp_path, items[-1]) is not None


def test_every_inter_tool_shows_or_is_named():
    """Each inter counter is nonzero in some file that agrees, but those
    UNREACHED names (PERF.md lists them)."""
    total = dict.fromkeys(native.AV1_INTER_COUNTS, 0)
    blobs = [_file(name) for name in CONFIGS] + [
        _sequence_items(name)[-1] for name in SEQUENCES]
    for data in blobs:
        for k, v in _decode(data)[1].items():
            if k in total:
                total[k] += v
    assert {k for k, v in total.items() if not v} == UNREACHED, total
    assert total["scaled_reference"] and total["local_warp"] and \
        total["interintra_wedge"] and total["interintra_smooth"]


def _primary(data: bytes) -> int:
    return _AvifMeta(data, *_avif_top(data)[0][b"meta"]).primary


def _layer_edits(data: bytes) -> dict[str, bytes]:
    item = _primary(data)

    def prop(d, kind, body, essential=True):
        return avif_add_property(d, item, kind, body, essential)

    out = {f"lsel_{v}": prop(data, b"lsel", v.to_bytes(2, "big"))
           for v in (0, 1, 2, 3, 4, 0xFFFF)}
    out["lsel_not_essential"] = prop(data, b"lsel", b"\x00\x01", False)
    out.update({f"a1op_{v}": prop(data, b"a1op", bytes([v]))
                for v in (0, 1, 2, 31, 32)})
    out["a1op_not_essential"] = prop(data, b"a1op", b"\x00", False)
    one = prop(data, b"a1op", b"\x01")
    out.update({f"a1op_1_lsel_{v}": prop(one, b"lsel", v.to_bytes(2, "big"))
                for v in (0, 1, 2)})
    # a1lx: the item's own, its layer sizes made too large, essential
    at = next(a for p, a, _ in isobmff_boxes(data)
              if p[-1:] == (b"a1lx",)) + 8
    size = sum(n for _, n in _AvifMeta(data, *_avif_top(data)[0][b"meta"])
               .locations[item][1])
    big = size.to_bytes(2, "big") if size < 1 << 16 else b"\xff\xff"
    out["a1lx_past_item"] = data[:at + 1] + big + data[at + 3:]
    out["a1lx_zero_sizes"] = data[:at + 1] + bytes(4) + data[at + 5:]
    out["a1lx_essential"] = _set_essential(data, item, b"a1lx")
    return out


def _set_essential(data: bytes, item: int, kind: bytes) -> bytes:
    """The file with the item's association of its ``kind`` property in
    ipma marked essential (ipma of version 0 and 7-bit indices)."""
    index = [p[-1] for p, _, _ in isobmff_boxes(data)
             if len(p) == 4 and p[:3] == (b"meta", b"iprp", b"ipco")
             ].index(kind) + 1
    at = next(a for p, a, _ in isobmff_boxes(data)
              if p == (b"meta", b"iprp", b"ipma")) + 8
    assert data[at] == 0 and not data[at + 3] & 1
    p = at + 8
    for _ in range(int.from_bytes(data[at + 4:at + 8], "big")):
        this, n = int.from_bytes(data[p:p + 2], "big"), data[p + 2]
        for k in range(p + 3, p + 3 + n):
            if this == item and data[k] & 0x7F == index:
                return data[:k] + bytes([data[k] | 0x80]) + data[k + 1:]
        p += 3 + n
    raise AssertionError("no such association")


def test_lsel_a1op_a1lx_as_libavif(tmp_path):
    """lsel names the layer libavif gives (0xFFFF the last, as no lsel;
    a layer past the stream's or AV1's four: None), a1op the operating
    point whose layers libaom keeps, a1lx's sizes are checked against the
    item; a1op and lsel must be essential and a1lx must not. Each read
    equals cv2's; lsel 0, 1 and 2 give three different frames."""
    data = _file("speed6_3")
    edits = _layer_edits(data)
    seen = {}
    for name, blob in edits.items():
        seen[name] = _same_as_cv2(tmp_path, blob, name + ".avif")
    assert seen["lsel_3"] is None and seen["lsel_4"] is None
    assert seen["lsel_not_essential"] is None and seen["a1op_32"] is None
    assert seen["a1lx_past_item"] is None and seen["a1lx_essential"] is None
    frames = [seen[f"lsel_{v}"] for v in (0, 1, 2)]
    assert all(f is not None for f in frames)
    assert not np.array_equal(frames[0], frames[1])
    assert not np.array_equal(frames[1], frames[2])
    np.testing.assert_array_equal(seen["lsel_65535"], seen["lsel_2"])


def test_scaled_lsel_layer_stays_refused(tmp_path):
    """A layer coded at half size and picked by lsel: libavif scales it to
    the ispe, which the port refuses by name; the full-size last layer of
    the same file reads equal to cv2."""
    data = _file("scaled_half")
    path = tmp_path / "s.avif"
    path.write_bytes(avif_add_property(data, _primary(data), b"lsel",
                                       b"\x00\x00", True))
    assert cv2.imread(str(path)) is not None
    with pytest.raises(NotImplementedError, match="ispe property differs"):
        read_image(path)
    assert "ispe property differs" in unsupported(path)
    assert _same_as_cv2(tmp_path, data) is not None


@pytest.mark.parametrize("layers", [2, 3])
def test_layered_grid_cells(tmp_path, layers):
    """A grid of layered cells (each cell's a1lx; libavif decodes every
    cell with one libaom decoder) equals cv2."""
    cells = [[_page(64, 64, s), np.full((32, 32), 128, np.uint8),
              np.full((32, 32), 120, np.uint8)] for s in range(4)]
    data = libavif_encode_grid(cells, 2, 2, speed=7, quality=80,
                               layers=layers)
    assert _same_as_cv2(tmp_path, data).shape == (128, 128, 3)


def _inter_frame(data: bytes) -> tuple[int, int]:
    """(start, end) in the file of the item's last layer, the last of its
    extents (libavif writes one for each layer): the inter frame's
    OBUs."""
    entry = iloc_fields(data)[_primary(data)]
    (off_at, off_n), (len_at, len_n) = entry["extents"][-1]
    base_at, base_n = entry["base"]
    base = int.from_bytes(data[base_at:base_at + base_n], "big") \
        if base_n else 0
    start = base + int.from_bytes(data[off_at:off_at + off_n], "big")
    return start, start + int.from_bytes(data[len_at:len_at + len_n], "big")


@pytest.mark.parametrize("seed", range(8))
def test_cuts_and_flips_agree_with_cv2(tmp_path, seed):
    """Seeded cuts of the file inside the inter frame and byte flips in
    its header and tile data, in a1lx and in added lsel and a1op boxes:
    each read equals cv2's (an image or None)."""
    rng = np.random.default_rng(seed)
    data = _file(("speed9_2", "speed6_3", "obmc", "warped", "interintra",
                  "depth10", "scaled_half", "speed4_4")[seed])
    start, end = _inter_frame(data)
    cases = {}
    for k in range(3):
        cut = int(rng.integers(start + 1, end))
        cases[f"cut{k}"] = data[:cut]
    for k in range(6):
        at = int(rng.integers(start, min(end, start + 24))) if k < 2 else \
            int(rng.integers(start, end))
        bit = 1 << int(rng.integers(0, 8))
        cases[f"flip{k}"] = data[:at] + bytes([data[at] ^ bit]) + \
            data[at + 1:]
    boxed = avif_add_property(avif_add_property(
        data, _primary(data), b"a1op", b"\x00", True), _primary(data),
        b"lsel", b"\x00\x01", True)
    for kind in (b"a1lx", b"a1op", b"lsel"):
        at = next(a for p, a, _ in isobmff_boxes(boxed)
                  if p[-1:] == (kind,)) + 8
        bit = 1 << int(rng.integers(0, 8))
        k = at + int(rng.integers(0, 2))
        cases[f"flip_{kind.decode()}"] = boxed[:k] + \
            bytes([boxed[k] ^ bit]) + boxed[k + 1:]
    for name, blob in cases.items():
        _same_as_cv2(tmp_path, blob, f"{name}.avif", refused=True)
