"""The port's AVIF reader (io/images.py over native/av1.cpp) on grid items
against ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` (cv2 5.0's
AvifDecoder over libavif 1.4.2 and libaom 3.14.1), byte for byte and None
for None. libavif's own encoder (the one cv2 bundles, driven through
ctypes: tests/image_writers.py libavif_encode_grid) writes the grids: 1x2,
2x1, 2x2 and 3x2 cells at 4:2:0, 4:2:2, 4:4:4 and monochrome, 8 and 10
bits, with and without an alpha grid, with film grain; edits of the
ImageGrid payload crop the output, reorder the cells and cut the grid. A
seeded fuzz of the grid's boxes (iref, iloc, iinf, iprp, ImageGrid) found
libavif's rules; its cases are kept here. Also here, as the fuzz found
them: cv2's signature check (libavif's parse of the file's first 500
bytes), the data libaom reads after an item's frame, and an alpha cell of
no frame where one libaom decoder reads every cell."""

import struct

import cv2
import numpy as np
import pytest

from ocr_inference_tpu_torch import native
from ocr_inference_tpu_torch.io.images import (
    _avif_container, image_format, read_image, unsupported,
)
from tests.image_writers import (
    avif_move_item, avif_pad_meta, iloc_fields, isobmff_boxes,
    libavif_encode, libavif_encode_grid, put_uint, ycbcr_planes,
)
from tests.test_torch_avif import _cv2_avif, _cv2_rgb, _scan

# refusals a fuzzed file may meet where cv2 reads it: a cell scaled to its
# ispe, a layered cell, premultiplied alpha the port does not divide out
REFUSED = ("ispe property differs", "premultiplied alpha")


def _colour(h: int = 256, w: int = 384) -> np.ndarray:
    """Smooth seeded colour with the scanned page's text over it."""
    rng = np.random.default_rng(3)
    small = rng.integers(0, 256, (9, 13, 3), np.uint8)
    colour = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
    text = _scan()[:h, :w]
    return np.where(text < 128, text, colour).astype(np.uint8)


def _grid(rows: int, cols: int, cw: int, ch: int, layout: str = "420",
          depth: int = 8, alpha: bool = False, **kw) -> bytes:
    img = _colour()
    cells, alphas = [], []
    for r in range(rows):
        for c in range(cols):
            cell = img[r * ch:(r + 1) * ch, c * cw:(c + 1) * cw]
            cells.append(ycbcr_planes(cell, layout, depth))
            ramp = (np.arange(cw)[None] * 255 // cw + r * 40) % 256
            alphas.append(np.broadcast_to(ramp, (ch, cw)).astype(np.uint16)
                          << (depth - 8))
    return libavif_encode_grid(cells, cols, rows, depth, layout,
                               alphas=alphas if alpha else None, **kw)


def _same(path, data):
    """read_image equals cv2 (an image or None), image_format says AVIF
    and unsupported() has nothing to say; returns cv2's image."""
    path.write_bytes(data)
    want, got = _cv2_rgb(path), read_image(path)
    if want is None:
        assert got is None
    else:
        assert got is not None and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert image_format(path) == "AVIF" and unsupported(path) is None
    return want


def _box(data: bytes, path: tuple) -> tuple[int, int]:
    return next((a, e) for p, a, e in isobmff_boxes(data) if p == path)


def _image_grid(data: bytes, item: int = 1) -> int:
    """Where an item's ImageGrid payload lies (libavif writes it in
    mdat)."""
    entry = iloc_fields(data)[item]
    (at, nbytes), _ = entry["extents"][0]
    return int.from_bytes(data[at:at + nbytes], "big")


@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("layout", ["420", "422", "444", "400"])
@pytest.mark.parametrize("shape", [(1, 2, 64, 64), (2, 1, 64, 80),
                                   (2, 2, 96, 64), (3, 2, 64, 66)],
                         ids=lambda s: "%dx%d" % s[:2])
def test_grid_layouts(tmp_path, shape, layout, depth):
    """Grids of 1x2, 2x1, 2x2 and 3x2 cells at each chroma format and at 8
    and 10 bits: the cells stitched at the stream's depth, then converted
    whole (chroma upsampling reads across cell edges). A monochrome 2x2
    grid's meta box ends on cv2's 500 signature bytes exactly: cv2 gives
    None (test_signature_bytes)."""
    rows, cols, cw, ch = shape
    data = _grid(rows, cols, cw, ch, layout, depth)
    want = _same(tmp_path / "g.avif", data)
    assert (want is None) == (layout == "400" and rows * cols == 4)
    if want is None:
        data = avif_pad_meta(data, 8)
        assert _same(tmp_path / "g.avif", data) is not None
    c = _avif_container(data)
    assert c["grid"] == (rows, cols, cols * cw, rows * ch)
    assert len(c["cells"]) == rows * cols


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("layout", ["420", "444", "400"])
def test_grid_alpha(tmp_path, layout, depth):
    """An alpha grid beside the colour grid: its cells decoded (and
    dropped); above 8 bits the conversion takes libyuv's paths with
    alpha. Monochrome with alpha gives None, as in cv2."""
    data = _grid(2, 3, 64, 64, layout, depth, alpha=True)
    assert _avif_container(data)["alpha"]["grid"] == (2, 3, 192, 128)
    want = _same(tmp_path / "a.avif", data)
    assert (want is None) == (layout == "400")


@pytest.mark.parametrize("depth,options", [
    (8, {"film-grain-test": 1}), (8, {"film-grain-test": 7}),
    (10, {"film-grain-test": 3})])
def test_grid_film_grain(tmp_path, depth, options):
    """libaom's film grain on every cell, each cell's grain synthesised
    with its own seed, as libaom adds it frame by frame."""
    data = _grid(2, 2, 96, 64, "420", depth, options=options)
    rc, _, used = native.av1_decode_counts(
        _avif_container(data)["cells"][1],
        native.av1_info(_avif_container(data)["cells"][1])[1])
    assert rc == 0 and used["grain"] == 1
    assert _same(tmp_path / "f.avif", data) is not None


@pytest.mark.parametrize("layout", ["420", "444"])
def test_grid_cropped_output(tmp_path, layout):
    """The ImageGrid's output size edited (and the grid's ispe with it):
    the stitched planes cut before the conversion. Sizes the cells do not
    cover, a last row or column outside the output, odd sizes at 4:2:0
    and an ispe other than the output size give None, as in cv2; 32-bit
    output fields (flags bit 0) read the same."""
    data = _grid(2, 3, 64, 64, layout)
    at = _image_grid(data)
    ispe = _box(data, (b"meta", b"iprp", b"ipco", b"ispe"))[0] + 12
    assert data[at:at + 4] == b"\x00\x00\x01\x02"
    for w, h, same_ispe in ((190, 126, True), (130, 66, True),
                            (129, 66, True), (191, 127, True),
                            (128, 66, True), (192, 64, True),
                            (193, 128, True), (190, 126, False)):
        edit = put_uint(put_uint(data, at + 4, 2, w), at + 6, 2, h)
        if same_ispe:
            edit = put_uint(put_uint(edit, ispe, 4, w), ispe + 4, 4, h)
        want = _same(tmp_path / "c.avif", edit)
        fits = (128 < w <= 192 and 64 < h <= 128 and same_ispe
                and (layout == "444" or not (w % 2 or h % 2)))
        assert (want is not None) == fits, (w, h)
        if want is not None:
            assert want.shape == (h, w, 3)
    edit = put_uint(put_uint(data, ispe, 4, 190), ispe + 4, 4, 126)
    wide = avif_move_item(edit, 1, struct.pack(">4B2I", 0, 1, 1, 2, 190,
                                               126))
    assert _same(tmp_path / "c.avif", wide).shape == (126, 190, 3)
    for payload in (struct.pack(">4B2I", 1, 1, 1, 2, 190, 126),
                    struct.pack(">4B2H", 0, 1, 1, 2, 190, 126),
                    struct.pack(">4B2IB", 0, 1, 1, 2, 190, 126, 0),
                    struct.pack(">4B2I", 0, 1, 1, 2, 0, 126),
                    struct.pack(">4B", 0, 0, 1, 2)):
        assert _same(tmp_path / "c.avif",
                     avif_move_item(edit, 1, payload)) is None


def test_grid_cell_order(tmp_path):
    """The cells are placed in the order of the dimg reference, not of
    their item ids: the reference reversed mirrors a 1x2 grid; the cell
    count and each cell named once are checked (a cell named twice, rows
    or columns the references do not fill give None)."""
    data = _grid(1, 2, 96, 64)
    at, end = _box(data, (b"meta", b"iref"))
    dimg = data.index(b"dimg", at) + 8  # from (2), count (2), cells (2 each)
    assert data[dimg:dimg + 4] == b"\x00\x02\x00\x03"
    base = _same(tmp_path / "o.avif", data)
    swapped = _same(tmp_path / "o.avif", data[:dimg] + b"\x00\x03\x00\x02"
                    + data[dimg + 4:])
    # the cells away from the seam, where the chroma upsampling reads
    # across it
    np.testing.assert_array_equal(swapped[:, 2:94], base[:, 98:190])
    for cells in (b"\x00\x02\x00\x02", b"\x00\x03\x00\x03"):
        assert _same(tmp_path / "o.avif",
                     data[:dimg] + cells + data[dimg + 4:]) is None
    grid = _image_grid(data)
    for rows_cols in (b"\x00\x00", b"\x01\x01", b"\x00\x02"):
        assert _same(tmp_path / "o.avif", data[:grid + 2] + rows_cols
                     + data[grid + 4:]) is None


def test_signature_bytes(tmp_path):
    """cv2 tells AVIF by libavif's parse of the file's first 500 bytes:
    where the meta box ends within them, libavif reads on (a grid's
    ImageGrid payload, the first cell's sequence header where no colr nclx
    gives the CICP), and a read that starts past them fails the check, so
    cv2 gives None for a file libavif decodes. A monochrome 2x2 grid's meta
    ends at byte 500, its ImageGrid at 508: None; the same file with its
    meta box padded past byte 500 reads."""
    data = _grid(2, 2, 64, 64, "400")
    assert _box(data, (b"meta",))[1] == 500
    assert _same(tmp_path / "s.avif", data) is None
    for pad in (8, 64):
        assert _same(tmp_path / "s.avif", avif_pad_meta(data, pad)) \
            is not None
    # a single item without colr: libavif reads its sequence header
    page = _cv2_avif(_scan()[:64, :96])
    colr = _box(page, (b"meta", b"iprp", b"ipco", b"colr"))[0] + 4
    plain = page[:colr] + b"free" + page[colr + 4:]
    assert _same(tmp_path / "s.avif", plain) is not None
    meta_end = _box(plain, (b"meta",))[1]
    # the meta box ending at byte 500 puts the item past it; at 492, the
    # item starts at byte 500 and its read is only cut
    for end, readable in ((500, False), (492, True), (520, True)):
        padded = avif_pad_meta(plain, end - meta_end)
        assert (_same(tmp_path / "s.avif", padded) is not None) == readable


def _fuzz_cases(seed: int, count: int):
    """Seeded byte edits (one or two bytes, set to 0, 1, 2, 0xFF, a random
    value, one bit flipped or the value moved by one) in a grid's boxes."""
    rng = np.random.default_rng(seed)
    files = [_grid(2, 2, 96, 64), _grid(2, 3, 64, 64, "444", alpha=True),
             _grid(3, 2, 64, 64, alpha=True)]
    for k in range(count):
        data = files[k % len(files)]
        spans = {p[1]: (a, e) for p, a, e in isobmff_boxes(data)
                 if len(p) == 2 and p[0] == b"meta"}
        grid = _image_grid(data)
        spans[b"grid"] = (grid, grid + 8)
        kind = [b"iref", b"iloc", b"iinf", b"iprp", b"grid", b"pitm"][
            int(rng.integers(6))]
        edit = bytearray(data)
        for _ in range(int(rng.integers(1, 3))):
            at = int(rng.integers(*spans[kind]))
            edit[at] = int(rng.choice([0, 1, 2, 0xFF, rng.integers(256),
                                       edit[at] ^ (1 << rng.integers(8)),
                                       (edit[at] + 1) & 255,
                                       (edit[at] - 1) & 255]))
        yield kind, bytes(edit)


@pytest.mark.parametrize("seed", range(4))
def test_grid_fuzz(tmp_path, seed):
    """Seeded edits of a grid's iref (dimg, auxl), iloc, iinf, iprp (its
    properties and their associations) and ImageGrid payload: each reads
    equal to cv2, gives None where cv2 does, or (where cv2 reads it) is
    refused by a name REFUSED lists."""
    path = tmp_path / "z.avif"
    for kind, data in _fuzz_cases(seed, 120):
        path.write_bytes(data)
        want = _cv2_rgb(path)
        try:
            got = read_image(path)
        except NotImplementedError as e:
            assert want is not None and any(w in str(e) for w in REFUSED), \
                (kind, str(e))
            continue
        if want is None:
            assert got is None, kind
        else:
            assert got is not None and got.shape == want.shape, kind
            np.testing.assert_array_equal(got, want, err_msg=str(kind))


def test_grid_refusals(tmp_path):
    """Grids still refused by name, where cv2 reads them: cells whose ispe
    differs from their frames (libavif scales each cell to it), and
    layered cells (a1lx; their layers after the first are inter frames).
    One cell's ispe other than the rest, or a cell without ispe, gives
    None, as in cv2."""
    path = tmp_path / "r.avif"
    data = _grid(1, 2, 96, 64)
    ispes = [a for p, a, _ in isobmff_boxes(data)
             if p == (b"meta", b"iprp", b"ipco", b"ispe")]
    assert len(ispes) == 2  # the grid's, then the one the cells share
    scaled = data
    for at, w, h in ((ispes[1] + 12, 80, 70), (ispes[0] + 12, 160, 70),
                     (_image_grid(data) + 4, 160, 70)):
        size = 2 if at == _image_grid(data) + 4 else 4
        scaled = put_uint(put_uint(scaled, at, size, w), at + size, size, h)
    path.write_bytes(scaled)
    assert _cv2_rgb(path).shape == (70, 160, 3)
    with pytest.raises(NotImplementedError, match="ispe property differs"):
        read_image(path)
    assert "ispe property differs" in unsupported(path)
    # layered cells (a1lx; their second layers are inter frames), once
    # refused by name, read as cv2 reads them
    layered = _grid(1, 2, 96, 64, layers=2)
    path.write_bytes(layered)
    want = _cv2_rgb(path)
    assert want.shape == (64, 192, 3)
    np.testing.assert_array_equal(read_image(path), want)
    assert unsupported(path) is None
    # the second cell's ipma entry: ispe (4), pixi, av1C, colr
    at, _ = _box(data, (b"meta", b"iprp", b"ipma"))
    k = data.index(b"\x00\x03\x04\x04", at) + 3
    for ispe in (b"\x01", b"\x00"):  # the grid's ispe, none
        assert _same(path, data[:k] + ispe + data[k + 1:]) is None


def test_alpha_cell_of_no_frame(tmp_path):
    """Where colour and alpha are both grids, libavif decodes every cell
    with one libaom decoder, which gives an alpha cell of no frame (a
    temporal delimiter alone) the frame decoded before it: cv2 reads the
    file. A colour cell of no frame, or a single alpha item of none (its
    own decoder), gives None."""
    data = _grid(2, 3, 64, 64, alpha=True)
    fields = iloc_fields(data)
    c = _avif_container(data)
    alpha_cells = [i for i in sorted(fields) if i > 8]
    path = tmp_path / "n.avif"
    for item, readable in ((alpha_cells[0], True), (alpha_cells[3], True),
                           (2, False)):
        (_, _), (len_at, len_size) = fields[item]["extents"][0]
        edit = put_uint(data, len_at, len_size, 2)  # 12 00: a delimiter
        assert (_same(path, edit) is not None) == readable
    assert len(c["alpha"]["cells"]) == 6
    page = _scan()[:64, :96]
    single = _cv2_avif(np.dstack([page, np.full((64, 96), 200, np.uint8)]))
    alpha_item = [i for i in iloc_fields(single) if i != 1][0]
    (_, _), (len_at, len_size) = iloc_fields(single)[alpha_item]["extents"][0]
    assert _same(path, put_uint(single, len_at, len_size, 2)) is None


def _grow_item(data: bytes, extra: bytes) -> bytes:
    """cv2's single-item file with bytes after its AV1 payload (the last
    thing in the file): the item's length and mdat's size grown."""
    (_, _), (len_at, len_size) = iloc_fields(data)[1]["extents"][0]
    n = int.from_bytes(data[len_at:len_at + len_size], "big")
    out = put_uint(data, len_at, len_size, n + len(extra))
    at, _ = _box(out, (b"mdat",))
    size = int.from_bytes(out[at:at + 4], "big")
    return put_uint(out, at, 4, size + len(extra)) + extra


def test_data_after_the_frame(tmp_path):
    """What follows an item's frame, as libaom reads it (zero bytes
    skipped, then the next temporal unit): OBUs that hold no frame pass
    where libaom reads them (a temporal delimiter, padding, a sequence
    header, metadata of each kind with its own checks, reserved types)
    and fail where not; a temporal unit with a frame is decoded in turn,
    and its frame is the one cv2 gets."""
    page = _scan()
    first = _cv2_avif(page[:64, :96])
    payload = _avif_container(first)["cells"][0]
    seq = payload[2:4 + payload[3]]
    assert payload[:2] == b"\x12\x00" and seq[0] == 0x0A
    other = _avif_container(_cv2_avif(page[100:164, 100:196]))["cells"][0]
    path = tmp_path / "t.avif"
    for extra, readable in (
            (b"\x12\x00", True), (b"\x00\x00\x12\x00", True),
            (b"\x12\x00\x00", False), (b"\x12\x01\x00", True),
            (b"\x12\x01\x05", False), (b"\x12", False),
            (b"\x7a\x01\x80", True), (b"\x7a\x01\x81", False),
            (seq, True), (b"\x12\x00" + seq, True), (b"\x4a\x01\x80", True),
            (b"\x2a\x06\x01\x00\x10\x00\x20\x80", True),  # HDR CLL
            (b"\x2a\x04\x01\x00\x10\x80", False),
            (b"\x2a\x1a\x02" + bytes(range(1, 25)) + b"\x80", True),  # MDCV
            (b"\x2a\x04\x04\xb5\x11\x80", True),  # ITU-T T.35
            (b"\x2a\x02\x04\xb5", False),
            (b"\x2a\x04\x03\x0e\x00\x80", True),  # scalability
            (b"\x2a\x03\x03\x0e\x80", False),
            (b"\x2a\x02\x07\x80", True), (b"\x2a\x02\x07\x00", False),
            (b"\x55\x66", False), (other, True), (other + b"\x12\x00", True)):
        want = _same(path, _grow_item(first, extra))
        assert (want is not None) == readable, extra
    np.testing.assert_array_equal(
        _same(path, _grow_item(first, other)),
        _cv2_rgb_bytes(tmp_path, _cv2_avif(page[100:164, 100:196])))


def _cv2_rgb_bytes(tmp_path, data: bytes) -> np.ndarray:
    path = tmp_path / "other.avif"
    path.write_bytes(data)
    return _cv2_rgb(path)


def test_single_item_of_the_grid_writer(tmp_path):
    """libavif_encode's single items of the same cells read as before: the
    writers share their code."""
    img = _colour(64, 96)
    data = libavif_encode(ycbcr_planes(img, "420", 8), 8, "420", speed=9)
    assert _avif_container(data)["grid"] is None
    assert _same(tmp_path / "one.avif", data) is not None
