"""The port's JPEG 2000 reader (io/images.py, native/jp2.cpp) against
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` (OpenJPEG 2.5.3 in
cv2 5.0), byte for byte: JP2 files and raw J2K codestreams written by
Pillow and by OpenJPEG's own encoder (tests/image_writers.py, through
ctypes, for the code-block styles, SOP/EPH, POC, tile-parts, ROI and
precisions Pillow does not reach), JP2 boxes written here around them
(colour spaces, palettes, channel definitions), packed packet headers, and
seeded truncations and corruptions, which give what cv2 gives: an image or
None; the Part 2 markers OpenJPEG reads; the HT code-block style bit over
empty and over Part 1 code-blocks (tests/test_torch_htj2k.py holds HT
code-blocks from a writer of their own)."""

import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from ocr_inference_tpu_torch.io.images import (
    image_format, read_image, unsupported,
)
from tests.image_writers import (
    j2k_ht_flagged, j2k_mcc, j2k_mco, j2k_mct, j2k_packed_headers,
    j2k_segment, jp2_file, openjpeg_encode,
)


def _cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _same(path, data=None):
    """read_image equals cv2 (an image or None) and unsupported() passes
    the file."""
    if data is not None:
        path.write_bytes(data)
    want, got = _cv2_rgb(path), read_image(path)
    if want is None:
        assert got is None, path.name
    else:
        assert got is not None, path.name
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert unsupported(path) is None
    return want


def _page(rng, h, w, c=3, prec=8):
    """Smooth shapes with noise: code-blocks with many bit-planes and
    runs of zeros both."""
    yy, xx = np.mgrid[:h, :w]
    base = 0.5 + 0.35 * np.sin(xx / 5.0 + yy / 9.0)[..., None]
    noise = rng.normal(0, 0.06, (h, w, c))
    return ((base + noise).clip(0, 1) * ((1 << prec) - 1)).astype(np.int64)


def _pillow(img, mode=None, **save):
    import io

    buf = io.BytesIO()
    Image.fromarray(np.asarray(img, np.uint8), mode).save(buf, "JPEG2000",
                                                          **save)
    return buf.getvalue()


def test_openjpeg_writer_round_trips_through_cv2(tmp_path):
    """The ctypes layout of OpenJPEG's encoder structs is right: a lossless
    codestream of known samples reads back equal in cv2, and in the
    port."""
    samples = np.random.default_rng(0).integers(0, 256, (33, 47, 3))
    path = tmp_path / "x.j2k"
    np.testing.assert_array_equal(
        _same(path, openjpeg_encode(samples, rates=[0])), samples)


@pytest.mark.parametrize("progression",
                         ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"])
@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
def test_progressions_and_wavelets(tmp_path, progression, irreversible):
    """Each progression order, 5/3 and 9/7, with layers, tiles of odd
    size, precincts and small code-blocks, through Pillow."""
    rng = np.random.default_rng(len(progression) + irreversible)
    img = _page(rng, 75, 98).astype(np.uint8)
    for kw in (dict(), dict(tile_size=(37, 41), quality_mode="rates",
                            quality_layers=[30, 10, 2]),
               dict(precinct_size=(16, 16), codeblock_size=(8, 16),
                    num_resolutions=4)):
        _same(tmp_path / "x.jp2", _pillow(
            img, progression=progression, irreversible=irreversible, **kw))


@pytest.mark.parametrize("mode", [1, 2, 4, 8, 16, 32, 1 | 2 | 4, 63, 1 | 8,
                                  4 | 32])
def test_code_block_styles(tmp_path, mode):
    """BYPASS (1), RESET (2), TERMALL (4), VSC (8), PTERM (16), SEGSYM
    (32) and mixes, lossless and lossy, through OpenJPEG's encoder."""
    rng = np.random.default_rng(mode)
    img = _page(rng, 70, 83)
    for irreversible, rates in ((0, [0]), (1, [25, 8, 1])):
        _same(tmp_path / "x.jp2", openjpeg_encode(
            img, jp2=True, mode=mode, irreversible=irreversible,
            rates=rates))


@pytest.mark.parametrize("case", [
    dict(csty=2), dict(csty=4), dict(csty=6, tp_on=1, tp_flag=b"R"),
    dict(csty=6, tp_on=1, tp_flag=b"L", tile=(32, 48)),
    dict(tp_on=1, tp_flag=b"C", tile=(40, 40)),
    dict(extra=("PLT=YES", "TLM=YES"), tp_on=1, tp_flag=b"R"),
    dict(roi_compno=0, roi_shift=3), dict(roi_compno=1, roi_shift=6),
    dict(pocs=[(1, 0, 0, 1, 3, 3, 2), (1, 0, 0, 3, 3, 3, 4)]),
    dict(pocs=[(1, 1, 0, 2, 3, 3, 1), (1, 0, 0, 3, 3, 3, 0)], csty=4),
    dict(precincts=[(4, 4), (5, 5), (6, 6)], prog_order=3),
    dict(cblockw_init=4, cblockh_init=1024 // 4 // 4),
    dict(cblockw_init=1024, cblockh_init=4),
], ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items())[:40])
def test_markers_tile_parts_poc_roi(tmp_path, case):
    """SOP and EPH markers, tile-parts by resolution, layer and
    component, PLT/TLM, ROI maxshift, POC changes of progression,
    precincts per resolution and the code-block size limits."""
    rng = np.random.default_rng(sum(map(ord, str(case))))
    img = _page(rng, 64, 90)
    for irreversible in (0, 1):
        _same(tmp_path / "x.jp2", openjpeg_encode(
            img, jp2=True, numresolution=3, rates=[30, 8, 1],
            irreversible=irreversible, **case))


@pytest.mark.parametrize("prec", [1, 4, 7, 8, 9, 10, 12, 16])
def test_precisions(tmp_path, prec):
    """cv2 gives None below 8 bits; above, it shifts every component
    right by the precision less 8. Signed components give None."""
    rng = np.random.default_rng(prec)
    for c, jp2, space in ((3, True, 1), (1, True, 2), (3, False, 1)):
        img = rng.integers(0, 1 << prec, (21, 34, c))
        _same(tmp_path / "x.jp2", openjpeg_encode(
            img, prec=prec, jp2=jp2, color_space=space, numresolution=2,
            irreversible=int(prec > 9), rates=[0]))
    img = rng.integers(-(1 << (prec - 1)), 1 << (prec - 1), (21, 34, 3))
    assert _same(tmp_path / "s.jp2", openjpeg_encode(
        img, prec=prec, sgnd=True, jp2=True, numresolution=2)) is None


@pytest.mark.parametrize("space", [None, 16, 17, 18, 12, 24, 14, 5, "icc"])
@pytest.mark.parametrize("comps", [1, 2, 3, 4])
def test_colour_spaces(tmp_path, space, comps):
    """The colr box as cv2 maps it: greyscale from component 0, sYCC
    through cvtColor's YUV -> BGR, sRGB and every unknown space (no colr,
    an ICC profile, other EnumCS) from the first three components, None
    with fewer; CMYK and e-sYCC give None. A raw codestream is
    unspecified."""
    rng = np.random.default_rng(comps * 31 + len(str(space)))
    img = rng.integers(0, 256, (19, 26, comps))
    cs = openjpeg_encode(img, numresolution=2, tcp_mct=0)
    colr = None if space is None else ("icc", b"\0" * 16) \
        if space == "icc" else ("enum", space)
    _same(tmp_path / "x.jp2", jp2_file(cs, 19, 26, comps, colr=colr))
    _same(tmp_path / "x.j2k", cs)


def test_sycc_and_gray_pages(tmp_path):
    """sYCC 4:4:4 from OpenJPEG's encoder, gray and gray with alpha from
    Pillow, RGBA; sYCC 4:2:0 and 4:2:2 subsampled components give None in
    cv2 (it needs every component at full size), as does an image
    offset."""
    rng = np.random.default_rng(3)
    img = _page(rng, 40, 52)
    _same(tmp_path / "a.jp2", openjpeg_encode(img, jp2=True, color_space=3,
                                              tcp_mct=0))
    for sub in (2, 3):
        assert _same(tmp_path / "b.jp2", openjpeg_encode(
            img, jp2=True, color_space=3, subsampling=sub)) is None
    u8 = img.astype(np.uint8)
    for mode in ("L", "LA", "RGBA"):
        _same(tmp_path / "c.jp2", _pillow(Image.fromarray(u8).convert(mode)))
    assert _same(tmp_path / "d.jp2", openjpeg_encode(
        img, jp2=True, offset=(3, 5))) is None


def test_palettes_and_channel_definitions(tmp_path):
    """pclr/cmap (entries of 1-16 bits, direct and palette mapping, the
    index clipped to the palette) and cdef reordering, with every colour
    space: cv2 keeps the low byte of an entry wider than 8 bits. Broken
    boxes (cdef incomplete or out of range, cmap past the components)
    give None."""
    rng = np.random.default_rng(8)
    cases = 0
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(4, 30, 2))
        prec = int(rng.choice([8, 8, 9, 12]))
        index = rng.integers(0, 1 << prec, (h, w, 1))
        cs = openjpeg_encode(index, prec=prec, numresolution=2)
        npc = int(rng.choice([1, 3, 4]))
        sizes = [int(rng.choice([7, 7, 15, 4, 11])) for _ in range(npc)]
        count = int(rng.integers(1, 1025))
        entries = np.stack([rng.integers(0, 1 << ((s & 0x7F) + 1), count)
                            for s in sizes], -1)
        cmap = [(0, 1, j) for j in range(npc)]
        if rng.random() < 0.15:
            cmap[0] = (0, 0, 0)
        if rng.random() < 0.1:
            cmap[-1] = (1, 1, npc - 1)
        cdef = None
        if rng.random() < 0.4:
            order = rng.permutation(npc)
            cdef = [(j, 0 if j < 3 else 1, int(order[j]) + 1 if j < 3 else 0)
                    for j in range(npc)]
            if rng.random() < 0.2:
                cdef = cdef[:-1]
        space = [("enum", 16), ("enum", 17), ("enum", 18), None][
            int(rng.integers(0, 4))]
        _same(tmp_path / "p.jp2", jp2_file(cs, h, w, 1, colr=space,
                                           pclr=(entries, sizes), cmap=cmap,
                                           cdef=cdef))
        cases += 1
    rgb = rng.integers(0, 256, (12, 15, 3))
    cs = openjpeg_encode(rgb, numresolution=2)
    for cdef in ([(0, 0, 3), (1, 0, 2), (2, 0, 1)], [(0, 0, 1), (1, 0, 2)],
                 [(0, 0, 1), (1, 0, 2), (5, 0, 3)]):
        _same(tmp_path / "c.jp2", jp2_file(cs, 12, 15, 3, cdef=cdef))
    assert cases == 60


@pytest.mark.parametrize("where", ["ppt", "ppm"])
def test_packed_packet_headers(tmp_path, where):
    """Packet headers moved into PPT (tile-part header) or PPM (main
    header) markers, SOP markers left in the packets."""
    rng = np.random.default_rng(5)
    img = _page(rng, 48, 61)
    for kw in (dict(), dict(rates=[20, 5, 1], prog_order=2, irreversible=1)):
        data = j2k_packed_headers(openjpeg_encode(img, csty=6, **kw), where)
        assert _same(tmp_path / "x.j2k", data) is not None


@pytest.mark.parametrize("seed", range(6))
def test_truncations_and_corruptions(tmp_path, seed):
    """Seeded damage, each held against cv2: bytes flipped in the packet
    data or anywhere in the codestream, runs of zeros, cuts anywhere
    (OpenJPEG's strict mode, as cv2 runs it, fails on a cut tile-part)."""
    rng = np.random.default_rng(100 + seed)
    for i in range(30):
        img = _page(rng, int(rng.integers(16, 70)), int(rng.integers(16, 70)))
        data = bytearray(openjpeg_encode(
            img, jp2=True, mode=int(rng.integers(0, 64)),
            csty=int(rng.choice([0, 2, 4, 6])),
            prog_order=int(rng.integers(0, 5)),
            irreversible=int(rng.random() < 0.5), numresolution=3,
            rates=[30, 10, 1] if rng.random() < 0.5 else [0],
            **(dict(tile=(32, 32)) if rng.random() < 0.3 else {})))
        cs = data.index(b"\xff\x4f\xff\x51")
        sod = data.index(b"\xff\x93", cs)
        kind = i % 4
        if kind == 0:
            for _ in range(int(rng.integers(1, 4))):
                at = int(rng.integers(sod + 2, len(data) - 2))
                data[at] ^= int(rng.integers(1, 256))
        elif kind == 1:
            data[int(rng.integers(cs, len(data)))] ^= int(rng.integers(1, 256))
        elif kind == 2:
            data = data[: int(rng.integers(cs, len(data)))]
        else:
            at, n = int(rng.integers(sod + 2, len(data) - 2)), \
                int(rng.integers(1, 20))
            data[at: at + n] = bytes(len(data[at: at + n]))
        _same(tmp_path / "x.jp2", bytes(data))


def test_random_pillow_configurations(tmp_path):
    """Sizes from 1 pixel, every mode Pillow writes, tiles, precincts,
    code-block sizes, layers, resolutions, MCT on and off, PLT, raw
    codestreams."""
    rng = np.random.default_rng(1)
    done = 0
    for _ in range(70):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        mode = str(rng.choice(["RGB", "L", "RGBA", "LA"]))
        img = Image.fromarray(_page(rng, h, w).astype(np.uint8)).convert(mode)
        top = int(np.log2(min(h, w))) + 1
        kw = dict(num_resolutions=int(rng.integers(1, min(top, 7) + 1)),
                  irreversible=bool(rng.random() < 0.5),
                  progression=str(rng.choice(["LRCP", "RLCP", "RPCL", "PCRL",
                                              "CPRL"])))
        if rng.random() < 0.5:
            cbw, cbh = (int(2 ** rng.integers(2, 7)) for _ in range(2))
            if cbw * cbh <= 4096:
                kw["codeblock_size"] = (cbw, cbh)
        if rng.random() < 0.4:
            kw["precinct_size"] = (int(2 ** rng.integers(2, 8)),) * 2
        if rng.random() < 0.4:
            kw.update(quality_mode="rates", quality_layers=sorted(
                (float(x) for x in rng.integers(2, 60, 3)), reverse=True))
        if rng.random() < 0.3:
            kw["tile_size"] = (int(rng.integers(16, 80)),) * 2
        kw["mct"] = int(mode.startswith("RGB") and rng.random() < 0.8)
        kw["no_jp2"] = bool(rng.random() < 0.2)
        kw["plt"] = bool(rng.random() < 0.2)
        try:
            data = _pillow(img, **kw)
        except OSError:
            continue  # a layout Pillow's encoder refuses
        _same(tmp_path / "x.jp2", data)
        done += 1
    assert done > 50


def _with_marker(codestream: bytes, marker: int, payload: bytes) -> bytes:
    """The codestream with one marker segment added after SIZ."""
    siz_len, = struct.unpack_from(">H", codestream, 4)
    at = 4 + siz_len
    return codestream[:at] + struct.pack(">HH", marker, 2 + len(payload)) + \
        payload + codestream[at:]


def test_ht_flagged_files_and_part2_as_cv2(tmp_path):
    """HT code-blocks (code-block style bit 6), which OpenJPEG 2.5 decodes,
    are read as cv2 reads them, whether the bit is set in a COD or COC of
    the main header or of a tile-part header, and unsupported() names
    none of them. Each file is a flat page coded losslessly, so that its
    code-blocks are empty and it is a valid HTJ2K codestream: cv2 reads it.
    A tile-part COD without the bit over a main COD with it is read. A gray
    raw codestream so flagged is None, as cv2 gives None for any
    1-component raw codestream. Part 1 code-blocks flagged HT give None,
    as cv2's HT decoder gives None for them. The Part 2 markers are read
    as OpenJPEG reads them (test_part2_markers)."""
    cs = openjpeg_encode(np.full((16, 20, 3), 128), numresolution=2,
                         tcp_mct=0)
    c0, c1 = _segments(cs)[0xFF52]
    cod_ht = j2k_ht_flagged(cs[c0:c1])
    coc_ht = struct.pack(">HHBB", 0xFF53, 4 + (c1 - c0 - 9), 1,
                         cs[c0 + 4] & 1) + cod_ht[9:]
    cases = {
        "main_cod": j2k_ht_flagged(cs),
        "main_coc": cs[:c1] + coc_ht + cs[c1:],
        "tile_cod": _in_tile_header(cs, cod_ht),
        "tile_coc": _in_tile_header(cs, coc_ht),
    }
    for name, data in cases.items():
        path = tmp_path / f"{name}.j2k"
        want = _same(path, data)
        assert want is not None and (want == 128).all(), name
        assert image_format(path) == "JPEG 2000"
    got = _same(tmp_path / "tile_clears.j2k",
                _in_tile_header(j2k_ht_flagged(cs), cs[c0:c1]))
    assert (got == 128).all()
    gray = openjpeg_encode(np.full((16, 20), 128), numresolution=2)
    assert _same(tmp_path / "gray.j2k", j2k_ht_flagged(gray)) is None
    path = tmp_path / "part1_flagged.j2k"
    assert _same(path, j2k_ht_flagged(openjpeg_encode(
        np.random.default_rng(2).integers(0, 256, (16, 20, 3)),
        numresolution=2))) is None


def _part2_cases() -> dict:
    """Part 2 (and CAP) marker segments, by name: what each splices into a
    codestream's main or first tile-part header."""
    mcc = j2k_mcc(1, 3, offset=1)
    return {
        "cap": j2k_segment(0xFF50, struct.pack(">IH", 1 << 17, 0)),
        "mct": j2k_mct(1, [0, 0, 0]),
        "mct_later_record": j2k_segment(0xFF74, struct.pack(">HHH", 1, 1, 0)
                                        + bytes(12)),
        "mct_short": j2k_segment(0xFF74, bytes(4)),
        "mct_mcc": j2k_mct(1, [0, 0, 0]) + mcc,
        "mcc_names_no_mct": j2k_mcc(1, 3, offset=5),
        "mcc_short": j2k_segment(0xFF75, bytes(4)),
        "mco_offsets_0": j2k_mct(1, [0, 0, 0]) + mcc + j2k_mco(1),
        "mco_offsets_128": j2k_mct(1, [128] * 3) + mcc + j2k_mco(1),
        "mco_offsets_10_20_30": j2k_mct(1, [10, 20, 30]) + mcc + j2k_mco(1),
        "mco_offsets_int16": j2k_mct(1, [-5, 300, 7], etype=0) + mcc
        + j2k_mco(1),
        "mco_offsets_float32": j2k_mct(1, [100.7, -3.2, 128.0], etype=2)
        + mcc + j2k_mco(1),
        "mco_offsets_float64": j2k_mct(1, [1e12, 50.9, 0.0], etype=3) + mcc
        + j2k_mco(1),
        "mco_offsets_wrong_size": j2k_mct(1, [1, 2]) + mcc + j2k_mco(1),
        "mco_without_mcc": j2k_mco(1),
        "mco_no_stage": j2k_mco(),
        "mco_two_stages": j2k_mco(1, 2),
        "mco_mcc_of_4_components": j2k_mct(1, [0] * 4) + j2k_mcc(
            1, 4, offset=1) + j2k_mco(1),
        "mco_decorrelation": j2k_mct(2, [1, 0, 0, 0, 1, 0, 0, 0, 1],
                                     etype=2, array=1)
        + j2k_mcc(1, 3, deco=2) + j2k_mco(1),
        "mco_decorrelation_wrong_size": j2k_mct(2, [1] * 8, etype=2, array=1)
        + j2k_mcc(1, 3, deco=2) + j2k_mco(1),
        "cbd_as_siz": j2k_segment(0xFF78, struct.pack(">HBBB", 3, 7, 7, 7)),
        "cbd_9_bits": j2k_segment(0xFF78, struct.pack(">HBBB", 3, 8, 8, 8)),
        "cbd_mixed": j2k_segment(0xFF78, struct.pack(">HBBB", 3, 7, 6, 7)),
        "cbd_12_bits": j2k_segment(0xFF78, struct.pack(">HBBB", 3, 11, 11,
                                                       11)),
        "cbd_signed": j2k_segment(0xFF78, struct.pack(">HBBB", 3, 0x87, 0x87,
                                                      0x87)),
        "cbd_7_bits": j2k_segment(0xFF78, struct.pack(">HBBB", 3, 6, 6, 6)),
        "cbd_short": j2k_segment(0xFF78, struct.pack(">HBB", 2, 7, 7)),
        "ads_atk_dco_nlt": b"".join(j2k_segment(m, bytes(4)) for m in (
            0xFF73, 0xFF79, 0xFF70, 0xFF76)),
    }


@pytest.mark.parametrize("where", ["main", "tile"])
@pytest.mark.parametrize("case", sorted(_part2_cases()))
@pytest.mark.parametrize("irreversible", [0, 1], ids=["53", "97"])
def test_part2_markers(tmp_path, case, where, irreversible):
    """The Part 2 markers OpenJPEG reads, in the main header or a tile-part
    header, each held against cv2: MCT and MCC records, an MCO that
    replaces the DC level shifts by its MCC's offset array (elements of
    each type, converted as OpenJPEG converts them) or by zero, CBD's
    precision and signedness (main header only), malformed records (None),
    and CAP and the markers OpenJPEG does not read (read past in the main
    header, None in a tile-part header)."""
    img = _page(np.random.default_rng(3), 24, 28)
    cs = openjpeg_encode(img, numresolution=2, irreversible=irreversible)
    segment = _part2_cases()[case]
    if where == "main":
        siz = 4 + struct.unpack_from(">H", cs, 4)[0]
        data = cs[:siz] + segment + cs[siz:]
    else:
        data = _in_tile_header(cs, segment)
    want = _same(tmp_path / "x.j2k", data)
    if case == "mco_offsets_10_20_30":  # the offsets change the page
        assert not np.array_equal(want, _same(tmp_path / "plain.j2k", cs))


_PLACED_MARKERS = {
    # (header, marker, payload): what OpenJPEG reads past after a check,
    # or refuses where it stands
    "main_tlm": ("main", 0xFF55, b"\0\x50" + bytes(5)),
    "main_tlm_short": ("main", 0xFF55, b"\0"),
    "main_plm": ("main", 0xFF57, b"\0"),
    "main_plm_empty": ("main", 0xFF57, b""),
    "main_crg": ("main", 0xFF63, bytes(12)),
    "main_crg_short": ("main", 0xFF63, bytes(8)),
    "main_com_empty": ("main", 0xFF64, b""),
    "main_cpf": ("main", 0xFF59, b""),
    "main_plt": ("main", 0xFF58, b"\0\x05"),
    "main_ppt": ("main", 0xFF61, b"\0\x05"),
    "main_sop": ("main", 0xFF91, bytes(4)),
    "main_eph": ("main", 0xFF92, b""),
    "main_unknown": ("main", 0xFF6A, bytes(4)),
    "tile_plt": ("tile", 0xFF58, b"\0\x81\x05"),
    "tile_plt_empty": ("tile", 0xFF58, b""),
    "tile_com_empty": ("tile", 0xFF64, b""),
    "tile_tlm": ("tile", 0xFF55, bytes(4)),
    "tile_cap": ("tile", 0xFF50, bytes(4)),
    "tile_unknown": ("tile", 0xFF6A, bytes(4)),
}


@pytest.mark.parametrize("case", sorted(_PLACED_MARKERS))
def test_marker_placement_and_size_checks(tmp_path, case):
    """Markers OpenJPEG reads past, after its own checks of their size,
    and markers it refuses in a header where they do not belong (PLT, PPT
    and SOP in the main header; TLM, CAP and unknown markers in a
    tile-part header), each held against cv2."""
    where, marker, payload = _PLACED_MARKERS[case]
    cs = openjpeg_encode(_page(np.random.default_rng(8), 16, 20),
                         numresolution=2)
    segment = j2k_segment(marker, payload)
    if where == "main":
        siz = 4 + struct.unpack_from(">H", cs, 4)[0]
        data = cs[:siz] + segment + cs[siz:]
    else:
        data = _in_tile_header(cs, segment)
    _same(tmp_path / "x.j2k", data)


def test_jp2_box_structure(tmp_path):
    """What OpenJPEG's jp2.c refuses (cv2 None): no signature box first,
    no ftyp second, no jp2h, ihdr not first in jp2h, a box past the end;
    what it reads: unknown boxes skipped, XL box lengths, a jp2c box of
    length 0, a second colr box ignored."""
    img = np.random.default_rng(4).integers(0, 256, (12, 14, 3))
    cs = openjpeg_encode(img, numresolution=2)
    good = jp2_file(cs, 12, 14, 3)
    sig, rest = good[:12], good[12:]
    ftyp_len, = struct.unpack_from(">I", rest)
    ftyp, tail = rest[:ftyp_len], rest[ftyp_len:]
    jp2h_len, = struct.unpack_from(">I", tail)
    jp2h, jp2c = tail[:jp2h_len], tail[jp2h_len:]
    free = struct.pack(">I4s", 12, b"free") + b"abcd"
    xl = struct.pack(">I4sQ", 1, b"jp2c", 16 + len(cs)) + cs
    colr2 = jp2h[:8] + jp2h[8:] + struct.pack(">I4sBBBI", 15, b"colr", 1, 0,
                                              0, 17)
    colr2 = struct.pack(">I", len(colr2)) + colr2[4:]
    cases = {
        "ok_free_box": sig + ftyp + free + jp2h + free + jp2c,
        "ok_xl_jp2c": sig + ftyp + jp2h + xl,
        "ok_zero_length_jp2c": sig + ftyp + jp2h + struct.pack(
            ">I4s", 0, b"jp2c") + cs,
        "ok_second_colr_ignored": sig + ftyp + colr2 + jp2c,
        "no_ftyp": sig + jp2h + jp2c,
        "no_jp2h": sig + ftyp + jp2c,
        "jp2c_before_jp2h": sig + ftyp + jp2c + jp2h,
        "box_past_end": sig + ftyp + jp2h[:-4],
    }
    for name, data in cases.items():
        got = _same(tmp_path / f"{name}.jp2", data)
        assert (got is not None) == name.startswith("ok"), name


def _segments(codestream: bytes) -> dict:
    """The main header's marker segments: marker -> (start, end)."""
    out, pos = {}, 2
    while True:
        marker, length = struct.unpack_from(">HH", codestream, pos)
        if marker == 0xFF90:
            return out
        out.setdefault(marker, (pos, pos + 2 + length))
        pos += 2 + length


def _in_tile_header(codestream: bytes, segment: bytes) -> bytes:
    """A marker segment added to the first tile-part's header, its Psot
    grown to match."""
    sot = codestream.index(b"\xff\x90")
    psot, = struct.unpack_from(">I", codestream, sot + 6)
    head = codestream[:sot + 6] + struct.pack(">I", psot + len(segment)) + \
        codestream[sot + 10: sot + 12]
    return head + segment + codestream[sot + 12:]


def test_quantisation_and_tile_header_markers(tmp_path):
    """Markers OpenJPEG's encoder does not write, spliced into its
    codestreams: scalar derived quantisation (QCD style 1), a QCC of other
    step sizes for one component, the same in a tile-part header (a tile
    QCD overrides a main-header QCC, as OpenJPEG copies it to every
    component), a tile-header COD of another MCT, an RGN shift, a COC of
    the same code-block style; each decoded as cv2 decodes it."""
    img = _page(np.random.default_rng(6), 40, 56)
    cs = openjpeg_encode(img, irreversible=1, numresolution=3,
                         rates=[20, 4])
    seg = _segments(cs)
    q0, q1 = seg[0xFF5C]
    qcd = cs[q0 + 4: q1]  # Sqcd, then a 16-bit step size a band
    derived = struct.pack(">HHB", 0xFF5C, 5, (qcd[0] & 0xE0) | 1) + qcd[1:3]
    steps = np.frombuffer(qcd[1:], ">u2")
    other = ((steps & 0xF800) | ((steps & 0x7FF) + 301) % 2048).astype(">u2")
    qcc = struct.pack(">HHBB", 0xFF5D, 4 + other.nbytes, 2, qcd[0]) + \
        other.tobytes()
    c0, c1 = seg[0xFF52]
    cod = bytearray(cs[c0: c1])
    cod[8] ^= 1  # SGcod's MCT byte
    rgn = struct.pack(">HHBBB", 0xFF5E, 5, 1, 0, 2)
    coc = struct.pack(">HHBB", 0xFF53, 4 + (c1 - c0 - 9), 0,
                      cs[c0 + 4] & 1) + cs[c0 + 9: c1]
    cases = {
        "derived": cs[:q0] + derived + cs[q1:],
        "qcc": cs[:q1] + qcc + cs[q1:],
        "tile_qcc": _in_tile_header(cs, qcc),
        "tile_qcd_over_qcc": _in_tile_header(cs[:q1] + qcc + cs[q1:],
                                             derived),
        "tile_cod_mct": _in_tile_header(cs, bytes(cod)),
        "tile_cod_twice": _in_tile_header(_in_tile_header(cs, bytes(cod)),
                                          cs[c0: c1]),
        "rgn": cs[:q1] + rgn + cs[q1:],
        "coc": cs[:q1] + coc + cs[q1:],
    }
    for name, data in cases.items():
        assert _same(tmp_path / f"{name}.j2k", data) is not None, name


def _damaged_headers(cs: bytes) -> dict:
    """Named edits of a one-tile codestream's markers (each held against
    cv2): Psot too large, too small, zero; marker lengths off by one; the
    SOT's tile index and tile-part numbers out of range; EOC missing,
    doubled or followed by bytes; a second COD; a QCD short of bands."""
    seg = _segments(cs)
    sot = cs.index(b"\xff\x90")
    psot, = struct.unpack_from(">I", cs, sot + 6)

    def with_psot(value):
        return cs[:sot + 6] + struct.pack(">I", value) + cs[sot + 10:]

    def with_byte(at, value):
        return cs[:at] + bytes([value]) + cs[at + 1:]

    c0, c1 = seg[0xFF52]
    q0, q1 = seg[0xFF5C]
    return {
        "psot_plus_1": with_psot(psot + 1),
        "psot_plus_100": with_psot(psot + 100),
        "psot_minus_1": with_psot(psot - 1),
        "psot_minus_40": with_psot(psot - 40),
        "psot_zero": with_psot(0),
        "psot_13": with_psot(13),
        "lsot_11": with_byte(sot + 3, 11),
        "isot_7": with_byte(sot + 5, 7),
        "tpsot_1_of_1": with_byte(sot + 10, 1),
        "tnsot_0": with_byte(sot + 11, 0),
        "tnsot_2": with_byte(sot + 11, 2),
        "lcod_plus_1": with_byte(c0 + 3, cs[c0 + 3] + 1),
        "lcod_minus_1": with_byte(c0 + 3, cs[c0 + 3] - 1),
        "lsiz_minus_1": with_byte(5, cs[5] - 1),
        "csiz_2": with_byte(41, 2),
        "cod_twice": cs[:c1] + cs[c0:c1] + cs[c1:],
        "qcd_short": cs[:q0 + 3] + bytes([cs[q0 + 3] - 4]) + cs[q0 + 4:q1 - 4]
        + cs[q1:],
        "cblk_style_bit_7": with_byte(c0 + 12, cs[c0 + 12] | 0x80),
        "transform_2": with_byte(c0 + 13, 2),
        "progression_5": with_byte(c0 + 5, 5),
        "mct_2": with_byte(c0 + 8, 2),
        "no_eoc": cs[:-2],
        "eoc_twice": cs + b"\xff\xd9",
        "bytes_after_eoc": cs + b"\x00\x01\x02",
        "garbage_marker_end": cs[:-2] + b"\xff\x30",
    }


@pytest.mark.parametrize("irreversible", [0, 1])
def test_marker_damage(tmp_path, irreversible):
    """Broken marker segments, each decoded (or given None) as cv2 does."""
    img = _page(np.random.default_rng(11), 37, 45)
    cs = openjpeg_encode(img, irreversible=irreversible, numresolution=3,
                         rates=[20, 4], csty=6)
    for name, data in _damaged_headers(cs).items():
        _same(tmp_path / f"{name}.j2k", data)
