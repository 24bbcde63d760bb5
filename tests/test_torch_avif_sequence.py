"""The port's AVIF reader (io/images.py over native/av1.cpp) on image
sequences against ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``
(cv2 5.0's AvifDecoder over libavif 1.4.2 and libaom 3.14.1), byte for
byte and None for None: cv2.imread gives a sequence's first frame. Pillow
writes the sequences (save_all, RGB and RGBA: a colour track, and an alpha
track that names it through tref/auxl). Edits of the brands and of the
meta and moov boxes show which source libavif's AVIF_DECODER_SOURCE_AUTO
reads (the track where the major brand is avis, or where it is not avif and
a moov was read; the primary item else), and a seeded fuzz of the track's
boxes (tkhd, tref, edts/elst, mdia, minf, stbl and its sample tables)
holds the port to libavif's rules."""

import io

import numpy as np
import pytest
from PIL import Image

from ocr_inference_tpu_torch.io.images import (
    _avif_container, image_format, read_image, unsupported,
)
from tests.image_writers import (
    iloc_fields, isobmff_boxes, put_uint, sequence_avif,
)
from tests.test_torch_avif import _cv2_rgb, _scan

# refusals a fuzzed file may meet where cv2 reads it: a frame libavif
# scales to the track's size, premultiplied alpha the port does not
# divide out
REFUSED = ("track size differs", "premultiplied alpha")


def _sequence(mode: str, frames: int = 3, seed: int = 0) -> bytes:
    """Pillow's sequence of seeded 64x96 crops of the scanned page (an
    alpha ramp in RGBA)."""
    rng = np.random.default_rng(seed)
    page = _scan()
    images = []
    for _ in range(frames):
        y, x = (int(v) for v in rng.integers(0, 400, 2))
        crop = page[y:y + 64, x:x + 96]
        if mode == "RGBA":
            ramp = np.broadcast_to(np.linspace(0, 255, 96).astype(np.uint8),
                                   (64, 96))
            crop = np.dstack([crop, ramp])
        images.append(Image.fromarray(np.ascontiguousarray(crop)))
    buf = io.BytesIO()
    images[0].save(buf, "AVIF", save_all=True, append_images=images[1:])
    return buf.getvalue()


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


def _box(data: bytes, path: tuple, nth: int = 0) -> tuple[int, int]:
    return [(a, e) for p, a, e in isobmff_boxes(data) if p == path][nth]


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_pillow_sequences(tmp_path, mode):
    """Pillow's sequences read as their first frame from the track (major
    brand avis), equal to cv2, to the frame Pillow was given's AVIF and to
    the primary item Pillow also writes; the alpha track's first sample is
    decoded too."""
    data = _sequence(mode)
    assert data[8:12] == b"avis"
    c = _avif_container(data)
    assert c["source"] == "track" and c["frames"] == 3
    assert (c["alpha"] is not None) == (mode == "RGBA")
    want = _same(tmp_path / "s.avif", data)
    as_item = _same(tmp_path / "i.avif", data[:8] + b"avif" + data[12:])
    assert _avif_container(data[:8] + b"avif" + data[12:])["source"] == \
        "item"
    np.testing.assert_array_equal(want, as_item)
    path = tmp_path / "w.avif"
    sequence_avif(path)  # the writer other tests use
    assert _same(path, path.read_bytes()) is not None


def _poison_item(data: bytes) -> bytes:
    """The file with its primary item's data cut to one byte: where the
    item is read the file gives None, where the track is read it does
    not (a file without meta stays as it is)."""
    if not any(p == (b"meta",) for p, _, _ in isobmff_boxes(data)):
        return data
    (_, _), (at, size) = iloc_fields(data)[1]["extents"][0]
    return put_uint(data, at, size, 1)


def _poison_track(data: bytes) -> bytes:
    """The file with the colour track's first sample cut to one byte (its
    stsz entry; a file without moov stays as it is)."""
    if not any(p == (b"moov",) for p, _, _ in isobmff_boxes(data)):
        return data
    at, _ = _box(data, (b"moov", b"trak", b"mdia", b"minf", b"stbl",
                        b"stsz"))
    return put_uint(data, at + 20, 4, 1)


def _brand_cases(data: bytes) -> dict:
    end = int.from_bytes(data[:4], "big")
    compatible = data[16:end]
    assert compatible[:8] == b"avifavis"

    def brands(major, compat=compatible):
        return data[:8] + major + data[12:16] + compat + data[end:]

    meta_at = _box(data, (b"meta",))[0] + 4
    moov_at = _box(data, (b"moov",))[0] + 4
    no_meta = data[:meta_at] + b"free" + data[meta_at + 4:]
    no_moov = data[:moov_at] + b"free" + data[moov_at + 4:]
    return {
        # (file, the source libavif reads, or None where it fails first)
        "avis": (data, "track"),
        "major avif": (brands(b"avif"), "item"),
        "major mif1": (brands(b"mif1"), "track"),
        "major mif1, no avis": (
            brands(b"mif1", compatible.replace(b"avis", b"xxxx")), "item"),
        "major mif1, no avif": (
            brands(b"mif1", compatible.replace(b"avif", b"xxxx")), "track"),
        "no meta": (no_meta, None),
        "no meta, no avif": (no_meta[:16] + b"xxxx" + no_meta[20:],
                             "track"),
        "no moov": (no_moov, None),
        "no moov, major avif": (brands(b"avif")[:moov_at] + b"free"
                                + brands(b"avif")[moov_at + 4:], None),
        "no moov, avif only": (
            no_moov[:8] + b"avif" + no_moov[12:20] + b"xxxx"
            + no_moov[24:], "item"),
    }


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_brands_meta_and_moov(tmp_path, mode):
    """Which source is read, held to cv2 by files whose item or whose track
    is cut: brand avif asks for meta and avis for moov (a file without the
    box its brands ask for gives None, cv2 does not fall back to the
    other); the major brand picks avis's track or avif's item, another
    major brand the track where a moov was read before libavif had what
    its brands ask for, the item else."""
    data = _sequence(mode)
    for name, (edit, source) in _brand_cases(data).items():
        want = _same(tmp_path / "b.avif", edit)
        assert (want is None) == (source is None), name
        if source is None:
            continue
        assert _avif_container(edit)["source"] == source, name
        item_cut = _same(tmp_path / "b.avif", _poison_item(edit))
        track_cut = _same(tmp_path / "b.avif", _poison_track(edit))
        assert (item_cut is None) == (source == "item"), name
        assert (track_cut is None) == (source == "track"), name


def test_alpha_track(tmp_path):
    """The alpha track is the one whose tref/auxl names the colour track
    and whose auxi, where it has one, names alpha (a broken auxi fails the
    file); its first sample is decoded, so its sample table is read: cut,
    the file gives None; not alpha, it is not read."""
    data = _sequence("RGBA")
    stsc = _box(data, (b"moov", b"trak", b"mdia", b"minf", b"stbl",
                       b"stsc"), 1)[0]
    broken = put_uint(data, stsc + 20, 4, 0x400003)  # samples per chunk
    auxi = _box(data, (b"moov", b"trak", b"mdia", b"minf", b"stbl", b"stsd",
                       b"av01", b"auxi"))[0]
    tref = _box(data, (b"moov", b"trak", b"tref"))[0]
    path = tmp_path / "a.avif"
    assert _same(path, broken) is None
    for edit, readable in (
            (put_uint(broken, auxi + 4, 1, ord("x")), False),  # no auxi
            (put_uint(broken, auxi + 40, 1, ord("X")), True),  # another urn
            (put_uint(broken, tref + 19, 1, 5), True),  # auxl to track 5
            (put_uint(data, auxi + 8, 1, 1), False),  # auxi version 1
            (put_uint(data, auxi + 55, 1, ord("A")), False)):  # no NUL
        assert (_same(path, edit) is not None) == readable


def test_first_sample_not_a_key_frame(tmp_path):
    """A track whose first sample is the sequence's second frame (an
    inter frame, without a sequence header) gives None, as in cv2."""
    data = _sequence("RGB")
    stbl = (b"moov", b"trak", b"mdia", b"minf", b"stbl")
    stsz = _box(data, stbl + (b"stsz",))[0]
    stco = _box(data, stbl + (b"stco",))[0]
    first = int.from_bytes(data[stsz + 20:stsz + 24], "big")
    offset = int.from_bytes(data[stco + 16:stco + 20], "big")
    second = put_uint(data, stco + 16, 4, offset + first)
    second = put_uint(second, stsz + 20, 4,
                      int.from_bytes(data[stsz + 24:stsz + 28], "big"))
    assert _same(tmp_path / "k.avif", second) is None


_TRACK_BOXES = (b"tkhd", b"tref", b"edts", b"elst", b"mdia", b"mdhd",
                b"hdlr", b"minf", b"stbl", b"stsd", b"av01", b"stts",
                b"stsc", b"stsz", b"stco", b"stss", b"trak", b"moov")


@pytest.mark.parametrize("seed", range(4))
def test_track_fuzz(tmp_path, seed):
    """Seeded edits (one or two bytes set to 0, 1, 2, 0xFF, a random
    value, or one bit flipped) of a sequence's moov boxes: each reads
    equal to cv2, gives None where cv2 does, or (where cv2 reads it) is
    refused by a name REFUSED lists."""
    rng = np.random.default_rng(seed)
    files = [_sequence("RGB"), _sequence("RGBA")]
    path = tmp_path / "z.avif"
    for k in range(150):
        data = files[k % 2]
        spans = [(a, e) for p, a, e in isobmff_boxes(data)
                 if p[0] == b"moov" and p[-1] in _TRACK_BOXES]
        start, end = spans[int(rng.integers(len(spans)))]
        edit = bytearray(data)
        for _ in range(int(rng.integers(1, 3))):
            at = int(rng.integers(start, end))
            edit[at] = int(rng.choice([0, 1, 2, 0xFF, rng.integers(256),
                                       edit[at] ^ (1 << rng.integers(8))]))
        path.write_bytes(bytes(edit))
        want = _cv2_rgb(path)
        try:
            got = read_image(path)
        except NotImplementedError as e:
            assert want is not None and any(w in str(e) for w in REFUSED), \
                str(e)
            continue
        if want is None:
            assert got is None, (start, end)
        else:
            assert got is not None and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
