"""Small image encoders for the reader tests and the fixture: TIFF files
with the layouts cv2 and PIL do not write (tiles, 16-bit samples, palette,
orientation, fill order, both byte orders), Adam7-interlaced PNG, JPEG
2000 (JP2 boxes around a codestream, OpenJPEG's own encoder driven through
ctypes for the options Pillow does not reach, packed packet headers), BMP
(every header, RLE8), PNM/PAM, AVIF through the libavif cv2 bundles
(grids, layers, the fields cv2 and Pillow do not set) and edits of AVIF
boxes. cv2 stays the oracle."""

from __future__ import annotations

import io
import struct
import zlib
from pathlib import Path

import numpy as np


def packbits(data: bytes) -> bytes:
    """PackBits: literal runs of up to 128 bytes, repeats of 3..128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i + 1)]) + data[i: i + 1]
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _raw_rows(samples: np.ndarray, bits: int, order: str) -> np.ndarray:
    """(h, w, spp) samples -> (h, row_bytes) bytes in file layout."""
    h, w, spp = samples.shape
    if bits == 16:
        return samples.astype(order + "u2").view(np.uint8).reshape(h, -1)
    if bits == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    flat = samples.reshape(h, w * spp).astype(np.uint8)
    per = 8 // bits
    pad = (-flat.shape[1]) % per
    flat = np.pad(flat, ((0, 0), (0, pad)))
    flat = flat.reshape(h, -1, per)
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    return (flat << shifts).sum(axis=2, dtype=np.uint8)


def _difference(samples: np.ndarray) -> np.ndarray:
    """The horizontal predictor's differencing, per sample, wrapping."""
    out = samples.copy()
    out[:, 1:] = samples[:, 1:] - samples[:, :-1]
    return out


def lzw(data: bytes) -> bytes:
    """TIFF LZW (MSB first, the code width growing one code early), a clear
    code first and whenever the table fills."""
    out, acc, nbits = bytearray(), 0, 0
    width = 9

    def emit(code):
        nonlocal acc, nbits
        acc = (acc << width) | code
        nbits += width
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)

    table = {bytes([i]): i for i in range(256)}
    next_code = 258
    emit(256)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = next_code
        next_code += 1
        if next_code == 1 << width:
            width += 1
        if next_code >= 4093:
            emit(256)
            table = {bytes([i]): i for i in range(256)}
            next_code, width = 258, 9
        w = bytes([c])
    if w:
        emit(table[w])
        next_code += 1
        if next_code == 1 << width:
            width += 1
    emit(257)
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


# ITU-T T.4 terminating codes (runs 0-63), white and black
_FAX_WHITE = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 "
    "01000 001000 000011 110100 110101 101010 101011 0100111 0001100 "
    "0001000 0010111 0000011 0000100 0101000 0101011 0010011 0100100 "
    "0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 "
    "00101011 00101100 00101101 00000100 00000101 00001010 00001011 "
    "01010010 01010011 01010100 01010101 00100100 00100101 01011000 "
    "01011001 01011010 01011011 01001010 01001011 00110010 00110011 "
    "00110100").split()
_FAX_BLACK = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 "
    "0000101 0000111 00000100 00000111 000011000 0000010111 0000011000 "
    "0000001000 00001100111 00001101000 00001101100 00000110111 "
    "00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 "
    "000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 "
    "000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111").split()
_FAX_VERTICAL = {0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010",
                 -2: "000010", -3: "0000010"}
FAX_EXTENSION = "0000001"  # a 2-D extension code, uncompressed mode


def _changes(row) -> list[int]:
    """Changing elements of a row of bools (True = black), from white."""
    out, colour = [], False
    for x, v in enumerate(row):
        if v != colour:
            out.append(x)
            colour = v
    return out


def ccitt_2d(ink: np.ndarray, compression: int, ext=None) -> bytes:
    """A strip of (h, w) bools (True = black, w < 64) coded 2-D: T.6
    (Group 4, ``compression`` 4) or T.4 with every row 2-D after its EOL
    (Group 3, 3; T4Options bit 0). ``ext`` {row: k} writes an extension
    code in place of that row's k-th mode code and drops the rest of the
    row; the rows after it are coded against the row libtiff makes of it
    (from the last change, a run of the current colour of w - a0, then a
    pass mode's pending run in the other colour)."""
    h, w = ink.shape
    ext = ext or {}
    ref = []
    bits = []
    for y in range(h):
        cur = _changes(ink[y]) + [w, w]
        refw = ref + [w, w]
        a0, colour, codes, made = -1, 0, [], []
        while a0 < w:
            if ext.get(y) == len(codes):
                codes.append(FAX_EXTENSION)
                a0 = max(a0, 0)
                last = made[-1] if made else 0
                made += [last + w - a0] + ([w] if a0 > last else [])
                break
            a1 = next(v for v in cur if v > a0)
            i1 = next(i for i, v in enumerate(refw)
                      if v > a0 and i % 2 == colour)
            b1 = refw[i1]
            b2 = refw[i1 + 1] if i1 + 1 < len(refw) else w
            if b2 < a1:
                codes.append("0001")
                a0 = b2
            elif abs(a1 - b1) <= 3:
                codes.append(_FAX_VERTICAL[a1 - b1])
                made.append(a1)
                a0, colour = a1, colour ^ 1
            else:
                a2 = next(v for v in cur if v > a1)
                first, second = ((_FAX_WHITE, _FAX_BLACK) if colour == 0
                                 else (_FAX_BLACK, _FAX_WHITE))
                codes.append("001" + first[a1 - max(a0, 0)]
                             + second[a2 - a1])
                made += [a1, a2]
                a0 = a2
        ref = [min(v, w) for v in made]
        if compression == 3:
            bits.append("000000000001" + "0")
        bits += codes
    if compression == 3:
        bits.append("000000000001")
    s = "".join(bits)
    s += "0" * (-len(s) % 8)
    return bytes(int(s[i: i + 8], 2) for i in range(0, len(s), 8))


def _compress(raw: bytes, compression: int) -> bytes:
    if compression == 1:
        return raw
    if compression in (8, 32946):
        return zlib.compress(raw)
    if compression == 32773:
        return packbits(raw)
    if compression == 5:
        return lzw(raw)
    raise ValueError(compression)


def _ycbcr_blocks(samples: np.ndarray, hs: int, vs: int) -> np.ndarray:
    """(h, w, 3) Y, Cb, Cr samples -> the packed YCbCr layout: per block of
    vs rows by hs columns (edge blocks padded by repeating the last row
    and column), its hs * vs Y samples and then the Cb and Cr of its
    top-left pixel; returns (block rows, blocks across * (hs*vs + 2))."""
    h, w, _ = samples.shape
    bh, bw = -(-h // vs), -(-w // hs)
    rows = np.minimum(np.arange(bh * vs), h - 1)
    cols = np.minimum(np.arange(bw * hs), w - 1)
    full = samples[rows][:, cols]
    y = full[..., 0].reshape(bh, vs, bw, hs).transpose(0, 2, 1, 3)
    chroma = full[::vs, ::hs, 1:]
    blocks = np.concatenate([y.reshape(bh, bw, vs * hs), chroma], axis=2)
    return blocks.reshape(bh, -1)


def _page_chunks(samples, bits, compression, predictor, tile, rows_per_strip,
                 order, fill_order, planar=False, ycbcr=None):
    h, w, spp = samples.shape
    if planar:
        chunks = []
        for s in range(spp):
            chunks += _page_chunks(samples[..., s: s + 1], bits, compression,
                                   predictor, tile, rows_per_strip, order,
                                   fill_order)
        return chunks
    diff = _difference if predictor == 2 else (lambda x: x)

    def raw(block):
        if ycbcr:
            return _ycbcr_blocks(block, *ycbcr).astype(np.uint8)
        return _raw_rows(diff(block), bits, order)

    chunks = []
    if tile:
        tw, th = tile
        ph, pw = -(-h // th) * th, -(-w // tw) * tw
        padded = np.zeros((ph, pw, spp), samples.dtype)
        padded[:h, :w] = samples
        for y in range(0, ph, th):
            for x in range(0, pw, tw):
                chunks.append(raw(padded[y: y + th, x: x + tw]).tobytes())
    else:
        for y in range(0, h, rows_per_strip):
            chunks.append(raw(samples[y: y + rows_per_strip]).tobytes())
    if fill_order == 2:
        rev = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                       np.uint8)
        chunks = [rev[np.frombuffer(c, np.uint8)].tobytes() for c in chunks]
    return [_compress(c, compression) for c in chunks]


# TIFF field types -> struct codes (RATIONAL as two LONGs)
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 7: "B", 16: "Q"}


def write_tiff(path, pages, order: str = "<", big: bool = False) -> None:
    """Write a TIFF (a BigTIFF when ``big``) of one or more pages. Each
    page is a dict: ``samples`` (h, w, spp) integer array (bit values for
    1-bit), ``bits``, ``photometric``, and optionally ``compression`` (1,
    5, 8, 32946 or 32773), ``predictor``, ``tile`` (tw, th),
    ``rows_per_strip``, ``orientation``, ``colormap`` (3 * 2**bits 16-bit
    values), ``extra_samples``, ``fill_order``, ``planar`` (True: one
    plane of strips or tiles per sample, PlanarConfiguration 2),
    ``ycbcr_subsampling`` ((hs, vs): samples are Y, Cb, Cr, written in
    the packed block layout; the tag left out when ``subsampling_tag`` is
    False), ``odd_offsets`` (each strip or tile at an odd file
    offset), ``chunks`` (the strips' or tiles' bytes as
    they are, e.g. JPEG streams, instead of samples encoded here) and
    ``tags`` ({tag: value} set as a SHORT, or {tag: (type, values)} with
    RATIONALs as (numerator, denominator) pairs and UNDEFINED as bytes)."""
    head = b"II" if order == "<" else b"MM"
    if big:
        out = bytearray(head + struct.pack(order + "HHHQ", 43, 8, 0, 0))
        link, off_code, off_type, entry_size = 8, "Q", 16, 20
    else:
        out = bytearray(head + struct.pack(order + "HI", 42, 0))
        link, off_code, off_type, entry_size = 4, "I", 4, 12
    field = 8 if big else 4
    for page in pages:
        samples = np.asarray(page["samples"])
        if samples.ndim == 2:
            samples = samples[..., None]
        h, w, spp = samples.shape
        bits = page["bits"]
        comp = page.get("compression", 1)
        tile = page.get("tile")
        rps = page.get("rows_per_strip", h)
        ycbcr = page.get("ycbcr_subsampling")
        chunks = page.get("chunks") or _page_chunks(
            samples, bits, comp, page.get("predictor", 1), tile, rps, order,
            page.get("fill_order", 1), page.get("planar", False), ycbcr)
        offsets = []
        for c in chunks:
            if page.get("odd_offsets"):  # start each chunk at an odd offset
                out += b"\x00"
            offsets.append(len(out))
            out += c
            if len(out) % 2:
                out += b"\x00"
        tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
                259: (3, [comp]), 262: (3, [page["photometric"]]),
                277: (3, [spp]), 284: (3, [2 if page.get("planar") else 1])}
        if ycbcr and page.get("subsampling_tag", True):
            tags[530] = (3, list(ycbcr))
        if tile:
            tags.update({322: (3, [tile[0]]), 323: (3, [tile[1]]),
                         324: (off_type, offsets),
                         325: (4, [len(c) for c in chunks])})
        else:
            tags.update({273: (off_type, offsets), 278: (4, [rps]),
                         279: (4, [len(c) for c in chunks])})
        for tag, key, typ in ((274, "orientation", 3), (317, "predictor", 3),
                              (338, "extra_samples", 3),
                              (266, "fill_order", 3), (320, "colormap", 3)):
            if key in page:
                v = page[key]
                tags[tag] = (typ, list(v) if isinstance(v, (list, tuple,
                                                             np.ndarray))
                             else [v])
        for tag, v in page.get("tags", {}).items():
            tags[tag] = v if isinstance(v, tuple) else (3, [v])
        ifd_at = len(out)
        struct.pack_into(order + off_code, out, link, ifd_at)
        entries, blobs = [], bytearray()
        data_at = ifd_at + (8 if big else 2) + entry_size * len(tags) + field
        for tag in sorted(tags):
            typ, vals = tags[tag]
            if typ == 7:
                blob, count = bytes(vals), len(vals)
            else:
                flat = [int(x) for v in vals for x in
                        (v if isinstance(v, (tuple, list)) else (v,))]
                blob = struct.pack(order + _TYPES[typ][0] * len(flat), *flat)
                count = len(vals)
            if len(blob) <= field:
                value = blob.ljust(field, b"\x00")
            else:
                value = struct.pack(order + off_code, data_at + len(blobs))
                blobs += blob
                if len(blobs) % 2:
                    blobs += b"\x00"
            entries.append(struct.pack(order + "HH" + off_code, tag, typ,
                                       count) + value)
        out += struct.pack(order + ("Q" if big else "H"), len(tags))
        out += b"".join(entries)
        link = len(out)
        out += b"\x00" * field
        out += blobs
    if hasattr(path, "write"):
        path.write(bytes(out))
        return
    with open(path, "wb") as f:
        f.write(bytes(out))


def jpeg2000_tiff(h: int = 8, w: int = 8) -> bytes:
    """A TIFF whose compression is 34712 (JPEG 2000, which libtiff does not
    know: cv2 gives an all-zero page for it): the page read_image refuses
    by name. Its strip holds no real codestream."""
    buf = io.BytesIO()
    write_tiff(buf, [dict(samples=np.zeros((h, w, 3), np.uint8), bits=8,
                          photometric=2, tags={259: 34712})])
    return buf.getvalue()


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + \
        struct.pack(">I", zlib.crc32(tag + data))


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def write_adam7_png(path, samples: np.ndarray, color: int, depth: int,
                    palette: np.ndarray | None = None) -> None:
    """An Adam7-interlaced PNG of (h, w, channels) samples (the values a
    depth of ``depth`` bits holds), each pass's rows with filter type
    (y % 5): None, Sub, Up, Average, Paeth."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    stream = bytearray()
    for x0, y0, dx, dy in ADAM7:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        raw = _raw_rows(sub, depth, ">").astype(np.int64)
        prior = np.zeros(raw.shape[1], np.int64)
        for y, row in enumerate(raw):
            t = y % 5
            left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
            ul = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
            p = left + prior - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - ul)
            paeth = np.where((pa <= pb) & (pa <= pc), left,
                             np.where(pb <= pc, prior, ul))
            pred = {0: 0, 1: left, 2: prior, 3: (left + prior) // 2,
                    4: paeth}[t]
            stream += bytes([t]) + ((row - pred) % 256).astype(
                np.uint8).tobytes()
            prior = row
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                       1))
    if palette is not None:
        body += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    body += _chunk(b"IDAT", zlib.compress(bytes(stream)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IEND", b""))


def jpeg_scans(data: bytes) -> list[tuple[int, int, dict]]:
    """(start, end, header) of each scan of a JPEG: from its SOS marker to
    the next marker that is not a restart marker; header holds the scan's
    component ids and Ss, Se, Ah, Al."""
    scans, pos = [], 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF or data[pos + 1] in (0x00, 0xFF):
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xD9 or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        length = int.from_bytes(data[pos + 2: pos + 4], "big")
        if marker != 0xDA:
            pos += 2 + length
            continue
        ns = data[pos + 4]
        at = pos + 5 + 2 * ns
        header = {"components": [data[pos + 5 + 2 * i] for i in range(ns)],
                  "ss": data[at], "se": data[at + 1],
                  "ah": data[at + 2] >> 4, "al": data[at + 2] & 15}
        end = pos + 2 + length
        while end + 1 < len(data) and not (
                data[end] == 0xFF and data[end + 1] not in (0x00, 0xFF)
                and not 0xD0 <= data[end + 1] <= 0xD7):
            end += 1
        scans.append((pos, end, header))
        pos = end
    return scans


def drop_scans(data: bytes, drop) -> bytes:
    """A JPEG's bytes without the scans for which ``drop(index, header)``
    is true: a complete file whose scans leave bits unsent."""
    out, last = bytearray(), 0
    for i, (start, end, header) in enumerate(jpeg_scans(data)):
        if drop(i, header):
            out += data[last:start]
            last = end
    return bytes(out + data[last:])


def split_jpeg_tables(data: bytes) -> tuple[bytes, bytes]:
    """A JPEG's bytes -> (a tables-only stream: SOI, its DQT and DHT
    segments before the first scan, EOI; the abbreviated stream left
    without them), as a TIFF's JPEGTables tag and strips hold them."""
    tables, rest, pos = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while pos + 4 <= len(data):
        marker = data[pos + 1]
        length = int.from_bytes(data[pos + 2: pos + 4], "big")
        if marker == 0xDA:
            break
        segment = data[pos: pos + 2 + length]
        (tables if marker in (0xC4, 0xDB) else rest).extend(segment)
        pos += 2 + length
    return bytes(tables + b"\xff\xd9"), bytes(rest + data[pos:])


# ---------------------------------------------------------------------------
# JPEG variants cv2 and PIL do not write: lossless (T.81 Annex H), 12-bit
# DCT, arithmetic coding (Annex D)
# ---------------------------------------------------------------------------

def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def huffman_spec(freq: dict) -> tuple[list[int], list[int]]:
    """libjpeg's jpeg_gen_optimal_table (T.81 Annex K.2, K.3): symbol
    frequencies -> (BITS[1..16], HUFFVAL) of a code at most 16 bits long
    with no code of all ones."""
    f = {s: n for s, n in freq.items() if n}
    f[256] = 1  # the reserved symbol keeps every real code off all-ones
    size = {s: 0 for s in f}
    nxt = {s: None for s in f}
    live = dict(f)
    while len(live) > 1:
        # the two least frequent; on a tie the larger symbol first
        c1 = min(live, key=lambda s: (live[s], -s))
        v1 = live.pop(c1)
        c2 = min(live, key=lambda s: (live[s], -s))
        live[c1] = v1 + live.pop(c2)
        s = c1
        size[s] += 1
        while nxt[s] is not None:
            s = nxt[s]
            size[s] += 1
        nxt[s] = c2
        s = c2
        size[s] += 1
        while nxt[s] is not None:
            s = nxt[s]
            size[s] += 1
    bits = [0] * 33
    for s in f:
        bits[size[s]] += 1
    for i in range(32, 16, -1):  # K.3 Adjust_BITS
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the reserved symbol's code
    vals = sorted((s for s in f if s != 256), key=lambda s: (size[s], s))
    return bits[1:17], vals


def _huffman_codes(bits, vals) -> dict[int, tuple[int, int]]:
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _dht(tc: int, th: int, bits, vals) -> bytes:
    return _segment(0xC4, bytes([(tc << 4) | th, *bits, *vals]))


class _BitWriter:
    """Entropy-coded bits, MSB first, 0xFF stuffed, padded with ones."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, length: int) -> None:
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        data, self.out = bytes(self.out), bytearray()
        return data


def _category(v: int) -> int:
    return abs(int(v)).bit_length()


def _magnitude(v: int, s: int) -> int:
    return v if v >= 0 else v + (1 << s) - 1


def lossless_predict(rows: np.ndarray, predictor: int, precision: int,
                     pt: int, restart_rows: int = 0) -> np.ndarray:
    """T.81 H.1.2.1 over one component's (h, w) samples already shifted
    right by ``pt``: each sample's prediction, the first row of the image
    and of each restart interval predicted from the left (its first sample
    from 2**(P - Pt - 1)), the first column from above."""
    h, w = rows.shape
    x = rows.astype(np.int64)
    pred = np.zeros((h, w), np.int64)
    for y in range(h):
        first = y == 0 or (restart_rows and y % restart_rows == 0)
        if first:
            pred[y, 0] = 1 << (precision - pt - 1)
            pred[y, 1:] = x[y, :-1]
            continue
        ra, rb, rc = x[y, :-1], x[y - 1, 1:], x[y - 1, :-1]
        pred[y, 0] = x[y - 1, 0]
        pred[y, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                       5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                       7: (ra + rb) >> 1}[predictor]
    return pred


def jpeg_lossless(samples, precision: int = 8, predictor: int = 1,
                  pt: int = 0, restart_rows: int = 0, marker: int = 0xC3,
                  sampling=None, size=None, interleaved: bool = True
                  ) -> bytes:
    """A lossless JPEG (SOF3, Huffman; T.81 Annex H) of (h, w) or (h, w,
    nc) samples below 2**precision, every component sampled 1x1 and all
    in one interleaved scan; ``restart_rows`` puts a restart marker every
    that many rows. With ``sampling`` [(h, v), ...], ``samples`` is a list
    of component planes, each of its own size (ceil(W h / hmax) by
    ceil(H v / vmax) for the image ``size`` (H, W)), coded in one
    interleaved scan of hmax x vmax MCUs (``restart_rows`` counting MCU
    rows; the samples an MCU holds past a plane's edge coded as 0) or,
    without ``interleaved``, in one scan a component."""
    if sampling is None:
        s = np.asarray(samples)
        if s.ndim == 2:
            s = s[..., None]
        size = s.shape[:2]
        samples = [s[..., c] for c in range(s.shape[2])]
        sampling = [(1, 1)] * s.shape[2]
    h, w = size
    nc = len(samples)
    hmax = max(f[0] for f in sampling)
    vmax = max(f[1] for f in sampling)
    mcux, mcuy = -(-w // hmax), -(-h // vmax)
    if not interleaved:
        assert not restart_rows
    diffs = []
    for c in range(nc):
        x = np.asarray(samples[c]).astype(np.int64) >> pt
        rows = restart_rows * sampling[c][1]
        d = (x - lossless_predict(x, predictor, precision, pt, rows)) & 0xFFFF
        d = np.where(d >= 0x8000, d - 0x10000, d)
        if interleaved:  # padded to whole MCUs
            pad = np.zeros((mcuy * sampling[c][1], mcux * sampling[c][0]),
                           np.int64)
            pad[:d.shape[0], :d.shape[1]] = d
            d = pad
        diffs.append(d)
    cats = [np.where(d == -0x8000, 16, np.vectorize(_category)(d))
            for d in diffs]
    freq = {}
    for k in cats:
        for v, n in zip(*np.unique(k, return_counts=True)):
            freq[int(v)] = freq.get(int(v), 0) + int(n)
    bits, vals = huffman_spec(freq)
    codes = _huffman_codes(bits, vals)
    sof = struct.pack(">BHHB", precision, h, w, nc) + b"".join(
        bytes([c + 1, (sampling[c][0] << 4) | sampling[c][1], 0])
        for c in range(nc))
    out = bytearray(b"\xff\xd8" + _segment(marker, sof) + _dht(0, 0, bits,
                                                               vals))
    if restart_rows:
        out += _segment(0xDD, struct.pack(">H", restart_rows * mcux))

    def put(bw, c, y, x):
        v, k = int(diffs[c][y, x]), int(cats[c][y, x])
        bw.put(*codes[k])
        if 0 < k < 16:
            bw.put(_magnitude(v, k), k)

    for scan in ([list(range(nc))] if interleaved else
                 [[c] for c in range(nc)]):
        out += _segment(0xDA, bytes([len(scan)]) + b"".join(
            bytes([c + 1, 0]) for c in scan) + bytes([predictor, 0, pt]))
        bw = _BitWriter()
        if not interleaved:
            c = scan[0]
            for y in range(diffs[c].shape[0]):
                for x in range(diffs[c].shape[1]):
                    put(bw, c, y, x)
            out += bw.flush()
            continue
        for my in range(mcuy):
            if restart_rows and my and my % restart_rows == 0:
                out += bw.flush() + bytes([0xFF, 0xD0 + (my // restart_rows
                                                         - 1) % 8])
            for mx in range(mcux):
                for c in scan:
                    hc, vc = sampling[c]
                    for y in range(vc):
                        for x in range(hc):
                            put(bw, c, my * vc + y, mx * hc + x)
        out += bw.flush()
    return bytes(out + b"\xff\xd9")


def _sof_components(nc: int, ids, sampling) -> bytes:
    ids = ids or list(range(1, nc + 1))
    return b"".join(bytes([ids[c], (sampling[c][0] << 4) | sampling[c][1],
                           min(c, 1)]) for c in range(nc))


def _fdct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    return m


def _frame_size(planes, sampling, size=None):
    """The frame's (height, width): ``size``, or the planes' own."""
    if size is not None:
        return size
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    return (max(p.shape[0] * vmax // v for p, (_, v) in zip(planes,
                                                              sampling)),
            max(p.shape[1] * hmax // h for p, (h, _) in zip(planes,
                                                              sampling)))


def jpeg_dct_blocks(planes, sampling, qtables, precision: int, size=None):
    """Each component's (h, w) plane (already subsampled) -> its quantised
    DCT blocks, (block rows, block columns, 64) in zigzag order, the edge
    padded by repeating the last row and column to whole MCUs; ``size``
    the frame's (height, width)."""
    m = _fdct_matrix()
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    full_h, full_w = _frame_size(planes, sampling, size)
    mcux, mcuy = -(-full_w // (8 * hmax)), -(-full_h // (8 * vmax))
    zz = np.array(_ZIGZAG)
    out = []
    for plane, (h, v), q in zip(planes, sampling, qtables):
        bh, bw = mcuy * v, mcux * h
        rows = np.minimum(np.arange(bh * 8), plane.shape[0] - 1)
        cols = np.minimum(np.arange(bw * 8), plane.shape[1] - 1)
        x = plane.astype(np.float64)[rows][:, cols] - (1 << (precision - 1))
        blocks = x.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ij,abjk,lk->abil", m, blocks, m).reshape(bh, bw,
                                                                   64)
        qn = np.asarray(q, np.float64).reshape(64)
        out.append(np.round(coef / qn).astype(np.int64)[..., zz])
    return out, mcux, mcuy


# zigzag position -> natural (row-major) index
_ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
           26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
           56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
           45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)

# T.81 Table K.1, luminance
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103,
    99]).reshape(8, 8)


def _mcu_blocks(coefs, sampling, mcux, mcuy):
    """(component, block) pairs of every MCU in order, interleaved."""
    for my in range(mcuy):
        for mx in range(mcux):
            yield [(c, coefs[c][my * v + j, mx * h + i])
                   for c, (h, v) in enumerate(sampling)
                   for j in range(v) for i in range(h)]


def jpeg_dct(planes, precision: int = 8, sampling=None, ids=None,
             qscale: float = 1.0, marker: int = 0xC1,
             adobe: int | None = None) -> bytes:
    """A sequential Huffman-coded DCT JPEG (SOF0/SOF1, one interleaved
    scan, optimal tables) of component planes, each (h, w) below
    2**precision and already subsampled by ``sampling`` [(h, v), ...];
    quantisation tables of 16-bit entries (Pq 1) at 12 bits: T.81's
    luminance table times ``qscale`` (times 16 at 12 bits)."""
    nc = len(planes)
    sampling = sampling or [(1, 1)] * nc
    scale = qscale * (16 if precision == 12 else 1)
    q = np.clip(np.round(_LUMA_Q * scale), 1, 65535 if precision == 12
                else 255).astype(np.int64)
    coefs, mcux, mcuy = jpeg_dct_blocks(planes, sampling, [q] * nc,
                                        precision)
    syms = [[], []]  # (component, kind, symbol, value, size) in order
    stream = []
    last = [0] * nc
    for mcu in _mcu_blocks(coefs, sampling, mcux, mcuy):
        for c, blk in mcu:
            d = int(blk[0]) - last[c]
            last[c] = int(blk[0])
            s = _category(d)
            stream.append((0, c, s, d, s))
            run = 0
            nz = np.nonzero(blk[1:])[0]
            end = nz[-1] + 1 if nz.size else 0
            for k in range(1, end + 1):
                v = int(blk[k])
                if v == 0:
                    run += 1
                    continue
                while run > 15:
                    stream.append((1, c, 0xF0, 0, 0))
                    run -= 16
                s = _category(v)
                stream.append((1, c, (run << 4) | s, v, s))
                run = 0
            if end < 63:
                stream.append((1, c, 0, 0, 0))
    for kind, c, sym, _, _ in stream:
        syms[kind].append(sym)
    tables = [huffman_spec({int(k): int(n) for k, n in zip(
        *np.unique(np.array(s), return_counts=True))}) for s in syms]
    codes = [_huffman_codes(*t) for t in tables]
    qbytes = b"".join(struct.pack(">H", int(v)) for v in q.reshape(64)[
        list(_ZIGZAG)]) if precision == 12 else bytes(
            int(v) for v in q.reshape(64)[list(_ZIGZAG)])
    h_full = max(p.shape[0] * max(v for _, v in sampling) // v
                 for p, (_, v) in zip(planes, sampling))
    w_full = max(p.shape[1] * max(h for h, _ in sampling) // h
                 for p, (h, _) in zip(planes, sampling))
    out = bytearray(b"\xff\xd8")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe]))
    out += _segment(0xDB, bytes([(1 if precision == 12 else 0) << 4])
                    + qbytes)
    out += _segment(marker, struct.pack(">BHHB", precision, h_full, w_full,
                                        nc) + _sof_components(nc, ids,
                                                              sampling))
    out += _dht(0, 0, *tables[0]) + _dht(1, 0, *tables[1])
    out += _segment(0xDA, bytes([nc]) + b"".join(
        bytes([(ids or range(1, nc + 1))[c], 0]) for c in range(nc))
        + bytes([0, 63, 0]))
    bw = _BitWriter()
    for kind, c, sym, v, s in stream:
        bw.put(*codes[kind][sym])
        if s:
            bw.put(_magnitude(v, s), s)
    return bytes(out + bw.flush() + b"\xff\xd9")


# ---------------------------------------------------------------------------
# libtiff's other codecs: old-style LZW, NeXT, ThunderScan, CCITT RLE-W
# and SGI LogL/LogLuv
# ---------------------------------------------------------------------------

def old_style_lzw(data: bytes) -> bytes:
    """Old-style (pre-TIFF 6) LZW as libtiff's LZWDecodeCompat reads it:
    codes LSB first, the width rising once the decoder's next entry passes
    511, 1023 and 2047 (not one code early), a clear code first and
    whenever the table would pass 4093 entries, then the end code."""
    out = bytearray()
    acc = nbits = 0
    width = 9
    dec_free = 258  # the entry the decoder makes next

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    table = {bytes([i]): i for i in range(256)}
    emit(256)
    first = True
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        if not first:
            dec_free += 1
            if dec_free > (1 << width) - 1 and width < 12:
                width += 1
        first = False
        table[wc] = len(table) + 2
        w = bytes([c])
        if len(table) + 2 >= 4093:
            emit(table[w])
            dec_free += 1
            if dec_free > (1 << width) - 1 and width < 12:
                width += 1
            emit(256)
            table = {bytes([i]): i for i in range(256)}
            width, dec_free, first, w = 9, 258, True, b""
    if w:
        emit(table[w])
        if not first:
            dec_free += 1
            if dec_free > (1 << width) - 1 and width < 12:
                width += 1
    emit(257)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def next_2bit(samples: np.ndarray) -> bytes:
    """NeXT 2-bit RLE (compression 32766) of (h, w) 2-bit samples, the
    rows cycling through the codec's three row forms: a literal row, a
    literal span over white (3), and runs of one grey (<grey><count>)."""
    h, w = samples.shape
    rows = _raw_rows(samples[..., None], 2, ">")
    out = bytearray()
    for y in range(h):
        kind = y % 3
        if kind == 0:
            out += b"\x00" + rows[y].tobytes()
        elif kind == 1:
            on = np.nonzero(samples[y] != 3)[0]
            lo = int(on[0]) // 4 if on.size else 0
            hi = int(on[-1]) // 4 + 1 if on.size else 0
            out += b"\x40" + struct.pack(">HH", lo, hi - lo) + rows[y][
                lo:hi].tobytes()
        else:
            x = 0
            while x < w:
                v = int(samples[y, x])
                n = 1
                while x + n < w and n < 63 and samples[y, x + n] == v:
                    n += 1
                out.append((v << 6) | n)
                x += n
    return bytes(out)


def next_rows_white_first(samples: np.ndarray) -> np.ndarray:
    """What NeXT rows written by next_2bit decode to: the literal-span
    rows keep white outside their span."""
    out = samples.copy()
    for y in range(1, out.shape[0], 3):
        on = np.nonzero(samples[y] != 3)[0]
        if on.size:
            lo, hi = on[0] // 4 * 4, (on[-1] // 4 + 1) * 4
            out[y, :lo] = 3
            out[y, hi:] = 3
    return out


def thunderscan(samples: np.ndarray) -> bytes:
    """ThunderScan 4-bit (compression 32809) of (h, w) 4-bit samples, each
    row coded on its own with raw pixels, runs of the last pixel, and
    2- and 3-bit deltas where they fit."""
    out = bytearray()
    d2 = {0: 0, 1: 1, -1: 3}
    d3 = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    for row in samples.astype(int):
        last, x, w = 0, 0, len(row)
        while x < w:
            n = 0
            while x + n < w and n < 63 and row[x + n] == last:
                n += 1
            if n >= 2:
                out.append(n)
                x += n
                continue
            if x + 2 < w and all(row[x + k] - row[x + k - 1] in d2 if k
                                 else row[x] - last in d2 for k in range(3)):
                a, b, c = row[x] - last, row[x + 1] - row[x], \
                    row[x + 2] - row[x + 1]
                out.append(0x40 | (d2[a] << 4) | (d2[b] << 2) | d2[c])
                last = row[x + 2]
                x += 3
                continue
            if x + 1 < w and row[x] - last in d3 and \
                    row[x + 1] - row[x] in d3:
                out.append(0x80 | (d3[row[x] - last] << 3)
                           | d3[row[x + 1] - row[x]])
                last = row[x + 1]
                x += 2
                continue
            out.append(0xC0 | row[x])
            last = row[x]
            x += 1
    return bytes(out)


# T.4 make-up codes (64..1728), white and black
_FAX_MAKEUP_WHITE = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 "
    "011011011 010011000 010011001 010011010 011000 010011011").split()
_FAX_MAKEUP_BLACK = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101").split()


def _fax_run(run: int, black: bool) -> str:
    term = _FAX_BLACK if black else _FAX_WHITE
    makeup = _FAX_MAKEUP_BLACK if black else _FAX_MAKEUP_WHITE
    bits = ""
    while run >= 64:
        k = min(run // 64, 27)
        bits += makeup[k - 1]
        run -= 64 * k
    return bits + term[run]


def modified_huffman(ink: np.ndarray, align: int = 8) -> bytes:
    """CCITT modified Huffman of (h, w) bools (True = black): each row's
    runs from white, with no EOL, padded to ``align`` bits (8: compression
    2; 16: RLE-W, 32771, rows on 16-bit words of the strip)."""
    s = ""
    for row in ink:
        x, black = 0, False
        changes = _changes(row) + [len(row)]
        for c in changes:
            s += _fax_run(c - x, black)
            x, black = c, not black
        s += "0" * (-len(s) % align)
    return bytes(int(s[i: i + 8], 2) for i in range(0, len(s), 8))


def _logl16(y: np.ndarray) -> np.ndarray:
    """tif_luv.c LogL16fromY, rounding (SGILOGENCODE_NODITHER)."""
    le = np.floor(256.0 * (np.log2(np.maximum(y, 1e-30)) + 64.0) + 0.5)
    le = np.clip(le, 0, 0x7FFF).astype(np.int64)
    return np.where(y <= 1.8371976e-19, 0, np.where(y >= 1.8376e19, 0x7FFF,
                                                     le))


def _sgilog_bytes(words: np.ndarray, nbytes: int) -> bytes:
    """tif_luv.c's run-length coding of one row of ``nbytes``-byte words:
    each byte plane, most significant first, as runs (128 + n - 2, byte)
    of at least 4 and literals (n, bytes...)."""
    out = bytearray()
    for shift in range(8 * (nbytes - 1), -1, -8):
        plane = [(int(v) >> shift) & 0xFF for v in words]
        i = 0
        while i < len(plane):
            j = i
            while j < len(plane) and plane[j] == plane[i] and j - i < 129:
                j += 1
            if j - i >= 4:
                out += bytes([128 + (j - i) - 2, plane[i]])
                i = j
                continue
            k = i
            while k < len(plane) and k - i < 127:
                m = k
                while m < len(plane) and plane[m] == plane[k] and m - k < 4:
                    m += 1
                if m - k >= 4:
                    break
                k += 1
            out += bytes([k - i]) + bytes(plane[i:k])
            i = k
    return bytes(out)


def sgilog(samples: np.ndarray, luv: bool) -> list[bytes]:
    """SGI LogL (``luv`` False: (h, w) luminance Y, compression 34676 over
    photometric 32844) or LogLuv 32-bit ((h, w, 3) X, Y, Z; photometric
    32845) strips, one row each, coded as tif_luv.c codes them (rounding,
    no dither)."""
    if not luv:
        return [_sgilog_bytes(_logl16(row), 2) for row in samples]
    strips = []
    for row in samples:
        x, y, z = row[..., 0], row[..., 1], row[..., 2]
        le = _logl16(y)
        s = x + 15.0 * y + 3.0 * z
        ok = (le > 0) & (s > 0)
        u = np.where(ok, 4.0 * x / np.where(ok, s, 1), 4.0 / 19)
        v = np.where(ok, 9.0 * y / np.where(ok, s, 1), 9.0 / 19)
        ue = np.clip(np.floor(410 * u + 0.5), 0, 255).astype(np.int64)
        ve = np.clip(np.floor(410 * v + 0.5), 0, 255).astype(np.int64)
        strips.append(_sgilog_bytes((le << 16) | (ue << 8) | ve, 4))
    return strips


def sgilog24(codes: np.ndarray) -> list[bytes]:
    """SGI LogLuv 24-bit strips (compression 34677, photometric 32845),
    one row each, of (h, w) 24-bit codes: a 10-bit log luminance over a
    14-bit (u', v') cell index, three bytes a pixel, most significant
    first (tif_luv.c LogLuvEncode24 writes them uncoded)."""
    c = np.asarray(codes, np.uint32)
    b = np.stack([(c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF], -1)
    return [row.astype(np.uint8).tobytes() for row in b]


# jcarith.c's Qe table (T.81 Table D.2): (Qe, Next_Index_LPS,
# Next_Index_MPS, Switch_MPS); entry 113 is the fixed 0.5 estimate
_QE = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))


class QMCoder:
    """T.81 Annex D's arithmetic (QM) encoder as libjpeg's jcarith.c
    writes it: a statistics bin is a one-element list [index | MPS << 7],
    bytes are stacked for carries, and 0xFF bytes are stuffed."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = \
            0, 0x10000, 0, 0, 11, -1

    def _emit(self, v):
        self.out.append(v)

    def _flush_zeros(self):
        self.out += b"\x00" * self.zc
        self.zc = 0

    def encode(self, st: list, val: int) -> None:
        sv = st[0]
        qe, nlps, nmps, switch = _QE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[0] = (sv & 0x80) ^ (nlps | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[0] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._flush_zeros()
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        """jcarith.c finish_pass: the shortest tail that decodes, trailing
        zero bytes left out (the decoder reads zeros past a marker)."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)
        data, self.out = bytes(self.out), bytearray()
        self.reset()
        return data


class _ArithStats:
    """The statistics bins of one scan (jcarith.c start_pass)."""

    def __init__(self, dac):
        self.dac = dac
        self.fixed = [113]
        self.reset()

    def reset(self):
        self.dc = {t: [[0] for _ in range(64)] for t in range(16)}
        self.ac = {t: [[0] for _ in range(256)] for t in range(16)}


def _arith_value(q, stats, base, v, ac, x1):
    """Figures F.8 and F.9: a nonzero value's magnitude category and bits
    (its sign already coded); base is the bin of the first decision."""
    st = base
    m = 0
    v -= 1
    if v:
        q.encode(stats[st], 1)
        m = 1
        v2 = v
        if not ac:
            st = x1
            while v2 >> 1:
                v2 >>= 1
                q.encode(stats[st], 1)
                m <<= 1
                st += 1
        elif v2 >> 1:
            v2 >>= 1
            q.encode(stats[st], 1)
            m <<= 1
            st = x1
            while v2 >> 1:
                v2 >>= 1
                q.encode(stats[st], 1)
                m <<= 1
                st += 1
    q.encode(stats[st], 0)
    return st, m, v


def _arith_dc(q, s, tbl, ctx, ci, diff):
    """Figures F.4-F.9 for one DC difference; updates the context."""
    st = s.dc[tbl]
    base = ctx[ci]
    if diff == 0:
        q.encode(st[base], 0)
        ctx[ci] = 0
        return
    q.encode(st[base], 1)
    if diff > 0:
        q.encode(st[base + 1], 0)
        first, ctx[ci] = base + 2, 4
    else:
        diff = -diff
        q.encode(st[base + 1], 1)
        first, ctx[ci] = base + 3, 8
    last, m, v = _arith_value(q, st, first, diff, False, 20)
    lo, hi = s.dac.get(("L", tbl), 0), s.dac.get(("U", tbl), 1)
    if m < (1 << lo) >> 1:
        ctx[ci] = 0
    elif m > (1 << hi) >> 1:
        ctx[ci] += 8
    last += 14
    while m >> 1:
        m >>= 1
        q.encode(st[last], 1 if m & v else 0)


def _arith_ac_value(q, s, tbl, k, v):
    """A nonzero AC value at k (its EOB and zero-run decisions coded)."""
    st = s.ac[tbl]
    base = 3 * (k - 1)
    q.encode(st[base + 1], 1)
    q.encode(s.fixed, 1 if v < 0 else 0)
    x1 = 189 if k <= s.dac.get(("K", tbl), 5) else 217
    last, m, a = _arith_value(q, st, base + 2, abs(v), True, x1)
    last += 14
    while m >> 1:
        m >>= 1
        q.encode(st[last], 1 if m & a else 0)


def _tdiv(v: int, al: int) -> int:
    """An AC coefficient's point transform: divided, rounded to zero."""
    return v >> al if v >= 0 else -((-v) >> al)


def jpeg_arith(planes, sampling=None, progressive: bool = False,
               restart: int = 0, dac=None, ids=None, qscale: float = 1.0,
               adobe: int | None = None, script=None, size=None) -> bytes:
    """An arithmetic-coded DCT JPEG (T.81 Annex D; libjpeg's jcarith.c):
    SOF9 sequential in one interleaved scan, or SOF10 progressive with
    successive approximation (libjpeg's default script for 1 or 3
    components, or ``script``: (component indices, Ss, Se, Ah, Al) per
    scan). ``dac`` {("L"|"U"|"K", table): value} writes a DAC segment;
    ``restart`` puts a restart marker every that many MCUs."""
    nc = len(planes)
    sampling = sampling or [(1, 1)] * nc
    q8 = np.clip(np.round(_LUMA_Q * qscale), 1, 255).astype(np.int64)
    coefs, mcux, mcuy = jpeg_dct_blocks(planes, sampling, [q8] * nc, 8,
                                        size)
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    height, width = _frame_size(planes, sampling, size)
    dac = dac or {}
    ids = ids or list(range(1, nc + 1))
    if script is None:
        if not progressive:
            script = [(list(range(nc)), 0, 63, 0, 0)]
        elif nc == 1:
            script = [([0], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([0], 6, 63, 0, 2),
                      ([0], 1, 63, 2, 1), ([0], 0, 0, 1, 0),
                      ([0], 1, 63, 1, 0)]
        else:
            script = [(list(range(nc)), 0, 0, 0, 1), ([0], 1, 5, 0, 2),
                      ([2], 1, 63, 0, 1), ([1], 1, 63, 0, 1),
                      ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1),
                      (list(range(nc)), 0, 0, 1, 0), ([2], 1, 63, 1, 0),
                      ([1], 1, 63, 1, 0), ([0], 1, 63, 1, 0)]
    out = bytearray(b"\xff\xd8")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe]))
    out += _segment(0xDB, bytes([0]) + bytes(int(v) for v in q8.reshape(64)[
        list(_ZIGZAG)]))
    out += _segment(0xCA if progressive else 0xC9, struct.pack(
        ">BHHB", 8, height, width, nc) + b"".join(
            bytes([ids[c], (sampling[c][0] << 4) | sampling[c][1], 0])
            for c in range(nc)))
    if dac:
        tables = sorted({t for _, t in dac})
        out += _segment(0xCC, b"".join(
            bytes([t, (dac.get(("U", t), 1) << 4) | dac.get(("L", t), 0)])
            for t in tables if ("L", t) in dac or ("U", t) in dac)
            + b"".join(bytes([16 + t, dac[("K", t)]]) for t in tables
                       if ("K", t) in dac))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    for comps, ss, se, ah, al in script:
        q = QMCoder()
        s = _ArithStats(dac)
        ns = len(comps)
        out += _segment(0xDA, bytes([ns]) + b"".join(
            bytes([ids[c], 0]) for c in comps) + bytes([ss, se,
                                                        (ah << 4) | al]))
        last = [0] * ns
        ctx = [0] * ns
        if ns == 1:  # non-interleaved: the component's own blocks
            c = comps[0]
            h, v = sampling[c]
            cw = -(-(-(-width * h // hmax)) // 8)
            ch = -(-(-(-height * v // vmax)) // 8)
            units = [[(0, coefs[c][by, bx])] for by in range(ch)
                     for bx in range(cw)]
        else:
            units = [[(comps.index(c), blk) for c, blk in mcu if c in comps]
                     for mcu in _mcu_blocks(coefs, sampling, mcux, mcuy)]
        rst = 0
        for n, unit in enumerate(units):
            if restart and n and n % restart == 0:
                out += q.finish() + bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                s.reset()
                last = [0] * ns
                ctx = [0] * ns
            for ci, blk in unit:
                blk = [int(x) for x in blk]
                if ss == 0 and ah == 0:  # DC first, or sequential
                    dcv = blk[0] >> al
                    _arith_dc(q, s, 0, ctx, ci, dcv - last[ci])
                    last[ci] = dcv
                elif ss == 0:  # DC refinement
                    q.encode(s.fixed, (blk[0] >> al) & 1)
                if not progressive:
                    ss, se = 1, 63
                if ss == 0:
                    continue
                vals = [_tdiv(blk[k], al) for k in range(64)]
                ke = se
                while ke >= ss and vals[ke] == 0:
                    ke -= 1
                kex = ss - 1
                if ah:
                    kex = se
                    while kex >= ss and _tdiv(blk[kex], ah) == 0:
                        kex -= 1
                k = ss
                st = s.ac[0]
                while k <= ke:
                    if not ah or k > kex:
                        q.encode(st[3 * (k - 1)], 0)  # not EOB
                    while True:
                        v = vals[k]
                        if v:
                            if ah and abs(v) >> 1:  # previously nonzero
                                q.encode(st[3 * (k - 1) + 2], abs(v) & 1)
                            elif ah:  # newly nonzero
                                q.encode(st[3 * (k - 1) + 1], 1)
                                q.encode(s.fixed, 1 if v < 0 else 0)
                            else:
                                _arith_ac_value(q, s, 0, k, v)
                            break
                        q.encode(st[3 * (k - 1) + 1], 0)
                        k += 1
                    k += 1
                if k <= se:
                    q.encode(st[3 * (k - 1)], 1)  # EOB
                if not progressive:
                    ss, se = 0, 63
        out += q.finish()
    return bytes(out + b"\xff\xd9")


# ---------------------------------------------------------------------------
# JPEG 2000: JP2 boxes, and OpenJPEG's encoder through ctypes
# ---------------------------------------------------------------------------

JP2_SIGNATURE_BOX = b"\x00\x00\x00\x0cjP  \r\n\x87\n"


def jp2_box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def jp2_file(codestream: bytes, h: int, w: int, nc: int, colr=("enum", 16),
             pclr=None, cmap=None, cdef=None, bpc: int = 7) -> bytes:
    """A JP2 file around ``codestream``: the signature and ftyp boxes, jp2h
    (ihdr; colr as ("enum", EnumCS) or ("icc", profile), or none; pclr as
    (entries (n, channels), [B_i bytes]); cmap as [(cmp, mtyp, pcol)]; cdef
    as [(cn, typ, asoc)]) and jp2c."""
    body = jp2_box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    if colr is not None:
        body += jp2_box(b"colr", struct.pack(">BBBI", 1, 0, 0, colr[1])
                        if colr[0] == "enum" else
                        struct.pack(">BBB", 2, 0, 0) + colr[1])
    if pclr is not None:
        entries, sizes = pclr
        payload = struct.pack(">HB", *entries.shape) + bytes(sizes)
        for row in entries:
            for v, s in zip(row, sizes):
                payload += int(v).to_bytes(((s & 0x7F) + 8) // 8, "big")
        body += jp2_box(b"pclr", payload)
    if cmap is not None:
        body += jp2_box(b"cmap", b"".join(struct.pack(">HBB", *e)
                                          for e in cmap))
    if cdef is not None:
        body += jp2_box(b"cdef", struct.pack(">H", len(cdef)) + b"".join(
            struct.pack(">HHH", *e) for e in cdef))
    return (JP2_SIGNATURE_BOX + jp2_box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + jp2_box(b"jp2h", body) + jp2_box(b"jp2c", codestream))


def _openjpeg():
    """Pillow's bundled libopenjp2 with the encoder's structs declared
    (openjpeg.h 2.5: opj_cparameters_t, opj_image_t); the layout is checked
    against opj_set_default_encoder_parameters' defaults here and by a
    lossless round trip through cv2 in the tests."""
    import ctypes
    import glob
    import os

    import PIL

    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        PIL.__file__)), "pillow.libs", "libopenjp2-*.so*"))
    lib = ctypes.CDLL(libs[0])
    i32, u32 = ctypes.c_int, ctypes.c_uint32

    class Poc(ctypes.Structure):
        _fields_ = [(n, u32) for n in (
            "resno0", "compno0", "layno1", "resno1", "compno1", "layno0",
            "precno0", "precno1")] + [
            ("prg1", i32), ("prg", i32), ("progorder", ctypes.c_char * 5),
            ("tile", u32), ("tx0", i32), ("tx1", i32), ("ty0", i32),
            ("ty1", i32)] + [(n, u32) for n in (
                "layS resS compS prcS layE resE compE prcE txS txE tyS tyE "
                "dx dy lay_t res_t comp_t prc_t tx0_t ty0_t").split()]

    class Params(ctypes.Structure):
        _fields_ = [(n, i32) for n in (
            "tile_size_on", "cp_tx0", "cp_ty0", "cp_tdx", "cp_tdy",
            "cp_disto_alloc", "cp_fixed_alloc", "cp_fixed_quality")] + [
            ("cp_matrice", ctypes.c_void_p), ("cp_comment", ctypes.c_char_p),
            ("csty", i32), ("prog_order", i32), ("POC", Poc * 32),
            ("numpocs", u32), ("tcp_numlayers", i32),
            ("tcp_rates", ctypes.c_float * 100),
            ("tcp_distoratio", ctypes.c_float * 100)] + [(n, i32) for n in (
                "numresolution", "cblockw_init", "cblockh_init", "mode",
                "irreversible", "roi_compno", "roi_shift", "res_spec")] + [
            ("prcw_init", i32 * 33), ("prch_init", i32 * 33),
            ("infile", ctypes.c_char * 4096),
            ("outfile", ctypes.c_char * 4096), ("index_on", i32),
            ("index", ctypes.c_char * 4096)] + [(n, i32) for n in (
                "image_offset_x0", "image_offset_y0", "subsampling_dx",
                "subsampling_dy", "decod_format", "cod_format",
                "jpwl_epc_on", "jpwl_hprot_MH")] + [
            ("jpwl_hprot_TPH_tileno", i32 * 16), ("jpwl_hprot_TPH", i32 * 16),
            ("jpwl_pprot_tileno", i32 * 16), ("jpwl_pprot_packno", i32 * 16),
            ("jpwl_pprot", i32 * 16)] + [(n, i32) for n in (
                "jpwl_sens_size", "jpwl_sens_addr", "jpwl_sens_range",
                "jpwl_sens_MH")] + [
            ("jpwl_sens_TPH_tileno", i32 * 16), ("jpwl_sens_TPH", i32 * 16),
            ("cp_cinema", i32), ("max_comp_size", i32), ("cp_rsiz", i32),
            ("tp_on", ctypes.c_char), ("tp_flag", ctypes.c_char),
            ("tcp_mct", ctypes.c_char), ("jpip_on", i32),
            ("mct_data", ctypes.c_void_p), ("max_cs_size", i32),
            ("rsiz", ctypes.c_uint16)]

    class CompParm(ctypes.Structure):
        _fields_ = [(n, u32) for n in "dx dy w h x0 y0 prec bpp sgnd".split()]

    class Comp(ctypes.Structure):
        _fields_ = [(n, u32) for n in (
            "dx dy w h x0 y0 prec bpp sgnd resno_decoded factor".split())] + [
            ("data", ctypes.POINTER(ctypes.c_int32)),
            ("alpha", ctypes.c_uint16)]

    class Image(ctypes.Structure):
        _fields_ = [("x0", u32), ("y0", u32), ("x1", u32), ("y1", u32),
                    ("numcomps", u32), ("color_space", i32),
                    ("comps", ctypes.POINTER(Comp)),
                    ("icc_profile_buf", ctypes.c_void_p),
                    ("icc_profile_len", u32)]

    lib.opj_image_create.restype = ctypes.POINTER(Image)
    lib.opj_create_compress.restype = ctypes.c_void_p
    lib.opj_stream_create_default_file_stream.restype = ctypes.c_void_p
    defaults = Params()
    lib.opj_set_default_encoder_parameters(ctypes.byref(defaults))
    assert (defaults.numresolution, defaults.cblockw_init,
            defaults.cblockh_init, defaults.roi_compno,
            defaults.subsampling_dx, defaults.decod_format,
            defaults.cod_format) == (6, 64, 64, -1, 1, -1, -1), \
        "opj_cparameters_t layout"
    return lib, Params, CompParm, Image


def openjpeg_encode(samples: np.ndarray, prec: int = 8, sgnd: bool = False,
                    jp2: bool = False, color_space: int = 1,
                    subsampling: int = 1, offset=(0, 0), extra=(),
                    **params) -> bytes:
    """Encode (h, w) or (h, w, c) integer samples with OpenJPEG's encoder
    (Pillow's libopenjp2): a raw codestream, or a JP2 file when ``jp2``
    (``color_space``: 1 sRGB, 2 gray, 3 sYCC). ``params`` set
    opj_cparameters_t fields by name (``mode``: the code-block style bits,
    ``csty``: 2 SOP, 4 EPH, ``tp_on``/``tp_flag``: tile-parts, ``roi_*``,
    ...), plus ``rates`` (the layers' compression ratios; lossless: [0]),
    ``tile`` (w, h), ``precincts`` [(log2 w, log2 h)] per resolution,
    ``pocs`` [(tile, resno0, compno0, layno1, resno1, compno1, order)];
    ``subsampling`` subsamples every component but the first; ``offset``
    (x, y) moves the image on the reference grid; ``extra``:
    opj_encoder_set_extra_options strings ("PLT=YES", "TLM=YES")."""
    import ctypes
    import os
    import tempfile

    lib, Params, CompParm, Image = _openjpeg()
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    parms = (CompParm * c)()
    for i in range(c):
        d = subsampling if i else 1
        parms[i].dx = parms[i].dy = d
        parms[i].w, parms[i].h = -(-w // d), -(-h // d)
        parms[i].x0, parms[i].y0 = offset
        parms[i].prec, parms[i].sgnd = prec, int(sgnd)
    image = lib.opj_image_create(c, parms, color_space)
    im = image.contents
    im.x0, im.y0 = offset
    im.x1, im.y1 = offset[0] + w, offset[1] + h
    for i in range(c):
        d = subsampling if i else 1
        plane = np.ascontiguousarray(samples[::d, ::d, i], np.int32)
        ctypes.memmove(im.comps[i].data, plane.ctypes.data, plane.nbytes)
    p = Params()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    p.tcp_numlayers, p.cp_disto_alloc = 1, 1
    p.tcp_mct = bytes([1 if c >= 3 and subsampling == 1 else 0])
    for key, value in params.items():
        if key == "rates":
            p.tcp_numlayers = len(value)
            for i, r in enumerate(value):
                p.tcp_rates[i] = r
        elif key == "tile":
            p.tile_size_on = 1
            p.cp_tdx, p.cp_tdy = value
        elif key == "precincts":
            p.res_spec = len(value)
            p.csty |= 1
            for i, (pw, ph) in enumerate(value):
                p.prcw_init[i], p.prch_init[i] = 1 << pw, 1 << ph
        elif key == "pocs":
            for i, (t, r0, c0, l1, r1, c1, prg) in enumerate(value):
                q = p.POC[i]
                q.tile, q.resno0, q.compno0, q.layno1 = t, r0, c0, l1
                q.resno1, q.compno1, q.prg1, q.prg = r1, c1, prg, prg
            p.numpocs = len(value)
        elif key in ("tp_on", "tp_flag", "tcp_mct"):
            setattr(p, key, value if isinstance(value, bytes)
                    else bytes([value]))
        else:
            setattr(p, key, value)
    codec = ctypes.c_void_p(lib.opj_create_compress(2 if jp2 else 0))
    fd, name = tempfile.mkstemp(suffix=".jp2" if jp2 else ".j2k")
    os.close(fd)
    try:
        ok = lib.opj_setup_encoder(codec, ctypes.byref(p), image)
        if ok and extra:
            opts = (ctypes.c_char_p * (len(extra) + 1))(
                *[e.encode() for e in extra], None)
            ok = lib.opj_encoder_set_extra_options(codec, opts)
        stream = ctypes.c_void_p(lib.opj_stream_create_default_file_stream(
            name.encode(), 0))
        ok = ok and lib.opj_start_compress(codec, image, stream) and \
            lib.opj_encode(codec, stream) and \
            lib.opj_end_compress(codec, stream)
        lib.opj_stream_destroy(stream)
        data = Path(name).read_bytes()
    finally:
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)
        os.unlink(name)
    if not ok:
        raise ValueError("OpenJPEG's encoder refused the parameters")
    return data


def j2k_packed_headers(codestream: bytes, where: str = "ppt") -> bytes:
    """A single-tile-part codestream encoded with SOP and EPH markers, its
    packet headers moved out of the packets: into PPT markers of the
    tile-part header (``where`` "ppt") or PPM markers of the main header
    ("ppm"). Each header ends at its EPH marker (moved with it); the SOP
    markers and bodies stay in the tile's data."""
    sot = codestream.index(b"\xff\x90")
    psot, = struct.unpack_from(">I", codestream, sot + 6)
    sod = codestream.index(b"\xff\x93", sot)
    end = sot + psot if psot else len(codestream) - 2
    data = codestream[sod + 2: end]
    headers, bodies, pos = bytearray(), bytearray(), 0
    while pos < len(data):
        assert data[pos: pos + 2] == b"\xff\x91", "expected SOP"
        eph = data.index(b"\xff\x92", pos + 6) + 2
        nxt = data.find(b"\xff\x91", eph)
        nxt = len(data) if nxt < 0 else nxt
        headers += data[pos + 6: eph]
        bodies += data[pos: pos + 6] + data[eph: nxt]
        pos = nxt

    def segments(marker: int, blob: bytes, prefix) -> bytes:
        out, z = bytearray(), 0
        for i in range(0, len(blob), 60000):
            part = prefix(z) + blob[i: i + 60000]
            out += struct.pack(">HH", marker, 2 + len(part)) + part
            z += 1
        return bytes(out)

    tile_header = codestream[sot + 12: sod]
    if where == "ppt":
        tile_header += segments(0xFF61, bytes(headers), lambda z: bytes([z]))
        main = codestream[:sot]
    else:
        ppm = struct.pack(">I", len(headers)) + bytes(headers)
        main = codestream[:sot] + segments(0xFF60, ppm, lambda z: bytes([z]))
    part = tile_header + b"\xff\x93" + bytes(bodies)
    sot_seg = codestream[sot: sot + 6] + struct.pack(
        ">I", 12 + len(part)) + codestream[sot + 10: sot + 12]
    return main + sot_seg + part + b"\xff\xd9"


def j2k_segment(marker: int, payload: bytes) -> bytes:
    """A codestream marker segment: the marker, its length, the payload."""
    return struct.pack(">HH", marker, 2 + len(payload)) + payload


def j2k_mct(index: int, values, etype: int = 1, array: int = 2) -> bytes:
    """A Part 2 MCT marker segment (one record, Zmct = Ymct = 0): array
    ``array`` (1 decorrelation, 2 offset) of ``values`` as elements of type
    ``etype`` (0 int16, 1 int32, 2 float32, 3 float64)."""
    fmt = ">" + "hifd"[etype]
    data = b"".join(struct.pack(fmt, v) for v in values)
    return j2k_segment(0xFF74, struct.pack(
        ">HHH", 0, (etype << 10) | (array << 8) | index, 0) + data)


def j2k_mcc(index: int, comps: int, offset: int = 0, deco: int = 0
            ) -> bytes:
    """A Part 2 MCC marker segment: one array-based decorrelation
    collection over components 0..comps-1, naming the MCT records
    ``deco`` and ``offset`` (0: none), reversible."""
    tmcc = (1 << 16) | (offset << 8) | deco
    return j2k_segment(0xFF75, struct.pack(">HBHH", 0, index, 0, 1)
                       + struct.pack(">BH", 1, comps) + bytes(range(comps))
                       + struct.pack(">H", comps) + bytes(range(comps))
                       + tmcc.to_bytes(3, "big"))


def j2k_mco(*stages: int) -> bytes:
    """A Part 2 MCO marker segment naming the MCC records ``stages``."""
    return j2k_segment(0xFF77, bytes([len(stages), *stages]))


def j2k_ht_flagged(codestream: bytes) -> bytes:
    """The codestream with code-block style bit 6 (HT) set in its main
    COD. Its code-blocks are still Part 1: only a codestream whose every
    code-block is empty (a flat image, losslessly coded) is then a valid
    HTJ2K codestream, which OpenJPEG decodes."""
    at = codestream.index(b"\xff\x52") + 12
    return codestream[:at] + bytes([codestream[at] | 0x40]) + \
        codestream[at + 1:]


# ---------------------------------------------------------------------------
# BMP, PNM and PAM
# ---------------------------------------------------------------------------

def bmp_file(width: int, height: int, bpp: int, data: bytes,
             compression: int = 0, header: int = 40, clrused: int = 0,
             palette=None, masks=None) -> bytes:
    """A BMP file: the 14-byte file header, a ``header``-byte info header
    (12: BITMAPCOREHEADER, 40, 64: OS/2 2.x, 108: V4, 124: V5), the masks
    after it (BI_BITFIELDS), the palette ((n, 4) BGRA, (n, 3) BGR for the
    core header) and ``data``, the rows as stored (bottom-up for a positive
    height)."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", header, width, height, 1, bpp,
                           compression, len(data), 2835, 2835, clrused, 0)
        info += bytes(header - 40)
    extra = struct.pack("<III", *masks) if masks is not None else b""
    if palette is not None:
        extra += np.asarray(palette, np.uint8).tobytes()
    offset = 14 + len(info) + len(extra)
    return b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset) + \
        info + extra + data


def bmp_rows(index: np.ndarray, bpp: int) -> bytes:
    """(h, w) palette indices or (h, w, 3) BGR, top row first -> the rows
    of an uncompressed BMP, bottom-up, each padded to 4 bytes."""
    rows = _raw_rows(index if index.ndim == 3 else index[..., None], bpp,
                     "<") if bpp < 24 else index.reshape(index.shape[0], -1)
    pad = (-rows.shape[1]) % 4
    return np.pad(rows, ((0, 0), (0, pad)))[::-1].astype(np.uint8).tobytes()


def bmp_rle8(index: np.ndarray) -> bytes:
    """RLE8 of (h, w) palette indices, bottom row first: runs of equal
    pixels up to 255, an end-of-line escape after each row, end of
    bitmap."""
    out = bytearray()
    for row in index[::-1]:
        x = 0
        while x < len(row):
            run = 1
            while x + run < len(row) and row[x + run] == row[x] and run < 255:
                run += 1
            out += bytes([run, int(row[x])])
            x += run
        out += b"\x00\x00"
    return bytes(out[:-2]) + b"\x00\x01"


def pnm_file(samples: np.ndarray, maxval: int = 255, binary: bool = True,
             comment: bytes = b"") -> bytes:
    """A PGM (P2/P5) of (h, w) or PPM (P3/P6) of (h, w, 3) samples, 16-bit
    big-endian above a maxval of 255; ``comment`` goes after the magic."""
    samples = np.asarray(samples)
    color = samples.ndim == 3
    magic = (6 if color else 5) if binary else (3 if color else 2)
    head = b"P%d\n" % magic + (b"# " + comment + b"\n" if comment else b"") \
        + b"%d %d\n%d\n" % (samples.shape[1], samples.shape[0], maxval)
    if not binary:
        rows = samples.reshape(samples.shape[0], -1)
        return head + b"\n".join(b" ".join(b"%d" % v for v in r)
                                 for r in rows) + b"\n"
    return head + samples.astype(">u2" if maxval > 255 else np.uint8) \
        .tobytes()


def pam_file(samples: np.ndarray, maxval: int = 255, tupltype=None) -> bytes:
    """A PAM (P7) of (h, w, depth) samples."""
    h, w, depth = samples.shape
    head = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (
        w, h, depth, maxval)
    if tupltype:
        head += b"TUPLTYPE " + tupltype.encode() + b"\n"
    return head + b"ENDHDR\n" + samples.astype(
        ">u2" if maxval > 255 else np.uint8).tobytes()


# -- GIF ----------------------------------------------------------------------

def gif_codes(codes, min_size: int) -> list[tuple[int, int]]:
    """Each LZW code with the width a GIF decoder reads it at: min_size + 1
    after a clear or end code, one more each time the table's next entry
    reaches the width's limit (up to 12 bits)."""
    clear = 1 << min_size
    size, nxt, prev, out = min_size + 1, clear + 2, None, []
    for c in codes:
        out.append((c, size))
        if c in (clear, clear + 1):
            size, nxt, prev = min_size + 1, clear + 2, None
            continue
        if prev is not None and nxt < 4096:
            nxt += 1
            if nxt == 1 << size and size < 12:
                size += 1
        prev = c
    return out


def pack_lsb(codes) -> bytes:
    """(value, width) codes packed least significant bit first."""
    acc = n = 0
    out = bytearray()
    for v, b in codes:
        acc |= v << n
        n += b
        while n >= 8:
            out.append(acc & 255)
            acc >>= 8
            n -= 8
    if n:
        out.append(acc & 255)
    return bytes(out)


def gif_blocks(data: bytes, size: int = 255, terminator: bool = True
               ) -> bytes:
    """Data sub-blocks of at most ``size`` bytes."""
    out = bytearray()
    for i in range(0, len(data), size):
        out.append(len(data[i:i + size]))
        out += data[i:i + size]
    return bytes(out) + (b"\0" if terminator else b"")


def gif_lzw(index: np.ndarray, min_size: int, clear_every: int = 0) -> bytes:
    """Indices (< 2**min_size) LZW-coded as a GIF encoder codes them: a
    clear code first, the table grown to 4096 entries (then a clear, or
    another every ``clear_every`` codes), an end code last."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1

    def fresh():
        return {(i,): i for i in range(clear)}, clear + 2

    table, nxt = fresh()
    codes, s, since = [clear], (), 0
    for v in index.ravel().tolist():
        t = s + (v,)
        if t in table:
            s = t
            continue
        codes.append(table[s])
        since += 1
        if nxt < 4096 and not (clear_every and since >= clear_every):
            table[t] = nxt
            nxt += 1
        else:
            codes.append(clear)
            table, nxt = fresh()
            since = 0
        s = (v,)
    if s:
        codes.append(table[s])
    codes.append(eoi)
    return pack_lsb(gif_codes(codes, min_size))


def gif_file(width: int, height: int, lzw_data: bytes, min_size: int = 8,
             gct=None, lct=None, background: int = 0, gce=None,
             frame=None, interlace: bool = False, extensions: bytes = b"",
             more: bytes = b"", trailer: bool = True,
             version: bytes = b"89a") -> bytes:
    """A GIF file with one image: ``gct``/``lct`` (n, 3) colour tables
    (padded to a power of two), ``gce`` (disposal, transparent index or
    None), ``frame`` (left, top, w, h; the whole screen by default),
    ``more`` (blocks after the image, e.g. further frames)."""
    def table(t):
        t = np.asarray(t, np.uint8).reshape(-1, 3)
        k = max(0, (len(t) - 1).bit_length() - 1)
        pad = np.zeros(((2 << k) - len(t), 3), np.uint8)
        return k, np.concatenate([t, pad]).tobytes()
    out = bytearray(b"GIF" + version + struct.pack("<HH", width, height))
    if gct is not None:
        k, t = table(gct)
        out += bytes([0x80 | k, background, 0]) + t
    else:
        out += bytes([0, background, 0])
    out += extensions
    if gce is not None:
        disposal, transparent = gce
        out += b"\x21\xf9\x04" + bytes([
            (disposal << 2) | (transparent is not None)]) + b"\0\0" + \
            bytes([transparent or 0]) + b"\0"
    left, top, fw, fh = frame or (0, 0, width, height)
    flags = 0x40 if interlace else 0
    local = b""
    if lct is not None:
        k, local = table(lct)
        flags |= 0x80 | k
    out += b"\x2c" + struct.pack("<HHHHB", left, top, fw, fh, flags) + local
    out += bytes([min_size]) + gif_blocks(lzw_data) + more
    return bytes(out) + (b"\x3b" if trailer else b"")


def gif_interlace(index: np.ndarray) -> np.ndarray:
    """Rows in GIF's interlaced order (0::8, 4::8, 2::4, 1::2)."""
    h = index.shape[0]
    order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                            np.arange(2, h, 4), np.arange(1, h, 2)])
    return index[order]


# -- WebP (libwebp's own encoder through ctypes) ------------------------------

def _libwebp():
    """The system libwebp (libwebp.so.7; encode.h of encoder ABI 0x020f)
    with WebPConfig, WebPPicture and WebPMemoryWriter declared."""
    import ctypes
    import ctypes.util

    lib = ctypes.CDLL(ctypes.util.find_library("webp") or "libwebp.so.7")
    i32, f32, vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p

    class Config(ctypes.Structure):
        _fields_ = [("lossless", i32), ("quality", f32), ("method", i32),
                    ("image_hint", i32), ("target_size", i32),
                    ("target_PSNR", f32)] + [(n, i32) for n in (
                        "segments", "sns_strength", "filter_strength",
                        "filter_sharpness", "filter_type", "autofilter",
                        "alpha_compression", "alpha_filtering",
                        "alpha_quality", "pass_", "show_compressed",
                        "preprocessing", "partitions", "partition_limit",
                        "emulate_jpeg_size", "thread_level", "low_memory",
                        "near_lossless", "exact", "use_delta_palette",
                        "use_sharp_yuv", "qmin", "qmax")]

    class Picture(ctypes.Structure):
        _fields_ = [("use_argb", i32), ("colorspace", i32), ("width", i32),
                    ("height", i32), ("y", vp), ("u", vp), ("v", vp),
                    ("y_stride", i32), ("uv_stride", i32), ("a", vp),
                    ("a_stride", i32), ("pad1", ctypes.c_uint32 * 2),
                    ("argb", vp), ("argb_stride", i32),
                    ("pad2", ctypes.c_uint32 * 3), ("writer", vp),
                    ("custom_ptr", vp), ("extra_info_type", i32),
                    ("extra_info", vp), ("stats", vp), ("error_code", i32),
                    ("progress_hook", vp), ("user_data", vp),
                    ("pad3", ctypes.c_uint32 * 3), ("pad4", vp), ("pad5", vp),
                    ("pad6", ctypes.c_uint32 * 8), ("memory_", vp),
                    ("memory_argb_", vp), ("pad7", vp * 2)]

    class Writer(ctypes.Structure):
        _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)),
                    ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                    ("pad", ctypes.c_uint32)]

    return lib, Config, Picture, Writer


def webp_encode(pixels: np.ndarray, **options) -> bytes:
    """A WebP file of (h, w, 3) RGB or (h, w, 4) RGBA ``pixels`` from
    libwebp's WebPEncode with the WebPConfig fields in ``options`` (e.g.
    lossless, quality, method, segments, sns_strength, filter_strength,
    filter_sharpness, filter_type, partitions, near_lossless, exact,
    alpha_compression, alpha_filtering, alpha_quality, use_sharp_yuv;
    ``pass_`` for pass)."""
    import ctypes

    lib, Config, Picture, Writer = _libwebp()
    abi = 0x020F
    cfg = Config()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0,
                                      ctypes.c_float(75.0), abi)
    for name, value in options.items():
        setattr(cfg, name, value)
    assert lib.WebPValidateConfig(ctypes.byref(cfg)), options
    pic = Picture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), abi)
    h, w, nch = pixels.shape
    pic.width, pic.height = w, h
    pic.use_argb = int(bool(options.get("lossless")))
    src = np.ascontiguousarray(pixels, np.uint8)
    importer = lib.WebPPictureImportRGBA if nch == 4 \
        else lib.WebPPictureImportRGB
    assert importer(ctypes.byref(pic), src.ctypes.data_as(ctypes.c_void_p),
                    w * nch)
    writer = Writer()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    pic.custom_ptr = ctypes.cast(ctypes.pointer(writer), ctypes.c_void_p) \
        .value
    try:
        assert lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)), \
            pic.error_code
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


def riff_chunks(data: bytes) -> list[tuple[bytes, int, int]]:
    """(tag, offset of the payload, payload size) of a RIFF file's chunks."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = struct.unpack_from("<I", data, pos + 4)[0]
        out.append((data[pos:pos + 4], pos + 8, size))
        pos += 8 + size + (size & 1)
    return out


def riff_file(chunks) -> bytes:
    """A RIFF/WEBP file of (tag, payload) chunks (odd payloads padded)."""
    body = b"".join(tag + struct.pack("<I", len(p)) + p + b"\0" * (len(p) & 1)
                    for tag, p in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


# -- Sun raster, PFM, Radiance HDR --------------------------------------------

def sun_raster(width: int, height: int, depth: int, data: bytes,
               rtype: int = 1, maptype: int = 0, colormap: bytes = b"",
               maplength: int | None = None) -> bytes:
    """A Sun raster file (big-endian header) of already padded rows."""
    maplen = len(colormap) if maplength is None else maplength
    return struct.pack(">8I", 0x59A66A95, width, height, depth, len(data),
                       rtype, maptype, maplen) + colormap + data


def sun_rows(pixels: np.ndarray, depth: int) -> bytes:
    """(h, w) indices (depth 1 or 8) or (h, w, 3|4) bytes as Sun raster
    rows padded to 16 bits."""
    h = pixels.shape[0]
    if depth == 1:
        rows = np.packbits(pixels.astype(np.uint8), axis=1)
    else:
        rows = pixels.reshape(h, -1).astype(np.uint8)
    pad = (-rows.shape[1]) % 2
    return np.pad(rows, ((0, 0), (0, pad))).tobytes()


def sun_rle(data: bytes) -> bytes:
    """Sun's byte encoding: 0x80 n v repeats v n+1 times, 0x80 0 is a
    literal 0x80."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and data[j] == data[i] and j - i < 256:
            j += 1
        if j - i >= 3:
            out += bytes([0x80, j - i - 1, data[i]])
            i = j
        elif data[i] == 0x80:
            out += b"\x80\x00"
            i += 1
        else:
            out.append(data[i])
            i += 1
    return bytes(out)


def pfm_file(values: np.ndarray, scale: float = -1.0,
             header: bytes | None = None) -> bytes:
    """A colour PFM: rows bottom to top, little-endian for a negative
    scale."""
    h, w, _ = values.shape
    head = header if header is not None else \
        b"PF\n%d %d\n%s\n" % (w, h, repr(float(scale)).encode())
    order = "<f4" if scale < 0 else ">f4"
    return head + values[::-1].astype(order).tobytes()


def hdr_header(width: int, height: int, magic: bytes = b"#?RADIANCE",
               lines: bytes = b"") -> bytes:
    return magic + b"\n" + lines + b"FORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" \
        % (height, width)


def hdr_rle_line(channel: bytes) -> bytes:
    """One channel of a scanline in Radiance's runs (over 128: a repeat)."""
    out, i, n = bytearray(), 0, len(channel)
    while i < n:
        j = i
        while j < n and channel[j] == channel[i] and j - i < 127:
            j += 1
        if j - i >= 3:
            out += bytes([128 + j - i, channel[i]])
            i = j
            continue
        k = i
        while k < n and k - i < 128 and not (
                k + 2 < n and channel[k] == channel[k + 1] == channel[k + 2]):
            k += 1
        out += bytes([k - i]) + channel[i:k]
        i = k
    return bytes(out)


def hdr_rle(rgbe: np.ndarray) -> bytes:
    """(h, w, 4) RGBE quadruples as new-style run-length scanlines."""
    h, w, _ = rgbe.shape
    out = bytearray()
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            out += hdr_rle_line(rgbe[y, :, c].astype(np.uint8).tobytes())
    return bytes(out)


def screen_content_avif(path, seed: int = 0) -> None:
    """A 64x64 AVIF of two colours in random dots as Pillow writes it at
    its defaults: libaom turns screen-content tools (palette, intra block
    copy) on for it."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    dots = np.where(rng.random((64, 64)) < 0.3, 40, 235).astype(np.uint8)
    Image.fromarray(np.repeat(dots[..., None], 3, 2)).save(path, "AVIF")


def ten_bit_avif(path, seed: int = 0) -> None:
    """A 64x64 AVIF of 10 bits (cv2 from uint16 random dots)."""
    import cv2

    rng = np.random.default_rng(seed)
    dots = np.where(rng.random((64, 64)) < 0.3, 160, 940).astype(np.uint16)
    assert cv2.imwrite(str(path), np.repeat(dots[..., None], 3, 2),
                       [cv2.IMWRITE_AVIF_DEPTH, 10])


def sequence_avif(path, seed: int = 0) -> None:
    """A 64x64 AVIF image sequence of three frames of random dots as
    Pillow writes it (save_all, major brand avis), a variant the port's
    AVIF reader refuses by name."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    frames = [Image.fromarray(np.where(rng.random((64, 64, 3)) < 0.3, 40,
                                       235).astype(np.uint8))
              for _ in range(3)]
    frames[0].save(path, "AVIF", save_all=True, append_images=frames[1:])


def _libavif():
    """The libavif (1.4) bundled with cv2 (opencv_python.libs), whose
    encoder is libaom's, with the functions the libavif writers call
    declared."""
    import ctypes

    import cv2

    libs = Path(cv2.__file__).parent.parent / "opencv_python.libs"
    lib = ctypes.CDLL(str(sorted(libs.glob("libavif-*.so*"))[0]))
    vp, u32, i32 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
    for name, res, args in (
            ("avifImageCreate", vp, [u32, u32, u32, i32]),
            ("avifImageAllocatePlanes", i32, [vp, i32]),
            ("avifImageDestroy", None, [vp]),
            ("avifEncoderCreate", vp, []),
            ("avifEncoderSetCodecSpecificOption", i32,
             [vp, ctypes.c_char_p, ctypes.c_char_p]),
            ("avifEncoderWrite", i32, [vp, vp, vp]),
            ("avifEncoderAddImage", i32, [vp, vp, ctypes.c_uint64, i32]),
            ("avifEncoderAddImageGrid", i32, [vp, u32, u32, vp, i32]),
            ("avifEncoderFinish", i32, [vp, vp]),
            ("avifEncoderDestroy", None, [vp]),
            ("avifRWDataFree", None, [vp])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _libavif_image(lib, planes: list[np.ndarray], depth: int, layout: str,
                   full_range: bool, matrix: int,
                   alpha: np.ndarray | None, primaries: int = 2,
                   premultiplied: bool = False) -> int:
    """An avifImage of the planes (avifImage's fields by offset)."""
    import ctypes

    h, w = planes[0].shape
    image = lib.avifImageCreate(w, h, depth, {"444": 1, "422": 2, "420": 3,
                                              "400": 4}[layout])
    ctypes.c_uint32.from_address(image + 16).value = int(full_range)
    ctypes.c_uint32.from_address(image + 80).value = int(premultiplied)
    ctypes.c_uint16.from_address(image + 104).value = primaries
    ctypes.c_uint16.from_address(image + 108).value = matrix
    lib.avifImageAllocatePlanes(image, 1 if alpha is None else 3)
    dtype = np.uint16 if depth > 8 else np.uint8
    rows = [(ctypes.c_void_p.from_address(image + 24 + 8 * p).value,
             ctypes.c_uint32.from_address(image + 48 + 4 * p).value, plane)
            for p, plane in enumerate(planes)]
    if alpha is not None:
        rows.append((ctypes.c_void_p.from_address(image + 64).value,
                     ctypes.c_uint32.from_address(image + 72).value, alpha))
    for at, row_bytes, plane in rows:
        plane = np.ascontiguousarray(plane, dtype=dtype)
        for r in range(plane.shape[0]):
            ctypes.memmove(at + r * row_bytes, plane[r].ctypes.data,
                           plane[r].nbytes)
    return image


def _libavif_encoder(lib, speed: int, quality: int, options: dict | None
                     ) -> int:
    """An avifEncoder at a speed and quality (its fields by offset), with
    libaom's codec-specific options."""
    import ctypes

    encoder = lib.avifEncoderCreate()
    ctypes.c_int32.from_address(encoder + 8).value = speed
    ctypes.c_int32.from_address(encoder + 32).value = quality
    for key, value in (options or {}).items():
        assert lib.avifEncoderSetCodecSpecificOption(
            encoder, key.encode(), str(value).encode()) == 0, key
    return encoder


def _libavif_run(lib, encoder: int, images: list[int], write) -> bytes:
    """``write(out)`` (an avifEncoderWrite or avifEncoderFinish into the
    avifRWData ``out``) -> the file; the encoder and images destroyed."""
    import ctypes

    out = (ctypes.c_uint8 * 16)()  # avifRWData: data, size
    try:
        assert write(ctypes.addressof(out)) == 0
        at = ctypes.c_void_p.from_address(ctypes.addressof(out)).value
        size = ctypes.c_size_t.from_address(ctypes.addressof(out) + 8).value
        return ctypes.string_at(at, size)
    finally:
        lib.avifRWDataFree(ctypes.addressof(out))
        lib.avifEncoderDestroy(encoder)
        for image in images:
            lib.avifImageDestroy(image)


def libavif_encode(planes: list[np.ndarray], depth: int, layout: str,
                   full_range: bool = True, matrix: int = 2, speed: int = 6,
                   quality: int = 60, alpha: np.ndarray | None = None,
                   options: dict | None = None, primaries: int = 2,
                   premultiplied: bool = False) -> bytes:
    """An AVIF of YUV planes as libavif's encoder (libaom) writes it: Y, U
    and V (or Y alone for ``layout`` "400"; "420", "422" or "444" else)
    of ``depth`` 8, 10 or 12 bits, the range, colour primaries and matrix
    coefficients set in the image (and so in its colr box), an alpha plane
    of the same depth where given (``premultiplied``: the colour marked as
    premultiplied by it, a prem reference), and libaom's codec-specific
    ``options`` (e.g. film-grain-test, denoise-noise-level). Reaches what
    cv2 and Pillow do not write: 4:2:2 and 4:4:4 above 8 bits, and film
    grain above 8 bits. Fields of libavif 1.4's avifImage and avifEncoder
    are set by offset."""
    lib = _libavif()
    image = _libavif_image(lib, planes, depth, layout, full_range, matrix,
                           alpha, primaries, premultiplied)
    encoder = _libavif_encoder(lib, speed, quality, options)
    return _libavif_run(lib, encoder, [image],
                        lambda out: lib.avifEncoderWrite(encoder, image, out))


def libavif_encode_grid(cells: list[list[np.ndarray]], columns: int,
                        rows: int, depth: int = 8, layout: str = "420",
                        full_range: bool = True, matrix: int = 2,
                        speed: int = 9, quality: int = 60,
                        alphas: list[np.ndarray] | None = None,
                        options: dict | None = None,
                        layers: int = 1) -> bytes:
    """An AVIF grid item as libavif's encoder writes it
    (avifEncoderAddImageGrid): ``rows`` x ``columns`` cells, each a list of
    planes as libavif_encode takes them, in row order, of one size (at
    least 64x64, even where the chroma is subsampled); with ``alphas``,
    an alpha grid of the cells' alpha planes. The grid's output size is
    the cells' whole. With ``layers`` 2, each cell is layered (libavif's
    extraLayerCount: a key frame at quality 10, then an inter frame at
    ``quality``)."""
    import ctypes

    lib = _libavif()
    images = [_libavif_image(lib, planes, depth, layout, full_range, matrix,
                             None if alphas is None else alphas[k])
              for k, planes in enumerate(cells)]
    encoder = _libavif_encoder(lib, speed, quality, options)
    ctypes.c_uint32.from_address(encoder + 28).value = layers - 1
    pointers = (ctypes.c_void_p * len(images))(*images)

    def write(out):
        for q in [10] * (layers - 1) + [quality]:
            ctypes.c_int32.from_address(encoder + 32).value = q
            # AVIF_ADD_IMAGE_FLAG_SINGLE for a still image
            rc = lib.avifEncoderAddImageGrid(encoder, columns, rows,
                                             ctypes.addressof(pointers),
                                             2 if layers == 1 else 0)
            if rc:
                return rc
        return lib.avifEncoderFinish(encoder, out)

    return _libavif_run(lib, encoder, images, write)


def ispe_scaled_avif(path, seed: int = 0) -> None:
    """A 64x64 AVIF as cv2 writes it with its ispe set to 64x63: libavif
    scales the frame to the ispe, a variant the port's AVIF reader refuses
    by name ("ispe property differs")."""
    import cv2

    rng = np.random.default_rng(seed)
    dots = np.where(rng.random((64, 64)) < 0.3, 40, 235).astype(np.uint8)
    ok, buf = cv2.imencode(".avif", np.repeat(dots[..., None], 3, 2))
    assert ok
    data = buf.tobytes()
    at = data.index(b"ispe") + 12  # its height
    Path(path).write_bytes(data[:at] + (63).to_bytes(4, "big")
                           + data[at + 4:])


def layered_avif(path, seed: int = 0) -> None:
    """A 64x64 AVIF of two layers as libavif's encoder writes it
    (extraLayerCount 1: a key frame at quality 10, then the second layer,
    an inter frame, at quality 90; a1lx): its second layer is an AV1 inter
    frame."""
    import ctypes

    lib = _libavif()
    rng = np.random.default_rng(seed)
    dots = np.where(rng.random((64, 64)) < 0.3, 40, 235).astype(np.uint8)
    image = _libavif_image(lib, [dots, np.full((32, 32), 128, np.uint8),
                                 np.full((32, 32), 128, np.uint8)], 8,
                           "420", True, 2, None)
    encoder = _libavif_encoder(lib, 9, 10, None)
    ctypes.c_uint32.from_address(encoder + 28).value = 1  # extraLayerCount

    def write(out):
        for quality in (10, 90):
            ctypes.c_int32.from_address(encoder + 32).value = quality
            rc = lib.avifEncoderAddImage(encoder, image, 1, 0)
            if rc:
                return rc
        return lib.avifEncoderFinish(encoder, out)

    Path(path).write_bytes(_libavif_run(lib, encoder, [image], write))


def layered_avif_bytes(layers: list[list[np.ndarray]], depth: int = 8,
                       layout: str = "420", qualities: list[int] | None = None,
                       speed: int = 6, options: dict | None = None,
                       scaling: list[tuple[int, int]] | None = None,
                       alpha: list[np.ndarray] | None = None) -> bytes:
    """A layered AVIF as libavif's encoder writes it (extraLayerCount
    len(layers) - 1): each layer's planes (as libavif_encode takes them)
    added in turn at its quality (default 10 for all but the last, 90),
    at libaom ``speed`` with its codec-specific ``options``; ``scaling``
    gives each layer's scalingMode (n, d) (libaom codes that layer at n/d
    of the size; a later layer then predicts from a scaled reference),
    ``alpha`` each layer's alpha plane."""
    import ctypes

    lib = _libavif()
    images = [_libavif_image(lib, planes, depth, layout, True, 2,
                             None if alpha is None else alpha[k])
              for k, planes in enumerate(layers)]
    qualities = qualities or [10] * (len(layers) - 1) + [90]
    encoder = _libavif_encoder(lib, speed, qualities[-1], options)
    ctypes.c_uint32.from_address(encoder + 28).value = len(layers) - 1

    def write(out):
        for k, (image, quality) in enumerate(zip(images, qualities)):
            ctypes.c_int32.from_address(encoder + 32).value = quality
            ctypes.c_int32.from_address(encoder + 36).value = quality
            if scaling is not None:  # avifEncoder.scalingMode, both axes
                n, d = scaling[k]
                for at, v in ((68, n), (72, d), (76, n), (80, d)):
                    ctypes.c_int32.from_address(encoder + at).value = v
            rc = lib.avifEncoderAddImage(encoder, image, 1, 0)
            if rc:
                return rc
        return lib.avifEncoderFinish(encoder, out)

    return _libavif_run(lib, encoder, images, write)


def libavif_sequence_bytes(frames: list[list[np.ndarray]], speed: int = 6,
                           quality: int = 60, options: dict | None = None
                           ) -> bytes:
    """An AVIF image sequence (avis) of 8-bit 4:2:0 frames as libavif's
    encoder writes it: libaom with its lookahead, so alt-ref frames,
    compound prediction and frames shown again."""
    lib = _libavif()
    images = [_libavif_image(lib, planes, 8, "420", True, 2, None)
              for planes in frames]
    encoder = _libavif_encoder(lib, speed, quality, options)

    def write(out):
        for image in images:
            rc = lib.avifEncoderAddImage(encoder, image, 1, 0)
            if rc:
                return rc
        return lib.avifEncoderFinish(encoder, out)

    return _libavif_run(lib, encoder, images, write)


def libavif_decode(data: bytes) -> list[np.ndarray] | None:
    """libavif's own decode of an AVIF (avifDecoderReadMemory, its
    defaults) -> its Y, U and V planes (Y alone for 4:0:0) at the stream's
    depth (uint8 at 8 bits, uint16 above), or None where it fails."""
    import ctypes

    lib = _libavif()
    vp = ctypes.c_void_p
    for name, res, args in (
            ("avifDecoderCreate", vp, []), ("avifImageCreateEmpty", vp, []),
            ("avifDecoderReadMemory", ctypes.c_int,
             [vp, vp, vp, ctypes.c_size_t]),
            ("avifDecoderDestroy", None, [vp])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    decoder, image = lib.avifDecoderCreate(), lib.avifImageCreateEmpty()
    buf = ctypes.create_string_buffer(data, len(data))
    try:
        if lib.avifDecoderReadMemory(decoder, image, buf, len(data)):
            return None
        w, h, depth, layout = (ctypes.c_uint32.from_address(image + at).value
                               for at in (0, 4, 8, 12))
        sx, sy = {1: (0, 0), 2: (1, 0), 3: (1, 1), 4: (1, 1)}[layout]
        planes = []
        for p in range(1 if layout == 4 else 3):
            at = ctypes.c_void_p.from_address(image + 24 + 8 * p).value
            row = ctypes.c_uint32.from_address(image + 48 + 4 * p).value
            pw, ph = (w, h) if p == 0 else ((w + sx) >> sx, (h + sy) >> sy)
            raw = np.frombuffer(ctypes.string_at(at, row * ph),
                                np.uint8).reshape(ph, row)
            planes.append(raw.view(np.uint16 if depth > 8 else np.uint8)
                          [:, :pw].copy())
        return planes
    finally:
        lib.avifDecoderDestroy(decoder)
        lib.avifImageDestroy(image)


def isobmff_boxes(data: bytes, start: int = 0, end: int | None = None,
                  path: tuple = ()) -> list[tuple[tuple, int, int]]:
    """Every box of an AVIF file, nested boxes too: (path of box types,
    start, end). Full boxes (meta) and sample entries (stsd, av01) are
    entered past their fields; a box of size 0 runs to ``end``."""
    end = len(data) if end is None else end
    out, at = [], start
    while at + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, at)
        size = size or end - at
        if size < 8:
            break
        here = path + (kind,)
        out.append((here, at, at + size))
        body = {b"meta": 12, b"stsd": 16}.get(kind, 8)
        if kind == b"av01" and b"stsd" in path:
            body = 8 + 78
        if kind in (b"meta", b"iprp", b"ipco", b"moov", b"trak", b"mdia",
                    b"minf", b"stbl", b"stsd", b"edts", b"tref", b"dinf",
                    b"av01") and (kind != b"av01" or b"stsd" in path):
            out += isobmff_boxes(data, at + body, at + size, here)
        at += size
    return out


def iloc_fields(data: bytes) -> dict[int, dict]:
    """Where each item's location lies in the (first) meta box's iloc:
    {item: {"method", "base": (at, bytes), "extents": [((offset at,
    bytes), (length at, bytes))]}}, for edits."""
    at = next(a for p, a, _ in isobmff_boxes(data) if p == (b"meta", b"iloc"))
    p = at + 8
    version = data[p]
    p += 4
    sizes = int.from_bytes(data[p:p + 2], "big")
    p += 2
    off, length, base, index = (sizes >> 12, (sizes >> 8) & 15,
                                (sizes >> 4) & 15, sizes & 15)
    width = 2 if version < 2 else 4
    count = int.from_bytes(data[p:p + width], "big")
    p += width
    out = {}
    for _ in range(count):
        item = int.from_bytes(data[p:p + width], "big")
        p += width
        method = 0
        if version in (1, 2):
            method = int.from_bytes(data[p:p + 2], "big") & 15
            p += 2
        p += 2
        entry = {"method": method, "base": (p, base), "extents": []}
        p += base
        n = int.from_bytes(data[p:p + 2], "big")
        p += 2
        for _ in range(n):
            if version in (1, 2):
                p += index
            entry["extents"].append(((p, off), (p + off, length)))
            p += off + length
        out[item] = entry
    return out


def put_uint(data: bytes, at: int, nbytes: int, value: int) -> bytes:
    return data[:at] + value.to_bytes(nbytes, "big") + data[at + nbytes:]


def avif_pad_meta(data: bytes, pad: int) -> bytes:
    """An AVIF file with a free box of ``pad`` bytes (8 or more) at the end
    of its meta box, the items' file offsets moved past it."""
    (meta_at, meta_end), = [(a, e) for p, a, e in isobmff_boxes(data)
                            if p == (b"meta",)]
    fields = iloc_fields(data)
    out = data[:meta_end] + struct.pack(">I4s", pad, b"free") + \
        bytes(pad - 8) + data[meta_end:]
    out = put_uint(out, meta_at, 4, meta_end - meta_at + pad)
    for entry in fields.values():
        if entry["method"]:
            continue
        (at, nbytes) = entry["base"]
        value = int.from_bytes(data[at:at + nbytes], "big") if nbytes else 0
        if nbytes and value >= meta_end:
            out = put_uint(out, at, nbytes, value + pad)
        for (at, nbytes), _ in entry["extents"]:
            offset = int.from_bytes(data[at:at + nbytes], "big")
            if value + offset >= meta_end and not (entry["base"][1] and
                                                   value >= meta_end):
                out = put_uint(out, at, nbytes, offset + pad)
    return out


def avif_add_property(data: bytes, item: int, kind: bytes, body: bytes,
                      essential: bool) -> bytes:
    """An AVIF file with a property box (``kind``, ``body``) appended to
    ipco and associated with ``item`` in ipma (after its others, marked
    essential or not), the boxes around it and the items' file offsets
    moved to fit."""
    boxes = isobmff_boxes(data)
    where = {p: (a, e) for p, a, e in boxes}
    meta, iprp = where[(b"meta",)], where[(b"meta", b"iprp")]
    ipco, ipma = where[(b"meta", b"iprp", b"ipco")], where[(b"meta", b"iprp",
                                                           b"ipma")]
    count = sum(1 for p, _, _ in boxes if len(p) == 4 and p[:3] == (
        b"meta", b"iprp", b"ipco"))
    prop = struct.pack(">I4s", 8 + len(body), kind) + body
    # ipma: version, flags, entries of (item, count, associations)
    at = ipma[0] + 8
    version, flags = data[at], int.from_bytes(data[at + 1:at + 4], "big")
    width, wide = (2 if version < 1 else 4), flags & 1
    out, p = bytearray(data[ipma[0]:at + 4]), at + 4
    entries = int.from_bytes(data[p:p + 4], "big")
    out += data[p:p + 4]
    p += 4
    for _ in range(entries):
        this = int.from_bytes(data[p:p + width], "big")
        n = data[p + width]
        size = n * (2 if wide else 1)
        assoc = data[p + width + 1:p + width + 1 + size]
        if this == item:
            index = count + 1
            assoc += ((index | (essential << 15)).to_bytes(2, "big") if wide
                      else bytes([index | (essential << 7)]))
            n += 1
        out += data[p:p + width] + bytes([n]) + assoc
        p += width + 1 + size
    out = bytes(out)
    out = struct.pack(">I", len(out)) + out[4:]
    grow = len(prop) + len(out) - (ipma[1] - ipma[0])
    new = (data[:ipco[1]] + prop + data[ipco[1]:ipma[0]] + out
           + data[ipma[1]:])
    new = put_uint(new, ipco[0], 4, ipco[1] - ipco[0] + len(prop))
    new = put_uint(new, iprp[0], 4, iprp[1] - iprp[0] + grow)
    new = put_uint(new, meta[0], 4, meta[1] - meta[0] + grow)
    fields = iloc_fields(data)
    for entry in fields.values():
        if entry["method"]:
            continue
        (at, nbytes) = entry["base"]
        value = int.from_bytes(data[at:at + nbytes], "big") if nbytes else 0
        if nbytes and value >= meta[1]:
            new = put_uint(new, at, nbytes, value + grow)
        for (at, nbytes), _ in entry["extents"]:
            offset = int.from_bytes(data[at:at + nbytes], "big")
            if value + offset >= meta[1] and not (entry["base"][1] and
                                                  value >= meta[1]):
                new = put_uint(new, at, nbytes, offset + grow)
    return new


def avif_crop_grid(data: bytes, width: int, height: int) -> bytes:
    """libavif_encode_grid's file with the grid's output size (its
    ImageGrid's 16-bit fields, and the grid item's ispe, the first in
    ipco) set to width x height."""
    (at, nbytes), _ = iloc_fields(data)[1]["extents"][0]
    grid = int.from_bytes(data[at:at + nbytes], "big")
    assert data[grid:grid + 2] == b"\x00\x00"  # version 0, 16-bit sizes
    ispe = next(a for p, a, _ in isobmff_boxes(data)
                if p == (b"meta", b"iprp", b"ipco", b"ispe")) + 12
    for at, size in ((grid + 4, 2), (ispe, 4)):
        data = put_uint(put_uint(data, at, size, width), at + size, size,
                        height)
    return data


def avif_move_item(data: bytes, item: int, payload: bytes) -> bytes:
    """An AVIF file with an item's data replaced by ``payload``, appended
    at the end of the file (its iloc entry's one extent pointed there)."""
    entry = iloc_fields(data)[item]
    assert entry["method"] == 0 and len(entry["extents"]) == 1
    (off_at, off_size), (len_at, len_size) = entry["extents"][0]
    base = entry["base"]
    base_value = int.from_bytes(data[base[0]:base[0] + base[1]], "big") \
        if base[1] else 0
    out = put_uint(data, off_at, off_size, len(data) - base_value)
    return put_uint(out, len_at, len_size, len(payload)) + payload


def ycbcr_planes(rgb: np.ndarray, layout: str, depth: int
                 ) -> list[np.ndarray]:
    """An RGB image's BT.601 full-range Y, Cb and Cr (cv2's YCrCb),
    subsampled by taking every other sample for ``layout`` "420" or
    "422", and widened to ``depth`` bits (Y alone for "400")."""
    import cv2

    ycc = cv2.cvtColor(rgb, cv2.COLOR_RGB2YCrCb).astype(np.uint16)
    ycc <<= depth - 8
    y, cb, cr = ycc[..., 0], ycc[..., 2], ycc[..., 1]
    if layout == "400":
        return [y]
    step = {"444": (1, 1), "422": (1, 2), "420": (2, 2)}[layout]
    return [y, cb[::step[0], ::step[1]], cr[::step[0], ::step[1]]]
