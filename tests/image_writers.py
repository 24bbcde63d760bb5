"""Small image encoders for the reader tests and the fixture: TIFF files
with the layouts cv2 and PIL do not write (tiles, 16-bit samples, palette,
orientation, fill order, both byte orders) and Adam7-interlaced PNG. cv2
reads every file written here, so cv2 stays the oracle."""

from __future__ import annotations

import io
import struct
import zlib

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


def jpeg_lossless(samples: np.ndarray, precision: int = 8,
                  predictor: int = 1, pt: int = 0, restart_rows: int = 0,
                  marker: int = 0xC3) -> bytes:
    """A lossless JPEG (SOF3, Huffman; T.81 Annex H) of (h, w) or (h, w,
    nc) samples below 2**precision, every component sampled 1x1 and all
    in one interleaved scan; ``restart_rows`` puts a restart marker every
    that many rows."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, nc = s.shape
    diffs = []
    for c in range(nc):
        x = s[..., c].astype(np.int64) >> pt
        d = (x - lossless_predict(x, predictor, precision, pt,
                                  restart_rows)) & 0xFFFF
        diffs.append(np.where(d >= 0x8000, d - 0x10000, d))
    diff = np.stack(diffs, -1)
    cats = np.vectorize(_category)(diff) if diff.size else diff
    cats = np.where(diff == -0x8000, 16, cats)
    freq = {int(k): int(v) for k, v in zip(*np.unique(cats,
                                                      return_counts=True))}
    bits, vals = huffman_spec(freq)
    codes = _huffman_codes(bits, vals)
    sof = struct.pack(">BHHB", precision, h, w, nc) + b"".join(
        bytes([c + 1, 0x11, 0]) for c in range(nc))
    out = bytearray(b"\xff\xd8" + _segment(marker, sof) + _dht(0, 0, bits,
                                                               vals))
    if restart_rows:
        out += _segment(0xDD, struct.pack(">H", restart_rows * w))
    out += _segment(0xDA, bytes([nc]) + b"".join(
        bytes([c + 1, 0]) for c in range(nc)) + bytes([predictor, 0, pt]))
    bw = _BitWriter()
    for y in range(h):
        if restart_rows and y and y % restart_rows == 0:
            out += bw.flush() + bytes([0xFF, 0xD0 + (y // restart_rows - 1)
                                       % 8])
        for x in range(w):
            for c in range(nc):
                v, k = int(diff[y, x, c]), int(cats[y, x, c])
                bw.put(*codes[k])
                if 0 < k < 16:
                    bw.put(_magnitude(v, k), k)
    return bytes(out + bw.flush() + b"\xff\xd9")


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
