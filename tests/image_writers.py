"""Small image encoders for the reader tests and the fixture: TIFF files
with the layouts cv2 and PIL do not write (tiles, 16-bit samples, palette,
orientation, fill order, both byte orders) and Adam7-interlaced PNG. cv2
reads every file written here, so cv2 stays the oracle."""

from __future__ import annotations

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


def old_style_lzw(data: bytes) -> bytes:
    """Old-style (pre-TIFF 6) LZW as libtiff's LZWDecodeCompat reads it:
    9-bit codes packed LSB first, a clear code, one literal a byte and the
    end code (at most 253 bytes, so the codes stay 9 bits wide). Byte 0
    is 0 and bit 0 of byte 1 is set; bits 1-7 of byte 1 hold the first
    byte's low 7 bits."""
    assert len(data) <= 253
    acc = 0
    codes = [256] + list(data) + [257]
    for i, code in enumerate(codes):
        acc |= code << (9 * i)
    return acc.to_bytes(-(-9 * len(codes) // 8), "little")


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
    False), ``chunks`` (the strips' or tiles' bytes as
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
    with open(path, "wb") as f:
        f.write(bytes(out))


def arithmetic_jpeg(baseline: bytes) -> bytes:
    """A baseline JPEG's bytes with its SOF0 marker turned into SOF9: an
    arithmetic-coded JPEG by its header (cv2 cannot write one)."""
    data = bytearray(baseline)
    data[data.index(b"\xff\xc0") + 1] = 0xC9
    return bytes(data)


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
