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


def _compress(raw: bytes, compression: int) -> bytes:
    if compression == 1:
        return raw
    if compression in (8, 32946):
        return zlib.compress(raw)
    if compression == 32773:
        return packbits(raw)
    raise ValueError(compression)


def _page_chunks(samples, bits, compression, predictor, tile, rows_per_strip,
                 order, fill_order):
    h, w, spp = samples.shape
    diff = _difference if predictor == 2 else (lambda x: x)
    chunks = []
    if tile:
        tw, th = tile
        ph, pw = -(-h // th) * th, -(-w // tw) * tw
        padded = np.zeros((ph, pw, spp), samples.dtype)
        padded[:h, :w] = samples
        for y in range(0, ph, th):
            for x in range(0, pw, tw):
                raw = _raw_rows(diff(padded[y: y + th, x: x + tw]), bits,
                                order)
                chunks.append(raw.tobytes())
    else:
        for y in range(0, h, rows_per_strip):
            chunks.append(_raw_rows(diff(samples[y: y + rows_per_strip]),
                                    bits, order).tobytes())
    if fill_order == 2:
        rev = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                       np.uint8)
        chunks = [rev[np.frombuffer(c, np.uint8)].tobytes() for c in chunks]
    return [_compress(c, compression) for c in chunks]


def write_tiff(path, pages, order: str = "<") -> None:
    """Write a TIFF of one or more pages. Each page is a dict: ``samples``
    (h, w, spp) integer array (bit values for 1-bit), ``bits``,
    ``photometric``, and optionally ``compression`` (1, 8, 32946 or 32773),
    ``predictor``, ``tile`` (tw, th), ``rows_per_strip``, ``orientation``,
    ``colormap`` (3 * 2**bits 16-bit values), ``extra_samples``,
    ``fill_order``, ``tags`` ({tag: value} SHORT tags set as given)."""
    out = bytearray(b"II*\x00" if order == "<" else b"MM\x00*")
    out += b"\x00\x00\x00\x00"
    link = 4  # where the next IFD offset goes
    for page in pages:
        samples = np.asarray(page["samples"])
        if samples.ndim == 2:
            samples = samples[..., None]
        h, w, spp = samples.shape
        bits = page["bits"]
        comp = page.get("compression", 1)
        tile = page.get("tile")
        rps = page.get("rows_per_strip", h)
        chunks = _page_chunks(samples, bits, comp, page.get("predictor", 1),
                              tile, rps, order, page.get("fill_order", 1))
        offsets = []
        for c in chunks:
            offsets.append(len(out))
            out += c
            if len(out) % 2:
                out += b"\x00"
        tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
                259: (3, [comp]), 262: (3, [page["photometric"]]),
                277: (3, [spp]), 284: (3, [1])}
        if tile:
            tags.update({322: (3, [tile[0]]), 323: (3, [tile[1]]),
                         324: (4, offsets),
                         325: (4, [len(c) for c in chunks])})
        else:
            tags.update({273: (4, offsets), 278: (4, [rps]),
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
            tags[tag] = (3, [v])
        ifd_at = len(out)
        struct.pack_into(order + "I", out, link, ifd_at)
        entries, blobs = [], bytearray()
        data_at = ifd_at + 2 + 12 * len(tags) + 4
        for tag in sorted(tags):
            typ, vals = tags[tag]
            code = {3: "H", 4: "I"}[typ]
            blob = struct.pack(order + code * len(vals), *[int(v) for v in
                                                           vals])
            if len(blob) <= 4:
                field = blob.ljust(4, b"\x00")
            else:
                field = struct.pack(order + "I", data_at + len(blobs))
                blobs += blob
                if len(blobs) % 2:
                    blobs += b"\x00"
            entries.append(struct.pack(order + "HHI", tag, typ, len(vals))
                           + field)
        out += struct.pack(order + "H", len(tags)) + b"".join(entries)
        link = len(out)
        out += b"\x00\x00\x00\x00"
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
