"""Parquet writers for detection results and eval-mode OCR lines, on the
standard library: counterpart of ocr_inference_tpu/io/parquet.py (schema
parity with the reference: Config.py:90-115, BDRC/utils.py:1111-1140 and
:1240-1292), which writes with pyarrow. The card machine has no pyarrow,
so this writes the format itself:

- one row group, one v1 data page per column, PLAIN values;
- repetition and definition levels RLE-encoded (the RLE/bit-packed
  hybrid), lists in the three-level layout pyarrow writes
  (``optional group (LIST) { repeated group list { element } }``), every
  field optional as pyarrow's default fields are;
- the footer in the Thrift compact protocol, with the physical, converted
  and logical types pyarrow gives the schema's fields;
- the GZIP codec (default) or none. The JAX writer uses zstd, which
  Python's standard library lacks: the bytes differ, the Parquet schema
  and the rows do not.

``read_result_parquet`` reads files this module writes (PLAIN pages, GZIP
or none); a file of another codec or encoding raises NotImplementedError
naming it.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

from ocr_inference_tpu_torch.core.config import (
    LINE_DETECTION_SCHEMA,
    OCR_LINES_SCHEMA,
)

MAGIC = b"PAR1"
CREATED_BY = "ocr_inference_tpu_torch parquet writer"

# parquet.thrift enums
_INT32, _FLOAT, _BYTE_ARRAY = 1, 4, 6
_OPTIONAL, _REPEATED = 1, 2
_UTF8, _LIST, _INT_16 = 0, 3, 16
_PLAIN, _RLE = 0, 3
_CODECS = {"none": 0, "gzip": 2}
_CODEC_NAMES = {0: "none", 1: "Snappy", 2: "GZIP", 3: "LZO", 4: "Brotli",
                5: "LZ4", 6: "zstd", 7: "LZ4_RAW"}
_ENCODING_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE",
                   4: "BIT_PACKED", 5: "DELTA_BINARY_PACKED",
                   6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY",
                   8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
_PRIMITIVES = {"string": _BYTE_ARRAY, "int32": _INT32, "int16": _INT32,
               "float32": _FLOAT}


# ---------------------------------------------------------------------------
# Thrift compact protocol
# ---------------------------------------------------------------------------

# compact type ids
_T_TRUE, _T_FALSE, _T_I8, _T_I16, _T_I32, _T_I64 = 1, 2, 3, 4, 5, 6
_T_DOUBLE, _T_BINARY, _T_LIST, _T_SET, _T_MAP, _T_STRUCT = 7, 8, 9, 10, 11, 12


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


class _Struct:
    """A Thrift struct to encode: ordered (field id, type, value)."""

    def __init__(self, *fields):
        self.fields = [f for f in fields if f[2] is not None]


def _encode_value(typ, value, out: bytearray) -> None:
    if typ in (_T_I8,):
        out += struct.pack("<b", value)
    elif typ in (_T_I16, _T_I32, _T_I64):
        out += _varint(_zigzag(value))
    elif typ == _T_BINARY:
        data = value.encode() if isinstance(value, str) else value
        out += _varint(len(data)) + data
    elif typ == _T_STRUCT:
        _encode_struct(value, out)
    elif typ == _T_LIST:
        elem, items = value
        out += bytes([(len(items) << 4) | elem]) if len(items) < 15 else \
            bytes([0xF0 | elem]) + _varint(len(items))
        for item in items:
            _encode_value(elem, item, out)
    else:
        raise ValueError(f"thrift type {typ}")


def _encode_struct(st: _Struct, out: bytearray) -> None:
    last = 0
    for fid, typ, value in st.fields:
        if typ in (_T_TRUE, _T_FALSE):
            typ = _T_TRUE if value else _T_FALSE
        delta = fid - last
        if 0 < delta <= 15:
            out.append((delta << 4) | typ)
        else:
            out.append(typ)
            out += _varint(_zigzag(fid))
        if typ not in (_T_TRUE, _T_FALSE):
            _encode_value(typ, value, out)
        last = fid
    out.append(0)


def _thrift(st: _Struct) -> bytes:
    out = bytearray()
    _encode_struct(st, out)
    return bytes(out)


class _ThriftReader:
    """Decodes a compact-protocol struct into {field id: value}; lists are
    Python lists, nested structs dicts."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def _byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def _varint(self) -> int:
        shift = result = 0
        while True:
            b = self._byte()
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7

    def _int(self) -> int:
        n = self._varint()
        return (n >> 1) ^ -(n & 1)

    def value(self, typ):
        if typ == _T_TRUE:
            return True
        if typ == _T_FALSE:
            return False
        if typ == _T_I8:
            return struct.unpack("<b", bytes([self._byte()]))[0]
        if typ in (_T_I16, _T_I32, _T_I64):
            return self._int()
        if typ == _T_DOUBLE:
            v, = struct.unpack_from("<d", self.data, self.pos)
            self.pos += 8
            return v
        if typ == _T_BINARY:
            n = self._varint()
            v = self.data[self.pos: self.pos + n]
            self.pos += n
            return v
        if typ in (_T_LIST, _T_SET):
            head = self._byte()
            n, elem = head >> 4, head & 15
            if n == 15:
                n = self._varint()
            if elem in (_T_TRUE, _T_FALSE):  # booleans in lists: one byte
                return [self._byte() == 1 for _ in range(n)]
            return [self.value(elem) for _ in range(n)]
        if typ == _T_MAP:
            n = self._varint()
            if n == 0:
                return {}
            kv = self._byte()
            return {self.value(kv >> 4): self.value(kv & 15)
                    for _ in range(n)}
        if typ == _T_STRUCT:
            return self.struct()
        raise ValueError(f"thrift type {typ}")

    def struct(self) -> dict:
        out, last = {}, 0
        while True:
            head = self._byte()
            if head == 0:
                return out
            typ = head & 15
            fid = last + (head >> 4) if head >> 4 else self._int()
            out[fid] = self.value(typ)
            last = fid


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

class _Leaf:
    def __init__(self, path, kind, max_def, max_rep):
        self.path, self.kind = path, kind
        self.max_def, self.max_rep = max_def, max_rep


def _schema_elements(schema) -> tuple[list[_Struct], list[_Leaf]]:
    """The flattened SchemaElements (root first) and the leaf columns."""
    elements = [_Struct((4, _T_BINARY, "schema"),
                        (5, _T_I32, len(schema)))]
    leaves: list[_Leaf] = []

    def field(name, typ, path, d, r):
        if isinstance(typ, str):
            logical = converted = None
            if typ == "string":
                converted, logical = _UTF8, _Struct((1, _T_STRUCT, _Struct()))
            elif typ == "int16":
                converted = _INT_16
                logical = _Struct((10, _T_STRUCT, _Struct(
                    (1, _T_I8, 16), (2, _T_TRUE, True))))
            elements.append(_Struct(
                (1, _T_I32, _PRIMITIVES[typ]), (3, _T_I32, _OPTIONAL),
                (4, _T_BINARY, name), (6, _T_I32, converted),
                (10, _T_STRUCT, logical)))
            leaves.append(_Leaf(path + [name], typ, d + 1, r))
        elif typ[0] == "list":
            elements.append(_Struct(
                (3, _T_I32, _OPTIONAL), (4, _T_BINARY, name),
                (5, _T_I32, 1), (6, _T_I32, _LIST),
                (10, _T_STRUCT, _Struct((3, _T_STRUCT, _Struct())))))
            elements.append(_Struct((3, _T_I32, _REPEATED),
                                    (4, _T_BINARY, "list"), (5, _T_I32, 1)))
            field("element", typ[1], path + [name, "list"], d + 2, r + 1)
        else:
            elements.append(_Struct((3, _T_I32, _OPTIONAL),
                                    (4, _T_BINARY, name),
                                    (5, _T_I32, len(typ[1]))))
            for child, ctype in typ[1]:
                field(child, ctype, path + [name], d + 1, r)

    for name, typ in schema:
        field(name, typ, [], 0, 0)
    return elements, leaves


def _shred(typ, value, r: int, d: int, depth: int, out: list, at: int) -> int:
    """Append (repetition, definition, value) of ``value`` (a field of
    ``typ`` at definition depth ``d`` and repetition depth ``depth``) to
    the leaf lists out[at:], returning the index after its leaves."""
    n = _leaf_count(typ)
    if value is None:
        for k in range(at, at + n):
            out[k].append((r, d, None))
        return at + n
    if isinstance(typ, str):
        out[at].append((r, d + 1, value))
        return at + 1
    if typ[0] == "struct":
        k = at
        for name, ctype in typ[1]:
            k = _shred(ctype, value.get(name), r, d + 1, depth, out, k)
        return k
    if len(value) == 0:
        for k in range(at, at + n):
            out[k].append((r, d + 1, None))
        return at + n
    for i, item in enumerate(value):
        _shred(typ[1], item, r if i == 0 else depth + 1, d + 2, depth + 1,
               out, at)
    return at + n


def _leaf_count(typ) -> int:
    if isinstance(typ, str):
        return 1
    if typ[0] == "list":
        return _leaf_count(typ[1])
    return sum(_leaf_count(t) for _, t in typ[1])


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _rle_levels(levels: list[int], max_level: int) -> bytes:
    """The RLE/bit-packed hybrid of ``levels`` as runs of RLE, with the
    4-byte length prefix of a v1 data page."""
    width = (max(1, (max_level).bit_length()) + 7) // 8
    out = bytearray()
    i = 0
    while i < len(levels):
        j = i
        while j < len(levels) and levels[j] == levels[i]:
            j += 1
        out += _varint((j - i) << 1) + levels[i].to_bytes(width, "little")
        i = j
    return struct.pack("<I", len(out)) + bytes(out)


def _plain(kind: str, values: list) -> bytes:
    if kind == "string":
        out = bytearray()
        for v in values:
            data = v.encode("utf-8")
            out += struct.pack("<I", len(data)) + data
        return bytes(out)
    code = "f" if kind == "float32" else "i"
    return struct.pack(f"<{len(values)}{code}", *values)


def write_table(rows: list[dict], schema, out_path: str | Path,
                compression: str = "gzip") -> None:
    """Write ``rows`` (dicts keyed by the schema's field names; lists as
    Python lists, structs as dicts, None for null) as one row group."""
    codec = _CODECS[compression]
    elements, leaves = _schema_elements(schema)
    columns: list[list] = [[] for _ in leaves]
    for row in rows:
        at = 0
        for name, typ in schema:
            at = _shred(typ, row.get(name), 0, 0, 0, columns, at)
    body = bytearray(MAGIC)
    chunks = []
    for leaf, triples in zip(leaves, columns):
        page = bytearray()
        if leaf.max_rep:
            page += _rle_levels([t[0] for t in triples], leaf.max_rep)
        if leaf.max_def:
            page += _rle_levels([t[1] for t in triples], leaf.max_def)
        page += _plain(leaf.kind, [t[2] for t in triples
                                   if t[1] == leaf.max_def])
        data = gzip.compress(bytes(page), mtime=0) if codec else bytes(page)
        header = _thrift(_Struct(
            (1, _T_I32, 0), (2, _T_I32, len(page)), (3, _T_I32, len(data)),
            (5, _T_STRUCT, _Struct((1, _T_I32, len(triples)),
                                   (2, _T_I32, _PLAIN), (3, _T_I32, _RLE),
                                   (4, _T_I32, _RLE)))))
        offset = len(body)
        body += header + data
        meta = _Struct(
            (1, _T_I32, _PRIMITIVES[leaf.kind]),
            (2, _T_LIST, (_T_I32, [_PLAIN, _RLE])),
            (3, _T_LIST, (_T_BINARY, leaf.path)),
            (4, _T_I32, codec), (5, _T_I64, len(triples)),
            (6, _T_I64, len(header) + len(page)),
            (7, _T_I64, len(header) + len(data)), (9, _T_I64, offset))
        chunks.append((_Struct((2, _T_I64, offset), (3, _T_STRUCT, meta)),
                       len(header) + len(page)))
    row_group = _Struct(
        (1, _T_LIST, (_T_STRUCT, [c for c, _ in chunks])),
        (2, _T_I64, sum(n for _, n in chunks)), (3, _T_I64, len(rows)))
    footer = _thrift(_Struct(
        (1, _T_I32, 2), (2, _T_LIST, (_T_STRUCT, elements)),
        (3, _T_I64, len(rows)), (4, _T_LIST, (_T_STRUCT, [row_group])),
        (6, _T_BINARY, CREATED_BY)))
    body += footer + struct.pack("<I", len(footer)) + MAGIC
    Path(out_path).write_bytes(bytes(body))


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def _read_levels(buf: bytes, pos: int, count: int, max_level: int):
    """(levels, position after them) of a v1 page's length-prefixed
    RLE/bit-packed hybrid block."""
    length, = struct.unpack_from("<I", buf, pos)
    end = pos + 4 + length
    width = max_level.bit_length()
    r = _ThriftReader(buf, pos + 4)
    levels: list[int] = []
    while len(levels) < count and r.pos < end:
        head = r._varint()
        if head & 1:  # bit-packed groups of 8
            n = (head >> 1) * 8
            nbytes = (head >> 1) * width
            bits = int.from_bytes(buf[r.pos: r.pos + nbytes], "little")
            r.pos += nbytes
            levels += [(bits >> (width * i)) & ((1 << width) - 1)
                       for i in range(n)]
        else:
            nb = (width + 7) // 8
            v = int.from_bytes(buf[r.pos: r.pos + nb], "little")
            r.pos += nb
            levels += [v] * (head >> 1)
    return levels[:count], end


def _decode_plain(ptype: int, buf: bytes, pos: int, n: int) -> list:
    if ptype == _BYTE_ARRAY:
        out = []
        for _ in range(n):
            size, = struct.unpack_from("<I", buf, pos)
            out.append(buf[pos + 4: pos + 4 + size])
            pos += 4 + size
        return out
    code = {_INT32: "i", _FLOAT: "f", 2: "q", 5: "d"}.get(ptype)
    if code is None:
        raise NotImplementedError(f"Parquet physical type {ptype} is not "
                                  "read here")
    return list(struct.unpack_from(f"<{n}{code}", buf, pos))


def _file_schema(elements: list[dict]):
    """The SchemaElements back to (name, node) pairs: a node is ("leaf",
    physical type, is string), ("list", node) or ("struct", pairs)."""
    pos = 1

    def node():
        nonlocal pos
        el = elements[pos]
        pos += 1
        name = el[4].decode()
        if 5 not in el:
            return name, ("leaf", el[1], el.get(6) == _UTF8)
        children = [node() for _ in range(el[5])]
        if el.get(6) == _LIST or (10 in el and 3 in el[10]):
            inner = children[0][1]
            return name, ("list", inner[1][0][1] if inner[0] == "struct"
                          else inner)
        return name, ("struct", children)

    return [node() for _ in range(elements[0].get(5, 0))]


def _assemble(node, streams: list, k: int, d: int, depth: int):
    """One value of ``node`` (an optional field at definition depth d)
    from its leaves' level streams (streams[k:], each a list of (r, d, v)
    for this value only). Returns (value, next leaf index)."""
    n = _node_leaves(node)
    first = streams[k][0]
    if first[1] <= d:
        return None, k + n
    if node[0] == "leaf":
        v = first[2]
        return (v.decode("utf-8") if node[2] else v), k + 1
    if node[0] == "struct":
        out, j = {}, k
        for name, child in node[1]:
            out[name], j = _assemble(child, streams, j, d + 1, depth)
        return out, j
    if first[1] == d + 1:
        return [], k + n
    per_leaf = []
    for s in streams[k: k + n]:
        items, cur = [], []
        for t in s:
            if cur and t[0] <= depth + 1:
                items.append(cur)
                cur = []
            cur.append(t)
        items.append(cur)
        per_leaf.append(items)
    values = []
    for i in range(len(per_leaf[0])):
        sub = [items[i] for items in per_leaf]
        v, _ = _assemble(node[1], sub, 0, d + 2, depth + 1)
        values.append(v)
    return values, k + n


def _node_leaves(node) -> int:
    if node[0] == "leaf":
        return 1
    if node[0] == "list":
        return _node_leaves(node[1])
    return sum(_node_leaves(c) for _, c in node[1])


def read_table(path: str | Path) -> list[dict]:
    """The rows of a Parquet file this module writes (PLAIN v1 pages,
    GZIP or no compression), as Python values."""
    buf = Path(path).read_bytes()
    if buf[:4] != MAGIC or buf[-4:] != MAGIC:
        raise ValueError(f"{path} is not a Parquet file")
    size, = struct.unpack_from("<I", buf, len(buf) - 8)
    meta = _ThriftReader(buf, len(buf) - 8 - size).struct()
    schema = _file_schema(meta[2])
    leaves = []
    for name, node in schema:
        stack = [node]
        while stack:
            top = stack.pop(0)
            if top[0] == "leaf":
                leaves.append(top)
            elif top[0] == "list":
                stack.insert(0, top[1])
            else:
                stack[0:0] = [c for _, c in top[1]]
    streams: list[list] = [[] for _ in leaves]
    for group in meta.get(4, []):
        for i, chunk in enumerate(group[1]):
            cm = chunk[3]
            codec = cm[4]
            if codec not in (0, 2):
                raise NotImplementedError(
                    f"{path}: Parquet codec {_CODEC_NAMES.get(codec, codec)} "
                    "is not supported; the port reads GZIP or uncompressed "
                    "files")
            for enc in cm[2]:
                if enc not in (_PLAIN, _RLE, 4):
                    raise NotImplementedError(
                        f"{path}: Parquet encoding "
                        f"{_ENCODING_NAMES.get(enc, enc)} is not supported")
            streams[i] += _read_chunk(buf, cm, _max_levels(meta[2], cm[3]))
    rows = []
    cursors = [0] * len(streams)
    for _ in range(meta[3]):
        record = []
        for i, s in enumerate(streams):
            j = cursors[i] + 1
            while j < len(s) and s[j][0] != 0:
                j += 1
            record.append(s[cursors[i]: j])
            cursors[i] = j
        row, k = {}, 0
        for name, node in schema:
            row[name], k = _assemble(node, record, k, 0, 0)
        rows.append(row)
    return rows


def _max_levels(elements: list[dict], path: list[bytes]) -> tuple[int, int]:
    """(max definition, max repetition) level of the column at ``path``."""
    by_path, pos = {}, 1

    def walk(prefix, d, r):
        nonlocal pos
        el = elements[pos]
        pos += 1
        rep = el.get(3, 0)
        d2 = d + (rep != 0)
        r2 = r + (rep == _REPEATED)
        key = prefix + (el[4],)
        by_path[key] = (d2, r2)
        for _ in range(el.get(5, 0)):
            walk(key, d2, r2)

    for _ in range(elements[0].get(5, 0)):
        walk((), 0, 0)
    return by_path[tuple(path)]


def _read_chunk(buf: bytes, cm: dict, levels: tuple[int, int]) -> list:
    max_def, max_rep = levels
    pos, left, out = cm[9], cm[5], []
    while left > 0:
        reader = _ThriftReader(buf, pos)
        header = reader.struct()
        body = buf[reader.pos: reader.pos + header[3]]
        pos = reader.pos + header[3]
        if header[1] != 0:
            raise NotImplementedError(f"Parquet page type {header[1]} is "
                                      "not supported")
        if cm[4] == 2:
            body = gzip.decompress(body)
        dph = header[5]
        n = dph[1]
        if dph[2] != _PLAIN:
            raise NotImplementedError(
                "Parquet encoding "
                f"{_ENCODING_NAMES.get(dph[2], dph[2])} is not supported")
        p = 0
        reps = [0] * n
        defs = [max_def] * n
        if max_rep:
            reps, p = _read_levels(body, p, n, max_rep)
        if max_def:
            defs, p = _read_levels(body, p, n, max_def)
        values = iter(_decode_plain(cm[1], body, p,
                                    sum(d == max_def for d in defs)))
        out += [(r, d, next(values) if d == max_def else None)
                for r, d in zip(reps, defs)]
        left -= n
    return out


# ---------------------------------------------------------------------------
# The JAX package's functions
# ---------------------------------------------------------------------------

def bboxes_to_pyarrow(bboxes) -> list[dict]:
    return [{"x": x, "y": y, "w": w, "h": h} for (x, y, w, h) in bboxes]


def contours_to_arrow(contours) -> list[list[dict]]:
    return [[{"x": x, "y": y} for x, y in contour] for contour in contours]


def write_result_parquet(result: dict, out_dir: str | Path,
                         compression: str = "gzip") -> str:
    """Detection result -> ``<out_dir>/<image stem>.parquet``, one row of
    LINE_DETECTION_SCHEMA (reference: BDRC/utils.py:1119-1139)."""
    os.makedirs(out_dir, exist_ok=True)
    base_name, _ = os.path.splitext(result["image_name"])
    row = {
        "image_name": result["image_name"],
        "image_width": result["image_width"],
        "image_height": result["image_height"],
        "num_contours": result["num_contours"],
        "contours": contours_to_arrow(result["contours"]),
        "bboxes": bboxes_to_pyarrow(result["bboxes"]),
    }
    out_path = os.path.join(out_dir, f"{base_name}.parquet")
    write_table([row], LINE_DETECTION_SCHEMA, out_path, compression)
    return out_path


def read_result_parquet(path: str | Path) -> dict:
    """Inverse of write_result_parquet: contours as lists of (x, y),
    bboxes as (x, y, w, h) tuples."""
    row = read_table(path)[0]
    row["contours"] = [
        [(p["x"], p["y"]) for p in contour] for contour in row["contours"]
    ]
    row["bboxes"] = [(b["x"], b["y"], b["w"], b["h"]) for b in row["bboxes"]]
    return row


def save_ocr_lines_parquet(ocr_lines, out_path: str | Path,
                           compression: str = "gzip") -> None:
    """Eval-mode OCR lines -> OCR_LINES_SCHEMA rows (reference:
    BDRC/utils.py:1240-1292)."""
    rows = [{
        "guid": str(line.guid),
        "text": line.text,
        "encoding": line.encoding,
        "ctc_conf": float(line.ctc_conf) if line.ctc_conf else 0.0,
        "norm_logp": float(getattr(line, "norm_logp", 0.0)),
        "n_beams": len(line.logits) if line.logits else 0,
        "logits": line.logits,
        "lm_scores": line.lm_scores,
    } for line in ocr_lines]
    write_table(rows, OCR_LINES_SCHEMA, out_path, compression)
