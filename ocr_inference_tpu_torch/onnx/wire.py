"""Minimal protobuf wire-format codec for ONNX model files.

A copy of ocr_inference_tpu/onnx/wire.py (standard library and numpy
only). The reference loads and executes ``.onnx`` graphs with the
onnxruntime C++ runtime (reference: BDRC/inference.py:128, 294); the port
parses the ONNX protobuf itself and executes the graph through torch (see
``ocr_inference_tpu_torch.onnx.runner``). The codec also *writes* the same
subset, byte for byte as the JAX package's writer does (the producer name
included), which the tests use to fabricate ONNX files and
``onnx/retroplant.py`` uses to write weights back.

Only the message fields ONNX inference models actually use are mapped; all
unknown fields are skipped (parse) or omitted (write). Field numbers follow
onnx/onnx.proto (ModelProto.graph = 7, opset_import = 8, NodeProto.attribute
= 5, TensorProto.external_data = 13 / data_location = 14, ...); parsing of
exporter-style graphs — packed encodings, external-data sidecars, dim_param
axes, initializers repeated as inputs — is pinned by
tests/test_onnx_golden.py and tests/test_torch_onnx_wire.py against an
independent serializer.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Iterator

# wire types
VARINT = 0
I64 = 1
LEN = 2
I32 = 5


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    if value < 0:
        value &= (1 << 64) - 1  # two's complement, 64-bit
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def iter_fields(buf: bytes) -> Iterator[tuple[int, int, Any]]:
    """Yield (field_number, wire_type, raw_value) triples."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field_no = tag >> 3
        wtype = tag & 0x7
        if wtype == VARINT:
            val, pos = _read_varint(buf, pos)
        elif wtype == I64:
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == I32:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype} at {pos}")
        yield field_no, wtype, val


def field_bytes(field_no: int, payload: bytes) -> bytes:
    return _write_varint((field_no << 3) | LEN) + _write_varint(len(payload)) + payload


def field_varint(field_no: int, value: int) -> bytes:
    return _write_varint((field_no << 3) | VARINT) + _write_varint(value)


def field_string(field_no: int, value: str) -> bytes:
    return field_bytes(field_no, value.encode("utf-8"))


def field_float(field_no: int, value: float) -> bytes:
    return _write_varint((field_no << 3) | I32) + struct.pack("<f", value)


def to_signed(value: int) -> int:
    """Interpret a varint as a signed 64-bit int."""
    if value >= 1 << 63:
        return value - (1 << 64)
    return value


# ---------------------------------------------------------------------------
# ONNX message views (parse side)
# ---------------------------------------------------------------------------

# TensorProto.data_type values
TENSOR_DTYPES = {
    1: "float32",
    2: "uint8",
    3: "int8",
    4: "uint16",
    5: "int16",
    6: "int32",
    7: "int64",
    9: "bool",
    10: "float16",
    11: "float64",
    12: "uint32",
    13: "uint64",
}


@dataclass
class TensorProto:
    name: str = ""
    dims: list[int] = field(default_factory=list)
    data_type: int = 1
    raw_data: bytes = b""
    float_data: list[float] = field(default_factory=list)
    int32_data: list[int] = field(default_factory=list)
    int64_data: list[int] = field(default_factory=list)
    double_data: list[float] = field(default_factory=list)
    # exporter large-model support: data stored in a sidecar file
    # (TensorProto.data_location == EXTERNAL with external_data entries)
    data_location: int = 0
    external_data: dict[str, str] = field(default_factory=dict)

    def resolve_external(self, base_dir) -> None:
        """Load sidecar tensor bytes into raw_data (exporters write large
        initializers to a separate file next to the .onnx; keys per the ONNX
        spec: location, offset, length)."""
        if self.data_location != 1 or self.raw_data:
            return
        from pathlib import Path

        loc = self.external_data.get("location")
        if not loc:
            raise ValueError(f"external tensor {self.name!r} has no location")
        payload = (Path(base_dir) / loc).read_bytes()
        offset = int(self.external_data.get("offset", 0))
        length = self.external_data.get("length")
        end = offset + int(length) if length is not None else len(payload)
        self.raw_data = payload[offset:end]

    def to_numpy(self):
        import numpy as np

        dtype = TENSOR_DTYPES.get(self.data_type)
        if dtype is None:
            raise ValueError(f"unsupported tensor dtype {self.data_type}")
        if self.data_location == 1 and not self.raw_data:
            raise ValueError(
                f"external tensor {self.name!r} not resolved; load the model "
                "through load_model(path) so the sidecar file can be found"
            )
        if self.raw_data:
            arr = np.frombuffer(self.raw_data, dtype=np.dtype(dtype))
        elif self.float_data:
            arr = np.array(self.float_data, dtype=np.float32)
        elif self.int64_data:
            arr = np.array(self.int64_data, dtype=np.int64)
        elif self.int32_data:
            arr = np.array(self.int32_data, dtype=np.int32)
        elif self.double_data:
            arr = np.array(self.double_data, dtype=np.float64)
        else:
            arr = np.zeros(0, dtype=np.dtype(dtype))
        # dims == [] means a scalar tensor, not "leave flat"
        return arr.reshape(self.dims)


def parse_tensor(buf: bytes) -> TensorProto:
    t = TensorProto()
    for fno, wtype, val in iter_fields(buf):
        if fno == 1:
            if wtype == VARINT:
                t.dims.append(to_signed(val))
            else:  # packed
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    t.dims.append(to_signed(v))
        elif fno == 2:
            t.data_type = val
        elif fno == 4:
            if wtype == I32:
                t.float_data.append(struct.unpack("<f", val)[0])
            else:  # packed floats
                t.float_data.extend(
                    struct.unpack(f"<{len(val) // 4}f", val)
                )
        elif fno == 5:
            if wtype == VARINT:
                t.int32_data.append(to_signed(val))
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    t.int32_data.append(to_signed(v))
        elif fno == 7:
            if wtype == VARINT:
                t.int64_data.append(to_signed(val))
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    t.int64_data.append(to_signed(v))
        elif fno == 8:
            t.name = val.decode("utf-8")
        elif fno == 9:
            t.raw_data = val
        elif fno == 13:  # external_data: StringStringEntryProto
            key = value = ""
            for f2, _, v2 in iter_fields(val):
                if f2 == 1:
                    key = v2.decode("utf-8")
                elif f2 == 2:
                    value = v2.decode("utf-8")
            if key:
                t.external_data[key] = value
        elif fno == 14:
            t.data_location = val
        elif fno == 10:
            if wtype == I64:
                t.double_data.append(struct.unpack("<d", val)[0])
            else:
                t.double_data.extend(
                    struct.unpack(f"<{len(val) // 8}d", val)
                )
    return t


# AttributeProto.type values
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR, ATTR_GRAPH = 1, 2, 3, 4, 5
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8


@dataclass
class Attribute:
    name: str = ""
    type: int = 0
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: TensorProto | None = None
    floats: list[float] = field(default_factory=list)
    ints: list[int] = field(default_factory=list)
    strings: list[bytes] = field(default_factory=list)
    g: "Graph | None" = None

    @property
    def value(self):
        if self.type == ATTR_FLOAT:
            return self.f
        if self.type == ATTR_INT:
            return self.i
        if self.type == ATTR_STRING:
            return self.s.decode("utf-8")
        if self.type == ATTR_TENSOR:
            return self.t.to_numpy()
        if self.type == ATTR_FLOATS:
            return list(self.floats)
        if self.type == ATTR_INTS:
            return list(self.ints)
        if self.type == ATTR_STRINGS:
            return [s.decode("utf-8") for s in self.strings]
        if self.type == ATTR_GRAPH:
            return self.g
        return None


def parse_attribute(buf: bytes) -> Attribute:
    a = Attribute()
    for fno, wtype, val in iter_fields(buf):
        if fno == 1:
            a.name = val.decode("utf-8")
        elif fno == 2:
            a.f = struct.unpack("<f", val)[0]
        elif fno == 3:
            a.i = to_signed(val)
        elif fno == 4:
            a.s = val
        elif fno == 5:
            a.t = parse_tensor(val)
        elif fno == 6:
            a.g = parse_graph(val)
        elif fno == 7:
            if wtype == I32:
                a.floats.append(struct.unpack("<f", val)[0])
            else:
                a.floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif fno == 8:
            if wtype == VARINT:
                a.ints.append(to_signed(val))
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    a.ints.append(to_signed(v))
        elif fno == 9:
            a.strings.append(val)
        elif fno == 20:
            a.type = val
    return a


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    domain: str = ""
    inputs: list[str] = field(default_factory=list)
    outputs: list[str] = field(default_factory=list)
    attributes: dict[str, Attribute] = field(default_factory=dict)

    def attr(self, name: str, default=None):
        a = self.attributes.get(name)
        return a.value if a is not None else default


def parse_node(buf: bytes) -> Node:
    n = Node()
    for fno, _, val in iter_fields(buf):
        if fno == 1:
            n.inputs.append(val.decode("utf-8"))
        elif fno == 2:
            n.outputs.append(val.decode("utf-8"))
        elif fno == 3:
            n.name = val.decode("utf-8")
        elif fno == 4:
            n.op_type = val.decode("utf-8")
        elif fno == 5:  # AttributeProto (onnx.proto: NodeProto.attribute = 5)
            a = parse_attribute(val)
            n.attributes[a.name] = a
        elif fno == 7:
            n.domain = val.decode("utf-8")
    return n


@dataclass
class ValueInfo:
    name: str = ""
    elem_type: int = 1
    shape: list[int | str | None] = field(default_factory=list)


def _parse_value_info(buf: bytes) -> ValueInfo:
    vi = ValueInfo()
    for fno, _, val in iter_fields(buf):
        if fno == 1:
            vi.name = val.decode("utf-8")
        elif fno == 2:  # TypeProto
            for f2, _, v2 in iter_fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in iter_fields(v2):
                        if f3 == 1:
                            vi.elem_type = v3
                        elif f3 == 2:  # TensorShapeProto
                            for f4, _, v4 in iter_fields(v3):
                                if f4 == 1:  # Dimension
                                    dim_val: int | str | None = None
                                    for f5, _, v5 in iter_fields(v4):
                                        if f5 == 1:
                                            dim_val = to_signed(v5)
                                        elif f5 == 2:
                                            dim_val = v5.decode("utf-8")
                                    vi.shape.append(dim_val)
    return vi


@dataclass
class Graph:
    name: str = ""
    nodes: list[Node] = field(default_factory=list)
    initializers: dict[str, TensorProto] = field(default_factory=dict)
    inputs: list[ValueInfo] = field(default_factory=list)
    outputs: list[ValueInfo] = field(default_factory=list)


def parse_graph(buf: bytes) -> Graph:
    g = Graph()
    for fno, _, val in iter_fields(buf):
        if fno == 1:
            g.nodes.append(parse_node(val))
        elif fno == 2:
            g.name = val.decode("utf-8")
        elif fno == 5:
            t = parse_tensor(val)
            g.initializers[t.name] = t
        elif fno == 11:
            g.inputs.append(_parse_value_info(val))
        elif fno == 12:
            g.outputs.append(_parse_value_info(val))
    return g


@dataclass
class Model:
    ir_version: int = 0
    producer: str = ""
    opset: int = 0
    graph: Graph = field(default_factory=Graph)


def parse_model(buf: bytes) -> Model:
    m = Model()
    for fno, _, val in iter_fields(buf):
        if fno == 1:
            m.ir_version = val
        elif fno == 2:
            m.producer = val.decode("utf-8")
        elif fno == 7:  # GraphProto (onnx.proto: ModelProto.graph = 7)
            m.graph = parse_graph(val)
        elif fno == 8:  # OperatorSetIdProto (ModelProto.opset_import = 8)
            domain = ""
            version = 0
            for f2, _, v2 in iter_fields(val):
                if f2 == 1:
                    domain = v2.decode("utf-8")
                elif f2 == 2:
                    version = to_signed(v2)
            # only the default ai.onnx domain decides op semantics;
            # exporter extras (ai.onnx.ml, com.microsoft) must not skew it
            if domain in ("", "ai.onnx"):
                m.opset = max(m.opset, version)
    return m


def _resolve_graph_external(graph: Graph, base_dir) -> None:
    for t in graph.initializers.values():
        t.resolve_external(base_dir)
    for node in graph.nodes:
        for a in node.attributes.values():
            if a.t is not None:
                a.t.resolve_external(base_dir)
            if a.g is not None:
                _resolve_graph_external(a.g, base_dir)


def tensor_from_numpy(name: str, arr) -> TensorProto:
    """TensorProto carrying a numpy array as raw_data."""
    import numpy as np

    arr = np.ascontiguousarray(arr)
    rev = {v: k for k, v in TENSOR_DTYPES.items()}
    dt = rev.get(str(arr.dtype))
    if dt is None:
        raise ValueError(f"unsupported numpy dtype {arr.dtype}")
    t = TensorProto(name=name, dims=list(arr.shape), data_type=dt)
    t.raw_data = arr.tobytes()
    return t


def fold_dequantize(graph: Graph) -> int:
    """Fold DequantizeLinear nodes whose inputs are all initializers into
    plain float32 initializers under the node's output name.

    This is how quantized checkpoints (int8 weights + per-tensor or
    per-channel scale/zero-point — the standard HF size-reduction export of
    the reference's model repos, Config.py:18-35) become transparent to the
    executor AND the weight transplanter: after folding, the graph looks
    like an fp32 checkpoint. QDQ pairs on activations (non-initializer
    data input) are left for the runtime ops. Returns the folded count."""
    import numpy as np

    inits = graph.initializers
    kept = []
    n_folded = 0
    for node in graph.nodes:
        if node.op_type == "DequantizeLinear" and all(
            (not name) or name in inits for name in node.inputs
        ):
            x = inits[node.inputs[0]].to_numpy().astype(np.float32)
            scale = inits[node.inputs[1]].to_numpy().astype(np.float32)
            zp = (
                inits[node.inputs[2]].to_numpy().astype(np.float32)
                if len(node.inputs) > 2 and node.inputs[2]
                else None
            )
            if scale.ndim >= 1 and scale.size > 1:  # per-channel
                a = node.attributes.get("axis")
                axis = int(a.value) if a is not None else 1
                shape = [1] * x.ndim
                shape[axis % x.ndim] = -1
                scale = scale.reshape(shape)
                if zp is not None:
                    zp = zp.reshape(shape)
            if zp is not None:
                x = x - zp
            inits[node.outputs[0]] = tensor_from_numpy(
                node.outputs[0], x * scale
            )
            n_folded += 1
        else:
            kept.append(node)
    graph.nodes[:] = kept
    return n_folded


def load_model(path) -> Model:
    from pathlib import Path

    path = Path(path)
    with open(path, "rb") as f:
        model = parse_model(f.read())
    # external-data tensors live relative to the model file
    _resolve_graph_external(model.graph, path.parent)
    # quantized-checkpoint dialect: weight DequantizeLinear folds to fp32
    fold_dequantize(model.graph)
    return model


# ---------------------------------------------------------------------------
# Writer (subset) — used for tests and ONNX export
# ---------------------------------------------------------------------------

def encode_tensor(name: str, array) -> bytes:
    import numpy as np

    arr = np.asarray(array)
    dtype_map = {v: k for k, v in TENSOR_DTYPES.items()}
    out = b""
    for d in arr.shape:
        out += field_varint(1, d)
    out += field_varint(2, dtype_map[str(arr.dtype)])
    out += field_string(8, name)
    out += field_bytes(9, arr.tobytes())
    return out


def encode_attribute(name: str, value) -> bytes:
    import numpy as np

    out = field_string(1, name)
    if isinstance(value, bool):
        out += field_varint(3, int(value)) + field_varint(20, ATTR_INT)
    elif isinstance(value, int):
        out += field_varint(3, value) + field_varint(20, ATTR_INT)
    elif isinstance(value, float):
        out += field_float(2, value) + field_varint(20, ATTR_FLOAT)
    elif isinstance(value, str):
        out += field_bytes(4, value.encode()) + field_varint(20, ATTR_STRING)
    elif isinstance(value, np.ndarray):
        out += field_bytes(5, encode_tensor("", value))
        out += field_varint(20, ATTR_TENSOR)
    elif isinstance(value, (list, tuple)) and value and isinstance(value[0], float):
        for v in value:
            out += field_float(7, v)
        out += field_varint(20, ATTR_FLOATS)
    elif isinstance(value, (list, tuple)):
        for v in value:
            out += field_varint(8, int(v))
        out += field_varint(20, ATTR_INTS)
    else:
        raise TypeError(f"unsupported attribute value {value!r}")
    return out


def encode_node(op_type: str, inputs, outputs, name: str = "", **attrs) -> bytes:
    out = b""
    for i in inputs:
        out += field_string(1, i)
    for o in outputs:
        out += field_string(2, o)
    out += field_string(3, name or op_type)
    out += field_string(4, op_type)
    for k, v in attrs.items():
        out += field_bytes(5, encode_attribute(k, v))
    return out


def encode_value_info(name: str, elem_type: int, shape) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dim = field_string(2, d)
        else:
            dim = field_varint(1, int(d))
        dims += field_bytes(1, dim)
    shape_proto = dims
    tensor_type = field_varint(1, elem_type) + field_bytes(2, shape_proto)
    type_proto = field_bytes(1, tensor_type)
    return field_string(1, name) + field_bytes(2, type_proto)


def encode_model(
    nodes: list[bytes],
    initializers: list[bytes],
    inputs: list[bytes],
    outputs: list[bytes],
    graph_name: str = "graph",
    opset: int = 17,
) -> bytes:
    g = b""
    for n in nodes:
        g += field_bytes(1, n)
    g += field_string(2, graph_name)
    for t in initializers:
        g += field_bytes(5, t)
    for i in inputs:
        g += field_bytes(11, i)
    for o in outputs:
        g += field_bytes(12, o)
    opset_proto = field_varint(2, opset)
    return (
        field_varint(1, 8)  # ir_version
        + field_string(2, "ocr_inference_tpu")
        + field_bytes(7, g)  # ModelProto.graph = 7
        + field_bytes(8, opset_proto)  # ModelProto.opset_import = 8
    )


# ---------------------------------------------------------------------------
# In-place weight surgery: splice new initializer values into model bytes
# ---------------------------------------------------------------------------

def _emit_field(field_no: int, wtype: int, val) -> bytes:
    """Re-serialize a field exactly as iter_fields decoded it."""
    if wtype == VARINT:
        return field_varint(field_no, val)
    if wtype == LEN:
        return field_bytes(field_no, val)
    # I64 / I32: iter_fields kept the raw little-endian payload bytes
    return _write_varint((field_no << 3) | wtype) + val


def _rewrite_node_inputs(nbuf: bytes, renames: dict[int, str]) -> bytes:
    """Re-encode a NodeProto with the ``renames``-indexed input strings
    (position among the repeated ``input`` fields) pointing at new names."""
    out = []
    pos = 0
    for fno, wtype, val in iter_fields(nbuf):
        if fno == 1 and wtype == LEN:  # NodeProto.input
            new = renames.get(pos)
            out.append(
                field_string(1, new) if new is not None
                else _emit_field(fno, wtype, val)
            )
            pos += 1
        else:
            out.append(_emit_field(fno, wtype, val))
    return b"".join(out)


def replace_initializers(
    model_bytes: bytes,
    arrays: dict,
    additions: dict | None = None,
    input_renames: dict | None = None,
) -> bytes:
    """Return new ONNX model bytes with the named graph initializers
    re-encoded to hold ``arrays``' values; every other byte of the model
    (nodes, attributes, value infos, unknown fields) is preserved verbatim.

    Used by onnx.retroplant to write natively trained Flax weights back
    into a real exporter-produced checkpoint without reconstructing the
    graph. Shapes must match the existing slots; values are cast to each
    slot's stored dtype. Raises KeyError for names not present as
    initializers.

    ``additions`` appends brand-new initializers ``{name: array}`` (the
    array's own dtype is stored), and ``input_renames`` re-points node
    inputs ``{(node_index, input_position): new_name}`` — together they
    de-alias initializers the exporter deduplicated by value (several BN
    layers' identical fresh statistics sharing one tensor slot) so each
    consumer can receive its own written-back weights.
    """
    import numpy as np

    remaining = dict(arrays)
    node_renames: dict[int, dict[int, str]] = {}
    for (node_idx, input_pos), new_name in (input_renames or {}).items():
        node_renames.setdefault(node_idx, {})[input_pos] = new_name

    def rewrite_graph(gbuf: bytes) -> bytes:
        out = []
        node_idx = 0
        for fno, wtype, val in iter_fields(gbuf):
            if fno == 1 and wtype == LEN:  # GraphProto.node
                if node_idx in node_renames:
                    out.append(
                        field_bytes(
                            1, _rewrite_node_inputs(val, node_renames[node_idx])
                        )
                    )
                    node_idx += 1
                    continue
                node_idx += 1
            elif fno == 5 and wtype == LEN:  # GraphProto.initializer
                t = parse_tensor(val)
                if t.name in remaining:
                    arr = np.asarray(remaining.pop(t.name))
                    if list(arr.shape) != list(t.dims):
                        raise ValueError(
                            f"initializer {t.name!r}: new shape "
                            f"{tuple(arr.shape)} != slot shape {tuple(t.dims)}"
                        )
                    slot_dtype = TENSOR_DTYPES.get(t.data_type)
                    if slot_dtype is None:
                        raise ValueError(
                            f"initializer {t.name!r}: unsupported slot "
                            f"dtype {t.data_type}"
                        )
                    out.append(
                        field_bytes(5, encode_tensor(t.name, arr.astype(slot_dtype)))
                    )
                    continue
            out.append(_emit_field(fno, wtype, val))
        for name, arr in (additions or {}).items():
            out.append(field_bytes(5, encode_tensor(name, np.asarray(arr))))
        return b"".join(out)

    out = []
    for fno, wtype, val in iter_fields(model_bytes):
        if fno == 7 and wtype == LEN:  # ModelProto.graph
            out.append(field_bytes(7, rewrite_graph(val)))
        else:
            out.append(_emit_field(fno, wtype, val))
    if remaining:
        raise KeyError(
            "names not found among graph initializers: "
            + ", ".join(sorted(remaining))
        )
    return b"".join(out)
