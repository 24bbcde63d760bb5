"""Flax msgpack checkpoints <-> PyTorch state dicts, and the parameter
lifecycle (init, save, load).

Counterpart of ocr_inference_tpu/models/params.py. The JAX package writes
weights with ``flax.serialization.to_bytes``: a msgpack map of maps whose
leaves are numpy arrays packed as ExtType 1 = msgpack((shape, dtype_name,
raw bytes)) (flax/serialization.py ``_ndarray_to_bytes``). ``read_msgpack``
decodes that format with ``struct`` alone — the card machine has neither
``msgpack`` nor flax — and ``params_from_flax`` carries the tree across:

- paths keep Flax's module names (``ConvBN_10/Conv_0/kernel``), which the
  port's modules reproduce, so no positional matching and no sort of
  ``ConvBN_10`` before ``ConvBN_2`` can misplace a layer;
- conv kernels go HWIO -> OIHW (1-D: WIO -> OIW), dense kernels are
  transposed, BatchNorm scale/bias/mean/var become weight/bias/
  running_mean/running_var (eps 1e-5 is set on the modules), LayerNorm
  scale becomes weight;
- attention projections (``MultiHeadDotProductAttention_k/query|key|
  value|out``) become Linear weights: the (C, heads, d) kernels and
  (heads, d) biases flatten heads-major to (heads * d, C) and (heads * d,),
  the (heads, d, C) output kernel to (C, heads * d);
- the four GRU cells of a CRNN (``GRUCell_0..3``: layer 0 forward,
  backward, layer 1 forward, backward) become one bidirectional two-layer
  ``nn.GRU`` named ``BiGRU``: gates in torch's r, z, n order, the input
  side's biases of ir/iz/in in ``bias_ih``, ``bias_hh`` zero for r and z
  and ``hn``'s bias for n (Flax's ``r * (hn(h) + b_hn)`` is torch's
  ``r * (W_hn h + b_hn)``).
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos: self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("arr", ">H"), 0xDD: ("arr", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
        }
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode("utf-8")
            if kind == "arr":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack(">b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack(">b"), fixext[b])
        numeric = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in numeric:
            return self.unpack(numeric[b])
        raise ValueError(f"unsupported msgpack byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code == 1:  # ndarray: (shape, dtype name, raw bytes)
            shape, dtype, raw = _Reader(payload).value()
            return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        if code == 3:  # numpy scalar: (dtype name, raw bytes)
            dtype, raw = _Reader(payload).value()
            return np.frombuffer(raw, dtype=np.dtype(dtype))[0]
        raise ValueError(f"unsupported msgpack ext type {code}")


def read_msgpack(path: str | Path) -> dict:
    """Decode a ``flax.serialization.to_bytes`` file into nested dicts of
    numpy arrays (the tree ``flax.serialization.msgpack_restore`` gives)."""
    data = Path(path).read_bytes()
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{path}: trailing bytes after the msgpack tree")
    return tree


def _pack_header(out: bytearray, n: int, fix: int | None, fix_max: int,
                 codes: tuple[int, ...]) -> None:
    """A msgpack length header: the fix form below ``fix_max``, else the
    8/16/32-bit form (``codes``, the 8-bit one may be absent)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I")[3 - len(codes):],
                                (0xFF, 0xFFFF, 0xFFFFFFFF)[3 - len(codes):]):
        if n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack(obj, out: bytearray) -> None:
    """msgpack of ``obj`` as ``msgpack.packb(obj, use_bin_type=True)``
    writes it; numpy arrays as flax's ExtType 1; dict keys sorted, as
    ``jax.tree.map`` leaves the tree that flax serialises."""
    if isinstance(obj, dict):
        _pack_header(out, len(obj), 0x80, 15, (0xDE, 0xDF))
        for k in sorted(obj):
            _pack(str(k), out)
            _pack(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        _pack_header(out, len(obj), 0x90, 15, (0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_header(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, bytes):
        _pack_header(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (int, np.integer)) and 0 <= obj:
        n = int(obj)
        if n <= 0x7F:
            out.append(n)
        else:
            for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                     (0xCE, ">I", 0xFFFFFFFF),
                                     (0xCF, ">Q", 2 ** 64 - 1)):
                if n <= limit:
                    out.append(code)
                    out += struct.pack(fmt, n)
                    break
    elif isinstance(obj, np.ndarray):
        payload = bytearray()
        _pack((list(obj.shape), obj.dtype.name,
               np.ascontiguousarray(obj).tobytes()), payload)
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _pack_header(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", 1)
        out += payload
    else:
        raise TypeError(f"cannot serialise {type(obj).__name__}")


def to_bytes(tree: dict) -> bytes:
    """``flax.serialization.to_bytes`` of a tree of numpy arrays (or
    tensors), byte for byte."""
    out = bytearray()
    _pack(_map_leaves(tree, _host), out)
    return bytes(out)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _variables(variables) -> dict:
    """A Flax variables tree, or a module's (``flax_variables``)."""
    if isinstance(variables, torch.nn.Module):
        return flax_variables(variables)
    return variables


def save_params(variables, path: str | Path, meta: dict | None = None) -> None:
    """Write ``variables`` (a Flax tree, or one of the port's modules) to
    ``path`` as ``flax.serialization.to_bytes`` writes it, and ``meta``,
    when given, to the ``<path>.json`` sidecar (models/params.py:37-46).
    The JAX ``load_params`` reads the file, and ``read_msgpack`` reads the
    JAX package's."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(to_bytes(_variables(variables)))
    if meta is not None:
        Path(str(path) + ".json").write_text(json.dumps(meta, indent=2),
                                             encoding="utf-8")


def _restore(template: dict, loaded: dict, where: str) -> dict:
    out = {}
    for k, want in template.items():
        if k not in loaded:
            raise ValueError(f"checkpoint lacks {where}{k}")
        got = loaded[k]
        if isinstance(want, dict):
            out[k] = _restore(want, got, f"{where}{k}/")
        else:
            if tuple(np.shape(got)) != tuple(np.shape(want)):
                raise ValueError(
                    f"{where}{k}: checkpoint shape {np.shape(got)}, "
                    f"template {np.shape(want)}")
            out[k] = got
    extra = set(loaded) - set(template)
    if extra:
        raise ValueError(f"checkpoint has unexpected {where}{sorted(extra)}")
    return out


def load_params(template, path: str | Path):
    """Read a msgpack checkpoint (models/params.py:49-52). ``template`` is
    a Flax variables tree, and the checkpoint's tree with its structure
    and shapes is returned (a mismatch raises ValueError); or one of the
    port's modules, which is loaded in place and returned."""
    tree = read_msgpack(path)
    if isinstance(template, torch.nn.Module):
        load_flax_tree(template, tree, str(path))
        return template
    return _restore(template, tree, "")


def load_meta(path: str | Path) -> dict | None:
    """The ``<weights>.json`` sidecar (architecture geometry, charset), or
    None when absent (models/params.py:55-59)."""
    meta = Path(str(path) + ".json")
    if meta.is_file():
        return json.loads(meta.read_text(encoding="utf-8"))
    return None


def param_count(variables) -> int:
    """Elements in a Flax variables tree or a module's, batch statistics
    included (models/params.py:62)."""
    return int(sum(int(np.prod(np.shape(a)))
                   for _, a in _leaves(_variables(variables))))


def init_recognizer(model: torch.nn.Module, input_height: int = 80,
                    width: int = 256, seed: int = 0) -> dict:
    """Fresh Flax variables for a recognizer (models/params.py:31-34):
    ``seeded_flax_params`` of its tree, numpy draws from the Flax
    initialisers' distributions, not JAX's PRNG bits. ``input_height`` and
    ``width`` are the JAX signature's; the module fixes the shapes."""
    return seeded_flax_params(flax_shapes(model), seed)


def init_segmentation(model: torch.nn.Module, patch_size: int = 512,
                      seed: int = 0) -> dict:
    """Fresh Flax variables for a segmentation net (models/params.py:
    25-28), as ``init_recognizer`` draws them."""
    return seeded_flax_params(flax_shapes(model), seed)


def _leaves(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _natural_key(key: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", key)]


_BN_NAMES = {
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}
_ATTENTION_IN = ("query", "key", "value")
_GRU = "BiGRU"
_GATES_I, _GATES_H = ("ir", "iz", "in"), ("hr", "hz", "hn")


def _is_attention(modules) -> bool:
    return len(modules) >= 2 and modules[-2].startswith(
        "MultiHeadDotProductAttention_")


def _gru_key(prefix: list, cell: str, name: str) -> str:
    """GRUCell_k's weight ``name`` (weight_ih, ...) -> the BiGRU key:
    layer k // 2, the reverse direction for odd k."""
    k = int(cell.split("_")[1])
    suffix = f"_l{k // 2}" + ("_reverse" if k % 2 else "")
    return ".".join(prefix + [_GRU, name + suffix])


def _gru_params(prefix: list, cell: str, gates: dict) -> dict:
    """One Flax GRUCell's {gate: {kernel, bias}} -> its four BiGRU
    tensors."""
    try:
        w_ih = np.concatenate([gates[g]["kernel"].T for g in _GATES_I])
        w_hh = np.concatenate([gates[g]["kernel"].T for g in _GATES_H])
        b_ih = np.concatenate([gates[g]["bias"] for g in _GATES_I])
        b_hn = gates["hn"]["bias"]
    except KeyError as e:
        raise KeyError(f"{'/'.join(prefix + [cell])}: missing {e}") from None
    extra = set(gates) - set(_GATES_I + _GATES_H)
    if extra or "bias" in gates["hr"] or "bias" in gates["hz"]:
        raise KeyError(f"unmapped GRU leaves under {cell}: {sorted(extra)}")
    b_hh = np.concatenate([np.zeros_like(b_hn), np.zeros_like(b_hn), b_hn])
    return {_gru_key(prefix, cell, n): a for n, a in (
        ("weight_ih", w_ih), ("weight_hh", w_hh), ("bias_ih", b_ih),
        ("bias_hh", b_hh))}


def _cells(tree: dict, prefix: tuple = ()):
    """Split a params tree into its GRU cells ((module path, cell name,
    gates) triples) and the rest (the tree without them)."""
    rest, cells = {}, []
    for k, v in tree.items():
        if k.startswith("GRUCell_"):
            cells.append((list(prefix), k, v))
        elif isinstance(v, dict):
            sub, found = _cells(v, prefix + (k,))
            rest[k] = sub
            cells += found
        else:
            rest[k] = v
    return rest, cells


def params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """Flax variables {"params": ..., "batch_stats": ...} -> state_dict for
    the port's modules, keys ordered numerically (ConvBN_2 before
    ConvBN_10)."""
    out: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        rest, cells = _cells(tree.get(collection, {}))
        for prefix, cell, gates in cells:
            for key, arr in _gru_params(prefix, cell, gates).items():
                out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
        for path, arr in _leaves(rest):
            *modules, leaf = path
            owner = modules[-1] if modules else ""
            if owner.startswith(("BatchNorm_", "LayerNorm_")):
                name = _BN_NAMES[(collection, leaf)]
            elif _is_attention(modules) and owner in _ATTENTION_IN:
                name = "weight" if leaf == "kernel" else "bias"
                arr = (arr.reshape(arr.shape[0], -1).T if leaf == "kernel"
                       else arr.reshape(-1))
            elif _is_attention(modules) and owner == "out" and \
                    leaf == "kernel":
                name, arr = "weight", arr.reshape(-1, arr.shape[-1]).T
            elif leaf == "kernel" and owner.startswith("Dense_"):
                name, arr = "weight", arr.T
            elif leaf == "kernel":  # Conv: HWIO -> OIHW, WIO -> OIW
                nd = arr.ndim
                name = "weight"
                arr = arr.transpose((nd - 1, nd - 2) + tuple(range(nd - 2)))
            elif leaf == "bias":
                name = "bias"
            else:
                raise KeyError(f"unmapped Flax leaf {'/'.join(path)}")
            key = ".".join(modules + [name])
            out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return {k: out[k] for k in sorted(out, key=_natural_key)}


def load_flax_tree(module: torch.nn.Module, tree: dict,
                   what: str = "weights") -> None:
    """Load Flax variables {"params": ..., "batch_stats": ...} into
    ``module`` (strict: every key of both sides must match, every shape
    must agree)."""
    state = params_from_flax(tree)
    own = module.state_dict()
    missing = [k for k in own if k not in state and "num_batches" not in k]
    unexpected = [k for k in state if k not in own]
    if missing or unexpected:
        raise KeyError(
            f"{what}: missing {missing[:5]}, unexpected {unexpected[:5]}"
        )
    for k, v in state.items():
        if own[k].shape != v.shape:
            raise ValueError(
                f"{what}: {k} has shape {tuple(v.shape)}, module wants "
                f"{tuple(own[k].shape)}"
            )
    module.load_state_dict(state, strict=False)


def load_flax_weights(module: torch.nn.Module, path: str | Path) -> None:
    """Read a Flax msgpack checkpoint into ``module`` (``load_flax_tree``)."""
    load_flax_tree(module, read_msgpack(path), str(path))


_FLAX_BN = {v: k for k, v in _BN_NAMES.items()}


def _gru_leaves(modules: list, name: str, arr: np.ndarray):
    """One BiGRU tensor -> its Flax GRUCell leaves ((collection, path),
    array): the three gates' (in, hidden) kernels or biases; of
    ``bias_hh`` only ``hn``'s bias (Flax's r and z gates have no hidden
    bias)."""
    kind, layer = name.rsplit("_l", 1)
    layer, reverse = layer.split("_")[0], layer.endswith("_reverse")
    cell = f"GRUCell_{2 * int(layer) + int(reverse)}"
    prefix = tuple(modules[:-1]) + (cell,)
    parts = np.split(arr, 3)
    if kind == "weight_ih":
        leaves = zip(_GATES_I, ["kernel"] * 3, [p.T for p in parts])
    elif kind == "weight_hh":
        leaves = zip(_GATES_H, ["kernel"] * 3, [p.T for p in parts])
    elif kind == "bias_ih":
        leaves = zip(_GATES_I, ["bias"] * 3, parts)
    else:
        leaves = [("hn", "bias", parts[2])]
    for gate, leaf, a in leaves:
        yield ("params", prefix + (gate, leaf)), a


def flax_variables(module: torch.nn.Module) -> dict:
    """The Flax variable tree of one of the port's modules, the inverse of
    ``params_from_flax``: {"params": {...}, "batch_stats": {...}} of float32
    numpy arrays in the Flax layouts (conv kernels HWIO / WIO, dense
    kernels (in, out), attention kernels (C, heads, d) / (heads, d, C),
    GRU cells' gates (in, hidden)). A JAX module loads it as its own
    variables."""
    tree: dict = {}

    def put(collection, path, arr):
        node = tree.setdefault(collection, {})
        for m in path[:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = np.ascontiguousarray(arr, dtype=np.float32)

    for key, t in module.state_dict().items():
        *modules, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        # a copy: the tree must not follow later in-place updates
        arr = t.detach().to("cpu", torch.float32).numpy().copy()
        owner = modules[-1] if modules else ""
        if owner == _GRU:
            for (collection, path), a in _gru_leaves(modules, name, arr):
                put(collection, path, a)
            continue
        leaf = name
        collection = "params"
        if owner.startswith(("BatchNorm_", "LayerNorm_")):
            collection, leaf = _FLAX_BN[name]
        elif _is_attention(modules):
            heads = module.get_submodule(".".join(modules[:-1])).heads
            if owner == "out":
                if name == "weight":
                    leaf, arr = "kernel", arr.T.reshape(heads, -1, arr.shape[0])
            elif name == "weight":
                leaf = "kernel"
                arr = arr.T.reshape(arr.shape[1], heads, -1)
            else:
                arr = arr.reshape(heads, -1)
        elif name == "weight" and owner.startswith("Dense_"):
            leaf, arr = "kernel", arr.T
        elif name == "weight":  # OIHW -> HWIO, OIW -> WIO
            leaf = "kernel"
            arr = arr.transpose(tuple(range(2, arr.ndim)) + (1, 0))
        put(collection, tuple(modules) + (leaf,), arr)
    return tree


def _map_leaves(tree: dict, fn) -> dict:
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def flax_shapes(module: torch.nn.Module) -> dict:
    """``flax_variables``'s tree with a shape tuple at each leaf."""
    return _map_leaves(flax_variables(module), lambda a: tuple(a.shape))


# the standard deviation of a unit normal truncated to [-2, 2]
# (jax.nn.initializers.variance_scaling's truncated_normal correction)
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Unit normal draws, each outside [-2, 2] drawn again."""
    out = rng.standard_normal(int(np.prod(shape)))
    bad = np.flatnonzero(np.abs(out) > 2.0)
    while bad.size:
        out[bad] = rng.standard_normal(bad.size)
        bad = bad[np.abs(out[bad]) > 2.0]
    return out.reshape(shape)


def _orthogonal(rng: np.random.Generator, shape) -> np.ndarray:
    """jax.nn.initializers.orthogonal() with numpy: a standard normal
    (rows, cols) matrix (transposed first when rows < cols), Q of its QR
    with the signs of R's diagonal, shaped back."""
    rows, cols = int(np.prod(shape[:-1])), shape[-1]
    a = rng.standard_normal((max(rows, cols), min(rows, cols)))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    if rows < cols:
        q = q.T
    return q.reshape(shape)


def _fan_in(path: tuple, shape) -> int:
    """A kernel's fan-in as Flax's initialisers count it: over the input
    axes, which are all but the last except for an attention projection's
    (C, heads, d) query/key/value kernel, whose input axis is the first."""
    modules = path[1:-1]
    if _is_attention(modules) and modules[-1] in _ATTENTION_IN:
        return int(shape[0])
    return int(np.prod(shape[:-1]))


def seeded_flax_params(shapes: dict, seed: int) -> dict:
    """Weights for a model the repository has no checkpoint for, drawn
    with numpy alone so both packages can make the same ones: from
    ``np.random.default_rng(seed)``, leaves in the sorted order of their
    Flax paths, each from the distribution of the Flax module's default
    initialiser:

    - kernels of convs, Dense layers, attention projections and a GRU
      cell's input gates (ir, iz, in): lecun normal, a normal truncated at
      2 sigma scaled to variance 1/fan_in, fan_in over the kernel's input
      axes (``_fan_in``);
    - a GRU cell's recurrent kernels (hr, hz, hn): orthogonal
      (``_orthogonal``);
    - biases 0, BatchNorm and LayerNorm scale 1 and bias 0, running mean 0
      and variance 1.

    ``shapes`` is a tree as ``flax_shapes`` gives it; the result is the
    same tree of float32 arrays, in the Flax layout. These are not the
    weights the JAX package's own random init (JAX's PRNG) gives."""
    leaves = sorted(
        ((collection,) + path, shape)
        for collection in shapes
        for path, shape in _leaves(shapes[collection])
    )
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, shape in leaves:
        collection, leaf, owner = path[0], path[-1], path[-2]
        recurrent = (owner in _GATES_H and len(path) > 3
                     and path[-3].startswith("GRUCell_"))
        if collection == "params" and leaf == "kernel" and recurrent:
            arr = _orthogonal(rng, shape)
        elif collection == "params" and leaf == "kernel":
            std = np.sqrt(1.0 / _fan_in(path, shape)) / _TRUNC_STD
            arr = _truncated_normal(rng, shape) * std
        elif (collection, leaf) in (("params", "scale"),
                                    ("batch_stats", "var")):
            arr = np.ones(shape)
        elif leaf in ("bias", "mean"):
            arr = np.zeros(shape)
        else:
            raise KeyError(f"no initialiser for {'/'.join(path)} ({owner})")
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[leaf] = arr.astype(np.float32)
    return out
