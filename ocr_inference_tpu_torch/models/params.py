"""Flax msgpack checkpoints -> PyTorch state dicts.

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
  running_mean/running_var (eps 1e-5 is set on the modules).
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


def load_meta(path: str | Path) -> dict:
    """The ``<weights>.json`` sidecar (architecture geometry, charset), or
    {} when absent (models/params.py load_meta)."""
    meta = Path(str(path) + ".json")
    if meta.is_file():
        return json.loads(meta.read_text(encoding="utf-8"))
    return {}


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


def params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """Flax variables {"params": ..., "batch_stats": ...} -> state_dict for
    the port's modules, keys ordered numerically (ConvBN_2 before
    ConvBN_10)."""
    out: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _leaves(tree.get(collection, {})):
            *modules, leaf = path
            owner = modules[-1] if modules else ""
            if owner.startswith("BatchNorm_"):
                name = _BN_NAMES[(collection, leaf)]
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


def flax_shapes(module: torch.nn.Module) -> dict:
    """The Flax variable tree's shapes for one of the port's modules, the
    inverse of ``params_from_flax``: {"params": {...}, "batch_stats":
    {...}} with a shape tuple at each leaf (conv kernels HWIO / WIO, dense
    kernels (in, out))."""
    tree: dict = {}
    for key, t in module.state_dict().items():
        *modules, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        shape = tuple(t.shape)
        owner = modules[-1] if modules else ""
        if owner.startswith("BatchNorm_"):
            collection, leaf = _FLAX_BN[name]
        elif name == "weight" and owner.startswith("Dense_"):
            collection, leaf, shape = "params", "kernel", shape[::-1]
        elif name == "weight":  # OIHW -> HWIO, OIW -> WIO
            collection, leaf = "params", "kernel"
            shape = shape[2:] + (shape[1], shape[0])
        else:
            collection, leaf = "params", name
        node = tree.setdefault(collection, {})
        for m in modules:
            node = node.setdefault(m, {})
        node[leaf] = shape
    return tree


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


def seeded_flax_params(shapes: dict, seed: int) -> dict:
    """Weights for a model the repository has no checkpoint for, drawn
    with numpy alone so both packages can make the same ones: from
    ``np.random.default_rng(seed)``, kernels in the sorted order of their
    Flax paths, each from the Flax default initialiser's distribution
    (lecun normal: a normal truncated at 2 sigma, scaled to variance
    1/fan_in, fan_in = the kernel's size over its output axis); biases 0,
    BatchNorm scale 1 and bias 0, running mean 0 and variance 1. ``shapes``
    is a tree as ``flax_shapes`` gives it; the result is the same tree of
    float32 arrays, in the Flax layout. These are not the weights the JAX
    package's own random init (JAX's PRNG) gives."""
    leaves = sorted(
        ((collection,) + path, shape)
        for collection in shapes
        for path, shape in _leaves(shapes[collection])
    )
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, shape in leaves:
        collection, leaf, owner = path[0], path[-1], path[-2]
        if collection == "params" and leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            std = np.sqrt(1.0 / fan_in) / _TRUNC_STD
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
