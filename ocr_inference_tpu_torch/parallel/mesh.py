"""Device mesh runtime: data- and model-parallel execution over the cards
of one process, and process groups across hosts.

Counterpart of ocr_inference_tpu/parallel/mesh.py. The JAX package hands
XLA a ``jax.sharding.Mesh`` and sharding annotations and lets it insert
the collectives; the port does the same work by hand:

- a ``Mesh`` is a (data, model) array of ``torch.device``s. A device may
  repeat: torch has one CPU device, so a CPU mesh of 8 repeats it (what
  the tests run), and one card can stand for several entries;
- a batch splits along dim 0 into one contiguous block per data group,
  as ``P(DATA_AXIS)`` splits it; each block runs on its group's first
  device, on a replica of the parameters there;
- a model axis splits the recognizer head (the top-level ``Conv_0``,
  matched by path) over the group's devices by output feature, and the
  logits are gathered on the group's first device (``replicas.SplitHead``);
- across processes (one per host, as in the JAX package) a
  ``torch.distributed`` group reduces what a step must reduce: the train
  steps' BatchNorm statistics, loss sums and gradients.

Axes:
- ``data``  — pages / tiles / line batches (the dominant axis for OCR
              inference; BASELINE config 5's multi-volume sweep);
- ``model`` — the tensor-parallel axis of the recognizer head.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def distributed_init(device: str | torch.device | None = None) -> None:
    """Join the process group the JAX package's cluster variables name:
    ``JAX_COORDINATOR_ADDRESS`` (or ``COORDINATOR_ADDRESS``, host:port;
    rank 0 listens there), ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``,
    so that one launcher drives both packages. The backend is ``nccl``
    when ``device`` is CUDA (by default: when a card is present) and
    ``gloo`` on the CPU. No-op without an address or when a group already
    exists; an address without the counts raises ValueError."""
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get(
        "COORDINATOR_ADDRESS")
    if not addr or (dist.is_available() and dist.is_initialized()):
        return
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    if nproc is None or pid is None:
        raise ValueError(f"coordinator {addr} given without "
                         "JAX_NUM_PROCESSES and JAX_PROCESS_ID")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    cuda = torch.device(device).type == "cuda"
    kwargs = {}
    if cuda:
        dev = torch.device(device)
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        torch.cuda.set_device(index)
        kwargs["device_id"] = torch.device("cuda", index)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://{addr}",
                            world_size=int(nproc), rank=int(pid), **kwargs)


def process_index() -> int:
    """This process's rank in the group; 0 without one."""
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def process_count() -> int:
    """The group's size; 1 without one."""
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


_process_index, _process_count = process_index, process_count


def local_devices(device_type: str) -> list[torch.device]:
    """This process's devices of a type: every visible card for ``cuda``,
    the one CPU device for ``cpu``."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


class Mesh:
    """A (data, model) array of devices. ``shape`` is ``{"data": dp,
    "model": mp}`` as the JAX mesh's; ``groups[d]`` are the mp devices of
    data group d, the first of which runs the group's forward."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a (data, model) array, got shape "
                             f"{devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.devices.shape[0],
                MODEL_AXIS: self.devices.shape[1]}

    @property
    def groups(self) -> list[list[torch.device]]:
        return [list(row) for row in self.devices]

    @property
    def first_device(self) -> torch.device:
        return self.devices[0, 0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    devices: Optional[Sequence] = None,
    backend: Optional[str] = None,
) -> Mesh:
    """Build a (data, model) mesh over the given or available devices
    (``local_devices(backend)``; by default the cards, or the CPU without
    one). ``model_parallel`` devices per model group, the rest data
    parallel. A device may appear more than once."""
    if devices is None:
        backend = backend or ("cuda" if torch.cuda.is_available() else "cpu")
        devices = local_devices(backend)
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} mesh devices, only {len(devices)} "
                f"available ({[str(d) for d in devices]})")
        devices = devices[:n_devices]
    n = len(devices)
    if n % model_parallel != 0:
        raise ValueError(
            f"{n} devices not divisible by model_parallel={model_parallel}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n // model_parallel, model_parallel))


@dataclass(frozen=True)
class NamedSharding:
    """A placement on a mesh: ``spec`` names, per dim, the mesh axis that
    splits it (None: whole), as a JAX PartitionSpec; ``()`` is
    replicated."""

    mesh: Mesh
    spec: tuple = ()

    def split_dim(self, axis: str) -> Optional[int]:
        return self.spec.index(axis) if axis in self.spec else None


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Split the leading (batch) dim over the data axis, the rest whole."""
    return NamedSharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _feature_dim(key: Optional[str], ndim: int) -> int:
    """The output-feature dim of a parameter: dim 0 of a torch ``weight``
    ((out, in, ...) for the convolutions and linear layers the port's
    heads are), the last dim of anything else (a Flax kernel's, a
    bias's)."""
    return 0 if key is not None and key.split(".")[-1] == "weight" else \
        ndim - 1


def _map_with_path(fn, tree, top=None, leaf_key=None):
    """Map ``fn(top_module, leaf_key, leaf)`` over a tree of dicts, lists
    and tuples. ``top_module`` is the first mapping key's first dotted
    component (the top-level module of a Flax params dict, or of the
    port's ``{name: tensor}`` dicts), skipping sequence wrappers."""
    if isinstance(tree, dict):
        return {k: _map_with_path(
            fn, v, top if top is not None else str(k).split(".")[0], str(k))
            for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, top, leaf_key) for v in tree]
        if hasattr(tree, "_fields"):  # a namedtuple
            return type(tree)(*out)
        return type(tree)(out)
    return fn(top, leaf_key, tree)


def _tp_sharding(mesh: Mesh, head_module: str, top: Optional[str],
                 key: Optional[str], leaf) -> NamedSharding:
    """A leaf's sharding under ``tp_shardings``."""
    tp = mesh.shape[MODEL_AXIS]
    ndim = getattr(leaf, "ndim", 0)
    if tp > 1 and top == head_module and ndim >= 1:
        dim = _feature_dim(key, ndim)
        if leaf.shape[dim] % tp == 0:
            spec = [None] * ndim
            spec[dim] = MODEL_AXIS
            return NamedSharding(mesh, tuple(spec))
    return replicated(mesh)


def tp_shardings(mesh: Mesh, tree: Any, head_module: str = "Conv_0") -> Any:
    """Sharding tree for tensor-parallel recognizer heads.

    Leaves whose top-level module is ``head_module`` (the final
    vocab-width conv of Easter2 — matched by PATH, never by dimension
    size, so hidden layers that share the vocab width are never split)
    get their output-feature dim (``_feature_dim``) split over the model
    axis when it divides evenly; everything else is replicated. Takes a
    Flax params tree (nested dicts) or the port's ``{name: tensor}``
    dicts (``TrainState.params``, ``batch_stats``)."""
    return _map_with_path(
        lambda top, key, leaf: _tp_sharding(mesh, head_module, top, key,
                                            leaf), tree)


def _leaves_map(fn, tree):
    return _map_with_path(lambda _t, _k, leaf: fn(leaf), tree)


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """A tree of host arrays or tensors -> the same tree with each leaf a
    list of dp contiguous blocks of dim 0, block d on data group d's first
    device (as ``P(DATA_AXIS)`` splits it); a 0-d leaf is repeated to
    every group. A batch that does not split evenly raises ValueError."""
    dp = mesh.shape[DATA_AXIS]
    firsts = [g[0] for g in mesh.groups]

    def split(x):
        t = torch.as_tensor(x)
        if t.ndim == 0:
            return [t.to(d) for d in firsts]
        if t.shape[0] % dp:
            raise ValueError(f"a batch of {t.shape[0]} does not split over "
                             f"a data axis of {dp}")
        return [b.to(d) for b, d in zip(t.chunk(dp), firsts)]

    return _leaves_map(split, batch)


def _placed(tree: Any, device: torch.device) -> Any:
    return _leaves_map(lambda x: torch.as_tensor(x).to(device), tree)


def replicate_params(mesh: Mesh, params: Any) -> list:
    """One copy of a tree per mesh entry (row-major over (data, model)),
    made once per distinct device: entries on the same device share it."""
    copies: dict[torch.device, Any] = {}
    out = []
    for dev in mesh.devices.flat:
        if dev not in copies:
            copies[dev] = _placed(params, dev)
        out.append(copies[dev])
    return out


def shard_params_tp(
    mesh: Mesh, variables: Any, head_module: str = "Conv_0"
) -> list:
    """A variables tree placed tensor-parallel, one tree per mesh entry
    (row-major): the head's leaves that ``tp_shardings`` splits hold the
    entry's slice along the model axis, everything else the whole leaf.
    With ``model_parallel=1`` this is ``replicate_params``."""
    mp = mesh.shape[MODEL_AXIS]

    def placed(index: int, dev: torch.device):
        def place(top, key, leaf):
            t = torch.as_tensor(leaf)
            dim = _tp_sharding(mesh, head_module, top, key, t).split_dim(
                MODEL_AXIS)
            if dim is not None:
                t = t.chunk(mp, dim)[index % mp]
            return t.to(dev)

        return _map_with_path(place, variables)

    return [placed(i, dev) for i, dev in enumerate(mesh.devices.flat)]


def pad_to_multiple_of(batch, multiple: int):
    """Pad the batch dim (numpy array or tensor) with zeros so it divides
    the data axis; returns (padded, n_pad)."""
    n = batch.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return batch, 0
    if isinstance(batch, torch.Tensor):
        pad = batch.new_zeros((rem,) + tuple(batch.shape[1:]))
        return torch.cat([batch, pad]), rem
    pad = np.zeros((rem,) + batch.shape[1:], batch.dtype)
    return np.concatenate([batch, pad]), rem


def host_shard(items: Sequence, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> list:
    """Per-host input sharding: host i takes items i, i+P, i+2P, ...

    Used by the batch CLIs across processes so each reads only its share
    of pages. Defaults to the process group's rank and size (0 and 1
    without a group)."""
    pi = _process_index() if process_index is None else process_index
    pc = _process_count() if process_count is None else process_count
    return list(items[pi::pc])


class DataParallelRunner:
    """Run a per-example device function over a mesh-split batch.

    ``fn(params, batch) -> out`` (a batch-leading tensor): params are
    replicated once per device, the batch is padded to a multiple of the
    data-axis size and split, each data group's block runs on its first
    device (launched one after another with no host sync, so the cards
    run together), and the outputs come back concatenated, unpadded, on
    the mesh's first device."""

    def __init__(self, mesh: Mesh, fn: Callable):
        self.mesh = mesh
        self._dp = mesh.shape[DATA_AXIS]
        self._fn = fn

    def __call__(self, params: Any, batch):
        n = batch.shape[0]
        padded, _ = pad_to_multiple_of(batch, self._dp)
        blocks = shard_batch(self.mesh, padded)
        reps = replicate_params(self.mesh, params)
        mp = self.mesh.shape[MODEL_AXIS]
        first = self.mesh.first_device
        return torch.cat([self._fn(reps[d * mp], block).to(first)
                          for d, block in enumerate(blocks)])[:n]

