"""Model replicas on a mesh, the split head, and the sums a data-parallel
train step reduces over the whole batch.

What XLA does for the JAX package's pjit'd steps and sharded engines, done
by hand:

- ``group_replicas``: one module per data group on its first device (the
  module itself where it already lives there), the head split over the
  group's devices by output feature when the model axis is > 1
  (``SplitHead``; its logits are gathered on the group's first device);
- ``run_data_groups``: a train step's forward, one thread per data group,
  in lockstep. ``reduce_batch_norms`` turns a replica's BatchNorms into
  ``GroupBatchNorm``s, which in train mode sum their statistics over the
  whole data axis through ``ShardReduction.reduce``: every group's sums
  meet on the mesh's first device, are added there, then summed across
  processes (``all_reduce``), and go back to each group. All of it is one
  autograd graph, so the backward of a sum reaches every group, and across
  processes the backward all-reduces the gradient of each sum, in the
  reverse order of the forward's reductions (a token threads them).
"""

from __future__ import annotations

import copy
import functools
import threading
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ocr_inference_tpu_torch.models.layers import BN_MOMENTUM, BatchNorm
from ocr_inference_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, process_count

# seconds a group waits for the others at a reduction before the step fails
BARRIER_TIMEOUT = 600.0


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``a`` and ``b`` name one device (``cuda`` is the current card)."""
    def index(d):
        if d.index is None and d.type == "cuda":
            return torch.cuda.current_device()
        return d.index
    return a.type == b.type and index(a) == index(b)


class SplitHead(nn.Module):
    """A head (Conv1d, Conv2d or Linear) split by output feature over
    ``devices``: slice i computes its features on devices[i], and the
    outputs are concatenated on the input's device along the feature dim
    (dim 1 of a convolution's output, the last of a linear layer's)."""

    def __init__(self, head: nn.Module, devices: Sequence[torch.device]):
        super().__init__()
        n = len(devices)
        self.devices = list(devices)
        self.feature_dim = -1 if isinstance(head, nn.Linear) else 1
        parts = []
        for i, dev in enumerate(self.devices):
            part = copy.deepcopy(head)
            with torch.no_grad():
                part.weight = nn.Parameter(head.weight.chunk(n)[i].clone())
                if head.bias is not None:
                    part.bias = nn.Parameter(head.bias.chunk(n)[i].clone())
            if isinstance(part, nn.Linear):
                part.out_features = part.weight.shape[0]
            else:
                part.out_channels = part.weight.shape[0]
            parts.append(part.to(dev))
        self.parts = nn.ModuleList(parts)

    @property
    def weight(self) -> torch.Tensor:
        """Slice 0's weight: the head's dtype for ``float_head``."""
        return self.parts[0].weight

    def load_from(self, head: nn.Module) -> None:
        """Copy the slices of a whole head's parameters in."""
        n = len(self.parts)
        with torch.no_grad():
            for i, part in enumerate(self.parts):
                part.weight.copy_(head.weight.chunk(n)[i])
                if head.bias is not None:
                    part.bias.copy_(head.bias.chunk(n)[i])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [part(x.to(dev)) for part, dev in zip(self.parts,
                                                     self.devices)]
        return torch.cat([o.to(x.device) for o in outs], self.feature_dim)


def can_split(model: nn.Module, head_module: Optional[str],
              mp: int) -> bool:
    """The model has a top-level ``head_module`` whose output features
    divide the model axis."""
    head = getattr(model, head_module, None) if head_module else None
    return (mp > 1 and isinstance(head, (nn.Conv1d, nn.Conv2d, nn.Linear))
            and head.weight.shape[0] % mp == 0)


def group_replicas(mesh: Mesh, model: nn.Module,
                   head_module: Optional[str] = None,
                   always_copy: bool = False) -> list[nn.Module]:
    """One module per data group, on the group's first device: ``model``
    itself where it lives there (unless ``always_copy``), else a copy; its
    top-level ``head_module`` split over the group's devices
    (``SplitHead``) when ``can_split``. Groups on the same device share a
    module unless the head is split or ``always_copy``."""
    mp = mesh.shape[MODEL_AXIS]
    split = can_split(model, head_module, mp)
    tensor = next(model.parameters(), next(model.buffers(), None))
    shared: dict[torch.device, nn.Module] = {}
    out = []
    for group in mesh.groups:
        dev = group[0]
        # a module without tensors runs anywhere
        here = dev if tensor is None else tensor.device
        if split or always_copy:
            rep = copy.deepcopy(model).to(dev)
            if split:
                setattr(rep, head_module,
                        SplitHead(getattr(rep, head_module), group))
        elif dev in shared:
            rep = shared[dev]
        else:
            rep = (model if _same_device(dev, here)
                   else copy.deepcopy(model).to(dev))
            shared[dev] = rep
        out.append(rep)
    return out


class _AllReduce(torch.autograd.Function):
    """Sum tensors over the process group; the backward sums their
    gradients the same way. ``token`` orders the collectives: each
    reduction takes the previous one's token and gives the next, so the
    backward runs them in exactly the reverse order on every process."""

    @staticmethod
    def forward(ctx, token, *tensors):
        ctx.shapes = [t.shape for t in tensors]
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        return (token.clone(),) + tuple(
            p.reshape(s) for p, s in zip(flat.split(
                [t.numel() for t in tensors]), ctx.shapes))

    @staticmethod
    def backward(ctx, g_token, *grads):
        grads = [torch.zeros(s, device=g_token.device) if g is None else g
                 for g, s in zip(grads, ctx.shapes)]
        flat = torch.cat([g.reshape(-1) for g in grads]).contiguous()
        dist.all_reduce(flat)
        return (g_token,) + tuple(
            p.reshape(s) for p, s in zip(flat.split(
                [g.numel() for g in grads]), ctx.shapes))


class ShardReduction:
    """Sums over the data groups of one step, and over the processes.

    ``reduce(group, tensors)`` is called by every group's thread at the
    same point of the forward; it waits for all of them, and returns the
    sums of each tensor over every group and every process, on the
    caller's device. ``total(parts)`` does the same from one thread for
    the per-group loss sums after the forward."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self.first = self.devices[0]
        self._slots: list = [None] * len(self.devices)
        self._result: list = []
        self._token = None
        self._barrier = threading.Barrier(len(self.devices),
                                          action=self._sum,
                                          timeout=BARRIER_TIMEOUT)

    def _across(self, sums: list[torch.Tensor]) -> list[torch.Tensor]:
        if process_count() == 1:
            return sums
        if self._token is None:
            self._token = torch.zeros((), device=self.first,
                                      requires_grad=True)
        self._token, *sums = _AllReduce.apply(self._token, *sums)
        return sums

    def _add(self, per_group: Sequence[Sequence[torch.Tensor]]) -> list:
        return self._across([
            functools.reduce(torch.add, [t.to(self.first) for t in parts])
            for parts in zip(*per_group)])

    def _sum(self) -> None:
        self._result = self._add(self._slots)

    def reduce(self, group: int, tensors: Sequence[torch.Tensor]) -> list:
        self._slots[group] = list(tensors)
        self._barrier.wait()
        return [t.to(self.devices[group]) for t in self._result]

    def total(self, per_group: Sequence[Sequence[torch.Tensor]]) -> list:
        return self._add(per_group)

    def tie(self, loss: torch.Tensor) -> torch.Tensor:
        """``loss`` with the token chain in its graph (a zero term), so
        that the backward reaches every cross-process reduction in
        order."""
        return loss if self._token is None else loss + 0.0 * self._token

    def abort(self) -> None:
        self._barrier.abort()


class GroupBatchNorm(BatchNorm):
    """``models.layers.BatchNorm`` of data group ``group`` of a mesh train
    step: in train mode, while ``reduction`` is set, the mean and
    ``E[x^2]`` are those of the whole batch (every group's sums, added
    over the data axis and across processes), as Flax computes them under
    a pjit'd step; otherwise the layer's own."""

    def __init__(self, features: int, group: int):
        super().__init__(features)
        self.group = group
        self.reduction: Optional[ShardReduction] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.reduction is None:
            return super().forward(x)
        axes = [0] + list(range(2, x.ndim))
        shape = [1, -1] + [1] * (x.ndim - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        count = xf.new_full((), xf.numel() // xf.shape[1])
        s1, s2, n = self.reduction.reduce(
            self.group, [xf.sum(axes), (xf * xf).sum(axes), count])
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                    + (1 - BN_MOMENTUM) * mean)
            self.running_var.copy_(BN_MOMENTUM * self.running_var
                                   + (1 - BN_MOMENTUM) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        y = (xf - mean.view(shape)) * mul.view(shape) + \
            self.bias.to(xf.dtype).view(shape)
        return y.to(x.dtype)


def reduce_batch_norms(replica: nn.Module, group: int
                       ) -> list[GroupBatchNorm]:
    """Replace each ``BatchNorm`` of ``replica`` (a private copy) by a
    ``GroupBatchNorm`` of data group ``group`` holding the same tensors;
    returns them, for the step to set their ``reduction``."""
    out = []
    for name, mod in list(replica.named_modules()):
        if type(mod) is not BatchNorm:
            continue
        bn = GroupBatchNorm(mod.num_features, group).to(mod.weight.device)
        bn.load_state_dict(mod.state_dict())
        bn.train(mod.training)
        parent, _, leaf = name.rpartition(".")
        setattr(replica.get_submodule(parent), leaf, bn)
        out.append(bn)
    return out


def run_data_groups(fns: Sequence[Callable[[], object]],
                    reduction: ShardReduction) -> list:
    """Run ``fns[d]()`` in thread d; returns their results in order. The
    first error in any thread breaks the others' waits at ``reduction``
    and is raised here."""
    results: list = [None] * len(fns)
    errors: list = []

    def work(d: int) -> None:
        try:
            results[d] = fns[d]()
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)
            reduction.abort()

    threads = [threading.Thread(target=work, args=(d,), daemon=True)
               for d in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        real = [e for e in errors
                if not isinstance(e, threading.BrokenBarrierError)]
        raise (real or errors)[0]
    return results
