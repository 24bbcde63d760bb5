"""CTC fine-tuning for the recognizers, counterpart of
ocr_inference_tpu/training/train.py.

- ``ctc_loss_fn``: the mean over the batch of optax's ``ctc_loss`` per
  sequence, labels padded with 0, the blank. A sequence that has an
  alignment takes ``F.ctc_loss`` (``reduction="none"``; torch's "mean"
  would also divide by the target lengths); one that has none (a label
  longer than its frames allow), where torch gives ``inf`` and NaN
  gradients, takes ``ctc_loss_log_epsilon``, optax's recursion with
  ``log_epsilon`` in place of log 0: a large finite loss with finite
  gradients, as in the JAX package.
- ``make_optimizer``: optax's ``chain(clip_by_global_norm(1.0),
  adamw(warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup +
  1)), weight_decay))`` written out, because ``torch.optim`` differs from
  it: the clip scales by ``1 / norm`` only when the norm is at least 1 (no
  1e-6 added), the schedule is read at the count before its increment (the
  first update has learning rate 0), the decay applies to every parameter
  (biases and norm scales too) and adds ``wd * p`` to the Adam direction
  before the learning rate scales it, and eps 1e-8 is added outside the
  square root.
- ``make_train_step``: ``step(state_tuple, batch) -> (state_tuple,
  loss)``. The model's own parameters and BatchNorm buffers are the state:
  the forward runs in train mode (``models/layers.py BatchNorm``: Flax's
  batch statistics and running averages), the gradients come from
  autograd and the update is applied to the model in place. The tuple
  carries the optimizer state and the step count; its params and
  batch_stats are the model's tensors, and a state of another model is
  refused. ``dtype=torch.bfloat16`` runs the body under autocast over
  float32 parameters, as Flax's ``dtype=bf16`` modules do, with the
  float32 heads outside it.
- With a ``mesh`` (parallel/mesh.py) the step is the JAX pjit'd step: the
  batch splits over the data axis, one contiguous block per data group,
  each group runs a replica of the model on its first device (one thread
  a group), the BatchNorm statistics and the loss's sums are those of the
  whole batch (``parallel.replicas``), and the gradient is that of the
  whole batch's loss, reduced over the groups and, under a process group,
  across processes. ``state_shardings`` (``tp_shardings`` of the state)
  splits the head's parameters over the model axis; the clip's global
  norm reads the whole reduced gradient. Under a process group each
  process passes its own rows of the global batch, and every process
  gets the same loss and update.
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ocr_inference_tpu_torch.models.params import init_recognizer, load_flax_tree
from ocr_inference_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    process_count,
)
from ocr_inference_tpu_torch.parallel.replicas import (
    ShardReduction,
    SplitHead,
    group_replicas,
    reduce_batch_norms,
    run_data_groups,
)


def has_alignment(logit_lengths: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the label fits its frames. A label of L tokens with r
    adjacent repeats needs L + r frames (a blank between the repeats)."""
    n = labels.shape[1]
    inside = torch.arange(1, n, device=labels.device)[None] < \
        label_lengths[:, None]
    repeats = ((labels[:, 1:] == labels[:, :-1]) & inside).sum(1)
    return label_lengths + repeats <= logit_lengths


def ctc_loss_log_epsilon(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                         labels: torch.Tensor, label_lengths: torch.Tensor,
                         blank_id: int = 0, log_epsilon: float = -1e5
                         ) -> torch.Tensor:
    """optax's ``ctc_loss`` per sequence of (B, T, K) log-probabilities:
    its forward recursion over the blank states (B, N + 1) and the label
    states (B, N), one frame at a time, with ``log_epsilon`` standing for
    log 0 (optax ``ctc_loss_with_forward_probs``). Frames past a
    sequence's length keep its states."""
    b, t, _ = log_probs.shape
    n = labels.shape[1]
    dtype, dev = log_probs.dtype, log_probs.device
    pad = (torch.arange(t, device=dev)[None] >= logit_lengths[:, None]
           ).to(dtype)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(dtype), (0, 1))
    lp_phi = log_probs[:, :, blank_id]
    lp_emit = torch.gather(log_probs, 2, labels[:, None, :].expand(b, t, n))

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], 1)

    phi = torch.full((b, n + 1), log_epsilon, dtype=dtype, device=dev)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), log_epsilon, dtype=dtype, device=dev)
    for s in range(t):
        e, p, keep = lp_emit[:, s], lp_phi[:, s, None], pad[:, s, None]
        prev = update_phi(phi, emit + log_epsilon * repeat)
        next_emit = torch.logaddexp(prev[:, :-1] + e, emit + e)
        next_phi = update_phi(prev + p,
                              emit + p + log_epsilon * (1.0 - repeat))
        emit = keep * emit + (1.0 - keep) * next_emit
        phi = keep * phi + (1.0 - keep) * next_phi
    last = update_phi(phi, emit)
    return -last.gather(1, label_lengths[:, None]).squeeze(1)


def ctc_loss_per_seq(logits: torch.Tensor, logit_lengths: torch.Tensor,
                     labels: torch.Tensor, label_lengths: torch.Tensor,
                     blank_id: int = 0) -> torch.Tensor:
    """(B,) CTC loss of (B, T, V) logits; labels (B, L) padded with 0 (the
    blank at index 0, charset ids + 1). Sequences with an alignment take
    ``F.ctc_loss``, those without ``ctc_loss_log_epsilon`` (optax's large
    finite loss), which runs only when the batch holds one."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    log_probs = F.log_softmax(logits, dim=-1)
    logit_lengths, labels = logit_lengths.long(), labels.long()
    label_lengths = label_lengths.long()
    per_seq = F.ctc_loss(log_probs.transpose(0, 1), labels, logit_lengths,
                         label_lengths, blank=blank_id, reduction="none",
                         zero_infinity=True)
    rows = torch.nonzero(~has_alignment(logit_lengths, labels,
                                        label_lengths))[:, 0]
    if rows.numel():
        per_seq = per_seq.index_put((rows,), ctc_loss_log_epsilon(
            log_probs[rows], logit_lengths[rows], labels[rows],
            label_lengths[rows], blank_id))
    return per_seq


def ctc_loss_fn(logits: torch.Tensor, logit_lengths: torch.Tensor,
                labels: torch.Tensor, label_lengths: torch.Tensor,
                blank_id: int = 0) -> torch.Tensor:
    """Mean CTC loss of (B, T, V) logits (``ctc_loss_per_seq``)."""
    return ctc_loss_per_seq(logits, logit_lengths, labels, label_lengths,
                            blank_id).mean()


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule in its float32 arithmetic: a
    linear ramp from ``init_value`` to ``peak_value`` over
    ``warmup_steps`` (none when it is 0), then a cosine decay to
    ``end_value`` at ``decay_steps``."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError("decay_steps must exceed warmup_steps")

    def linear(count: int) -> np.float32:
        if warmup_steps <= 0:
            return f32(init_value)
        c = f32(min(max(count, 0), warmup_steps))
        frac = f32(1) - c / f32(warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

    def cosine(count: int) -> np.float32:
        c = f32(min(count, cos_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c
                                            / f32(cos_steps)))
        return f32(peak_value) * (f32(1 - alpha) * decay + f32(alpha))

    def schedule(count: int) -> np.float32:
        return linear(count) if count < warmup_steps else \
            cosine(count - warmup_steps)

    return schedule


@dataclass
class OptState:
    """AdamW's state: the update count and the two moments per leaf."""

    count: int
    mu: list
    nu: list


class AdamW:
    """optax's ``chain(clip_by_global_norm(max_norm), adamw(schedule,
    b1, b2, eps, weight_decay))`` over a list of tensors."""

    def __init__(self, schedule, weight_decay: float = 1e-4,
                 max_norm: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.schedule = schedule
        self.weight_decay, self.max_norm = weight_decay, max_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: list) -> OptState:
        return OptState(0, [torch.zeros_like(p) for p in params],
                        [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, grads: list, state: OptState, params: list
               ) -> tuple[list, OptState]:
        """(updates, new state), as optax's ``optimizer.update``."""
        g_norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        # optax: where(norm < max_norm, g, (g / norm) * max_norm)
        clipped = [torch.where(g_norm < self.max_norm, g,
                               (g / g_norm) * self.max_norm) for g in grads]
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_add(torch._foreach_mul(clipped, 1 - b1),
                                torch._foreach_mul(state.mu, b1))
        sq = torch._foreach_mul(clipped, clipped)
        nu = torch._foreach_add(torch._foreach_mul(sq, 1 - b2),
                                torch._foreach_mul(state.nu, b2))
        count = state.count + 1
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        denom = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(nu, c2)), self.eps)
        updates = torch._foreach_div(torch._foreach_div(mu, c1), denom)
        updates = torch._foreach_add(
            updates, torch._foreach_mul(params, self.weight_decay))
        step_size = -float(self.schedule(state.count))
        updates = torch._foreach_mul(updates, step_size)
        return updates, OptState(count, mu, nu)


def apply_updates(params: list, updates: list) -> None:
    """``optax.apply_updates``, in place."""
    with torch.no_grad():
        torch._foreach_add_(params, updates)


def make_optimizer(learning_rate: float = 3e-4, total_steps: int = 10_000,
                   warmup_steps: int = 500, weight_decay: float = 1e-4
                   ) -> AdamW:
    """train.py:42-59: clip-by-global-norm 1.0, then AdamW under a warmup
    from 0 to ``learning_rate`` and a cosine decay to 0."""
    schedule = warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps, max(total_steps, warmup_steps + 1))
    return AdamW(schedule, weight_decay=weight_decay)


class TrainState:
    """Train state: params (the model's parameters by name), batch_stats
    (its BatchNorm running statistics by name), opt_state, step. The
    tensors are the model's own, so a step that updates them updates the
    model."""

    def __init__(self, params, batch_stats, opt_state, step=0):
        self.params = params
        self.batch_stats = batch_stats
        self.opt_state = opt_state
        self.step = step

    def as_tuple(self):
        return (self.params, self.batch_stats, self.opt_state, self.step)


def model_state(model: torch.nn.Module, optimizer: AdamW) -> TrainState:
    """The TrainState over ``model``'s current tensors, with a fresh
    optimizer state."""
    params = dict(model.named_parameters())
    batch_stats = {k: v for k, v in model.named_buffers()
                   if k.endswith(("running_mean", "running_var"))}
    return TrainState(params, batch_stats,
                      optimizer.init(list(params.values())), 0)


class Loss:
    """A step's loss as sums over the examples of a batch: ``parts(model,
    batch)`` gives tensors whose sums over the blocks of a batch are the
    whole batch's, and ``combine(parts)`` the loss from them. A mesh step
    adds the parts over the data axis before combining, so a loss that is
    not a mean of per-example terms (the soft dice) is still the whole
    batch's. ``loss(model, batch)`` is the one-device loss."""

    def __init__(self, parts, combine):
        self.parts, self.combine = parts, combine

    def __call__(self, model, batch):
        return self.combine(self.parts(model, batch))


def _gradient_masks(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Entries of the model's parameters that Flax does not have, whose
    gradient is zeroed: the r and z thirds of a GRU's ``bias_hh`` (Flax's
    hidden-side r and z gates have no bias, ``params_from_flax``)."""
    masks = {}
    for mod_name, mod in model.named_modules():
        if not isinstance(mod, torch.nn.GRU):
            continue
        for name, p in mod.named_parameters(recurse=False):
            if name.startswith("bias_hh"):
                m = torch.zeros_like(p)
                m[2 * (p.shape[0] // 3):] = 1
                masks[f"{mod_name}.{name}" if mod_name else name] = m
    return masks


def autocast(device: torch.device, dtype: torch.dtype):
    """The compute-dtype context of a train step: nothing for float32,
    autocast for bf16."""
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def as_batch(batch: dict, device: torch.device) -> dict:
    """A batch of numpy arrays or tensors -> tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def value_and_grad(model: torch.nn.Module, loss_fn, batch: dict,
                   dtype: torch.dtype = torch.float32
                   ) -> tuple[torch.Tensor, list]:
    """(loss, gradients in ``named_parameters`` order) of ``loss_fn(model,
    batch)`` in train mode, the BatchNorm running statistics updated, the
    entries Flax lacks (``_gradient_masks``) given zero gradient."""
    device = next(model.parameters()).device
    batch = as_batch(batch, device)
    model.train()
    with autocast(device, dtype):
        loss = loss_fn(model, batch)
    names, leaves = zip(*model.named_parameters())
    grads = list(torch.autograd.grad(loss, leaves))
    return loss.detach(), _masked(model, names, grads)


def _masked(model: torch.nn.Module, names, grads: list) -> list:
    masks = _gradient_masks(model)
    return [g * masks[n] if n in masks else g for n, g in zip(names, grads)]


def split_head(mesh: Mesh, state_shardings) -> str | None:
    """The top-level module whose parameters ``state_shardings`` (a state
    tuple's shardings, ``tp_shardings`` of its params first) split over
    the model axis, or None. More than one raises ValueError."""
    if state_shardings is None or mesh.shape[MODEL_AXIS] == 1:
        return None
    params = state_shardings[0]
    if not isinstance(params, dict):
        return None
    tops = {name.split(".")[0] for name, s in params.items()
            if MODEL_AXIS in getattr(s, "spec", ())}
    if len(tops) > 1:
        raise ValueError(f"the port splits one module over the model axis, "
                         f"got {sorted(tops)}")
    return tops.pop() if tops else None


class MeshGradient:
    """``value_and_grad`` over a mesh: replicas of ``model`` per data
    group (their ``head`` split over the model axis when given), synced
    from the model before each call; the forward of each group's block in
    lockstep (``parallel.replicas.run_data_groups``); the loss of the
    whole batch from the groups' summed parts; its gradient summed over
    the groups and, under a process group, across processes."""

    def __init__(self, model: torch.nn.Module, mesh: Mesh,
                 head: str | None = None):
        self.model, self.mesh, self.head = model, mesh, head
        self.replicas = group_replicas(mesh, model, head, always_copy=True)
        self._norms = [bn for d, rep in enumerate(self.replicas)
                       for bn in reduce_batch_norms(rep, d)]
        if head is not None and not isinstance(
                getattr(self.replicas[0], head), SplitHead):
            raise ValueError(f"{head} cannot be split over a model axis "
                             f"of {mesh.shape[MODEL_AXIS]}")

    def _sync(self) -> None:
        with torch.no_grad():
            for rep in self.replicas:
                for name, p in self.model.named_parameters():
                    if self.head is None or name.split(".")[0] != self.head:
                        rep.get_parameter(name).copy_(p)
                if self.head is not None:
                    getattr(rep, self.head).load_from(
                        getattr(self.model, self.head))
                for name, b in self.model.named_buffers():
                    rep.get_buffer(name).copy_(b)

    def _blocks(self, batch: dict) -> list[dict]:
        dp = self.mesh.shape[DATA_AXIS]
        tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
        n = next(iter(tensors.values())).shape[0]
        if n % dp:
            raise ValueError(f"a batch of {n} does not split over a data "
                             f"axis of {dp}")
        return [{k: v.chunk(dp)[d].to(group[0]) for k, v in tensors.items()}
                for d, group in enumerate(self.mesh.groups)]

    def _grad_of(self, rep, name: str, grads: dict) -> torch.Tensor:
        top, _, leaf = name.partition(".")
        if top == self.head:
            n = len(getattr(rep, top).parts)
            return torch.cat([grads[f"{top}.parts.{i}.{leaf}"]
                              for i in range(n)])
        return grads[name]

    def __call__(self, loss: Loss, batch: dict,
                 dtype: torch.dtype = torch.float32
                 ) -> tuple[torch.Tensor, list]:
        self._sync()
        blocks = self._blocks(batch)
        reduction = ShardReduction([g[0] for g in self.mesh.groups])
        for bn in self._norms:
            bn.reduction = reduction

        def forward(d: int):
            rep, dev = self.replicas[d], self.mesh.groups[d][0]
            rep.train()
            with autocast(dev, dtype):
                return loss.parts(rep, blocks[d])

        parts = run_data_groups(
            [functools.partial(forward, d) for d in range(len(blocks))],
            reduction)
        value = reduction.tie(loss.combine(reduction.total(parts)))
        named = [dict(rep.named_parameters()) for rep in self.replicas]
        leaves = [p for params in named for p in params.values()]
        flat = torch.autograd.grad(value / process_count(), leaves,
                                   allow_unused=True)
        it = iter(flat)
        per_rep = [{name: (g if g is not None else torch.zeros_like(p))
                    for (name, p), g in zip(params.items(), it)}
                   for params in named]
        names, grads = [], []
        for name, p in self.model.named_parameters():
            names.append(name)
            grads.append(functools.reduce(torch.add, [
                self._grad_of(rep, name, g).to(p.device)
                for rep, g in zip(self.replicas, per_rep)]))
        if process_count() > 1:
            flat = torch.cat([g.reshape(-1) for g in grads])
            torch.distributed.all_reduce(flat)
            grads = [f.view_as(g) for f, g in zip(
                flat.split([g.numel() for g in grads]), grads)]
        return value.detach().to(next(self.model.parameters()).device), \
            _masked(self.model, names, grads)

    def take_statistics(self) -> None:
        """The model's BatchNorm running statistics from the first
        replica's (every replica computed the same)."""
        with torch.no_grad():
            for name, b in self.model.named_buffers():
                b.copy_(self.replicas[0].get_buffer(name))


def make_gradient_step(model: torch.nn.Module, optimizer: AdamW, loss_fn,
                       dtype: torch.dtype = torch.float32, mesh=None,
                       state_shardings=None):
    """step(state_tuple, batch) -> (state_tuple, loss) for
    ``loss_fn(model, batch)``: the model's parameters updated in place,
    the tuple's optimizer state and count advanced. A state whose params
    are not the model's own tensors raises ValueError. With a ``mesh``,
    ``loss_fn`` is a ``Loss`` and the step runs over the mesh
    (``MeshGradient``)."""
    grad = None if mesh is None else MeshGradient(
        model, mesh, split_head(mesh, state_shardings))

    def step(state_tuple, batch):
        params, batch_stats, opt_state, step_no = state_tuple
        leaves = []
        for name, p in model.named_parameters():
            if params.get(name) is not p:
                raise ValueError(
                    f"the train state does not hold the model's {name}; "
                    "model_state(model, optimizer) makes one that does")
            leaves.append(p)
        if grad is None:
            loss, grads = value_and_grad(model, loss_fn, batch, dtype)
        else:
            loss, grads = grad(loss_fn, batch, dtype)
            grad.take_statistics()
        updates, opt_state = optimizer.update(grads, opt_state, leaves)
        apply_updates(leaves, updates)
        return (params, batch_stats, opt_state, step_no + 1), loss

    return step


def recognizer_loss(time_stride: int = 4) -> Loss:
    """The recognizer step's loss: the mean CTC over logit lengths
    ``min(width // time_stride, T)`` (train.py:90-110), as the sum over
    the sequences and their count."""
    def parts(model, batch):
        logits = model(batch["images"])
        lengths = torch.clamp(
            batch["image_widths"].long() // time_stride, max=logits.shape[1])
        per_seq = ctc_loss_per_seq(logits, lengths, batch["labels"],
                                   batch["label_lengths"])
        return [per_seq.sum(), per_seq.new_full((), per_seq.numel())]

    return Loss(parts, lambda p: p[0] / p[1])


def make_train_step(model: torch.nn.Module, optimizer: AdamW, mesh=None,
                    time_stride: int = 4, state_shardings=None,
                    dtype: torch.dtype = torch.float32):
    """The recognizer's train step (train.py:76-134). batch: images (B, H,
    W) float in [-1, 1], image_widths (B,), labels (B, L), label_lengths
    (B,). With a ``mesh`` B must split over its data axis."""
    return make_gradient_step(model, optimizer, recognizer_loss(time_stride),
                              dtype, mesh, state_shardings)


def init_train_state(model: torch.nn.Module, optimizer: AdamW,
                     input_height: int = 80, width: int = 256,
                     seed: int = 0) -> TrainState:
    """Load ``init_recognizer``'s seeded weights into ``model`` and return
    its TrainState (train.py:137-147)."""
    load_flax_tree(model, init_recognizer(model, input_height, width, seed),
                   "seeded init")
    return model_state(model, optimizer)


def synthetic_ctc_batch(batch_size: int, height: int, width: int, vocab: int,
                        max_label: int = 32, seed: int = 0) -> dict:
    """Random batch for smoke tests (train.py:150-163), the JAX draws."""
    rng = np.random.default_rng(seed)
    return {
        "images": rng.normal(size=(batch_size, height, width)).astype(
            np.float32),
        "image_widths": np.full((batch_size,), width, np.int32),
        "labels": rng.integers(1, vocab, size=(batch_size, max_label)
                               ).astype(np.int32),
        "label_lengths": np.full((batch_size,), max_label // 2, np.int32),
    }
