"""Segmentation training for the detection nets (UNet, DeepLabV3+),
counterpart of ocr_inference_tpu/training/segmentation.py: per-pixel
BCE + soft dice for one class, softmax cross-entropy + dice for several,
over the recognizer's optimizer and train-step machinery (train.py).

Batches are NHWC as in the JAX package ({"images": (B, P, P, 3) float in
[0, 1], "targets": (B, P, P, C)}); the step hands the nets NCHW and reads
their logits back as NHWC.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ocr_inference_tpu_torch.models.params import (
    init_segmentation,
    load_flax_tree,
)
from ocr_inference_tpu_torch.training.train import (
    AdamW,
    Loss,
    TrainState,
    make_gradient_step,
    model_state,
)


def seg_loss_parts(logits: torch.Tensor, targets: torch.Tensor) -> list:
    """(B, P, P, C) logits and targets -> the sums the loss is made of:
    the per-pixel BCE (C = 1; optax's ``sigmoid_binary_cross_entropy``)
    or softmax cross-entropy (C > 1) summed over the pixels, the pixel
    count, and the soft dice's ``sum(probs * tgt)``, ``sum(probs)`` and
    ``sum(tgt)``."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    if logits.shape[-1] == 1:
        x, tgt = logits[..., 0], targets[..., 0]
        ce = -tgt * F.logsigmoid(x) - (1.0 - tgt) * F.logsigmoid(-x)
        probs = torch.sigmoid(x)
    else:
        tgt = targets
        ce = -(tgt * F.log_softmax(logits, dim=-1)).sum(-1)
        probs = torch.softmax(logits, dim=-1)
    return [ce.sum(), ce.new_full((), ce.numel()), (probs * tgt).sum(),
            probs.sum(), tgt.sum()]


def seg_loss_from_parts(parts, dice_weight: float = 1.0) -> torch.Tensor:
    """The cross-entropy's mean per pixel plus ``dice_weight`` times the
    soft-dice loss of ``seg_loss_parts`` (segmentation.py:25-48); the
    dice's sums are the whole batch's."""
    ce_sum, pixels, inter, probs, tgt = parts
    dice = 1.0 - (2.0 * inter + 1.0) / (probs + tgt + 1.0)
    return ce_sum / pixels + dice_weight * dice


def seg_loss_fn(logits: torch.Tensor, targets: torch.Tensor,
                dice_weight: float = 1.0) -> torch.Tensor:
    """(B, P, P, C) logits and targets -> BCE (C = 1) or softmax
    cross-entropy (C > 1), averaged per pixel, plus ``dice_weight`` times
    the soft-dice loss (segmentation.py:25-48)."""
    return seg_loss_from_parts(seg_loss_parts(logits, targets), dice_weight)


def make_seg_train_step(model: torch.nn.Module, optimizer: AdamW, mesh=None,
                        dice_weight: float = 1.0, state_shardings=None,
                        dtype: torch.dtype = torch.float32):
    """step(state_tuple, batch) -> (state_tuple, loss) (segmentation.py:
    51-100); with a ``mesh`` the batch splits over its data axis, and the
    BatchNorm statistics, the cross-entropy's mean and the dice's sums
    are the whole batch's."""
    return make_gradient_step(model, optimizer, segmentation_loss(dice_weight),
                              dtype, mesh, state_shardings)


def segmentation_loss(dice_weight: float = 1.0) -> Loss:
    """The segmentation step's loss: the NHWC batch to NCHW for the net,
    its logits back to NHWC for ``seg_loss_parts``."""
    def parts(model, batch):
        logits = model(batch["images"].permute(0, 3, 1, 2))
        return seg_loss_parts(logits.permute(0, 2, 3, 1), batch["targets"])

    return Loss(parts, lambda p: seg_loss_from_parts(p, dice_weight))


def init_seg_train_state(model: torch.nn.Module, optimizer: AdamW,
                         patch_size: int = 512, seed: int = 0) -> TrainState:
    """Load ``init_segmentation``'s seeded weights into ``model`` and
    return its TrainState (segmentation.py:103-114)."""
    load_flax_tree(model, init_segmentation(model, patch_size, seed),
                   "seeded init")
    return model_state(model, optimizer)


def synthetic_seg_batch(batch_size: int, patch_size: int = 128,
                        classes: int = 1, seed: int = 0) -> dict:
    """Random tiles with band-shaped targets for smoke tests
    (segmentation.py:117-131), the JAX draws."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (batch_size, patch_size, patch_size, 3))
    targets = np.zeros((batch_size, patch_size, patch_size, classes))
    for b in range(batch_size):
        y0 = rng.integers(0, patch_size - 16)
        targets[b, y0: y0 + 12, :, rng.integers(0, classes)] = 1.0
        images[b, y0: y0 + 12, :, :] *= 0.3
    return {"images": images.astype(np.float32),
            "targets": targets.astype(np.float32)}
