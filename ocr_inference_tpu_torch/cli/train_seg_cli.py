"""Segmentation training CLI, counterpart of
ocr_inference_tpu/cli/train_seg_cli.py (``bocr-train-seg``):

    python -m ocr_inference_tpu_torch.cli.train_seg_cli \\
        --config line_model/config.json --data pages/ \\
        --output unet.msgpack --steps 2000

A directory of page images with sibling ``<name>_mask.png`` binary masks
(or ``<name>_mask_<class>.png`` per layout class) is cut into
``patch_size`` tiles at the inference geometry (``tiling.plan_page``),
and batches sample tiles uniformly (``np.random.default_rng(0)``).

As in the JAX CLI: the tiles are RGB / 255, not binarized; the UNet is
``UNet(classes=n)`` at its default width (32) and stem (1), whatever the
config says; the nets train in float32; no sidecar is written. A layout
config's "background" class is the complement of the labelled masks.
Differences: ``--device`` (default ``cuda``; without a card it raises
unless ``cpu`` is given), pages and masks are read with io/images.py
``read_image`` (a mask's gray as cv2's RGB2GRAY of it), one device (no
mesh), and the port's seeded initial weights.
"""

from __future__ import annotations

import argparse
import os
import sys
from glob import glob

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a line/layout segmentation model")
    parser.add_argument("--config", required=True,
                        help="Line or layout model config JSON")
    parser.add_argument("--data", required=True,
                        help="Directory of page images + *_mask.png targets")
    parser.add_argument("--output", required=True,
                        help="Output weights path (.msgpack)")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--dice-weight", type=float, default=1.0)
    parser.add_argument("--log-every", type=int, default=50)
    parser.add_argument("--device", default="cuda",
                        help="Device to run on: 'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def _read_gray(path: str) -> np.ndarray | None:
    import torch

    from ocr_inference_tpu_torch.io.images import read_image
    from ocr_inference_tpu_torch.ops.imaging import rgb_to_gray

    img = read_image(path) if os.path.isfile(path) else None
    return None if img is None else rgb_to_gray(torch.from_numpy(img)).numpy()


def load_tiles(data_dir: str, patch_size: int, classes: list[str]):
    """Every page/mask pair tiled at the inference geometry
    (train_seg_cli.py:42-131): pages resized as ``plan_page`` says
    (INTER_LINEAR), masks with INTER_NEAREST, padded (pages with 255,
    masks with 0) and cut into tiles; uint8 tiles (N, P, P, 3) and targets
    (N, P, P, C)."""
    import torch

    from ocr_inference_tpu_torch.io.images import read_image
    from ocr_inference_tpu_torch.ops.imaging import (
        resize_linear_u8,
        resize_nearest_u8,
    )
    from ocr_inference_tpu_torch.ops.tiling import plan_page

    n_classes = max(1, len(classes)) if len(classes) > 1 else 1
    bg_idx = (classes.index("background")
              if n_classes > 1 and "background" in classes else None)
    tiles, targets = [], []

    def tile_one(arr, pad_value, plan, nearest=False):
        if (plan.resized_h, plan.resized_w) != (plan.orig_h, plan.orig_w):
            if nearest:
                arr = resize_nearest_u8(arr, plan.resized_h, plan.resized_w)
            else:
                arr = resize_linear_u8(torch.from_numpy(arr), plan.resized_h,
                                       plan.resized_w).numpy()
        padded = np.full((plan.padded_h, plan.padded_w) + arr.shape[2:],
                         pad_value, arr.dtype)
        padded[: plan.resized_h, : plan.resized_w] = arr
        p = patch_size
        for y in range(0, plan.padded_h, p):
            for x in range(0, plan.padded_w, p):
                yield padded[y: y + p, x: x + p]

    for img_path in sorted(glob(os.path.join(data_dir, "*"))):
        base, ext = os.path.splitext(img_path)
        if ext.lower() not in (".jpg", ".jpeg", ".png") or base.endswith(
                "_mask") or "_mask_" in os.path.basename(base):
            continue
        img = read_image(img_path)
        if img is None:
            continue
        h, w = img.shape[:2]
        if n_classes == 1:
            m = _read_gray(base + "_mask.png")
            if m is None:
                continue
            target = (m > 127).astype(np.uint8)[..., None]
        else:
            target = np.zeros((h, w, n_classes), np.uint8)
            found = False
            for ci, cname in enumerate(classes):
                if ci == bg_idx:
                    continue
                m = _read_gray(f"{base}_mask_{cname}.png")
                if m is not None:
                    target[..., ci] = m > 127
                    found = True
            if not found:
                continue
            if bg_idx is not None:
                target[..., bg_idx] = 1 - target.max(axis=-1)
        plan = plan_page(h, w, patch_size)
        tiles.extend(tile_one(img, 255, plan))
        targets.extend(tile_one(target, 0, plan, nearest=True))
    if not tiles:
        raise SystemExit(f"no page/mask pairs under {data_dir}")
    return np.stack(tiles), np.stack(targets)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from ocr_inference_tpu_torch.core.assets import (
        read_layout_model_config,
        read_line_model_config,
    )
    from ocr_inference_tpu_torch.device import resolve_device
    from ocr_inference_tpu_torch.models.params import save_params
    from ocr_inference_tpu_torch.models.segmentation import (
        DeepLabV3Plus,
        UNet,
    )
    from ocr_inference_tpu_torch.training import (
        init_seg_train_state,
        make_optimizer,
        make_seg_train_step,
    )

    device = resolve_device(args.device)
    try:
        config = read_layout_model_config(args.config)
    except Exception:
        config = read_line_model_config(args.config)
    classes = config.classes
    n_classes = len(classes) if len(classes) > 1 else 1
    arch = (config.architecture or "unet").lower()
    model = (DeepLabV3Plus(classes=n_classes) if "deeplab" in arch
             else UNet(classes=n_classes)).to(device)

    tiles, targets = load_tiles(args.data, config.patch_size, classes)
    n = len(tiles)
    print(f"dataset: {n} tiles of {config.patch_size}, {n_classes} class(es)")

    optimizer = make_optimizer(args.lr, total_steps=args.steps)
    state = init_seg_train_state(model, optimizer, config.patch_size)
    step_fn = make_seg_train_step(model, optimizer,
                                  dice_weight=args.dice_weight)
    print(f"training on 1 device(s) ({device})")

    tiles_dev = torch.from_numpy(tiles).to(device)
    targets_dev = torch.from_numpy(targets).to(device)
    rng = np.random.default_rng(0)
    state_t = state.as_tuple()
    for i in range(args.steps):
        idx = torch.from_numpy(rng.integers(0, n, size=args.batch_size)
                               ).to(device)
        batch = {"images": tiles_dev[idx].to(torch.float32) / 255.0,
                 "targets": targets_dev[idx].to(torch.float32)}
        state_t, loss = step_fn(state_t, batch)
        if (i + 1) % args.log_every == 0 or i == 0:
            print(f"step {i + 1}/{args.steps} loss {float(loss):.4f}",
                  flush=True)

    save_params(model, args.output)
    print(f"saved weights to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
