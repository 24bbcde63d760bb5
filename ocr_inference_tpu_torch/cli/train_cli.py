"""CTC fine-tuning CLI for the line recognizers, counterpart of
ocr_inference_tpu/cli/train_cli.py (``bocr-train``):

    python -m ocr_inference_tpu_torch.cli.train_cli --model DIR \\
        --data LINES --output weights.msgpack [options]

Trains (or fine-tunes from ``<model>/weights.msgpack``) the recognizer of
``<model>/model_config.json`` on ``<data>/<stem>.png|jpg`` line images and
their ``<stem>.txt`` labels, and writes msgpack weights with a ``.json``
sidecar that the port's and the JAX package's builders read.

As in the JAX CLI, the canvases are gray scaled to ``/127.5 - 1`` and not
binarized (inference binarizes them), the model trains in float32, and
the batch indices come from ``np.random.default_rng(0)``. Differences:
``--device`` (default ``cuda``; without a card it raises unless ``cpu`` is
given), images are read with io/images.py ``read_image``, the mesh is
over the devices of ``--device``'s type (one CPU device: no mesh), and a
fresh model starts from the port's seeded weights (models/params.py
``init_recognizer``), not JAX's PRNG.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from glob import glob

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Fine-tune a CTC line recognizer")
    parser.add_argument("--model", required=True,
                        help="OCR model directory (model_config.json)")
    parser.add_argument("--data", required=True,
                        help="Directory of line images + .txt labels")
    parser.add_argument("--output", required=True,
                        help="Output weights path (.msgpack)")
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--width", type=int, default=1024,
                        help="Training canvas width (bucket)")
    parser.add_argument("--from-scratch", action="store_true",
                        help="Ignore existing weights")
    parser.add_argument("--log-every", type=int, default=50)
    parser.add_argument("--device", default="cuda",
                        help="Device to run on: 'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def load_dataset(data_dir: str, config, width: int):
    """Line images + labels -> (gray canvases (N, H, width) in [-1, 1],
    labels (N, L), label lengths (N,)), on the host (train_cli.py:45-85)."""
    import torch

    from ocr_inference_tpu_torch.core.data import CharsetEncoder
    from ocr_inference_tpu_torch.io.images import read_image
    from ocr_inference_tpu_torch.ops.imaging import rgb_to_gray
    from ocr_inference_tpu_torch.ops.tiling import pad_ocr_line
    from ocr_inference_tpu_torch.text.encoders import (
        StackEncoder,
        WylieEncoder,
    )

    encoder = (StackEncoder(config.charset)
               if config.encoder == CharsetEncoder.STACK
               else WylieEncoder(config.charset))
    images, labels = [], []
    for img_path in sorted(glob(os.path.join(data_dir, "*"))):
        if not img_path.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        label_path = os.path.splitext(img_path)[0] + ".txt"
        if not os.path.isfile(label_path):
            continue
        img = read_image(img_path)
        if img is None:
            continue
        canvas = pad_ocr_line(torch.from_numpy(img), width,
                              config.input_height)
        gray = rgb_to_gray(canvas).numpy()
        images.append(gray.astype(np.float32) / 127.5 - 1.0)
        label = encoder.read_label(label_path)
        labels.append([i for i in encoder.encode(label) if i > 0])
    if not images:
        raise SystemExit(f"no image/label pairs under {data_dir}")
    max_label = max(len(ids) for ids in labels)
    label_arr = np.zeros((len(labels), max_label), np.int32)
    length_arr = np.zeros((len(labels),), np.int32)
    for i, ids in enumerate(labels):
        label_arr[i, : len(ids)] = ids
        length_arr[i] = len(ids)
    return np.stack(images), label_arr, length_arr


def main(argv=None):
    args = parse_args(argv)

    import torch

    from ocr_inference_tpu_torch.core.assets import read_ocr_model_config
    from ocr_inference_tpu_torch.device import resolve_device
    from ocr_inference_tpu_torch.parallel.mesh import local_devices, make_mesh
    from ocr_inference_tpu_torch.models.params import load_params, save_params
    from ocr_inference_tpu_torch.models.recognition import build_recognizer
    from ocr_inference_tpu_torch.training import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    device = resolve_device(args.device)
    config = read_ocr_model_config(
        os.path.join(args.model, "model_config.json"))
    vocab_size = len(config.charset) + (1 if config.add_blank else 0)
    model = build_recognizer(config.architecture, vocab_size,
                             config.input_height).to(device)

    images, labels, label_lengths = load_dataset(args.data, config,
                                                 args.width)
    n = len(images)
    print(f"dataset: {n} lines, canvas {config.input_height}x{args.width}, "
          f"vocab {vocab_size}")

    optimizer = make_optimizer(args.lr, total_steps=args.steps)
    state = init_train_state(model, optimizer, config.input_height,
                             args.width)
    weights_in = os.path.join(args.model, "weights.msgpack")
    if not args.from_scratch and os.path.isfile(weights_in):
        load_params(model, weights_in)  # in place: the state's tensors
        print(f"resumed from {weights_in}")

    n_dev = len(local_devices(device.type))
    mesh = make_mesh(devices=local_devices(device.type)) if n_dev > 1 \
        else None
    step_fn = make_train_step(model, optimizer, mesh)
    print(f"training on {n_dev} device(s) ({device.type})")

    images_dev = torch.from_numpy(images).to(device)
    labels_dev = torch.from_numpy(labels).to(device)
    lengths_dev = torch.from_numpy(label_lengths).to(device)
    widths = torch.full((args.batch_size,), args.width, dtype=torch.int32,
                        device=device)
    rng = np.random.default_rng(0)
    state_t = state.as_tuple()
    t0 = time.time()
    for step in range(1, args.steps + 1):
        idx = torch.from_numpy(rng.integers(0, n, size=args.batch_size)
                               ).to(device)
        batch = {
            "images": images_dev[idx],
            "image_widths": widths,
            "labels": labels_dev[idx],
            "label_lengths": lengths_dev[idx],
        }
        state_t, loss = step_fn(state_t, batch)
        if step % args.log_every == 0 or step == args.steps:
            rate = step * args.batch_size / (time.time() - t0)
            print(f"step {step}/{args.steps} loss {float(loss):.4f} "
                  f"({rate:.1f} lines/s)")

    save_params(
        model, args.output,
        meta={
            "architecture": config.architecture,
            "vocab_size": vocab_size,
            "input_height": config.input_height,
            "trained_steps": args.steps,
        },
    )
    print(f"saved weights to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
