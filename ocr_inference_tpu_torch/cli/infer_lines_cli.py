"""Detection-only bulk inference CLI -> Parquet, counterpart of
ocr_inference_tpu/cli/infer_lines_cli.py (``bocr-lines``) with the same
flags:

    python -m ocr_inference_tpu_torch.cli.infer_lines_cli -i PAGES \\
        -c LINES.msgpack|LINES.onnx|CONFIG.json [-o OUT] [options]

Pages load through io/dataset.py's ``ImageInferenceDataset`` prefetch
pool and go through the line SegmentationEngine's
``predict_many_batched`` in ``-b`` sized groups (so each tile runs the
binarize kernel), then each page's contours and bounding boxes are
written as one LINE_DETECTION_SCHEMA row to ``OUT/<page stem>.parquet``.

Differences from the JAX CLI:

- ``--device`` is ``cuda`` (default) or ``cpu``; without a card the
  default raises. ``--dtype`` (default ``bfloat16``) and ``--seed`` (of
  the weights ``--allow-random-weights`` makes) as the port's other CLIs
  have them;
- the Parquet files are GZIP-compressed where the JAX CLI writes zstd
  (io/parquet.py): the schema and the rows are the same;
- a page that cannot be read is reported and skipped, as in the JAX CLI;
  a format or variant the port does not decode stops the run naming it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ocr_inference_tpu_torch.cli.cli import DTYPES
from ocr_inference_tpu_torch.core.assets import read_line_model_config
from ocr_inference_tpu_torch.core.data import LineDetectionConfig
from ocr_inference_tpu_torch.geometry import backend as geo
from ocr_inference_tpu_torch.geometry import get_contours
from ocr_inference_tpu_torch.io.dataset import ImageInferenceDataset
from ocr_inference_tpu_torch.io.parquet import write_result_parquet
from ocr_inference_tpu_torch.pipeline.builder import build_detection_engine


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Run line segmentation inference on the card")
    parser.add_argument("-i", "--input-dir", required=True,
                        help="Input directory containing images")
    parser.add_argument("-o", "--output-dir", default="parquet_out",
                        help="Output directory for Parquet files")
    parser.add_argument("-c", "--checkpoint", required=True,
                        help="Path to model checkpoint (.msgpack or "
                             ".onnx) or line model config JSON")
    parser.add_argument("--num-classes", type=int, default=1,
                        help="Number of output classes (default: 1)")
    parser.add_argument("-b", "--batch-size", type=int, default=8,
                        help="Pages per detection batch")
    parser.add_argument("-w", "--num-workers", type=int, default=4,
                        help="Number of image-loading workers")
    parser.add_argument("-t", "--class-threshold", type=float, default=0.85,
                        help="Sigmoid threshold for binary mask")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="Device to run inference on")
    parser.add_argument("--dtype", choices=list(DTYPES), default="bfloat16",
                        help="Compute precision of the line model")
    parser.add_argument("--seed", type=int, default=0,
                        help="Seed of --allow-random-weights' weights")
    parser.add_argument("--no-pin-memory", action="store_true",
                        help="Kept for flag parity (no-op)")
    parser.add_argument("--allow-random-weights", action="store_true",
                        help="Run with random weights when none are found")
    return parser.parse_args(argv)


class _Pages(ImageInferenceDataset):
    """The dataset with unreadable pages reported and skipped (the JAX
    CLI's ``Failed to load image``) instead of raising."""

    def __getitem__(self, idx: int):
        try:
            img, _ = super().__getitem__(idx)
        except IOError:
            return self.paths[idx], None
        return self.paths[idx], img


def page_row(path: str, img, mask) -> dict:
    """One page's LINE_DETECTION_SCHEMA fields."""
    contours = get_contours(mask)
    return {
        "image_name": os.path.basename(path),
        "image_width": img.shape[1],
        "image_height": img.shape[0],
        "num_contours": len(contours),
        "contours": [[(int(x), int(y)) for [[x, y]] in cnt]
                     for cnt in contours],
        "bboxes": [tuple(int(v) for v in geo.bounding_rect(cnt))
                   for cnt in contours],
    }


def main(argv=None):
    args = parse_args(argv)
    pages = _Pages(args.input_dir)
    if not pages.paths:
        print(f"No images found in {args.input_dir}")
        sys.exit(1)

    if args.checkpoint.endswith(".json"):
        config = read_line_model_config(args.checkpoint)
    else:
        config = LineDetectionConfig(
            checkpoint=args.checkpoint,
            onnx_file=args.checkpoint,
            architecture="unet",
            patch_size=512,
            classes=["line"] * args.num_classes,
        )
    engine = build_detection_engine(
        config, args.allow_random_weights, DTYPES[args.dtype],
        device=args.device, seed=args.seed)
    os.makedirs(args.output_dir, exist_ok=True)

    start = time.perf_counter()
    n_done = 0

    def loaded():
        for path, img in pages.iter_prefetched(args.num_workers):
            if img is None:
                print(f"Failed to load image: {path}")
                continue
            yield path, img

    for path, img, mask in engine.predict_many_batched(
            loaded(), batch_size=args.batch_size,
            class_threshold=args.class_threshold):
        write_result_parquet(page_row(path, img, mask), args.output_dir)
        n_done += 1

    elapsed = time.perf_counter() - start
    print(f"Elapsed inference time: {elapsed:.2f}s")
    print(f"Processed {n_done} images "
          f"({n_done / max(elapsed, 1e-9):.2f} img/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
