"""CER evaluation CLI over line-image distributions, counterpart of
ocr_inference_tpu/cli/evaluate_cli.py (``bocr-eval``):

    python -m ocr_inference_tpu_torch.cli.evaluate_cli --model DIR \\
        --dataset ROOT [--output DIR] [options]

CLI form of the reference's OCR-CrossEvaluation-Sketchbook notebook flow
(reference: OCR-CrossEvaluation-Sketchbook.ipynb cells 8-9 driving
OCREvaluator over the Uchan-OCR-EVAL distribution folders, writing one
``{architecture}.txt`` score file per model).

Dataset layout (as downloaded by Download_Datasets.ipynb):
    <dataset>/<distribution>/*.jpg|png  (line images)
    <dataset>/<distribution>/*.txt      (one label file per image)

Differences from the JAX CLI:

- ``--device`` (default ``cuda``), ``--dtype`` (default ``bfloat16``) and
  ``--seed`` (of the weights ``--allow-random-weights`` makes), as the
  port's ``bocr`` has them; without a card the default device raises;
- line images are read with io/images.py ``read_image`` (PNG, JPEG, TIFF,
  JPEG 2000, BMP, PNM and PAM, as cv2.imread reads them; the dataset globs
  the JAX CLI's extensions): a dataset holding a format or variant it does
  not decode (WebP, GIF, a JPEG 2000 TIFF, ...) exits
  non-zero, naming the files and why, before any model is loaded;
- the JAX CLI's persistent compilation cache has no counterpart.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from glob import glob

from ocr_inference_tpu_torch.cli.cli import DTYPES


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate OCR models (CER) on line-image distributions"
    )
    parser.add_argument("--model", required=True, action="append",
                        help="OCR model directory (repeatable)")
    parser.add_argument("--dataset", required=True,
                        help="Dataset root with distribution subfolders")
    parser.add_argument("--output", default="eval_out",
                        help="Directory for score files")
    parser.add_argument("--kenlm", default=None,
                        help="ARPA LM for beam rescoring")
    parser.add_argument("--allow-random-weights", action="store_true")
    parser.add_argument("--seed", type=int, default=0,
                        help="Seed of the weights --allow-random-weights "
                             "makes")
    parser.add_argument("--device", default="cuda",
                        help="Device to run on: 'cuda' (default) or 'cpu'")
    parser.add_argument("--dtype", choices=list(DTYPES), default="bfloat16",
                        help="Compute precision of the recognizer")
    return parser.parse_args(argv)


def collect_distributions(root: str) -> dict[str, tuple[list[str], list[str]]]:
    """distribution -> (image_paths, label_paths), paired by stem. The JAX
    CLI's extensions are kept, so that a line the port cannot read is
    named rather than passed over."""
    out = {}
    for dist_dir in sorted(glob(os.path.join(root, "*"))):
        if not os.path.isdir(dist_dir):
            continue
        images = sorted(
            p
            for p in glob(os.path.join(dist_dir, "*"))
            if p.lower().endswith((".jpg", ".jpeg", ".png", ".tif", ".tiff"))
        )
        pairs = []
        for img in images:
            label = os.path.splitext(img)[0] + ".txt"
            if os.path.isfile(label):
                pairs.append((img, label))
        if pairs:
            out[os.path.basename(dist_dir)] = (
                [p[0] for p in pairs],
                [p[1] for p in pairs],
            )
    return out


def main(argv=None):
    args = parse_args(argv)

    from ocr_inference_tpu_torch.core.assets import get_kenlm_config
    from ocr_inference_tpu_torch.eval.evaluator import OCREvaluator
    from ocr_inference_tpu_torch.io.images import unsupported

    distributions = collect_distributions(args.dataset)
    if not distributions:
        print(f"No distributions with image/label pairs under {args.dataset}")
        sys.exit(1)
    refused = [(p, why) for images, _ in distributions.values()
               for p in images if (why := unsupported(p))]
    if refused:
        sys.exit("These line images cannot be read: "
                 + ", ".join(f"{p} ({why})" for p, why in refused))
    os.makedirs(args.output, exist_ok=True)

    kenlm_config = (
        get_kenlm_config(args.kenlm, args.kenlm) if args.kenlm else None
    )

    summary = {}
    for model_dir in args.model:
        config_path = os.path.join(model_dir, "model_config.json")
        evaluator = OCREvaluator(
            config_path,
            kenlm_config=kenlm_config,
            allow_random=args.allow_random_weights,
            device=args.device,
            dtype=DTYPES[args.dtype],
            seed=args.seed,
        )
        arch = evaluator.get_architecture()
        scores_by_dist = {}
        for dist, (images, labels) in distributions.items():
            result = evaluator.evaluate_distribution(dist, images, labels)
            mean_cer = (
                sum(result.cer_scores.values()) / len(result.cer_scores)
                if result.cer_scores
                else float("nan")
            )
            scores_by_dist[dist] = {
                "mean_cer": mean_cer,
                "per_image": result.cer_scores,
            }
            print(f"{arch} / {dist}: CER {mean_cer:.4f} "
                  f"({len(result.cer_scores)} lines)")

        # score file per architecture (notebook contract)
        score_file = os.path.join(args.output, f"{arch}.txt")
        with open(score_file, "w", encoding="utf-8") as f:
            for dist, rec in scores_by_dist.items():
                f.write(f"{dist}\t{rec['mean_cer']:.6f}\n")
        with open(
            os.path.join(args.output, f"{arch}.json"), "w", encoding="utf-8"
        ) as f:
            json.dump(scores_by_dist, f, indent=1, ensure_ascii=False)
        summary[arch] = {
            d: rec["mean_cer"] for d, rec in scores_by_dist.items()
        }

    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
