"""Page OCR CLI, counterpart of ocr_inference_tpu/cli/cli.py (``bocr``)
with the same flags and behaviour:

    python -m ocr_inference_tpu_torch.cli.cli --model DIR \\
        (--image PAGE.png | --folder DIR) --output DIR [options]

Differences from the JAX CLI:

- ``--device`` (default ``cuda``) and ``--dtype`` (default ``bfloat16``,
  the builder's): the port runs on the card unless asked for the CPU, and
  without a card the default raises; ``--seed`` picks the seeded weights
  that ``--allow-random-weights`` makes (pipeline/builder.py
  ``seeded_variables``);
- pages are read with io/images.py ``read_image`` (PNG, JPEG, TIFF, JPEG
  2000, BMP, PNM and PAM, as cv2.imread reads them; ``--folder`` globs
  the JAX CLI's five extensions): a ``--image`` or ``--folder`` holding a
  format or variant it does not decode (WebP, GIF, a JPEG 2000 TIFF, ...)
  exits non-zero, naming the files and why, before any model is loaded;
- ``--mesh`` builds the mesh from the devices of ``--device``'s type: a
  count the cards cannot give exits naming it (the JAX CLI falls back to
  a virtual CPU mesh, cli.py:177-182); on the CPU a mesh of N repeats the
  one CPU device torch has. Across processes each builds its share of
  the mesh from its own devices (``build_mesh``);
- a CUDA error ends the run with a traceback and a non-zero exit instead
  of failing the page.

A model directory whose ``onnx-model`` has no ``.msgpack`` beside it runs
through the port's ONNX executor (pipeline/builder.py), in float32 or,
with ``OCR_ONNX_BF16=1``, bfloat16: ``--dtype`` does not reach it, as in
the JAX CLI.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import torch

from ocr_inference_tpu_torch.core.assets import (
    get_kenlm_config,
    import_local_model,
    read_layout_model_config,
    read_line_model_config,
)
from ocr_inference_tpu_torch.core.config import LINE_SORTING
from ocr_inference_tpu_torch.core.data import ArtifactConfig, Encoding
from ocr_inference_tpu_torch.io.artifacts import ArtifactManager, AuditLogger
from ocr_inference_tpu_torch.io.exporter import TextExporter
from ocr_inference_tpu_torch.io.images import read_image, unsupported
from ocr_inference_tpu_torch.parallel.mesh import (
    distributed_init,
    host_shard,
    local_devices,
    make_mesh,
    process_count,
)
from ocr_inference_tpu_torch.pipeline.builder import (
    build_pipeline,
    default_layout_config,
    default_line_config,
)
from ocr_inference_tpu_torch.pipeline.runner import run_ocr_with_artifacts

IMAGE_EXTENSIONS = ("*.jpg", "*.jpeg", "*.png", "*.tif", "*.tiff")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run Tibetan OCR inference on images (PyTorch, CUDA)."
    )
    parser.add_argument("--model", required=True, help="Path to OCR model directory")
    parser.add_argument("--image", help="Path to a single image file")
    parser.add_argument("--folder", help="Path to a folder containing images")
    parser.add_argument("--output", required=True, help="Output directory for results")
    parser.add_argument(
        "--encoding", choices=["unicode", "wylie"], default="unicode",
        help="Output encoding",
    )
    parser.add_argument(
        "--k-factor", type=float, default=2.5, help="Line extraction k-factor"
    )
    parser.add_argument(
        "--bbox-tolerance", type=float, default=4.0, help="Bounding box tolerance"
    )
    parser.add_argument(
        "--merge-lines", action="store_true", help="Merge line chunks"
    )
    parser.add_argument("--dewarp", action="store_true", help="Apply TPS dewarping")
    parser.add_argument(
        "--line-mode", choices=["line", "layout"], default="line",
        help="Line detection mode",
    )
    parser.add_argument(
        "--line-sorting", choices=list(LINE_SORTING), default="threshold",
        help="Reading-order algorithm (reference Config.py:85 map)",
    )
    parser.add_argument(
        "--save-artifacts", action="store_true", help="Enable artifact saving"
    )
    parser.add_argument(
        "--artifact-output", default="output", help="Base directory for artifacts"
    )
    parser.add_argument(
        "--artifact-granularity", choices=["minimal", "standard"],
        default="standard", help="Level of artifact detail to save",
    )
    parser.add_argument(
        "--line-model", default=None,
        help="Path to a line/layout model config JSON (overrides defaults)",
    )
    parser.add_argument(
        "--kenlm", default=None,
        help="Path to a KenLM/ARPA model (.arpa) for beam rescoring",
    )
    parser.add_argument(
        "--allow-random-weights", action="store_true",
        help="Run with seeded random weights when none are found "
             "(smoke runs)",
    )
    parser.add_argument(
        "--seed", type=int, default=0,
        help="Seed of the weights --allow-random-weights makes",
    )
    parser.add_argument(
        "--resume", action="store_true",
        help="Skip pages already completed in the artifact job dir",
    )
    parser.add_argument(
        "--job-id", default=None, help="Reuse a fixed artifact job id"
    )
    parser.add_argument(
        "--mesh", default="off",
        help="Device mesh: 'off' (single device), 'auto' (all devices), an "
             "explicit device count, or 'DxM' (data x model, e.g. '4x2') "
             "for tensor-parallel recognizer heads. Batches of tiles and "
             "lines are sharded over the data axis; the recognizer's vocab "
             "head over the model axis.",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="Device to run on: 'cuda' (default) or 'cpu'",
    )
    parser.add_argument(
        "--dtype", choices=list(DTYPES), default="bfloat16",
        help="Compute precision of both models",
    )
    return parser


def _line_config(args):
    """The line/layout config (reference: cli.py:56-65, de-bugged)."""
    if not args.line_model:
        return (default_line_config() if args.line_mode == "line"
                else default_layout_config())
    line_model = args.line_model
    if os.path.isdir(line_model):
        # the HF model-directory layout: one *.json config inside
        # (reference: BDRC/utils.py:116-129)
        configs = sorted(
            f for f in os.listdir(line_model) if f.endswith(".json")
            and not f.endswith(".msgpack.json")
        )
        if len(configs) != 1:
            sys.exit(
                f"--line-model dir must contain exactly one config "
                f"json, found {configs} in {line_model}"
            )
        line_model = os.path.join(line_model, configs[0])
    if args.line_mode == "line":
        return read_line_model_config(line_model)
    return read_layout_model_config(line_model)


def build_mesh(spec: str, device: str):
    """``--mesh`` -> this process's mesh, or None for ``off``
    (cli.py:163-184): joins the process group the cluster variables name
    (``distributed_init``), then takes devices of ``device``'s type. A
    count (N, or D x M) counts the devices of every process, as
    ``jax.devices()`` does: each of P processes takes N / P of its own (D
    / P data groups of M); ``auto`` takes all of its own. On the CPU a
    mesh of N repeats torch's one CPU device; a count of cards the
    machine lacks exits naming it. The mesh is printed when it spans more
    than one device, as the JAX CLI prints the mesh it builds."""
    if spec == "off":
        return None
    kind = torch.device(device).type
    distributed_init(device)
    nproc = process_count()
    mp = 1
    if spec == "auto":
        n = None
    elif "x" in spec:
        d, m = spec.lower().split("x", 1)
        n, mp = int(d) * int(m), int(m)
    else:
        n = int(spec)
    each = ""
    if n is not None and nproc > 1:
        if n % (nproc * mp):
            sys.exit(f"--mesh {spec} does not split over {nproc} processes")
        n //= nproc
        each = f" in each of {nproc} processes"
    if kind == "cpu":
        devices = local_devices(kind) * (n or 1)
    else:
        devices = local_devices(kind)
        if n is not None and len(devices) < n:
            sys.exit(f"--mesh {spec} needs {n} {kind} devices{each}; this "
                     f"machine has {len(devices)}")
    mesh = make_mesh(n_devices=n, devices=devices, model_parallel=mp)
    if mesh.devices.size * nproc > 1:
        shape = dict(mesh.shape)
        shape["data"] *= nproc
        print(f"Device mesh: {shape}")
    return mesh


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.image and args.folder:
        sys.exit("--image and --folder cannot be used together.")
    if not args.image and not args.folder:
        sys.exit("You must specify either --image or --folder.")
    mesh = build_mesh(args.mesh, args.device)

    # Collect images (reference: cli.py:71-78) and refuse the formats the
    # port cannot read before any model is loaded
    is_batch_mode = bool(args.folder)
    if args.folder:
        image_paths = sorted(
            p
            for ext in IMAGE_EXTENSIONS
            for p in glob.glob(os.path.join(args.folder, ext))
        )
        if process_count() > 1:
            # per-host input sharding across processes (cli.py:209-216)
            image_paths = host_shard(image_paths)
    else:
        image_paths = [args.image]
    refused = [(p, why) for p in image_paths if (why := unsupported(p))]
    if refused:
        sys.exit("These pages cannot be read: "
                 + ", ".join(f"{p} ({why})" for p, why in refused))

    os.makedirs(args.output, exist_ok=True)

    # Load recognizer model (reference: cli.py:49-54)
    config_path = os.path.join(args.model, "model_config.json")
    if not os.path.isfile(config_path):
        raise FileNotFoundError(f"Model config not found: {config_path}")
    ocr_model = import_local_model(args.model)

    kenlm_config = None
    if args.kenlm:
        kenlm_config = get_kenlm_config(args.kenlm, args.kenlm)

    pipeline = build_pipeline(
        ocr_model.config,
        _line_config(args),
        kenlm_config=kenlm_config,
        dtype=DTYPES[args.dtype],
        device=args.device,
        allow_random=args.allow_random_weights,
        seed=args.seed,
        mesh=mesh,
    )
    target_encoding = (
        Encoding.UNICODE if args.encoding == "unicode" else Encoding.WYLIE
    )
    if not image_paths:
        print(f"No images found in {args.folder}")
        sys.exit(1)

    # Artifact setup (reference: cli.py:80-110)
    artifact_manager = None
    audit_logger = None
    artifact_config = None
    completed: set[str] = set()

    if args.save_artifacts:
        is_standard = args.artifact_granularity == "standard"
        artifact_config = ArtifactConfig(
            enabled=True,
            granularity=args.artifact_granularity,
            save_detection=is_standard,
            save_dewarping=is_standard,
        )
        artifact_manager = ArtifactManager(
            base_output_dir=args.artifact_output,
            job_id=args.job_id,
            config={
                "image_count": len(image_paths),
                "image_paths": [os.path.basename(p) for p in image_paths],
                "k_factor": args.k_factor,
                "bbox_tolerance": args.bbox_tolerance,
                "merge_lines": args.merge_lines,
                "dewarp": args.dewarp,
                "encoding": args.encoding,
                "line_mode": args.line_mode,
                "artifact_granularity": args.artifact_granularity,
            },
        )
        if args.resume:
            completed = artifact_manager.completed_pages()
            if completed:
                print(f"Resuming: {len(completed)} pages already done")
        artifact_manager.create_directory_structure()
        artifact_manager.save_config()
        if is_standard:
            audit_logger = AuditLogger(
                artifact_manager.job_id, artifact_manager.job_dir / "audit.log"
            )

    # Process images (reference: cli.py:112-149)
    n_ok = 0
    for img_path in image_paths:
        page_name = os.path.basename(img_path)
        if page_name in completed:
            continue
        try:
            img = read_image(img_path)
        except NotImplementedError as e:  # found only when decoding
            sys.exit(str(e))
        if img is None:
            print(f"Failed to load image: {img_path}")
            if audit_logger:
                audit_logger.log_error(f"Failed to load image: {img_path}")
            continue

        base = os.path.splitext(page_name)[0]
        if artifact_manager and is_batch_mode:
            artifact_manager.set_current_page(page_name)

        status, result = run_ocr_with_artifacts(
            pipeline=pipeline,
            image=img,
            image_name=base,
            k_factor=args.k_factor,
            bbox_tolerance=args.bbox_tolerance,
            merge_lines=args.merge_lines,
            use_tps=args.dewarp,
            target_encoding=target_encoding,
            line_sorting=LINE_SORTING[args.line_sorting],
            artifact_manager=artifact_manager,
            audit_logger=audit_logger,
            artifact_config=artifact_config,
        )

        if status.name == "SUCCESS":
            n_ok += 1
            _, lines, ocr_lines, angle = result
            if not artifact_manager:
                TextExporter(args.output).export_lines(
                    img, base, lines, ocr_lines
                )
                print(f"Text output: {args.output}/{base}.txt")
        else:
            print(f"OCR failed for {img_path}: {result}")
            if audit_logger:
                audit_logger.log_error(
                    f"Pipeline failed for {page_name}: {result}"
                )

    # Finalize (reference: cli.py:151-158)
    if artifact_manager:
        if is_batch_mode:
            artifact_manager.save_aggregate_metrics()
        artifact_manager.generate_manifest()
        print(f"Artifacts saved to: {artifact_manager.job_dir}")
        if audit_logger:
            print(
                f"Audit log available at: {artifact_manager.job_dir / 'audit.log'}"
            )
    return 0 if n_ok else 1


if __name__ == "__main__":
    sys.exit(main())
