"""Assemble the page pipeline from model configs and Flax msgpack weights.

Counterpart of ocr_inference_tpu/pipeline/builder.py:40-206 for native
msgpack weights: ``X.onnx`` configured -> ``X.msgpack`` (or
``weights.msgpack``) beside it, architecture geometry from the
``.msgpack.json`` sidecar. Stem-2 UNets get the 2% horizontal opening
(builder.py:110). The ONNX executor and random weights are not part of
this port.
"""

from __future__ import annotations

from pathlib import Path

import torch

from ocr_inference_tpu_torch.core.data import (
    BatchConfig,
    LineDetectionConfig,
    OCRModelConfig,
)
from ocr_inference_tpu_torch.device import resolve_device
from ocr_inference_tpu_torch.models.params import load_flax_weights, load_meta
from ocr_inference_tpu_torch.models.recognition import Easter2
from ocr_inference_tpu_torch.models.segmentation import UNet
from ocr_inference_tpu_torch.pipeline.engines import (
    RecognitionEngine,
    SegmentationEngine,
)
from ocr_inference_tpu_torch.pipeline.ocr_pipeline import OCRPipeline


def find_weights(model_file: str) -> Path:
    """``X.msgpack`` or ``weights.msgpack`` next to the configured file."""
    p = Path(model_file)
    for cand in (p.with_suffix(".msgpack"), p.parent / "weights.msgpack"):
        if cand.is_file():
            return cand
    raise FileNotFoundError(f"no .msgpack weights next to {model_file}")


def _place(model: torch.nn.Module, head: str, dtype: torch.dtype,
           device: torch.device) -> torch.nn.Module:
    """Body in ``dtype``, head in float32 (as the Flax modules), eval mode."""
    model.to(device=device, dtype=dtype)
    getattr(model, head).float()
    return model.eval()


def build_recognition_engine(
    config: OCRModelConfig,
    batch_cfg: BatchConfig | None = None,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device | None = None,
) -> RecognitionEngine:
    if config.architecture.lower() not in ("easter2", "easter2b"):
        raise NotImplementedError(f"recognizer {config.architecture}")
    dev = resolve_device(device)
    weights = find_weights(config.model_file)
    meta = load_meta(weights)
    vocab = len(config.charset) + (1 if config.add_blank else 0)
    model = Easter2(
        vocab,
        input_height=config.input_height,
        stem_features=int(meta.get("stem_features", 128)),
        width_mult=float(meta.get("width_mult", 1.0)),
    )
    load_flax_weights(model, weights)
    return RecognitionEngine(_place(model, "Conv_0", dtype, dev), config, dev,
                             batch_cfg)


def build_detection_engine(
    config: LineDetectionConfig,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device | None = None,
) -> SegmentationEngine:
    if not config.architecture.lower().startswith("unet"):
        raise NotImplementedError(f"detector {config.architecture}")
    dev = resolve_device(device)
    weights = find_weights(config.onnx_file)
    meta = load_meta(weights)
    # weight files without a sidecar predate the stem-2 variant (stride 1)
    stem = int(meta.get("stem_stride", 1))
    model = UNet(classes=1, width=int(meta.get("width", 32)),
                 stem_stride=stem)
    load_flax_weights(model, weights)
    model = _place(model, model._head_name, dtype, dev)
    return SegmentationEngine(model, dev, patch_size=config.patch_size,
                              open_width_frac=0.02 if stem > 1 else 0.0)


def build_pipeline(
    ocr_config: OCRModelConfig,
    line_config: LineDetectionConfig,
    batch_cfg: BatchConfig | None = None,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device | None = None,
    use_line_prepadding: bool = False,
) -> OCRPipeline:
    """Page pipeline from configs (reference: OCRPipeline ctor,
    inference.py:440-463). ``dtype`` is both engines' compute precision:
    bf16 by default, float32 for parity runs. ``device`` defaults to
    ``cuda`` and raises without a card unless ``"cpu"`` is given."""
    rec = build_recognition_engine(ocr_config, batch_cfg, dtype, device)
    det = build_detection_engine(line_config, dtype, device)
    return OCRPipeline(rec, det, line_config, use_line_prepadding)
