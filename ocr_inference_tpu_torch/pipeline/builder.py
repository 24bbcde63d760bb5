"""Assemble the page pipeline from model configs: Flax msgpack weights or
the ``.onnx`` file itself.

Counterpart of ocr_inference_tpu/pipeline/builder.py, with its order of
resolution for a configured model file ``X.onnx`` (builder.py:5-13):

1. ``X.msgpack`` (or ``weights.msgpack``) beside it: the port's own module,
   architecture geometry from the ``.msgpack.json`` sidecar; stem-2 UNets
   get the 2% horizontal opening (builder.py:110);
2. the ``.onnx`` file itself, run by the port's ONNX executor
   (``onnx.load_onnx_module``) in float32, or bfloat16 under
   ``OCR_ONNX_BF16=1``; the builders' ``dtype`` does not reach it, and
   the ONNX detector gets no opening (builder.py:87-101, :140-150);
3. ``allow_random=True``: the architecture with seeded weights
   (``seeded_variables``); without it a missing file raises
   ``FileNotFoundError``.

A ``LayoutDetectionConfig``, or an architecture whose name starts with
``deeplab``, builds the layout DeepLabV3+ (builder.py:131-194). A
``kenlm_config`` gives the recognizer its n-gram LM for eval mode.

The builders take the JAX positional order (builder.py:76, :131, :197);
the port's ``device`` and ``seed`` come after it. A ``mesh``
(parallel/mesh.py ``make_mesh``) goes to both engines, which then split
their batches over its data axis, the recognizer's head over its model
axis; the engines live on the mesh's first device, whose type must be
``device``'s.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from ocr_inference_tpu_torch.core.data import (
    BatchConfig,
    KenLMConfig,
    LayoutDetectionConfig,
    LineDetectionConfig,
    OCRModelConfig,
)
from ocr_inference_tpu_torch.device import resolve_device
from ocr_inference_tpu_torch.models.params import (
    flax_shapes,
    load_flax_tree,
    load_meta,
    read_msgpack,
    seeded_flax_params,
)
from ocr_inference_tpu_torch.models.recognition import build_recognizer
from ocr_inference_tpu_torch.models.segmentation import DeepLabV3Plus, UNet
from ocr_inference_tpu_torch.onnx import load_onnx_module
from ocr_inference_tpu_torch.pipeline.engines import (
    RecognitionEngine,
    SegmentationEngine,
)
from ocr_inference_tpu_torch.pipeline.ocr_pipeline import OCRPipeline

# Seeded weights scale the float32 head's kernel by this gain. At the
# Flax initialisers' own scale a fresh DeepLabV3+ gives logits within
# about +-0.7 on binarized pages, so no pixel of any class passes the 0.8
# softmax threshold and layout mode would run on empty masks. A seeded
# recognizer reads strings of random tokens, the same in both packages;
# with the gain its frames' top two logits lie far apart.
SEEDED_HEAD_GAIN = 32.0


def find_weights(model_file: str) -> Path | None:
    """``X.msgpack`` or ``weights.msgpack`` next to the configured file."""
    if not model_file:
        return None
    p = Path(model_file)
    for cand in (p.with_suffix(".msgpack"), p.parent / "weights.msgpack"):
        if cand.is_file():
            return cand
    return None


def _has_onnx(model_file: str) -> bool:
    """The configured file is an ``.onnx`` file that exists."""
    return bool(model_file) and model_file.endswith(".onnx") and \
        os.path.isfile(model_file)


def seeded_variables(model: torch.nn.Module, seed: int) -> dict:
    """Flax variables for ``model`` from ``seeded_flax_params`` (numpy
    alone, so the JAX module can load the same arrays), the kernel of the
    model's own head (``_head_name``: Conv_0 of the Easter2 family, Dense_1
    of CRNN, the segmentation heads) scaled by SEEDED_HEAD_GAIN."""
    tree = seeded_flax_params(flax_shapes(model), seed)
    tree["params"][model._head_name]["kernel"] *= SEEDED_HEAD_GAIN
    return tree


def _load(model: torch.nn.Module, weights: Path | None, model_file: str,
          allow_random: bool, seed: int, what: str) -> None:
    if weights is not None:
        load_flax_tree(model, read_msgpack(weights), str(weights))
    elif allow_random:
        load_flax_tree(model, seeded_variables(model, seed),
                       f"seeded {what}")
    else:
        raise FileNotFoundError(
            f"No weights found for {what}: {model_file} "
            "(pass allow_random=True for smoke runs)")


def _place(model: torch.nn.Module, head: str, dtype: torch.dtype,
           device: torch.device) -> torch.nn.Module:
    """Body in ``dtype``, head in float32 (as the Flax modules), eval mode.
    An RNN's weights are packed into the one buffer cuDNN reads (after a
    move they are separate tensors, which cuDNN would copy on every
    call)."""
    model.to(device=device, dtype=dtype)
    getattr(model, head).float()
    for m in model.modules():
        if isinstance(m, torch.nn.RNNBase):
            m.flatten_parameters()
    return model.eval()


def _engine_device(device, mesh) -> torch.device:
    """``device`` resolved; with a mesh, the mesh's first device, which
    must be of ``device``'s type."""
    dev = resolve_device(device)
    if mesh is None:
        return dev
    first = mesh.first_device
    if first.type != dev.type:
        raise ValueError(f"a mesh of {first.type} devices for device "
                         f"{dev}")
    return resolve_device(first)


def build_recognition_engine(
    config: OCRModelConfig,
    kenlm_config: KenLMConfig | None = None,
    batch_cfg: BatchConfig | None = None,
    allow_random: bool = False,
    dtype: torch.dtype = torch.bfloat16,
    mesh=None,
    device: str | torch.device | None = None,
    seed: int = 0,
) -> RecognitionEngine:
    """The recognizer of ``config.architecture`` (any name
    ``build_recognizer`` takes) behind a RecognitionEngine. ``width_mult``,
    ``stem_features`` and ``hidden`` come from the weight sidecar's meta
    where it has them (builder.py:101-118); an unknown name raises
    ValueError."""
    dev = _engine_device(device, mesh)
    weights = find_weights(config.model_file)
    vocab = len(config.charset) + (1 if config.add_blank else 0)
    if weights is None and _has_onnx(config.model_file):
        module = load_onnx_module(
            config.model_file, "line", config.input_layer,
            config.output_layer, config.swap_hw, config.squeeze_channel,
            vocab, device=dev)
        return RecognitionEngine(module, config, dev, batch_cfg,
                                 kenlm_config, mesh)
    meta = (load_meta(weights) or {}) if weights is not None else {}
    kwargs = {k: t(meta[k]) for k, t in (
        ("width_mult", float), ("stem_features", int), ("hidden", int))
        if k in meta}
    model = build_recognizer(config.architecture, vocab,
                             input_height=config.input_height, **kwargs)
    _load(model, weights, config.model_file, allow_random, seed,
          f"recognizer ({config.architecture})")
    return RecognitionEngine(_place(model, model._head_name, dtype, dev),
                             config, dev, batch_cfg, kenlm_config, mesh)


def build_detection_engine(
    config: LineDetectionConfig | LayoutDetectionConfig,
    allow_random: bool = False,
    dtype: torch.dtype = torch.bfloat16,
    mesh=None,
    device: str | torch.device | None = None,
    seed: int = 0,
) -> SegmentationEngine:
    is_layout = isinstance(config, LayoutDetectionConfig)
    dev = _engine_device(device, mesh)
    weights = find_weights(config.onnx_file)
    mode = "layout" if is_layout else "line"
    if weights is None and _has_onnx(config.onnx_file):
        return SegmentationEngine(
            load_onnx_module(config.onnx_file, "nchw", device=dev), dev,
            mode=mode, patch_size=config.patch_size, classes=config.classes,
            mesh=mesh)
    arch = config.architecture.lower()
    if not (is_layout or arch.startswith(("unet", "deeplab"))):
        raise NotImplementedError(f"detector {config.architecture}")
    n_classes = len(config.classes) if is_layout else 1
    if is_layout or arch.startswith("deeplab"):
        model = DeepLabV3Plus(classes=n_classes)
        stem = 1
    else:
        meta = (load_meta(weights) or {}) if weights is not None else {}
        # weight files without a sidecar predate the stem-2 variant (stride
        # 1); a fresh detector takes the stem-2 default (builder.py:162-168)
        stem = int(meta.get("stem_stride", 2 if weights is None else 1))
        model = UNet(classes=1, width=int(meta.get("width", 32)),
                     stem_stride=stem)
    _load(model, weights, config.onnx_file, allow_random, seed,
          f"detector ({config.architecture})")
    model = _place(model, model._head_name, dtype, dev)
    return SegmentationEngine(
        model, dev, mode=mode, patch_size=config.patch_size,
        classes=config.classes, open_width_frac=0.02 if stem > 1 else 0.0,
        mesh=mesh)


def build_pipeline(
    ocr_config: OCRModelConfig,
    line_config: LineDetectionConfig | LayoutDetectionConfig,
    kenlm_config: KenLMConfig | None = None,
    batch_cfg: BatchConfig | None = None,
    allow_random: bool = False,
    use_line_prepadding: bool = False,
    mesh=None,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device | None = None,
    seed: int = 0,
) -> OCRPipeline:
    """Page pipeline from configs (reference: OCRPipeline ctor,
    inference.py:440-463). ``dtype`` is both engines' compute precision:
    bf16 by default, float32 for parity runs. ``device`` defaults to
    ``cuda`` and raises without a card unless ``"cpu"`` is given.
    ``kenlm_config`` loads the n-gram LM that eval mode's fused beams and
    ``calibrate_lm`` use. ``allow_random`` gives a model without a weights
    file the seeded weights of ``seed``. ``mesh`` runs both engines over a
    device mesh."""
    rec = build_recognition_engine(ocr_config, kenlm_config, batch_cfg,
                                   allow_random, dtype, mesh, device, seed)
    det = build_detection_engine(line_config, allow_random, dtype, mesh,
                                 device, seed)
    return OCRPipeline(rec, det, line_config, use_line_prepadding)


def default_line_config(patch_size: int = 512) -> LineDetectionConfig:
    """The reference CLI's line default (reference: cli.py:57, de-bugged as
    builder.py:221-231 does)."""
    return LineDetectionConfig(
        checkpoint="",
        onnx_file="Models/Lines/PhotiLines.onnx",
        architecture="unet",
        patch_size=patch_size,
        classes=["line"],
    )


def default_layout_config(patch_size: int = 512) -> LayoutDetectionConfig:
    """The reference CLI's layout default (reference: cli.py:59-65;
    builder.py:234-242)."""
    return LayoutDetectionConfig(
        checkpoint="",
        onnx_file="Models/Layout/photi.onnx",
        architecture="deeplabv3",
        patch_size=patch_size,
        classes=["background", "image", "line", "caption", "margin"],
    )
