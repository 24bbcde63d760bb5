"""CER evaluation harness, counterpart of ocr_inference_tpu/eval/evaluator.py
(reference: OCREvaluator, BDRC/inference.py:964).

Same surface (config path, scorer, optional KenLM, label encoding) with the
batched fast path: ``evaluate_distribution`` pushes every line image of a
distribution through the bucketed recognition engine in device batches.

Differences from the JAX evaluator:

- line images are read with io/images.py ``read_image`` (PNG, JPEG and
  TIFF, as cv2.imread reads them; other formats raise NotImplementedError
  naming them);
- the whole-line binarize, which the JAX evaluator runs on the host with
  cv2 (``ops_host.binarize_host``), runs on the card: the port's cv2-exact
  ``rgb_to_gray``, then the line kernel (``kernels.binarize_lines``) on a
  (1, H, W) tensor of the line's own height. The 0/255 result goes to the
  engine as a 2-D strip, which reads as binarize_host's 3-channel copy
  does (RGB2GRAY of three equal channels is the identity);
- ``device`` (default ``cuda``, raising without a card), ``dtype`` (default
  bfloat16) and ``seed`` (of the weights ``allow_random`` makes) go to the
  builder.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ocr_inference_tpu_torch.core.assets import (
    get_filename,
    read_ocr_model_config,
)
from ocr_inference_tpu_torch.core.data import (
    CharsetEncoder,
    Encoding,
    EvaluationSet,
    KenLMConfig,
)
from ocr_inference_tpu_torch.device import PendingHost, upload
from ocr_inference_tpu_torch.eval.cer import CERScorer
from ocr_inference_tpu_torch.io.images import read_image
from ocr_inference_tpu_torch.ops import kernels
from ocr_inference_tpu_torch.ops.imaging import rgb_to_gray
from ocr_inference_tpu_torch.pipeline.builder import build_recognition_engine
from ocr_inference_tpu_torch.text import StackEncoder, WylieEncoder


def binarize_lines_async(images: list[np.ndarray],
                         device: torch.device) -> list[PendingHost]:
    """RGB line images -> their adaptive-threshold masks (uint8 0/255,
    (H, W)), one line kernel launch each, all queued before the first is
    read."""
    out = []
    for img in images:
        gray = rgb_to_gray(upload(img, device))
        out.append(PendingHost(kernels.binarize_lines(gray[None])[0]))
    return out


class OCREvaluator:
    """Run OCR inference + CER on line-image/label pairs."""

    def __init__(
        self,
        config_path: str,
        cer_scorer=None,
        kenlm_config: Optional[KenLMConfig] = None,
        label_encoding: Encoding = Encoding.UNICODE,
        allow_random: bool = False,
        device: str | torch.device | None = None,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
    ):
        if not os.path.isfile(config_path):
            raise FileNotFoundError(f"Model config not found: {config_path}")
        self._config_file = config_path
        self._cer_scorer = cer_scorer or CERScorer()
        self._kenlm_config = kenlm_config
        self._label_encoding = label_encoding
        self._model_config = read_ocr_model_config(config_path)
        if self._model_config.encoder == CharsetEncoder.STACK:
            self._label_encoder = StackEncoder(self._model_config.charset)
        else:
            self._label_encoder = WylieEncoder(self._model_config.charset)
        self._inference = build_recognition_engine(
            self._model_config, kenlm_config, dtype=dtype, device=device,
            allow_random=allow_random, seed=seed,
        )

    def get_architecture(self) -> str:
        return self._model_config.architecture

    def _read_label(self, label_path: str) -> str:
        label = self._label_encoder.read_label(label_path)
        if isinstance(label, list):  # stack encoder returns stack list
            label = "".join(label)
        return label

    def evaluate(self, image_path: str, label_path: str) -> float:
        """One image/label pair -> CER (reference: inference.py:1002-1011)."""
        img = read_image(image_path)
        if img is None:
            raise FileNotFoundError(f"cannot read {image_path}")
        label = self._read_label(label_path)
        prediction = self._inference.run(img)
        return self._cer_scorer.compute(
            predictions=[prediction], references=[label]
        )

    def evaluate_distribution(
        self,
        folder_name: str,
        image_paths: list[str],
        label_paths: list[str],
        batch_binarize: bool = True,
    ) -> EvaluationSet:
        """Folder-level evaluation (reference: inference.py:1013-1040), with
        the recognizer running in device batches across all lines; a line
        that cannot be read is skipped."""
        images = []
        names = []
        labels = []
        for image_path, label_path in zip(image_paths, label_paths):
            img = read_image(image_path)
            if img is None:
                continue
            images.append(img)
            names.append(get_filename(image_path))
            labels.append(self._read_label(label_path))
        if batch_binarize:
            images = [p.get() for p in binarize_lines_async(
                images, self._inference.device)]

        predictions = self._inference.run_batch(images)
        cer_scores = {
            name: float(
                self._cer_scorer.compute(predictions=[pred],
                                         references=[label])
            )
            for name, pred, label in zip(names, predictions, labels)
        }
        return EvaluationSet(folder_name, image_paths, label_paths, cer_scores)
