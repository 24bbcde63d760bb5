"""``pyctcdecode``-compatible module surface backed by the port's decode/.

Counterpart of ocr_inference_tpu/compat/ctcdecode.py over the port's
``CTCDecoder``.

Implements the API the reference stack consumes (reference:
BDRC/inference.py:16-17,97-106,114-118; BDRC/label_encoder.py:4,69):
``build_ctcdecoder(labels, kenlm_model_path=..., unigrams=...)`` returning
a decoder with ``decode`` / ``decode_beams``, plus the ``decoder``
submodule carrying ``OutputBeam`` and ``build_ctcdecoder``.

Semantics: ``decode`` runs the framework's CTC best-path collapse (for
trained models identical to pyctcdecode's top-1 beam, and bit-consistent
with this framework's own pipeline output); ``decode_beams`` runs the
host prefix beam search with optional n-gram LM shallow fusion. A label
spelled ``""``, ``"<blk>"`` or ``"<pad>"`` at index 0 is the CTC blank
(the reference inserts ``"<blk>"`` there, inference.py:93, then strips it
from decoded text — with a true blank there is nothing to strip, which is
the behavior the strip was emulating).
"""

from __future__ import annotations

import types
from typing import NamedTuple, Optional, Sequence

import numpy as np

_BLANKS = ("", "<blk>", "<pad>", "<PAD>", "_")


class OutputBeam(NamedTuple):
    """pyctcdecode.decoder.OutputBeam-compatible result tuple."""

    text: str
    last_lm_state: object
    text_frames: list
    logit_score: float
    lm_score: float


class BeamSearchDecoderCTC:
    def __init__(
        self,
        labels: Sequence[str],
        kenlm_model_path: Optional[str] = None,
        unigrams: Optional[Sequence[str]] = None,
        alpha: float = 0.5,
        beta: float = 0.0,
    ):
        from ocr_inference_tpu_torch.core.data import KenLMConfig
        from ocr_inference_tpu_torch.decode.decoder import CTCDecoder

        labels = list(labels)
        blank_positions = [i for i, l in enumerate(labels) if l in _BLANKS]
        if blank_positions and blank_positions != [0]:
            raise ValueError(
                "CTC blank label must sit at index 0 "
                f"(found at {blank_positions})"
            )
        self.add_blank = bool(blank_positions)
        self.labels = labels
        charset = labels[1:] if self.add_blank else labels

        kenlm_config = None
        if kenlm_model_path is not None:
            path = str(kenlm_model_path)
            arpa = path[: -len(".binary")] + ".arpa" if path.endswith(
                ".binary"
            ) else path
            kenlm_config = KenLMConfig(
                kenlm_file=path,
                arpa_file=arpa,
                unigrams=list(unigrams) if unigrams else None,
                alpha=alpha,
                beta=beta,
            )
        self._decoder = CTCDecoder(charset, self.add_blank, kenlm_config)

    def _to_tv(self, logits) -> np.ndarray:
        arr = np.asarray(logits, dtype=np.float32)
        if arr.ndim != 2:
            raise ValueError(f"expected (T, V) logits, got {arr.shape}")
        return arr

    def decode(self, logits, beam_width: int = 100) -> str:
        return self._decoder.ctc_decode(self._to_tv(logits))

    def decode_beams(
        self, logits, beam_width: int = 64, **_: object
    ) -> list[OutputBeam]:
        self._decoder.ctc_beam_width = beam_width
        beams = self._decoder.ctc_beam_decode(self._to_tv(logits))
        return [
            OutputBeam(
                text=b.text,
                last_lm_state=None,
                text_frames=[],
                logit_score=float(b.logit_score),
                lm_score=float(b.lm_score)
                if b.lm_score is not None
                else float(b.logit_score),
            )
            for b in beams
        ]


def build_ctcdecoder(
    labels: Sequence[str],
    kenlm_model_path: Optional[str] = None,
    unigrams: Optional[Sequence[str]] = None,
    alpha: float = 0.5,
    beta: float = 0.0,
) -> BeamSearchDecoderCTC:
    return BeamSearchDecoderCTC(
        labels, kenlm_model_path=kenlm_model_path, unigrams=unigrams,
        alpha=alpha, beta=beta,
    )


# the ``pyctcdecode.decoder`` submodule surface
decoder = types.ModuleType("pyctcdecode.decoder")
decoder.OutputBeam = OutputBeam
decoder.build_ctcdecoder = build_ctcdecoder
decoder.BeamSearchDecoderCTC = BeamSearchDecoderCTC
