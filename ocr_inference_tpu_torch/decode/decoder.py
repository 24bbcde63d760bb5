"""High-level CTC decoder bound to a charset (counterpart of
ocr_inference_tpu/decode/decoder.py; reference: BDRC/inference.py:75-118):
blank "<blk>" at vocab index 0 when add_blank, the charset.index+1 encode
shift, greedy decode on the logits' device, beam decode on the host
returning scored hypotheses, with optional n-gram LM fusion.

Deliberate differences from the JAX decoder: an ARPA file is always served
by the C++ scorer (``native.NativeArpaLM``): there is no switch to the
Python scorer and no fall-through to it, and a scorer that fails to build
or load raises RuntimeError to the caller (native._load turns the
OSErrors of g++, the build directory and ctypes into it). Only an error in the LM file itself — missing,
unreadable, without n-grams, or a ``.binary`` that fails to parse or its
cross-check with no sibling ``.arpa`` to fall back to — disables the LM
with a message on stderr, as in the JAX package.
"""

from __future__ import annotations

import struct
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ocr_inference_tpu_torch.core.data import KenLMConfig
from ocr_inference_tpu_torch.decode.arpa_lm import ArpaLM
from ocr_inference_tpu_torch.decode.ctc import (
    Beam,
    beam_search,
    greedy_decode,
    ids_to_tokens,
)
from ocr_inference_tpu_torch.decode.ctc_batch import beam_search_batch

# errors of an LM file (missing, unreadable, truncated, corrupt), as
# opposed to errors of the program or its build, which raise RuntimeError
LM_FILE_ERRORS = (OSError, ValueError, struct.error)


def _crosscheck_binary(binary, arpa_path: Path, n_samples: int = 32,
                       tol: float = 1e-4) -> bool:
    """Spot-check a binary LM's scores against the sibling ``.arpa``
    (decoder.py:22-45): up to ``n_samples`` n-grams of every order straight
    from the ARPA table, four backoff queries and one OOV query, each
    within ``tol`` log10."""
    ref = ArpaLM(arpa_path)
    grams = list(ref._table.keys())
    stride = max(1, len(grams) // n_samples)
    probes = grams[::stride][:n_samples]
    # backoff paths: unseen high-order continuations of seen grams; OOV
    probes += [g + ("\x00unseen\x00",) for g in probes[:4]]
    probes += [("\x00oov\x00",)]
    for gram in probes:
        ctx, tok = tuple(gram[:-1]), gram[-1]
        if abs(binary.score(ctx, tok) - ref.score(ctx, tok)) > tol:
            return False
    return True


def _load_lm(kenlm_config: KenLMConfig):
    """The n-gram scorer for a KenLM config (decoder.py:48-106).

    A readable ``.arpa`` wins and is served by the C++ scorer. A
    ``.binary`` is read through decode.kenlm_binary (probing) or
    decode.kenlm_trie (trie) when it is the only artifact; when it fails to
    parse or its scores diverge from a sibling ``.arpa``, the sibling is
    used instead (the reference always downloads the pair, BDRC/utils.py:
    132-159)."""
    from ocr_inference_tpu_torch.native import NativeArpaLM

    path = Path(kenlm_config.arpa_file)
    if str(path).endswith(".binary") or (
        not path.is_file() and str(kenlm_config.kenlm_file).endswith(".binary")
    ):
        from ocr_inference_tpu_torch.decode.kenlm_trie import open_binary

        binary = path if str(path).endswith(".binary") else Path(
            kenlm_config.kenlm_file
        )
        sibling = (
            path if path.is_file() and not str(path).endswith(".binary")
            else binary.with_suffix(".arpa")
        )
        try:
            model = open_binary(binary)  # probing or trie by model_type
            if sibling.is_file() and not _crosscheck_binary(model, sibling):
                raise ValueError(
                    "binary scores diverge from the sibling .arpa"
                )
            return model
        except LM_FILE_ERRORS as e:
            if not sibling.is_file():
                raise
            # stderr: a server speaks JSONL on stdout
            print(f"KenLM binary unusable ({e}); using {sibling}",
                  file=sys.stderr)
            path = sibling
    lm = NativeArpaLM(path)
    if lm.order < 1:
        raise ValueError(f"{path}: no n-gram sections (not an ARPA file)")
    return lm


class CTCDecoder:
    """Charset-bound CTC decoder (reference: BDRC/inference.py:75-118)."""

    blank_sign = "<blk>"

    def __init__(
        self,
        charset: str | Sequence[str],
        add_blank: bool,
        kenlm_config: Optional[KenLMConfig] = None,
        beam_width: int = 64,
    ):
        self.charset = list(charset)
        self.add_blank = add_blank
        self.ctc_beam_width = beam_width
        self.ctc_vocab = self.charset.copy()
        if add_blank:
            self.ctc_vocab.insert(0, self.blank_sign)

        self._lm = None
        self._lm_score_fn = None
        self.lm_alpha = kenlm_config.alpha if kenlm_config else 0.5
        self.lm_beta = kenlm_config.beta if kenlm_config else 0.0
        if kenlm_config is not None:
            try:
                self._lm = _load_lm(kenlm_config)
            except LM_FILE_ERRORS as e:
                # as the reference (inference.py:102-104): a bad LM file
                # decodes without the LM; stderr keeps stdout clean
                print(f"KenLM disabled: {e}", file=sys.stderr)
            else:
                self._lm_score_fn = self._lm.make_score_fn(
                    self.charset, self.add_blank
                )

    @property
    def has_lm(self) -> bool:
        return self._lm is not None

    # -- label <-> id (reference: BDRC/inference.py:108-112) --

    def encode(self, label: str) -> list[int]:
        return [self.charset.index(x) + 1 for x in label]

    def decode(self, inputs: Sequence[int]) -> str:
        return "".join(self.charset[x - 1] for x in inputs)

    # -- CTC decode --

    def ctc_decode_batch(self, logits) -> list[str]:
        """Greedy decode of a (B, T, V) batch where the logits are (a
        tensor on the card stays there; only the ids come back)."""
        ids, lengths, _ = greedy_decode(torch.as_tensor(logits))
        ids = ids.cpu().numpy()
        lengths = lengths.cpu().numpy()
        return [
            "".join(ids_to_tokens(ids[b], int(lengths[b]), self.charset,
                                  self.add_blank))
            for b in range(ids.shape[0])
        ]

    def ctc_decode(self, logits) -> str:
        """Single-line greedy decode of (T, V) logits
        (reference: BDRC/inference.py:114-115)."""
        arr = torch.as_tensor(logits)
        if arr.ndim == 2:
            arr = arr[None]
        return self.ctc_decode_batch(arr)[0]

    def ctc_beam_decode(
        self, logits, use_lm: bool = True, top_k: int = 10
    ) -> list[Beam]:
        """Beam decode of one line's (T, V) logits on the host
        (reference: BDRC/inference.py:117-118)."""
        return beam_search(
            _host(logits),
            self.charset,
            add_blank=self.add_blank,
            beam_width=self.ctc_beam_width,
            lm_score_fn=self._lm_score_fn if use_lm else None,
            lm_alpha=self.lm_alpha,
            lm_beta=self.lm_beta,
            top_k=top_k,
        )

    def ctc_beam_decode_batch(
        self, logits, use_lm: bool = True, top_k: int = 10
    ) -> list[list[Beam]]:
        """Beam decode a whole (B, T, V) batch on the host: LM-free
        batches through the vectorized search (decode.ctc_batch); shallow
        LM fusion calls the scorer per candidate, so it stays per line."""
        arr = _host(logits)
        if use_lm and self._lm_score_fn is not None:
            return [
                self.ctc_beam_decode(arr[b], use_lm=True, top_k=top_k)
                for b in range(arr.shape[0])
            ]
        return beam_search_batch(
            arr,
            self.charset,
            add_blank=self.add_blank,
            beam_width=self.ctc_beam_width,
            top_k=top_k,
        )


def _host(logits) -> np.ndarray:
    """Logits as a host numpy array (a tensor is copied from its device)."""
    if isinstance(logits, torch.Tensor):
        return logits.detach().cpu().numpy()
    return np.asarray(logits)
