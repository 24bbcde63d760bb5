"""The port's CTC prefix beam search against the JAX package's on seeded
logits: the scalar search with no LM, the Python LM and the C++ LM, the
vectorized batch search, the port's batch against its own scalar search,
and the charset-bound decoder. Against the JAX package, beams are compared
exactly: tokens, texts, ``logit_score`` and ``lm_score``. The batch search
merges prefixes with another float64 arithmetic than the scalar search
(a segmented max + log-sum-exp against pairwise ``logaddexp``), in both
packages, so the port's batch and scalar searches agree exactly on tokens
and texts and to the last bits (rtol 1e-12) on scores."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_inference_tpu.core.data import KenLMConfig as JaxKenLMConfig
from ocr_inference_tpu.decode.arpa_lm import ArpaLM as JaxArpaLM
from ocr_inference_tpu.decode.ctc import beam_search as jax_beam_search
from ocr_inference_tpu.decode.ctc_batch import (
    beam_search_batch as jax_beam_search_batch,
)
from ocr_inference_tpu.decode.decoder import CTCDecoder as JaxCTCDecoder
from ocr_inference_tpu.eval.synthetic import WYLIE_CHARSET_FULL
from ocr_inference_tpu.native import NativeArpaLM as JaxNativeArpaLM
from ocr_inference_tpu_torch.core.data import KenLMConfig
from ocr_inference_tpu_torch.decode import Beam, CTCDecoder, beam_search
from ocr_inference_tpu_torch.decode.arpa_lm import ArpaLM
from ocr_inference_tpu_torch.decode.ctc_batch import beam_search_batch
from ocr_inference_tpu_torch.native import NativeArpaLM

REPO = Path(__file__).resolve().parents[1]
LM = REPO / "artifacts" / "full77f" / "lm.arpa"
CHARSET = list(WYLIE_CHARSET_FULL)  # the full77f charset, the LM's tokens


def _logits(kind: str, seed: int, lines: int, frames: int,
            add_blank: bool) -> np.ndarray:
    """(lines, frames, vocab) float32 logits over the 77-unit charset (plus
    the blank). ``peaky``: CTC-like, one clear winner per frame, mostly
    blank, a quarter of the frames with a runner-up within about one nat;
    ``flat``: small random scores, every token a candidate of every frame.
    All scores are continuous, so no two hypotheses tie exactly."""
    vocab = len(CHARSET) + (1 if add_blank else 0)
    rng = np.random.RandomState(seed)
    if kind == "flat":
        return rng.normal(0.0, 0.5, (lines, frames, vocab)).astype(np.float32)
    x = rng.normal(0.0, 1.0, (lines, frames, vocab))
    win = np.where(rng.rand(lines, frames) < 0.6, 0,
                   rng.randint(0, vocab, (lines, frames)))
    np.put_along_axis(x, win[..., None],
                      12.0 + rng.rand(lines, frames, 1), axis=-1)
    runner = rng.randint(0, vocab, (lines, frames))
    close = rng.rand(lines, frames) < 0.25
    vals = np.where(close, 11.0, 4.0) + rng.rand(lines, frames)
    np.put_along_axis(x, runner[..., None], vals[..., None], axis=-1)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def scorers():
    return {
        "none": (None, None),
        "python": (ArpaLM(LM), JaxArpaLM(LM)),
        "native": (NativeArpaLM(LM), JaxNativeArpaLM(LM)),
    }


def _fields(beams):
    return [(b.text, b.tokens, b.logit_score, b.lm_score) for b in beams]


@pytest.mark.parametrize("lm", ["none", "python", "native"])
@pytest.mark.parametrize("width", [1, 16, 64])
@pytest.mark.parametrize("add_blank", [True, False])
@pytest.mark.parametrize("kind", ["peaky", "flat"])
def test_scalar_beam_search_equals_jax(scorers, kind, add_blank, width, lm):
    ours_lm, jax_lm = scorers[lm]
    frames = 48 if kind == "peaky" else 10
    logits = _logits(kind, 7 + width, 1, frames, add_blank)[0]
    kwargs = dict(add_blank=add_blank, beam_width=width, lm_alpha=0.7,
                  lm_beta=0.5, top_k=10)
    got = beam_search(
        logits, CHARSET,
        lm_score_fn=ours_lm and ours_lm.make_score_fn(CHARSET, add_blank),
        **kwargs)
    want = jax_beam_search(
        logits, CHARSET,
        lm_score_fn=jax_lm and jax_lm.make_score_fn(CHARSET, add_blank),
        **kwargs)
    assert all(isinstance(b, Beam) for b in got)
    assert len(got) == min(width, 10) or kind == "peaky"
    assert _fields(got) == _fields(want)
    assert (got[0].lm_score is None) == (lm == "none")


@pytest.mark.parametrize("width", [1, 16, 64])
@pytest.mark.parametrize("add_blank", [True, False])
@pytest.mark.parametrize("kind", ["peaky", "flat"])
def test_batch_beam_search_equals_jax_and_the_scalar_search(kind, add_blank,
                                                            width):
    frames = 64 if kind == "peaky" else 12
    logits = _logits(kind, 100 + width, 5, frames, add_blank)
    got = beam_search_batch(logits, CHARSET, add_blank=add_blank,
                            beam_width=width, top_k=10)
    want = jax_beam_search_batch(logits, CHARSET, add_blank=add_blank,
                                 beam_width=width, top_k=10)
    assert [_fields(b) for b in got] == [_fields(b) for b in want]
    scalar = [beam_search(line, CHARSET, add_blank=add_blank,
                          beam_width=width, top_k=10) for line in logits]
    for batch_beams, line_beams in zip(got, scalar):
        assert [(b.text, b.tokens, b.lm_score) for b in batch_beams] == \
            [(b.text, b.tokens, b.lm_score) for b in line_beams]
        np.testing.assert_allclose([b.logit_score for b in batch_beams],
                                   [b.logit_score for b in line_beams],
                                   rtol=1e-12, atol=0)


def test_batch_search_takes_one_line_as_2d():
    logits = _logits("peaky", 3, 1, 30, True)
    assert _fields(beam_search_batch(logits[0], CHARSET)[0]) == \
        _fields(beam_search_batch(logits, CHARSET)[0])


@pytest.fixture(scope="module")
def decoders():
    cfg = dict(alpha=0.7, beta=0.5)
    return (CTCDecoder(CHARSET, True, KenLMConfig(str(LM), str(LM), None,
                                                  **cfg)),
            JaxCTCDecoder(CHARSET, True, JaxKenLMConfig(str(LM), str(LM),
                                                        None, **cfg)))


@pytest.mark.parametrize("use_lm", [False, True])
def test_decoder_beams_equal_jax(decoders, use_lm):
    ours, theirs = decoders
    assert ours.has_lm and theirs.has_lm
    assert isinstance(ours._lm, NativeArpaLM)
    logits = _logits("peaky", 21, 4, 40, True)
    got = ours.ctc_beam_decode_batch(torch.from_numpy(logits), use_lm=use_lm,
                                     top_k=3)
    want = theirs.ctc_beam_decode_batch(logits, use_lm=use_lm, top_k=3)
    assert [_fields(b) for b in got] == [_fields(b) for b in want]
    assert _fields(ours.ctc_beam_decode(logits[1], use_lm=use_lm)) == \
        _fields(theirs.ctc_beam_decode(logits[1], use_lm=use_lm))


def test_decoder_greedy_and_label_maps_equal_jax(decoders):
    ours, theirs = decoders
    logits = _logits("peaky", 5, 3, 40, True)
    assert ours.ctc_decode_batch(torch.from_numpy(logits)) == \
        theirs.ctc_decode_batch(jnp.asarray(logits))
    assert ours.ctc_decode(logits[0]) == theirs.ctc_decode(logits[0])
    assert ours.ctc_vocab == theirs.ctc_vocab
    label = "bsgrub§kyi"
    units = ["b", "s", "g", "r", "u", "b", "§", "k", "y", "i"]
    assert ours.encode(units) == theirs.encode(units)
    assert ours.decode(ours.encode(units)) == "".join(units) == label
