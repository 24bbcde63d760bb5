"""The port's greedy CTC decode against ocr_inference_tpu.decode.ctc."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_inference_tpu.decode import ctc as jctc
from ocr_inference_tpu_torch.decode import ctc


@pytest.mark.parametrize("shape", [(4, 128, 78), (3, 750, 36), (1, 5, 3)])
def test_greedy_packed_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    # blank-heavy rows and repeats, as real CTC output has
    x[0, ::3, 0] += 8.0
    x[-1, 1:4, 1] += 20.0
    want = np.asarray(jctc.greedy_decode_packed(jnp.asarray(x)))
    got = ctc.greedy_decode_packed(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.int32
    # ids and lengths exactly
    np.testing.assert_array_equal(got[:, :-1], want[:, :-1])
    # conf: float32 sums over T and V taken in another order; 1e-5 relative
    # covers the last-ulp differences of a mean of up to 750 terms
    _, _, conf_got = ctc.unpack_greedy_host(got)
    _, _, conf_want = jctc.unpack_greedy_host(want)
    np.testing.assert_allclose(conf_got, conf_want, rtol=1e-5)


def test_ids_to_tokens_matches_jax():
    charset = list("abcdef")
    ids = np.array([3, 1, 0, -1, 5], np.int32)
    for add_blank in (True, False):
        assert ctc.ids_to_tokens(ids, 5, charset, add_blank) == \
            jctc.ids_to_tokens(ids, 5, charset, add_blank)
