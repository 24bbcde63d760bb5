"""The port's Flax-msgpack reader and its UNet / Easter2 against the Flax
modules, on the same weights (float32, logits within 1e-3)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ocr_inference_tpu.models import UNet as FlaxUNet, build_recognizer
from ocr_inference_tpu.models.params import (
    init_recognizer, init_segmentation, load_params,
)
from ocr_inference_tpu_torch.models.params import (
    load_flax_weights, params_from_flax, read_msgpack,
)
from ocr_inference_tpu_torch.models.recognition import Easter2
from ocr_inference_tpu_torch.models.segmentation import UNet

REPO = Path(__file__).resolve().parents[1]
REFPIPE = REPO / "tests" / "data" / "refpipe"
FULL = REPO / "artifacts" / "full77f"


@pytest.mark.parametrize("path", [REFPIPE / "lines.msgpack",
                                  REFPIPE / "recognizer.msgpack"])
def test_reader_matches_flax_serialization(path):
    ours = read_msgpack(path)
    want = serialization.msgpack_restore(path.read_bytes())
    a = jax.tree_util.tree_leaves_with_path(ours)
    b = jax.tree_util.tree_leaves_with_path(want)
    assert len(a) == len(b) > 0
    for (pa, va), (pb, vb) in zip(a, b):
        assert pa == pb
        assert va.dtype == vb.dtype and va.shape == vb.shape
        np.testing.assert_array_equal(va, vb)


def test_params_from_flax_orders_layers_numerically():
    keys = list(params_from_flax(read_msgpack(REFPIPE / "lines.msgpack")))
    convbn = [k.split(".")[0] for k in keys if k.startswith("ConvBN_")]
    order = list(dict.fromkeys(convbn))
    assert order == [f"ConvBN_{i}" for i in range(len(order))]
    assert keys.index("ConvBN_2.Conv_0.weight") < keys.index(
        "ConvBN_10.Conv_0.weight")


def _unet_pair(path, width, stem):
    flax_model = FlaxUNet(classes=1, width=width, stem_stride=stem,
                          dtype=jnp.float32)
    variables = load_params(init_segmentation(flax_model, 64), path)
    model = UNet(classes=1, width=width, stem_stride=stem).eval()
    load_flax_weights(model, path)
    return flax_model, variables, model


def _easter_pair(path, vocab, stem, width_mult):
    flax_model = build_recognizer("Easter2", vocab, width_mult=width_mult,
                                  stem_features=stem, dtype=jnp.float32)
    variables = load_params(init_recognizer(flax_model, 80, 256), path)
    model = Easter2(vocab, 80, stem_features=stem, width_mult=width_mult).eval()
    load_flax_weights(model, path)
    return flax_model, variables, model


def _unet_close(flax_model, variables, model, x):
    want = np.asarray(flax_model.apply(variables, x, train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-3, rtol=0)


def _easter_close(flax_model, variables, model, x):
    want = np.asarray(flax_model.apply(variables, x, train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_refpipe_unet_logits_match_flax():
    rng = np.random.default_rng(0)
    x = (rng.random((2, 128, 128, 3)) > 0.3).astype(np.float32)
    _unet_close(*_unet_pair(REFPIPE / "lines.msgpack", 8, 1), x)


@pytest.mark.parametrize("width", [320, 317, 512])
def test_refpipe_easter2_logits_match_flax(width):
    """Odd and even widths: SAME padding is computed per input width."""
    rng = np.random.default_rng(width)
    x = np.where(rng.random((2, 80, width)) > 0.2, 1.0, -1.0).astype(np.float32)
    _easter_close(*_easter_pair(REFPIPE / "recognizer.msgpack", 36, 64, 0.25), x)


def test_full77f_unet_tile_logits_match_flax():
    rng = np.random.default_rng(1)
    x = np.full((1, 512, 512, 3), 1.0, np.float32)
    x[0, 100:140, 40:470] = (rng.random((40, 430, 1)) > 0.5)
    _unet_close(*_unet_pair(FULL / "lines.msgpack", 32, 2), x)


def test_full77f_easter2_canvas_logits_match_flax():
    rng = np.random.default_rng(2)
    x = np.full((1, 80, 512), 1.0, np.float32)
    x[0, 20:60, 10:480] = np.where(rng.random((40, 470)) > 0.5, 1.0, -1.0)
    _easter_close(*_easter_pair(FULL / "recognizer.msgpack", 78, 128, 1.0), x)
