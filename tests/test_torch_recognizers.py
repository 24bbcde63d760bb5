"""The port's other recognizers (Easter2-Attention, Easter2-Vit, CRNN)
against the Flax modules of ocr_inference_tpu/models/recognition.py on the
same seeded weights, in float32: logits within 1e-3 (the bar of
ROADMAP.md) at a small size and at full width; ``build_recognizer``'s
names; the strict weight mapping both ways; the seeded draws (new leaves
drawn as Flax draws them, the existing models' draws unchanged); and the
builder at full width for all five names."""

import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_inference_tpu.models import build_recognizer as flax_recognizer
from ocr_inference_tpu_torch.core.data import CharsetEncoder, OCRModelConfig
from ocr_inference_tpu_torch.models.params import (
    _leaves,
    flax_shapes,
    load_flax_tree,
    params_from_flax,
    seeded_flax_params,
)
from ocr_inference_tpu_torch.models.recognition import build_recognizer
from ocr_inference_tpu_torch.models.segmentation import DeepLabV3Plus, UNet
from ocr_inference_tpu_torch.pipeline.builder import build_recognition_engine

NEW = ("Easter2-Attention", "Easter2-Vit", "CRNN")
NAMES = ("Easter2", "Easter2b", "Easter2-Attention", "Easter2-Vit", "CRNN")
VOCAB = 78  # full77f's 77 units and the blank
# reduced widths of the CPU tests (full width: stem 128, blocks of
# 256/256/512, 8 heads of 64; CRNN hidden 256)
SMALL = {"Easter2-Attention": {"width_mult": 0.125, "stem_features": 16},
         "Easter2-Vit": {"width_mult": 0.125, "stem_features": 16},
         "CRNN": {"hidden": 32}}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _pair(arch: str, seed: int, **kwargs):
    """The port's module and the Flax module with the same seeded weights
    at the Flax initialisers' scale (no head gain)."""
    model = build_recognizer(arch, VOCAB, **kwargs).eval()
    tree = seeded_flax_params(flax_shapes(model), seed)
    load_flax_tree(model, tree)
    flax_model = flax_recognizer(arch, VOCAB, dtype=jnp.float32, **kwargs)
    return model, flax_model, tree


def _max_diff(model, flax_model, tree, x) -> float:
    want = np.asarray(flax_model.apply(tree, x, train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (x.shape[0], x.shape[2] // 4, VOCAB)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("arch", NEW)
def test_small_logits_match_flax(arch, width):
    """(4, 80, W) in [-1, 1]; measured on the CPU: at most 3e-6."""
    x = np.random.default_rng(width).uniform(-1, 1, (4, 80, width))
    assert _max_diff(*_pair(arch, 3, **SMALL[arch]),
                     x.astype(np.float32)) <= 1e-3


@pytest.mark.parametrize("arch", NEW)
def test_full_width_logits_match_flax(arch):
    """One (1, 80, 256) forward at the JAX defaults' full width; measured
    on the CPU: at most 4e-6."""
    x = np.random.default_rng(5).uniform(-1, 1, (1, 80, 256))
    assert _max_diff(*_pair(arch, 0), x.astype(np.float32)) <= 1e-3


@pytest.mark.parametrize("name", [*NAMES, "EASTER2-VIT", "crnn", "easter2B"])
def test_build_recognizer_takes_the_same_names(name):
    model = build_recognizer(name, VOCAB, **SMALL.get(name, {}))
    flax_model = flax_recognizer(name, VOCAB)
    assert type(model).__name__ == type(flax_model).__name__
    variant = getattr(flax_model, "variant", None)
    if variant is not None:
        blocks = sum(k.startswith("MHSABlock_")
                     for k, _ in model.named_children())
        assert blocks == {"base": 0, "attention": 2, "vit": 4}[variant]


@pytest.mark.parametrize("name", ["Easter3", "crnn2", "", "ViT"])
def test_build_recognizer_refuses_unknown_names(name):
    with pytest.raises(ValueError, match="Unknown recognizer"):
        build_recognizer(name, VOCAB)
    with pytest.raises(ValueError, match="Unknown recognizer"):
        flax_recognizer(name, VOCAB)


@pytest.mark.parametrize("arch", NEW)
def test_flax_tree_round_trip_is_strict(arch):
    """flax_shapes gives the Flax module's own tree; params_from_flax maps
    every leaf to exactly the module's state dict; a missing or an extra
    leaf is refused."""
    model = build_recognizer(arch, VOCAB, **SMALL[arch])
    flax_model = flax_recognizer(arch, VOCAB, dtype=jnp.float32,
                                 **SMALL[arch])
    init = jax.eval_shape(flax_model.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 80, 64)))
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), init)
    assert flax_shapes(model) == want
    tree = seeded_flax_params(flax_shapes(model), 1)
    state = params_from_flax(tree)
    own = {k: v for k, v in model.state_dict().items()
           if "num_batches" not in k}
    assert set(state) == set(own)
    assert all(state[k].shape == own[k].shape for k in own)

    params = tree["params"]
    if arch == "CRNN":
        del params["GRUCell_3"]["hn"]["bias"]
    else:
        del params["MHSABlock_1"]["LayerNorm_0"]["scale"]
    with pytest.raises(KeyError):
        load_flax_tree(model, tree)
    tree = seeded_flax_params(flax_shapes(model), 1)
    tree["params"]["Extra_0"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="unexpected"):
        load_flax_tree(model, tree)


def test_gru_mapping_follows_flax_cells():
    """Cell k = layer k // 2, the backward direction for odd k; gates in
    torch's r, z, n order; b_hh zero for r and z, hn's bias for n."""
    model = build_recognizer("CRNN", VOCAB, hidden=4)
    tree = seeded_flax_params(flax_shapes(model), 2)
    for cell in tree["params"].values():
        for gate in cell.values() if "hn" in cell else ():
            if "bias" in gate:
                gate["bias"] = np.random.default_rng(0).standard_normal(
                    gate["bias"].shape).astype(np.float32)
    state = params_from_flax(tree)
    cell = tree["params"]["GRUCell_3"]
    np.testing.assert_array_equal(state["BiGRU.weight_ih_l1_reverse"],
                                  np.concatenate([cell[g]["kernel"].T for g
                                                  in ("ir", "iz", "in")]))
    np.testing.assert_array_equal(state["BiGRU.weight_hh_l1_reverse"],
                                  np.concatenate([cell[g]["kernel"].T for g
                                                  in ("hr", "hz", "hn")]))
    np.testing.assert_array_equal(state["BiGRU.bias_ih_l1_reverse"],
                                  np.concatenate([cell[g]["bias"] for g
                                                  in ("ir", "iz", "in")]))
    np.testing.assert_array_equal(state["BiGRU.bias_hh_l1_reverse"],
                                  np.concatenate([np.zeros(8, np.float32),
                                                  cell["hn"]["bias"]]))


def test_seeded_draws_of_new_leaves_follow_flax():
    """Attention query/key/value kernels (C, 8, d): variance 1/C (fan-in
    over the input axis, not 8C); the output kernel 1/C too (fan-in 8d =
    C); GRU recurrent kernels orthogonal; LayerNorm scale 1, bias 0."""
    easter = build_recognizer("Easter2-Vit", VOCAB)
    tree = seeded_flax_params(flax_shapes(easter), 0)["params"]
    attn = tree["MHSABlock_3"]["MultiHeadDotProductAttention_0"]
    for proj in ("query", "key", "value", "out"):
        std = float(attn[proj]["kernel"].std())
        assert abs(std * np.sqrt(512) - 1.0) < 0.02, (proj, std)
    ln = tree["MHSABlock_0"]["LayerNorm_1"]
    assert (ln["scale"] == 1).all() and (ln["bias"] == 0).all()
    crnn = build_recognizer("CRNN", VOCAB)
    cells = seeded_flax_params(flax_shapes(crnn), 0)["params"]
    for k in range(4):
        for gate in ("hr", "hz", "hn"):
            q = cells[f"GRUCell_{k}"][gate]["kernel"].astype(np.float64)
            np.testing.assert_allclose(q.T @ q, np.eye(256), atol=1e-5)
        std = float(cells[f"GRUCell_{k}"]["ir"]["kernel"].std())
        fan_in = 256 if k < 2 else 512
        assert abs(std * np.sqrt(fan_in) - 1.0) < 0.02


def _tree_hash(tree: dict) -> tuple[int, str]:
    digest = hashlib.sha256()
    n = 0
    for collection in sorted(tree):
        for path, arr in sorted(_leaves(tree[collection])):
            digest.update("/".join((collection, *path)).encode())
            digest.update(np.ascontiguousarray(arr).tobytes())
            n += 1
    return n, digest.hexdigest()


# The seeded trees of the models that had seeded weights before the other
# recognizers came: leaf count and sha256 of every path and value, taken
# with the draw as it was. The layout record
# (tests/data/torch_port/layout.json, its masks and texts) rests on the
# DeepLabV3+ tree at its seed.
_LAYOUT_SEED = 2
EXISTING_DRAWS = {
    "deeplabv3_5_classes": (
        lambda: DeepLabV3Plus(5), _LAYOUT_SEED, 147,
        "4fa2c01a56d8a5d36e95bbd09422f5f9b47faf34a7d0bd9d400b9d889e2dc9ff"),
    "easter2_full77f": (
        lambda: build_recognizer("Easter2", VOCAB), 0, 94,
        "497244efa5b6d76113de79c6162fd72e303f19bd48220882461bb25616e54475"),
    "unet_stem2": (
        lambda: UNet(classes=1, width=32, stem_stride=2), 0, 110,
        "7a11f5bd37c334dab292fea4e707b3350b30a09c1a6784e1a9412ed0b9e921d9"),
}


@pytest.mark.parametrize("name", sorted(EXISTING_DRAWS))
def test_existing_models_seeded_draws_did_not_move(name):
    from pathlib import Path

    make, seed, leaves, digest = EXISTING_DRAWS[name]
    if name.startswith("deeplab"):
        record = json.loads((Path(__file__).parent / "data" / "torch_port"
                             / "layout.json").read_text(encoding="utf-8"))
        assert record["seed"] == seed
    assert _tree_hash(seeded_flax_params(flax_shapes(make()), seed)) == (
        leaves, digest)


def _config(arch: str, model_file: str = "") -> OCRModelConfig:
    return OCRModelConfig(
        model_file=model_file, architecture=arch, input_width=3000,
        input_height=80, input_layer="input", output_layer="output",
        squeeze_channel=True, swap_hw=False, encoder=CharsetEncoder.WYLIE,
        charset=[f"t{i}" for i in range(VOCAB - 1)], add_blank=True,
        version="seeded")


@pytest.mark.parametrize("arch", NAMES)
def test_builder_builds_every_name_at_full_width(arch):
    engine = build_recognition_engine(_config(arch), dtype=torch.float32,
                                      device="cpu", allow_random=True)
    model = engine.model
    assert type(model).__name__ == ("CRNN" if arch == "CRNN" else "Easter2")
    head = getattr(model, model._head_name)
    assert head.weight.dtype == torch.float32
    widths = {p.shape[0] for n, p in model.named_parameters()
              if n.endswith("LayerNorm_0.weight")}
    assert widths <= {512}
    if arch == "CRNN":
        assert model.BiGRU.hidden_size == 256
        assert model.Dense_0.in_features == 5 * 512
    texts = engine.run_batch([np.full((40, 300), 255, np.uint8)])
    assert len(texts) == 1


def test_builder_reads_widths_from_the_sidecar(tmp_path):
    """width_mult / stem_features / hidden come from the weights' meta, as
    in the JAX builder; a sidecar key the module does not take fails."""
    from ocr_inference_tpu.models.params import save_params

    for arch, kwargs in SMALL.items():
        tree = seeded_flax_params(
            flax_shapes(build_recognizer(arch, VOCAB, **kwargs)), 4)
        save_params(tree, tmp_path / f"{arch}.msgpack",
                    {"architecture": arch, **kwargs})
        engine = build_recognition_engine(
            _config(arch, str(tmp_path / f"{arch}.onnx")),
            dtype=torch.float32, device="cpu")
        state = engine.model.state_dict()
        for key, want in params_from_flax(tree).items():
            assert torch.equal(state[key], want), key
    with pytest.raises(ValueError, match="Unknown recognizer"):
        build_recognition_engine(_config("Easter3"), device="cpu",
                                 allow_random=True)
