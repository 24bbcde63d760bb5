"""The port's training (ocr_inference_tpu_torch/training, models/params.py's
lifecycle, the models' train mode) against the JAX package's on the CPU,
on the same numpy inputs with the JAX init carried across, at small
widths.

Tolerances, float32 unless said:

- losses at 1e-5 relative; gradients per leaf at 1e-4 of the leaf's norm
  plus 1e-6 (a leaf whose gradient is 0 in exact arithmetic holds noise
  of about 1e-7);
- except for CRNN and DeepLabV3+, whose float32 gradients are not
  determined to 1e-4 by their inputs: a ReLU input within float noise of
  0 routes its element's gradient one way in one package and the other
  way in the other (the port's DeepLabV3+ forward flips 3 of the decoder's
  ReLUs against a float64 run at 64-pixel tiles, where a BatchNorm's
  variance E[x^2] - E[x]^2 cancels to 2.7e-4), and the flipped elements'
  gradients spread through every BatchNorm below. Both packages then lie
  up to 3% from the float64 gradient (the JAX package's DeepLabV3+
  encoder). For these two nets the reference is the JAX package's float64
  gradient (its Flax modules at dtype float64 under jax.enable_x64; their
  heads stay float32, as the JAX package builds them): the port's float64
  gradient equals it to 1e-5 of each leaf's norm (1.8e-7 at most on a
  CPU), so a fault in the port's backward shows, and each leaf of the
  port's float32 gradient lies as close to it as the JAX package's float32
  gradient does, up to a factor of 2, or within 5e-3 of its norm. A batch
  with a line that has no CTC alignment is held the same way: optax's
  recursion then runs at |log alpha| ~ 1e5, where float32 steps by 2^-7,
  and both packages' float32 gradients lie ~1e-3 from float64;
- updated parameters: every element within the most that Adam can move it
  across the steps, 2 * sum(lr) (Adam divides by the root of the second
  moment, so a gradient that is noise in both packages moves a parameter
  by up to lr either way: the key bias of an attention block, whose
  gradient is 0 in exact arithmetic, is one), and the mean distance under
  1e-3 of that;
- BatchNorm running statistics at 1e-5 relative (CRNN and DeepLabV3+:
  plus 1e-3 of the leaf's largest value, for the reason above: in
  DeepLabV3+ the ASPP projection's input holds the image-pool branch,
  whose BatchNorm over two 1x1 maps normalizes to +-1 and whose gradient
  is 0 in exact arithmetic);
- bf16 (selftrain's recognizer): the loss within 2% of the JAX bf16 loss,
  which itself lies within 2% of the float32 loss in both packages: bf16
  has 8 bits of mantissa (0.4% a rounding), and the two packages round
  at different places (Flax per op, autocast at each conv and matmul)."""

import contextlib
import copy
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from ocr_inference_tpu.eval.synthetic import WYLIE_CHARSET_FULL
from ocr_inference_tpu.models import recognition as JR
from ocr_inference_tpu.models import segmentation as JS
from ocr_inference_tpu.models import params as JP
from ocr_inference_tpu.training import segmentation as JTS
from ocr_inference_tpu.training import train as JT
from ocr_inference_tpu_torch.models import params as P
from ocr_inference_tpu_torch.models.recognition import build_recognizer
from ocr_inference_tpu_torch.models.segmentation import DeepLabV3Plus, UNet
from ocr_inference_tpu_torch.parallel import make_mesh, tp_shardings
from ocr_inference_tpu_torch.training import segmentation as TS
from ocr_inference_tpu_torch.training import train as T

VOCAB = 12
H, W = 80, 128
# the narrowest widths of each recognizer and of the segmentation nets
SMALL = {
    "Easter2": {"width_mult": 0.03125, "stem_features": 16},
    "Easter2b": {"width_mult": 0.03125, "stem_features": 16},
    "Easter2-Attention": {"width_mult": 0.03125, "stem_features": 16},
    "Easter2-Vit": {"width_mult": 0.03125, "stem_features": 16},
    "CRNN": {"hidden": 16},
}
SEG = {"unet": ({"width": 8}, 1), "unet_stem2": ({"width": 8, "stem_stride": 2}, 1),
       "deeplab": ({}, 3)}
LR, TOTAL, WARMUP = 1e-2, 20, 0


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_model(name: str, dtype=jnp.float32):
    """The Flax model of a recognizer (SMALL) or segmentation net (SEG)."""
    if name in SMALL:
        return JR.build_recognizer(name, VOCAB, dtype=dtype, **SMALL[name])
    kwargs, classes = SEG[name]
    if name == "deeplab":
        return JS.DeepLabV3Plus(classes=classes, dtype=dtype)
    return JS.UNet(classes=classes, dtype=dtype, **kwargs)


def _rec_pair(arch: str, seed: int = 0):
    """(port model, Flax model, Flax variables of the JAX init)."""
    jm = _jax_model(arch)
    variables = _np(JP.init_recognizer(jm, H, W, seed=seed))
    tm = build_recognizer(arch, VOCAB, H, **SMALL[arch])
    P.load_flax_tree(tm, variables)
    return tm, jm, variables


def _seg_pair(name: str, seed: int = 0):
    kwargs, classes = SEG[name]
    jm = _jax_model(name)
    tm = DeepLabV3Plus(classes=classes) if name == "deeplab" else \
        UNet(classes=classes, **kwargs)
    variables = _np(JP.init_segmentation(jm, 64, seed=seed))
    P.load_flax_tree(tm, variables)
    return tm, jm, variables, classes


def _rec_batch(seed: int = 1, batch: int = 3, max_label: int = 10):
    return JT.synthetic_ctc_batch(batch, H, W, VOCAB, max_label, seed=seed)


def _seg_batch(classes: int, seed: int = 1, batch: int = 2, patch: int = 64):
    return JTS.synthetic_seg_batch(batch, patch, classes, seed=seed)


def _jax_rec_loss(jm, batch):
    def loss_fn(params, batch_stats):
        logits, mutated = jm.apply(
            {"params": params, "batch_stats": batch_stats}, batch["images"],
            train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        lengths = jnp.minimum(batch["image_widths"] // 4, logits.shape[1])
        return JT.ctc_loss_fn(logits, lengths, batch["labels"],
                              batch["label_lengths"]), mutated["batch_stats"]
    return loss_fn


def _jax_seg_loss(jm, batch):
    def loss_fn(params, batch_stats):
        logits, mutated = jm.apply(
            {"params": params, "batch_stats": batch_stats}, batch["images"],
            train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        return JTS.seg_loss_fn(logits, batch["targets"]), \
            mutated["batch_stats"]
    return loss_fn


def _grad_tree(model, grads) -> dict:
    """The port's gradients as a Flax params tree."""
    g = copy.deepcopy(model)
    with torch.no_grad():
        for (_, p), d in zip(g.named_parameters(), grads):
            p.copy_(d)
    return P.flax_variables(g)["params"]


def _pairs(a: dict, b: dict, prefix=()):
    assert set(a) == set(b), (prefix, sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            yield from _pairs(a[k], b[k], prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(a[k]), np.asarray(b[k])


ILL_CONDITIONED = ("CRNN", "deeplab")


def _assert_grads(got: dict, want: dict, rel: float = 1e-4):
    for name, g, w in _pairs(got, want):
        err = np.linalg.norm((g - w).ravel())
        assert err <= rel * np.linalg.norm(w.ravel()) + 1e-6, (name, err)


def _f64(tree):
    """A tree's (or batch's) float32 arrays as float64."""
    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        if np.asarray(a).dtype == np.float32 else a, tree)


@contextlib.contextmanager
def _float64_flax():
    """jax.enable_x64, and Flax GRU carries in float64 (GRUCell makes its
    carry in its param_dtype, float32 unless given)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn, "GRUCell",
                   functools.partial(nn.GRUCell, param_dtype=jnp.float64))
        with jax.enable_x64(True):
            yield


def _jax_grads_f64(name: str, variables: dict, batch: dict) -> dict:
    """The JAX package's gradient in float64: the Flax modules at dtype
    float64 over float64 parameters and inputs. Their heads stay float32,
    as the JAX package builds them; optax's CTC recursion runs in
    float64."""
    loss = _jax_rec_loss if name in SMALL else _jax_seg_loss
    with _float64_flax():
        jm, v = _jax_model(name, jnp.float64), _f64(variables)
        _, grads = jax.value_and_grad(loss(jm, _f64(batch)), has_aux=True)(
            v["params"], v["batch_stats"])
        return _np(grads)


def _assert_grads_f64(name, model, loss_fn, batch, variables, got: dict,
                      want: dict):
    """The float64 reference bar (module docstring): the port's float64
    gradient equals the JAX package's float64 gradient to 1e-5 of each
    leaf's norm; the port's float32 gradient lies as close to it as the
    JAX package's float32 gradient does, up to a factor of 2, or within
    5e-3 of its norm."""
    ref = _jax_grads_f64(name, variables, batch)
    m64 = copy.deepcopy(model).double()
    b64 = {k: torch.from_numpy(a) for k, a in _f64(batch).items()}
    _, g64 = T.value_and_grad(m64, loss_fn, b64)
    for (leaf, g, w), (_, o64, r) in zip(_pairs(got, want),
                                          _pairs(_grad_tree(m64, g64), ref)):
        norm = np.linalg.norm(r.ravel()) + 1e-12
        assert np.linalg.norm((o64 - r).ravel()) <= 1e-5 * norm, leaf
        ours = np.linalg.norm((g - r).ravel()) / norm
        theirs = np.linalg.norm((w - r).ravel()) / norm
        assert ours <= max(2 * theirs, 5e-3), (leaf, ours, theirs)


def _check_grads(name, model, loss_fn, batch, variables, got, want):
    if name in ILL_CONDITIONED:
        _assert_grads_f64(name, model, loss_fn, batch, variables, got, want)
    else:
        _assert_grads(got, want)


def _assert_params(got: dict, want: dict, moved: float):
    """Every element within ``moved`` (2 * sum(lr)), the mean distance
    under 1e-3 of it."""
    diffs = [np.abs(g - w) for _, g, w in _pairs(got, want)]
    assert max(float(d.max()) for d in diffs) <= moved
    total = sum(float(d.sum()) for d in diffs)
    count = sum(d.size for d in diffs)
    assert total / count <= 1e-3 * moved


def _assert_stats(got: dict, want: dict, ill_conditioned: bool = False):
    for name, g, w in _pairs(got, want):
        atol = 1e-3 * float(np.abs(w).max()) if ill_conditioned else 1e-6
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol, err_msg=name)


def _sum_lr(steps: int) -> float:
    sched = optax.warmup_cosine_decay_schedule(
        0.0, LR, WARMUP, max(TOTAL, WARMUP + 1))
    return float(sum(sched(i) for i in range(steps)))


# -- the losses --

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_loss_and_its_logit_gradient_equal_optax(seed):
    rng = np.random.default_rng(seed)
    b, t, v, length = 4, 24, 9, 7
    logits = rng.normal(size=(b, t, v)).astype(np.float32) * 3
    logit_lengths = rng.integers(16, t + 1, size=b).astype(np.int32)
    labels = rng.integers(1, v, size=(b, length)).astype(np.int32)
    label_lengths = rng.integers(1, length + 1, size=b).astype(np.int32)
    labels[np.arange(length)[None] >= label_lengths[:, None]] = 0
    want, want_g = jax.value_and_grad(JT.ctc_loss_fn)(
        jnp.asarray(logits), logit_lengths, labels, label_lengths)
    x = torch.from_numpy(logits).requires_grad_()
    got = T.ctc_loss_fn(x, torch.from_numpy(logit_lengths),
                        torch.from_numpy(labels),
                        torch.from_numpy(label_lengths))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               rtol=1e-4, atol=1e-6)


def _ctc_pad(lengths, size):
    return (np.arange(size)[None] >= lengths[:, None]).astype(np.float32)


def test_ctc_loss_without_an_alignment():
    """A label longer than its frames (8 tokens in 6 frames) and one whose
    repeats need a blank each (3 tokens, 2 repeats, in 4 frames): optax's
    log_epsilon gives a large finite loss with finite gradients, and so
    does the port (torch's F.ctc_loss alone gives inf and NaN gradients);
    the sequences that have an alignment agree as before."""
    logits = np.random.default_rng(0).normal(size=(4, 6, 5)).astype(
        np.float32)
    lengths = np.array([6, 6, 4, 5], np.int32)
    labels = np.array([[1, 2, 3, 4, 1, 2, 3, 4], [1, 2, 0, 0, 0, 0, 0, 0],
                       [3, 3, 3, 0, 0, 0, 0, 0], [3, 3, 3, 0, 0, 0, 0, 0]],
                      np.int32)
    label_lengths = np.array([8, 2, 3, 3], np.int32)
    want = np.asarray(optax.ctc_loss(logits, _ctc_pad(lengths, 6), labels,
                                     _ctc_pad(label_lengths, 8)))
    assert (want[[0, 2]] > 1e4).all() and (want[[1, 3]] < 1e2).all()
    fits = T.has_alignment(torch.from_numpy(lengths).long(),
                           torch.from_numpy(labels).long(),
                           torch.from_numpy(label_lengths).long())
    assert fits.tolist() == [False, True, False, True]
    torch_alone = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1),
        torch.from_numpy(labels).long(), torch.from_numpy(lengths).long(),
        torch.from_numpy(label_lengths).long(), reduction="none")
    assert torch.isinf(torch_alone[[0, 2]]).all()
    want_mean, want_g = jax.value_and_grad(JT.ctc_loss_fn)(
        jnp.asarray(logits), lengths, labels, label_lengths)
    x = torch.from_numpy(logits).requires_grad_()
    got = T.ctc_loss_fn(x, torch.from_numpy(lengths),
                        torch.from_numpy(labels),
                        torch.from_numpy(label_lengths))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want_mean), rtol=1e-6)
    assert torch.isfinite(x.grad).all()
    g, want_g = x.grad.numpy(), np.asarray(want_g)
    np.testing.assert_allclose(g[[1, 3]], want_g[[1, 3]], rtol=1e-4,
                               atol=1e-6)
    # without an alignment the float32 gradient is set by rounding at
    # |log alpha| ~ 1e5 (float32 spacing 2^-7 there): both packages lie
    # ~1e-3 from optax's float64 gradient; the port must lie as close
    with jax.enable_x64(True):
        ref = np.asarray(jax.grad(JT.ctc_loss_fn)(
            jnp.asarray(logits, jnp.float64), lengths, labels,
            label_lengths))
    for row in (0, 2):
        norm = np.linalg.norm(ref[row])
        ours = np.linalg.norm(g[row] - ref[row]) / norm
        theirs = np.linalg.norm(want_g[row] - ref[row]) / norm
        assert ours <= max(2 * theirs, 1e-4), (row, ours, theirs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_log_epsilon_recursion_equals_optax_per_sequence(seed):
    """ctc_loss_log_epsilon on every sequence, with and without an
    alignment, padded frames and repeated tokens, in float64: optax's
    per-sequence loss and its gradient in float64, to 1e-12 and 1e-9
    relative (the same recursion; float32 is set by rounding, see
    test_ctc_loss_without_an_alignment)."""
    rng = np.random.default_rng(seed)
    b, t, v, length = 6, 12, 4, 9
    logits = rng.normal(size=(b, t, v)).astype(np.float32) * 2
    lengths = rng.integers(3, t + 1, size=b).astype(np.int32)
    labels = rng.integers(1, v, size=(b, length)).astype(np.int32)
    label_lengths = rng.integers(0, length + 1, size=b).astype(np.int32)
    # at least one sequence without an alignment and one with
    lengths[0], label_lengths[0], lengths[-1], label_lengths[-1] = 3, 9, t, 2
    labels[np.arange(length)[None] >= label_lengths[:, None]] = 0

    def optax_sum(x):
        return optax.ctc_loss(x, _ctc_pad(lengths, t), labels,
                              _ctc_pad(label_lengths, length))

    with jax.enable_x64(True):
        x64 = jnp.asarray(logits, jnp.float64)
        want = np.asarray(optax_sum(x64))
        want_g = np.asarray(jax.grad(lambda x: optax_sum(x).sum())(x64))
    x = torch.from_numpy(logits).double().requires_grad_()
    got = T.ctc_loss_log_epsilon(
        torch.log_softmax(x, -1), torch.from_numpy(lengths).long(),
        torch.from_numpy(labels).long(),
        torch.from_numpy(label_lengths).long())
    got.sum().backward()
    fits = T.has_alignment(torch.from_numpy(lengths).long(),
                           torch.from_numpy(labels).long(),
                           torch.from_numpy(label_lengths).long()).numpy()
    assert fits.any() and not fits.all()
    np.testing.assert_array_equal(want < 1e4, fits)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=1e-9,
                               atol=1e-12)


def test_a_line_without_an_alignment_trains_as_jax():
    """One Easter2 step on a batch whose first label (40 tokens) is longer
    than its 32 frames: the JAX step trains on (optax's finite loss), and
    so does the port, with the JAX loss, gradients and parameters within
    the float32 bars of the step tests; no parameter becomes NaN."""
    tm, jm, variables = _rec_pair("Easter2")
    batch = JT.synthetic_ctc_batch(3, H, W, VOCAB, 40, seed=1)
    batch["label_lengths"] = np.array([40, 6, 9], np.int32)
    batch["labels"][np.arange(40)[None] >=
                    batch["label_lengths"][:, None]] = 0
    (want_loss, _), want_grads = jax.value_and_grad(
        _jax_rec_loss(jm, batch), has_aux=True)(variables["params"],
                                                variables["batch_stats"])
    assert 1e4 < float(want_loss) < 1e7
    probe = copy.deepcopy(tm)
    loss, grads = T.value_and_grad(probe, T.recognizer_loss(), batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _assert_grads_f64("Easter2", tm, T.recognizer_loss(), batch, variables,
                      _grad_tree(probe, grads), _np(want_grads))
    opt = JT.make_optimizer(LR, TOTAL, WARMUP)
    jstate = (variables["params"], variables["batch_stats"],
              opt.init(variables["params"]), 0)
    jstate, _ = JT.make_train_step(jm, opt)(jstate, batch)
    with _float64_flax():
        jm64, v64 = _jax_model("Easter2", jnp.float64), _f64(variables)
        state64 = (v64["params"], v64["batch_stats"],
                   opt.init(v64["params"]), 0)
        ref = _np(JT.make_train_step(jm64, opt)(state64, _f64(batch))[0][0])
    topt = T.make_optimizer(LR, TOTAL, WARMUP)
    T.make_train_step(tm, topt)(T.model_state(tm, topt).as_tuple(), batch)
    assert all(torch.isfinite(p).all() for p in tm.parameters())
    got = P.flax_variables(tm)["params"]
    moved = 2 * _sum_lr(1)
    # Adam's first step moves each element by lr times the sign of its
    # gradient, so an element whose float32 gradient sign the rounding
    # sets moves either way: the port's mean distance from the float64
    # step within twice the JAX package's, or 1e-3 of 2 lr
    ours = [np.abs(g - r) for (_, g, r) in _pairs(got, ref)]
    theirs = [np.abs(w - r) for (_, w, r) in _pairs(_np(jstate[0]), ref)]
    assert max(float(d.max()) for d in ours) <= moved
    mean = lambda ds: sum(float(d.sum()) for d in ds) / sum(  # noqa: E731
        d.size for d in ds)
    assert mean(ours) <= max(2 * mean(theirs), 1e-3 * moved), (
        mean(ours), mean(theirs))


@pytest.mark.parametrize("classes", [1, 3])
def test_seg_loss_and_its_gradient_equal_jax(classes):
    rng = np.random.default_rng(classes)
    logits = rng.normal(size=(2, 16, 16, classes)).astype(np.float32) * 2
    if classes == 1:
        targets = (rng.uniform(size=logits.shape) > 0.7).astype(np.float32)
    else:
        targets = np.eye(classes, dtype=np.float32)[
            rng.integers(0, classes, size=logits.shape[:3])]
    want, want_g = jax.value_and_grad(JTS.seg_loss_fn)(
        jnp.asarray(logits), targets, 0.7)
    x = torch.from_numpy(logits).requires_grad_()
    got = TS.seg_loss_fn(x, torch.from_numpy(targets), 0.7)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               rtol=1e-4, atol=1e-8)


# -- the optimizer --

@pytest.mark.parametrize("lr,total,warmup", [(3e-4, 3000, 100),
                                             (1e-2, 20, 4), (5e-3, 7, 0),
                                             (3e-4, 2, 0)])
def test_schedule_values_equal_optax(lr, total, warmup):
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup,
                                              max(total, warmup + 1))
    got = T.warmup_cosine_decay_schedule(0.0, lr, warmup,
                                         max(total, warmup + 1))
    steps = range(min(total, 200) + 3)
    np.testing.assert_allclose([float(got(i)) for i in steps],
                               [float(want(jnp.int32(i))) for i in steps],
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_clipped_adamw_updates_equal_optax(grad_scale):
    """Three updates of a seeded tree, the gradient's global norm below 1
    (no clip) and above it (clipped)."""
    rng = np.random.default_rng(4)
    shapes = [(3, 4), (7,), (2, 3, 5)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * grad_scale).astype(np.float32)
              for s in shapes] for _ in range(3)]
    want_opt = JT.make_optimizer(1e-2, total_steps=10, warmup_steps=2)
    got_opt = T.make_optimizer(1e-2, total_steps=10, warmup_steps=2)
    jp = [jnp.asarray(p) for p in params]
    js = want_opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = got_opt.init(tp)
    for g in grads:
        ju, js = want_opt.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = got_opt.update([torch.from_numpy(x) for x in g], ts, tp)
        T.apply_updates(tp, tu)
        for a, b in zip(tu, ju):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                       atol=1e-9)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


# -- one train step of each net --

@pytest.mark.parametrize("arch", list(SMALL))
def test_one_recognizer_train_step_equals_jax(arch):
    tm, jm, variables = _rec_pair(arch)
    batch = _rec_batch()
    (want_loss, _), want_grads = jax.value_and_grad(
        _jax_rec_loss(jm, batch), has_aux=True)(variables["params"],
                                                variables["batch_stats"])
    opt = JT.make_optimizer(LR, TOTAL, WARMUP)
    jstate = (variables["params"], variables["batch_stats"],
              opt.init(variables["params"]), 0)
    jstate, jloss = JT.make_train_step(jm, opt)(jstate, batch)

    probe = copy.deepcopy(tm)
    loss, grads = T.value_and_grad(probe, T.recognizer_loss(), batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _check_grads(arch, tm, T.recognizer_loss(), batch, variables,
                 _grad_tree(probe, grads), _np(want_grads))

    topt = T.make_optimizer(LR, TOTAL, WARMUP)
    state = T.model_state(tm, topt).as_tuple()
    state, tloss = T.make_train_step(tm, topt)(state, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    got = P.flax_variables(tm)
    _assert_params(got["params"], _np(jstate[0]), 2 * _sum_lr(1))
    _assert_stats(got["batch_stats"], _np(jstate[1]), arch in ILL_CONDITIONED)


@pytest.mark.parametrize("name", list(SEG))
def test_one_segmentation_train_step_equals_jax(name):
    tm, jm, variables, classes = _seg_pair(name)
    batch = _seg_batch(classes)
    (want_loss, _), want_grads = jax.value_and_grad(
        _jax_seg_loss(jm, batch), has_aux=True)(variables["params"],
                                                variables["batch_stats"])
    opt = JT.make_optimizer(LR, TOTAL, WARMUP)
    jstate = (variables["params"], variables["batch_stats"],
              opt.init(variables["params"]), 0)
    jstate, jloss = JTS.make_seg_train_step(jm, opt)(jstate, batch)

    probe = copy.deepcopy(tm)
    loss, grads = T.value_and_grad(probe, TS.segmentation_loss(), batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _check_grads(name, tm, TS.segmentation_loss(), batch, variables,
                 _grad_tree(probe, grads), _np(want_grads))

    topt = T.make_optimizer(LR, TOTAL, WARMUP)
    state = T.model_state(tm, topt).as_tuple()
    state, tloss = TS.make_seg_train_step(tm, topt)(state, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    got = P.flax_variables(tm)
    _assert_params(got["params"], _np(jstate[0]), 2 * _sum_lr(1))
    _assert_stats(got["batch_stats"], _np(jstate[1]), name in ILL_CONDITIONED)


@pytest.mark.parametrize("kind", ["Easter2", "unet_stem2"])
def test_five_train_steps_equal_jax(kind):
    """Five steps on five batches: the losses and the parameters."""
    if kind == "Easter2":
        tm, jm, variables = _rec_pair(kind)
        batches = [_rec_batch(seed=s) for s in range(5)]
        jstep, tstep_fn = JT.make_train_step, T.make_train_step
    else:
        tm, jm, variables, classes = _seg_pair(kind)
        batches = [_seg_batch(classes, seed=s) for s in range(5)]
        jstep, tstep_fn = JTS.make_seg_train_step, TS.make_seg_train_step
    opt = JT.make_optimizer(LR, TOTAL, 2)
    jstate = (variables["params"], variables["batch_stats"],
              opt.init(variables["params"]), 0)
    jstep = jstep(jm, opt)
    topt = T.make_optimizer(LR, TOTAL, 2)
    tstate = T.model_state(tm, topt).as_tuple()
    tstep = tstep_fn(tm, topt)
    for batch in batches:
        jstate, jloss = jstep(jstate, batch)
        tstate, tloss = tstep(tstate, batch)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    sched = optax.warmup_cosine_decay_schedule(0.0, LR, 2, TOTAL)
    moved = 2 * float(sum(sched(i) for i in range(5)))
    got = P.flax_variables(tm)
    _assert_params(got["params"], _np(jstate[0]), moved)
    assert tstate[3] == 5 and tstate[2].count == 5


def test_bf16_recognizer_step_within_the_derived_bound():
    """selftrain's Easter2 step in bf16 (Flax dtype=bf16; the port's
    autocast): each package's bf16 loss within 2% of its float32 loss, and
    the two bf16 losses within 2% of each other (module docstring)."""
    tm, _, variables = _rec_pair("Easter2")
    jm16 = JR.build_recognizer("Easter2", VOCAB, **SMALL["Easter2"])
    assert jm16.dtype == jnp.bfloat16  # build_recognizer's default
    batch = _rec_batch()
    j16 = float(_jax_rec_loss(jm16, batch)(variables["params"],
                                           variables["batch_stats"])[0])
    j32 = float(_jax_rec_loss(
        JR.build_recognizer("Easter2", VOCAB, dtype=jnp.float32,
                            **SMALL["Easter2"]), batch)(
        variables["params"], variables["batch_stats"])[0])
    t16, _ = T.value_and_grad(copy.deepcopy(tm), T.recognizer_loss(), batch,
                              torch.bfloat16)
    t32, _ = T.value_and_grad(copy.deepcopy(tm), T.recognizer_loss(), batch)
    assert abs(j16 - j32) <= 0.02 * j32
    assert abs(float(t16) - float(t32)) <= 0.02 * float(t32)
    assert abs(float(t16) - j16) <= 0.02 * j16


def test_the_train_step_has_no_randomness():
    """The JAX Easter2's dropout is 0 in every build (no builder sets it),
    so its step does not depend on the dropout key; the port has no
    dropout module."""
    assert JR.Easter2Block.__dataclass_fields__["dropout"].default == 0.0
    _, jm, variables = _rec_pair("Easter2")
    batch = _rec_batch()
    outs = [np.asarray(jm.apply(variables, batch["images"], train=True,
                                mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(k)})[0])
            for k in (0, 1)]
    np.testing.assert_array_equal(outs[0], outs[1])
    for arch in SMALL:
        model = build_recognizer(arch, VOCAB, H, **SMALL[arch])
        assert not any(isinstance(m, torch.nn.Dropout)
                       for m in model.modules())


def test_train_state_holds_the_models_tensors():
    """The state's params are the model's tensors, which the step updates;
    the state of another model (even a copy) is refused, on one device
    and on a mesh, as are state shardings that split two modules over the
    model axis."""
    tm, _, _ = _rec_pair("Easter2")
    opt = T.make_optimizer(LR, TOTAL, WARMUP)
    state = T.init_train_state(tm, opt, seed=3)
    assert all(state.params[k] is p for k, p in tm.named_parameters())
    before = {k: v.clone() for k, v in state.params.items()}
    step = T.make_train_step(tm, opt)
    out, _ = step(state.as_tuple(), _rec_batch())
    assert out[0] is state.params and out[3] == 1 and out[2].count == 1
    assert any(not torch.equal(before[k], p)
               for k, p in tm.named_parameters())
    other = T.model_state(copy.deepcopy(tm), opt).as_tuple()
    with pytest.raises(ValueError, match="does not hold"):
        step(other, _rec_batch())
    mesh = make_mesh(devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="does not hold"):
        T.make_train_step(tm, opt, mesh)(other, _rec_batch(batch=2))
    mesh = make_mesh(devices=["cpu"] * 2, model_parallel=2)
    split = tp_shardings(mesh, dict(tm.named_parameters()))
    split["ConvBN1D_3.Conv_0.weight"] = split["Conv_0.weight"]
    with pytest.raises(ValueError, match="one module"):
        TS.make_seg_train_step(tm, opt, mesh,
                               state_shardings=(split, None, None, None))


def test_synthetic_batches_equal_jax():
    for a, b in ((T.synthetic_ctc_batch(3, 8, 16, 7, seed=2),
                  JT.synthetic_ctc_batch(3, 8, 16, 7, seed=2)),
                 (TS.synthetic_seg_batch(2, 32, 3, seed=2),
                  JTS.synthetic_seg_batch(2, 32, 3, seed=2))):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# -- the parameter lifecycle --

def _all_models():
    for arch in SMALL:
        tm, jm, variables = _rec_pair(arch)
        yield arch, tm, jm, variables
    for name in SEG:
        tm, jm, variables, _ = _seg_pair(name)
        yield name, tm, jm, variables


@pytest.mark.parametrize("index", range(len(SMALL) + len(SEG)))
def test_save_params_writes_flax_bytes_both_ways(index, tmp_path):
    """save_params of the port's module equals flax.serialization.to_bytes
    of the JAX variables, byte for byte; the JAX load_params reads it; the
    port reads the JAX package's file; param_count agrees."""
    name, tm, jm, variables = list(_all_models())[index]
    path = tmp_path / "w.msgpack"
    P.save_params(tm, path, meta={"architecture": name})
    assert path.read_bytes() == serialization.to_bytes(variables)
    back = JP.load_params(variables, path)
    for _, a, b in _pairs(_np(back), variables):
        np.testing.assert_array_equal(a, b)
    assert JP.load_meta(path) == P.load_meta(path) == {"architecture": name}
    jpath = tmp_path / "j.msgpack"
    JP.save_params(variables, jpath)
    assert P.load_meta(jpath) is None
    fresh = copy.deepcopy(tm)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    P.load_params(fresh, jpath)
    assert P.to_bytes(P.flax_variables(fresh)) == jpath.read_bytes()
    tree = P.load_params(P.flax_variables(tm), jpath)
    assert P.to_bytes(tree) == jpath.read_bytes()
    assert P.param_count(tm) == JP.param_count(variables)


def test_load_params_refuses_a_mismatched_tree(tmp_path):
    tm, _, variables = _rec_pair("Easter2")
    path = tmp_path / "w.msgpack"
    P.save_params(variables, path)
    bad = copy.deepcopy(variables)
    bad["params"]["Conv_0"]["kernel"] = np.zeros((1, 2, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        P.load_params(bad, path)
    del bad["params"]["Conv_0"]
    with pytest.raises(ValueError, match="unexpected"):
        P.load_params(bad, path)


@pytest.mark.parametrize("index", range(len(SMALL) + len(SEG)))
def test_init_gives_the_flax_tree(index):
    """init_recognizer / init_segmentation: the JAX init's tree (keys and
    shapes), drawn by numpy from a seed (the draws are not JAX's)."""
    name, tm, jm, variables = list(_all_models())[index]
    init = P.init_segmentation if name in SEG else P.init_recognizer
    got = init(tm, seed=5)
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, variables)
    again = init(tm, seed=5)
    assert P.to_bytes(got) == P.to_bytes(again)
    assert P.to_bytes(init(tm, seed=6)) != P.to_bytes(got)


def test_a_checkpoint_the_port_writes_drives_the_jax_pipeline(tmp_path):
    """Weights trained one step by the port, written with save_params,
    loaded by the JAX build_pipeline and by the port's: the same texts."""
    from ocr_inference_tpu.core import data as jdata
    from ocr_inference_tpu.eval.synthetic import GlyphSet, render_page
    from ocr_inference_tpu.pipeline.builder import build_pipeline as jbuild
    from ocr_inference_tpu_torch.core import data
    from ocr_inference_tpu_torch.pipeline.builder import build_pipeline
    from tests.make_torch_port_fixture import full77f_configs

    tm = build_recognizer("Easter2", 78)
    P.load_flax_weights(tm, "artifacts/full77f/recognizer.msgpack")
    opt = T.make_optimizer(1e-4, 10, 0)
    step = T.make_train_step(tm, opt)
    step(T.model_state(tm, opt).as_tuple(),
         T.synthetic_ctc_batch(2, 80, 128, 78, seed=0))
    (tmp_path / "rec").mkdir()
    P.save_params(tm, tmp_path / "rec" / "recognizer.msgpack")
    page = render_page(np.random.RandomState(101),
                       GlyphSet(WYLIE_CHARSET_FULL, 40, 7), WYLIE_CHARSET_FULL).image
    texts = []
    for mod, build, kw in ((jdata, jbuild, {"dtype": jnp.float32}),
                           (data, build_pipeline,
                            {"dtype": torch.float32, "device": "cpu"})):
        ocr, line = full77f_configs(mod.OCRModelConfig,
                                    mod.LineDetectionConfig,
                                    mod.CharsetEncoder.WYLIE)
        ocr.model_file = str(tmp_path / "rec" / "recognizer.onnx")
        status, payload = build(ocr, line, **kw).run_ocr(
            page, target_encoding=mod.Encoding.WYLIE)
        texts.append([ln.text for ln in payload[2]])
    assert texts[0] == texts[1] and any(texts[0])
