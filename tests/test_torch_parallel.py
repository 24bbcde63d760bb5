"""The port's mesh runtime (ocr_inference_tpu_torch/parallel), its mesh train
steps and mesh engines against the JAX package on the CPU, in one process:
the JAX side on the ``cpu_devices`` fixture's 8 virtual devices, the port
on meshes that repeat torch's one CPU device (8x1 and 4x2), from the same
numpy-made variables and inputs, float32.

Bars:

- the train steps against the JAX mesh step: those of
  tests/test_torch_training.py (loss rel 1e-5; each parameter within what
  Adam's first step can move it, 2 lr, the mean distance under 1e-3 of
  that; running statistics rel 1e-5);
- the mesh step against the port's own ``mesh=None`` step on the same
  batch (the same sums, added in another order), both in float64: the
  loss within rel 1e-6, each gradient leaf within 1e-5 of its norm, the
  BatchNorm running statistics and each updated parameter within 1e-6 and
  1e-5. In float32 the order of the sums alone moves some of the small
  UNet's gradient leaves past that bar (a BatchNorm bias on the 4x2 mesh:
  E[x^2] - E[x]^2 cancels, as for the ill-conditioned nets of
  tests/test_torch_training.py), while in float64 the two agree to
  rounding; the float32 steps are held to the JAX mesh step above.
  ``test_per_shard_statistics_are_caught`` shows that the UNet case on
  the 8x1 mesh fails these bars for a step whose BatchNorm statistics or
  soft dice are per data group;
- engines: the same masks, line boxes, texts and occupancy keys as
  ``mesh=None`` and as the JAX mesh engines;
- ``DataParallelRunner``: within 1e-6 of the JAX runner.
"""

import copy
import functools
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_inference_tpu.core import data as jdata
from ocr_inference_tpu.models import params as JP
from ocr_inference_tpu.models import recognition as JR
from ocr_inference_tpu.models import segmentation as JS
from ocr_inference_tpu.parallel import mesh as JM
from ocr_inference_tpu.pipeline import OCRPipeline as JaxPipeline
from ocr_inference_tpu.pipeline import RecognitionEngine as JaxRecognizer
from ocr_inference_tpu.pipeline import SegmentationEngine as JaxSegmenter
from ocr_inference_tpu.training import segmentation as JTS
from ocr_inference_tpu.training import train as JT
from ocr_inference_tpu_torch.core import data
from ocr_inference_tpu_torch.core.assets import import_local_model
from ocr_inference_tpu_torch.eval.synthetic import (
    WYLIE_CHARSET, GlyphSet, render_page,
)
from ocr_inference_tpu_torch.models import params as P
from ocr_inference_tpu_torch.models.recognition import Easter2
from ocr_inference_tpu_torch.models.segmentation import UNet
from ocr_inference_tpu_torch.parallel import mesh as M
from ocr_inference_tpu_torch.parallel import replicas as R
from ocr_inference_tpu_torch.pipeline.builder import build_pipeline
from ocr_inference_tpu_torch.training import segmentation as TS
from ocr_inference_tpu_torch.training import train as T
from tests.test_torch_training import (
    _assert_params, _assert_stats, _np, _sum_lr,
)
from tests.torch_dcn_worker import (
    BUCKETS, CHARSET, MAX_LINES, REC_SMALL, page, rec_config, rec_variables,
    tiny_pipeline,
)

LR, TOTAL, WARMUP = 1e-2, 20, 0
SHAPES = [(8, 1), (4, 2)]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _mesh(shape):
    return M.make_mesh(devices=["cpu"] * 8, model_parallel=shape[1])


def _jax_mesh(cpu_devices, shape):
    return JM.make_mesh(devices=cpu_devices, model_parallel=shape[1])


# -- the mesh runtime --

def test_make_mesh_shapes(cpu_devices):
    for shape in SHAPES:
        mesh = _mesh(shape)
        assert mesh.shape == dict(_jax_mesh(cpu_devices, shape).shape)
        assert mesh.shape == {"data": shape[0], "model": shape[1]}
        assert [len(g) for g in mesh.groups] == [shape[1]] * shape[0]
    with pytest.raises(ValueError, match="requested 16"):
        M.make_mesh(16, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="not divisible"):
        M.make_mesh(devices=["cpu"] * 6, model_parallel=4)


def test_pad_to_multiple_of():
    for make in (np.ones, torch.ones):
        arr, pad = M.pad_to_multiple_of(make((5, 3)), 8)
        assert tuple(arr.shape) == (8, 3) and pad == 3
        assert float(arr[5:].sum()) == 0
        arr, pad = M.pad_to_multiple_of(make((8, 3)), 8)
        assert pad == 0


def test_host_shard():
    items = list(range(10))
    assert M.host_shard(items, 0, 4) == [0, 4, 8]
    assert M.host_shard(items, 3, 4) == [3, 7]
    assert sorted(x for p in range(4) for x in M.host_shard(items, p, 4)) \
        == items
    assert M.host_shard(items) == items  # no process group: rank 0 of 1


def test_shard_batch_splits_as_the_data_axis(cpu_devices):
    batch = np.arange(64, dtype=np.float32).reshape(16, 4)
    for shape in SHAPES:
        got = M.shard_batch(_mesh(shape), {"x": batch, "n": np.int32(3)})
        want = JM.shard_batch(_jax_mesh(cpu_devices, shape), batch)
        blocks = {}
        for s in want.addressable_shards:
            blocks[s.index[0].start or 0] = np.asarray(s.data)
        assert len(got["x"]) == shape[0]
        for block, start in zip(got["x"], sorted(blocks)):
            np.testing.assert_array_equal(block.numpy(), blocks[start])
        assert [int(n) for n in got["n"]] == [3] * shape[0]
    with pytest.raises(ValueError, match="does not split"):
        M.shard_batch(_mesh((8, 1)), np.zeros((12, 2)))


def test_tp_shardings_split_the_head_by_path_only(cpu_devices):
    """Only Conv_0's leaves get the model axis, matched by path: the stem
    (128 features) equals the vocab (128) on purpose. The Flax tree's
    split paths equal the JAX package's; the port's own parameters split
    along their output features."""
    vocab = 128
    mesh = _mesh((4, 2))
    jm = JR.Easter2(vocab_size=vocab, dtype=jnp.float32)
    variables = _np(JP.init_recognizer(jm, 32, 64))
    jax_split = {
        jax.tree_util.keystr(path)
        for path, s in jax.tree_util.tree_flatten_with_path(
            JM.tp_shardings(_jax_mesh(cpu_devices, (4, 2)),
                            variables["params"]))[0]
        if s.spec and s.spec[-1] == "model"}
    ours = M.tp_shardings(mesh, variables["params"])
    our_split = {
        jax.tree_util.keystr(path)
        for path, s in jax.tree_util.tree_flatten_with_path(
            ours, is_leaf=lambda x: isinstance(x, M.NamedSharding))[0]
        if s.spec and s.spec[-1] == "model"}
    assert our_split == jax_split and our_split

    tm = Easter2(vocab, 32)
    named = M.tp_shardings(mesh, dict(tm.named_parameters()))
    split = {k: s.spec for k, s in named.items() if "model" in s.spec}
    assert split == {"Conv_0.weight": ("model", None, None),
                     "Conv_0.bias": ("model",)}
    stem = [s for k, s in named.items() if k.startswith("ConvBN1D_0")]
    assert stem and all(s.spec == () for s in stem)
    assert all(s.spec == () for s in M.tp_shardings(
        _mesh((8, 1)), dict(tm.named_parameters())).values())

    placed = M.shard_params_tp(mesh, {"Conv_0.weight": tm.Conv_0.weight,
                                      "Conv_0.bias": tm.Conv_0.bias})
    assert len(placed) == 8
    for key in ("Conv_0.weight", "Conv_0.bias"):
        whole = torch.cat([placed[0][key], placed[1][key]])
        torch.testing.assert_close(whole, getattr(tm.Conv_0, key[7:]).data)


def test_data_parallel_runner_equals_jax(cpu_devices):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    batch = rng.normal(size=(10, 4)).astype(np.float32)
    for shape in SHAPES:
        want = np.asarray(JM.DataParallelRunner(
            _jax_mesh(cpu_devices, shape), lambda p, b: b @ p)(w, batch))
        got = M.DataParallelRunner(_mesh(shape), lambda p, b: b @ p)(
            torch.from_numpy(w), batch)
        assert tuple(got.shape) == (10, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# -- the train steps --

def _easter2():
    jm = JR.build_recognizer("Easter2", 12, dtype=jnp.float32, **REC_SMALL)
    variables = _np(JP.init_recognizer(jm, 80, 128))
    tm = Easter2(12, 80, **REC_SMALL)
    P.load_flax_tree(tm, variables)
    batch = JT.synthetic_ctc_batch(8, 80, 128, 12, 10, seed=1)
    return (tm, jm, variables, batch, T.recognizer_loss(), T.make_train_step,
            JT.make_train_step)


def _unet():
    jm = JS.UNet(classes=1, width=8, stem_stride=2, dtype=jnp.float32)
    variables = _np(JP.init_segmentation(jm, 64))
    tm = UNet(classes=1, width=8, stem_stride=2)
    P.load_flax_tree(tm, variables)
    batch = JTS.synthetic_seg_batch(8, 64, 1, seed=1)
    return (tm, jm, variables, batch, TS.segmentation_loss(),
            TS.make_seg_train_step, JTS.make_seg_train_step)


NETS = {"Easter2": _easter2, "UNet": _unet}


def _tp_state_shardings(mesh, model):
    return (M.tp_shardings(mesh, dict(model.named_parameters())), None, None,
            None)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("net", list(NETS))
def test_mesh_train_step_equals_jax(cpu_devices, net, shape):
    """One step on a mesh against the JAX package's mesh step; on 4x2 the
    Easter2 state is split tensor-parallel (tp_shardings) in both."""
    tm, jm, variables, batch, _, port_step, jax_step = NETS[net]()
    tp = net == "Easter2" and shape[1] > 1
    jmesh = _jax_mesh(cpu_devices, shape)
    opt = JT.make_optimizer(LR, TOTAL, WARMUP)
    jstate = (variables["params"], variables["batch_stats"],
              opt.init(variables["params"]), 0)
    shardings = None
    if tp:
        rep = JM.replicated(jmesh)
        shardings = (JM.tp_shardings(jmesh, variables["params"]), rep,
                     JM.tp_shardings(jmesh, jstate[2]), rep)
    (jparams, jstats, _, _), jloss = jax_step(
        jm, opt, jmesh, state_shardings=shardings)(jstate, batch)

    mesh = _mesh(shape)
    topt = T.make_optimizer(LR, TOTAL, WARMUP)
    state = T.model_state(tm, topt).as_tuple()
    step = port_step(tm, topt, mesh, state_shardings=(
        _tp_state_shardings(mesh, tm) if tp else None))
    state, loss = step(state, batch)
    assert state[3] == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = P.flax_variables(tm)
    _assert_params(got["params"], _np(jparams), 2 * _sum_lr(1))
    _assert_stats(got["batch_stats"], _np(jstats))


def _f64(model, batch):
    """A copy of the model and the batch in float64."""
    return copy.deepcopy(model).double(), {
        k: torch.as_tensor(v).double() if np.asarray(v).dtype == np.float32
        else torch.as_tensor(v) for k, v in batch.items()}


def _grads_and_stats(model, loss, batch, mesh=None, head=None):
    model = copy.deepcopy(model)
    if mesh is None:
        value, grads = T.value_and_grad(model, loss, batch)
    else:
        grad = T.MeshGradient(model, mesh, head)
        value, grads = grad(loss, batch)
        grad.take_statistics()
    stats = {k: v.clone() for k, v in model.named_buffers()}
    return float(value), grads, stats


def _assert_mesh_equals_one_device(model, loss, batch, mesh, step, tp):
    want_loss, want_grads, want_stats = _grads_and_stats(model, loss, batch)
    got_loss, got_grads, got_stats = _grads_and_stats(
        model, loss, batch, mesh, "Conv_0" if tp else None)
    assert got_loss == pytest.approx(want_loss, rel=1e-6)
    names = [n for n, _ in model.named_parameters()]
    for name, g, w in zip(names, got_grads, want_grads):
        assert float((g - w).norm()) <= 1e-5 * float(w.norm()), name
    for name, w in want_stats.items():
        torch.testing.assert_close(got_stats[name], w, rtol=1e-6, atol=1e-6)
    # and a whole step: the parameters within 1e-5
    updated = []
    for m in (None, mesh):
        tm = copy.deepcopy(model)
        opt = T.make_optimizer(LR, TOTAL, WARMUP)
        shardings = _tp_state_shardings(m, tm) if tp and m else None
        step(tm, opt, m, state_shardings=shardings)(
            T.model_state(tm, opt).as_tuple(), batch)
        updated.append(dict(tm.named_parameters()))
    for name, w in updated[0].items():
        torch.testing.assert_close(updated[1][name], w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("net", list(NETS))
def test_mesh_step_equals_its_one_device_step(net, shape):
    """The mesh's loss, gradient, running statistics and updated
    parameters are those of the whole batch: equal to the port's
    mesh=None step (module docstring), in float64; the Easter2 head split
    over the 4x2 mesh's model axis."""
    tm, _, _, batch, loss, step, _ = NETS[net]()
    model, batch = _f64(tm, batch)
    _assert_mesh_equals_one_device(model, loss, batch, _mesh(shape), step,
                                   net == "Easter2" and shape[1] > 1)


def test_per_shard_statistics_are_caught(monkeypatch):
    """The UNet case on the 8x1 mesh fails the bars of
    test_mesh_step_equals_its_one_device_step for a step that takes each
    data group's own BatchNorm statistics, or a mean of per-group dice:
    both move the loss by more than 100 times rel 1e-6."""
    tm, _, _, batch, loss, _, _ = NETS["UNet"]()
    tm, batch = _f64(tm, batch)
    mesh = _mesh((8, 1))
    want, _, _ = _grads_and_stats(tm, loss, batch)

    # the mean of each group's loss: per-group dice (and cross-entropy
    # mean), with the whole batch's BatchNorm statistics
    parts = []
    orig_total = R.ShardReduction.total

    def keep(self, per_group):
        parts.extend(per_group)
        return orig_total(self, per_group)

    monkeypatch.setattr(R.ShardReduction, "total", keep)
    got, _, _ = _grads_and_stats(tm, loss, batch, mesh)
    assert got == pytest.approx(want, rel=1e-6)
    per_group = float(np.mean([float(loss.combine(p).detach())
                               for p in parts]))
    assert abs(per_group - want) > 100 * 1e-6 * want

    # each group's own statistics
    monkeypatch.setattr(R.ShardReduction, "reduce",
                        lambda self, group, tensors: list(tensors))
    got, _, _ = _grads_and_stats(tm, loss, batch, mesh)
    assert abs(got - want) > 100 * 1e-6 * want


def test_a_batch_that_does_not_split_fails():
    tm, _, _, batch, loss, _, _ = NETS["Easter2"]()
    with pytest.raises(ValueError, match="does not split"):
        T.MeshGradient(tm, M.make_mesh(devices=["cpu"] * 3))(loss, batch)


# -- the engines --

class _JaxDensity(nn.Module):
    """tests/dcn_worker.py's density detector."""

    @nn.compact
    def __call__(self, x, train: bool = False):
        dark = 1.0 - jnp.mean(x, axis=-1, keepdims=True)
        density = nn.avg_pool(dark, (9, 41), strides=(1, 1), padding="SAME")
        return (density - 0.35) * 40.0


def _jax_tiny(mesh):
    det_model = _JaxDensity()
    det = JaxSegmenter(det_model, det_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 512, 512, 3))), mode="line",
        mesh=mesh)
    rec = JaxRecognizer(
        JR.build_recognizer("Easter2", len(CHARSET) + 1, dtype=jnp.float32,
                            **REC_SMALL),
        rec_variables(), rec_config(jdata),
        batch_cfg=jdata.BatchConfig(width_buckets=BUCKETS,
                                    max_lines_per_batch=MAX_LINES),
        mesh=mesh)
    return JaxPipeline(rec, det)


def _read(pipe, pages):
    out = []
    for img in pages:
        status, payload = pipe.run_ocr(img)
        assert status.name == "SUCCESS", payload
        mask, lines, ocr_lines = payload[0], payload[1], payload[2]
        out.append((np.asarray(mask), [ln.bbox.as_tuple() for ln in lines],
                    [ln.text for ln in ocr_lines]))
    return out, dict(pipe.ocr_inference.occupancy)


@pytest.fixture(scope="module")
def pages():
    return [page(100), page(101, n_lines=5)]


@pytest.fixture(scope="module")
def one_device(pages):
    return _read(tiny_pipeline(None), pages)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d" % s)
def test_engines_on_a_mesh_equal_one_device_and_jax(cpu_devices, pages,
                                                    one_device, shape):
    """Masks, boxes and texts equal mesh=None's and the JAX mesh
    engines'; the occupancy keys (batches rounded to the data axis) the
    JAX ones. A mask pixel may differ from the JAX one (at most 1e-5 of
    them) where the JAX package's XLA blur departs from cv2 at a float32
    tie and the port follows cv2 (ROADMAP section 3): on the second page
    tile 1's binarized pixel (422, 157), which moves one mask pixel."""
    ours, occupancy = _read(tiny_pipeline(_mesh(shape)), pages)
    theirs, jax_occupancy = _read(_jax_tiny(_jax_mesh(cpu_devices, shape)),
                                  pages)
    for (mask, boxes, texts), (m1, b1, t1), (mj, bj, tj) in zip(
            ours, one_device[0], theirs):
        np.testing.assert_array_equal(mask, m1)
        assert np.count_nonzero(mask != mj) <= 1e-5 * mask.size
        assert boxes == b1 == bj and boxes
        assert texts == t1 == tj and any(texts)
    assert occupancy == jax_occupancy
    assert all(b % shape[0] == 0 for _, _, b in occupancy)


def test_stream_and_eval_batches_split_over_the_data_axis(pages):
    """The streaming path's quantum and tails and the eval mode's logits
    on a 4x2 mesh: the texts and logits of mesh=None."""
    one = tiny_pipeline(None).ocr_inference
    rec = tiny_pipeline(_mesh((4, 2))).ocr_inference
    strips = [pages[0][100: 128, 60: 60 + w] for w in (300, 500, 700, 840,
                                                       200)]
    for engine in (one, rec):
        state = engine.stream_state()
        for i, s in enumerate(strips):
            engine.stream_add(state, i, s)
        engine.texts = {**engine.stream_run(state, quantum=3),
                        **engine.stream_run(state, final=True)}
    assert rec.texts == one.texts and len(rec.texts) == len(strips)
    assert all(b % 4 == 0 for _, _, b in rec.occupancy)
    got, want = rec.line_logits(strips), one.line_logits(strips)
    for i in want:
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=1e-5)
    # quantum 9 -> 12 on a data axis of 4; tails 1, 2, 4, 8 -> 4, 4, 4, 8
    assert rec.warm_shapes(widths=(512,), quantum=9) == 3


def test_volume_runner_on_a_mesh(pages, one_device):
    """VolumeRunner over a 4x2 mesh (a page window's tiles as one stream,
    the recognizer's carry across pages): the boxes and texts of
    mesh=None's run_ocr."""
    from ocr_inference_tpu_torch.pipeline import VolumeRunner

    records = VolumeRunner(tiny_pipeline(_mesh((4, 2))), window_pages=2).run(
        [(f"p{i}", img) for i, img in enumerate(pages)])
    for rec, (_, boxes, texts) in zip(records, one_device[0]):
        assert rec.status.name == "SUCCESS"
        assert [ln.bbox.as_tuple() for ln in rec.lines] == boxes
        assert [ln.text for ln in rec.ocr_lines] == texts


def test_build_pipeline_takes_a_mesh(tmp_path):
    """build_pipeline(mesh=) on the refpipe checkpoints (UNet width 8 and
    Easter2 at 0.25 width, whose head splits over the 4x2 mesh's model
    axis): the page reads as with mesh=None."""
    from tests import make_refpipe_fixture as fx

    refpipe = __import__("pathlib").Path(__file__).parent / "data" / "refpipe"
    model = tmp_path / "model"
    model.mkdir()
    (model / "model_config.json").write_text(json.dumps({
        "onnx-model": str(refpipe / "recognizer.onnx"),
        "architecture": "Easter2", "input_width": fx.CANVAS,
        "input_height": fx.INPUT_H, "input_layer": "input",
        "output_layer": "output", "squeeze_channel_dim": "yes",
        "swap_hw": "no", "encoder": "wylie", "charset": list(WYLIE_CHARSET),
        "add_blank": "yes", "version": "refpipe"}))
    ocr = import_local_model(str(model)).config
    lines = data.LineDetectionConfig("", str(refpipe / "lines.onnx"),
                                     "unet", 512, ["line"])
    build = functools.partial(build_pipeline, ocr, lines,
                              dtype=torch.float32, device="cpu")
    img = render_page(np.random.RandomState(3), GlyphSet(fx.GLYPH_H, seed=7),
                      WYLIE_CHARSET, n_lines=(3, 4), page_w=512,
                      n_syllables=fx.N_SYLLABLES,
                      syllable_len=fx.SYLLABLE_LEN).image
    mesh = _mesh((4, 2))
    pipe = build(mesh=mesh)
    assert pipe.ocr_inference.mesh is mesh and pipe.line_inference.mesh is mesh
    assert isinstance(pipe.ocr_inference._replicas[0].Conv_0, R.SplitHead)
    got, _ = _read(pipe, [img])
    want, _ = _read(build(), [img])
    assert got[0][1] == want[0][1] and got[0][2] == want[0][2]
    assert any(got[0][2])
    with pytest.raises(ValueError, match="a mesh of cuda devices"):
        build(mesh=M.make_mesh(devices=["cuda:0"] * 2))
