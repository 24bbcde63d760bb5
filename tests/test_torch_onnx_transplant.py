"""The port's weight transplant and write-back (onnx/transplant.py,
onnx/retroplant.py) against the JAX package's on the same graphs.

For every exporter-made graph of tests/torch_onnx_graphs.py (folded and
fold-free TorchScript exports of the torch twins, the tf2onnx dialect,
fp16), the port's transplant into its own module must give the Flax
variable tree that JAX's transplant gives into the Flax module, leaf for
leaf and byte for byte; ``verify_transplant`` must report no layer over
1e-2 and a final diff under 1e-3 (3e-2 for fp16); the loaded module must
compute the twin's function. ``write_back`` of the same variables must
write the bytes JAX's writes, and the rewritten file must transplant back
to the same tree.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import unfreeze

from ocr_inference_tpu.onnx import retroplant as jax_retro
from ocr_inference_tpu.onnx import transplant as jax_tp
from ocr_inference_tpu.onnx.wire import load_model as jax_load_model
from ocr_inference_tpu_torch.models.params import (
    flax_variables,
    load_flax_tree,
)
from ocr_inference_tpu_torch.onnx.retroplant import RetroplantError, write_back
from ocr_inference_tpu_torch.onnx.transplant import (
    transplant,
    verify_transplant,
)
from ocr_inference_tpu_torch.onnx.wire import load_model
from tests.torch_onnx_graphs import TWINS, twin_case


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _numpy_tree(tree) -> dict:
    """A (frozen) JAX variable tree as nested dicts of numpy arrays."""
    out: dict = {}
    for path, leaf in _leaves(unfreeze(tree)):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(leaf)
    return out


def _assert_same_tree(got: dict, want: dict):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


class Cases:
    """Twin graphs and JAX transplants, each made once for the module."""

    def __init__(self, d):
        self.d = d
        self._cases, self._jax = {}, {}

    def case(self, name):
        if name not in self._cases:
            self._cases[name] = twin_case(name, self.d)
        return self._cases[name]

    def jax_transplant(self, name):
        """(JAX module, its transplanted tree as numpy)."""
        if name not in self._jax:
            case = self.case(name)
            module = case.jax_module()
            x = jnp.asarray(case.jax_x.astype(np.float32))
            # the template: the same Flax tree a module.init gives, made
            # by the port (init would compile a forward of its own)
            variables = jax.tree_util.tree_map(
                jnp.asarray, flax_variables(case.port_module()))
            tree, _ = jax_tp.transplant(jax_load_model(case.path), module,
                                        variables, x)
            self._jax[name] = (module, _numpy_tree(tree))
        return self._jax[name]



@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes at once; two intra-op
    threads each keep them from oversubscribing the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return Cases(tmp_path_factory.mktemp("transplant"))


@pytest.mark.parametrize("name", TWINS)
def test_transplant_equals_jax_and_verifies(cases, name):
    case = cases.case(name)
    _, want = cases.jax_transplant(name)
    module = case.port_module()
    x = case.port_x.astype(np.float32)
    tree, report = transplant(load_model(case.path), module, None, x)
    _assert_same_tree(tree, want)

    report = verify_transplant(load_model(case.path), module, tree, x,
                               report, graph_input=case.graph_x)
    fp16 = name.startswith("fp16")
    assert report.final_max_abs_diff < (3e-2 if fp16 else 1e-3)
    assert any(e.max_abs_diff is not None for e in report.entries)
    assert not report.failed(3e-2 if fp16 else 1e-2), str(report)

    load_flax_tree(module, tree)
    with torch.no_grad():
        out = module(torch.from_numpy(x)).numpy()
    ref = case.ref
    if ref.shape != out.shape:  # (B, V, T), or a channels-last graph
        ref = ref.transpose(0, 2, 1) if ref.ndim == 3 else \
            ref.transpose(0, 3, 1, 2)
    assert np.max(np.abs(out - ref)) < (3e-2 if fp16 else 1e-3)


def test_transplant_report_kinds(cases):
    """The report names the idioms: LayerNorm pairs, GRU directions, BN
    folded into the conv, decomposed Mul/Add BatchNorms."""
    def kinds(name):
        case = cases.case(name)
        _, report = transplant(load_model(case.path), case.port_module(),
                               None, case.port_x)
        return [(e.kind, e.folded) for e in report.entries]

    assert [k for k, _ in kinds("attention")].count("ln") == 4
    crnn = [k for k, _ in kinds("crnn")]
    assert crnn.count("gru[d0]") == 2 and crnn.count("gru[d1]") == 2
    assert ("bn", True) in kinds("easter2_fold")
    assert ("bn", False) in kinds("tf_easter2")


def test_layernorm_epsilon_mismatch_is_refused(tmp_path):
    from ocr_inference_tpu.models.torch_twins import TEaster2Attention
    from ocr_inference_tpu_torch.models.recognition import Easter2
    from ocr_inference_tpu_torch.onnx.export_shim import torch_export

    torch.manual_seed(4)
    tm = TEaster2Attention(16, 32, 5, depth=1, ln_eps=1e-5).eval()
    path = str(tmp_path / "eps.onnx")
    torch_export(tm, torch.randn(1, 16, 32), path, do_constant_folding=False)
    module = Easter2(5, 16, variant="attention").eval()
    with pytest.raises(ValueError, match="epsilon"):
        transplant(load_model(path), module, None,
                   np.zeros((1, 16, 32), np.float32))


@pytest.mark.parametrize("name", ["easter2_nofold", "attention",
                                  "unet_nofold", "tf_easter2",
                                  "fp16_easter2"])
def test_write_back_gives_jax_bytes(cases, tmp_path, name):
    """The same variables written back by both packages give the same
    file. A TorchScript float32 file transplants back to the same tree
    (the tf2onnx dialect stores BatchNorm folded into Mul/Add constants,
    an fp16 file rounds the weights)."""
    case = cases.case(name)
    jmodule, tree = cases.jax_transplant(name)
    # weights unrelated to the export, as after training, so every
    # exporter-deduplicated slot needs its own initializer
    rng = np.random.default_rng(11)
    tree = copy.deepcopy(tree)
    for path, leaf in _leaves(tree):
        node = tree
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = (leaf + rng.uniform(-0.05, 0.05, leaf.shape)
                          ).astype(np.float32)
    x = case.port_x.astype(np.float32)
    want_path, got_path = tmp_path / "jax.onnx", tmp_path / "port.onnx"
    jax_retro.write_back(str(case.path), jmodule,
                         jax.tree_util.tree_map(jnp.asarray, tree),
                         jnp.asarray(case.jax_x.astype(np.float32)),
                         str(want_path))
    module = case.port_module()
    mapping = write_back(str(case.path), module, tree, x, str(got_path))
    assert mapping
    if name == "unet_nofold":
        assert mapping.additions  # de-aliased exporter-shared slots
    assert got_path.read_bytes() == want_path.read_bytes()
    if name in ("easter2_nofold", "attention", "unet_nofold"):
        back, _ = transplant(load_model(got_path), module, None, x)
        _assert_same_tree(back, tree)


def test_write_back_reads_the_module_by_default(cases, tmp_path):
    """variables=None writes the module's own weights
    (flax_variables(module)): the transplanted module's weights go back
    into the fold-free graph bit for bit."""
    case = cases.case("easter2_nofold")
    model = load_model(case.path)
    module = case.port_module()
    tree, _ = transplant(model, module, None, case.port_x)
    load_flax_tree(module, tree)
    out = tmp_path / "back.onnx"
    write_back(str(case.path), module, None, case.port_x, str(out))
    want = {k: t.to_numpy() for k, t in model.graph.initializers.items()}
    got = {k: t.to_numpy()
           for k, t in load_model(out).graph.initializers.items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("name", ["easter2_fold", "crnn"])
def test_folded_exports_are_refused(cases, tmp_path, name):
    case = cases.case(name)
    with pytest.raises(RetroplantError, match="do_constant_folding"):
        write_back(str(case.path), case.port_module(), None, case.port_x,
                   str(tmp_path / "nope.onnx"))
