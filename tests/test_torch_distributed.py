"""The port across a real process boundary: two OS processes, each with a
4-entry CPU mesh, joined by a gloo process group through
``parallel.mesh.distributed_init`` from the JAX package's variables
(JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID), as
tests/test_distributed_dcn.py launches the JAX package's workers.

Checked against the same worker run as one process with an 8-entry mesh
(tests/torch_dcn_worker.py): the train step's loss and parameter
fingerprint within rel 1e-6 (the same sums in another order), and against
the JAX package's single-process 8-device mesh step from the same
variables and batch at the bars of tests/test_torch_training.py (loss
rel 1e-5, parameters within what Adam can move them); ``host_shard``'s
halves; the inference sweep's host-sharded pages, all-gathered line
counts and the union of texts."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ocr_inference_tpu.models import Easter2 as JaxEaster2
from ocr_inference_tpu.parallel import make_mesh as jax_mesh
from ocr_inference_tpu.training import train as JT
from tests.torch_dcn_worker import OPTIMIZER, REC_SMALL, train_setup

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_dcn_worker.py"
TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                        "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")}
    env["PYTHONPATH"] = str(REPO) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _run(outs, envs) -> list[dict]:
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(out)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, cwd=str(REPO))
             for out, env in zip(outs, envs)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a worker timed out")
        assert p.returncode == 0, err.decode(errors="replace")[-3000:]
    return [json.loads(Path(o).read_text()) for o in outs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two workers' results, the one-process 8-entry result)."""
    root = tmp_path_factory.mktemp("dcn")
    port = _free_port()
    outs = [root / f"w{i}.json" for i in range(2)] + [root / "one.json"]
    envs = [_env(JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                 JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(i))
            for i in range(2)] + [_env(TORCH_MESH_SIZE="8")]
    results = _run(outs, envs)
    return results[:2], results[2], outs


def test_process_group_and_host_shard(runs):
    workers, one, _ = runs
    for i, r in enumerate(workers):
        assert r["process_count"] == 2 and r["process_index"] == i
        assert r["mesh_shape"] == {"data": 4, "model": 1}
        assert r["step_no"] == 1
    assert one["process_count"] == 1
    assert one["mesh_shape"] == {"data": 8, "model": 1}
    s0, s1 = workers[0]["host_shard"], workers[1]["host_shard"]
    assert s0 == list(range(0, 10, 2)) and s1 == list(range(1, 10, 2))


def test_train_step_across_processes(runs):
    """The same loss and update on both processes; equal to the
    one-process 8-entry step within rel 1e-6, and to the JAX package's
    8-device mesh step at the training bars."""
    workers, one, outs = runs
    a, b = workers
    assert a["loss"] == pytest.approx(b["loss"], rel=1e-9)
    assert a["fingerprint"] == pytest.approx(b["fingerprint"], rel=1e-9)
    assert a["loss"] == pytest.approx(one["loss"], rel=1e-6)
    assert a["fingerprint"] == pytest.approx(one["fingerprint"], rel=1e-6)

    _, variables, batch = train_setup()
    jm = JaxEaster2(vocab_size=16, dtype=jnp.float32, **REC_SMALL)
    opt = JT.make_optimizer(**OPTIMIZER)
    state = (variables["params"], variables["batch_stats"],
             opt.init(variables["params"]), 0)
    step = JT.make_train_step(jm, opt, jax_mesh(
        devices=jax.local_devices(backend="cpu")))
    (params, _, _, _), loss = step(state, batch)
    assert a["loss"] == pytest.approx(float(loss), rel=1e-5)
    got = np.load(str(outs[0]) + ".npz")
    want = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    # every element within what Adam's first step can move it (2 lr), the
    # mean distance under 1e-3 of that (tests/test_torch_training.py)
    moved = 2 * OPTIMIZER["learning_rate"]
    diffs = [np.abs(got[f"params/{k}"] - w) for k, w in want.items()]
    assert max(float(d.max()) for d in diffs) <= moved
    mean = sum(float(d.sum()) for d in diffs) / sum(d.size for d in diffs)
    assert mean <= 1e-3 * moved


def test_inference_sweep_across_processes(runs):
    workers, one, _ = runs
    inf0, inf1 = workers[0]["inference"], workers[1]["inference"]
    assert inf0["pages"] == [0, 2] and inf1["pages"] == [1, 3]
    assert inf0["global_line_counts"] == inf1["global_line_counts"]
    assert one["inference"]["pages"] == [0, 1, 2, 3]
    assert {**inf0["texts"], **inf1["texts"]} == one["inference"]["texts"]
    assert one["inference"]["global_line_counts"] == \
        inf0["global_line_counts"]
    assert all(c > 0 for c in inf0["global_line_counts"])
