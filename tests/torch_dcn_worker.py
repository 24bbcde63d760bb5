"""Worker process for the port's two-process test (test_torch_distributed.py),
and the tiny pipeline the mesh tests share (test_torch_parallel.py).

Each worker joins a ``torch.distributed`` group over localhost (gloo)
through ``parallel.mesh.distributed_init``, from the JAX package's own
variables, so one launcher drives both packages; builds a mesh of
``TORCH_MESH_SIZE`` entries (default 4) over the one CPU device; and runs:

- one data-parallel training step (``training.make_train_step``): this
  process's rows of the global batch of 8, the BatchNorm statistics, the
  loss and the gradient reduced over its mesh and across the processes;
- ``host_shard`` input partitioning;
- an inference sweep: pages host-sharded across the processes, the
  pipeline data-parallel over this process's mesh, the per-page line
  counts all-gathered across the process boundary.

Writes a JSON result (and the updated parameters as .npz beside it) for
the parent test. Without the cluster variables it is the single-process
run the parent holds the group against. Run with:
  JAX_COORDINATOR_ADDRESS=localhost:<port> JAX_NUM_PROCESSES=2
  JAX_PROCESS_ID=<i> python tests/torch_dcn_worker.py OUT.json
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# 29 characters and the blank: a vocab of 30 splits over a model axis of 2
CHARSET = list("abcdefghijklmnopqrstuvwxyz'/ ")
REC_SMALL = {"width_mult": 0.03125, "stem_features": 16}
REC_SEED = 3
# the train step's optimizer: no warmup, so the first step moves
OPTIMIZER = {"learning_rate": 1e-3, "total_steps": 20, "warmup_steps": 0}
BUCKETS = (512, 1024)
MAX_LINES = 16


def page(seed: int, n_lines: int = 3, h: int = 400, w: int = 900,
         line_h: int = 28) -> np.ndarray:
    """A page of dark noise bands on a light ground (tests/dcn_worker.py's
    page, smaller)."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 235, dtype=np.uint8)
    step = h // (n_lines + 1)
    for i in range(n_lines):
        y0 = step * (i + 1)
        img[y0: y0 + line_h, 60: w - 60] = rng.integers(
            20, 70, size=(line_h, w - 120, 3))
    return img


class DensityLineModel(torch.nn.Module):
    """The ink density over a 9 x 41 window, as a line logit: masks that
    work without weights (tests/dcn_worker.py's Flax DensityLineModel, its
    SAME average pool counting the padding)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dark = 1.0 - x.mean(1, keepdim=True)
        density = F.avg_pool2d(dark, (9, 41), stride=1, padding=(4, 20),
                               count_include_pad=True)
        return (density - 0.35) * 40.0


def rec_config(data):
    """The recognizer's OCRModelConfig from a package's ``core.data``."""
    return data.OCRModelConfig(
        model_file="", architecture="Easter2", input_width=2000,
        input_height=80, input_layer="input", output_layer="output",
        squeeze_channel=True, swap_hw=False,
        encoder=data.CharsetEncoder.WYLIE, charset=CHARSET, add_blank=True,
        version="test")


def rec_variables() -> dict:
    """The seeded recognizer's Flax variables (numpy), for both
    packages."""
    from ocr_inference_tpu_torch.models.recognition import Easter2
    from ocr_inference_tpu_torch.pipeline.builder import seeded_variables

    return seeded_variables(Easter2(len(CHARSET) + 1, 80, **REC_SMALL),
                            REC_SEED)


def tiny_pipeline(mesh):
    """The density detector and the seeded small Easter2 behind the port's
    engines, on the CPU, float32."""
    from ocr_inference_tpu_torch.core import data
    from ocr_inference_tpu_torch.models.params import load_flax_tree
    from ocr_inference_tpu_torch.models.recognition import Easter2
    from ocr_inference_tpu_torch.pipeline import (
        OCRPipeline, RecognitionEngine, SegmentationEngine,
    )

    cpu = torch.device("cpu")
    rec = Easter2(len(CHARSET) + 1, 80, **REC_SMALL)
    load_flax_tree(rec, rec_variables())
    det = SegmentationEngine(DensityLineModel(), cpu, mode="line", mesh=mesh)
    engine = RecognitionEngine(
        rec.eval(), rec_config(data), cpu,
        data.BatchConfig(width_buckets=BUCKETS,
                         max_lines_per_batch=MAX_LINES), mesh=mesh)
    return OCRPipeline(engine, det)


def train_setup():
    """The two-process step's model (the JAX worker's Easter2, vocab 16, at
    32 x 64, narrowed to REC_SMALL) with the port's seeded init, and its
    batch of 8."""
    from ocr_inference_tpu_torch.models.params import (
        init_recognizer, load_flax_tree,
    )
    from ocr_inference_tpu_torch.models.recognition import Easter2
    from ocr_inference_tpu_torch.training import synthetic_ctc_batch

    model = Easter2(16, input_height=32, **REC_SMALL)
    variables = init_recognizer(model, 32, 64)
    load_flax_tree(model, variables)
    return model, variables, synthetic_ctc_batch(8, 32, 64, 16, max_label=10)


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def main(out_path: str) -> None:
    import torch.distributed as dist

    from ocr_inference_tpu_torch.core.data import OpStatus
    from ocr_inference_tpu_torch.models.params import flax_variables
    from ocr_inference_tpu_torch.parallel.mesh import (
        distributed_init, host_shard, make_mesh, process_count,
        process_index,
    )
    from ocr_inference_tpu_torch.training import make_optimizer, make_train_step
    from ocr_inference_tpu_torch.training.train import model_state

    torch.set_num_threads(1)
    distributed_init("cpu")
    pi, pc = process_index(), process_count()
    size = int(os.environ.get("TORCH_MESH_SIZE", "4"))
    mesh = make_mesh(devices=["cpu"] * size)

    t0 = time.time()
    model, _, batch = train_setup()
    optimizer = make_optimizer(**OPTIMIZER)
    rows = 8 // pc
    local = {k: v[pi * rows: (pi + 1) * rows] for k, v in batch.items()}
    state, loss = make_train_step(model, optimizer, mesh)(
        model_state(model, optimizer).as_tuple(), local)
    fingerprint = float(sum(p.detach().abs().sum()
                            for p in model.parameters()))
    np.savez(out_path + ".npz", **_flat(flax_variables(model)))

    t1 = time.time()
    n_pages = 4
    my_pages = host_shard(list(range(n_pages)))
    pipeline = tiny_pipeline(mesh)
    texts: dict[int, list[str]] = {}
    counts = torch.zeros(n_pages, dtype=torch.int64)
    for i in my_pages:
        status, payload = pipeline.run_ocr(page(100 + i))
        assert status == OpStatus.SUCCESS, payload
        texts[i] = [line.text for line in payload[2]]
        counts[i] = len(payload[2])
    if pc > 1:
        gathered = [torch.zeros_like(counts) for _ in range(pc)]
        dist.all_gather(gathered, counts)
        counts = torch.stack(gathered).sum(0)

    result = {
        "loss": float(loss),
        "fingerprint": fingerprint,
        "step_no": int(state[3]),
        "process_index": pi,
        "process_count": pc,
        "mesh_shape": mesh.shape,
        "host_shard": host_shard(list(range(10))),
        "inference": {
            "pages": my_pages,
            "texts": {str(i): t for i, t in texts.items()},
            "global_line_counts": [int(c) for c in counts],
        },
    }
    with open(out_path, "w") as f:
        json.dump(result, f)
    if pc > 1:
        dist.destroy_process_group()
    print(f"worker {pi}/{pc} OK loss={float(loss):.6f} train "
          f"{t1 - t0:.1f} s, pages {time.time() - t1:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1])
