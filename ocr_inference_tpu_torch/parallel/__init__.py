"""Mesh runtime: device meshes, shardings, data-parallel execution
(counterpart of ocr_inference_tpu/parallel)."""

from ocr_inference_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    DataParallelRunner,
    batch_sharding,
    distributed_init,
    host_shard,
    make_mesh,
    pad_to_multiple_of,
    replicate_params,
    replicated,
    shard_batch,
    tp_shardings,
)
