"""Parallelism layer: ranks over ``torch.distributed``, batch rows, state
replication and the data-parallel train step (counterpart of
``downgan_tpu/parallel/__init__.py``). One process per card; the spatial
(halo-exchange) half of the JAX package's layer is not ported yet, and
``spatial.py`` here tiles a domain on one device."""
from downgan_tpu_torch.parallel.dp import (
    GroupSync,
    all_reduce_gradients,
    all_reduce_means,
    build_dp_epoch,
    build_dp_train_step,
    device_batches,
)
from downgan_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    batch_rows,
    rank,
    replicate_state,
    world_size,
)
from downgan_tpu_torch.parallel.multihost import (
    initialize,
    local_device,
    make_global_batch,
    process_batch_slice,
)
from downgan_tpu_torch.parallel.spatial import tiled_sr_inference

__all__ = [
    "DATA_AXIS",
    "GroupSync",
    "all_reduce_gradients",
    "all_reduce_means",
    "batch_rows",
    "build_dp_epoch",
    "build_dp_train_step",
    "device_batches",
    "initialize",
    "local_device",
    "make_global_batch",
    "process_batch_slice",
    "rank",
    "replicate_state",
    "tiled_sr_inference",
    "world_size",
]
