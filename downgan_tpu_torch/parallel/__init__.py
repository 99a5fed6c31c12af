"""Parallelism layer: ranks over ``torch.distributed``, batch rows, state
replication, the data-parallel train step, halo-exchange spatial sharding
of the fields' rows (the sharded networks and the spatial and DP x spatial
train steps) and overlap-tiled inference (counterpart of
``downgan_tpu/parallel/__init__.py``). One process per card; on one card,
gloo ranks can share it."""
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
    SPATIAL_AXIS,
    batch_rows,
    field_rows,
    make_grid,
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
from downgan_tpu_torch.parallel.spatial import (
    SpatialSync,
    build_dp_spatial_train_step,
    build_spatial_train_step,
    halo_exchange,
    make_sharded_conv,
    sharded_critic_apply,
    sharded_generator_apply,
    tiled_sr_inference,
)

__all__ = [
    "DATA_AXIS",
    "SPATIAL_AXIS",
    "GroupSync",
    "SpatialSync",
    "all_reduce_gradients",
    "all_reduce_means",
    "batch_rows",
    "build_dp_epoch",
    "build_dp_spatial_train_step",
    "build_dp_train_step",
    "build_spatial_train_step",
    "device_batches",
    "field_rows",
    "halo_exchange",
    "initialize",
    "local_device",
    "make_global_batch",
    "make_grid",
    "make_sharded_conv",
    "process_batch_slice",
    "rank",
    "replicate_state",
    "sharded_critic_apply",
    "sharded_generator_apply",
    "tiled_sr_inference",
    "world_size",
]
