"""Ranks, batch rows and state replication (counterpart of
``downgan_tpu/parallel/mesh.py``).

The JAX package builds a device mesh in one process and lets GSPMD shard
the batch and replicate the state. PyTorch's idiom is one process per card
over ``torch.distributed``: a rank holds a full copy of the train state,
takes its contiguous rows of every global batch (:func:`batch_rows`, the
counterpart of ``batch_sharding``/``shard_batch``) and averages gradients
with the other ranks after each backward (``parallel/dp.py``). So there is
no ``make_mesh`` over devices here; without a process group a program is
rank 0 of 1. Spatial sharding (``parallel/spatial.py``) splits each field's
rows over the ranks of a spatial group instead: :func:`make_grid` lays the
job out as the JAX package's ``(data, spatial)`` mesh, and
:func:`field_rows` gives a rank its rows of a field.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


def in_group() -> bool:
    """Whether this process belongs to an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    """Ranks in ``group`` (default: the whole job); 1 without a process group."""
    return dist.get_world_size(group) if in_group() else 1


def rank(group=None) -> int:
    """This process's rank in ``group``; 0 without a process group."""
    return dist.get_rank(group) if in_group() else 0


def rows_of(global_batch: int, rank: int, world: int) -> slice:
    """The contiguous rows ``[rank * b, (rank + 1) * b)`` of a global batch
    of ``global_batch`` rows that rank ``rank`` of ``world`` takes, b =
    ``global_batch / world``; a batch that does not divide over the ranks is
    refused (every rank runs the same shapes)."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not a rank of a world of {world}")
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by {world} processes")
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


def field_rows(height: int, shards: int, index: int) -> slice:
    """The rows ``[index * h, (index + 1) * h)`` of a field of ``height``
    rows that spatial shard ``index`` of ``shards`` holds, h = ``height /
    shards``; a height the shards do not divide is refused (every shard
    holds as many rows, as ``shard_map`` requires in the JAX package)."""
    if shards < 1 or not 0 <= index < shards:
        raise ValueError(f"shard {index} is not a shard of {shards}")
    if height % shards:
        raise ValueError(f"a field of {height} rows does not split over {shards} spatial "
                         "shards; use a number of shards that divides it")
    per = height // shards
    return slice(index * per, (index + 1) * per)


def make_grid(data: int, spatial: int) -> Tuple[object, object]:
    """This rank's ``(data group, spatial group)`` of the job laid out as a
    ``data x spatial`` grid, spatial fastest (the JAX package's
    ``make_mesh((data, spatial), ("data", "spatial"))``): rank ``d *
    spatial + s`` is shard s of the field rows of data replica d. The
    spatial group of replica d is ranks ``[d * spatial, (d + 1) *
    spatial)``; the data group of shard s is ranks ``s, s + spatial, ...``.
    Every rank creates every group, in the same order (``new_group`` is a
    collective of the whole job), and keeps its own two."""
    if not in_group():
        raise RuntimeError("a grid of ranks needs a process group: call "
                           "parallel.multihost.initialize first")
    if data < 1 or spatial < 1 or data * spatial != dist.get_world_size():
        raise ValueError(f"a {data} x {spatial} grid does not cover the job's "
                         f"{dist.get_world_size()} ranks")
    me = dist.get_rank()
    mine = [None, None]
    for d in range(data):
        group = dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
        if me // spatial == d:
            mine[1] = group
    for s in range(spatial):
        group = dist.new_group(list(range(s, data * spatial, spatial)))
        if me % spatial == s:
            mine[0] = group
    return mine[0], mine[1]


def batch_rows(batch, rank: int, world: int, axis: int = 0):
    """This rank's contiguous rows of ``batch`` (a tensor or numpy array)
    along its batch ``axis``: 0 for a (B, ...) batch, 1 for the fused
    round's (n_critic, B, ...) stacks, -1 for an epoch's (steps, B) index
    matrix. A view; the whole batch at world size 1."""
    index = [slice(None)] * batch.ndim
    index[axis] = rows_of(batch.shape[axis], rank, world)
    return batch[tuple(index)]


def _state_tensors(state) -> Iterator[torch.Tensor]:
    """Every tensor of a ``GANTrainState`` in one order that depends only on
    its structure: both networks' parameters and buffers, the EMA
    generator's, then each optimizer's per-parameter state."""
    for module in (state.generator, state.critic, state.g_ema):
        if module is not None:
            yield from module.parameters()
            yield from module.buffers()
    for opt in (state.g_opt, state.c_opt):
        for group in opt.param_groups:
            for p in group["params"]:
                per_param = opt.state.get(p, {})
                for key in sorted(per_param):
                    if isinstance(per_param[key], torch.Tensor):
                        yield per_param[key]


@torch.no_grad()
def broadcast_tensors(tensors: List[torch.Tensor], device: torch.device, group=None) -> None:
    """Overwrite ``tensors`` on every rank with rank 0's, in place:
    one flat buffer per dtype on ``device`` (the collective's device: a
    CUDA tensor under NCCL; gloo takes either), one ``broadcast`` each, then
    ``copy_`` back. ``copy_`` bumps each tensor's version counter, so a DRB
    block's packed-weight cache, which keys on it, repacks."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(device) for t in same])
        dist.broadcast(flat, src=0, group=group)
        for t, chunk in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(chunk.view_as(t))


def replicate_state(state, group=None) -> None:
    """Make ``state`` (a ``GANTrainState`` built the same way on every rank:
    same config, same structure) rank 0's on every rank: every
    parameter, buffer, Adam moment and count and EMA tensor, and the step.
    The counterpart of the JAX package's ``replicate_state``; at world size
    1 it changes nothing."""
    device = next(state.generator.parameters()).device
    broadcast_tensors(list(_state_tensors(state)), device, group)
    step = torch.tensor([state.step], dtype=torch.int64, device=device)
    dist.broadcast(step, src=0, group=group)
    state.step = int(step.item())
