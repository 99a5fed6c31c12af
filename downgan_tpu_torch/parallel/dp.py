"""Data-parallel WGAN-GP training across ranks (counterpart of
``downgan_tpu/parallel/dp.py``).

Every rank holds the whole train state, replicated (``mesh.replicate_state``)
and takes its contiguous rows of each global batch. After each update's
backward, the gradients are averaged across the ranks
(:func:`all_reduce_gradients`: one flat bucket per network, a ``SUM``
all-reduce, then a division by the world size) before the optimizer steps,
so every rank applies the same update and keeps the same weights, bit for
bit. The JAX package gets this from GSPMD, which inserts the psum.
PyTorch's ``DistributedDataParallel`` cannot carry it: the gradient
penalty differentiates the critic's input gradient
(``training/wgan.py::gradient_penalty``, ``create_graph=True``), a double
backward DDP's reducer does not support. So the step averages the
gradients itself, with ``all_reduce`` and ``broadcast`` only, which gloo
also runs on CUDA tensors.

The step's metrics are the ranks' means (:func:`all_reduce_means`), the
same on every rank. What depends on the whole batch is taken over the
global batch, as GSPMD does: the metric pass scores every rank's rows
(:func:`gather_rows`), and the physics terms divide by the std over every
rank's rows (:func:`global_std`).
"""
from __future__ import annotations

from typing import Callable, Iterator, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.nn.functional import all_reduce as all_reduce_with_grad

from downgan_tpu_torch.config.config import Config
from downgan_tpu_torch.parallel.mesh import batch_rows, rank, world_size
from downgan_tpu_torch.training.wgan import Metrics, build_fused_round, build_train_step
from downgan_tpu_torch.utils.profiling import annotate


@torch.no_grad()
def all_reduce_gradients(params: Sequence[torch.Tensor], group=None, average: bool = True) -> None:
    """Replace each gradient of ``params`` by its mean across ``group``'s
    ranks (their sum with ``average=False``): the gradients flattened into
    one bucket, all-reduced with ``SUM``, divided by the world size and
    copied back. Parameters without a gradient are left out (the same ones
    on every rank, which run the same graph). Exact at world size 1."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if average:
        flat.div_(dist.get_world_size(group))
    torch._foreach_copy_(grads, [c.view_as(g) for g, c in
                                 zip(grads, flat.split([g.numel() for g in grads]))])


def all_reduce_means(metrics: Metrics, group=None) -> Metrics:
    """Each metric's mean across ``group``'s ranks, one all-reduce for the
    whole dict; the same values on every rank."""
    if not metrics:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(dist.get_world_size(group))
    return dict(zip(keys, flat.unbind()))


@torch.no_grad()
def gather_rows(rows: torch.Tensor, group=None) -> torch.Tensor:
    """The global batch on every rank: each rank's ``rows`` (the same
    shape on every rank) in rank order along axis 0. Each rank writes its
    rows into a zero buffer of the global batch and the buffers are
    all-reduced with ``SUM`` (an all-gather that gloo also runs on CUDA
    tensors); adding zeros is exact, so the rows arrive bit for bit."""
    b = rows.shape[0]
    out = rows.new_zeros((b * dist.get_world_size(group), *rows.shape[1:]))
    r = dist.get_rank(group)
    out[r * b:(r + 1) * b] = rows
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def global_std(x: torch.Tensor, group=None) -> torch.Tensor:
    """The population std of the elements of ``x`` over every rank of
    ``group`` (each rank holding as many), in two passes, mean then
    squared deviations, each sum all-reduced by ``torch.distributed.nn``'s
    differentiable all-reduce: its backward all-reduces the gradient, so a
    rank's backward reaches the statistic's dependence on every rank's
    rows, and the averaged gradients are those of the global batch."""
    n = x.numel() * dist.get_world_size(group)
    mean = all_reduce_with_grad(x.sum(), group=group) / n
    return (all_reduce_with_grad((x - mean).square().sum(), group=group) / n).sqrt()


class GroupSync:
    """The ranks' agreement the train step takes as ``sync``
    (``training/wgan.py``): this process's rank and the world size of
    ``group`` (default: the whole job), gradients averaged by
    :func:`all_reduce_gradients`, metrics by :func:`all_reduce_means`,
    the global batch by :func:`gather_rows` and its std by
    :func:`global_std`."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("data-parallel training needs a process group: call "
                               "parallel.multihost.initialize first")
        self.group = group
        self.rank, self.world = rank(group), world_size(group)

    def gradients(self, params: Sequence[torch.Tensor]) -> None:
        all_reduce_gradients(params, self.group)

    def metrics(self, metrics: Metrics) -> Metrics:
        return all_reduce_means(metrics, self.group)

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        return gather_rows(rows, self.group)

    def std(self, x: torch.Tensor) -> torch.Tensor:
        return global_std(x, self.group)


def build_dp_train_step(config: Config, gen: nn.Module, critic: nn.Module, group=None,
                        eof_components=None) -> Callable[..., Metrics]:
    """The train step of ``config.hp.schedule`` (the reference step, or the
    fused n-critic round, whose stacks carry the batch on axis 1) over this
    rank's rows, its gradients and metrics averaged across ``group``."""
    build = build_fused_round if config.hp.schedule == "fused" else build_train_step
    return build(config, gen, critic, eof_components=eof_components, sync=GroupSync(group))


def device_batches(config: Config, ds, perm: np.ndarray, rank: int = 0, world: int = 1
                   ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """This rank's (coarse, fine) batches of one epoch over a
    device-resident set ``ds`` that every rank holds whole (replicated, as
    the JAX package's ``build_dp_epoch_scan``). ``perm`` is the epoch's
    (steps, B) global batch order, the same on every rank; each rank
    gathers its rows of each global batch on its device. On the fused
    schedule the order is cut to whole rounds of ``critic_iterations``
    batches and each batch is an (n, B / world, ...) stack. At world size 1
    these are the one-device epoch's batches. Each batch's gather is a
    ``feed.batch`` span."""
    hp = config.hp
    fused = hp.schedule == "fused"
    if fused:
        n_c = hp.critic_iterations
        rounds = len(perm) // n_c
        if rounds == 0:
            raise ValueError(f"dataset too small: {len(perm)} steps/epoch < "
                             f"critic_iterations={n_c} needed per fused round")
        perm = perm[:rounds * n_c].reshape(rounds, n_c, perm.shape[1])
    local = np.ascontiguousarray(batch_rows(perm, rank, world, axis=-1))
    for idx in torch.from_numpy(local).to(ds.device, torch.long):
        with annotate("feed.batch"):
            coarse, fine = ds.gather(idx.reshape(-1))
            if fused:
                coarse, fine = (t.reshape(*idx.shape, *t.shape[1:]) for t in (coarse, fine))
        yield coarse, fine


def build_dp_epoch(config: Config, gen: nn.Module, critic: nn.Module, group=None,
                   eof_components=None) -> Callable[..., Iterator[Metrics]]:
    """``epoch(state, ds, perm)``: one epoch of :func:`build_dp_train_step`
    over :func:`device_batches`, yielding each step's (or round's) metrics,
    the same on every rank (the counterpart of ``build_dp_epoch_scan``);
    ``epoch.step`` is the step."""
    step_fn = build_dp_train_step(config, gen, critic, group, eof_components)

    def epoch(state, ds, perm: np.ndarray) -> Iterator[Metrics]:
        for coarse, fine in device_batches(config, ds, perm, step_fn.sync.rank,
                                           step_fn.sync.world):
            yield step_fn(state, coarse, fine)

    epoch.step = step_fn
    return epoch
