"""Spatial parallelism: halo-exchange sharding of the fields' rows over
ranks, and overlap-tiled full-domain inference on one device or several
(counterpart of ``downgan_tpu/parallel/spatial.py``).

**Halo-exchange sharding** (``halo_exchange``, ``sharded_conv3x3``,
``make_sharded_conv``, ``sharded_generator_apply``,
``sharded_critic_apply``, ``build_spatial_train_step``,
``build_dp_spatial_train_step``). The fields' H axis is split over the
ranks of a spatial group (``torch.distributed``; gloo on the CPU, and gloo
ranks sharing one card), weights replicated. A sharded network takes and
returns whole fields that every rank of the group holds alike: it takes its
rows (:func:`scatter_rows`), runs every conv on its rows plus a halo from
its neighbours (:func:`halo_exchange`), and gathers the output's rows
(:func:`gather_rows`), as ``shard_map`` does around the JAX package's
networks. So the train step's losses, GP norms, metrics, alphas, latents
and flips run as they are on the replicated fields.

Every collective is an ``autograd.Function`` whose backward calls its
adjoint's ``apply`` (never ``once_differentiable``), so the gradient
penalty's double backward differentiates the collectives again: scatter
and gather are each other's adjoint, the halo exchange's adjoint returns
each halo row's cotangent to its owner, and :func:`row_sum` (the critic's
row-parallel fc1) has the identity as its backward, whose own backward is
the sum again. The rule behind them: a value every rank holds alike has
the whole cotangent on every rank; a rank's rows have their own.

gloo runs only ``all_reduce`` and ``broadcast`` on CUDA tensors, so every
gather and halo is "write your rows into a zero buffer, then
``all_reduce(SUM)``": adding zeros is exact, so rows arrive bit for bit.

The DRB kernel fuses a block's five convs into one launch, so a per-conv
halo cannot sit inside it. A sharded DRB takes one five-row halo instead
(global rows ``[max(0, r0 - 5), min(H, r1 + 5))``: no zero rows at the
domain's edges, whose SAME padding the kernel gives itself), runs the
kernel over that band and keeps its own rows: every row the band's false
edges reach is cropped away.

**Overlap-tiled inference** (``effective_fold``,
``count_tiled_dispatches`` and ``tiled_sr_inference``). A stochastic
generator's latent is drawn once for the whole domain and appended before
tiling (``spatial.py:238-247``), so overlapping tiles see the same latent
in the cells they share and stitch without seams. It is the JAX package's
numpy draw, so the two packages tile the same input.

Where the JAX package shards each dispatch's tiles over a mesh, the port
takes a list of devices: one generator replica on each, every dispatch's
folded tiles split among them in contiguous equal parts, and the result
stitched in tile order. The latent is drawn before the split, so it
follows the tile, not the device; each replica keeps its own DRB pack
cache on its own device.
"""
from __future__ import annotations

import math
from typing import Callable, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from downgan_tpu_torch.config.config import Config
from downgan_tpu_torch.models.generator import Generator
from downgan_tpu_torch.models.layers import CRITIC_SLOPE, GEN_SLOPE
from downgan_tpu_torch.parallel.dp import GroupSync, all_reduce_gradients
from downgan_tpu_torch.parallel.mesh import field_rows
from downgan_tpu_torch.training.state import load_generator
from downgan_tpu_torch.training.wgan import LOCAL_SYNC, Metrics, build_train_step, fixed_latent


def effective_fold(tiles_per_dispatch: int, n_devices: int = 1) -> int:
    """Tiles folded into one dispatch: ``tiles_per_dispatch``, rounded up
    to a multiple of ``n_devices`` so every replica takes the same batch
    (the JAX package's ``mesh_size``)."""
    k = max(1, tiles_per_dispatch)
    if n_devices > 1:
        k = -(-k // n_devices) * n_devices
    return k


def count_tiled_dispatches(b: int, h: int, w: int, tile_rows: int,
                           tile_cols: int = 0, tiles_per_dispatch: int = 8,
                           n_devices: int = 1) -> int:
    """Generator dispatches :func:`tiled_sr_inference` issues for a
    (b, h, w) domain: all tiles, ragged edge tiles included, folded
    :func:`effective_fold` at a time (a dispatch runs on every replica).
    ``/metrics`` reports it."""
    n_rows = -(-h // tile_rows)
    n_cols = -(-w // tile_cols) if tile_cols else 1
    return -(-(b * n_rows * n_cols) // effective_fold(tiles_per_dispatch, n_devices))


def generator_replicas(config: Config, weights: Mapping[str, torch.Tensor],
                       devices: Sequence[str | torch.device]) -> List[torch.nn.Module]:
    """One generator with ``weights`` on each of ``devices`` (a device may
    repeat: each replica is a module of its own)."""
    return [load_generator(config, weights, d) for d in devices]


def tiled_sr_inference(config: Config, weights: Mapping[str, torch.Tensor],
                       coarse: np.ndarray, tile_rows: int = 16, overlap: int = 8,
                       tile_cols: int = 0, tiles_per_dispatch: int = 8,
                       device: str | torch.device = "cuda",
                       devices: Optional[Sequence[str | torch.device]] = None) -> np.ndarray:
    """Full-domain super-resolution of (B, H, W, C) coarse fields (NHWC, H
    and W arbitrary) to (B, H*sf, W*sf, P) by overlap tiling, with the
    generator's ``weights`` (a state dict) on ``device``, or split over a
    replica on each of ``devices``.

    Each tile of ``tile_rows`` x ``tile_cols`` coarse cells (``tile_cols=0``:
    full-width row bands) is evaluated with ``overlap`` cells of context per
    side, the bands sliding inward at the domain edges; only the interior
    is kept. Tiles fold ``tiles_per_dispatch`` at a time (rounded up to a
    multiple of the replicas) into the batch axis, and each tile is cropped
    to its kept interior on the device before the copy to the host."""
    return tiled_generate(generator_replicas(config, weights, devices or [device]), config,
                          coarse, tile_rows=tile_rows, overlap=overlap, tile_cols=tile_cols,
                          tiles_per_dispatch=tiles_per_dispatch)


def tiled_generate(gen: torch.nn.Module | Sequence[torch.nn.Module], config: Config,
                   coarse: np.ndarray, tile_rows: int = 16, overlap: int = 8, tile_cols: int = 0,
                   tiles_per_dispatch: int = 8) -> np.ndarray:
    """:func:`tiled_sr_inference` with an already built generator, or a
    list of replicas (:func:`generator_replicas`), each on its own
    generator's device. For a stochastic generator, an input of
    ``n_covariates`` channels gets the whole-domain latent
    (``fixed_latent`` at (B, H, W, k)) appended before tiling; an input
    that already carries its latent channels is tiled as it is."""
    if tile_rows < 1 or overlap < 0 or tile_cols < 0:
        raise ValueError(
            f"invalid tiling: tile_rows={tile_rows} (>=1), overlap={overlap} "
            f"(>=0), tile_cols={tile_cols} (>=0)")
    # The generator's own output ratio, not the data pipeline's scale_factor.
    sf = 2 ** config.num_upsample
    b, h, w, c = coarse.shape
    if config.noise_channels and c == config.n_covariates:
        z = fixed_latent(config, (b, h, w, config.noise_channels)).astype(coarse.dtype)
        coarse = np.concatenate([coarse, z], axis=-1)
    band_h = tile_rows + 2 * overlap
    band_w = tile_cols + 2 * overlap if tile_cols else w
    keep_h = min(tile_rows, h) * sf
    keep_w = (min(tile_cols, w) if tile_cols else w) * sf
    if h < band_h:
        raise ValueError(f"domain height {h} smaller than band {band_h}; "
                         "reduce tile_rows/overlap or run the field whole")
    if tile_cols and w < band_w:
        raise ValueError(f"domain width {w} smaller than band {band_w}; "
                         "reduce tile_cols/overlap or leave tile_cols=0")

    row_starts = range(0, h, tile_rows)
    col_starts = range(0, w, tile_cols) if tile_cols else [0]
    # (sample, row start, band row origin, col start, band col origin) per tile
    places = []
    for bi in range(b):
        for rs in row_starts:
            r_lo = min(max(rs - overlap, 0), h - band_h)
            for cs in col_starts:
                c_lo = min(max(cs - overlap, 0), w - band_w) if tile_cols else 0
                places.append((bi, rs, r_lo, cs, c_lo))

    gens = [gen] if isinstance(gen, torch.nn.Module) else list(gen)
    out = np.zeros((b, h * sf, w * sf, config.n_predictands), np.float32)
    k = effective_fold(tiles_per_dispatch, len(gens))
    part = k // len(gens)  # tiles of a dispatch on each replica
    for start in range(0, len(places), k):
        sel = places[start:start + k]
        chunk = np.stack([coarse[bi, r_lo:r_lo + band_h, c_lo:c_lo + band_w]
                          for bi, _, r_lo, _, c_lo in sel]).astype(np.float32, copy=False)
        pad = k - chunk.shape[0]
        if pad:  # every dispatch keeps the same batch shape
            chunk = np.concatenate([chunk, np.zeros((pad, *chunk.shape[1:]), np.float32)])
        # Each tile's fetch window, clamped inside the band (a ragged last
        # tile keeps fewer cells), and the tile's offset inside it.
        kr = [min((rs - r_lo) * sf, band_h * sf - keep_h) for _, rs, r_lo, _, _ in sel]
        kc = [min((cs - c_lo) * sf, band_w * sf - keep_w) for _, _, _, cs, c_lo in sel]
        with torch.inference_mode():
            kept = []  # every replica's work is queued before the first copy back
            for r, g in enumerate(gens):
                lo, hi = r * part, min((r + 1) * part, len(sel))
                if lo >= hi:  # the rest of the dispatch is padding
                    break
                x = torch.from_numpy(chunk[lo:lo + part]).to(next(g.parameters()).device)
                fine = g(x.permute(0, 3, 1, 2).contiguous())  # (part, P, band_h*sf, band_w*sf)
                kept.append(torch.stack([fine[j - lo, :, kr[j]:kr[j] + keep_h,
                                              kc[j]:kc[j] + keep_w] for j in range(lo, hi)]))
            kept = np.concatenate([t.permute(0, 2, 3, 1).cpu().numpy() for t in kept])
        for j, (bi, rs, r_lo, cs, c_lo) in enumerate(sel):
            n_rows = min(tile_rows, h - rs) * sf
            n_cols = min(tile_cols, w - cs) * sf if tile_cols else w * sf
            off_r = (rs - r_lo) * sf - kr[j]
            off_c = (cs - c_lo) * sf - kc[j]
            out[bi, rs * sf:rs * sf + n_rows, cs * sf:cs * sf + n_cols] = (
                kept[j, off_r:off_r + n_rows, off_c:off_c + n_cols])
    return out


# -- halo-exchange sharding --------------------------------------------------------

DRB_HALO = 5  # the rows a DenseResidualBlock's five 3x3 convs reach


def _shard(group):
    """(shards, this rank's index) of the spatial ``group``."""
    return dist.get_world_size(group), dist.get_rank(group)


def band_rows(shards: int, index: int, h: int, k: int):
    """Global rows ``[lo, hi)``: shard ``index``'s h rows and up to ``k`` rows
    on each side, clipped at the domain's edges."""
    return max(0, index * h - k), min(shards * h, (index + 1) * h + k)


def _halo_owners(shards: int, index: int, h: int, k: int):
    """The halo of shard ``index`` by owner, (shard, rows), top to bottom:
    the rows above, a suffix of each owner's rows, and the rows below, a
    prefix. A shard of fewer than ``k`` rows takes rows from more than one
    neighbour; each owner gives at most min(k, h) rows, so they lie in its
    top or bottom min(k, h) rows."""
    lo, hi = band_rows(shards, index, h, k)
    above = [(j, (j + 1) * h - max(lo, j * h)) for j in range(lo // h, index)]
    below = [(j, min(hi, (j + 1) * h) - j * h) for j in range(index + 1, -(-hi // h))]
    return above, below


class _ScatterRows(torch.autograd.Function):
    """A whole field every rank holds alike -> this rank's rows. Backward:
    the rows' cotangents gathered into the whole field's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        shards, index = _shard(group)
        return x[:, :, field_rows(x.shape[2], shards, index)].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _GatherRows.apply(grad, ctx.group), None


class _GatherRows(torch.autograd.Function):
    """Each rank's rows -> the whole field on every rank, in rank order.
    Backward: this rank's rows of the whole cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        shards, index = _shard(group)
        b, c, h, w = x.shape
        out = x.new_zeros((b, c, h * shards, w))
        out[:, :, index * h:(index + 1) * h] = x
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _ScatterRows.apply(grad, ctx.group), None


class _HaloExchange(torch.autograd.Function):
    """This rank's rows (B, C, h, W) -> global rows ``band_rows(.., k)``: its
    rows with up to ``k`` rows of the ranks above and below, clipped at the
    domain's edges. Every rank puts its top and bottom min(k, h) rows into
    its slots of a zero buffer, one all-reduce fills every slot, and each
    rank reads its halo from its neighbours' slots. Backward:
    :class:`_HaloAdjoint`."""

    @staticmethod
    def forward(ctx, x, k, group):
        ctx.k, ctx.h, ctx.group = k, x.shape[2], group
        shards, index = _shard(group)
        b, c, h, w = x.shape
        m = min(k, h)
        edges = x.new_zeros((shards, 2, b, c, m, w))
        edges[index, 0] = x[:, :, :m]
        edges[index, 1] = x[:, :, h - m:]
        dist.all_reduce(edges, op=dist.ReduceOp.SUM, group=group)
        above, below = _halo_owners(shards, index, h, k)
        return torch.cat([edges[j, 1, :, :, m - n:] for j, n in above] + [x]
                         + [edges[j, 0, :, :, :n] for j, n in below], dim=2)

    @staticmethod
    def backward(ctx, grad):
        return _HaloAdjoint.apply(grad, ctx.k, ctx.h, ctx.group), None, None


class _HaloAdjoint(torch.autograd.Function):
    """The halo exchange's adjoint: a band's cotangent -> the cotangent of
    this rank's h rows, each halo row's cotangent sent back to the slot of
    its owner (one all-reduce) and added to the owner's rows there.
    Backward: :class:`_HaloExchange`."""

    @staticmethod
    def forward(ctx, grad, k, h, group):
        ctx.k, ctx.group = k, group
        shards, index = _shard(group)
        b, c, _, w = grad.shape
        m = min(k, h)
        above, below = _halo_owners(shards, index, h, k)
        top = sum(n for _, n in above)
        edges = grad.new_zeros((shards, 2, b, c, m, w))
        row = 0
        for j, n in above:
            edges[j, 1, :, :, m - n:] = grad[:, :, row:row + n]
            row += n
        row = top + h
        for j, n in below:
            edges[j, 0, :, :, :n] = grad[:, :, row:row + n]
            row += n
        dist.all_reduce(edges, op=dist.ReduceOp.SUM, group=group)
        out = grad[:, :, top:top + h].clone()
        out[:, :, :m] += edges[index, 0]
        out[:, :, h - m:] += edges[index, 1]
        return out

    @staticmethod
    def backward(ctx, grad):
        return _HaloExchange.apply(grad, ctx.k, ctx.group), None, None, None


class _RowSum(torch.autograd.Function):
    """The sum over the group of each rank's partial product: a value every
    rank then holds alike. Backward: the identity (:class:`_Replicate`):
    the whole cotangent is already on every rank, and summing it would
    scale it by the number of shards."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _Replicate.apply(grad, ctx.group), None


class _Replicate(torch.autograd.Function):
    """The identity from a value every rank holds alike to each rank's
    copy; its backward sums the copies' cotangents (:class:`_RowSum`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return _RowSum.apply(grad, ctx.group), None


def scatter_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's rows (``mesh.field_rows``) of the NCHW field ``x`` that
    every rank of ``group`` holds alike; differentiable."""
    return _ScatterRows.apply(x, group)


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The whole NCHW field on every rank of ``group`` from each rank's rows
    ``x``, bit for bit; differentiable. (``parallel.dp.gather_rows`` gathers
    a batch's samples.)"""
    return _GatherRows.apply(x, group)


def row_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ``group`` of each rank's ``x`` (a row-parallel product's
    partial result), with the identity as its backward."""
    return _RowSum.apply(x, group)


class RowShardedLinear(nn.Module):
    """A linear layer over an NCHW activation whose rows are split over the
    ranks of the spatial ``group`` (the JAX ``RowShardedDense``): each rank
    multiplies its flattened rows by the columns of ``linear``'s weight
    that they meet, :func:`row_sum` adds the partial products, and the bias
    is added after the sum. It shares ``linear``'s parameters.

    The flatten is NCHW, (C, H, W), so a rank's rows are not one block of
    the weight's columns, as in the JAX package's NHWC flatten: they are
    ``weight.view(out, C, H, W)[:, :, r0:r1]``. Computes in fp32."""

    def __init__(self, linear: nn.Linear, group=None):
        super().__init__()
        self.linear = linear
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        shards, index = _shard(self.group)
        weight = self.linear.weight.view(self.linear.out_features, c, h * shards, w)
        columns = weight[:, :, field_rows(h * shards, shards, index)].reshape(-1, c * h * w)
        return row_sum(F.linear(x.flatten(1), columns), self.group) + self.linear.bias


def halo_exchange(x: torch.Tensor, k: int, group=None, fill: bool = True) -> torch.Tensor:
    """This rank's rows (B, C, h, W) of an H-sharded field with ``k`` rows of
    the shards above and below: (B, C, h + 2k, W), global rows ``[r0 - k,
    r1 + k)``, with zero rows past the domain's edges (the SAME conv's
    padding, as the JAX ``halo_exchange``). Where a shard holds fewer than
    ``k`` rows, the halo takes rows from more than one neighbour. With
    ``fill=False`` the band stops at the domain's edges instead. Its
    backward returns each halo row's cotangent to its owner, and is itself
    differentiable."""
    band = _HaloExchange.apply(x, k, group)
    if not fill:
        return band
    shards, index = _shard(group)
    h = x.shape[2]
    lo, hi = band_rows(shards, index, h, k)
    return F.pad(band, (0, 0, k - (index * h - lo), k - (hi - (index + 1) * h)))


def sharded_conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                    group=None, stride: int = 1) -> torch.Tensor:
    """A 3x3 conv padded 1 (the unsharded ``Conv2d``) of an H-sharded NCHW
    block: a one-row halo, then ``F.conv2d`` with padding (0, 1), W padded
    locally. Stride 2 needs an even local H."""
    if stride == 2 and x.shape[2] % 2:
        raise ValueError(f"stride-2 sharded conv needs an even local H, got {x.shape[2]} "
                         "rows per shard — use fewer spatial shards")
    return F.conv2d(halo_exchange(x, 1, group), weight, bias, stride=stride, padding=(0, 1))


def make_sharded_conv(group=None) -> Callable[..., torch.Tensor]:
    """``conv(x, weight, bias)``: the 3x3 conv of a whole NCHW field ``x``
    (the same on every rank of ``group``) with OIHW ``weight``, as
    :func:`sharded_conv3x3` on each rank's rows, the output's rows gathered
    (the JAX ``make_sharded_conv``, whose input is sharded over the mesh)."""
    def conv(x, weight, bias):
        return gather_rows(sharded_conv3x3(scatter_rows(x, group), weight, bias, group), group)

    return conv


def sharded_drb(block: nn.Module, x: torch.Tensor, group=None) -> torch.Tensor:
    """A DenseResidualBlock (``models.generator.DenseResidualBlock``) on this
    rank's rows: one :data:`DRB_HALO`-row halo, clipped at the domain's
    edges (no zero rows), the block (the DRB kernel on a CUDA tensor,
    ``DRBFunction`` under autograd, the twin on the CPU) over the band,
    then this rank's rows of its output."""
    shards, index = _shard(group)
    h = x.shape[2]
    top = index * h - band_rows(shards, index, h, DRB_HALO)[0]
    return block(halo_exchange(x, DRB_HALO, group, fill=False))[:, :, top:top + h]


class ShardedGenerator(nn.Module):
    """An RRDB ``Generator`` evaluated with its rows split over the spatial
    ``group``: whole (B, C, h, w) fields in, whole (B, P, H, W) fields out,
    the same on every rank. It shares the generator's parameters (its
    ``module``), so the train state, Adam, the EMA and checkpoints are the
    unsharded ones. ``conv1``, ``conv2``, the up convs and the head run as
    one-row halo convs, the 48 DRBs as :func:`sharded_drb`, the pixel
    shuffles on local rows. It computes in fp32 whatever the generator's
    ``compute_dtype``, as the JAX ``sharded_generator_apply`` builds its
    ``Generator`` without a dtype. Latent channels are input channels and
    travel with their rows."""

    def __init__(self, generator: nn.Module, group=None):
        super().__init__()
        if type(generator) is not Generator:
            raise ValueError(f"spatial sharding runs the RRDB generator only, not "
                             f"{type(generator).__name__} (generator_arch='rrdb')")
        self.module = generator
        self.group = group

    def conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return sharded_conv3x3(x, conv.weight, conv.bias, self.group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.module
        x = scatter_rows(x.float(), self.group)
        out1 = self.conv(g.conv1, x)
        out = out1
        for rrdb in g.res_blocks:
            y = out
            for block in rrdb.dense_blocks:
                y = sharded_drb(block, y, self.group)
            out = y * 0.2 + out
        out = out1 + self.conv(g.conv2, out)
        for conv in g.upsampling[::3]:
            out = F.pixel_shuffle(F.leaky_relu(self.conv(conv, out), GEN_SLOPE), 2)
        out = F.leaky_relu(self.conv(g.conv3[0], out), GEN_SLOPE)
        return gather_rows(self.conv(g.conv3[2], out), self.group)


class ShardedCritic(nn.Module):
    """The ``Critic`` evaluated with its rows split over the spatial
    ``group``: whole fields in, scores the same on every rank out, in fp32
    (the JAX ``sharded_critic_apply``). The eight convs are halo convs; fc1
    is a :class:`RowShardedLinear`. Shares the critic's parameters (its
    ``module``). Needs ``fine_size / 16`` (fc1's input rows, read off its
    width and the last conv's channels) divisible by the shards, so every
    rank holds whole rows of fc1's input."""

    def __init__(self, critic: nn.Module, group=None):
        super().__init__()
        fc1 = critic.classifier[0]
        rows = math.isqrt(fc1.in_features // critic.features[-2].out_channels)
        shards = dist.get_world_size(group)
        if rows % shards:
            raise ValueError(f"the sharded critic needs fine_size/16 = {rows} "
                             f"divisible by the {shards} spatial shards")
        self.module = critic
        self.group = group
        self.fc1 = RowShardedLinear(fc1, group)

    def replicated_parameters(self) -> List[torch.Tensor]:
        """The parameters used only after fc1's row sum, on values every
        rank holds alike: fc1's bias and fc2's weight and bias."""
        fc1, fc2 = self.module.classifier[0], self.module.classifier[2]
        return [fc1.bias, fc2.weight, fc2.bias]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = scatter_rows(x.float(), self.group)
        for conv in self.module.features[::2]:
            x = F.leaky_relu(sharded_conv3x3(x, conv.weight, conv.bias, self.group,
                                             conv.stride[0]), CRITIC_SLOPE)
        fc2 = self.module.classifier[2]
        return F.linear(F.leaky_relu(self.fc1(x), CRITIC_SLOPE), fc2.weight, fc2.bias)


def sharded_generator_apply(config: Config, group=None) -> Callable[..., torch.Tensor]:
    """``apply(generator, coarse)``: the RRDB generator's forward of whole
    NCHW fields with the rows sharded over ``group`` inside
    (:class:`ShardedGenerator`, fp32), the output whole on every rank.
    Refuses an SRResNet config: the JAX apply builds an RRDB whatever the
    config, so an SRResNet's parameters do not load into it."""
    if config.generator_arch != "rrdb":
        raise ValueError(f"spatial sharding runs the RRDB generator only, not "
                         f"generator_arch={config.generator_arch!r}")

    def apply(generator: nn.Module, coarse: torch.Tensor) -> torch.Tensor:
        return ShardedGenerator(generator, group)(coarse)

    return apply


def sharded_critic_apply(config: Config, group=None) -> Callable[..., torch.Tensor]:
    """``apply(critic, fine)``: the critic's scores of whole NCHW fields with
    the rows sharded over ``group`` inside (:class:`ShardedCritic`, fp32),
    the same on every rank; differentiable, the GP's double backward
    included. ``config`` keeps the JAX signature: the critic's shape is
    read off the module."""
    def apply(critic: nn.Module, fine: torch.Tensor) -> torch.Tensor:
        return ShardedCritic(critic, group)(fine)

    return apply


class SpatialSync:
    """The ranks' agreement of a spatially sharded train step (the step's
    ``sync``, beside ``parallel.dp.GroupSync``).

    Gradients, and the rule that sets their scale: a parameter used inside
    the sharded region (every generator parameter, every critic conv and
    fc1's weight) holds on each rank only its rows' share of the gradient,
    so those are **summed** over the spatial ``group`` (a mean would scale
    them by 1/S). A parameter used only after fc1's row sum (``replicated``:
    fc1's bias and fc2) already holds its whole gradient on every rank and
    is left alone (a sum would scale it by S). Then, under DP x spatial,
    every gradient is averaged over ``data_group`` as ``GroupSync`` does.

    The batch's rank and world, the metrics, the gather and the std are the
    data group's (rank 0 of 1 without one): every rank of a spatial group
    holds the same samples whole, and the same metrics."""

    def __init__(self, group=None, replicated: Sequence[torch.Tensor] = (), data_group=None):
        self.group = group
        self.data = LOCAL_SYNC if data_group is None else GroupSync(data_group)
        self.rank, self.world = self.data.rank, self.data.world
        self._replicated = {id(p) for p in replicated}

    def gradients(self, params: Sequence[torch.Tensor]) -> None:
        all_reduce_gradients([p for p in params if id(p) not in self._replicated], self.group,
                             average=False)
        self.data.gradients(params)

    def metrics(self, metrics: Metrics) -> Metrics:
        return self.data.metrics(metrics)

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        return self.data.gather(rows)

    def std(self, x: torch.Tensor) -> torch.Tensor:
        return self.data.std(x)


def _spatially_sharded_step(config: Config, gen: nn.Module, critic: nn.Module, group,
                            data_group) -> Callable[..., Metrics]:
    """The reference-schedule ``build_train_step`` over the sharded networks
    and their :class:`SpatialSync`, refusing the conditional critic."""
    if config.critic_conditional:
        raise NotImplementedError(
            "the spatially-sharded train step supports the reference's "
            "unconditional critic only (the conditional critic's "
            "upsampled-covariate concat is not halo-decomposed); train "
            "critic_conditional models with the DP path")
    sharded_gen = ShardedGenerator(gen, group)
    sharded_critic = ShardedCritic(critic, group)
    sync = SpatialSync(group, sharded_critic.replicated_parameters(), data_group)
    return build_train_step(config, sharded_gen, sharded_critic, sync=sync)


def build_spatial_train_step(config: Config, gen: nn.Module, critic: nn.Module,
                             group=None) -> Callable[..., Metrics]:
    """The reference-schedule WGAN-GP train step (``training/wgan.py::
    build_train_step``, whatever ``hp.schedule``) with the fields' rows
    sharded over ``group`` instead of the batch: ``step(state, coarse,
    fine, ...)`` on whole fields the same on every rank, ``state`` holding
    ``gen`` and ``critic`` (replicated, updated alike on every rank). Both
    networks run sharded (:class:`ShardedGenerator`, :class:`ShardedCritic`)
    and gradients flow through the collectives. Refuses
    ``critic_conditional``, as the JAX package does."""
    return _spatially_sharded_step(config, gen, critic, group, None)


def build_dp_spatial_train_step(config: Config, gen: nn.Module, critic: nn.Module,
                                spatial_group, data_group) -> Callable[..., Metrics]:
    """:func:`build_spatial_train_step` composed with data parallelism over a
    ``(data, spatial)`` grid of ranks (``mesh.make_grid``): each data
    replica takes its rows of the global batch (``coarse`` and ``fine``
    are its samples, whole fields), its spatial group splits their rows,
    and the gradients are summed over the spatial group, then averaged over
    ``data_group``; metrics, the metric pass's batch and the physics std are
    the data group's."""
    return _spatially_sharded_step(config, gen, critic, spatial_group, data_group)
