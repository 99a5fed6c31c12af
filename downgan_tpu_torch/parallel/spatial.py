"""Overlap-tiled full-domain inference, on one device or split over
several (counterpart of ``effective_fold``, ``count_tiled_dispatches`` and
``tiled_sr_inference`` in ``downgan_tpu/parallel/spatial.py``).

A stochastic generator's latent is drawn once for the whole domain and
appended before tiling (``spatial.py:238-247``), so overlapping tiles see
the same latent in the cells they share and stitch without seams. It is
the JAX package's numpy draw, so the two packages tile the same input.

Where the JAX package shards each dispatch's tiles over a mesh, the port
takes a list of devices: one generator replica on each, every dispatch's
folded tiles split among them in contiguous equal parts, and the result
stitched in tile order. The latent is drawn before the split, so it
follows the tile, not the device; each replica keeps its own DRB pack
cache on its own device.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch

from downgan_tpu_torch.config.config import Config
from downgan_tpu_torch.training.state import load_generator
from downgan_tpu_torch.training.wgan import fixed_latent


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
