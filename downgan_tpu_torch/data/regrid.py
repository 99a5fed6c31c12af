"""Nearest-neighbour regridding onto ERA-aligned lon-lat target grids: the
port's own copy of ``downgan_tpu/data/regrid.py``.

The reference does this step outside Python with the external CDO binary
(``DoWnGAN/GAN/scripts/regrid_16_fold/regrid_to_era.sh`` runs
``cdo remapnn,target.txt`` over WRF NetCDFs; grid specs in the two
``target.txt`` files). CDO is not in this environment and shelling out is
not part of a Python pipeline anyway, so this module implements ``remapnn`` directly:
build the target lon-lat grid, find nearest source indices once
(vectorized ``searchsorted`` on the monotone coordinate axes), then regrid
every time slice with a single fancy-index gather. The two reference
target grids (16-fold 0.09375 deg 880x432, 10-fold 0.075 deg 1100x540 —
``regrid_16_fold/target.txt:1-7``, ``regrid_10_fold/target.txt``) ship as
named presets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class LonLatGrid:
    """Regular lon-lat target grid (the CDO ``gridtype = lonlat`` spec)."""

    xsize: int
    ysize: int
    xfirst: float
    xinc: float
    yfirst: float
    yinc: float

    @property
    def lons(self) -> np.ndarray:
        return self.xfirst + self.xinc * np.arange(self.xsize)

    @property
    def lats(self) -> np.ndarray:
        return self.yfirst + self.yinc * np.arange(self.ysize)


# Reference target grids (regrid_16_fold/target.txt, regrid_10_fold/target.txt).
TARGET_GRIDS: Dict[str, LonLatGrid] = {
    "era_16_fold": LonLatGrid(880, 432, -139.055, 0.09375114738941193, 18.137, 0.09375),
    "era_10_fold": LonLatGrid(1100, 540, -139.055, 0.075, 18.137, 0.075),
}


def nearest_indices(source: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Index of the nearest source coordinate for each target coordinate.

    ``source`` must be monotonically increasing (the bisect contract of the
    reference's ``find_nearest_index``, ``helpers/prep_gan.py:16-48``) —
    vectorized over all targets instead of a Python bisect per point.
    """
    source = np.asarray(source, dtype=np.float64)
    if source.ndim != 1 or source.size < 2:
        raise ValueError("source coordinates must be a 1-D array of size >= 2")
    if np.any(np.diff(source) <= 0):
        raise ValueError("source coordinates must be monotonically increasing")
    idx = np.searchsorted(source, targets, side="left")
    idx = np.clip(idx, 1, len(source) - 1)
    left = source[idx - 1]
    right = source[idx]
    idx -= (np.abs(targets - left) < np.abs(targets - right)).astype(idx.dtype)
    return idx.astype(np.int64)


def find_nearest_index(data: np.ndarray, val: float) -> int:
    """Scalar nearest-index (drop-in for ``prep_gan.find_nearest_index``)."""
    return int(nearest_indices(data, np.asarray([val]))[0])


def remap_nearest(
    field: np.ndarray,
    src_lats: np.ndarray,
    src_lons: np.ndarray,
    grid: LonLatGrid,
) -> np.ndarray:
    """Nearest-neighbour remap of (..., lat, lon) onto ``grid``.

    Equivalent of ``cdo remapnn``: one precomputed index map, one gather.
    Returns (..., grid.ysize, grid.xsize).
    """
    yi = nearest_indices(src_lats, grid.lats)
    xi = nearest_indices(src_lons, grid.lons)
    return field[..., yi[:, None], xi[None, :]]


def coarsen_block_mean(field: np.ndarray, factor: int) -> np.ndarray:
    """Conservative block-mean coarsening of (..., lat, lon) by ``factor``
    (the fine->coarse companion of the 8x SR pairing; used by the synthetic
    data generator and upscale-consistency checks). (T, H, W) float32
    inputs take the native C++ kernel (``native.block_mean_coarsen``);
    other shapes/dtypes use the numpy reshape-mean."""
    *lead, h, w = field.shape
    if h % factor or w % factor:
        raise ValueError(f"spatial dims ({h},{w}) not divisible by {factor}")
    if field.ndim == 3 and field.dtype == np.float32:
        from downgan_tpu_torch.data import native

        return native.block_mean_coarsen(field, factor)
    return field.reshape(*lead, h // factor, factor, w // factor, factor).mean(
        axis=(-3, -1)
    )
