"""Dataset-generation pipeline: the port's own copy of
``downgan_tpu/data/pipeline.py``.

Capability parity with the reference's xarray/dask pipeline
(``DoWnGAN/helpers/gen_experiment_datasets.py``): attribute-name
standardization, region cropping, z-score standardization with the
reference's sanity asserts, invariant-field broadcast along time,
(time, var, lat, lon) concatenation, and the year-mask train/test split
with its ``test[0] = False`` quirk. Implemented on plain numpy dicts —
the multi-process dask cluster the reference needs for NetCDF decode
(``gen_train_test_netcdfs.py:29-33``) is unnecessary here because h5py
reads are a single pass and the arrays then live in memory.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from downgan_tpu_torch.config.config import Config, NON_STANDARD_ATTRIBUTES
from downgan_tpu_torch.data.times import filter_times


def standardize_names(names: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Rename non-standard variable keys (reference gen_experiment_datasets.py:36-46)."""
    return {NON_STANDARD_ATTRIBUTES.get(k, k): v for k, v in names.items()}


def crop_array(arr: np.ndarray, config: Config, scale_factor: int) -> np.ndarray:
    """Crop (time, lat, lon) to the configured region box scaled by
    ``scale_factor`` (reference gen_experiment_datasets.py:19-33)."""
    lat_sl, lon_sl = (
        config.region_box.fine_slices(scale_factor)
        if scale_factor != 1
        else config.region_box.coarse_slices()
    )
    return arr[:, lat_sl, lon_sl]


def standardize(arr: np.ndarray) -> Tuple[np.ndarray, float, float]:
    """Z-score over all elements, NaN-skipping (reference :195-201).

    float32 arrays take the native C++ single-pass path
    (``data/native.py``); anything else falls back to numpy. Real
    pipeline inputs are usually crop_array slices (non-contiguous
    views), so the contiguity the kernel needs is established here with
    the same copy the in-place z-score requires anyway.
    """
    if arr.dtype == np.float32:
        from downgan_tpu_torch.data import native

        buf = np.ascontiguousarray(arr)
        if buf is arr:  # standardize never mutates its input
            buf = arr.copy()
        mean, std, _ = native.nan_moments(buf)
        return native.standardize_inplace(buf, mean, std), mean, std
    mean = float(np.nanmean(arr))
    std = float(np.nanstd(arr))
    return (arr - mean) / std, mean, std


def standardize_all(
    data: Dict[str, np.ndarray],
    skip: Sequence[str] = ("land_sea_mask",),
    loose: Sequence[str] = ("surface_pressure",),
    stats: Optional[Dict[str, Tuple[float, float]]] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, Tuple[float, float]]]:
    """Standardize every variable except the binary mask, with the
    reference's post-hoc asserts (gen_experiment_datasets.py:203-233).

    If ``stats`` is given, reuse those (train-set) mean/std instead of
    refitting — the train-statistics reuse the legacy covariate CLI applies
    to validation data (helpers/covariates.py).
    """
    out: Dict[str, np.ndarray] = {}
    used: Dict[str, Tuple[float, float]] = {}
    for key, arr in data.items():
        if key in skip:
            out[key] = arr
            continue
        if stats is not None and key in stats:
            mean, std = stats[key]
            out[key] = (arr - mean) / std
            used[key] = (mean, std)
            continue
        out[key], mean, std = standardize(arr)
        used[key] = (mean, std)
        new_mean = float(np.nanmean(out[key]))
        new_std = float(np.nanstd(out[key]))
        assert np.isclose(new_mean, 0.0, atol=1e-2), f"Mean of {key} is not 0!"
        std_tol = 1.0 if key in loose else 1e-1
        assert np.isclose(new_std, 1.0, atol=std_tol), f"Std of {key} not in tolerance!"
    return out, used


def extend_along_time(arr: np.ndarray, n_times: int) -> np.ndarray:
    """Broadcast a time-invariant (lat, lon) field along a new leading time
    axis (reference :49-58). Returns a broadcast view (no copy)."""
    if arr.ndim == 3 and arr.shape[0] == 1:
        arr = arr[0]
    return np.broadcast_to(arr, (n_times,) + arr.shape)


def concat_variables(
    data: Dict[str, np.ndarray], order: Sequence[str]
) -> np.ndarray:
    """Stack variables into (time, var, lat, lon) in registry order
    (reference :154-165)."""
    return np.stack([np.asarray(data[k]) for k in order], axis=1)


def train_test_split(
    coarse: np.ndarray,
    fine: np.ndarray,
    times: Sequence,
    mask_years: Sequence[int],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Year-held-out split (reference :168-192): train = years NOT in
    mask_years; test = complement, with the first sample dropped when 2000
    is masked (bad first WRF field)."""
    assert coarse.shape[0] == fine.shape[0], "Time dim mismatch coarse vs fine!"
    train_mask = filter_times(times, mask_years=mask_years)
    test_mask = ~train_mask
    if 2000 in set(int(y) for y in mask_years):
        test_mask = test_mask.copy()
        test_mask[0] = False
    return coarse[train_mask], fine[train_mask], coarse[test_mask], fine[test_mask]


def to_nhwc(arr: np.ndarray) -> np.ndarray:
    """(time, var, lat, lon) -> (time, lat, lon, var): the layout of the data
    tiers' arrays (NCHW only on the device)."""
    return np.ascontiguousarray(np.transpose(arr, (0, 2, 3, 1)))


def from_nhwc(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(arr, (0, 3, 1, 2)))
