"""Dataset staging: raw NetCDF -> preprocessed train/test -> device arrays.
The port's own copy of ``downgan_tpu/data/staging.py``.

Capability parity with the reference's staging path: the xarray/dask
pipeline function ``generate_train_test_coarse_fine``
(``DoWnGAN/helpers/gen_experiment_datasets.py:236-268``), the
preprocessed-NetCDF writer (``helpers/gen_train_test_netcdfs.py:13-26``),
the ``load_preprocessed`` fast path (``gen_experiment_datasets.py:271-277``)
and the import-time device staging of ``GAN/stage.py:17-31`` — re-designed
as explicit functions over the h5py NetCDF layer (no dask cluster needed:
reads are one pass and the arrays then live in device memory).
"""
from __future__ import annotations

import glob as _glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from downgan_tpu_torch.config.config import (
    COVARIATE_NAMES_ORDERED,
    FINE_NAMES_ORDERED,
    NON_STANDARD_ATTRIBUTES,
    Config,
)
from downgan_tpu_torch.data.dataset import DeviceDataset
from downgan_tpu_torch.data.netcdf import NetCDFFile, write_netcdf
from downgan_tpu_torch.data.pipeline import (
    crop_array,
    extend_along_time,
    standardize_all,
    to_nhwc,
    train_test_split,
)
from downgan_tpu_torch.data.times import wrf_to_dt


def _read_var_multifile(
    path_or_glob: str,
    var: str,
    raw_var: Optional[str] = None,
    want_latlon: bool = False,
):
    """Read a variable (and its time coord if present) across a glob of
    NetCDF files, concatenated along time in TIME order — the reference's
    ``open_mfdataset(combine="by_coords")``
    (``gen_experiment_datasets.py:79-84``), which orders chunks by their
    coordinates, NOT by filename (lexical order scrambles unpadded names
    like ``wrf_2.nc`` / ``wrf_10.nc``).

    ``var`` is the standardized name; ``raw_var`` the raw NetCDF variable
    name from the registry (the reference selects
    ``ds[covariate_names_ordered[key]]`` — real ERA files store
    ``lsm``/``sp``/``sr``/``z``, which NON_STANDARD_ATTRIBUTES does not
    rename). ``want_latlon=True`` additionally returns the (lat, lon)
    coordinate arrays of the first file (None when absent).
    """
    paths = sorted(_glob.glob(path_or_glob)) or [path_or_glob]
    chunks: List[np.ndarray] = []
    times: List[np.ndarray] = []
    lat = lon = None
    for p in paths:
        with NetCDFFile(p) as f:
            names = {NON_STANDARD_ATTRIBUTES.get(n, n): n for n in f.variable_names}
            coord_names = {NON_STANDARD_ATTRIBUTES.get(n, n): n for n in f.coordinate_names}
            real = names.get(var)
            if real is None and raw_var is not None and raw_var in f.variable_names:
                real = raw_var
            if real is None:
                real = var
            arr = f.variable(real).data
            chunks.append(np.asarray(arr))
            if "time" in coord_names:
                times.append(np.asarray(f.coord(coord_names["time"])))
            if want_latlon and lat is None:
                if "lat" in coord_names:
                    lat = np.asarray(f.coord(coord_names["lat"]))
                if "lon" in coord_names:
                    lon = np.asarray(f.coord(coord_names["lon"]))
    if (len(chunks) > 1 and len(times) == len(chunks)
            and all(len(t) for t in times)):
        order = np.argsort([t[0] for t in times], kind="stable")
        chunks = [chunks[int(i)] for i in order]
        times = [times[int(i)] for i in order]
    data = np.concatenate(chunks, axis=0) if chunks[0].ndim == 3 else np.stack(chunks)
    t = np.concatenate(times) if times else None
    if want_latlon:
        return data, t, lat, lon
    return data, t


def load_data(
    fine_paths: Dict[str, str], coarse_path: str
) -> Dict[str, object]:
    """Open the legacy prep library's raw inputs in one call (parity with
    ``DoWnGAN/helpers/prep_gan.py:81-111`` ``load_data``): the fine U/V
    multi-file sets (glob patterns, concatenated along time) and the
    coarse UV NetCDF with latitude sorted ascending.

    Returns ``{"fine_u": (arr, times), "fine_v": (arr, times),
    "coarse": {var: arr, ..., "latitude": lat, "longitude": lon}}`` as
    numpy arrays (the reference returns lazy xarray datasets; here reads
    are one eager pass through the h5py layer).
    """
    out: Dict[str, object] = {}
    for key, var in (("fine_u", "u10"), ("fine_v", "v10")):
        arr, t = _read_var_multifile(fine_paths[var.upper()[0]], var)
        if t is not None and t.dtype.kind == "f":
            t = wrf_to_dt(t)
        out[key] = (arr, t)

    coarse: Dict[str, np.ndarray] = {}
    with NetCDFFile(coarse_path) as f:
        lat_name = next((n for n in f.coordinate_names
                         if NON_STANDARD_ATTRIBUTES.get(n, n) == "lat"), None)
        order = None
        if lat_name is not None:
            lat = np.asarray(f.coord(lat_name))
            order = np.argsort(lat, kind="stable")  # sortby ascending
            coarse["latitude"] = lat[order]
        for n in f.coordinate_names:
            std = NON_STANDARD_ATTRIBUTES.get(n, n)
            if std == "lon":
                coarse["longitude"] = np.asarray(f.coord(n))
        for n in f.variable_names:
            arr = np.asarray(f.variable(n).data, dtype=np.float64)
            if order is not None and arr.ndim >= 2:
                arr = np.take(arr, order, axis=-2)  # (.., lat, lon) layout
            coarse[n] = arr
    out["coarse"] = coarse
    return out


def load_fine(config: Config) -> Tuple[Dict[str, np.ndarray], Optional[np.ndarray]]:
    """Load + crop the fine-resolution predictands (reference
    ``load_fine``, ``gen_experiment_datasets.py:60-98``). Returns
    name->(time, lat, lon) dict and the decoded time axis."""
    out: Dict[str, np.ndarray] = {}
    times = None
    for std_name in FINE_NAMES_ORDERED:
        path = config.fine_paths[std_name]
        arr, t = _read_var_multifile(path, std_name)
        out[std_name] = crop_array(arr, config, config.scale_factor)
        if t is not None and times is None:
            times = t
    if times is not None and times.dtype.kind == "f":
        times = wrf_to_dt(times)
    return out, times


def load_fine_coords(
    config: Config,
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """The fine grid's true (lat, lon) coordinates cropped to the region.

    The reference threads the fine dataset's cropped coordinates into the
    generated NetCDF (``gen_fake_ds.py:181-182`` slices
    ``dsf.U10[time_mask, sf*low:sf*up, sf*l:sf*r]`` and ``:162`` writes
    that dataset's coords). Returns (None, None) when the fine files carry
    no lat/lon coordinates.
    """
    if not config.fine_paths:
        return None, None
    path_or_glob = next(iter(config.fine_paths.values()))
    paths = sorted(_glob.glob(path_or_glob)) or [path_or_glob]
    if not os.path.exists(paths[0]):
        return None, None
    lat = lon = None
    with NetCDFFile(paths[0]) as f:
        for n in f.coordinate_names:
            std = NON_STANDARD_ATTRIBUTES.get(n, n)
            if std == "lat":
                lat = np.asarray(f.coord(n))
            elif std == "lon":
                lon = np.asarray(f.coord(n))
    if lat is None or lon is None:
        return None, None
    lat_sl, lon_sl = config.region_box.fine_slices(config.scale_factor)
    return lat[lat_sl], lon[lon_sl]


def _crop_global_mask(
    arr: np.ndarray,
    mask_lat: np.ndarray,
    mask_lon: np.ndarray,
    fine_lat: np.ndarray,
    fine_lon: np.ndarray,
) -> np.ndarray:
    """Reference ``crop_global_mask`` (``gen_experiment_datasets.py:100-113``):
    the saved land-sea mask is a GLOBAL field on a 0-360-longitude grid, so
    it is cropped by matching the fine grid's extent against the mask's own
    coordinates (longitudes converted by -360) — keeping the reference's
    exact slice arithmetic (lat end exclusive of the max-matching row, lon
    end inclusive)."""
    mlat1 = int(np.argmin(np.abs(fine_lat.min() - mask_lat)))
    mlat2 = int(np.argmin(np.abs(fine_lat.max() - mask_lat)))
    mlon1 = int(np.argmin(np.abs(fine_lon.min() - (-360 + mask_lon))))
    mlon2 = int(np.argmin(np.abs(fine_lon.max() - (-360 + mask_lon)))) + 1
    return arr[:, mlat1:mlat2, mlon1:mlon2]


def load_covariates(
    config: Config,
    n_times: int,
    fine_coords: Optional[Tuple[Optional[np.ndarray], Optional[np.ndarray]]] = None,
) -> Dict[str, np.ndarray]:
    """Load + crop coarse covariates; broadcast invariant fields along time
    (reference ``load_covariates``, ``gen_experiment_datasets.py:115-151``).

    Parity details that only show on real ERA inputs: variables are found
    by the registry's raw NetCDF name too (``lsm``/``sp``/``sr``/``z`` —
    the reference selects ``ds[covariate_names_ordered[key]]``), every
    covariate is sorted latitude-ascending before the index crop
    (``sortby("lat", ascending=True)``, ``:133``), and the land-sea mask —
    a GLOBAL file upstream — is coordinate-cropped against the fine grid
    (``crop_global_mask``, ``:138``) whenever both sides carry lat/lon
    coordinates AND the mask longitudes are genuinely 0-360 (the only grid
    the reference's ``-360 + lon`` arithmetic is valid for); regional
    masks — coordinate-less or on ordinary -180..180 longitudes — keep
    the index crop.
    Invariant fields are cropped BEFORE the time broadcast (extending a
    global mask over ~19k steps first would materialize hundreds of GB).
    """
    if fine_coords is None:
        fine_coords = load_fine_coords(config)
    fine_lat, fine_lon = fine_coords
    out: Dict[str, np.ndarray] = {}
    for std_name, raw_name in COVARIATE_NAMES_ORDERED.items():
        path = config.covariate_paths[std_name]
        arr, _, lat, lon = _read_var_multifile(
            path, std_name, raw_var=raw_name, want_latlon=True)
        # Time-invariant fields (lsm, z — config.invariant_fields) arrive as
        # (lat, lon) or (1, lat, lon). Shape-driven so a file that already
        # carries a time axis passes through untouched.
        if arr.ndim == 2:
            arr = arr[None]
        if (lat is not None and lat.size == arr.shape[-2] and lat.size > 1
                and lat[0] > lat[-1]):
            arr = arr[..., ::-1, :]
            lat = lat[::-1]
        if (std_name == "land_sea_mask"
                and lat is not None and lon is not None
                and fine_lat is not None and fine_lon is not None
                and lat.size == arr.shape[-2] and lon.size == arr.shape[-1]
                # The reference's crop arithmetic (-360 + mask_lon) is only
                # meaningful for the GLOBAL 0-360 ERA mask it assumes; a
                # regional mask that happens to carry -180..180 coordinates
                # must keep the index crop or every argmin collapses to the
                # last column.
                and float(np.max(lon)) > 180.0):
            arr = _crop_global_mask(arr, lat, lon,
                                    np.asarray(fine_lat), np.asarray(fine_lon))
        else:
            arr = crop_array(np.asarray(arr), config, 1)
        if arr.shape[0] == 1 and n_times > 1:
            arr = extend_along_time(arr, n_times)
        out[std_name] = np.ascontiguousarray(arr)
    return out


def _check_same_grid(arrs: Dict[str, np.ndarray], what: str) -> None:
    """The coordinate crop of a global land-sea mask is argmin-driven: an
    off-by-one against the index-cropped covariates would otherwise only
    surface as an opaque np.stack failure (or, if sizes coincidentally
    matched, a silent grid misalignment). Fail with the offender named.
    Checked at EVERY stack site of ``load_covariates`` output (staging's
    ``generate_train_test_coarse_fine`` and inference's
    ``rebuild_coarse_covariates``), not inside ``load_covariates`` — the
    per-variable crop arithmetic itself is reference parity
    (gen_experiment_datasets.py crop_global_mask) and is pinned as such
    by tests that inspect mismatching fixtures un-stacked."""
    shapes = {k: v.shape[-2:] for k, v in arrs.items()}
    if len(set(shapes.values())) > 1:
        raise ValueError(
            f"{what} spatial grids disagree after cropping: "
            + ", ".join(f"{k}={s}" for k, s in shapes.items())
            + " — check that the land-sea mask file's lat/lon coordinates "
            "cover the configured region on the same coarse grid")


def generate_train_test_coarse_fine(
    config: Config,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Full pipeline: load -> standardize -> stack -> year split.

    Returns (coarse_train, fine_train, coarse_test, fine_test) as NHWC
    float32 arrays (reference returns (time, var, lat, lon) xr Datasets,
    ``gen_experiment_datasets.py:236-268``; the port's data tiers keep NHWC
    on the host and go NCHW on the device).
    """
    fine_vars, times = load_fine(config)
    n_times = next(iter(fine_vars.values())).shape[0]
    if times is None:
        times = np.asarray(config.range_datetimes[:n_times])
    cov_vars = load_covariates(config, n_times)

    fine_std, _ = standardize_all(fine_vars, skip=())
    cov_std, _ = standardize_all(cov_vars)

    _check_same_grid(cov_std, "covariate")
    fine = np.stack([fine_std[k] for k in FINE_NAMES_ORDERED], axis=1)
    coarse = np.stack([cov_std[k] for k in COVARIATE_NAMES_ORDERED], axis=1)

    ct, ft, cv, fv = train_test_split(coarse, fine, times[:n_times], config.mask_years)
    return (
        to_nhwc(ct).astype(np.float32),
        to_nhwc(ft).astype(np.float32),
        to_nhwc(cv).astype(np.float32),
        to_nhwc(fv).astype(np.float32),
    )


# -- preprocessed file round trip -------------------------------------------

def preprocessed_path(config: Config, kind: str, split: str) -> str:
    """``<proc_data_dir>/<kind>_<split>_<region>.nc`` (reference layout,
    ``gen_train_test_netcdfs.py:20-26``)."""
    return os.path.join(config.proc_data_dir, f"{kind}_{split}_{config.region}.nc")


def write_preprocessed(
    config: Config,
    coarse_train: np.ndarray,
    fine_train: np.ndarray,
    coarse_test: np.ndarray,
    fine_test: np.ndarray,
    fine_lats: Optional[np.ndarray] = None,
    fine_lons: Optional[np.ndarray] = None,
) -> List[str]:
    """Write the 4 preprocessed NetCDFs (NHWC stored as (time, var, lat, lon)
    for on-disk parity with the reference's concat layout). When the fine
    grid's true coordinates are known (``load_fine_coords``) they are
    stored on the fine files so downstream tools (``generate``) can attach
    real geospatial coords instead of index ranges."""
    os.makedirs(config.proc_data_dir, exist_ok=True)
    paths = []
    arrays = {
        ("coarse", "train"): coarse_train,
        ("fine", "train"): fine_train,
        ("coarse", "test"): coarse_test,
        ("fine", "test"): fine_test,
    }
    for (kind, split), arr in arrays.items():
        path = preprocessed_path(config, kind, split)
        tvhw = np.ascontiguousarray(np.transpose(arr, (0, 3, 1, 2)))
        names = list(COVARIATE_NAMES_ORDERED if kind == "coarse" else FINE_NAMES_ORDERED)
        coords = {"time": np.arange(tvhw.shape[0], dtype=np.float64)}
        if (kind == "fine" and fine_lats is not None and fine_lons is not None
                and len(fine_lats) == tvhw.shape[2]
                and len(fine_lons) == tvhw.shape[3]):
            coords["lat"] = np.asarray(fine_lats, dtype=np.float64)
            coords["lon"] = np.asarray(fine_lons, dtype=np.float64)
        write_netcdf(
            path,
            variables={"data": tvhw},
            dims={"data": ("time", "var", "lat", "lon")},
            coords=coords,
            attrs={"data": {"variables": ",".join(names)}},
            # One time row per chunk: sequential whole-file loads are
            # unaffected (uncompressed), and the disk-streaming tier
            # (data/stream.py) reads random batch rows with zero chunk
            # amplification.
            chunks={"data": (1, tvhw.shape[1], tvhw.shape[2], tvhw.shape[3])},
        )
        paths.append(path)
    return paths


def load_preprocessed_coords(
    config: Config,
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Read the fine grid's stored (lat, lon) coords back from the
    preprocessed fine-test file (written by :func:`write_preprocessed`);
    (None, None) for files from before coords were stored."""
    path = preprocessed_path(config, "fine", "test")
    if not os.path.exists(path):
        return None, None
    with NetCDFFile(path) as f:
        names = set(f.coordinate_names)
        if "lat" in names and "lon" in names:
            return np.asarray(f.coord("lat")), np.asarray(f.coord("lon"))
    return None, None


def load_preprocessed(config: Config) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Read the 4 preprocessed NetCDFs back as NHWC float32 (reference
    ``load_preprocessed``, ``gen_experiment_datasets.py:271-277``)."""
    out = []
    for kind, split in (("coarse", "train"), ("fine", "train"), ("coarse", "test"), ("fine", "test")):
        with NetCDFFile(preprocessed_path(config, kind, split)) as f:
            out.append(to_nhwc(np.asarray(f.variable("data").data)).astype(np.float32))
    return tuple(out)  # type: ignore[return-value]


def stage_datasets(config: Config, device) -> Tuple[DeviceDataset, DeviceDataset]:
    """Device staging (reference ``GAN/stage.py:17-31``): preprocessed (or
    freshly generated) arrays -> train and test ``DeviceDataset``s on
    ``device``, NCHW."""
    if config.already_preprocessed:
        ct, ft, cv, fv = load_preprocessed(config)
    else:
        ct, ft, cv, fv = generate_train_test_coarse_fine(config)
    return DeviceDataset.from_numpy(ct, ft, device), DeviceDataset.from_numpy(cv, fv, device)
