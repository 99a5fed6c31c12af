"""The port's own copies of the JAX package's data modules, against the JAX
package, exactly (both sides are the same numpy arithmetic): WRF times,
regridding, the pipeline steps, CF decoding and the NetCDF reader and
writers, the native host library against its numpy version, and the whole
staging chain on raw NetCDFs that the JAX package's ``write_netcdf``
writes (plain float32 and int16-packed as ERA files are):
``generate_train_test_coarse_fine``, ``write_preprocessed`` and
``load_preprocessed`` both ways, ``prepare-covariates``' files and
statistics, and ``cli train`` from raw files, and from ``prepare-data``'s
files with ``--host-feed`` and ``--stream``."""
import json
from datetime import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")
pytest.importorskip("jax")

from downgan_tpu.config.config import Config as JaxConfig  # noqa: E402
from downgan_tpu.data import native as jax_native  # noqa: E402
from downgan_tpu.data import netcdf as jax_netcdf  # noqa: E402
from downgan_tpu.data import pipeline as jax_pipeline  # noqa: E402
from downgan_tpu.data import regrid as jax_regrid  # noqa: E402
from downgan_tpu.data import staging as jax_staging  # noqa: E402
from downgan_tpu.data import times as jax_times  # noqa: E402
from downgan_tpu_torch.cli.__main__ import main  # noqa: E402
from downgan_tpu_torch.config.config import COVARIATE_NAMES_ORDERED, Config, HyperParams  # noqa: E402
from downgan_tpu_torch.data import native, netcdf, pipeline, regrid, staging, times  # noqa: E402
from downgan_tpu_torch.data.dataset import DeviceDataset  # noqa: E402
from downgan_tpu_torch.data.feed import HostDataset  # noqa: E402
from downgan_tpu_torch.data.stream import StreamDataset  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401


def assert_same(a, b):
    """Equal values, dtypes and shapes (NaN equal to NaN), recursively."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b), (a, b)


# -- times, regrid, pipeline -------------------------------------------------

def test_times_match_jax():
    start, end = datetime(2000, 10, 1), datetime(2001, 1, 3, 12)
    assert times.datetime_wrf_period(start, end) == jax_times.datetime_wrf_period(start, end)
    wrf = [20000101.0, 20000101.25, 20000229.5, 20061231.75, 20100615.125]
    assert_same(times.wrf_to_dt(wrf), jax_times.wrf_to_dt(wrf))
    assert_same(times.dt_index(wrf), jax_times.dt_index(wrf))
    for ts in (times.wrf_to_dt(wrf), times.datetime_wrf_period(start, end)):
        for mask in (None, (2000, 2006), (2001,)):
            assert_same(times.filter_times(ts, mask), jax_times.filter_times(ts, mask))


def test_regrid_matches_jax():
    rng = np.random.default_rng(0)
    src = np.cumsum(rng.uniform(0.05, 0.2, 60))
    targets = rng.uniform(src[0] - 1, src[-1] + 1, 40)
    assert_same(regrid.nearest_indices(src, targets), jax_regrid.nearest_indices(src, targets))
    assert regrid.find_nearest_index(src, 3.3) == jax_regrid.find_nearest_index(src, 3.3)
    assert regrid.TARGET_GRIDS == {k: regrid.LonLatGrid(**vars(v))
                                   for k, v in jax_regrid.TARGET_GRIDS.items()}
    grid = regrid.LonLatGrid(12, 9, -139.0, 0.5, 18.2, 0.4)
    lats, lons = 18.0 + 0.3 * np.arange(15), -139.5 + 0.35 * np.arange(20)
    field = rng.standard_normal((3, 15, 20)).astype(np.float32)
    assert_same(regrid.remap_nearest(field, lats, lons, grid),
                jax_regrid.remap_nearest(field, lats, lons, jax_regrid.LonLatGrid(**vars(grid))))
    for arr in (field[:, :12, :16], field[:, :12, :16].astype(np.float64), field[None, :, :12, :16]):
        assert_same(regrid.coarsen_block_mean(arr, 4), jax_regrid.coarsen_block_mean(arr, 4))
    for bad in (np.array([1.0]), np.array([2.0, 1.0])):
        with pytest.raises(ValueError, match="source coordinates"):
            regrid.nearest_indices(bad, targets)
    with pytest.raises(ValueError, match="divisible"):
        regrid.coarsen_block_mean(field, 4)


def test_pipeline_matches_jax():
    rng = np.random.default_rng(1)
    cfg, jcfg = Config(region="florida"), JaxConfig(region="florida")
    coarse = rng.standard_normal((5, 22, 90)).astype(np.float32)
    fine = rng.standard_normal((5, 170, 700)).astype(np.float32)
    for arr, factor in ((coarse, 1), (fine, 8)):
        assert_same(pipeline.crop_array(arr, cfg, factor), jax_pipeline.crop_array(arr, jcfg, factor))
    with_nan = (rng.standard_normal((6, 7)) * 3 + 2).astype(np.float32)
    with_nan[0, 0] = np.nan
    for arr in (with_nan, with_nan.astype(np.float64), coarse[:, 4:20, 70:86]):
        assert_same(pipeline.standardize(arr), jax_pipeline.standardize(arr))
    data = {"u10": coarse * 4 + 1, "land_sea_mask": (coarse > 0).astype(np.float32),
            "surface_pressure": coarse * 100 + 1e5}
    out, stats = pipeline.standardize_all(data)
    assert_same((out, stats), jax_pipeline.standardize_all(data))
    assert_same(pipeline.standardize_all(data, stats=stats),
                jax_pipeline.standardize_all(data, stats=stats))
    assert_same(pipeline.standardize_names({"U10": 1, "latitude": 2, "cape": 3}),
                jax_pipeline.standardize_names({"U10": 1, "latitude": 2, "cape": 3}))
    for inv in (coarse[0], coarse[:1]):
        assert_same(pipeline.extend_along_time(inv, 4), jax_pipeline.extend_along_time(inv, 4))
    assert_same(pipeline.concat_variables(data, ["u10", "surface_pressure"]),
                jax_pipeline.concat_variables(data, ["u10", "surface_pressure"]))
    ts = times.wrf_to_dt([20000101.0, 20000101.5, 20010101.0, 20060101.0, 20070101.0])
    stack = rng.standard_normal((5, 2, 3, 4)).astype(np.float32)
    for years in ((2000, 2006), (2001,)):
        assert_same(pipeline.train_test_split(stack, stack + 1, ts, years),
                    jax_pipeline.train_test_split(stack, stack + 1, ts, years))
    assert_same(pipeline.to_nhwc(stack), jax_pipeline.to_nhwc(stack))
    assert_same(pipeline.from_nhwc(pipeline.to_nhwc(stack)), stack)


# -- CF decoding, the NetCDF layer, the native library -----------------------

CF_CASES = {
    "int16_fill": (np.arange(-300, 300, dtype=np.int16),
                   {"scale_factor": np.float64(0.0183), "add_offset": np.float32(7.25),
                    "_FillValue": np.int16(-300)}),
    "int8_missing": (np.arange(-100, 100, dtype=np.int8),
                     {"scale_factor": 0.5, "missing_value": np.array([-100], np.int8)}),
    "int16_offset_only": (np.arange(50, dtype=np.int16), {"add_offset": -3.0}),
    "int32_two_fills": (np.arange(-5, 20, dtype=np.int32),
                        {"scale_factor": 2.0, "_FillValue": np.array([-5, 7], np.int32)}),
    "float_fill": (np.linspace(-1, 1, 9).astype(np.float32), {"_FillValue": np.float32(0.0)}),
    "plain": (np.linspace(-1, 1, 9).astype(np.float32), {}),
}


@pytest.mark.parametrize("case", CF_CASES, ids=str)
def test_decode_cf_matches_jax(case):
    raw, attrs = CF_CASES[case]
    assert_same(netcdf._decode_cf(raw, attrs), jax_netcdf._decode_cf(raw, attrs))


def numpy_only(fn):
    """Run ``fn`` with the native library taken away: the numpy versions."""
    saved = dict(native._state)
    native._state["lib"] = None
    try:
        return fn()
    finally:
        native._state.clear()
        native._state.update(saved)


NATIVE_CASES = {
    "cf_unpack_i16": lambda rng: native.cf_unpack(
        rng.integers(-32000, 32000, 5000, dtype=np.int16).clip(-32767), 1.8307457812500001e-03,
        0.1234567890123456, -32767),
    "cf_unpack_i8_no_fill": lambda rng: native.cf_unpack(
        rng.integers(-120, 120, 999, dtype=np.int8), 0.37, -2.0, None),
    "nan_moments": lambda rng: native.nan_moments(np.where(
        rng.random(20000) < 0.01, np.nan, rng.standard_normal(20000) * 40 + 1e3
    ).astype(np.float32)),
    "standardize_inplace": lambda rng: native.standardize_inplace(
        (rng.standard_normal(4000) * 2 + 5).astype(np.float32), 5.01234567, 1.98765),
    "block_mean_8": lambda rng: native.block_mean_coarsen(
        (rng.standard_normal((3, 32, 48)) * 5).astype(np.float32), 8),
    "block_mean_3": lambda rng: native.block_mean_coarsen(
        (rng.standard_normal((2, 9, 15)) * 5).astype(np.float32), 3),
}


@pytest.mark.parametrize("case", NATIVE_CASES, ids=str)
def test_native_library_equals_its_numpy_version(case):
    """Bit for bit, with the library and with its numpy versions."""
    assert native.available()
    with_lib = NATIVE_CASES[case](np.random.default_rng(7))
    assert_same(numpy_only(lambda: NATIVE_CASES[case](np.random.default_rng(7))), with_lib)


def test_native_library_matches_the_jax_packages():
    rng = np.random.default_rng(11)
    raw = rng.integers(-32000, 32000, 4096, dtype=np.int16)
    assert_same(native.cf_unpack(raw, 0.0123, 4.5, int(raw[3])),
                jax_native.cf_unpack(raw, 0.0123, 4.5, int(raw[3])))
    data = (rng.standard_normal((64, 65)) * 3 + 9).astype(np.float32)
    data[5, :4] = np.nan
    assert native.nan_moments(data) == jax_native.nan_moments(data)
    assert_same(native.standardize_inplace(data.copy(), 9.1, 3.2),
                jax_native.standardize_inplace(data.copy(), 9.1, 3.2))
    assert_same(native.block_mean_coarsen(data[None, :64, :64], 8),
                jax_native.block_mean_coarsen(data[None, :64, :64], 8))


def test_netcdf_reader_and_writers_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    packed = rng.integers(-30000, 30000, (4, 5, 6)).astype(np.int16)
    attrs = {"u10": {"scale_factor": 0.001, "add_offset": 2.5, "_FillValue": np.int16(-30000),
                     "units": "m s-1"}}
    coords = {"time": np.arange(4.0), "lat": np.linspace(20, 21, 5), "lon": np.linspace(-90, -88, 6)}
    args = dict(variables={"u10": packed}, dims={"u10": ("time", "lat", "lon")}, coords=coords,
                attrs=attrs)
    jax_netcdf.write_netcdf(str(tmp_path / "jax.nc"), **args)
    netcdf.write_netcdf(str(tmp_path / "port.nc"), **args)
    with netcdf.NetCDFStreamWriter(
            str(tmp_path / "stream.nc"), {"u10": (4, 5, 6)}, {"u10": ("time", "lat", "lon")},
            coords=coords, attrs={"u10": {"units": "m s-1"}}) as w:
        for t in range(4):
            w.write("u10", t, packed[t] * 0.5)
    for name in ("jax.nc", "port.nc"):
        path = str(tmp_path / name)
        with netcdf.NetCDFFile(path) as f, jax_netcdf.NetCDFFile(path) as g:
            assert f.variable_names == g.variable_names == ["u10"]
            assert sorted(f.coordinate_names) == sorted(g.coordinate_names) == ["lat", "lon", "time"]
            a, b = f.variable("u10"), g.variable("u10")
            assert_same(a.data, b.data)
            assert a.dims == b.dims == ["time", "lat", "lon"] and a.attrs.keys() == b.attrs.keys()
            assert_same(f.variable("u10", (slice(1, 3),)).data, g.variable("u10", (slice(1, 3),)).data)
            assert_same(f.coord("lat"), g.coord("lat"))
    assert_same(netcdf.read_variable(str(tmp_path / "stream.nc"), "u10").data,
                jax_netcdf.read_variable(str(tmp_path / "stream.nc"), "u10").data)


# -- staging on raw NetCDFs ---------------------------------------------------

# 4 samples in 2000 (a masked year: test, minus the dropped first field) and
# 4 in 2001 (train); the florida box needs a 20x86 coarse grid, 8x that fine.
WRF_TIMES = np.array([20000101.0, 20000101.25, 20000101.5, 20000101.75,
                      20010101.0, 20010101.25, 20010101.5, 20010101.75])


def pack_int16(arr):
    """CF-pack a float field as ERA files are: int16 payload, scale and offset."""
    lo, hi = float(arr.min()), float(arr.max())
    scale = max(hi - lo, 1e-6) / 65500.0
    offset = (hi + lo) / 2.0
    return np.round((arr - offset) / scale).astype(np.int16), {"scale_factor": scale,
                                                                "add_offset": offset}


def write_raw(root, packed):
    """Raw fine U10/V10 files (WRF times, lat/lon) and the seven covariate
    files under their raw ERA names (lsm and z time-invariant), by the JAX
    package's ``write_netcdf``."""
    rng = np.random.default_rng(0)
    n_t = len(WRF_TIMES)

    def write(path, name, data, dims, coords):
        attrs = {}
        if packed:
            data, attrs = pack_int16(data)
        jax_netcdf.write_netcdf(str(path), variables={name: data}, dims={name: dims},
                                coords=coords, attrs={name: attrs})
        return str(path)

    fine_coords = {"Times": WRF_TIMES, "lat": 20.0 + 0.0125 * np.arange(160),
                   "lon": -139.0 + 0.0125 * np.arange(688)}
    fine_paths = {v: write(root / f"fine_{v}.nc", v.upper(),
                           (rng.standard_normal((n_t, 160, 688)) * 3 + 1).astype(np.float32),
                           ("Times", "lat", "lon"), fine_coords) for v in ("u10", "v10")}
    cov_paths = {}
    for std, raw_name in COVARIATE_NAMES_ORDERED.items():
        if std in ("land_sea_mask", "geopotential"):
            data, dims, coords = rng.standard_normal((20, 86)), ("lat", "lon"), None
        else:
            data, dims = rng.standard_normal((n_t, 20, 86)), ("time", "lat", "lon")
            coords = {"time": np.arange(n_t, dtype=np.float64)}
        cov_paths[std] = write(root / f"cov_{std}.nc", raw_name,
                               (data * 10 + 50).astype(np.float32), dims, coords)
    return fine_paths, cov_paths


@pytest.fixture(scope="module", params=["float32", "int16_packed"])
def raw(request, tmp_path_factory):
    """(port Config, JAX Config) of one raw set: florida, already_preprocessed
    False, a tiny model for the CLI drives."""
    root = tmp_path_factory.mktemp(f"raw_{request.param}")
    fine_paths, cov_paths = write_raw(root, request.param == "int16_packed")
    cfg = Config(region="florida", fine_paths=fine_paths, covariate_paths=cov_paths,
                 already_preprocessed=False, proc_data_dir=str(root / "proc"), filters=8,
                 num_res_blocks=1, hp=HyperParams(batch_size=2, epochs=1,
                                                  metrics_to_calculate=("MAE", "MSE", "Wass")))
    return cfg, JaxConfig.from_json(cfg.to_json())


def test_generate_train_test_matches_jax(raw):
    cfg, jcfg = raw
    arrays = staging.generate_train_test_coarse_fine(cfg)
    assert [a.shape for a in arrays] == [(4, 16, 16, 7), (4, 128, 128, 2), (3, 16, 16, 7),
                                         (3, 128, 128, 2)]
    assert_same(arrays, jax_staging.generate_train_test_coarse_fine(jcfg))
    assert_same(staging.load_fine_coords(cfg), jax_staging.load_fine_coords(jcfg))
    fine, t = staging.load_fine(cfg)
    assert_same((fine, t), jax_staging.load_fine(jcfg))
    assert_same(staging.load_covariates(cfg, len(t)), jax_staging.load_covariates(jcfg, len(t)))
    legacy = {"U": cfg.fine_paths["u10"], "V": cfg.fine_paths["v10"]}
    assert_same(staging.load_data(legacy, cfg.covariate_paths["u10"]),
                jax_staging.load_data(legacy, jcfg.covariate_paths["u10"]))


def test_preprocessed_files_round_trip_both_ways(raw, tmp_path):
    cfg, jcfg = raw
    arrays = staging.generate_train_test_coarse_fine(cfg)
    lats, lons = staging.load_fine_coords(cfg)
    for writer, reader in ((staging, jax_staging), (jax_staging, staging)):
        w_cfg = (cfg if writer is staging else jcfg).replace(proc_data_dir=str(tmp_path / writer.__name__))
        r_cfg = (jcfg if reader is jax_staging else cfg).replace(proc_data_dir=w_cfg.proc_data_dir)
        writer.write_preprocessed(w_cfg, *arrays, fine_lats=lats, fine_lons=lons)
        assert_same(reader.load_preprocessed(r_cfg), arrays)
        assert_same(reader.load_preprocessed_coords(r_cfg), (lats, lons))
    staged = staging.stage_datasets(cfg.replace(proc_data_dir=str(tmp_path / staging.__name__),
                                                already_preprocessed=True), "cpu")
    want = (DeviceDataset.from_numpy(*arrays[:2], "cpu"), DeviceDataset.from_numpy(*arrays[2:], "cpu"))
    for got, ds in zip(staged, want):
        assert torch.equal(got.coarse, ds.coarse) and torch.equal(got.fine, ds.fine)


@pytest.mark.parametrize("which", ["train", "validation"])
def test_prepare_covariates_matches_jax(raw, tmp_path, which):
    from click.testing import CliRunner

    from downgan_tpu.cli.__main__ import cli as jax_cli

    cfg, _ = raw
    outputs = {}
    for side in ("port", "jax"):
        path = tmp_path / f"{side}.json"
        path.write_text(cfg.replace(proc_data_dir=str(tmp_path / side)).to_json())
        if side == "port":
            written = main(["prepare-covariates", "--config", str(path), "--set", which])
        else:
            res = CliRunner().invoke(jax_cli, ["prepare-covariates", "--config", str(path),
                                               "--set", which])
            assert res.exit_code == 0, res.output
            written = res.output.split()
        outputs[side] = written
    assert [p.split("/")[-1] for p in outputs["port"]] == [p.split("/")[-1] for p in outputs["jax"]]
    port_stats, jax_stats = (json.load(open(o[0])) for o in (outputs["port"], outputs["jax"]))
    assert port_stats == jax_stats and "land_sea_mask" not in port_stats
    for p, j in zip(outputs["port"][1:], outputs["jax"][1:]):
        name = p.split("/")[-1].split("_" + which)[0][len("cov_"):]
        a, b = netcdf.read_variable(p, name), jax_netcdf.read_variable(j, name)
        assert_same(a.data, b.data)
        assert a.data.shape[0] == (4 if which == "train" else 3)


def test_cli_train_from_raw_and_from_prepared_files(raw, tmp_path):
    """``train`` stages the raw files; ``prepare-data`` writes what the JAX
    package's pipeline computes; ``train --host-feed`` and ``--stream`` run
    from those files."""
    cfg, jcfg = raw
    proc = tmp_path / "proc"
    raw_cfg = tmp_path / "raw.json"
    raw_cfg.write_text(cfg.replace(proc_data_dir=str(proc)).to_json())
    run = ["--device", "cpu", "--tracking-root", str(tmp_path / "exps")]
    trainer = main(["train", "--config", str(raw_cfg), *run])
    assert isinstance(trainer.train_ds, DeviceDataset) and len(trainer.train_ds) == 4
    assert trainer.history[0]["steps"] == 2 and "test" in trainer.history[0]
    paths = main(["prepare-data", "--config", str(raw_cfg)])
    assert len(paths) == 4 and all(p.endswith("_florida.nc") for p in paths)
    prepared = cfg.replace(proc_data_dir=str(proc), already_preprocessed=True)
    assert_same(staging.load_preprocessed(prepared), jax_staging.generate_train_test_coarse_fine(jcfg))
    prep_cfg = tmp_path / "prepared.json"
    prep_cfg.write_text(prepared.to_json())
    for flag, kind in (("--host-feed", HostDataset), ("--stream", StreamDataset)):
        trainer = main(["train", "--config", str(prep_cfg), flag, *run])
        assert type(trainer.train_ds) is kind and len(trainer.test_ds) == 3
        assert trainer.history[0]["steps"] == 2 and "test" in trainer.history[0]
