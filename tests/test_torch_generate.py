"""Batch inference of the port against the JAX package: the chunk iterator,
the NetCDF layout and writers (in memory and streamed: plain, tiled,
ensemble), ``rebuild_coarse_covariates``, and the ``generate`` and
``evaluate`` commands held to the JAX commands, with their usage errors.
Weights come from numpy on both sides (``_torch_parity``), the JAX
package's ensemble latents are passed in, and NetCDF files are read back
with h5py."""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from click.testing import CliRunner  # noqa: E402

from downgan_tpu import inference as jax_inference  # noqa: E402
from downgan_tpu.cli.__main__ import cli as jax_cli  # noqa: E402
from downgan_tpu.config.config import Config as JaxConfig  # noqa: E402
from downgan_tpu.training.wgan import eval_noise_rng  # noqa: E402
from downgan_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from downgan_tpu_torch import inference  # noqa: E402
from downgan_tpu_torch.cli.__main__ import main  # noqa: E402
from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.data.staging import load_fine_coords  # noqa: E402
from downgan_tpu_torch.parallel.spatial import tiled_sr_inference  # noqa: E402
from downgan_tpu_torch.training import wgan  # noqa: E402
from downgan_tpu_torch.training.state import make_generator  # noqa: E402
from downgan_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402
from downgan_tpu_torch.utils.port_weights import generator_state_dict_from_flax  # noqa: E402

from _torch_parity import flax_generator, one_thread, paired_states  # noqa: E402,F401
from test_torch_data import write_raw  # noqa: E402

# The two packages' fp32 generator forwards (tests/test_torch_generator.py):
# the same products, summed in another order.
ATOL, RTOL = 2e-5, 1e-5
# Metric means of the two packages' passes (tests/test_torch_train.py), here
# rounded to 6 decimals on both sides.
METRIC_RTOL, METRIC_ATOL = 1e-6, 5e-6
KW = dict(filters=8, num_res_blocks=1, coarse_size=16, fine_size=128, chunk_size=4)
STEP = 3  # the checkpoints' step, which evaluate reports


def host(tree):
    return jax.tree.map(np.asarray, tree)


def coarse_of(n, seed, h=16, w=16):
    return np.random.default_rng(seed).standard_normal((n, h, w, 7)).astype(np.float32)


def read_all(path):
    """Every dataset of a NetCDF: values, dims, chunking and dtype."""
    with h5py.File(path, "r") as f:
        return {k: (np.asarray(f[k][...]), tuple(d.label for d in f[k].dims), f[k].chunks,
                    f[k].dtype) for k in f}


def assert_same_file(a, b):
    ra, rb = read_all(a), read_all(b)
    assert ra.keys() == rb.keys()
    for k in ra:
        np.testing.assert_array_equal(ra[k][0], rb[k][0], err_msg=k)
        assert ra[k][1:] == rb[k][1:], k


def assert_close_files(port, jax_file):
    """Structure equal (variables, dims, coordinates, chunking, dtype);
    coordinates equal, fields within ATOL/RTOL."""
    rp, rj = read_all(port), read_all(jax_file)
    assert rp.keys() == rj.keys()
    for k in rp:
        assert rp[k][1:] == rj[k][1:], k
        assert rp[k][0].shape == rj[k][0].shape, k
        if k in ("u10", "v10"):
            np.testing.assert_allclose(rp[k][0], rj[k][0], atol=ATOL, rtol=RTOL, err_msg=k)
        else:
            np.testing.assert_array_equal(rp[k][0], rj[k][0], err_msg=k)


def jax_member_latent(jcfg):
    """The JAX package's member latents, ``normal(fold_in(fold_in(
    eval_noise_rng, member), chunk))``, as the port's ``latent=``."""
    def latent(member, chunk, shape):
        key = jax.random.fold_in(jax.random.fold_in(eval_noise_rng(jcfg), member), chunk)
        return np.asarray(jax.random.normal(key, shape, jnp.float32))
    return latent


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """A deterministic model on the raw NetCDF set of the data tests
    (florida, 16 -> 128) and a stochastic one (2 latent channels), each as
    numpy-made weights for both packages, a bundle of each package, a
    config file and full trainer checkpoints of each package at step 3."""
    root = tmp_path_factory.mktemp("generate")
    fine_paths, cov_paths = write_raw(root, packed=False)
    out = {}
    for name, noise in (("deterministic", 0), ("stochastic", 2)):
        cfg = Config(region="florida", fine_paths=fine_paths, covariate_paths=cov_paths,
                     already_preprocessed=False, proc_data_dir=str(root / "proc"),
                     noise_channels=noise, hp=HyperParams(batch_size=4), **KW)
        jcfg = JaxConfig.from_json(cfg.to_json())
        _, g_params = flax_generator(jcfg, cfg, seed=11 + noise)
        g_sd = generator_state_dict_from_flax(host(g_params), num_res_blocks=1, num_upsample=3)
        config_path = root / f"{name}.json"
        config_path.write_text(cfg.to_json())
        d = root / name
        jax_inference.write_generator_bundle(str(d / "jax_bundle"), jcfg, g_params)
        inference.write_generator_bundle(str(d / "port_bundle"), cfg, g_sd)
        out[name] = dict(cfg=cfg, jcfg=jcfg, g_params=g_params, g_sd=g_sd, dir=d,
                         config=str(config_path))
    # Full trainer checkpoints of the deterministic model, critic included.
    m = out["deterministic"]
    _, _, jstate, state = paired_states(m["jcfg"], m["cfg"])
    manager = JaxCheckpointManager(str(m["dir"] / "jax_ckpt"))
    manager.save(STEP, jstate.replace(step=jnp.asarray(STEP, jnp.int32)))
    manager.wait()
    manager.close()
    state.step = STEP
    CheckpointManager(str(m["dir"] / "port_ckpt")).save(STEP, state)
    m["g_sd"] = {k: v.clone() for k, v in state.generator.state_dict().items()}
    return out


@pytest.mark.parametrize("chunk", [3, 4])
@pytest.mark.parametrize("noise", [0, 2])
def test_generate_fields_iter_is_generate_fields(chunk, noise):
    cfg = Config(noise_channels=noise, **{**KW, "coarse_size": 8, "fine_size": 32})
    weights = make_generator(cfg, "cpu").state_dict()
    coarse = coarse_of(10, 1, 8, 8)  # ragged tails: 10 = 3 x 3 + 1 = 2 x 4 + 2
    blocks = list(inference.generate_fields_iter(cfg, weights, coarse, chunk_size=chunk,
                                                 device="cpu"))
    assert [s for s, _ in blocks] == list(range(0, 10, chunk))
    assert [b.shape[0] for _, b in blocks] == [min(chunk, 10 - s) for s, _ in blocks]
    whole = inference.generate_fields(cfg, weights, coarse, chunk_size=chunk, device="cpu")
    np.testing.assert_array_equal(np.concatenate([b for _, b in blocks]), whole)


@pytest.mark.parametrize("mode", ["plain", "tiled", "tiled_stochastic", "ensemble"])
def test_streamed_netcdf_is_the_in_memory_one(models, tmp_path, mode):
    """``generate_to_netcdf`` writes the file the in-memory path writes, bit
    for bit. Tiled, each chunk is tiled alone: deterministic, that is one
    whole-series tiler call; stochastic, one call on the series with every
    sample's own latent (``sample_latent`` of its index) appended."""
    m = models["stochastic" if mode in ("tiled_stochastic", "ensemble") else "deterministic"]
    cfg, weights = m["cfg"], m["g_sd"]
    kw = dict(times=np.arange(6) * 6.0, lats=np.linspace(20, 30, 128),
              lons=np.linspace(-85, -75, 128)) if mode == "plain" else {}
    tiling = dict(tile_rows=4, overlap=2)
    if mode == "plain":
        coarse = coarse_of(6, 2)
        fields = inference.generate_fields(cfg, weights, coarse, device="cpu")
    elif mode == "ensemble":
        coarse = coarse_of(5, 3)
        fields = inference.generate_ensemble(cfg, weights, coarse, 3, device="cpu")
        kw = dict(n_members=3)
    else:
        coarse = coarse_of(3, 4, h=12)
        with_z = coarse
        if cfg.noise_channels:
            z = np.stack([inference.sample_latent(cfg, j, (12, 16, 2)) for j in range(3)])
            with_z = np.concatenate([coarse, z], axis=-1)
        fields = tiled_sr_inference(cfg, weights, with_z, device="cpu", **tiling)
        kw = dict(chunk_size=2, **tiling)
    mem, stream = str(tmp_path / "mem.nc"), str(tmp_path / "stream.nc")
    inference.write_generated_netcdf(mem, fields, **{k: v for k, v in kw.items()
                                                     if k in ("times", "lats", "lons")})
    inference.generate_to_netcdf(stream, cfg, weights, coarse, device="cpu", **kw)
    assert_same_file(mem, stream)
    assert read_all(stream)["u10"][0].shape == fields.shape[:-1]


@pytest.mark.parametrize("case", [
    dict(n=6, times=None, lats=None, lons=None, n_members=0),
    dict(n=3, times=np.arange(3) * 21600.0, lats=np.linspace(20, 30, 64),
         lons=np.linspace(-85, -75, 32), n_members=0),
    dict(n=7, times=None, lats=None, lons=None, n_members=4),
])
def test_generated_layout_is_the_jax_one(case):
    args = (case["n"], 64, 32, 2, ("u10", "v10", "extra"), case["times"], case["lats"],
            case["lons"], 5)
    got = inference._generated_layout(*args, n_members=case["n_members"])
    want = jax_inference._generated_layout(*args, n_members=case["n_members"])
    assert got[0] == want[0]
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        assert got[1][k].dtype == want[1][k].dtype
        np.testing.assert_array_equal(got[1][k], want[1][k])
    assert got[2:] == want[2:]
    with pytest.raises(ValueError, match="must be named"):
        inference._generated_layout(3, 8, 8, 2, ("u10",), None, None, None, 5)


@pytest.mark.parametrize("subset", ["train", "test"])
def test_rebuild_coarse_covariates_is_the_jax_one(models, subset):
    m = models["deterministic"]
    coarse, times = inference.rebuild_coarse_covariates(m["cfg"], subset)
    jcoarse, jtimes = jax_inference.rebuild_coarse_covariates(m["jcfg"], subset)
    assert coarse.dtype == jcoarse.dtype == np.float32
    assert coarse.shape == jcoarse.shape == ((4 if subset == "train" else 3), 16, 16, 7)
    np.testing.assert_array_equal(coarse, jcoarse)
    np.testing.assert_array_equal(times, jtimes)
    with pytest.raises(ValueError, match="subset"):
        inference.rebuild_coarse_covariates(m["cfg"], "validation")


def jax_invoke(args):
    res = CliRunner().invoke(jax_cli, args)
    assert res.exit_code == 0, res.output
    return res.output


GENERATE_CASES = {
    # the raw covariates of the test years, their times and the fine crop's
    # coordinates, in memory
    "raw": ("deterministic", ["--raw-covariates"]),
    # a stochastic generator's whole-domain latent, streamed
    "tiled": ("stochastic", ["--synthetic", "--samples", "3", "--tile-rows", "4", "--overlap",
                             "2", "--tiles-per-dispatch", "3", "--streamed"]),
    "ensemble": ("stochastic", ["--synthetic", "--samples", "5", "--ensemble", "2"]),
}


@pytest.mark.parametrize("case", list(GENERATE_CASES))
def test_generate_command_matches_jax(models, tmp_path, monkeypatch, case):
    which, flags = GENERATE_CASES[case]
    m = models[which]
    if case == "ensemble":
        monkeypatch.setattr(inference, "member_latent",
                            lambda config, member, chunk, shape:
                            jax_member_latent(m["jcfg"])(member, chunk, shape))
    port, jax_file = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    main(["generate", "--checkpoint", str(m["dir"] / "port_bundle"), "--out", port,
          "--device", "cpu", *flags])
    jax_invoke(["generate", "--checkpoint", str(m["dir"] / "jax_bundle"), "--out", jax_file,
                *flags])
    assert_close_files(port, jax_file)
    got = read_all(port)
    if case == "raw":  # the test years' times in epoch seconds, the fine crop's coordinates
        times = inference.rebuild_coarse_covariates(m["cfg"], "test")[1]
        np.testing.assert_array_equal(got["time"][0], np.asarray(times).astype(
            "datetime64[s]").astype("float64"))
        lats, lons = load_fine_coords(m["cfg"])
        np.testing.assert_array_equal(got["lat"][0], lats)
        np.testing.assert_array_equal(got["lon"][0], lons)
    if case == "ensemble":
        assert got["u10"][1] == ("member", "time", "lat", "lon")


@pytest.mark.parametrize("case", ["checkpoint", "weights_only", "ensemble"])
def test_evaluate_command_matches_jax(models, tmp_path, monkeypatch, capsys, case):
    """The JSON line of ``evaluate`` over 6 synthetic samples (a batch of 4
    and a tail of 2): a full trainer checkpoint (every metric, Wass from
    its critic), a bundle (Wass dropped, with the JAX warning) and a
    2-member ensemble of the stochastic model (the JAX package's latents:
    its fixed realization for the metric pass, its member draws)."""
    m = models["stochastic" if case == "ensemble" else "deterministic"]
    source = {"checkpoint": "ckpt", "weights_only": "bundle", "ensemble": "bundle"}[case]
    flags = ["--config", m["config"], "--synthetic", "--samples", "6"]
    if case == "ensemble":
        flags += ["--ensemble", "2"]
        monkeypatch.setattr(inference, "member_latent",
                            lambda config, member, chunk, shape:
                            jax_member_latent(m["jcfg"])(member, chunk, shape))
        monkeypatch.setattr(wgan, "fixed_latent", lambda config, shape: np.array(
            jax.random.normal(eval_noise_rng(m["jcfg"]), shape, jnp.float32)))
    out = tmp_path / "port.json"
    got = main(["evaluate", "--checkpoint", str(m["dir"] / f"port_{source}"), "--device", "cpu",
                "--out", str(out), *flags])
    err = capsys.readouterr().err
    want = json.loads(jax_invoke(["evaluate", "--checkpoint", str(m["dir"] / f"jax_{source}"),
                                  *flags]).strip().splitlines()[-1])
    assert json.loads(out.read_text()) == got
    assert got.keys() == want.keys()
    assert ("Wass" in got) == (case == "checkpoint")
    assert ("dropping the Wass metric" in err) == (case != "checkpoint")
    assert (got["split"], got["n_samples"], got["step"]) == ("synthetic", 6,
                                                             STEP if case == "checkpoint" else 0)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=METRIC_RTOL, abs=METRIC_ATOL), k
        else:
            assert got[k] == v, k


def usage_error(capsys, argv, match):
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code == 2
    assert match in capsys.readouterr().err


def test_usage_errors(models, tmp_path, monkeypatch, capsys):
    det, sto = models["deterministic"], models["stochastic"]
    bundle, ckpt = str(det["dir"] / "port_bundle"), str(det["dir"] / "port_ckpt")
    out = str(tmp_path / "x.nc")
    gen = ["generate", "--synthetic", "--samples", "2", "--device", "cpu", "--out", out]
    usage_error(capsys, gen, "exactly one of --checkpoint or --run")
    usage_error(capsys, gen + ["--checkpoint", bundle, "--run", "r"],
                "exactly one of --checkpoint or --run")
    usage_error(capsys, gen + ["--checkpoint", str(sto["dir"] / "port_bundle"), "--ensemble", "2",
                               "--tile-rows", "4"], "mutually exclusive")
    usage_error(capsys, gen + ["--checkpoint", bundle, "--ensemble", "2"],
                "needs a stochastic generator")
    usage_error(capsys, gen + ["--checkpoint", bundle, "--ema"], "--ema needs the full")
    usage_error(capsys, gen + ["--checkpoint", str(det["dir"] / "port_bundle" / "generator.pt"),
                               "--weights-only", "--ema"], "--ema needs the full")
    usage_error(capsys, gen + ["--checkpoint", bundle, "--epoch", "1"],
                "an epoch/step cannot be selected")
    with monkeypatch.context() as patched:  # h5py not installed
        patched.setitem(sys.modules, "h5py", None)
        usage_error(capsys, gen + ["--checkpoint", bundle], "h5py")
    ev = ["evaluate", "--synthetic", "--samples", "2", "--device", "cpu"]
    usage_error(capsys, ev + ["--checkpoint", ckpt, "--ensemble", "2"],
                "needs a stochastic generator")
    usage_error(capsys, ev + ["--checkpoint", bundle, "--ema"], "--ema needs the full")
    usage_error(capsys, ev + ["--checkpoint", ckpt, "--ema"], "--ema requires an EMA-trained run")
    usage_error(capsys, ev + ["--checkpoint", ckpt, "--epoch", "7"], "not among the retained")


def test_refusals_leave_an_existing_file_alone(models, tmp_path):
    """The streamed writer's checks come before h5py's ``"w"`` truncates."""
    det, sto = models["deterministic"], models["stochastic"]
    path = str(tmp_path / "existing.nc")
    coarse = coarse_of(2, 5)
    inference.generate_to_netcdf(path, det["cfg"], det["g_sd"], coarse, device="cpu")
    before = read_all(path)
    with pytest.raises(ValueError, match="stochastic"):
        inference.generate_to_netcdf(path, det["cfg"], det["g_sd"], coarse, n_members=2,
                                     device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        inference.generate_to_netcdf(path, sto["cfg"], sto["g_sd"], coarse, n_members=2,
                                     tile_rows=4, device="cpu")
    after = read_all(path)
    for k in before:
        np.testing.assert_array_equal(before[k][0], after[k][0], err_msg=k)
