"""The port's data-parallel step (``parallel/``) on two gloo ranks of the CPU:
the ranks agree bit for bit and match the one-process step on the global
batch, on the reference schedule, the fused round, grad_accum with flips
and latents, and the physics terms and metrics, whose statistics span the
global batch; one reference step matches the JAX package's
``build_dp_train_step`` on a 2-device CPU mesh; a broadcast state leaves the
DRB packed-weight cache fresh. Then the single-process helpers and the
``train`` CLI's refusals. The ranks are spawned once for the module
(``tests/_torch_dp_worker.py``) and every case is its own test.

On the card: ``python -m pytest tests/test_torch_dp.py -m cuda --noconftest``
runs two gloo ranks sharing the one card (JAX is imported only where the
JAX package is compared, so the card, which has none, collects this file).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("torch.multiprocessing")

from downgan_tpu_torch.cli.__main__ import main  # noqa: E402
from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.parallel import multihost  # noqa: E402
from downgan_tpu_torch.parallel.mesh import batch_rows, rows_of  # noqa: E402

import _torch_dp_worker as worker  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401

B, WORLD = 8, 2
# The port's own step tolerances (tests/test_torch_train.py): losses and
# metrics are fp32 means summed in another order (here: two rank means
# averaged against one mean over both ranks' rows); Adam's normalized step
# can turn a rounding difference in a near-zero gradient into up to 2 * lr
# in one element per update, so the worst element may be 2 * lr per update
# the network took and the bulk (the median element) within 1e-6.
METRIC_RTOL, METRIC_ATOL = 1e-6, 5e-6
ADAM_ATOL, MEDIAN_ATOL = 2 * 2.5e-4, 1e-6
# On the card cuDNN picks its algorithms by batch size, so a rank's B=4
# convolutions and one process's B=8 sum in other orders than on the CPU:
# the median element is held to chip_smoke.py's card-vs-CPU
# ADAM_MEDIAN_ATOL (measured on the H100: 2.0e-6 after six steps).
CARD_MEDIAN_ATOL = 1e-5


def tiny_config(**hp) -> Config:
    """``tests/test_parallel.py::tiny_config``: filters 8, one RRDB, 8 -> 32."""
    hp.setdefault("metrics_to_calculate", ("MAE", "MSE", "Wass"))
    return Config(coarse_size=8, fine_size=32, filters=8, num_res_blocks=1,
                  hp=HyperParams(batch_size=B, **hp))


def batches(shape_lead, cfg, seed):
    """Global NCHW (coarse, fine) batches of leading shape ``shape_lead``."""
    rng = np.random.default_rng(seed)
    coarse = rng.standard_normal((*shape_lead, cfg.n_covariates, cfg.coarse_size, cfg.coarse_size))
    fine = rng.standard_normal((*shape_lead, cfg.n_predictands, cfg.fine_size, cfg.fine_size))
    return torch.from_numpy(coarse.astype(np.float32)), torch.from_numpy(fine.astype(np.float32))


def step_cases():
    """The cases each rank runs, and the one-process run holds: six
    reference steps (generator updates at 0 and 5), two fused rounds of 2
    critic updates, six steps with grad_accum 2, flips and 4 latent
    channels, and six steps whose loss and metrics take statistics of the
    whole batch (the divergence and vorticity terms' std, RALSD's mean
    spectrum)."""
    cases = {}
    for name, cfg, lead, seed in (
            ("reference", tiny_config(), (6, B), 0),
            ("fused", tiny_config(schedule="fused", critic_iterations=2), (2, 2, B), 1),
            ("accum", tiny_config(grad_accum=2, augment_flips=True).replace(noise_channels=4),
             (6, B), 2),
            ("physics", tiny_config(divergence_lambda=1.0, vorticity_lambda=1.0,
                                    metrics_to_calculate=("MAE", "Divergence", "Vorticity",
                                                          "RALSD", "Wass")), (6, B), 4)):
        coarse, fine = batches(lead, cfg, seed)
        cases[name] = {"config": cfg.to_json(), "coarse": coarse, "fine": fine}
    return cases


def jax_case():
    """One reference step of the JAX package's ``build_dp_train_step`` on a
    2-device CPU mesh from the weights the port's case starts from; its
    alphas (the JAX step's own draw over the global batch) are given to the
    port. Returns (the port's case, JAX's metrics and weights in the port's
    layout)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from downgan_tpu.config.config import Config as JaxConfig
    from downgan_tpu.config.config import HyperParams as JaxHyperParams
    from downgan_tpu.parallel.dp import build_dp_train_step as jax_build_dp_train_step
    from downgan_tpu.parallel.mesh import make_mesh, replicate_state, shard_batch

    from _torch_parity import jax_alpha, paired_states, port_weights_of

    jcfg = JaxConfig(coarse_size=8, fine_size=32, filters=8, num_res_blocks=1,
                     hp=JaxHyperParams(batch_size=B, metrics_to_calculate=("MAE", "MSE", "Wass")))
    cfg = tiny_config()
    jgen, jcritic, jstate, state = paired_states(jcfg, cfg)
    coarse, fine = batches((1, B), cfg, 3)
    mesh = make_mesh(devices=jax.devices()[:WORLD])
    step = jax_build_dp_train_step(jcfg, jgen, jcritic, mesh, donate_state=False)
    rng = jax.random.PRNGKey(3)
    nhwc = [np.ascontiguousarray(t[0].numpy().transpose(0, 2, 3, 1)) for t in (coarse, fine)]
    jstate, jm = step(replicate_state(mesh, jstate), *shard_batch(mesh, *map(jnp.asarray, nhwc)),
                      rng)
    case = {"config": cfg.to_json(), "coarse": coarse, "fine": fine,
            "alphas": torch.from_numpy(jax_alpha(rng, 0, B))[None],
            "init": {"generator": state.generator.state_dict(),
                     "critic": state.critic.state_dict()}}
    want = {"metrics": {k: float(v) for k, v in jm.items()},
            "weights": port_weights_of(cfg, jstate.g_params, jstate.c_params)}
    return case, want


def spawn(fn, tmp, *args):
    """Run ``fn(rank, WORLD, store, tmp, *args)`` in WORLD spawned processes;
    returns each rank's results."""
    worker.spawn(fn, (WORLD, str(tmp / "store"), str(tmp), *args), WORLD)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(WORLD)]


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Every case on two gloo ranks, and in one process on the global batch."""
    tmp = tmp_path_factory.mktemp("dp")
    cases = step_cases()
    cases["jax"], jax_want = jax_case()
    torch.save(cases, tmp / "cases.pt")
    ranks = spawn(worker.step_cases, tmp, "cpu")
    one = {name: worker.run_case(case, "cpu") for name, case in cases.items()}
    return {"cases": cases, "ranks": ranks, "one": one, "jax": jax_want}


def updates(cfg_json: str, steps: int):
    """(generator, critic) optimizer updates over ``steps`` steps or rounds."""
    hp = Config.from_json(cfg_json).hp
    if hp.schedule == "fused":
        return steps, steps * hp.critic_iterations
    return sum(1 for s in range(steps) if s % hp.critic_iterations == 0), steps


def assert_weights_close(got: dict, want: dict, n_updates: int, what: str,
                         median_atol: float = MEDIAN_ATOL):
    for k, w in want.items():
        diff = (got[k].double() - w.double()).abs()
        assert diff.max() <= ADAM_ATOL * n_updates, (what, k, diff.max().item())
        assert diff.median() <= median_atol, (what, k, diff.median().item())


CASES = ("reference", "fused", "accum", "physics")


@pytest.mark.parametrize("name", CASES + ("jax",))
def test_ranks_agree_bit_for_bit(dp_runs, name):
    r0, r1 = (r[name] for r in dp_runs["ranks"])
    for m0, m1 in zip(r0["metrics"], r1["metrics"]):
        assert m0.keys() == m1.keys() and all(torch.equal(m0[k], m1[k]) for k in m0), name
    for part in ("generator", "critic"):
        for k, v in r0["state"][part].items():
            assert torch.equal(v, r1["state"][part][k]), (name, part, k)
    assert r0["state"]["step"] == r1["state"]["step"]


@pytest.mark.parametrize("name", CASES)
def test_two_ranks_match_one_process_on_the_global_batch(dp_runs, name):
    got, want = dp_runs["ranks"][0][name], dp_runs["one"][name]
    assert len(got["metrics"]) == len(want["metrics"])
    for mg, mw in zip(got["metrics"], want["metrics"]):
        assert mg.keys() == mw.keys()
        for k in mw:
            np.testing.assert_allclose(mg[k].item(), mw[k].item(), rtol=METRIC_RTOL,
                                       atol=METRIC_ATOL, err_msg=f"{name} {k}")
    g_upd, c_upd = updates(dp_runs["cases"][name]["config"], len(want["metrics"]))
    assert_weights_close(got["state"]["generator"], want["state"]["generator"], g_upd, name)
    assert_weights_close(got["state"]["critic"], want["state"]["critic"], c_upd, name)
    assert got["state"]["step"] == want["state"]["step"]


def test_one_reference_step_matches_the_jax_dp_step(dp_runs):
    got, want = dp_runs["ranks"][0]["jax"], dp_runs["jax"]
    (metrics,) = got["metrics"]
    assert set(metrics) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=k)
    gen_sd, critic_sd = want["weights"]
    assert_weights_close(got["state"]["generator"], gen_sd, 1, "generator")
    assert_weights_close(got["state"]["critic"], critic_sd, 1, "critic")


def test_broadcast_state_refreshes_the_drb_pack_cache(dp_runs):
    r0, r1 = (r["drb_cache"] for r in dp_runs["ranks"])
    assert not torch.equal(r0["before"], r1["before"])  # rank 1 started from other weights
    assert torch.equal(r0["after"], r1["after"])
    assert torch.equal(r0["after"], r0["before"])  # rank 0's own state is unchanged
    assert r1["packs_fresh"] and all(r1["packs_fresh"])


# -- single-process helpers ---------------------------------------------------
def test_process_batch_slice_and_batch_rows():
    multihost.initialize(num_processes=1)  # a lone process: no-op
    multihost.initialize()  # no torchrun environment: no-op
    assert multihost.process_batch_slice(64) == (0, 64)
    assert multihost.process_batch_slice(64, process_index=0, process_count=1) == (0, 64)
    assert multihost.process_batch_slice(64, process_index=3, process_count=4) == (48, 64)
    with pytest.raises(ValueError, match="not divisible"):
        multihost.process_batch_slice(10, process_index=0, process_count=4)
    with pytest.raises(ValueError, match="not a rank"):
        rows_of(8, 2, 2)
    x = torch.arange(2 * 8).reshape(2, 8)
    assert torch.equal(batch_rows(x, 1, 2, axis=1), x[:, 4:])
    assert torch.equal(batch_rows(x, 0, 1, axis=-1), x)


def test_make_global_batch_places_this_ranks_rows_nchw():
    rows = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)  # (B, H, W, C)
    t = multihost.make_global_batch(rows, "cpu")
    assert t.shape == (2, 5, 3, 4) and torch.equal(t, torch.from_numpy(rows).permute(0, 3, 1, 2))
    stack = multihost.make_global_batch(rows[None], "cpu", batch_axis=1)  # (n, B, C, H, W)
    assert stack.shape == (1, 2, 5, 3, 4)


def test_initialize_reraises_on_explicit_args_and_tolerates_a_repeat(monkeypatch):
    def refused(*args, **kwargs):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(torch.distributed, "init_process_group", refused)
    with pytest.raises(RuntimeError, match="connection refused"):
        multihost.initialize("127.0.0.1:9", num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="together"):
        multihost.initialize(num_processes=2)
    monkeypatch.setenv("WORLD_SIZE", "2")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        multihost.initialize()  # a half-set torchrun environment is no lone process
    monkeypatch.setattr(multihost, "in_group", lambda: True)
    multihost.initialize("127.0.0.1:9", num_processes=2, process_id=0)  # a repeat: tolerated


# -- the train CLI's refusals ------------------------------------------------------
def config_file(tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text(tiny_config().to_json())
    return str(path)


def test_cli_multihost_needs_a_checkpoint_dir(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        main(["train", "--config", config_file(tmp_path), "--synthetic", "--device", "cpu",
              "--multihost"])
    assert e.value.code == 2 and "--checkpoint-dir" in capsys.readouterr().err


def test_cli_multihost_refuses_a_lone_process(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as e:
        main(["train", "--config", config_file(tmp_path), "--synthetic", "--device", "cpu",
              "--multihost", "--checkpoint-dir", str(tmp_path / "ckpt")])
    assert e.value.code == 2 and "no process group formed" in capsys.readouterr().err


def test_cli_mesh_refuses_one_card_of_several(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as e:
        main(["train", "--config", config_file(tmp_path), "--synthetic"])
    err = capsys.readouterr().err
    assert e.value.code == 2 and "torch.distributed.run --nproc-per-node 2" in err
    assert "--no-mesh" in err


def test_cli_refuses_a_rank_without_multihost(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as e:
        main(["train", "--config", config_file(tmp_path), "--synthetic", "--device", "cpu"])
    assert e.value.code == 2 and "pass --multihost" in capsys.readouterr().err


# -- on the card -------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: two gloo ranks share it")
    return "cuda:0"


@pytest.mark.cuda
def test_cuda_two_gloo_ranks_share_the_card(cuda_device, tmp_path):
    """Two gloo ranks on the one card (NCCL refuses two ranks on one
    device): ``all_reduce_gradients`` over CUDA tensors, the ranks bit for
    bit, the one-rank run within the step tolerances, the DRB cache fresh
    after the broadcast."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = {"reference": step_cases()["reference"]}
    torch.save(cases, tmp_path / "cases.pt")
    ranks = spawn(worker.step_cases, tmp_path, cuda_device)
    one = worker.run_case(cases["reference"], cuda_device)
    r0, r1 = (r["reference"] for r in ranks)
    for part in ("generator", "critic"):
        for k, v in r0["state"][part].items():
            assert torch.equal(v, r1["state"][part][k]), (part, k)
    g_upd, c_upd = updates(cases["reference"]["config"], len(one["metrics"]))
    assert_weights_close(r0["state"]["generator"], one["state"]["generator"], g_upd, "generator",
                         CARD_MEDIAN_ATOL)
    assert_weights_close(r0["state"]["critic"], one["state"]["critic"], c_upd, "critic",
                         CARD_MEDIAN_ATOL)
    c0, c1 = (r["drb_cache"] for r in ranks)
    assert torch.equal(c0["after"], c1["after"]) and all(c1["packs_fresh"])
