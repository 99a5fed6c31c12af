"""The port's training slice against the JAX package's: six train steps on
the same weights, batches and alphas (losses, metrics, the generator-update
schedule, parameters and the EMA generator after steps 0 and 5); the synthetic set and the batch
order, bit for bit; the Trainer's epoch loop, ``gen_loss`` rescale and test
pass; the ``train`` CLI; and the accepted XLA-program flags."""
import copy
import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from downgan_tpu.config.config import Config as JaxConfig  # noqa: E402
from downgan_tpu.config.config import HyperParams as JaxHyperParams  # noqa: E402
from downgan_tpu.data import dataset as jax_dataset  # noqa: E402
from downgan_tpu.training.state import GANTrainState as JaxState  # noqa: E402
from downgan_tpu.training.state import make_models  # noqa: E402
from downgan_tpu.training.state import make_optimizer as jax_make_optimizer  # noqa: E402
from downgan_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from downgan_tpu.training.trainer import full_split_metric_pass as jax_full_split  # noqa: E402
from downgan_tpu.training.wgan import build_eval_metrics as jax_build_eval  # noqa: E402
from downgan_tpu.training.wgan import build_train_step as jax_build_train_step  # noqa: E402
from downgan_tpu.training.wgan import g_updates_in_window as jax_g_updates  # noqa: E402
from downgan_tpu.utils.port_weights import port_critic, port_generator  # noqa: E402

from downgan_tpu_torch.cli.__main__ import main  # noqa: E402
from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.data.dataset import (  # noqa: E402
    DeviceDataset,
    epoch_permutation,
    synthetic_dataset,
)
from downgan_tpu_torch.training.state import make_train_state  # noqa: E402
from downgan_tpu_torch.training.trainer import Trainer, full_split_metric_pass  # noqa: E402
from downgan_tpu_torch.training.wgan import (  # noqa: E402
    build_eval_metrics,
    build_train_step,
    g_updates_in_window,
)
from downgan_tpu_torch.utils.port_weights import (  # noqa: E402
    critic_state_dict_from_flax,
    generator_state_dict_from_flax,
)

from _torch_parity import flax_critic, flax_generator, one_thread  # noqa: E402,F401

B = 2
KW = dict(filters=8, num_res_blocks=1, coarse_size=16, fine_size=128)
N_STEPS = 6  # steps 0 and 5 update the generator
# Per-step losses and metrics: fp32 on both sides with sums in another
# order (1e-6 relative; critic_loss ~100 is GP-dominated), MS-SSIM a
# product of five scale means.
METRIC_RTOL, METRIC_ATOL = 1e-6, 5e-6
# After step 0 both sides took one Adam step, lr * g / (|g| + 1e-8): the
# same gradients to fp32 rounding give the same update to far below lr.
STEP0_ATOL = 1e-5
# Adam's normalized update (m / sqrt(v) is +-1 for a nonzero gradient of
# stable sign) turns an ulp-level difference in a near-zero gradient into a
# sign flip, and one flipped update moves an element by up to 2 * lr; over
# k updates up to 2 * lr * k. Torch's CPU reductions change order with the
# thread count, and the port alone then moves that far: 7.31e-4 in the
# critic after six steps at 1 thread against 4, where the same run at 1
# thread is 8.2e-7 from JAX. So the bound holds for a fixed thread count
# (the module runs at one, `one_thread`): every element within 2 * lr, and
# the bulk (the median) within 1e-6.
ADAM_ATOL = 2 * 2.5e-4
# The EMA generator on both sides: 0.5 moves it half way to the live
# weights at each generator update, so after step 5 it differs from both
# the initial and the live weights.
EMA_DECAY = 0.5


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def port_weights_of(jax_g_params, jax_c_params):
    host = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return (generator_state_dict_from_flax(host(jax_g_params), num_res_blocks=1, num_upsample=3),
            critic_state_dict_from_flax(host(jax_c_params), base=8, fine_size=128))


@pytest.fixture(scope="module")
def six_steps():
    """Six steps of both packages from the same weights, on the same
    batches, the JAX alphas passed to the port, the generator EMA on. One
    compile of the JAX step for the module."""
    jcfg = JaxConfig(hp=JaxHyperParams(batch_size=B, ema_decay=EMA_DECAY), **KW)
    cfg = Config(hp=HyperParams(batch_size=B, ema_decay=EMA_DECAY), **KW)
    jgen, g_params = flax_generator(jcfg, cfg, seed=0)
    jcritic, c_params, _ = flax_critic(jcfg, seed=1)
    tx = jax_make_optimizer(jcfg)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), g_params=g_params, c_params=c_params,
                      g_opt_state=tx.init(g_params), c_opt_state=tx.init(c_params),
                      g_ema=jax.tree.map(jnp.copy, g_params))
    jstep = jax.jit(jax_build_train_step(jcfg, jgen, jcritic))
    coarse, fine = synthetic_dataset(n_samples=B * N_STEPS, seed=3)
    rng = jax.random.PRNGKey(7)

    state = make_train_state(cfg, "cpu")
    gen_sd, critic_sd = port_weights_of(g_params, c_params)
    state.generator.load_state_dict(gen_sd)
    state.g_ema.load_state_dict(gen_sd)
    state.critic.load_state_dict(critic_sd)
    step = build_train_step(cfg, state.generator, state.critic)

    out = {"jax": [], "port": [], "jax_params": [], "port_params": [], "jax_ema": [],
           "port_ema": []}
    for i in range(N_STEPS):
        rows = slice(B * i, B * (i + 1))
        jstate, jm = jstep(jstate, jnp.asarray(coarse[rows]), jnp.asarray(fine[rows]), rng)
        alpha = np.array(jax.random.uniform(jax.random.fold_in(rng, i), (B, 1, 1, 1), jnp.float32))
        pm = step(state, nchw(coarse[rows]), nchw(fine[rows]), torch.from_numpy(alpha))
        out["jax"].append({k: float(v) for k, v in jm.items()})
        out["port"].append({k: float(v) for k, v in pm.items()})
        out["jax_params"].append(port_weights_of(jstate.g_params, jstate.c_params))
        out["port_params"].append((copy.deepcopy(state.generator.state_dict()),
                                   copy.deepcopy(state.critic.state_dict())))
        out["jax_ema"].append(port_weights_of(jstate.g_ema, jstate.c_params)[0])
        out["port_ema"].append(copy.deepcopy(state.g_ema.state_dict()))
    out["state"], out["forwards"] = state, dict(step.forwards)
    return out


@pytest.mark.parametrize("i", range(N_STEPS))
def test_step_losses_and_metrics_match_jax(six_steps, i):
    jm, pm = six_steps["jax"][i], six_steps["port"][i]
    assert set(pm) == set(jm) == {"critic_loss", "gen_loss", "Wass", "MAE", "MSE", "MSSSIM"}
    for k in jm:
        assert pm[k] == pytest.approx(jm[k], rel=METRIC_RTOL, abs=METRIC_ATOL), k


def test_generator_schedule_matches_jax(six_steps):
    """G updates at steps 0 and 5 (step % 5 == 0, step 0 included); the
    skipped steps report gen_loss exactly 0 on both sides."""
    for i in range(N_STEPS):
        updated = i % 5 == 0
        assert (six_steps["jax"][i]["gen_loss"] != 0.0) == updated
        assert (six_steps["port"][i]["gen_loss"] != 0.0) == updated
    assert six_steps["forwards"] == {"critic_fake": 6, "update": 2, "metric": 6}
    assert six_steps["state"].step == N_STEPS
    # the step-0 critic loss is GP-dominated: 100 * (|grad| - 1)^2 with |grad| ~ 0
    assert 95 < six_steps["port"][0]["critic_loss"] < 100.5


@pytest.mark.parametrize("net", [0, 1], ids=["generator", "critic"])
@pytest.mark.parametrize("i", [0, 5], ids=["after_step0", "after_step5"])
def test_parameters_match_jax(six_steps, net, i):
    ref, got = six_steps["jax_params"][i][net], six_steps["port_params"][i][net]
    assert set(ref) == set(got)
    diff = np.concatenate([(got[k] - ref[k]).abs().numpy().ravel() for k in ref])
    moved = np.concatenate([(got[k] - six_steps["port_params"][0][net][k]).abs().numpy().ravel()
                            for k in ref]) if i else None
    if i == 0:
        assert diff.max() <= STEP0_ATOL
    else:
        assert diff.max() <= ADAM_ATOL and np.median(diff) <= 1e-6
        assert np.median(moved) > 100 * 1e-6  # the bulk check has teeth: the weights moved


@pytest.mark.parametrize("i", [0, 5], ids=["after_step0", "after_step5"])
def test_ema_generator_matches_jax(six_steps, i):
    """The port's ``g_ema`` against the JAX ``g_ema`` (``e = d*e + (1-d)*p``
    after each generator update), at the bound the parameters use."""
    ref, got = six_steps["jax_ema"][i], six_steps["port_ema"][i]
    live = six_steps["port_params"][i][0]
    assert set(ref) == set(got)
    diff = np.concatenate([(got[k] - ref[k]).abs().numpy().ravel() for k in ref])
    assert diff.max() <= (STEP0_ATOL if i == 0 else ADAM_ATOL) and np.median(diff) <= 1e-6
    # it is neither the live weights nor (after step 5) the step-0 EMA
    assert max((got[k] - live[k]).abs().max().item() for k in ref) > 100 * 1e-6
    if i:
        assert max((got[k] - six_steps["port_ema"][0][k]).abs().max().item() for k in ref) > 1e-4


@pytest.mark.parametrize("kw", [dict(n_samples=6), dict(n_samples=5, coarse_size=8, fine_size=64,
                                                         n_covariates=2, seed=4),
                                dict(n_samples=3, covariate_noise=0.3, seed=9)],
                         ids=["florida_shape", "no_extra_covariates", "covariate_noise"])
def test_synthetic_dataset_is_bit_identical(kw):
    for ours, theirs in zip(synthetic_dataset(**kw), jax_dataset.synthetic_dataset(**kw)):
        assert ours.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("n,bs,shuffle", [(23, 4, True), (16, 4, True), (9, 2, False)])
def test_epoch_permutation_is_bit_identical(n, bs, shuffle):
    ours = epoch_permutation(n, np.random.default_rng((0, 3)), bs, shuffle)
    theirs = jax_dataset.epoch_permutation(n, np.random.default_rng((0, 3)), bs, shuffle)
    assert ours.dtype == theirs.dtype == np.int32
    np.testing.assert_array_equal(ours, theirs)


def test_device_dataset_holds_nchw_and_gathers_rows():
    coarse, fine = synthetic_dataset(n_samples=5, seed=2)
    ds = DeviceDataset.from_numpy(coarse, fine, "cpu")
    assert ds.coarse.shape == (5, 7, 16, 16) and ds.fine.shape == (5, 2, 128, 128)
    c, f = ds.gather(torch.tensor([4, 0, 2]))
    np.testing.assert_array_equal(c.numpy(), coarse[[4, 0, 2]].transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(f.numpy(), fine[[4, 0, 2]].transpose(0, 3, 1, 2))


@pytest.mark.parametrize("start,n", [(0, 6), (6, 6), (3, 1), (5, 1), (0, 0), (7, 9)])
def test_g_updates_in_window_matches_jax(start, n):
    assert g_updates_in_window(start, n, 5) == jax_g_updates(start, n, 5)


@pytest.fixture(scope="module")
def trained():
    """Two epochs of the port's Trainer on CPU (12 training samples, batch
    2: 6 steps an epoch), recording every batch and step metric, and a test
    set of 5 samples (two batches and a ragged tail of one)."""
    cfg = Config(hp=HyperParams(batch_size=B), **KW)
    coarse, fine = synthetic_dataset(n_samples=17, seed=5)
    train = DeviceDataset.from_numpy(coarse[:12], fine[:12], "cpu")
    test = DeviceDataset.from_numpy(coarse[12:], fine[12:], "cpu")
    trainer = Trainer(cfg, train, test, device="cpu")
    seen = []
    step_fn = trainer.step_fn

    def recording(state, c, f, alpha=None):
        metrics = step_fn(state, c, f, alpha)
        seen.append((f.clone(), {k: float(v) for k, v in metrics.items()}))
        return metrics

    trainer.step_fn = recording
    records = trainer.train(2)
    return cfg, coarse, fine, trainer, seen, records


def test_trainer_batch_order_is_the_jax_trainers(trained):
    cfg, _, fine, trainer, seen, _ = trained
    jcfg = JaxConfig(hp=JaxHyperParams(batch_size=B), **KW)
    fine_nchw = fine.transpose(0, 3, 1, 2)
    for epoch in range(2):
        # the JAX Trainer's own rule: epoch_permutation of default_rng((seed, epoch))
        rng = JaxTrainer._epoch_rng(types.SimpleNamespace(config=jcfg, epoch=epoch))
        perm = jax_dataset.epoch_permutation(12, rng, B)
        for s, idx in enumerate(perm):
            np.testing.assert_array_equal(seen[6 * epoch + s][0].numpy(), fine_nchw[idx])
    assert trainer.state.step == 12 and trainer.epoch == 2


def test_trainer_epoch_means_and_gen_loss_rescale(trained):
    _, _, _, trainer, seen, records = trained
    assert [r["epoch"] for r in records] == [0, 1] and [r["steps"] for r in records] == [6, 6]
    for epoch, record in enumerate(records):
        steps = [m for _, m in seen[6 * epoch:6 * epoch + 6]]
        n_upd = jax_g_updates(6 * epoch, 6, 5)  # 2 (steps 0, 5), then 1 (step 10)
        assert n_upd == (2, 1)[epoch]
        assert record["train"]["gen_loss"] == pytest.approx(
            sum(m["gen_loss"] for m in steps) / n_upd, rel=1e-6)
        for k in ("critic_loss", "Wass", "MAE", "MSE", "MSSSIM"):
            assert record["train"][k] == pytest.approx(np.mean([m[k] for m in steps]), rel=1e-6)
        assert all(np.isfinite(v) for v in record["train"].values())
    assert trainer.forwards == {"critic_fake": 12, "update": 3, "metric": 12, "test": 6}


def test_test_pass_matches_jax_full_split_metric_pass(trained):
    """Same weights and test data through both packages' full-split pass:
    two batches of 2 and a ragged tail of 1, each batch weighted equally.
    No randomness on either side."""
    cfg, coarse, fine, trainer, _, records = trained
    jcfg = JaxConfig(hp=JaxHyperParams(batch_size=B), **KW)
    jgen, jcritic = make_models(jcfg)
    g_np = {k: v.detach().numpy() for k, v in trainer.state.generator.state_dict().items()}
    c_np = {k: v.detach().numpy() for k, v in trainer.state.critic.state_dict().items()}
    jstate = JaxState(step=jnp.zeros((), jnp.int32),
                      g_params=port_generator(g_np, num_res_blocks=1, num_upsample=3),
                      c_params=port_critic(c_np, base=8, fine_size=128),
                      g_opt_state=None, c_opt_state=None)
    test = jax_dataset.DeviceDataset.from_numpy(coarse[12:], fine[12:])
    want = jax_full_split(jstate, test, B, np.random.default_rng(0),
                          jax.jit(jax_build_eval(jcfg, jgen, jcritic)))
    got = trainer.run_test_pass()
    assert got == records[-1]["test"]
    assert set(got) == set(want) == {"MAE", "MSE", "MSSSIM", "Wass"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL, abs=METRIC_ATOL), k


def test_full_split_metric_pass_weights_batches_equally():
    coarse, fine = synthetic_dataset(n_samples=5, seed=6)
    ds = DeviceDataset.from_numpy(coarse, fine, "cpu")
    sizes = []

    def eval_batch(c, f):
        sizes.append(len(f))
        return {"n": torch.tensor(float(len(f))), "first": f[0, 0, 0, 0]}

    means = full_split_metric_pass(ds, 2, eval_batch)
    assert sizes == [2, 2, 1]
    assert means["n"] == pytest.approx(5 / 3)
    assert means["first"] == pytest.approx(float(fine[[0, 2, 4], 0, 0, 0].mean()), rel=1e-6)


def tiny_config_file(tmp_path, **hp):
    cfg = Config(hp=HyperParams(batch_size=B, **hp), **KW)
    path = tmp_path / "tiny.json"
    path.write_text(cfg.to_json())
    return str(path)


def test_cli_train_runs_on_cpu(tmp_path, capsys):
    trainer = main(["train", "--config", tiny_config_file(tmp_path), "--synthetic",
                    "--samples", "14", "--epochs", "2", "--device", "cpu", "--seed", "3",
                    "--tracking-root", str(tmp_path / "exps")])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["epoch"] for ln in lines] == [0, 1]
    assert [ln["steps"] for ln in lines] == [6, 6]  # int(0.9 * 14) = 12 training samples
    for ln in lines:
        assert set(ln["test"]) == {"MAE", "MSE", "MSSSIM", "Wass"}  # 2 test samples
        assert all(np.isfinite(v) for part in ("train", "test") for v in ln[part].values())
    assert trainer.config.seed == 3 and len(trainer.train_ds) == 12 and len(trainer.test_ds) == 2
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def test_cli_train_refuses_without_synthetic_and_without_a_card(tmp_path, capsys, monkeypatch):
    with pytest.raises(SystemExit) as exc:
        main(["train", "--config", tiny_config_file(tmp_path), "--device", "cpu"])
    assert exc.value.code == 2
    assert "run `prepare-data`" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["train", "--config", tiny_config_file(tmp_path), "--synthetic", "--samples", "14",
              "--epochs", "1", "--tracking-root", str(tmp_path / "exps")])


def test_xla_program_flags_are_accepted():
    """fused_epoch and remat shape only the JAX package's XLA program;
    florida sets fused_epoch, so refusing it would refuse florida."""
    with open("examples/florida.json") as f:
        florida = Config.from_json(f.read())
    assert florida.hp.fused_epoch
    cfg = Config(hp=dataclasses.replace(florida.hp, batch_size=B, remat=True), **KW)
    state = make_train_state(cfg, "cpu")
    build_train_step(cfg, state.generator, state.critic)
    assert build_eval_metrics(cfg) is not None
