"""The port's tuned training options against the JAX package's: the fused
n-critic round (``hp.schedule = "fused"``, ``build_fused_round``) over two
rounds with ``metrics_reuse_fake`` on and off and the generator EMA;
``metrics_reuse_fake`` and ``fused_critic_pass`` on the reference schedule;
one bf16 fused round; the trainer's fused schedule (rounds per epoch, the
step counter, ``gen_loss``, an exact resume in fp32 and bf16); the ``train``
CLI on the tuned settings; and a bf16 bundle through ``export`` and
``serve``'s restore.

Same weights (numpy, through the JAX package's ``port_generator`` and
``port_critic``), same batches, and the JAX alphas ``uniform(fold_in(rng,
step))`` passed to the port.
"""
import copy
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from downgan_tpu.config.config import Config as JaxConfig  # noqa: E402
from downgan_tpu.config.config import HyperParams as JaxHyperParams  # noqa: E402
from downgan_tpu.training.state import GANTrainState as JaxState  # noqa: E402
from downgan_tpu.training.state import make_optimizer as jax_make_optimizer  # noqa: E402
from downgan_tpu.training.wgan import build_fused_round as jax_build_fused_round  # noqa: E402
from downgan_tpu.training.wgan import build_train_step as jax_build_train_step  # noqa: E402

from downgan_tpu_torch.cli.__main__ import _resolve_source, build_parser, main  # noqa: E402
from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.data.dataset import DeviceDataset, synthetic_dataset  # noqa: E402
from downgan_tpu_torch.inference import load_bundle  # noqa: E402
from downgan_tpu_torch.training.state import load_generator, make_train_state  # noqa: E402
from downgan_tpu_torch.training.trainer import Trainer  # noqa: E402
from downgan_tpu_torch.training.wgan import build_fused_round, build_train_step  # noqa: E402
from downgan_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402
from downgan_tpu_torch.utils.port_weights import (  # noqa: E402
    critic_state_dict_from_flax,
    generator_state_dict_from_flax,
)

from _torch_parity import flax_critic, flax_generator, one_thread  # noqa: E402,F401

B, N_CRITIC, ROUNDS = 2, 5, 2
KW = dict(filters=8, num_res_blocks=1, coarse_size=8, fine_size=64)
# 64x64 is too small for five MS-SSIM levels; the metric pass is the same
# code for every registry entry (tests/test_torch_train.py runs MS-SSIM).
METRICS = ("MAE", "MSE", "Wass")
DATA = dict(coarse_size=8, fine_size=64)
LR = 2.5e-4
# fp32, as tests/test_torch_train.py: per-round losses and metrics to 1e-6
# relative (sums in another order; critic_loss ~100 is GP-dominated); the
# parameters after each round as that test's after step 5, since a round
# already holds five critic updates: every element within 2 * lr (Adam's
# normalized step can turn an ulp-level difference of a near-zero gradient
# into O(lr); measured 9.5e-5 after the first round) and the median
# within 1e-6.
METRIC_RTOL, METRIC_ATOL = 1e-6, 5e-6
ADAM_ATOL, MEDIAN_ATOL = 2 * LR, 1e-6
# bf16, one round: both sides compute every conv, DRB and dense layer in
# bf16 and round at other places (tests/test_torch_bf16.py), and the GP's
# bf16 double backward is coarse (~8 % relative L2 off JAX's). Losses and
# metrics: 2e-2 relative or 1e-3 absolute (measured: Wass, a difference of
# two critic means of ~1e-3, 3e-5 apart; the rest within 6e-6 relative).
# Parameters: Adam's first steps are lr * sign(g), so an element whose
# gradient's sign differs moves the other way; every element within
# 2 * lr per update (five critic updates: measured 2.0e-3 of 2.5e-3; plus
# 2**-20 for the fp32 rounding of the parameters themselves), and
# the median within 1e-4 (measured: 2.2e-5 for the critic, 2.8e-7 for the
# generator).
BF16_RTOL, BF16_ATOL, BF16_MEDIAN_ATOL = 2e-2, 1e-3, 1e-4


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 1, 4, 2, 3)
                                                 if np.ndim(a) == 5 else
                                                 np.asarray(a).transpose(0, 3, 1, 2)))


def port_weights_of(jax_g_params, jax_c_params):
    host = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return (generator_state_dict_from_flax(host(jax_g_params), num_res_blocks=1, num_upsample=3),
            critic_state_dict_from_flax(host(jax_c_params), base=8, fine_size=64))


def both_states(hp):
    """The JAX and the port train state of ``hp`` from the same weights."""
    jcfg = JaxConfig(hp=JaxHyperParams(batch_size=B, metrics_to_calculate=METRICS, **hp), **KW)
    cfg = Config(hp=HyperParams(batch_size=B, metrics_to_calculate=METRICS, **hp), **KW)
    jgen, g_params = flax_generator(jcfg, cfg, seed=0)
    jcritic, c_params, _ = flax_critic(jcfg, seed=1)
    tx = jax_make_optimizer(jcfg)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), g_params=g_params, c_params=c_params,
                      g_opt_state=tx.init(g_params), c_opt_state=tx.init(c_params),
                      g_ema=jax.tree.map(jnp.copy, g_params) if jcfg.hp.ema_decay else None)
    state = make_train_state(cfg, "cpu")
    gen_sd, critic_sd = port_weights_of(g_params, c_params)
    state.generator.load_state_dict(gen_sd)
    state.critic.load_state_dict(critic_sd)
    if state.g_ema is not None:
        state.g_ema.load_state_dict(gen_sd)
    return jcfg, cfg, jgen, jcritic, jstate, state


def jax_alphas(rng, first_step, n):
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(rng, first_step + i),
                                                   (B, 1, 1, 1), jnp.float32))
                     for i in range(n)])


def snapshot(state, jstate):
    port = (copy.deepcopy(state.generator.state_dict()), copy.deepcopy(state.critic.state_dict()),
            None if state.g_ema is None else copy.deepcopy(state.g_ema.state_dict()))
    jax_side = port_weights_of(jstate.g_params, jstate.c_params)
    jax_ema = None if jstate.g_ema is None else port_weights_of(jstate.g_ema, jstate.c_params)[0]
    return port, (*jax_side, jax_ema)


def run_fused_rounds(hp, rounds=ROUNDS, seed=3):
    """``rounds`` fused rounds of both packages; per round the metrics and
    the (generator, critic, EMA) weights of both."""
    jcfg, cfg, jgen, jcritic, jstate, state = both_states(dict(schedule="fused", **hp))
    jround = jax.jit(jax_build_fused_round(jcfg, jgen, jcritic))
    fused_round = build_fused_round(cfg, state.generator, state.critic)
    coarse, fine = synthetic_dataset(n_samples=B * N_CRITIC * rounds, seed=seed, **DATA)
    coarse = coarse.reshape(rounds, N_CRITIC, B, *coarse.shape[1:])
    fine = fine.reshape(rounds, N_CRITIC, B, *fine.shape[1:])
    rng = jax.random.PRNGKey(7)
    out = {"jax": [], "port": [], "weights": []}
    for r in range(rounds):
        jstate, jm = jround(jstate, jnp.asarray(coarse[r]), jnp.asarray(fine[r]), rng)
        alphas = torch.from_numpy(jax_alphas(rng, r * N_CRITIC, N_CRITIC))
        pm = fused_round(state, nchw(coarse[r]), nchw(fine[r]), alphas)
        out["jax"].append({k: float(v) for k, v in jm.items()})
        out["port"].append({k: float(v) for k, v in pm.items()})
        out["weights"].append(snapshot(state, jstate))
        assert int(jstate.step) == state.step == (r + 1) * N_CRITIC
    out["forwards"] = dict(fused_round.forwards)
    return out


@pytest.fixture(scope="module", params=[dict(metrics_reuse_fake=True, ema_decay=0.5),
                                        dict(metrics_reuse_fake=False)],
                ids=["reuse_fake_ema", "fresh_fake"])
def fused_rounds(request):
    return request.param, run_fused_rounds(request.param)


def assert_weights_close(got, want, atol, median_atol=MEDIAN_ATOL):
    assert set(got) == set(want)
    diff = np.concatenate([(got[k] - want[k]).abs().numpy().ravel() for k in want])
    assert diff.max() <= atol and np.median(diff) <= median_atol, (diff.max(), np.median(diff))


@pytest.mark.parametrize("r", range(ROUNDS))
def test_fused_round_losses_and_metrics_match_jax(fused_rounds, r):
    _, out = fused_rounds
    jm, pm = out["jax"][r], out["port"][r]
    assert set(pm) == set(jm) == {"critic_loss", "gen_loss", "Wass", "MAE", "MSE"}
    for k in jm:
        assert pm[k] == pytest.approx(jm[k], rel=METRIC_RTOL, abs=METRIC_ATOL), k
    assert pm["gen_loss"] != 0.0  # every round updates the generator


@pytest.mark.parametrize("r", range(ROUNDS), ids=["after_round0", "after_round1"])
def test_fused_round_parameters_match_jax(fused_rounds, r):
    hp, out = fused_rounds
    port, jax_side = out["weights"][r]
    for net in (0, 1, 2):
        if net == 2 and not hp.get("ema_decay"):
            assert port[2] is None and jax_side[2] is None
            continue
        assert_weights_close(port[net], jax_side[net], ADAM_ATOL)
    if hp.get("ema_decay"):  # the EMA moved half way: it is not the live generator
        live = port[0]
        assert max((port[2][k] - live[k]).abs().max().item() for k in live) > 1e-4


def test_fused_round_counts_generator_forwards_by_kind(fused_rounds):
    hp, out = fused_rounds
    metric = 0 if hp["metrics_reuse_fake"] else ROUNDS
    assert out["forwards"] == {"critic_fake": N_CRITIC * ROUNDS, "update": ROUNDS,
                               "metric": metric}


def test_fused_round_scores_the_last_critic_fake_under_reuse():
    """Under metrics_reuse_fake the metric pass scores the last critic
    update's fake, made by the round's starting generator: its MAE is
    the starting generator's L1 on the last minibatch."""
    cfg = Config(hp=HyperParams(batch_size=B, schedule="fused", metrics_reuse_fake=True,
                                metrics_to_calculate=METRICS), **KW)
    state = make_train_state(cfg, "cpu")
    coarse, fine = synthetic_dataset(n_samples=B * N_CRITIC, seed=4, **DATA)
    coarse_n = nchw(coarse.reshape(N_CRITIC, B, *coarse.shape[1:]))
    fine_n = nchw(fine.reshape(N_CRITIC, B, *fine.shape[1:]))
    with torch.no_grad():
        want = (state.generator(coarse_n[-1]) - fine_n[-1]).abs().mean().item()
    m = build_fused_round(cfg, state.generator, state.critic)(state, coarse_n, fine_n)
    assert float(m["MAE"]) == pytest.approx(want, rel=1e-6)
    with pytest.raises(ValueError, match="critic_iterations=5"):
        build_fused_round(cfg, state.generator, state.critic)(state, coarse_n[:4], fine_n[:4])


def test_reference_step_reusing_the_fake_with_fused_critic_pass_matches_jax():
    """The reference schedule with metrics_reuse_fake (the metric pass
    scores the critic update's fake) and fused_critic_pass (each pair of
    critic forwards as one), six steps, against JAX ``build_train_step``."""
    hp = dict(metrics_reuse_fake=True, fused_critic_pass=True)
    jcfg, cfg, jgen, jcritic, jstate, state = both_states(hp)
    jstep = jax.jit(jax_build_train_step(jcfg, jgen, jcritic))
    step = build_train_step(cfg, state.generator, state.critic)
    coarse, fine = synthetic_dataset(n_samples=B * 6, seed=5, **DATA)
    rng = jax.random.PRNGKey(8)
    for i in range(6):
        rows = slice(B * i, B * (i + 1))
        jstate, jm = jstep(jstate, jnp.asarray(coarse[rows]), jnp.asarray(fine[rows]), rng)
        pm = step(state, nchw(coarse[rows]), nchw(fine[rows]),
                  torch.from_numpy(jax_alphas(rng, i, 1)[0]))
        for k in jm:
            assert float(pm[k]) == pytest.approx(float(jm[k]), rel=METRIC_RTOL,
                                                 abs=METRIC_ATOL), (i, k)
    assert step.forwards == {"critic_fake": 6, "update": 2, "metric": 0}
    port, jax_side = snapshot(state, jstate)
    for net in (0, 1):
        assert_weights_close(port[net], jax_side[net], ADAM_ATOL)


def test_fused_critic_pass_gives_the_same_step():
    """One forward over the concatenated real and fake batch is the same
    math as two (the JAX package's test_fused_critic_pass_matches_unfused):
    the step's metrics to fp32 rounding, the critic's parameters after its
    Adam step within 5e-4 (Adam can amplify a last-ulp difference of a
    near-zero gradient to O(lr))."""
    coarse, fine = synthetic_dataset(n_samples=B, seed=6, **DATA)
    outs = {}
    for fused in (False, True):
        cfg = Config(hp=HyperParams(batch_size=B, fused_critic_pass=fused,
                                    metrics_to_calculate=METRICS), **KW)
        state = make_train_state(cfg, "cpu")
        m = build_train_step(cfg, state.generator, state.critic)(state, nchw(coarse), nchw(fine))
        outs[fused] = ({k: float(v) for k, v in m.items()}, state.critic.state_dict())
    for k, v in outs[False][0].items():
        assert outs[True][0][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    for k, v in outs[False][1].items():
        torch.testing.assert_close(outs[True][1][k], v, rtol=0, atol=5e-4)


def test_bf16_fused_round_matches_jax_bf16():
    hp = dict(compute_dtype="bfloat16", metrics_reuse_fake=True)
    out = run_fused_rounds(hp, rounds=1, seed=9)
    jm, pm = out["jax"][0], out["port"][0]
    for k in jm:
        assert pm[k] == pytest.approx(jm[k], rel=BF16_RTOL, abs=BF16_ATOL), k
    port, jax_side = out["weights"][0]
    for net, updates in ((0, 1), (1, N_CRITIC)):
        assert_weights_close(port[net], jax_side[net], 2 * LR * updates + 2.0 ** -20,
                             BF16_MEDIAN_ATOL)


# ---------------------------------------------------------------------------
# Trainer and CLI


def tuned_config(**hp):
    return Config(hp=HyperParams(batch_size=B, schedule="fused", metrics_to_calculate=METRICS,
                                 **hp), **KW)


def data(n_train, n_test=3, seed=10):
    coarse, fine = synthetic_dataset(n_samples=n_train + n_test, seed=seed, **DATA)
    return (DeviceDataset.from_numpy(coarse[:n_train], fine[:n_train], "cpu"),
            DeviceDataset.from_numpy(coarse[n_train:], fine[n_train:], "cpu"))


def test_trainer_fused_schedule_rounds_steps_and_gen_loss():
    """13 training samples at batch 2 are 6 steps, one whole round of 5 (the
    sixth batch is cut); the step counter moves by 5 a round; gen_loss is
    the round's own (no rescale); the test pass runs."""
    train, test = data(13)
    trainer = Trainer(tuned_config(), train, test, device="cpu")
    seen = []
    step_fn = trainer.step_fn

    def recording(state, coarse_n, fine_n):
        assert coarse_n.shape == (N_CRITIC, B, 7, 8, 8)
        assert fine_n.shape == (N_CRITIC, B, 2, 64, 64)
        m = step_fn(state, coarse_n, fine_n)
        seen.append({k: float(v) for k, v in m.items()})
        return m

    trainer.step_fn = recording
    records = trainer.train(2)
    assert [r["steps"] for r in records] == [1, 1] and trainer.state.step == 2 * N_CRITIC
    for r, m in zip(records, seen):
        assert r["train"]["gen_loss"] == pytest.approx(m["gen_loss"], rel=1e-6)
        assert set(r["test"]) == set(METRICS)
    assert trainer.forwards == {"critic_fake": 10, "update": 2, "metric": 2, "test": 4}


def test_trainer_fused_schedule_needs_a_whole_round():
    train, test = data(9)  # 4 steps < critic_iterations
    trainer = Trainer(tuned_config(), train, test, device="cpu")
    with pytest.raises(ValueError, match="critic_iterations=5"):
        trainer.train(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_schedule_resume_is_exact(tmp_path, dtype):
    """3 epochs straight against 2 + a resume + 1, bit for bit on the CPU:
    rounds start at multiples of critic_iterations and the alphas are a
    function of (seed, step)."""
    cfg = tuned_config(compute_dtype=dtype, metrics_reuse_fake=True, ema_decay=0.5)
    train, test = data(10, seed=11)
    straight = Trainer(cfg, train, test, device="cpu", print_every=100)
    straight.train(3)
    first = Trainer(cfg, train, test, device="cpu", print_every=100,
                    checkpoint_manager=CheckpointManager(str(tmp_path / "ck")))
    first.train(2)
    resumed = Trainer(cfg, train, test, device="cpu", print_every=100,
                      checkpoint_manager=CheckpointManager(str(tmp_path / "ck")))
    assert resumed.maybe_resume() and resumed.state.step == 2 * N_CRITIC
    resumed.train(3)
    assert resumed.history[-1] == {**straight.history[-1],
                                   "seconds": resumed.history[-1]["seconds"]}
    a, b = straight.state.state_dict(), resumed.state.state_dict()
    for part in ("generator", "critic", "g_ema"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    assert a["step"] == b["step"] == 3 * N_CRITIC


def test_cli_train_tuned_settings_and_bf16_bundle_round_trip(tmp_path, capsys):
    """``train`` with the tuned hp fields of examples/production_tuned.json
    (bf16 compute, fused rounds, the metric pass on the reused fake) on a
    tiny model, then its best bundle through ``export``'s and ``serve``'s
    restore: a bf16 generator again, equal to the trained EMA-free live
    weights' forward."""
    with open("examples/production_tuned.json") as f:
        tuned = Config.from_json(f.read())
    assert (tuned.hp.compute_dtype, tuned.hp.schedule, tuned.hp.metrics_reuse_fake) == (
        "bfloat16", "fused", True)
    cfg = tuned.replace(hp=dataclasses.replace(tuned.hp, batch_size=B, metrics_to_calculate=METRICS),
                        **KW)
    path = tmp_path / "tiny_tuned.json"
    path.write_text(cfg.to_json())
    trainer = main(["train", "--config", str(path), "--synthetic", "--samples", "12",
                    "--epochs", "1", "--device", "cpu", "--tracking-root", str(tmp_path / "exps"),
                    "--track-best", "MAE"])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["steps"] == 1 and trainer.state.step == N_CRITIC  # 10 samples: 5 batches
    assert trainer.forwards == {"critic_fake": 5, "update": 1, "metric": 0, "test": 1}
    assert trainer.state.generator.compute_dtype == torch.bfloat16

    best = os.path.join(trainer.run.artifact_dir, "best")
    bundle_cfg, weights, _ = load_bundle(best)
    assert bundle_cfg.hp.compute_dtype == "bfloat16"
    parser = build_parser()
    for argv in (["serve", "--checkpoint", best],
                 ["export", "--checkpoint", os.path.join(trainer.run.artifact_dir, "checkpoints"),
                  "--out", str(tmp_path / "bundle")]):
        config, restored = _resolve_source(parser.parse_args(argv), parser)
        assert config.hp.compute_dtype == "bfloat16"
        gen = load_generator(config, restored, "cpu")
        assert gen.compute_dtype == torch.bfloat16
        x = torch.randn(2, 7, 8, 8, generator=torch.Generator().manual_seed(0))
        with torch.inference_mode():
            torch.testing.assert_close(gen(x), trainer.state.generator(x), rtol=0, atol=0)
    out = main(["export", "--checkpoint", os.path.join(trainer.run.artifact_dir, "checkpoints"),
                "--out", str(tmp_path / "bundle")])
    assert load_bundle(out)[0].hp.compute_dtype == "bfloat16"


def test_cli_train_dtype_and_schedule_flags_override_the_config(tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text(Config(hp=HyperParams(batch_size=B, metrics_to_calculate=METRICS),
                           **KW).to_json())
    trainer = main(["train", "--config", str(path), "--synthetic", "--samples", "12",
                    "--epochs", "0", "--device", "cpu", "--tracking-root", str(tmp_path / "exps"),
                    "--compute-dtype", "bfloat16", "--schedule", "fused"])
    assert (trainer.config.hp.compute_dtype, trainer.config.hp.schedule) == ("bfloat16", "fused")
    assert trainer.state.generator.compute_dtype == trainer.state.critic.compute_dtype == torch.bfloat16
    assert trainer.step_fn.__name__ == "fused_round" and trainer.history == []
