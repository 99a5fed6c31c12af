"""Gradient accumulation and LR schedules against the JAX package: six
reference-schedule steps under ``grad_accum=2`` with a cosine schedule and
warmup (both networks' rates read at each update's count, lr 0 at a
network's first update); one fused round with flips, the conditional critic
and ``grad_accum=2``; and the accumulated gradient against the one-piece
gradient of the same batch. Same weights, batches, alphas and flip masks
on both sides; one compile of each JAX program."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from downgan_tpu.config.config import Config as JaxConfig  # noqa: E402
from downgan_tpu.config.config import HyperParams as JaxHyperParams  # noqa: E402
from downgan_tpu.training.wgan import build_fused_round as jax_build_fused_round  # noqa: E402
from downgan_tpu.training.wgan import build_train_step as jax_build_train_step  # noqa: E402

from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.data.dataset import synthetic_dataset  # noqa: E402
from downgan_tpu_torch.training.state import lr_schedule_fn, make_train_state  # noqa: E402
from downgan_tpu_torch.training.wgan import (  # noqa: E402
    build_fused_round,
    build_train_step,
    critic_loss,
    generator_loss,
)

from _torch_parity import jax_alpha, jax_flips, one_thread, paired_states, port_weights_of  # noqa: E402,F401

KW = dict(filters=8, num_res_blocks=1, coarse_size=8, fine_size=64)
DATA = dict(coarse_size=8, fine_size=64)
METRICS = ("MAE", "MSE", "Wass")
LR = 2.5e-4
# tests/test_torch_train.py's step tolerances (fp32, sums in another
# order): losses and metrics 1e-6 relative or 5e-6 absolute; parameters
# after step 0 within 1e-5; after five critic updates every element
# within 2 * lr and the median within 1e-6.
METRIC_RTOL, METRIC_ATOL = 1e-6, 5e-6
STEP0_ATOL, ADAM_ATOL, MEDIAN_ATOL = 1e-5, 2 * LR, 1e-6
ACCUM_B, N_STEPS = 4, 6
ACCUM_HP = dict(batch_size=ACCUM_B, grad_accum=2, lr_schedule="cosine", lr_warmup_steps=2,
                lr_decay_steps=6, lr_final_factor=0.1, metrics_to_calculate=METRICS)


def nchw(a):
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 1, 4, 2, 3) if a.ndim == 5 else a.transpose(0, 3, 1, 2)))


def max_and_median(ref, got):
    diff = np.concatenate([(got[k] - ref[k]).abs().numpy().ravel() for k in ref])
    return diff.max(), np.median(diff)


@pytest.fixture(scope="module")
def accum_steps():
    jcfg = JaxConfig(hp=JaxHyperParams(**ACCUM_HP), **KW)
    cfg = Config(hp=HyperParams(**ACCUM_HP), **KW)
    coarse, fine = synthetic_dataset(n_samples=ACCUM_B * N_STEPS, seed=4, **DATA)
    jgen, jcritic, jstate, state = paired_states(jcfg, cfg)
    initial = (copy.deepcopy(state.generator.state_dict()), copy.deepcopy(state.critic.state_dict()))
    jstep = jax.jit(jax_build_train_step(jcfg, jgen, jcritic))
    step = build_train_step(cfg, state.generator, state.critic)
    rng = jax.random.PRNGKey(8)
    out = {"jax": [], "port": [], "params": [], "lr": []}
    for i in range(N_STEPS):
        rows = slice(ACCUM_B * i, ACCUM_B * (i + 1))
        jstate, jm = jstep(jstate, jnp.asarray(coarse[rows]), jnp.asarray(fine[rows]), rng)
        pm = step(state, nchw(coarse[rows]), nchw(fine[rows]),
                  torch.from_numpy(jax_alpha(rng, i, ACCUM_B)))
        out["jax"].append({k: float(v) for k, v in jm.items()})
        out["port"].append({k: float(v) for k, v in pm.items()})
        out["params"].append((port_weights_of(cfg, jstate.g_params, jstate.c_params),
                              (copy.deepcopy(state.generator.state_dict()),
                               copy.deepcopy(state.critic.state_dict()))))
        out["lr"].append((state.g_opt.param_groups[0]["lr"], state.c_opt.param_groups[0]["lr"]))
    out["initial"], out["cfg"], out["forwards"] = initial, cfg, dict(step.forwards)
    return out


@pytest.mark.parametrize("i", range(N_STEPS))
def test_accum_step_losses_and_metrics_match_jax(accum_steps, i):
    jm, pm = accum_steps["jax"][i], accum_steps["port"][i]
    assert set(pm) == set(jm) == {"critic_loss", "gen_loss", *METRICS}
    for k in jm:
        assert pm[k] == pytest.approx(jm[k], rel=METRIC_RTOL, abs=METRIC_ATOL), k


def test_accum_schedule_counts_each_networks_updates(accum_steps):
    """The critic updates every step (counts 0-5), the generator at steps 0
    and 5 (counts 0 and 1); each update ran at its count's rate, lr 0 at
    count 0, so step 0 left both networks where they started."""
    sched = lr_schedule_fn(accum_steps["cfg"].hp)
    assert [c for _, c in accum_steps["lr"]] == [sched(i) for i in range(N_STEPS)]
    assert [g for g, _ in accum_steps["lr"]] == [0.0] * 5 + [sched(1)]
    for net in (0, 1):
        after0 = accum_steps["params"][0][1][net]
        assert all(torch.equal(after0[k], v) for k, v in accum_steps["initial"][net].items())
    # two microbatch forwards for each of the two generator updates
    assert accum_steps["forwards"] == {"critic_fake": 6, "update": 4, "metric": 6}


@pytest.mark.parametrize("net", [0, 1], ids=["generator", "critic"])
@pytest.mark.parametrize("i", [0, 5], ids=["after_step0", "after_step5"])
def test_accum_parameters_match_jax(accum_steps, net, i):
    ref, got = (sd[net] for sd in accum_steps["params"][i])
    worst, median = max_and_median(ref, got)
    if i == 0:
        assert worst <= STEP0_ATOL
    else:
        assert worst <= ADAM_ATOL and median <= MEDIAN_ATOL
        # the bulk check has teeth: the weights moved (the generator by one
        # update at half the rate: its count-0 update ran at lr 0)
        _, moved = max_and_median(accum_steps["initial"][net], got)
        assert moved > 20 * MEDIAN_ATOL


FUSED_B, N_CRITIC = 2, 5
FUSED_HP = dict(batch_size=FUSED_B, schedule="fused", grad_accum=2, augment_flips=True,
                metrics_to_calculate=METRICS)


@pytest.fixture(scope="module")
def fused_round_pair():
    kw = dict(KW, critic_conditional=True)
    jcfg = JaxConfig(hp=JaxHyperParams(**FUSED_HP), **kw)
    cfg = Config(hp=HyperParams(**FUSED_HP), **kw)
    coarse, fine = synthetic_dataset(n_samples=FUSED_B * N_CRITIC, seed=5, **DATA)
    coarse = coarse.reshape(N_CRITIC, FUSED_B, *coarse.shape[1:])
    fine = fine.reshape(N_CRITIC, FUSED_B, *fine.shape[1:])
    jgen, jcritic, jstate, state = paired_states(jcfg, cfg)
    jstate, jm = jax.jit(jax_build_fused_round(jcfg, jgen, jcritic))(
        jstate, jnp.asarray(coarse), jnp.asarray(fine), jax.random.PRNGKey(9))
    rng = jax.random.PRNGKey(9)
    alphas = torch.from_numpy(np.stack([jax_alpha(rng, i, FUSED_B) for i in range(N_CRITIC)]))
    # one decision per sample over the round's (n B) stack, at its first step
    flips = jax_flips(rng, 0, N_CRITIC * FUSED_B)
    fused_round = build_fused_round(cfg, state.generator, state.critic)
    pm = fused_round(state, nchw(coarse), nchw(fine), alphas, flips=flips)
    return ({k: float(v) for k, v in jm.items()}, {k: float(v) for k, v in pm.items()},
            port_weights_of(cfg, jstate.g_params, jstate.c_params),
            (state.generator.state_dict(), state.critic.state_dict()), flips,
            dict(fused_round.forwards))


def test_fused_round_with_variants_matches_jax(fused_round_pair):
    jm, pm, _, _, flips, forwards = fused_round_pair
    assert set(pm) == set(jm) == {"critic_loss", "gen_loss", *METRICS}
    for k in jm:
        assert pm[k] == pytest.approx(jm[k], rel=METRIC_RTOL, abs=METRIC_ATOL), k
    assert all(0 < int(f.sum()) < f.numel() for f in flips)
    assert forwards == {"critic_fake": 5, "update": 2, "metric": 1}


@pytest.mark.parametrize("net", [0, 1], ids=["generator", "critic"])
def test_fused_round_with_variants_parameters_match_jax(fused_round_pair, net):
    ref, got = fused_round_pair[2][net], fused_round_pair[3][net]
    worst, median = max_and_median(ref, got)
    assert worst <= (STEP0_ATOL if net == 0 else ADAM_ATOL) and median <= MEDIAN_ATOL


@pytest.mark.parametrize("net", ["critic", "generator"])
def test_accumulated_gradient_is_the_one_piece_gradient(net):
    """Every core loss term is a per-sample mean, so the mean of the two
    microbatches' gradients is the whole batch's up to fp32 summation
    order: 1e-5 of the largest entry. (The physics terms' batch-wide std
    is per microbatch under accumulation, as in the JAX package.)"""
    hp = dict(batch_size=4, metrics_to_calculate=METRICS)
    grads = {}
    for k in (1, 2):
        cfg = Config(hp=HyperParams(grad_accum=k, **hp), **KW)
        state = make_train_state(cfg, "cpu")
        coarse, fine = synthetic_dataset(n_samples=4, seed=6, **DATA)
        coarse, fine = nchw(coarse), nchw(fine)
        if net == "critic":
            with torch.no_grad():
                fake = state.generator(coarse)
            alpha = torch.rand(4, 1, 1, 1, generator=torch.Generator().manual_seed(0))
            losses = [critic_loss(cfg, state.critic, f, r, a)[0]
                      for f, r, a in zip(fake.chunk(k), fine.chunk(k), alpha.chunk(k))]
            params = list(state.critic.parameters())
        else:
            losses = [generator_loss(cfg, state.generator, state.critic, c, f)
                      for c, f in zip(coarse.chunk(k), fine.chunk(k))]
            params = list(state.generator.parameters())
        for loss in losses:
            (loss / k).backward(inputs=params)
        grads[k] = torch.cat([p.grad.reshape(-1) for p in params])
    scale = grads[1].abs().max()
    assert ((grads[2] - grads[1]).abs().max() / scale).item() <= 1e-5
