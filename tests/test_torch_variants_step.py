"""The port's reference-schedule train step with the training variants on
together, against the JAX package's: frequency separation, the conditional
critic, the physics-aware flips and the divergence, vorticity and EOF terms
at weight 1, over six steps from the same weights, batches, alphas and
flip masks (the JAX draws, reproduced from the same ``fold_in`` streams
and passed in). One compile of the JAX step for the module."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from downgan_tpu.config.config import Config as JaxConfig  # noqa: E402
from downgan_tpu.config.config import HyperParams as JaxHyperParams  # noqa: E402
from downgan_tpu.data.eof import fit_eofs_per_channel as jax_fit_eofs  # noqa: E402
from downgan_tpu.training.wgan import build_train_step as jax_build_train_step  # noqa: E402

from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.data.dataset import synthetic_dataset  # noqa: E402
from downgan_tpu_torch.training.state import make_train_state  # noqa: E402
from downgan_tpu_torch.training.wgan import build_fused_round, build_train_step  # noqa: E402

from _torch_parity import jax_alpha, jax_flips, one_thread, paired_states, port_weights_of  # noqa: E402,F401

B, N_STEPS = 2, 6  # steps 0 and 5 update the generator
KW = dict(filters=8, num_res_blocks=1, coarse_size=8, fine_size=64, critic_conditional=True)
# 64x64 is too small for MS-SSIM's five levels (tests/test_torch_train.py runs it).
METRICS = ("MAE", "MSE", "Divergence", "Vorticity", "RALSD", "Wass")
HP = dict(batch_size=B, freq_sep=True, augment_flips=True, divergence_lambda=1.0,
          vorticity_lambda=1.0, eof_lambda=1.0, ncomp=4, metrics_to_calculate=METRICS)
# tests/test_torch_train.py's step tolerances: per-step losses and metrics
# to 1e-6 relative or 5e-6 absolute (fp32, sums in another order); the
# parameters after step 0 within 1e-5, after step 5 every element within
# 2 * lr (Adam's normalized step turns an ulp-level difference of a
# near-zero gradient into O(lr)) and the median within 1e-6.
METRIC_RTOL, METRIC_ATOL = 1e-6, 5e-6
STEP0_ATOL, ADAM_ATOL, MEDIAN_ATOL = 1e-5, 2 * 2.5e-4, 1e-6


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def six_steps():
    jcfg = JaxConfig(hp=JaxHyperParams(**HP), **KW)
    cfg = Config(hp=HyperParams(**HP), **KW)
    coarse, fine = synthetic_dataset(n_samples=B * N_STEPS, seed=3, coarse_size=8, fine_size=64)
    comps = jax_fit_eofs(fine, 6)  # more than ncomp: both steps take the leading 4
    jgen, jcritic, jstate, state = paired_states(jcfg, cfg)
    jstep = jax.jit(jax_build_train_step(jcfg, jgen, jcritic, eof_components=comps))
    step = build_train_step(cfg, state.generator, state.critic, eof_components=comps)
    rng = jax.random.PRNGKey(7)
    out = {"jax": [], "port": [], "params": [], "flips": []}
    for i in range(N_STEPS):
        rows = slice(B * i, B * (i + 1))
        jstate, jm = jstep(jstate, jnp.asarray(coarse[rows]), jnp.asarray(fine[rows]), rng)
        flips = jax_flips(rng, i, B)
        pm = step(state, nchw(coarse[rows]), nchw(fine[rows]),
                  torch.from_numpy(jax_alpha(rng, i, B)), flips=flips)
        out["jax"].append({k: float(v) for k, v in jm.items()})
        out["port"].append({k: float(v) for k, v in pm.items()})
        out["params"].append((port_weights_of(cfg, jstate.g_params, jstate.c_params),
                              (copy.deepcopy(state.generator.state_dict()),
                               copy.deepcopy(state.critic.state_dict()))))
        out["flips"].append(flips)
    out["forwards"], out["state"], out["comps"] = dict(step.forwards), state, comps
    return out


@pytest.mark.parametrize("i", range(N_STEPS))
def test_variant_step_losses_and_metrics_match_jax(six_steps, i):
    jm, pm = six_steps["jax"][i], six_steps["port"][i]
    assert set(pm) == set(jm) == {"critic_loss", "gen_loss", *METRICS}
    for k in jm:
        assert pm[k] == pytest.approx(jm[k], rel=METRIC_RTOL, abs=METRIC_ATOL), k


def test_variant_schedule_flips_and_forwards(six_steps):
    """G updates at steps 0 and 5; the injected masks flipped some samples
    both ways; the critic takes 2 + 7 inputs."""
    for i in range(N_STEPS):
        assert (six_steps["port"][i]["gen_loss"] != 0.0) == (i % 5 == 0)
    lon = torch.cat([f[0] for f in six_steps["flips"]])
    lat = torch.cat([f[1] for f in six_steps["flips"]])
    assert 0 < int(lon.sum()) < lon.numel() and 0 < int(lat.sum()) < lat.numel()
    assert six_steps["forwards"] == {"critic_fake": 6, "update": 2, "metric": 6}
    assert six_steps["state"].critic.features[0].in_channels == 9


@pytest.mark.parametrize("net", [0, 1], ids=["generator", "critic"])
@pytest.mark.parametrize("i", [0, 5], ids=["after_step0", "after_step5"])
def test_variant_parameters_match_jax(six_steps, net, i):
    ref, got = (sd[net] for sd in six_steps["params"][i])
    assert set(ref) == set(got)
    diff = np.concatenate([(got[k] - ref[k]).abs().numpy().ravel() for k in ref])
    if i == 0:
        assert diff.max() <= STEP0_ATOL
    else:
        moved = np.concatenate([(got[k] - six_steps["params"][0][1][net][k]).abs().numpy().ravel()
                                for k in ref])
        assert diff.max() <= ADAM_ATOL and np.median(diff) <= MEDIAN_ATOL
        assert np.median(moved) > 100 * MEDIAN_ATOL  # the weights moved


@pytest.mark.parametrize("build", [build_train_step, build_fused_round],
                         ids=["reference", "fused"])
def test_eof_term_needs_components(build):
    """The JAX error, at build time, on both schedules."""
    cfg = Config(hp=HyperParams(batch_size=B, eof_lambda=0.5), **KW)
    state = make_train_state(cfg, "cpu")
    with pytest.raises(ValueError, match="eof_lambda > 0 requires eof_components"):
        build(cfg, state.generator, state.critic)
