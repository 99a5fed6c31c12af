"""The port's stochastic generator (``noise_channels > 0``) against the JAX
package's: the widened RRDB forward and its weight mapping, one
reference-schedule step with a generator update and one fused round with
the JAX latents passed in, the test pass on the fixed latent, CRPS and
spread, ensemble metrics on the JAX member latents, the tiled domain
output; and the port's own streams: training latents as functions of
(seed, step, stream), the fixed realization, member latents, a coalesced
serving request equal to a direct one bit for bit, ``cli train
--noise-channels`` and ``--warm-start``'s adoption and conflicts.

Tiny model: filters 8, 1 RRDB, 8 -> 32 (MS-SSIM needs larger fields; the
metric pass is the same code for every registry entry), batch 2, two
noise channels. Each JAX program compiles once for the file."""
import copy
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from downgan_tpu import inference as jax_inference  # noqa: E402
from downgan_tpu.config.config import Config as JaxConfig  # noqa: E402
from downgan_tpu.config.config import HyperParams as JaxHyperParams  # noqa: E402
from downgan_tpu.ops import ensemble as jax_ensemble  # noqa: E402
from downgan_tpu.parallel.spatial import tiled_sr_inference as jax_tiled  # noqa: E402
from downgan_tpu.training.state import GANTrainState as JaxState  # noqa: E402
from downgan_tpu.training.state import make_optimizer as jax_make_optimizer  # noqa: E402
from downgan_tpu.training.wgan import build_eval_metrics as jax_build_eval  # noqa: E402
from downgan_tpu.training.wgan import build_fused_round as jax_build_fused_round  # noqa: E402
from downgan_tpu.training.wgan import build_train_step as jax_build_train_step  # noqa: E402
from downgan_tpu.training.wgan import eval_noise_rng  # noqa: E402
from downgan_tpu.utils.port_weights import export_generator  # noqa: E402

from downgan_tpu_torch.cli.__main__ import main  # noqa: E402
from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.inference import (  # noqa: E402
    ensemble_metrics,
    generate_ensemble,
    generate_fields,
    write_generator_bundle,
)
from downgan_tpu_torch.ops.ensemble import crps_ensemble, ensemble_spread  # noqa: E402
from downgan_tpu_torch.parallel.spatial import tiled_sr_inference  # noqa: E402
from downgan_tpu_torch.serving import BatchingSRModel, SRModel  # noqa: E402
from downgan_tpu_torch.training.state import load_generator, make_generator  # noqa: E402
from downgan_tpu_torch.training.state import make_train_state  # noqa: E402
from downgan_tpu_torch.training.wgan import (  # noqa: E402
    LATENT_STREAMS,
    build_eval_metrics,
    build_fused_round,
    build_train_step,
    fixed_latent,
    train_latent,
)
from downgan_tpu_torch.utils.port_weights import (  # noqa: E402
    critic_state_dict_from_flax,
    generator_state_dict_from_flax,
)

from _torch_parity import flax_critic, flax_generator, one_thread  # noqa: E402,F401

B, K, N_CRITIC = 2, 2, 2
KW = dict(filters=8, num_res_blocks=1, coarse_size=8, fine_size=32, noise_channels=K,
          chunk_size=4)
METRICS = ("MAE", "MSE", "Wass")
# fp32 on both sides, convs summed in another order (tests/test_torch_generator.py).
ATOL, RTOL = 2e-5, 1e-5
# Losses and metrics of a step or round: tests/test_torch_train.py's; the
# parameters after one step or round: its bound after step 0 (one Adam
# step, lr * g / (|g| + 1e-8), from the same gradients to fp32 rounding).
METRIC_RTOL, METRIC_ATOL = 1e-6, 5e-6
STEP_ATOL = 1e-5
# A fused round holds two critic updates: tests/test_torch_fused.py's
# bound for rounds, every element within 2 * lr, the median within 1e-6.
ROUND_ATOL = 2 * 2.5e-4


def configs(**hp):
    hp = dict(batch_size=B, critic_iterations=N_CRITIC, metrics_to_calculate=METRICS, **hp)
    return JaxConfig(hp=JaxHyperParams(**hp), **KW), Config(hp=HyperParams(**hp), **KW)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def host(tree):
    return jax.tree.map(np.asarray, tree)


def data(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 8, 8, 7)).astype(np.float32),
            rng.standard_normal((n, 32, 32, 2)).astype(np.float32))


@pytest.fixture(scope="module")
def nets():
    """Numpy-made weights for both packages: the flax generator (conv1
    takes 7 + K channels) and critic, and the port's state dicts."""
    jcfg, cfg = configs()
    jgen, g_params = flax_generator(jcfg, cfg, seed=11)
    jcritic, c_params, _ = flax_critic(jcfg, seed=12)
    g_sd = generator_state_dict_from_flax(host(g_params), num_res_blocks=1, num_upsample=2)
    c_sd = critic_state_dict_from_flax(host(c_params), base=8, fine_size=32)
    return jgen, g_params, jcritic, c_params, g_sd, c_sd


def port_state(cfg, g_sd, c_sd):
    state = make_train_state(cfg, "cpu")
    state.generator.load_state_dict(g_sd)
    state.critic.load_state_dict(c_sd)
    return state


def jax_state(jcfg, g_params, c_params):
    tx = jax_make_optimizer(jcfg)
    return JaxState(step=jnp.zeros((), jnp.int32), g_params=g_params, c_params=c_params,
                    g_opt_state=tx.init(g_params), c_opt_state=tx.init(c_params))


def normal(key, shape):
    """The JAX package's latent draw (``make_noise_injector``), NCHW."""
    return nchw(jax.random.normal(key, shape, jnp.float32))


def assert_params_close(jstate, state, atol, median=None):
    g_ref = generator_state_dict_from_flax(host(jstate.g_params), 1, 2)
    c_ref = critic_state_dict_from_flax(host(jstate.c_params), base=8, fine_size=32)
    for ref, got in ((g_ref, state.generator.state_dict()), (c_ref, state.critic.state_dict())):
        assert set(ref) == set(got)
        diff = np.concatenate([(got[k] - ref[k]).abs().numpy().ravel() for k in ref])
        assert diff.max() <= atol
        if median is not None:
            assert np.median(diff) <= median


def assert_metrics_close(got, want):
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=METRIC_RTOL,
                                              abs=METRIC_ATOL), k


# -- the widened generator -------------------------------------------------------

def test_widened_rrdb_forward_and_mapping_match_flax(nets):
    jgen, g_params, _, _, g_sd, _ = nets
    jcfg, cfg = configs()
    gen = make_generator(cfg, "cpu")
    assert gen.conv1.weight.shape == (8, 7 + K, 3, 3)
    exported = export_generator(host(g_params), num_res_blocks=1, num_upsample=2)
    assert set(exported) == set(g_sd) == set(gen.state_dict())
    for k, v in exported.items():
        np.testing.assert_array_equal(g_sd[k].numpy(), v)
    x = np.random.default_rng(0).standard_normal((3, 8, 8, 7 + K)).astype(np.float32)
    want = np.asarray(jax.jit(jgen.apply)(g_params, jnp.asarray(x)))
    gen = load_generator(cfg, g_sd, "cpu")
    with torch.inference_mode():
        got = gen(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_florida_stochastic_param_count():
    with open("examples/florida.json") as f:
        florida = Config.from_json(f.read())
    gen = make_generator(florida.replace(noise_channels=4), "cpu")
    assert sum(p.numel() for p in gen.parameters()) == 1_697_090  # 576 more than florida
    with pytest.raises(ValueError, match="noise_channels must be >= 0"):
        make_generator(florida.replace(noise_channels=-1), "cpu")


# -- training ----------------------------------------------------------------------

def test_reference_step_with_jax_latents_matches_jax(nets):
    """Steps 0 (critic update, generator update, a fresh metric fake) and
    1 (critic only) on the same batches, alphas and latents: the JAX
    step's ``fold_in(fold_in(fold_in(rng, step), 2), stream)`` draws."""
    jgen, g_params, jcritic, c_params, g_sd, c_sd = nets
    jcfg, cfg = configs()
    jstep = jax.jit(jax_build_train_step(jcfg, jgen, jcritic))
    jstate = jax_state(jcfg, g_params, c_params)
    state = port_state(cfg, g_sd, c_sd)
    step = build_train_step(cfg, state.generator, state.critic)
    coarse, fine = data(2 * B, seed=1)
    rng = jax.random.PRNGKey(5)
    for i in range(2):
        rows = slice(B * i, B * (i + 1))
        jstate, want = jstep(jstate, jnp.asarray(coarse[rows]), jnp.asarray(fine[rows]), rng)
        alpha_rng = jax.random.fold_in(rng, i)
        noise_rng = jax.random.fold_in(alpha_rng, 2)
        latents = {s: normal(jax.random.fold_in(noise_rng, n), (B, 8, 8, K))
                   for n, s in enumerate(LATENT_STREAMS)}
        alpha = torch.from_numpy(np.array(jax.random.uniform(alpha_rng, (B, 1, 1, 1))))
        got = step(state, nchw(coarse[rows]), nchw(fine[rows]), alpha, latents)
        assert_metrics_close(got, want)
        if i == 0:
            assert float(got["gen_loss"]) != 0.0
            assert_params_close(jstate, state, STEP_ATOL)
    assert step.forwards == {"critic_fake": 2, "update": 1, "metric": 2}


def test_fused_round_reusing_the_fake_with_jax_latents_matches_jax(nets):
    """One fused round under ``metrics_reuse_fake``: the metric pass scores
    the last critic update's fake, made from that update's latent
    (``fold_in(fold_in(rng, step), 2)``); the generator update draws
    ``fold_in(fold_in(rng, step_end), 3)``."""
    jgen, g_params, jcritic, c_params, g_sd, c_sd = nets
    jcfg, cfg = configs(schedule="fused", metrics_reuse_fake=True)
    jround = jax.jit(jax_build_fused_round(jcfg, jgen, jcritic))
    jstate = jax_state(jcfg, g_params, c_params)
    state = port_state(cfg, g_sd, c_sd)
    fused_round = build_fused_round(cfg, state.generator, state.critic)
    coarse, fine = data(N_CRITIC * B, seed=2)
    coarse_n = coarse.reshape(N_CRITIC, B, 8, 8, 7)
    fine_n = fine.reshape(N_CRITIC, B, 32, 32, 2)
    rng = jax.random.PRNGKey(9)
    jstate, want = jround(jstate, jnp.asarray(coarse_n), jnp.asarray(fine_n), rng)
    step_key = lambda s: jax.random.fold_in(rng, s)  # noqa: E731
    latents = {"critic_fake": torch.stack([normal(jax.random.fold_in(step_key(i), 2),
                                                  (B, 8, 8, K)) for i in range(N_CRITIC)]),
               "update": normal(jax.random.fold_in(step_key(N_CRITIC), 3), (B, 8, 8, K))}
    alphas = torch.stack([torch.from_numpy(np.array(jax.random.uniform(step_key(i),
                                                                       (B, 1, 1, 1))))
                          for i in range(N_CRITIC)])
    got = fused_round(state, torch.stack([nchw(c) for c in coarse_n]),
                      torch.stack([nchw(f) for f in fine_n]), alphas, latents)
    assert_metrics_close(got, want)
    assert_params_close(jstate, state, ROUND_ATOL, median=1e-6)
    assert state.step == N_CRITIC
    assert fused_round.forwards == {"critic_fake": N_CRITIC, "update": 1, "metric": 0}


def test_training_latents_are_functions_of_seed_step_and_stream():
    _, cfg = configs()
    coarse = torch.zeros(B, 7, 8, 8)
    draws = {s: train_latent(cfg, 3, s, coarse) for s in LATENT_STREAMS}
    for s, z in draws.items():
        assert z.shape == (B, K, 8, 8) and z.dtype == torch.float32
        assert torch.equal(z, train_latent(cfg, 3, s, coarse))  # a resume draws it again
        assert not torch.equal(z, train_latent(cfg, 4, s, coarse))
        assert not torch.equal(z, train_latent(cfg.replace(seed=1), 3, s, coarse))
    assert not torch.equal(draws["critic_fake"], draws["update"])
    assert train_latent(cfg.replace(noise_channels=0), 3, "update", coarse) is None


def test_step_draws_its_latents_from_seed_and_step(nets):
    """Without ``latents`` the step draws ``train_latent`` itself: the same
    step from the same state twice gives the same bits."""
    *_, g_sd, c_sd = nets
    _, cfg = configs()
    coarse, fine = data(B, seed=3)
    runs = []
    for _ in range(2):
        state = port_state(cfg, g_sd, c_sd)
        step = build_train_step(cfg, state.generator, state.critic)
        metrics = step(state, nchw(coarse), nchw(fine))
        runs.append(({k: float(v) for k, v in metrics.items()},
                     copy.deepcopy(state.generator.state_dict())))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items())


# -- evaluation --------------------------------------------------------------------

def test_test_pass_on_the_fixed_latent_matches_jax(nets):
    jgen, g_params, jcritic, c_params, g_sd, c_sd = nets
    jcfg, cfg = configs()
    coarse, fine = data(3, seed=4)
    want = jax.jit(jax_build_eval(jcfg, jgen, jcritic))(
        jax_state(jcfg, g_params, c_params), jnp.asarray(coarse), jnp.asarray(fine))
    state = port_state(cfg, g_sd, c_sd)
    eval_metrics = build_eval_metrics(cfg)
    z = normal(eval_noise_rng(jcfg), (3, 8, 8, K))
    assert_metrics_close(eval_metrics(state.generator, state.critic, nchw(coarse), nchw(fine),
                                      z), want)
    # Without a latent: the port's fixed realization, the same at any batch size.
    own = nchw(fixed_latent(cfg, (3, 8, 8, K)))
    default = eval_metrics(state.generator, state.critic, nchw(coarse), nchw(fine))
    assert default == eval_metrics(state.generator, state.critic, nchw(coarse), nchw(fine), own)
    np.testing.assert_array_equal(fixed_latent(cfg, (2, 8, 8, K)),
                                  fixed_latent(cfg, (5, 8, 8, K))[:2])


@pytest.mark.parametrize("m", [1, 2, 5])
def test_crps_and_spread_match_jax(m):
    rng = np.random.default_rng(m)
    members = rng.standard_normal((m, 3, 6, 6, 2)).astype(np.float32)
    truth = rng.standard_normal((3, 6, 6, 2)).astype(np.float32)
    crps = crps_ensemble(torch.from_numpy(members), torch.from_numpy(truth))
    spread = ensemble_spread(torch.from_numpy(members))
    assert float(crps) == pytest.approx(float(jax_ensemble.crps_ensemble(members, truth)),
                                        rel=1e-6)
    assert float(spread) == pytest.approx(float(jax_ensemble.ensemble_spread(members)),
                                          rel=1e-6, abs=0)
    if m == 1:  # the MAE and no spread
        assert float(crps) == pytest.approx(float(np.abs(members[0] - truth).mean()), rel=1e-6)
        assert float(spread) == 0.0


def test_ensemble_metrics_on_jax_member_latents_match_jax(nets):
    """Five samples in chunks of 4 (a padded tail), two members; the JAX
    package's member latents ``fold_in(fold_in(eval_noise_rng, member),
    chunk)`` passed in."""
    _, g_params, *_, g_sd, _ = nets
    jcfg, cfg = configs()
    coarse, fine = data(5, seed=6)
    want = jax_inference.ensemble_metrics(jcfg, g_params, coarse, fine, n_members=2)

    def jax_latent(member, chunk, shape):
        key = jax.random.fold_in(jax.random.fold_in(eval_noise_rng(jcfg), member), chunk)
        return np.asarray(jax.random.normal(key, shape, jnp.float32))

    got = ensemble_metrics(cfg, g_sd, coarse, fine, n_members=2, device="cpu",
                           latent=jax_latent)
    assert set(got) == set(want) == {"CRPS", "spread", "ens_mean_MAE", "member_MAE",
                                     "n_members"}
    assert got["n_members"] == want["n_members"] == 2
    for k in ("CRPS", "spread", "ens_mean_MAE", "member_MAE"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert got["CRPS"] < got["member_MAE"] and got["spread"] > 0


def test_members_are_reproducible_and_independent(nets):
    *_, g_sd, _ = nets
    _, cfg = configs()
    coarse, _ = data(5, seed=7)
    members = generate_ensemble(cfg, g_sd, coarse, n_members=2, device="cpu")
    assert members.shape == (2, 5, 32, 32, 2)
    np.testing.assert_array_equal(members[1], generate_fields(cfg, g_sd, coarse, device="cpu",
                                                              member=1))
    assert np.abs(members[0] - members[1]).max() > 1e-3
    deterministic = cfg.replace(noise_channels=0)
    with pytest.raises(ValueError, match="needs a stochastic generator"):
        generate_ensemble(deterministic, make_generator(deterministic, "cpu").state_dict(),
                          coarse, n_members=2, device="cpu")


# -- serving and domain tiling -------------------------------------------------------

def test_coalesced_request_equals_a_direct_one_bit_for_bit(nets):
    """Requests of 3, 5 and 2 samples coalesced into blocks of 4: each gets
    the fixed latent in its own block layout, so the same bits as a
    direct call, whatever it was coalesced with."""
    *_, g_sd, _ = nets
    _, cfg = configs()
    direct = SRModel(cfg, g_sd, batch_size=4, device="cpu")
    batching = BatchingSRModel(cfg, g_sd, batch_size=4, max_wait_ms=300.0, device="cpu")
    requests = [data(n, seed=n)[0] for n in (3, 5, 2)]
    try:
        results = [None] * 3
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, batching.generate(requests[i]))) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        batching.close()
    assert batching.dispatch_count < 4  # at least two requests shared a dispatch
    for req, got in zip(requests, results):
        np.testing.assert_array_equal(got, direct.generate(req))
    # the latent is the fixed realization: row j of a request gets row j % 4
    z = fixed_latent(cfg, (4, 8, 8, K))
    np.testing.assert_array_equal(direct._augment(requests[1])[..., 7:],
                                  np.concatenate([z, z[:1]]))


def test_domain_request_matches_jax_tiled_inference(nets):
    """The whole-domain latent (numpy on both sides) appended before
    tiling: the port's tiled output equals the JAX package's with the same
    weights; the tiles stitch without seams (the JAX test's bound against
    the whole-field forward on the same latent); repeated calls agree bit
    for bit."""
    _, g_params, *_, g_sd, _ = nets
    jcfg, cfg = configs()
    coarse = np.random.default_rng(8).standard_normal((1, 24, 8, 7)).astype(np.float32)
    want = jax_tiled(jcfg, g_params, coarse, tile_rows=8, overlap=4)
    got = tiled_sr_inference(cfg, g_sd, coarse, tile_rows=8, overlap=4, device="cpu")
    assert got.shape == (1, 96, 32, 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    served = SRModel(cfg, g_sd, batch_size=4, device="cpu")
    np.testing.assert_array_equal(served.generate_domain(coarse, tile_rows=8, overlap=4), got)
    z = fixed_latent(cfg, (1, 24, 8, K))
    gen = load_generator(cfg, g_sd, "cpu")
    with torch.inference_mode():
        whole = gen(nchw(np.concatenate([coarse, z], axis=-1)))
    assert np.abs(got - whole.permute(0, 2, 3, 1).numpy()).max() < 5e-2


# -- the CLI -----------------------------------------------------------------------

def tiny_config_file(tmp_path, **kw):
    cfg = Config(hp=HyperParams(batch_size=B, metrics_to_calculate=METRICS),
                 **{**KW, "noise_channels": 0, **kw})
    path = tmp_path / "tiny.json"
    path.write_text(cfg.to_json())
    return str(path)


def test_cli_train_noise_channels_and_warm_start(tmp_path, capsys):
    """``--noise-channels 2`` trains a stochastic generator; its bundle
    warm-starts a run of a deterministic config, which adopts the
    bundle's noise_channels; conflicting flags are usage errors."""
    argv = ["train", "--config", tiny_config_file(tmp_path), "--synthetic", "--samples", "6",
            "--epochs", "1", "--device", "cpu", "--tracking-root", str(tmp_path / "exps")]
    trainer = main([*argv, "--noise-channels", "2"])
    assert trainer.config.noise_channels == 2
    assert trainer.state.generator.conv1.weight.shape[1] == 7 + 2
    (line,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert all(np.isfinite(v) for part in ("train", "test") for v in line[part].values())
    assert trainer.forwards == {"critic_fake": 2, "update": 1, "metric": 2, "test": 1}

    bundle = write_generator_bundle(str(tmp_path / "bundle"), trainer.config,
                                    trainer.state.generator.state_dict())
    warm = main([*argv, "--warm-start", bundle])
    assert warm.config.noise_channels == 2 and warm.config.generator_arch == "rrdb"
    for flag, value, match in (("--noise-channels", "0", "the generator input width"),
                               ("--generator-arch", "srresnet", "the architecture")):
        with pytest.raises(SystemExit) as exc:
            main([*argv, "--warm-start", bundle, flag, value])
        err = capsys.readouterr().err
        assert exc.value.code == 2 and "conflicts with the bundle's" in err and match in err
    with pytest.raises(SystemExit) as exc:
        main([*argv, "--noise-channels", "-1"])
    assert exc.value.code == 2 and "--noise-channels must be >= 0" in capsys.readouterr().err
