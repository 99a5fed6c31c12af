"""The port's training-variant building blocks against the JAX package's,
function by function, on numpy-made inputs: the divergence, vorticity and
EOF losses, the frequency-separation filters, the radial spectrum and
RALSD, the physics-aware flips (with the JAX masks injected), the EOF fit
and EOF low-pass, the nearest upsample and the critic's conditioning, the
LR schedules against optax, and a conditional critic's weights at 9
inputs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from downgan_tpu.config.config import Config as JaxConfig  # noqa: E402
from downgan_tpu.config.config import HyperParams as JaxHyperParams  # noqa: E402
from downgan_tpu.data import eof as jax_eof  # noqa: E402
from downgan_tpu.models.layers import upsample_nearest as jax_upsample  # noqa: E402
from downgan_tpu.ops import augment as jax_augment  # noqa: E402
from downgan_tpu.ops import losses as jax_losses  # noqa: E402
from downgan_tpu.ops import metrics as jax_metrics  # noqa: E402
from downgan_tpu.ops import spectral as jax_spectral  # noqa: E402
from downgan_tpu.training.state import lr_schedule_fn as jax_lr_schedule_fn  # noqa: E402
from downgan_tpu.training.wgan import make_condition as jax_make_condition  # noqa: E402

from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.data import eof  # noqa: E402
from downgan_tpu_torch.data.dataset import DeviceDataset  # noqa: E402
from downgan_tpu_torch.data.feed import HostDataset  # noqa: E402
from downgan_tpu_torch.data.stream import StreamDataset  # noqa: E402
from downgan_tpu_torch.models.critic import Critic  # noqa: E402
from downgan_tpu_torch.models.layers import upsample_nearest  # noqa: E402
from downgan_tpu_torch.ops import augment, losses, spectral  # noqa: E402
from downgan_tpu_torch.ops.metrics import resolve_metrics  # noqa: E402
from downgan_tpu_torch.training.state import (  # noqa: E402
    ScheduledAdam,
    lr_schedule_fn,
    make_optimizer,
)
from downgan_tpu_torch.training.trainer import training_eof_components  # noqa: E402
from downgan_tpu_torch.training.wgan import flip_masks, make_condition  # noqa: E402
from downgan_tpu_torch.utils.port_weights import critic_state_dict_from_flax  # noqa: E402

from _torch_parity import flax_critic, jax_flips, one_thread  # noqa: E402,F401


# fp32 on both sides, reductions in another order: 1e-5 relative (the
# normalized losses divide by a std, the log-spectral distance takes logs of
# sums over up to 16,384 pixels).
RTOL, ATOL = 1e-5, 1e-6


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def fields(shape, seed):
    """Smooth-ish NHWC float32 fields: noise plus a large-scale wave, so
    the finite differences and spectra are not white."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    yy, xx = np.meshgrid(np.linspace(0, 3, h), np.linspace(0, 2, w), indexing="ij")
    wave = np.sin(yy + 0.7 * xx)[None, :, :, None] * rng.uniform(0.5, 2.0, (b, 1, 1, c))
    return (wave + 0.3 * rng.standard_normal(shape)).astype(np.float32)


# -- physics losses and filters ---------------------------------------------------

@pytest.mark.parametrize("name", ["divergence_loss", "vorticity_loss"])
def test_physics_losses_match_jax(name):
    """Three channels, so only u (0) and v (1) may enter; the std is the
    population one on both sides."""
    hr, fake = fields((3, 24, 20, 3), 0), fields((3, 24, 20, 3), 1)
    want = float(getattr(jax_losses, name)(jnp.asarray(hr), jnp.asarray(fake)))
    got = float(getattr(losses, name)(nchw(hr), nchw(fake)))
    assert got == pytest.approx(want, rel=RTOL)
    changed = fake.copy()
    changed[..., 2] += 1.0  # a scalar channel the losses must not read
    assert float(getattr(losses, name)(nchw(hr), nchw(changed))) == got


@pytest.mark.parametrize("name,golden", [("divergence_loss", 0.0018), ("vorticity_loss", 0.00144)])
def test_physics_losses_golden_values(name, golden):
    """The reference suite's Gaussian fixture (tests/test_losses.py): the
    same golden value and tolerance as the JAX test, and the JAX value to
    1e-5 relative."""
    xx, yy = np.meshgrid(np.arange(-5, 5), np.arange(-6, 6), indexing="ij")
    hr = np.broadcast_to(np.exp(-(xx ** 2 + yy ** 2)).astype(np.float32)[None, :, :, None],
                         (64, 10, 12, 2)).copy()
    fake = np.broadcast_to(np.exp(-(xx ** 4 + yy ** 4)).astype(np.float32)[None, :, :, None],
                           (64, 10, 12, 2)).copy()
    got = float(getattr(losses, name)(nchw(hr), nchw(fake)))
    assert got == pytest.approx(golden, abs=1e-4)
    assert got == pytest.approx(float(getattr(jax_losses, name)(jnp.asarray(hr),
                                                                 jnp.asarray(fake))), rel=RTOL)
    assert float(getattr(losses, name)(nchw(hr), nchw(hr))) == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("layout", ["shared", "per_channel"])
def test_eof_loss_matches_jax(layout):
    hr, fake = fields((4, 12, 10, 2), 2), fields((4, 12, 10, 2), 3)
    rng = np.random.default_rng(4)
    shape = (6, 120) if layout == "shared" else (6, 2, 120)
    comps = rng.standard_normal(shape).astype(np.float32)
    want = float(jax_losses.eof_loss(jnp.asarray(comps), jnp.asarray(hr), jnp.asarray(fake)))
    got = float(losses.eof_loss(torch.from_numpy(comps), nchw(hr), nchw(fake)))
    assert got == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("filter_size", [3, 5])
def test_low_and_high_pass_match_jax(filter_size):
    """Replicate padding then a stride-1 mean: equal to the JAX
    reduce-window within fp32 sums of 25 terms."""
    x = fields((2, 17, 13, 3), 5)
    lo = losses.low_pass(nchw(x), filter_size)
    assert lo.shape == (2, 3, 17, 13)
    np.testing.assert_allclose(lo.numpy(), nchw(jax_losses.low_pass(jnp.asarray(x), filter_size)),
                               atol=ATOL)
    np.testing.assert_allclose(losses.high_pass(nchw(x), filter_size).numpy(),
                               nchw(jax_losses.high_pass(jnp.asarray(x), filter_size)), atol=ATOL)


# -- spectra ----------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(16, 16), (12, 20), (128, 128)])
def test_radial_bin_matrix_is_the_jax_one(hw):
    np.testing.assert_array_equal(spectral._radial_bin_matrix(*hw),
                                  jax_spectral._radial_bin_matrix(*hw))


@pytest.mark.parametrize("shape", [(3, 16, 16, 2), (2, 24, 20, 2), (2, 128, 128, 2)])
def test_radial_spectrum_and_ralsd_match_jax(shape):
    real, fake = fields(shape, 6), fields(shape, 7)
    want = np.asarray(jax_spectral.radial_spectrum(jnp.asarray(fake)))
    got = spectral.radial_spectrum(nchw(fake)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    r = float(spectral.ralsd(nchw(fake), nchw(real)))
    assert r == pytest.approx(float(jax_spectral.ralsd(jnp.asarray(fake), jnp.asarray(real))),
                              rel=RTOL)
    assert float(spectral.ralsd(nchw(real), nchw(real))) == 0.0


def test_ralsd_takes_bf16_in_fp32():
    """The FFT runs on the fp32 values of a bf16 input (cuFFT takes no bf16)."""
    real, fake = nchw(fields((2, 16, 16, 2), 8)), nchw(fields((2, 16, 16, 2), 9))
    got = spectral.ralsd(fake.bfloat16(), real.bfloat16())
    assert got.dtype == torch.float32
    assert float(got) == float(spectral.ralsd(fake.bfloat16().float(), real.bfloat16().float()))


@pytest.mark.parametrize("name", ["Divergence", "Vorticity", "RALSD"])
def test_registry_metrics_match_jax(name):
    """The new registry entries, ``f(real, fake)`` on both sides (RALSD
    swaps its arguments in both registries)."""
    real, fake = fields((2, 32, 32, 2), 10), fields((2, 32, 32, 2), 11)
    (fn,) = resolve_metrics([name, "Wass"]).values()
    want = float(jax_metrics.resolve_metrics([name])[name](jnp.asarray(real), jnp.asarray(fake)))
    assert float(fn(nchw(real), nchw(fake))) == pytest.approx(want, rel=RTOL)


# -- flips ------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [{}, dict(u_channels_coarse=(0, 2), v_channels_coarse=(1, 3),
                                               u_channels_fine=(1,), v_channels_fine=())],
                         ids=["default", "custom"])
def test_flip_pair_matches_jax_with_its_masks(channels):
    """The JAX masks, injected: bit for bit (a mirror and a sign flip)."""
    b = 16
    coarse, fine = fields((b, 8, 6, 5), 12), fields((b, 16, 12, 2), 13)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(3), 4), 1)
    jc, jf = jax_augment.random_flip_pair(key, jnp.asarray(coarse), jnp.asarray(fine), **channels)
    lon, lat = jax_flips(jax.random.PRNGKey(3), 4, b)
    assert 0 < int(lon.sum()) < b and 0 < int(lat.sum()) < b
    pc, pf = augment.random_flip_pair(nchw(coarse), nchw(fine), lon, lat, **channels)
    np.testing.assert_array_equal(pc.numpy(), nchw(jc).numpy())
    np.testing.assert_array_equal(pf.numpy(), nchw(jf).numpy())
    cfg = Config(**{k: v for k, v in channels.items()})
    mc, mf = augment.make_augment(cfg)(nchw(coarse), nchw(fine), lon, lat)
    assert torch.equal(mc, pc) and torch.equal(mf, pf)


def test_axis_flip_values():
    """A lon flip mirrors W (dim 3) and negates the named channels only."""
    x = torch.arange(2 * 2 * 2 * 3, dtype=torch.float32).reshape(2, 2, 2, 3)
    ref = x.flip(3).clone()
    ref[:, 0] *= -1
    assert torch.equal(augment._axis_flip(x, augment.LON_DIM, (0,)), ref)
    assert torch.equal(augment._axis_flip(x, augment.LAT_DIM, ()), x.flip(2))


@pytest.mark.parametrize("dim,negate", [(augment.LON_DIM, 0), (augment.LAT_DIM, 1)],
                         ids=["lon", "lat"])
def test_flip_preserves_divergence_and_negates_vorticity(dim, negate):
    """The invariants of tests/test_augment.py in NCHW: the sign-corrected
    mirror's central-difference divergence is the mirror of the original's
    and its vorticity the negated mirror; a naive image flip breaks this."""
    uv = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 2, 16, 16)).astype(np.float32))

    def div(f):
        return np.gradient(f[0, 0].numpy(), axis=1) + np.gradient(f[0, 1].numpy(), axis=0)

    def vort(f):
        return np.gradient(f[0, 1].numpy(), axis=1) - np.gradient(f[0, 0].numpy(), axis=0)

    mirror = (lambda a: a[:, ::-1]) if dim == augment.LON_DIM else (lambda a: a[::-1, :])
    flipped = augment._axis_flip(uv, dim, (negate,))
    np.testing.assert_allclose(div(flipped), mirror(div(uv)), atol=1e-6)
    np.testing.assert_allclose(vort(flipped), -mirror(vort(uv)), atol=1e-6)
    assert not np.allclose(div(uv.flip(dim)), mirror(div(uv)), atol=1e-3)


def test_flip_masks_are_a_function_of_seed_and_step():
    lon, lat = flip_masks(0, 5, 256, torch.device("cpu"))
    again = flip_masks(0, 5, 256, torch.device("cpu"))
    assert lon.dtype == torch.bool and lon.shape == (256,)
    assert torch.equal(lon, again[0]) and torch.equal(lat, again[1])
    assert not torch.equal(lon, lat)
    assert not torch.equal(lon, flip_masks(0, 6, 256, torch.device("cpu"))[0])
    assert not torch.equal(lon, flip_masks(1, 5, 256, torch.device("cpu"))[0])
    assert 96 < int(lon.sum()) < 160 and 96 < int(lat.sum()) < 160


# -- EOFs -------------------------------------------------------------------------

def eof_training_fine(n=24, h=12, w=10):
    return fields((n, h, w, 2), 14)


def test_fit_eofs_per_channel_is_the_jax_fit():
    """The same numpy code: components and means bit for bit."""
    fine = eof_training_fine()
    got, got_means = eof.fit_eofs_per_channel(fine, 5, return_means=True)
    want, want_means = jax_eof.fit_eofs_per_channel(fine, 5, return_means=True)
    assert got.shape == (5, 2, 120)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_means, want_means)
    basis, jbasis = eof.fit_eofs(fine[..., 0].reshape(24, -1), 4), \
        jax_eof.fit_eofs(fine[..., 0].reshape(24, -1), 4)
    for field in ("components", "mean", "explained_variance"):
        np.testing.assert_array_equal(getattr(basis, field), getattr(jbasis, field))
    flat = fine[..., 1].reshape(24, -1)
    proj = eof.project(basis, flat)
    np.testing.assert_array_equal(proj, jax_eof.project(jbasis, flat))
    np.testing.assert_array_equal(eof.reconstruct(basis, proj), jax_eof.reconstruct(jbasis, proj))


def test_randomized_svd_is_the_jax_one():
    x = np.random.default_rng(15).standard_normal((60, 50))
    for got, want in zip(eof._randomized_svd(x, 4), jax_eof._randomized_svd(x, 4)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tier", ["device", "host", "stream"])
def test_training_eof_components_from_nchw_tensors_and_nhwc_rows(tier):
    """A device set's NCHW tensor, a host set's NHWC rows and a streamed
    set's (time, var, lat, lon) records give the JAX fit of the NHWC fields
    bit for bit: each channel flattens over (H, W) row-major in every
    layout."""
    fine = eof_training_fine()
    coarse = np.zeros((24, 3, 3, 7), np.float32)
    if tier == "device":
        ds = DeviceDataset.from_numpy(coarse, fine, "cpu")
    elif tier == "host":
        ds = HostDataset(coarse, fine)
    else:
        ds = StreamDataset(np.ascontiguousarray(coarse.transpose(0, 3, 1, 2)),
                           np.ascontiguousarray(fine.transpose(0, 3, 1, 2)))
    np.testing.assert_array_equal(training_eof_components(ds, 5),
                                  jax_eof.fit_eofs_per_channel(fine, 5))


@pytest.mark.parametrize("layout", ["shared", "per_channel"])
@pytest.mark.parametrize("mean", ["none", "centred", "reference"])
def test_low_pass_eof_batch_matches_jax(layout, mean):
    fine = eof_training_fine()
    comps, means = jax_eof.fit_eofs_per_channel(fine, 5, return_means=True)
    if layout == "shared":
        comps, means = comps[:, 0], means[0]
    kw = {"none": {}, "centred": dict(mean=means),
          "reference": dict(mean=means, add_mean_back=False)}[mean]
    batch = fields((3, 12, 10, 2), 16)
    want = jax_eof.low_pass_eof_batch(jnp.asarray(batch), jnp.asarray(comps),
                                      **{k: (jnp.asarray(v) if k == "mean" else v)
                                         for k, v in kw.items()})
    got = eof.low_pass_eof_batch(nchw(batch), torch.from_numpy(comps),
                                 **{k: (torch.from_numpy(v) if k == "mean" else v)
                                    for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), nchw(want).numpy(), rtol=RTOL, atol=ATOL)


# -- conditioning -----------------------------------------------------------------

@pytest.mark.parametrize("factor", [2, 8])
def test_upsample_nearest_matches_jax(factor):
    x = fields((2, 5, 3, 4), 17)
    np.testing.assert_array_equal(upsample_nearest(nchw(x), factor).numpy(),
                                  nchw(jax_upsample(jnp.asarray(x), factor)).numpy())


@pytest.mark.parametrize("conditional", [False, True])
def test_make_condition_matches_jax(conditional):
    kw = dict(coarse_size=8, fine_size=64, critic_conditional=conditional)
    coarse, x = fields((2, 8, 8, 7), 18), fields((2, 64, 64, 2), 19)
    want = jax_make_condition(JaxConfig(**kw))(jnp.asarray(x), jnp.asarray(coarse))
    got = make_condition(Config(**kw))(nchw(x), nchw(coarse))
    assert got.shape == (2, 9 if conditional else 2, 64, 64)
    np.testing.assert_array_equal(got.numpy(), nchw(want).numpy())
    with pytest.raises(ValueError, match="integer multiple"):
        make_condition(Config(coarse_size=12, fine_size=64, critic_conditional=True))


def test_conditional_critic_weights_map_at_nine_inputs():
    """``critic_state_dict_from_flax`` maps a flax critic over 2 + 7
    inputs; the port's critic scores conditioned inputs as flax does."""
    jcfg = JaxConfig(filters=8, coarse_size=8, fine_size=64, critic_conditional=True)
    assert jcfg.critic_in_channels == 9
    jcritic, c_params, _ = flax_critic(jcfg, seed=2, conv_gain=2.5)
    critic = Critic(base=8, fine_size=64, in_channels=9)
    critic.load_state_dict(critic_state_dict_from_flax(jax.tree.map(np.asarray, c_params),
                                                       base=8, fine_size=64))
    x = fields((3, 64, 64, 9), 20)
    want = np.asarray(jcritic.apply(c_params, jnp.asarray(x)))
    with torch.no_grad():
        got = critic(nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# -- learning-rate schedules ------------------------------------------------------

SCHEDULES = [dict(lr_schedule="constant"), dict(lr_schedule="constant", lr_warmup_steps=3)] + [
    dict(lr_schedule=shape, lr_warmup_steps=w, lr_decay_steps=10, lr_final_factor=f)
    for shape in ("cosine", "linear") for w in (0, 3) for f in (0.0, 0.1)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_lr_schedule_matches_optax(kw):
    """At counts 0 .. decay + 3, against the JAX package's optax schedule
    evaluated in float64 (the port computes in float64; optax's own fp32
    evaluation is one fp32 rounding away): 1e-7 relative."""
    want_fn = jax_lr_schedule_fn(JaxHyperParams(**kw))
    got_fn = lr_schedule_fn(HyperParams(**kw))
    with jax.enable_x64(True):
        for count in range(kw.get("lr_decay_steps", 10) + 4):
            want = float(want_fn(np.int64(count)))
            assert got_fn(count) == pytest.approx(want, rel=1e-7, abs=0.0), count
    if kw.get("lr_warmup_steps"):
        assert got_fn(0) == 0.0


def test_scheduled_adam_steps_like_optax_adam():
    """Off by one is the trap: optax reads the schedule at the count before
    the update, so the first update runs at lr 0 under a warmup. Five
    updates of the same gradients through both optimizers, fp32 (1e-6
    relative to the largest parameter)."""
    hp = HyperParams(lr=0.1, lr_schedule="cosine", lr_warmup_steps=2, lr_decay_steps=5,
                     lr_final_factor=0.1)
    w0 = np.random.default_rng(21).standard_normal(6).astype(np.float32)
    grads = np.random.default_rng(22).standard_normal((5, 6)).astype(np.float32)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = make_optimizer(Config(hp=hp), torch.nn.ParameterList([p]))
    assert isinstance(opt, ScheduledAdam)
    tx = optax.adam(jax_lr_schedule_fn(JaxHyperParams(**{
        k: getattr(hp, k) for k in ("lr", "lr_schedule", "lr_warmup_steps", "lr_decay_steps",
                                    "lr_final_factor")})), b1=hp.beta1, b2=hp.beta2, eps=1e-8)
    jw, st = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    for i, g in enumerate(grads):
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        upd, st = tx.update(jnp.asarray(g), st, jw)
        jw = optax.apply_updates(jw, upd)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-6 * np.abs(w0).max())
        if i == 0:  # lr 0: Adam's moments moved, the parameter did not
            assert torch.equal(p.detach(), torch.from_numpy(w0))
    assert int(opt.state[p]["step"]) == 5
    assert opt.param_groups[0]["lr"] == pytest.approx(lr_schedule_fn(hp)(4))


def test_constant_schedule_is_plain_adam():
    """Under the reference's constant schedule every update runs at ``lr``,
    as plain Adam's do: five updates of the same gradients, bit for bit."""
    cfg = Config(hp=HyperParams())
    opt = make_optimizer(cfg, torch.nn.Linear(2, 2))
    assert opt.param_groups[0]["lr"] == cfg.hp.lr
    p, q = (torch.nn.Parameter(torch.arange(6.0)) for _ in range(2))
    ours = make_optimizer(cfg, torch.nn.ParameterList([p]))
    plain = torch.optim.Adam([q], lr=cfg.hp.lr, betas=(cfg.hp.beta1, cfg.hp.beta2), eps=1e-8,
                             foreach=True)
    for g in np.random.default_rng(23).standard_normal((5, 6)).astype(np.float32):
        p.grad, q.grad = torch.from_numpy(g.copy()), torch.from_numpy(g.copy())
        ours.step()
        plain.step()
        assert torch.equal(p, q) and ours.param_groups[0]["lr"] == cfg.hp.lr
    warm = make_optimizer(Config(hp=dataclasses.replace(cfg.hp, lr_warmup_steps=2)),
                          torch.nn.Linear(2, 2))
    assert isinstance(warm, ScheduledAdam) and warm.param_groups[0]["lr"] == 0.0
