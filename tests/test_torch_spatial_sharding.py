"""The port's halo-exchange spatial sharding (``parallel/spatial.py``) on
gloo ranks of the CPU, against the JAX package's sharded applies and train
step on its CPU mesh and against the port's own unsharded networks and
steps.

Four ranks are spawned once for the module (``tests/_torch_spatial_worker.py``)
as a 2 x 2 (data, spatial) grid: the 2-shard cases run in its spatial
groups, the 4-shard cases over all four ranks (florida's 16 coarse rows
over 4 shards are 4 rows a shard against the DRB's 5-row halo: halos from
two neighbours). Tiny model: filters 8, one RRDB, 16 -> 128 (the JAX
package's ``tests/test_spatial.py`` config). Each JAX program compiles once
for the module; the JAX references run in this process, the ranks import
no JAX.

On the card: ``python -m pytest tests/test_torch_drb.py -m cuda --noconftest``
holds the kernel on a halo-extended band, cropped, to the whole field bit
for bit; ``chip_smoke.py`` phase ``spatial`` runs the florida model sharded.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("torch.multiprocessing")



from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.models.generator import DenseResidualBlock  # noqa: E402
from downgan_tpu_torch.ops.cuda.drb import drb_forward_reference  # noqa: E402
from downgan_tpu_torch.parallel.spatial import DRB_HALO, band_rows  # noqa: E402
from downgan_tpu_torch.training.state import make_train_state  # noqa: E402
from downgan_tpu_torch.training.wgan import build_train_step, gradient_penalty  # noqa: E402

import _torch_dp_worker as dp_worker  # noqa: E402
import _torch_spatial_worker as worker  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401

WORLD, SHARDS = 4, (2, 4)
B, B_DP = 2, 8
KW = dict(coarse_size=16, fine_size=128, filters=8, num_res_blocks=1)
METRICS = ("MAE", "MSE", "Wass")
# The JAX package's bounds (tests/test_spatial.py): fp32 sums in another
# order. The sharded conv and generator against the unsharded ones to 1e-5
# and 2e-5; the critic's scores to 3e-4 absolute and 1e-4 relative, the GP
# to 1e-3 relative; a spatial step's losses to 1e-3 relative and its
# parameters to 5e-5; a step with latents and flips to 1e-4 relative in
# every metric; DP x spatial against DP alone to 1e-4 relative in the
# metrics, 5e-5 in the critic, and in the generator every element within
# 2 * lr + 1e-5 with fewer than 0.5 % of them beyond 5e-5 (Adam's first
# step is lr * sign(g): a near-zero gradient summed in another order can
# flip it).
CONV_ATOL, GEN_ATOL = 1e-5, 2e-5
# The sharded conv's first- and second-order gradients against the
# unsharded conv's: fp32 sums in another order, each to 1e-5 of its largest
# entry (the weight's second-order gradient, up to ~50, sums terms that
# cancel: an element of 0.15 came out 8e-5 off in relative terms).
CONV_GRAD_REL = 1e-5
SCORE_ATOL, SCORE_RTOL, GP_RTOL = 3e-4, 1e-4, 1e-3
LOSS_RTOL, PARAM_ATOL, METRIC_RTOL = 1e-3, 5e-5, 1e-4
ADAM_FLIP_ATOL, FLIP_SHARE = 2 * 2.5e-4 + 1e-5, 0.005
# The GP's parameter gradients through the sharded critic against the
# unsharded critic's and JAX's: fp32 double backwards of the same function
# whose sums run in another order, each tensor to 1e-4 of its largest entry
# (measured here: 4.2e-6 at worst).
GP_GRAD_REL = 1e-4
# The parameter gradients of a scalar of the sharded generator's output
# against the unsharded generator's and JAX's through its sharded apply:
# fp32 sums in another order, each tensor to GEN_GRAD_REL of its largest entry.
GEN_GRAD_REL = 1e-4
# The halo case runs in float64, so the exchange and its adjoints must be
# exact up to the reference's own float64 sums.
F64_ATOL = 1e-12


def jax_config(**hp):
    from downgan_tpu.config.config import Config as JaxConfig
    from downgan_tpu.config.config import HyperParams as JaxHyperParams

    hp = dict(batch_size=B, metrics_to_calculate=METRICS, **hp)
    return JaxConfig(hp=JaxHyperParams(**hp), **KW)


def port_config(**hp):
    hp = dict(batch_size=B, metrics_to_calculate=METRICS, **hp)
    return Config(hp=HyperParams(**hp), **KW)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def halo_case(rng):
    """A float64 field of 16 rows and, per shard count, a weight for each
    rank's 5-row band."""
    x = torch.from_numpy(rng.standard_normal((2, 3, 16, 5)))
    weights = {s: [torch.from_numpy(rng.standard_normal((2, 3, 16 // s + 2 * DRB_HALO, 5)))
                   for _ in range(s)] for s in SHARDS}
    return {"x": x, "ks": (1, DRB_HALO), "band_weights": weights}


def halo_reference(case, shards):
    """The same scalar and gradients from numpy-style slices of the padded
    whole field, one process."""
    x = case["x"].clone().requires_grad_(True)
    h, k = 16 // shards, DRB_HALO
    padded = torch.nn.functional.pad(x, (0, 0, k, k))
    loss = sum((padded[:, :, r * h:(r + 1) * h + 2 * k].pow(3) * w).sum()
               for r, w in enumerate(case["band_weights"][shards]))
    (grad,) = torch.autograd.grad(loss, x, create_graph=True)
    (grad2,) = torch.autograd.grad(grad.square().sum(), x)
    return loss.detach(), grad.detach(), grad2


def make_cases(weights, rng, step_alpha):
    """Every case the ranks run, from the model's ``weights`` (config and
    state dicts) and seeded draws; also the NHWC inputs the JAX references
    take. ``step_alpha`` is the reference step's GP alpha (B, 1, 1, 1)."""
    x_conv = rng.standard_normal((2, 16, 12, 5)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 5, 7)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(7) * 0.1).astype(np.float32)
    coarse = rng.standard_normal((B, 16, 16, 7)).astype(np.float32)
    real = rng.standard_normal((B, 128, 128, 2)).astype(np.float32)
    fake, alpha = real * 0.9, np.full((B, 1, 1, 1), 0.3, np.float32)
    step_coarse = rng.standard_normal((1, B, 16, 16, 7)).astype(np.float32)
    step_fine = rng.standard_normal((1, B, 128, 128, 2)).astype(np.float32)
    arrays = dict(x_conv=x_conv, kernel=kernel, bias=bias, coarse=coarse, real=real, fake=fake,
                  alpha=alpha, step_coarse=step_coarse[0], step_fine=step_fine[0])
    cases = {
        "halo": halo_case(rng),
        "conv": {"x": nchw(x_conv), "weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
                 "bias": torch.from_numpy(bias),
                 "r": torch.from_numpy(rng.standard_normal((2, 7, 16, 12)).astype(np.float32))},
        "linear": {"x": torch.from_numpy(rng.standard_normal((3, 4, 8, 6)).astype(np.float32)),
                   "linear": {"weight": torch.from_numpy(
                       rng.standard_normal((5, 4 * 8 * 6)).astype(np.float32)),
                       "bias": torch.from_numpy(rng.standard_normal(5).astype(np.float32))},
                   "r": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))},
        "generator": {**weights, "coarse": nchw(coarse)},
        "critic": {**weights, "real": nchw(real), "fake": nchw(fake),
                   "alpha": torch.from_numpy(alpha)},
        "step": {**weights, "coarse": torch.stack([nchw(c) for c in step_coarse]),
                 "fine": torch.stack([nchw(f) for f in step_fine]), "alphas": step_alpha[None]},
    }
    # latents and flips passed in (a stochastic generator's own weights)
    noisy = port_config(augment_flips=True).replace(noise_channels=2)
    state_n = make_train_state(noisy, "cpu")
    g = torch.Generator().manual_seed(9)
    cases["step_noise_flips"] = {
        "config": noisy.to_json(), "generator": state_n.generator.state_dict(),
        "critic": state_n.critic.state_dict(), "coarse": cases["step"]["coarse"],
        "fine": cases["step"]["fine"], "alphas": cases["step"]["alphas"],
        "latents": {s: torch.randn((1, B, 2, 16, 16), generator=g)
                    for s in ("critic_fake", "update", "metric")},
        "flips": (torch.tensor([[True, False]]), torch.tensor([[True, True]]))}
    # DP x spatial against DP alone: one step at global batch 8
    dp_cfg = Config(hp=HyperParams(batch_size=B_DP, metrics_to_calculate=METRICS), **KW)
    cases["dp"] = {**weights, "config": dp_cfg.to_json(),
                   "coarse": torch.from_numpy(
                       rng.standard_normal((1, B_DP, 7, 16, 16)).astype(np.float32)),
                   "fine": torch.from_numpy(
                       rng.standard_normal((1, B_DP, 2, 128, 128)).astype(np.float32)),
                   "alphas": torch.rand((1, B_DP, 1, 1, 1), generator=g)}
    # the cotangent of the sharded generator's output for its parameter gradients
    arrays["gen_r"] = rng.standard_normal((B, 128, 128, 2)).astype(np.float32)
    cases["generator"]["r"] = nchw(arrays["gen_r"])
    return cases, arrays


def spawn_ranks(tmp, cases, device):
    """Every case on the four ranks on ``device``; each rank's results."""
    torch.save(cases, tmp / "cases.pt")
    dp_worker.spawn(worker.spatial_cases, (WORLD, str(tmp / "store"), str(tmp), device), WORLD)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(WORLD)]


def unsharded(cases, device):
    """The port's unsharded generator forward and the parameter gradients
    of the same scalar of it, critic scores, GP and GP gradients, and the
    plain steps, on ``device``."""
    cfg, state = worker.load_state(cases["generator"], device)
    crit = {k: cases["critic"][k].to(device) for k in ("real", "fake", "alpha")}
    fine = state.generator(cases["generator"]["coarse"].to(device))
    (fine * cases["generator"]["r"].to(device)).sum().backward()
    out = {"generator": fine.detach().cpu(), "gen_grads": worker.gradients(state.generator)}
    with torch.no_grad():
        out["scores"] = state.critic(crit["real"]).cpu()
    gp = gradient_penalty(state.critic, crit["real"], crit["fake"], crit["alpha"])
    gp.backward()
    out.update(gp=gp.detach().cpu(), gp_grads=worker.gradients(state.critic))
    for name in ("step", "step_noise_flips", "dp"):
        out[name] = worker.step_case(cases[name], lambda c, st: build_train_step(
            c, st.generator, st.critic), device)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on the four ranks, and the references: JAX's in this
    process and the port's unsharded ones."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from downgan_tpu.parallel import spatial as jax_spatial
    from downgan_tpu.parallel.mesh import make_mesh
    from downgan_tpu.training.wgan import gradient_penalty as jax_gradient_penalty

    from _torch_parity import jax_alpha, paired_states, port_weights_of

    def spatial_mesh(n):
        return make_mesh((n,), ("spatial",), devices=jax.devices()[:n])

    jcfg, cfg = jax_config(), port_config()
    jgen, jcritic, jstate, state = paired_states(jcfg, cfg)
    weights = {"config": cfg.to_json(), "generator": state.generator.state_dict(),
               "critic": state.critic.state_dict()}
    jrng = jax.random.PRNGKey(5)
    cases, a = make_cases(weights, np.random.default_rng(0),
                          torch.from_numpy(jax_alpha(jrng, 0, B)))
    want = {"jax": {}}
    real, fake, alpha = (jnp.asarray(a[k]) for k in ("real", "fake", "alpha"))
    for s in SHARDS:
        mesh = spatial_mesh(s)
        want["jax"][f"conv_{s}"] = np.asarray(jax_spatial.make_sharded_conv(mesh)(
            *(jnp.asarray(a[k]) for k in ("x_conv", "kernel", "bias"))))
        g_apply = jax_spatial.sharded_generator_apply(jcfg, mesh)
        want["jax"][f"generator_{s}"] = np.asarray(g_apply(jstate.g_params,
                                                           jnp.asarray(a["coarse"])))
        g_grads = jax.jit(jax.grad(lambda p: jnp.sum(
            g_apply(p, jnp.asarray(a["coarse"])) * jnp.asarray(a["gen_r"]))))(jstate.g_params)
        want["jax"][f"gen_grads_{s}"] = port_weights_of(cfg, g_grads, jstate.c_params)[0]
        c_apply = jax_spatial.sharded_critic_apply(jcfg, mesh)
        want["jax"][f"scores_{s}"] = np.asarray(c_apply(jstate.c_params, real))
        gp, grads = jax.jit(jax.value_and_grad(
            lambda p: jax_gradient_penalty(c_apply, p, real, fake, alpha)))(jstate.c_params)
        want["jax"][f"gp_{s}"] = float(gp)
        want["jax"][f"gp_grads_{s}"] = port_weights_of(cfg, jstate.g_params, grads)[1]
    want["jax"]["generator"] = np.asarray(jax.jit(jgen.apply)(jstate.g_params,
                                                              jnp.asarray(a["coarse"])))
    # one reference step: the JAX spatial step on a 2-device mesh
    jstep = jax_spatial.build_spatial_train_step(jcfg, spatial_mesh(2), with_metrics=True)
    js, jm = jstep(jstate, jnp.asarray(a["step_coarse"]), jnp.asarray(a["step_fine"]), jrng)
    want["jax"]["step_metrics"] = {k: float(v) for k, v in jm.items()}
    want["jax"]["step_weights"] = port_weights_of(cfg, js.g_params, js.c_params)
    want.update(unsharded(cases, "cpu"))
    ranks = spawn_ranks(tmp_path_factory.mktemp("spatial"), cases, "cpu")
    return {"cases": cases, "ranks": ranks, "want": want}


def each_rank(runs, key):
    return [(r, rank[key]) for r, rank in enumerate(runs["ranks"])]


# -- the collectives ------------------------------------------------------------------

@pytest.mark.parametrize("shards", SHARDS)
def test_halo_bands_are_the_fields_rows(runs, shards):
    """Each rank's band at k = 1 and 5, zero-filled at the domain's edges
    and clipped there: the whole field's rows, bit for bit."""
    x = runs["cases"]["halo"]["x"]
    h = 16 // shards
    for r, got in each_rank(runs, f"halo_{shards}"):
        index = r % shards
        for k in (1, DRB_HALO):
            padded = torch.nn.functional.pad(x, (0, 0, k, k))
            assert torch.equal(got[f"band_k{k}"], padded[:, :, index * h:(index + 1) * h + 2 * k])
        lo, hi = band_rows(shards, index, h, DRB_HALO)
        assert torch.equal(got["clipped_k5"], x[:, :, lo:hi])


@pytest.mark.parametrize("shards", SHARDS)
def test_halo_gradient_and_double_gradient(runs, shards):
    """A scalar of every rank's 5-row band: its value, its gradient in the
    whole field (the adjoint returns each halo row's cotangent to its
    owner) and the gradient of that gradient (the adjoint's own backward)
    equal the unsharded autograd's in float64, on every rank."""
    loss, grad, grad2 = halo_reference(runs["cases"]["halo"], shards)
    for _, got in each_rank(runs, f"halo_{shards}"):
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-12)
        np.testing.assert_allclose(got["grad"], grad, atol=F64_ATOL)
        np.testing.assert_allclose(got["grad2"], grad2, atol=F64_ATOL)


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_conv_matches_jax_and_the_unsharded_conv(runs, shards):
    case = runs["cases"]["conv"]
    x, w, b = (case[k].clone() for k in ("x", "weight", "bias"))
    want = torch.nn.functional.conv2d(x, w, b, padding=1)
    xg, wg = x.requires_grad_(True), w.requires_grad_(True)
    loss = (torch.tanh(torch.nn.functional.conv2d(xg, wg, b, padding=1)) * case["r"]).sum()
    (gx,) = torch.autograd.grad(loss, xg, create_graph=True)
    gx2, gw2 = torch.autograd.grad(gx.square().sum(), (xg, wg))
    jax_y = nchw(runs["want"]["jax"][f"conv_{shards}"])
    for _, got in each_rank(runs, f"conv_{shards}"):
        np.testing.assert_allclose(got["y"], jax_y, atol=CONV_ATOL)
        np.testing.assert_allclose(got["y"], want, atol=CONV_ATOL)
        for name, ref in (("gx", gx.detach()), ("gx2", gx2), ("gw2", gw2)):
            err = (got[name] - ref).abs().max() / ref.abs().max()
            assert err <= CONV_GRAD_REL, (name, float(err))


@pytest.mark.parametrize("shards", SHARDS)
def test_row_sharded_linear_takes_its_rows_nchw_columns(runs, shards):
    """Each rank's rows meet the weight's columns (C, H, W)[:, r0:r1] of the
    NCHW flatten; the weight gradient summed over the shards is the whole
    one, the bias's (taken after the row sum) is not summed."""
    case = runs["cases"]["linear"]
    linear = torch.nn.Linear(4 * 8 * 6, 5)
    linear.load_state_dict(case["linear"])
    y = linear(case["x"].flatten(1))
    (y * case["r"]).sum().backward()
    for _, got in each_rank(runs, f"linear_{shards}"):
        np.testing.assert_allclose(got["y"], y.detach(), atol=1e-5)
        np.testing.assert_allclose(got["weight_grad"], linear.weight.grad, atol=1e-5)
        np.testing.assert_allclose(got["bias_grad"], linear.bias.grad, atol=1e-6)


def test_band_and_crop_drb_is_the_whole_block():
    """The sharded DRB's geometry on the CPU twin: a shard's rows plus a
    5-row halo, clipped at the domain's edges, through the block, cropped
    back to the shard's rows, equal the whole field's block bit for bit
    (the twin sums each pixel's terms alike wherever the band starts; one process;
    the kernel's leg is in tests/test_torch_drb.py). 16 rows over 4 shards
    is 4 rows a shard: bands of 9, 13 and 13 and 9 rows."""
    torch.manual_seed(0)
    block = DenseResidualBlock(8)
    x = torch.randn(2, 8, 16, 12)
    weights, biases = block.stage_params()
    with torch.no_grad():
        whole = drb_forward_reference(x, weights, biases)
        for shards in SHARDS:
            h = 16 // shards
            for index in range(shards):
                lo, hi = band_rows(shards, index, h, DRB_HALO)
                top = index * h - lo
                got = block(x[:, :, lo:hi].contiguous())[:, :, top:top + h]
                assert torch.equal(got, whole[:, :, index * h:(index + 1) * h]), (shards, index)


# -- the sharded networks ---------------------------------------------------------------

@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_generator_matches_jax_and_the_unsharded_one(runs, shards):
    want = runs["want"]
    for _, got in each_rank(runs, f"generator_{shards}"):
        np.testing.assert_allclose(got["fine"], nchw(want["jax"][f"generator_{shards}"]),
                                   atol=GEN_ATOL)
        np.testing.assert_allclose(got["fine"], nchw(want["jax"]["generator"]), atol=GEN_ATOL)
        np.testing.assert_allclose(got["fine"], want["generator"], atol=GEN_ATOL)


def assert_gradients_close(got, want, rel):
    """Every tensor of ``got`` within ``rel`` of the largest entry of its
    counterpart in ``want`` (1 where that is all zeros)."""
    assert set(got) == set(want)
    for k, g in want.items():
        scale = g.abs().max() if g.any() else 1.0
        err = (got[k] - g).abs().max() / scale
        assert err <= rel, (k, float(err))


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_generator_parameter_gradients(runs, shards):
    """The parameter gradients of a scalar of the sharded generator's output
    (each DRB's backward over its band, the halos' adjoints returning the
    halo rows' share to their owners, the gather's backward), summed over
    the shards by SpatialSync's rule, against the unsharded generator's and
    JAX's through its sharded apply: no tensor off by a factor of S, 1/S or
    a lost halo share."""
    want = runs["want"]
    for _, got in each_rank(runs, f"generator_{shards}"):
        for ref in (want["gen_grads"], want["jax"][f"gen_grads_{shards}"]):
            assert_gradients_close(got["grads"], ref, GEN_GRAD_REL)


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_critic_and_gp_match_jax(runs, shards):
    """Scores and the GP through the sharded critic against the JAX sharded
    critic and the port's unsharded one; every rank holds the same."""
    want = runs["want"]
    for _, got in each_rank(runs, f"critic_{shards}"):
        np.testing.assert_allclose(got["scores"], want["jax"][f"scores_{shards}"],
                                   atol=SCORE_ATOL, rtol=SCORE_RTOL)
        np.testing.assert_allclose(got["scores"], want["scores"], atol=SCORE_ATOL,
                                   rtol=SCORE_RTOL)
        assert float(got["gp"]) == pytest.approx(want["jax"][f"gp_{shards}"], rel=GP_RTOL)
        assert float(got["gp"]) == pytest.approx(float(want["gp"]), rel=GP_RTOL)


@pytest.mark.parametrize("shards", SHARDS)
def test_gp_parameter_gradients_through_the_collectives(runs, shards):
    """The GP's double backward through scatter, halos and the row sum,
    summed over the shards by SpatialSync's rule, against the unsharded
    critic's and JAX's gradients through its sharded critic: no tensor off
    by a factor of S or 1/S."""
    want = runs["want"]
    for _, got in each_rank(runs, f"critic_{shards}"):
        # a bias that only shifts a LeakyReLU's input has no GP gradient
        for ref in (want["gp_grads"], want["jax"][f"gp_grads_{shards}"]):
            assert_gradients_close(got["grads"], ref, GP_GRAD_REL)


# -- the train steps ----------------------------------------------------------------

def test_spatial_step_matches_jax_and_the_plain_step(runs):
    """One reference step (a critic update, a generator update, the metric
    pass) sharded over 2 ranks, against the JAX spatial step on a 2-device
    mesh and the port's plain step: losses to 1e-3 relative, every
    parameter to 5e-5."""
    jm = runs["want"]["jax"]["step_metrics"]
    j_gen, j_critic = runs["want"]["jax"]["step_weights"]
    plain = runs["want"]["step"]
    for _, got in each_rank(runs, "step"):
        (metrics,) = got["metrics"]
        assert set(metrics) == set(jm) == {"critic_loss", "gen_loss", *METRICS}
        for k in ("critic_loss", "gen_loss"):
            assert float(metrics[k]) == pytest.approx(jm[k], rel=LOSS_RTOL), k
            assert float(metrics[k]) == pytest.approx(float(plain["metrics"][0][k]),
                                                      rel=LOSS_RTOL), k
        assert got["step"] == 1 and got["forwards"] == {"critic_fake": 1, "update": 1, "metric": 1}
        for part, ref in (("generator", j_gen), ("critic", j_critic),
                          ("generator", plain["generator"]), ("critic", plain["critic"])):
            for k, v in ref.items():
                np.testing.assert_allclose(got[part][k], v, atol=PARAM_ATOL, err_msg=k)


# The ranks that share a step's updates: each spatial group of the grid for
# the 2-shard steps, all four for DP x spatial, each data group for the DP
# step. Two groups that run the same case apart are separate computations
# (on the card cuDNN's weight-gradient algorithms need not give them the
# same bits).
COUPLED = {"step": [(0, 1), (2, 3)], "step_noise_flips": [(0, 1), (2, 3)],
           "dp_spatial": [(0, 1, 2, 3)], "dp": [(0, 2), (1, 3)]}


def assert_ranks_agree(ranks, name):
    """The weights and metrics of ``name`` are the same bits on every rank
    of each group that shares its updates."""
    for group in COUPLED[name]:
        first = ranks[group[0]][name]
        for got in (ranks[r][name] for r in group[1:]):
            for part in ("generator", "critic"):
                assert all(torch.equal(v, got[part][k]) for k, v in first[part].items()), \
                    (name, group, part)
            for m0, m1 in zip(first["metrics"], got["metrics"], strict=True):
                assert all(torch.equal(v, m1[k]) for k, v in m0.items()), (name, group)


@pytest.mark.parametrize("name", list(COUPLED))
def test_ranks_agree_bit_for_bit(runs, name):
    assert_ranks_agree(runs["ranks"], name)


def test_spatial_step_with_latents_and_flips(runs):
    """A stochastic generator (2 latent channels) and flips: the latents and
    masks are drawn for the whole fields outside the sharded networks, so
    every metric equals the plain step's to 1e-4 relative."""
    plain = runs["want"]["step_noise_flips"]
    for _, got in each_rank(runs, "step_noise_flips"):
        for k, v in plain["metrics"][0].items():
            assert float(got["metrics"][0][k]) == pytest.approx(float(v), rel=METRIC_RTOL), k
        for k, v in plain["critic"].items():
            np.testing.assert_allclose(got["critic"][k], v, atol=PARAM_ATOL, err_msg=k)


def test_dp_spatial_step_matches_the_dp_step(runs):
    """The 2 x 2 grid (batch over the data groups, rows over the spatial
    groups) against 2-rank data parallelism on the same global batch of 8,
    one step: the JAX test's bounds (metrics 1e-4, critic 5e-5, the
    generator's Adam sign flips rare and within 2 * lr); and against one
    process's plain step to 1e-3 in the metrics."""
    plain = runs["want"]["dp"]
    for r, got in each_rank(runs, "dp_spatial"):
        want = runs["ranks"][r]["dp"]
        for k, v in want["metrics"][0].items():
            assert float(got["metrics"][0][k]) == pytest.approx(float(v), rel=METRIC_RTOL), k
            assert float(got["metrics"][0][k]) == pytest.approx(
                float(plain["metrics"][0][k]), rel=LOSS_RTOL), k
        for k, v in want["critic"].items():
            np.testing.assert_allclose(got["critic"][k], v, atol=PARAM_ATOL, err_msg=k)
        n_big = n_tot = 0
        for k, v in want["generator"].items():
            d = (got["generator"][k] - v).abs()
            assert float(d.max()) <= ADAM_FLIP_ATOL, k
            n_big += int((d > PARAM_ATOL).sum())
            n_tot += d.numel()
        assert n_big / n_tot < FLIP_SHARE, (n_big, n_tot)


# -- refusals -------------------------------------------------------------------------

@pytest.mark.parametrize("what,match", [
    ("critic_conditional", "NotImplementedError: the spatially-sharded train step supports "
                           "the reference's unconditional critic only"),
    ("srresnet_apply", "ValueError: spatial sharding runs the RRDB generator only"),
    ("srresnet_module", "ValueError: spatial sharding runs the RRDB generator only"),
    ("fine_size", r"ValueError: the sharded critic needs fine_size/16 = 2 divisible by the 4"),
    ("odd_local_rows", "ValueError: stride-2 sharded conv needs an even local H, got 3"),
    ("rows_not_divisible", "ValueError: a field of 6 rows does not split over 4"),
])
def test_refusals(runs, what, match):
    for _, got in each_rank(runs, "refusals"):
        assert got[what] is not None and got[what].startswith(match), got[what]


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: four gloo ranks share it")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda:0"


# On the card cuDNN picks its algorithms by shape, so a shard's convs and the
# whole field's sum in other orders: the generator is held to GEN_ATOL, its
# parameter gradients and the GP's to 1e-3 of each tensor's largest entry
# (chip_smoke.py's SP_GRAD_REL), and a step's weights to chip_smoke.py's card
# tolerances (2 * lr per update at worst, the median element within 1e-5).
CARD_GRAD_REL, CARD_ADAM_ATOL, CARD_MEDIAN_ATOL = 1e-3, 2 * 2.5e-4, 1e-5


@pytest.mark.cuda
def test_cuda_four_gloo_ranks_share_the_card(cuda_device, tmp_path):
    """Every case on four gloo ranks sharing the card, the sharded DRBs on
    the kernel over halo-extended bands, against the port's unsharded
    networks and plain steps on the card; the ranks bit for bit."""
    cfg = port_config()
    state = make_train_state(cfg, "cpu")
    weights = {"config": cfg.to_json(), "generator": state.generator.state_dict(),
               "critic": state.critic.state_dict()}
    cases, _ = make_cases(weights, np.random.default_rng(0), torch.full((B, 1, 1, 1), 0.4))
    ranks = spawn_ranks(tmp_path, cases, cuda_device)
    want = unsharded(cases, cuda_device)
    for got in ranks:
        for s in SHARDS:
            assert (got[f"generator_{s}"]["fine"] - want["generator"]).abs().max() <= GEN_ATOL
            assert_gradients_close(got[f"generator_{s}"]["grads"], want["gen_grads"],
                                   CARD_GRAD_REL)
            crit = got[f"critic_{s}"]
            torch.testing.assert_close(crit["scores"], want["scores"], atol=SCORE_ATOL,
                                       rtol=SCORE_RTOL)
            assert float(crit["gp"]) == pytest.approx(float(want["gp"]), rel=GP_RTOL)
            assert_gradients_close(crit["grads"], want["gp_grads"], CARD_GRAD_REL)
    for name in ("step", "step_noise_flips", "dp_spatial"):
        assert_ranks_agree(ranks, name)
        plain = want["dp" if name == "dp_spatial" else name]
        for part in ("generator", "critic"):
            diff = torch.cat([(ranks[0][name][part][k] - v).abs().flatten()
                              for k, v in plain[part].items()])
            assert diff.max() <= CARD_ADAM_ATOL and diff.median() <= CARD_MEDIAN_ATOL, (name, part)
