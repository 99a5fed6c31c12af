"""WGAN-GP train step and fused n-critic round (counterpart of
``downgan_tpu/training/wgan.py``: ``gradient_penalty``,
``_critic_pair_means``, the reference branch of ``make_loss_fns``,
``g_updates_in_window``, ``build_train_step``, ``build_fused_round`` and
``build_eval_metrics``, and ``_ema_update``).

Reference schedule, per batch, as ``wgan.py:313-440``:
  1. a critic update on every step, on a fake made without a graph (the
     JAX ``stop_gradient``): loss = E[C(fake)] - E[C(real)] + w_gp * GP;
  2. a generator update when ``step % critic_iterations == 0``, step 0
     included, against the post-update critic:
     loss = -gamma * E[C(fake)] + content_lambda * L1(fake, fine);
  3. a metric pass (MAE/MSE/MSSSIM/Wass) scored by the post-update critic
     on a fresh fake from the post-update generator (the test pass's
     :func:`build_eval_metrics` on the training batch) or, under
     ``hp.metrics_reuse_fake``, on the critic update's fake, which the
     pre-update generator made (no third generator forward).
Fused schedule (``hp.schedule = "fused"``, ``wgan.py:443-582``): one round
is ``critic_iterations`` critic updates on distinct minibatches, then one
generator update on the last of them against the post-update critic, then
the metric pass on that minibatch (:func:`build_fused_round`).
After a generator update the EMA generator, when there is one, moves
toward the new weights (:func:`ema_update`, ``wgan.py:290-295,397``).
Under ``hp.fused_critic_pass`` every pair of independent critic forwards
(real and fake, in the loss and in the metric pass) runs as one
concatenated 2B forward (:func:`critic_pair_means`).
Metrics come back as device scalars; nothing in the step waits for the
card. The GP's per-sample alpha is :func:`gp_alpha` of ``(config.seed,
step)``, or passed in: the JAX package draws it from ``fold_in(rng,
step)``, a stream torch cannot reproduce, so parity tests inject it.

A stochastic generator (``config.noise_channels = k > 0``,
``wgan.py:77-108``) takes k channels of N(0, 1) latent after the
covariates. Training draws a fresh latent for every generator forward:
:func:`train_latent` of ``(config.seed, step, stream)``, one stream per
forward of the step (the critic update's fake, the generator update, the
metric pass's fresh fake), so a resumed run draws what an uninterrupted one
would have. These are the port's own streams, not the JAX package's
threefry draws; parity tests pass the JAX latents in (``latents=``). The
test pass scores one fixed realization, :func:`fixed_latent` of
``config.seed``, drawn on the host, so the card and the CPU score the same
latent. With ``noise_channels = 0`` no latent is drawn or appended.

The training variants (``wgan.py:111-295`` of the JAX package):
- ``critic_conditional``: every critic input is the fine field with the
  nearest-upsampled covariates appended (:func:`make_condition`), in the
  critic update, the generator loss and the metric pass's Wass;
- ``freq_sep``: the critic update scores high-pass residuals and the
  generator's content loss compares low-pass bands (:func:`split_bands`);
- ``divergence_lambda``, ``vorticity_lambda``, ``eof_lambda``: physics
  and EOF-projection terms of the generator loss; the EOF term needs the
  basis fit from the training fine fields (``eof_components``);
- ``grad_accum = k``: each update's batch runs as k equal microbatches,
  each with its own GP, alpha slice and physics std; the gradients are
  averaged (backward of loss / k, each microbatch's graph freed before the
  next is built) and each optimizer steps once;
- ``augment_flips``: the step mirrors each (coarse, fine) pair by the
  masks :func:`flip_masks` of ``(config.seed, step)`` (or ``flips=``)
  before anything else reads the batch.
Data parallelism (``parallel/dp.py``): both builders take ``sync``, the
ranks' agreement. In one process it is :data:`LOCAL_SYNC`, rank 0 of 1,
and changes nothing. Across ranks each rank runs the step on its
contiguous rows of the global batch; every update's gradients are averaged
across the ranks once, after its last microbatch's backward and before the
optimizer steps (``sync.gradients``), and the step's metrics are the
ranks' mean (``sync.metrics``). Per-sample randomness follows its sample,
not its rank: the GP's alphas, the flip masks and the latents are drawn for
the global batch from ``(seed, step, ...)`` and each rank takes its rows
(:func:`rank_rows`), and ``alpha``/``alphas``/``latents``/``flips`` given
to a step are for the global batch too. Statistics of the whole batch
are the global batch's: the metric pass scores the fields of every rank's
rows (``sync.gather``), so MS-SSIM's min-max normalization and RALSD's
mean spectrum see the global batch, and the physics terms divide by the
std over every rank's rows (``sync.std``, differentiable; under
``grad_accum``, over microbatch i of every rank). So a run's numbers do not
depend on how many ranks share its batch beyond rounding, as in the JAX
package, where the key is replicated and GSPMD shards the draw and the
reductions.
Spans (``utils/profiling.py::annotate``, on only under a profiler): each
call of a step or round is ``train.call``; inside it each critic update's
fake is ``critic.fake``, each update ``critic.update`` /
``generator.update`` with its microbatches' ``*.loss`` (the GP's
``create_graph`` gradient included) and ``*.backward`` (the GP's double
backward included) and its optimizer step ``*.adam`` (the EMA update
included), and the metric pass, a fresh fake included, ``metric.pass``.
``hp.fused_epoch`` and ``hp.remat`` only shape the JAX package's XLA
program (one ``lax.scan`` per epoch; activation rematerialization) and
leave the math alone, so the port accepts and ignores them; its DRB
backward recomputes its block from the input in any case.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from downgan_tpu_torch.config.config import Config
from downgan_tpu_torch.models.layers import upsample_nearest
from downgan_tpu_torch.ops.augment import make_augment
from downgan_tpu_torch.ops.losses import (
    content_loss,
    divergence_loss,
    eof_loss,
    low_pass,
    population_std,
    vorticity_loss,
    wass_loss,
)
from downgan_tpu_torch.ops.metrics import resolve_metrics
from downgan_tpu_torch.training.state import GANTrainState
from downgan_tpu_torch.utils.profiling import annotate

Metrics = Dict[str, torch.Tensor]


class LocalSync:
    """The agreement of a lone process: rank 0 of 1, gradients and metrics
    left as they are, its rows the whole batch. ``parallel.dp.GroupSync`` is
    the one across ranks."""

    rank, world = 0, 1

    def gradients(self, params: Sequence[torch.Tensor]) -> None:
        """Average ``params``' gradients across the ranks (here: nothing)."""

    def metrics(self, metrics: Metrics) -> Metrics:
        """The ranks' mean of each metric (here: ``metrics`` itself)."""
        return metrics

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        """Every rank's rows in rank order: the global batch (here: ``rows``)."""
        return rows

    def std(self, x: torch.Tensor) -> torch.Tensor:
        """The population std of ``x``'s elements over every rank."""
        return population_std(x)


LOCAL_SYNC = LocalSync()


def rank_rows(draw: torch.Tensor, sync, axis: int = 0) -> torch.Tensor:
    """``sync``'s rank's contiguous rows of ``draw``, a draw for the global
    batch along ``axis``; all of it at world size 1."""
    if sync.world == 1:
        return draw
    n = draw.shape[axis] // sync.world
    return draw.narrow(axis, sync.rank * n, n)


def gradient_penalty(critic: nn.Module, real: torch.Tensor, fake: torch.Tensor,
                     alpha: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Mean squared deviation of the critic's input-gradient norm from 1,
    at ``alpha * real + (1 - alpha) * fake`` with per-sample alpha
    (B, 1, 1, 1); the norms carry the eps=1e-12 sqrt guard. The input
    gradient keeps its graph (``create_graph=True``), so the penalty is
    differentiable in the critic's parameters: a double backward, whose
    weight terms the critic's convs take on the weight-gradient route
    (``models/layers.py::critic_conv2d``, counted in its
    ``double_backwards``)."""
    interp = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(critic(interp).sum(), interp, create_graph=True)
    norms = torch.sqrt(grads.flatten(1).square().sum(dim=1) + eps)
    return (norms - 1.0).square().mean()


def make_condition(config: Config) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``condition(x, coarse) -> critic input``: ``x`` itself for the
    reference's unconditional critic or, under ``critic_conditional``, ``x``
    with the covariates ``coarse`` nearest-upsampled to the fine grid
    appended as channels. Real and fake share the condition, so the GP's
    interpolation keeps it fixed."""
    if not config.critic_conditional:
        return lambda x, coarse: x
    factor = config.fine_size // config.coarse_size
    if factor * config.coarse_size != config.fine_size:
        raise ValueError("critic_conditional requires fine_size to be an integer multiple of "
                         f"coarse_size (got {config.fine_size}/{config.coarse_size})")

    def condition(x: torch.Tensor, coarse: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, upsample_nearest(coarse, factor).to(x.dtype)], dim=1)

    return condition


def split_bands(config: Config, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(low, high) bands of ``x`` for ``freq_sep``: the ``hp.filter_size``
    low-pass and the residual."""
    lo = low_pass(x, config.hp.filter_size)
    return lo, x - lo


def critic_pair_means(critic: nn.Module, a: torch.Tensor, b: torch.Tensor,
                      fused: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E[C(a)], E[C(b)]) for two equal-size batches; with ``fused``
    (``hp.fused_critic_pass``) as one forward over their concatenation.
    Per-sample math is the same either way."""
    if fused:
        out = critic(torch.cat([a, b]))
        return out[:a.shape[0]].mean(), out[a.shape[0]:].mean()
    return critic(a).mean(), critic(b).mean()


def critic_loss(config: Config, critic: nn.Module, fake: torch.Tensor, real: torch.Tensor,
                alpha: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, E[C(real)], E[C(fake)]) with loss = E[C(fake)] - E[C(real)]
    + effective_gp_weight * GP (100 under ``double_gp_lambda``)."""
    c_real, c_fake = critic_pair_means(critic, real, fake, config.hp.fused_critic_pass)
    gp = gradient_penalty(critic, real, fake, alpha)
    return c_fake - c_real + config.hp.effective_gp_weight * gp, c_real, c_fake


def generator_loss(config: Config, gen: nn.Module, critic: nn.Module, coarse: torch.Tensor,
                   fine: torch.Tensor, eof_components: Optional[torch.Tensor] = None,
                   std=population_std) -> torch.Tensor:
    """-gamma * E[C(G(coarse))] + content_lambda * L1(G(coarse), fine);
    ``coarse`` is the generator's whole input (latent included), and the
    conditional critic sees its covariates only. Under ``freq_sep`` the
    critic scores the fake's high band and the L1 compares the low bands.
    Plus ``divergence_lambda``, ``vorticity_lambda`` and ``eof_lambda``
    times their terms on the whole fake, each normalized by ``std`` (the
    batch's population std; the global batch's across ranks);
    ``eof_components`` is the basis :func:`eof_basis` made."""
    hp = config.hp
    condition = make_condition(config)
    cov = coarse[:, :config.n_covariates]
    fake = gen(coarse)
    if hp.freq_sep:
        fake_low, fake_high = split_bands(config, fake)
        real_low, _ = split_bands(config, fine)
        loss = (-critic(condition(fake_high, cov)).mean() * hp.gamma
                + hp.content_lambda * content_loss(fake_low, real_low))
    else:
        loss = (-critic(condition(fake, cov)).mean() * hp.gamma
                + hp.content_lambda * content_loss(fake, fine))
    if hp.divergence_lambda:
        loss = loss + hp.divergence_lambda * divergence_loss(fine, fake, std)
    if hp.vorticity_lambda:
        loss = loss + hp.vorticity_lambda * vorticity_loss(fine, fake, std)
    if hp.eof_lambda:
        loss = loss + hp.eof_lambda * eof_loss(eof_components, fine, fake, std)
    return loss


def eof_basis(config: Config, eof_components, device: torch.device) -> Optional[torch.Tensor]:
    """The leading ``hp.ncomp`` components of ``eof_components`` ((>= ncomp,
    C, H*W) or (>= ncomp, H*W), numpy or tensor) as fp32 on ``device`` when
    ``hp.eof_lambda > 0``, else None; raises when the term is on and no
    components are given."""
    if not config.hp.eof_lambda:
        return None
    if eof_components is None:
        raise ValueError("hp.eof_lambda > 0 requires eof_components (fit them from the "
                         "training fine fields with data.eof.fit_eofs_per_channel)")
    return torch.as_tensor(eof_components)[:config.hp.ncomp].to(device, torch.float32)


def _device_rng(entropy: Tuple[int, ...], device: torch.device) -> torch.Generator:
    seed = int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def gp_alpha(seed: int, step: int, batch: int, device: torch.device) -> torch.Tensor:
    """The GP's per-sample alpha (batch, 1, 1, 1), U[0, 1), at ``step``:
    drawn from a generator on ``device`` seeded from ``(seed, step)``, so
    it is a pure function of the two, like the JAX package's
    ``fold_in(rng, step)``, and a resumed run draws what an uninterrupted
    one would have."""
    return torch.rand((batch, 1, 1, 1), generator=_device_rng((seed, step), device),
                      device=device)


_FLIP_TAG = 3  # keeps the flip stream apart from gp_alpha's and the latents'


def flip_masks(seed: int, step: int, batch: int,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``augment_flips``' per-sample (lon, lat) bool masks (batch,) at
    ``step``, each true with probability 1/2: drawn on ``device`` from a
    generator seeded from ``(seed, step, tag)``, a pure function of the
    two, as :func:`gp_alpha`. So a resumed run flips what an uninterrupted
    one would have, and nothing is copied from the host."""
    draws = torch.rand((2, batch), generator=_device_rng((seed, step, _FLIP_TAG), device),
                       device=device)
    lon, lat = draws < 0.5
    return lon, lat


# The generator forwards of a step that draw a training latent, by stream
# (the JAX package folds 0, 1, 2 into the step's noise key, wgan.py:366-429).
LATENT_STREAMS = ("critic_fake", "update", "metric")
_LATENT_TAG = 2  # keeps the latent streams apart from gp_alpha's (seed, step)
FIXED_LATENT_TAG = 0x5E11  # the JAX package's fixed-realization tag (eval_noise_rng, spatial.py)


def train_latent(config: Config, step: int, stream: str, coarse: torch.Tensor,
                 sync=LOCAL_SYNC) -> Optional[torch.Tensor]:
    """The training latent (B, k, h, w) for ``coarse`` (B, C, h, w) of the
    generator forward ``stream`` (one of :data:`LATENT_STREAMS`) at
    ``step``, N(0, 1) in ``coarse``'s dtype, drawn on ``coarse``'s device
    from a generator seeded from ``(config.seed, step, stream)``: a pure
    function of the three. Under data parallelism ``coarse`` is a rank's
    rows: the latent is drawn for the global batch and the rank takes its
    rows. None for a deterministic generator."""
    k = config.noise_channels
    if not k:
        return None
    b, _, h, w = coarse.shape
    rng = _device_rng((config.seed, step, _LATENT_TAG, LATENT_STREAMS.index(stream)),
                      coarse.device)
    z = torch.randn((b * sync.world, k, h, w), generator=rng, device=coarse.device,
                    dtype=coarse.dtype)
    return rank_rows(z, sync)


def fixed_latent(config: Config, shape: Tuple[int, int, int, int]) -> np.ndarray:
    """The fixed latent realization of evaluation and serving, NHWC
    ``shape`` (b, h, w, k) float32 on the host:
    ``np.random.default_rng((config.seed, 0x5E11)).standard_normal(shape)``.
    A draw of b rows is the first b rows of any larger draw, so every batch
    size sees the same realization row by row. The whole-domain latent of
    the tiler is this draw at the domain's shape, as in the JAX package."""
    z = np.random.default_rng((config.seed, FIXED_LATENT_TAG)).standard_normal(shape)
    return z.astype(np.float32)


def with_latent(coarse: torch.Tensor, z: Optional[torch.Tensor]) -> torch.Tensor:
    """The generator input: ``coarse`` with the latent ``z`` appended as
    channels, or ``coarse`` itself when there is no latent."""
    return coarse if z is None else torch.cat([coarse, z.to(coarse.dtype)], dim=1)


@torch.no_grad()
def ema_update(decay: float, ema: nn.Module, params: Sequence[torch.Tensor]) -> None:
    """``e = decay * e + (1 - decay) * p`` over ``ema``'s parameters, in
    place, as two foreach passes: in-place writes bump the version
    counters, so the EMA generator's DRB blocks repack their weights."""
    ema_params = list(ema.parameters())
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, list(params), alpha=1.0 - decay)


def g_updates_in_window(start_step: int, n_steps: int, critic_iterations: int) -> int:
    """Generator updates the reference schedule performs over steps
    ``[start_step, start_step + n_steps)``: the steps where
    ``step % critic_iterations == 0``, global step 0 included."""
    if n_steps <= 0:
        return 0
    n = critic_iterations
    first = -(-start_step // n) * n  # first multiple of n >= start_step
    last = (start_step + n_steps - 1) // n * n
    return max(0, (last - first) // n + 1)


def build_metric_pass(config: Config, sync=LOCAL_SYNC) -> Callable[..., Metrics]:
    """``score(critic, fake, fine, coarse)``: the metric registry on
    ``fake`` against ``fine``, and Wass from the critic on the conditioned
    pair (its two forwards fused under ``hp.fused_critic_pass``; ``coarse``,
    the covariates, is read only by a conditional critic); no update, no
    graph. Across ``sync``'s ranks the registry scores the global batch
    (every rank's rows of ``fake`` and ``fine``, the same values on every
    rank) and Wass this rank's rows."""
    names = config.hp.metrics_to_calculate
    fns = resolve_metrics(names)
    fused = config.hp.fused_critic_pass
    condition = make_condition(config)

    @torch.no_grad()
    def score(critic: nn.Module, fake: torch.Tensor, fine: torch.Tensor,
              coarse: torch.Tensor) -> Metrics:
        whole_fine, whole_fake = sync.gather(fine), sync.gather(fake)
        out = {name: fn(whole_fine, whole_fake) for name, fn in fns.items()}
        if "Wass" in names:
            out["Wass"] = wass_loss(*critic_pair_means(critic, condition(fine, coarse),
                                                       condition(fake, coarse), fused))
        return out

    return score


def build_eval_metrics(config: Config) -> Callable[..., Metrics]:
    """Test-set metric pass for one batch, ``eval_metrics(gen, critic,
    coarse, fine, latent=None)``: :func:`build_metric_pass` on G(coarse).
    A stochastic generator scores the fixed realization: the first B rows
    of :func:`fixed_latent`, drawn once per batch shape and device and
    kept there, or ``latent`` (B, k, h, w) when given."""
    score = build_metric_pass(config)
    fixed: Dict[tuple, torch.Tensor] = {}

    def eval_latent(coarse: torch.Tensor) -> Optional[torch.Tensor]:
        if not config.noise_channels:
            return None
        b, _, h, w = coarse.shape
        key = (b, h, w, coarse.device)
        if key not in fixed:
            z = fixed_latent(config, (b, h, w, config.noise_channels))
            fixed[key] = torch.from_numpy(z).permute(0, 3, 1, 2).contiguous().to(coarse.device)
        return fixed[key]

    @torch.no_grad()
    def eval_metrics(gen: nn.Module, critic: nn.Module, coarse: torch.Tensor,
                     fine: torch.Tensor, latent: Optional[torch.Tensor] = None) -> Metrics:
        z = eval_latent(coarse) if latent is None else latent
        return score(critic, gen(with_latent(coarse, z)), fine, coarse)

    return eval_metrics


def _check_modules(state: GANTrainState, gen: nn.Module, critic: nn.Module) -> None:
    # A spatially sharded network (parallel/spatial.py) wraps the state's as .module.
    if (getattr(gen, "module", gen) is not state.generator
            or getattr(critic, "module", critic) is not state.critic):
        raise ValueError("this step was built for other modules than the state's")


def _microbatches(k: int, *tensors: torch.Tensor):
    """The ``k`` equal microbatches of each tensor's leading axis, zipped."""
    b = tensors[0].shape[0]
    if b % k:
        raise ValueError(f"batch {b} does not divide into grad_accum={k} microbatches")
    return zip(*(t.chunk(k) for t in tensors))


def _accumulate(k: int, loss_of: Callable[..., Tuple[torch.Tensor, ...]], microbatches,
                params: Sequence[torch.Tensor], spans: Tuple[str, str],
                sync=LOCAL_SYNC) -> Tuple[torch.Tensor, ...]:
    """Backward of each microbatch's (loss, *aux) = ``loss_of(*microbatch)``
    into ``params``' gradients, scaled by 1/k, each graph freed before the
    next microbatch is built, then the gradients averaged across the ranks
    once (``sync.gradients``); returns the detached means of (loss, *aux)
    over this rank's microbatches. ``spans`` names each microbatch's loss
    and backward spans."""
    loss_span, backward_span = spans
    totals = None
    for mb in microbatches:
        with annotate(loss_span):
            out = loss_of(*mb)
        with annotate(backward_span):
            (out[0] / k).backward(inputs=params)
        out = [t.detach() for t in out]
        totals = out if totals is None else [a + b for a, b in zip(totals, out)]
    sync.gradients(params)
    return tuple(t / k for t in totals)


def critic_update(config: Config, state: GANTrainState, critic: nn.Module,
                  c_params: Sequence[torch.Tensor], fake: torch.Tensor, real: torch.Tensor,
                  alpha: torch.Tensor, sync=LOCAL_SYNC
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One critic update on the critic inputs ``fake`` (made without a
    graph) and ``real``, over ``hp.grad_accum`` microbatches, its gradients
    averaged across ``sync``'s ranks; returns the detached (loss,
    E[C(real)], E[C(fake)]) of this rank's rows."""
    k = config.hp.grad_accum
    with annotate("critic.update"):
        state.c_opt.zero_grad(set_to_none=True)
        out = _accumulate(k, lambda f, r, a: critic_loss(config, critic, f, r, a),
                          _microbatches(k, fake, real, alpha), c_params,
                          ("critic.loss", "critic.backward"), sync)
        with annotate("critic.adam"):
            state.c_opt.step()
    return out


def generator_update(config: Config, state: GANTrainState, gen: nn.Module, critic: nn.Module,
                     g_params: Sequence[torch.Tensor], coarse: torch.Tensor,
                     fine: torch.Tensor, eof: Optional[torch.Tensor],
                     sync=LOCAL_SYNC) -> torch.Tensor:
    """One generator update against the current critic, over
    ``hp.grad_accum`` microbatches, its gradients averaged across
    ``sync``'s ranks, then the EMA update; returns the detached loss of this
    rank's rows."""
    k = config.hp.grad_accum
    with annotate("generator.update"):
        state.g_opt.zero_grad(set_to_none=True)
        (g_loss,) = _accumulate(
            k, lambda c, f: (generator_loss(config, gen, critic, c, f, eof, sync.std),),
            _microbatches(k, coarse, fine), g_params, ("generator.loss", "generator.backward"),
            sync)
        with annotate("generator.adam"):
            state.g_opt.step()
            if state.g_ema is not None:
                ema_update(config.hp.ema_decay, state.g_ema, g_params)
    return g_loss


def critic_inputs(config: Config, condition, fake: torch.Tensor, fine: torch.Tensor,
                  coarse: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The critic update's (fake, real) inputs: high bands under
    ``freq_sep``, conditioned on ``coarse`` under ``critic_conditional``."""
    if config.hp.freq_sep:
        fake, fine = split_bands(config, fake)[1], split_bands(config, fine)[1]
    return condition(fake, coarse), condition(fine, coarse)


def build_train_step(config: Config, gen: nn.Module, critic: nn.Module,
                     eof_components=None, sync=LOCAL_SYNC) -> Callable[..., Metrics]:
    """The reference-schedule train step over ``gen`` and ``critic``:
    ``step(state, coarse, fine, alpha=None, latents=None, flips=None) ->
    metrics``, where ``state`` is the :class:`GANTrainState` holding these
    two modules; it updates both networks and ``state.step`` in place.
    ``eof_components`` is the EOF basis the ``eof_lambda`` term needs
    (:func:`eof_basis`).

    Under ``augment_flips`` the pair is first flipped by the masks
    :func:`flip_masks` of ``(config.seed, state.step)``, or ``flips`` (lon,
    lat), each (B,) bool. ``alpha`` (B, 1, 1, 1) is, when omitted,
    :func:`gp_alpha` of ``(config.seed, state.step)``. A stochastic
    generator's three latents are :func:`train_latent` of ``(config.seed,
    state.step, stream)``, or ``latents[stream]`` (B, k, h, w) for each
    stream of :data:`LATENT_STREAMS` the step runs. ``step.forwards``
    counts the generator forwards it runs, by kind: ``critic_fake``,
    ``update`` and ``metric`` (a generator update runs ``hp.grad_accum``
    forwards, one a microbatch).

    ``sync`` is the ranks' agreement (module docstring; ``step.sync``):
    under data parallelism ``coarse`` and ``fine`` are this rank's rows,
    and ``alpha``, ``latents`` and ``flips`` stay the global batch's.
    """
    hp = config.hp
    score = build_metric_pass(config, sync)
    condition = make_condition(config)
    augment = make_augment(config) if hp.augment_flips else None
    g_params = [p for p in gen.parameters()]
    c_params = [p for p in critic.parameters()]
    eof = eof_basis(config, eof_components, g_params[0].device)
    forwards = {"critic_fake": 0, "update": 0, "metric": 0}

    def step(state: GANTrainState, coarse: torch.Tensor, fine: torch.Tensor,
             alpha: Optional[torch.Tensor] = None,
             latents: Optional[Mapping[str, torch.Tensor]] = None,
             flips: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> Metrics:
        _check_modules(state, gen, critic)
        with annotate("train.call"):
            at_step = state.step
            global_b = fine.shape[0] * sync.world
            if augment is not None:
                if flips is None:
                    flips = flip_masks(config.seed, at_step, global_b, fine.device)
                coarse, fine = augment(coarse, fine, *(rank_rows(m, sync) for m in flips))
            if alpha is None:
                alpha = gp_alpha(config.seed, at_step, global_b, fine.device)
            alpha = rank_rows(alpha, sync)

            def g_input(stream: str) -> torch.Tensor:
                z = train_latent(config, at_step, stream, coarse, sync) if latents is None \
                    else rank_rows(latents[stream], sync)
                return with_latent(coarse, z)

            # ---- critic update; no gradient reaches the generator
            with torch.no_grad(), annotate("critic.fake"):
                fake = gen(g_input("critic_fake"))
            forwards["critic_fake"] += 1
            c_loss, c_real, c_fake = critic_update(
                config, state, critic, c_params,
                *critic_inputs(config, condition, fake, fine, coarse), alpha, sync)

            # ---- generator update on the reference schedule, post-update critic
            if state.step % hp.critic_iterations == 0:
                g_loss = generator_update(config, state, gen, critic, g_params,
                                          g_input("update"), fine, eof, sync)
                forwards["update"] += hp.grad_accum
            else:
                g_loss = torch.zeros((), device=fine.device)
            state.step += 1

            metrics = {"critic_loss": c_loss, "gen_loss": g_loss,
                       "Wass": wass_loss(c_real, c_fake)}
            # The post-update critic scores a fresh fake from the post-update
            # generator (reference mlflow_epoch.py:53-63) or, under
            # metrics_reuse_fake, the critic update's fake (made from its latent).
            with annotate("metric.pass"):
                if not hp.metrics_reuse_fake:
                    with torch.no_grad():
                        fake = gen(g_input("metric"))
                    forwards["metric"] += 1
                metrics.update(score(critic, fake, fine, coarse))
            return sync.metrics(metrics)

    step.forwards = forwards
    step.sync = sync
    return step


def build_fused_round(config: Config, gen: nn.Module, critic: nn.Module,
                      eof_components=None, sync=LOCAL_SYNC) -> Callable[..., Metrics]:
    """The fused n-critic round over ``gen`` and ``critic`` (``wgan.py:443-
    582``): ``fused_round(state, coarse_n, fine_n, alphas=None,
    latents=None, flips=None) -> metrics`` with inputs (n, B, C, h, w) and
    (n, B, P, H, W), n = ``hp.critic_iterations``. Under ``augment_flips``
    the round's (n B) pairs are first flipped, one decision per sample, by
    :func:`flip_masks` of ``(config.seed, state.step)`` at the round's
    starting step, or ``flips`` (lon, lat), each (n B,) bool. It runs n
    critic updates on the n minibatches in order, update i with alpha
    :func:`gp_alpha` of ``(config.seed, state.step + i)`` (or
    ``alphas[i]``), each on a fake from the round's starting generator;
    then one generator update on the last minibatch against the
    post-update critic, and the EMA update. ``state.step`` advances by n.
    ``eof_components`` as :func:`build_train_step`'s.

    A stochastic generator's latents: critic update i's fake takes
    :func:`train_latent` at step ``state.step + i``, stream
    ``critic_fake``; the generator update and the metric pass's fresh fake
    take streams ``update`` and ``metric`` at the step the round ends on
    (the JAX round folds 2, 3 and 4 into the same steps' keys). Given,
    ``latents["critic_fake"]`` is (n, B, k, h, w) and ``latents["update"]``
    and ``latents["metric"]`` are (B, k, h, w).

    Metrics: ``critic_loss`` the mean over the n updates, ``Wass`` from
    the means of their n real and n fake scores, ``gen_loss`` the one
    update's; the metric pass scores the last minibatch, on the last
    critic update's fake under ``hp.metrics_reuse_fake`` (made before the
    generator update), else on a fresh fake from the updated generator.
    ``fused_round.forwards`` counts the generator forwards by kind, as
    :func:`build_train_step`'s, and so is ``sync``: under data parallelism
    the stacks hold this rank's rows on their axis 1, and ``alphas``,
    ``latents`` and ``flips`` stay the global batch's (the flips (n B_global,)
    in (n, B_global) order)."""
    hp = config.hp
    score = build_metric_pass(config, sync)
    condition = make_condition(config)
    augment = make_augment(config) if hp.augment_flips else None
    g_params = [p for p in gen.parameters()]
    c_params = [p for p in critic.parameters()]
    eof = eof_basis(config, eof_components, g_params[0].device)
    forwards = {"critic_fake": 0, "update": 0, "metric": 0}

    def fused_round(state: GANTrainState, coarse_n: torch.Tensor, fine_n: torch.Tensor,
                    alphas: Optional[torch.Tensor] = None,
                    latents: Optional[Mapping[str, torch.Tensor]] = None,
                    flips: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> Metrics:
        _check_modules(state, gen, critic)
        n = coarse_n.shape[0]
        if n != hp.critic_iterations:
            raise ValueError(f"a fused round takes critic_iterations={hp.critic_iterations} "
                             f"minibatches, got {n}")
        with annotate("train.call"):
            global_b = coarse_n.shape[1] * sync.world
            if augment is not None:
                nb = n * coarse_n.shape[1]
                if flips is None:
                    flips = flip_masks(config.seed, state.step, n * global_b, fine_n.device)
                c2, f2 = augment(coarse_n.reshape(nb, *coarse_n.shape[2:]),
                                 fine_n.reshape(nb, *fine_n.shape[2:]),
                                 *(rank_rows(m.reshape(n, global_b), sync, axis=1).reshape(nb)
                                   for m in flips))
                coarse_n, fine_n = c2.reshape(coarse_n.shape), f2.reshape(fine_n.shape)

            def g_input(stream: str, coarse: torch.Tensor,
                        i: Optional[int] = None) -> torch.Tensor:
                if latents is None:
                    z = train_latent(config, state.step, stream, coarse, sync)
                else:
                    z = rank_rows(latents[stream] if i is None else latents[stream][i], sync)
                return with_latent(coarse, z)

            losses, reals, fakes = [], [], []
            for i in range(n):
                coarse, fine = coarse_n[i], fine_n[i]
                alpha = rank_rows(gp_alpha(config.seed, state.step, global_b, fine.device)
                                  if alphas is None else alphas[i], sync)
                with torch.no_grad(), annotate("critic.fake"):
                    fake = gen(g_input("critic_fake", coarse, i))
                forwards["critic_fake"] += 1
                c_loss, c_real, c_fake = critic_update(
                    config, state, critic, c_params,
                    *critic_inputs(config, condition, fake, fine, coarse), alpha, sync)
                losses.append(c_loss)
                reals.append(c_real)
                fakes.append(c_fake)
                state.step += 1

            g_loss = generator_update(config, state, gen, critic, g_params,
                                      g_input("update", coarse), fine, eof, sync)
            forwards["update"] += hp.grad_accum
            metrics = {"critic_loss": torch.stack(losses).mean(), "gen_loss": g_loss,
                       "Wass": wass_loss(torch.stack(reals).mean(), torch.stack(fakes).mean())}
            with annotate("metric.pass"):
                if not hp.metrics_reuse_fake:
                    with torch.no_grad():
                        fake = gen(g_input("metric", coarse))
                    forwards["metric"] += 1
                metrics.update(score(critic, fake, fine, coarse))
            return sync.metrics(metrics)

    fused_round.forwards = forwards
    fused_round.sync = sync
    return fused_round
