"""WGAN-GP train step, reference schedule (counterpart of
``downgan_tpu/training/wgan.py``: ``gradient_penalty``, the reference
branch of ``make_loss_fns``, ``g_updates_in_window``, ``build_train_step``
and ``build_eval_metrics``, and ``_ema_update``).

Per batch, as ``wgan.py:313-440``:
  1. a critic update on every step, on a fake made without a graph (the
     JAX ``stop_gradient``): loss = E[C(fake)] - E[C(real)] + w_gp * GP;
  2. a generator update when ``step % critic_iterations == 0``, step 0
     included, against the post-update critic:
     loss = -gamma * E[C(fake)] + content_lambda * L1(fake, fine);
  3. a metric pass (MAE/MSE/MSSSIM/Wass) on a fresh fake from the
     post-update generator and the post-update critic: the test pass's
     :func:`build_eval_metrics` on the training batch.
After a generator update the EMA generator, when there is one, moves
toward the new weights (:func:`ema_update`, ``wgan.py:290-295,397``).
Metrics come back as device scalars; nothing in the step waits for the
card. The GP's per-sample alpha is :func:`gp_alpha` of ``(config.seed,
step)``, or passed in: the JAX package draws it from ``fold_in(rng,
step)``, a stream torch cannot reproduce, so parity tests inject it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from downgan_tpu_torch.config.config import Config
from downgan_tpu_torch.ops.losses import content_loss, wass_loss
from downgan_tpu_torch.ops.metrics import resolve_metrics
from downgan_tpu_torch.training.state import GANTrainState, check_training_ported

Metrics = Dict[str, torch.Tensor]


def gradient_penalty(critic: nn.Module, real: torch.Tensor, fake: torch.Tensor,
                     alpha: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Mean squared deviation of the critic's input-gradient norm from 1,
    at ``alpha * real + (1 - alpha) * fake`` with per-sample alpha
    (B, 1, 1, 1); the norms carry the eps=1e-12 sqrt guard. The input
    gradient keeps its graph (``create_graph=True``), so the penalty is
    differentiable in the critic's parameters: a double backward."""
    interp = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(critic(interp).sum(), interp, create_graph=True)
    norms = torch.sqrt(grads.flatten(1).square().sum(dim=1) + eps)
    return (norms - 1.0).square().mean()


def critic_loss(config: Config, critic: nn.Module, fake: torch.Tensor, real: torch.Tensor,
                alpha: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, E[C(real)], E[C(fake)]) with loss = E[C(fake)] - E[C(real)]
    + effective_gp_weight * GP (100 under ``double_gp_lambda``)."""
    c_real, c_fake = critic(real).mean(), critic(fake).mean()
    gp = gradient_penalty(critic, real, fake, alpha)
    return c_fake - c_real + config.hp.effective_gp_weight * gp, c_real, c_fake


def generator_loss(config: Config, gen: nn.Module, critic: nn.Module, coarse: torch.Tensor,
                   fine: torch.Tensor) -> torch.Tensor:
    """-gamma * E[C(G(coarse))] + content_lambda * L1(G(coarse), fine)."""
    fake = gen(coarse)
    hp = config.hp
    return -critic(fake).mean() * hp.gamma + hp.content_lambda * content_loss(fake, fine)


def gp_alpha(seed: int, step: int, batch: int, device: torch.device) -> torch.Tensor:
    """The GP's per-sample alpha (batch, 1, 1, 1), U[0, 1), at ``step``:
    drawn from a generator on ``device`` seeded from ``(seed, step)``, so
    it is a pure function of the two, like the JAX package's
    ``fold_in(rng, step)``, and a resumed run draws what an uninterrupted
    one would have."""
    step_seed = int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0])
    rng = torch.Generator(device=device).manual_seed(step_seed)
    return torch.rand((batch, 1, 1, 1), generator=rng, device=device)


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


def build_eval_metrics(config: Config) -> Callable[[nn.Module, nn.Module, torch.Tensor,
                                                     torch.Tensor], Metrics]:
    """Test-set metric pass for one batch, ``eval_metrics(gen, critic,
    coarse, fine)``: the metric registry on G(coarse) against fine, and
    Wass from the critic; no update, no graph."""
    names = config.hp.metrics_to_calculate
    fns = resolve_metrics(names)

    @torch.no_grad()
    def eval_metrics(gen: nn.Module, critic: nn.Module, coarse: torch.Tensor,
                     fine: torch.Tensor) -> Metrics:
        fake = gen(coarse)
        out = {name: fn(fine, fake) for name, fn in fns.items()}
        if "Wass" in names:
            out["Wass"] = wass_loss(critic(fine).mean(), critic(fake).mean())
        return out

    return eval_metrics


def build_train_step(config: Config, gen: nn.Module,
                     critic: nn.Module) -> Callable[..., Metrics]:
    """The train step over ``gen`` and ``critic``:
    ``step(state, coarse, fine, alpha=None) -> metrics``, where ``state``
    is the :class:`GANTrainState` holding these two modules; it updates
    both networks and ``state.step`` in place.

    ``alpha`` (B, 1, 1, 1) is, when omitted, :func:`gp_alpha` of
    ``(config.seed, state.step)``. ``step.forwards`` counts
    the generator forwards it runs, by kind: ``critic_fake``, ``update``
    and ``metric``.
    """
    check_training_ported(config)
    hp = config.hp
    eval_metrics = build_eval_metrics(config)
    g_params = [p for p in gen.parameters()]
    c_params = [p for p in critic.parameters()]
    forwards = {"critic_fake": 0, "update": 0, "metric": 0}

    def step(state: GANTrainState, coarse: torch.Tensor, fine: torch.Tensor,
             alpha: Optional[torch.Tensor] = None) -> Metrics:
        if state.generator is not gen or state.critic is not critic:
            raise ValueError("this step was built for other modules than the state's")
        if alpha is None:
            alpha = gp_alpha(config.seed, state.step, fine.shape[0], fine.device)

        # ---- critic update; no gradient reaches the generator
        with torch.no_grad():
            fake = gen(coarse)
        forwards["critic_fake"] += 1
        state.c_opt.zero_grad(set_to_none=True)
        c_loss, c_real, c_fake = critic_loss(config, critic, fake, fine, alpha)
        c_loss.backward(inputs=c_params)
        state.c_opt.step()

        # ---- generator update on the reference schedule, post-update critic
        if state.step % hp.critic_iterations == 0:
            state.g_opt.zero_grad(set_to_none=True)
            g_loss = generator_loss(config, gen, critic, coarse, fine)
            forwards["update"] += 1
            g_loss.backward(inputs=g_params)
            state.g_opt.step()
            if state.g_ema is not None:
                ema_update(hp.ema_decay, state.g_ema, g_params)
            g_loss = g_loss.detach()
        else:
            g_loss = torch.zeros((), device=fine.device)
        state.step += 1

        metrics = {"critic_loss": c_loss.detach(), "gen_loss": g_loss,
                   "Wass": wass_loss(c_real, c_fake).detach()}
        # A fresh fake from the post-update generator, scored by the
        # post-update critic (reference mlflow_epoch.py:53-63).
        metrics.update(eval_metrics(gen, critic, coarse, fine))
        forwards["metric"] += 1
        return metrics

    step.forwards = forwards
    return step
