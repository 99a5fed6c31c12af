"""Model, optimizer and train-state construction (counterpart of
``downgan_tpu/training/state.py``).

The JAX package threads one immutable pytree through a pure step; here the
state is the two ``nn.Module``s, their two ``torch.optim.Adam``s, the step
counter and the EMA generator, updated in place by the step
(``training/wgan.py``), and saved whole by :meth:`GANTrainState.state_dict`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import torch
from torch import nn

from downgan_tpu_torch.config.config import Config
from downgan_tpu_torch.models.critic import Critic
from downgan_tpu_torch.models.generator import ESRGANGenerator, Generator, SRResNetGenerator
from downgan_tpu_torch.models.layers import init_torch_default_, torch_dtype

# The critic draws from its own stream, so the generator's weights are the
# same whether or not a critic is made.
CRITIC_SEED_OFFSET = 1


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. Entry points default to
    ``"cuda"``; without a card that raises unless the caller asked for the
    CPU, so a run never lands on the CPU by accident."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def make_generator(config: Config, device: str | torch.device = "cuda",
                   rng: Optional[torch.Generator] = None) -> nn.Module:
    """The generator of ``config.generator_arch`` (the RRDB
    :class:`Generator`, the :class:`ESRGANGenerator`, fp32 only, or the
    :class:`SRResNetGenerator`) for ``config``,
    in eval mode on ``device``, computing in ``config.hp.compute_dtype``
    (fp32 parameters, as the JAX package's ``make_models``), taking
    ``config.generator_in_channels`` inputs (the covariates, then
    ``noise_channels`` latent channels), its weights drawn from ``rng``
    (default: a generator seeded with ``config.seed``) by torch's
    default-init distribution."""
    if config.noise_channels < 0:
        raise ValueError(f"noise_channels must be >= 0, got {config.noise_channels}")
    archs = {"rrdb": Generator, "esrgan": ESRGANGenerator, "srresnet": SRResNetGenerator}
    if config.generator_arch not in archs:
        raise ValueError(f"unknown generator_arch {config.generator_arch!r}")
    dev = resolve_device(device)
    gen = archs[config.generator_arch](
        filters=config.filters, in_channels=config.generator_in_channels,
        n_predictands=config.n_predictands, num_res_blocks=config.num_res_blocks,
        num_upsample=config.num_upsample, compute_dtype=torch_dtype(config.hp.compute_dtype))
    if rng is None:
        rng = torch.Generator().manual_seed(config.seed)
    init_torch_default_(gen, rng)
    return gen.to(dev).eval()


def load_generator(config: Config, weights: Mapping[str, torch.Tensor],
                   device: str | torch.device = "cuda") -> nn.Module:
    """:func:`make_generator` with ``weights`` (a state dict of the
    config's architecture, e.g. from
    ``utils.port_weights.load_generator_weights``) loaded ``strict=True``."""
    gen = make_generator(config, device)
    gen.load_state_dict(weights, strict=True)
    return gen


def make_critic(config: Config, device: str | torch.device = "cuda",
                rng: Optional[torch.Generator] = None) -> Critic:
    """The critic for ``config`` on ``device``, computing in
    ``config.hp.compute_dtype``, its weights drawn from
    ``rng`` (default: a generator seeded with ``config.seed`` plus
    :data:`CRITIC_SEED_OFFSET`) by torch's default-init distribution. A
    conditional critic (``config.critic_conditional``) takes
    ``config.critic_in_channels`` inputs: the fine field and the
    upsampled covariates."""
    dev = resolve_device(device)
    critic = Critic(base=config.filters, fine_size=config.fine_size,
                    in_channels=config.critic_in_channels,
                    compute_dtype=torch_dtype(config.hp.compute_dtype))
    if rng is None:
        rng = torch.Generator().manual_seed(config.seed + CRITIC_SEED_OFFSET)
    init_torch_default_(critic, rng)
    return critic.to(dev)


def lr_schedule_fn(hp) -> Callable[[int], float]:
    """The learning rate as a function of a network's optimizer-update
    count, from the ``hp`` knobs (the JAX package's ``lr_schedule_fn``,
    ``state.py:68-92``, in float64 without optax): constant (the
    reference's), constant after ``lr_warmup_steps`` of linear warmup from
    0, or a cosine or linear decay from ``lr`` to ``lr * lr_final_factor``.
    The cosine's ``lr_decay_steps`` counts the warmup too (optax's
    ``warmup_cosine_decay_schedule``); the linear decay runs over
    ``lr_decay_steps - lr_warmup_steps`` updates after the warmup. Both
    hold the end value past the decay."""
    lr, warmup, decay_steps = hp.lr, hp.lr_warmup_steps, hp.lr_decay_steps
    end = lr * hp.lr_final_factor

    def after_warmup(t: int) -> float:  # t counts updates since the warmup
        if hp.lr_schedule == "constant":
            return lr
        span = decay_steps - warmup
        frac = min(t, span) / span
        if hp.lr_schedule == "cosine":
            alpha = 0.0 if lr == 0.0 else end / lr
            return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)
        return (lr - end) * (1.0 - frac) + end

    def schedule(count: int) -> float:
        return lr * count / warmup if count < warmup else after_warmup(count - warmup)

    return schedule


class ScheduledAdam(torch.optim.Adam):
    """``torch.optim.Adam`` whose learning rate follows ``schedule`` of the
    update count. The count is read from the Adam state's ``step`` (a CPU
    tensor under foreach Adam, so no sync) before the update increments it,
    as optax evaluates its schedule at the count before the update: a
    network's first update runs at ``schedule(0)``, which is 0 under a
    warmup. Each network counts its own updates, and a checkpoint's Adam
    state carries the count, so a resume continues the schedule exactly."""

    def __init__(self, params, schedule: Callable[[int], float], **kwargs):
        super().__init__(params, lr=schedule(0), **kwargs)
        self.schedule = schedule

    def step(self, closure=None):
        for group in self.param_groups:
            count = next((int(self.state[p]["step"]) for p in group["params"]
                          if "step" in self.state.get(p, {})), 0)
            group["lr"] = self.schedule(count)
        return super().step(closure)


def make_optimizer(config: Config, module: torch.nn.Module) -> torch.optim.Adam:
    """Adam(lr, betas=(beta1, beta2), eps=1e-8) over ``module``'s
    parameters, as the JAX package's ``optax.adam`` (reference
    ``stage.py:63-64``). The two updates are the same algebra:
    ``lr * m / (1 - b1^t) / (sqrt(v) / sqrt(1 - b2^t) + eps)`` in torch is
    ``lr * m_hat / (sqrt(v_hat) + eps)`` in optax. It is a
    :class:`ScheduledAdam` over :func:`lr_schedule_fn`, which is ``lr`` at
    every count under the reference's constant schedule.

    The foreach implementation, on every device: one launch per update
    over all tensors. Never the fused one: it writes the parameters without
    bumping their version counters, which the generator's DRB blocks read
    to know when to repack their weights for the kernel. (Pinning only
    ``fused=False`` would fall back to the single-tensor loop.)"""
    hp = config.hp
    return ScheduledAdam(module.parameters(), lr_schedule_fn(hp),
                         betas=(hp.beta1, hp.beta2), eps=1e-8, foreach=True, fused=False)


def make_ema_generator(config: Config, gen: nn.Module) -> nn.Module:
    """A copy of ``gen``'s weights on its device, out of autograd: the EMA
    generator (the JAX package's ``g_ema = tree.map(copy, g_params)``).
    A fresh module, so its DRB blocks keep their own packed-weight cache."""
    ema = make_generator(config, next(gen.parameters()).device)
    ema.load_state_dict(gen.state_dict())
    return ema.requires_grad_(False)


@dataclass
class GANTrainState:
    """Both networks, their optimizers, the step counter (the reference's
    ``num_steps``) and the EMA generator (``hp.ema_decay > 0``, else None);
    the train step advances ``step`` by one.

    :meth:`state_dict` is everything a resume needs: the GP's alphas and
    a stochastic generator's training latents are functions of
    ``(config.seed, step)`` (``training/wgan.py::gp_alpha``,
    ``train_latent``), so the step carries their streams."""

    step: int
    generator: nn.Module
    critic: Critic
    g_opt: torch.optim.Adam
    c_opt: torch.optim.Adam
    g_ema: Optional[nn.Module] = None

    def state_dict(self) -> dict:
        """Tensors, numbers and nested dicts and lists only (no module), so
        ``torch.load(weights_only=True)`` reads it back. The DRB blocks'
        packed weights are derived and not in it."""
        return {"step": self.step,
                "generator": self.generator.state_dict(),
                "critic": self.critic.state_dict(),
                "g_opt": self.g_opt.state_dict(),
                "c_opt": self.c_opt.state_dict(),
                "g_ema": None if self.g_ema is None else self.g_ema.state_dict()}

    def load_state_dict(self, sd: Mapping) -> None:
        """Copy ``sd`` (from :meth:`state_dict`, on any device) into this
        state in place. Parameters are written with ``copy_``, which bumps
        their version counters, so the DRB blocks repack their weights; the
        optimizers keep the saved ``foreach``/``fused`` choice and Adam's
        ``step`` stays a CPU tensor, as foreach Adam keeps it."""
        if (sd["g_ema"] is None) != (self.g_ema is None):
            have = "has" if sd["g_ema"] is not None else "has no"
            raise ValueError(f"the checkpoint {have} EMA generator, this state's "
                             "hp.ema_decay says otherwise")
        self.generator.load_state_dict(sd["generator"])
        self.critic.load_state_dict(sd["critic"])
        self.g_opt.load_state_dict(sd["g_opt"])
        self.c_opt.load_state_dict(sd["c_opt"])
        if self.g_ema is not None:
            self.g_ema.load_state_dict(sd["g_ema"])
        self.step = int(sd["step"])


def make_train_state(config: Config, device: str | torch.device = "cuda") -> GANTrainState:
    """Seeded generator and critic on ``device``, each with its Adam, at
    step 0, and the EMA copy of the generator when ``hp.ema_decay > 0``.
    Both networks are left in train mode."""
    gen = make_generator(config, device).train()
    critic = make_critic(config, device).train()
    return GANTrainState(step=0, generator=gen, critic=critic,
                         g_opt=make_optimizer(config, gen), c_opt=make_optimizer(config, critic),
                         g_ema=make_ema_generator(config, gen) if config.hp.ema_decay else None)
