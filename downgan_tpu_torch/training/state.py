"""Model, optimizer and train-state construction (counterpart of
``downgan_tpu/training/state.py``).

The JAX package threads one immutable pytree through a pure step; here the
state is the two ``nn.Module``s, their two ``torch.optim.Adam``s, the step
counter and the EMA generator, updated in place by the step
(``training/wgan.py``), and saved whole by :meth:`GANTrainState.state_dict`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import torch
from torch import nn

from downgan_tpu_torch.config.config import Config
from downgan_tpu_torch.models.critic import Critic
from downgan_tpu_torch.models.generator import Generator, SRResNetGenerator
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
    :class:`Generator` or the :class:`SRResNetGenerator`) for ``config``,
    in eval mode on ``device``, computing in ``config.hp.compute_dtype``
    (fp32 parameters, as the JAX package's ``make_models``), taking
    ``config.generator_in_channels`` inputs (the covariates, then
    ``noise_channels`` latent channels), its weights drawn from ``rng``
    (default: a generator seeded with ``config.seed``) by torch's
    default-init distribution."""
    if config.noise_channels < 0:
        raise ValueError(f"noise_channels must be >= 0, got {config.noise_channels}")
    archs = {"rrdb": Generator, "srresnet": SRResNetGenerator}
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


def check_training_ported(config: Config) -> None:
    """Raise for every training option the port has not ported yet. What
    it runs: either generator family, deterministic or stochastic
    (``noise_channels``), on the reference and the fused schedule
    (``hp.schedule``) with constant-LR Adam, fp32 or bf16 compute
    (``hp.compute_dtype``), the critic on the fine field alone, the MAE/MSE/MSSSIM/Wass metric pass
    (on a fresh fake, or the critic update's under
    ``hp.metrics_reuse_fake``), the critic's two forwards as one
    (``hp.fused_critic_pass``) and the generator EMA (``hp.ema_decay``).

    ``hp.fused_epoch`` and ``hp.remat`` only shape the JAX package's XLA
    program (one ``lax.scan`` per epoch; activation rematerialization) and
    leave the math alone, so they are accepted and ignored; the port's
    DRB backward recomputes its block from the input in any case."""
    hp = config.hp
    unported = {
        "lr_schedule != 'constant'": hp.lr_schedule != "constant",
        "lr_warmup_steps": bool(hp.lr_warmup_steps),
        "grad_accum > 1": hp.grad_accum > 1,
        "freq_sep": hp.freq_sep,
        "critic_conditional": config.critic_conditional,
        "divergence_lambda": bool(hp.divergence_lambda),
        "vorticity_lambda": bool(hp.vorticity_lambda),
        "eof_lambda": bool(hp.eof_lambda),
        "augment_flips": hp.augment_flips,
    }
    for name, on in unported.items():
        if on:
            raise ValueError(f"{name} is not ported yet: it comes with a later slice of "
                             "the port's training")


def make_critic(config: Config, device: str | torch.device = "cuda",
                rng: Optional[torch.Generator] = None) -> Critic:
    """The critic for ``config`` on ``device``, computing in
    ``config.hp.compute_dtype``, its weights drawn from
    ``rng`` (default: a generator seeded with ``config.seed`` plus
    :data:`CRITIC_SEED_OFFSET`) by torch's default-init distribution."""
    check_training_ported(config)
    dev = resolve_device(device)
    critic = Critic(base=config.filters, fine_size=config.fine_size,
                    in_channels=config.critic_in_channels,
                    compute_dtype=torch_dtype(config.hp.compute_dtype))
    if rng is None:
        rng = torch.Generator().manual_seed(config.seed + CRITIC_SEED_OFFSET)
    init_torch_default_(critic, rng)
    return critic.to(dev)


def make_optimizer(config: Config, module: torch.nn.Module) -> torch.optim.Adam:
    """Adam(lr, betas=(beta1, beta2), eps=1e-8) over ``module``'s
    parameters, as the JAX package's ``optax.adam`` (reference
    ``stage.py:63-64``). The two updates are the same algebra:
    ``lr * m / (1 - b1^t) / (sqrt(v) / sqrt(1 - b2^t) + eps)`` in torch is
    ``lr * m_hat / (sqrt(v_hat) + eps)`` in optax.

    The foreach implementation, on every device: one launch per update
    over all tensors. Never the fused one: it writes the parameters without
    bumping their version counters, which the generator's DRB blocks read
    to know when to repack their weights for the kernel. (Pinning only
    ``fused=False`` would fall back to the single-tensor loop.)"""
    check_training_ported(config)
    hp = config.hp
    return torch.optim.Adam(module.parameters(), lr=hp.lr, betas=(hp.beta1, hp.beta2), eps=1e-8,
                            foreach=True, fused=False)


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
