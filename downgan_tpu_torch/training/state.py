"""Model, optimizer and train-state construction (counterpart of
``downgan_tpu/training/state.py``).

The JAX package threads one immutable pytree through a pure step; here the
state is the two ``nn.Module``s, their two ``torch.optim.Adam``s and the
step counter, updated in place by the step (``training/wgan.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import torch

from downgan_tpu_torch.config.config import Config
from downgan_tpu_torch.models.critic import Critic
from downgan_tpu_torch.models.generator import Generator
from downgan_tpu_torch.models.layers import init_torch_default_

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
                   rng: Optional[torch.Generator] = None) -> Generator:
    """The RRDB generator for ``config``, in eval mode on ``device``, its
    weights drawn from ``rng`` (default: a generator seeded with
    ``config.seed``) by torch's default-init distribution."""
    if config.generator_arch != "rrdb":
        raise ValueError(
            f"generator_arch={config.generator_arch!r} is not ported yet: the "
            "SRResNet generator comes with a later slice of the port")
    if config.noise_channels > 0:
        raise ValueError(
            "noise_channels > 0 (stochastic serving) is not ported yet: it "
            "comes with a later slice of the port")
    if config.hp.compute_dtype != "float32":
        raise ValueError(
            f"compute_dtype={config.hp.compute_dtype!r} is not ported yet: "
            "bf16 serving comes with a later slice of the port")
    dev = resolve_device(device)
    gen = Generator(filters=config.filters, in_channels=config.n_covariates,
                    n_predictands=config.n_predictands,
                    num_res_blocks=config.num_res_blocks,
                    num_upsample=config.num_upsample)
    if rng is None:
        rng = torch.Generator().manual_seed(config.seed)
    init_torch_default_(gen, rng)
    return gen.to(dev).eval()


def load_generator(config: Config, weights: Mapping[str, torch.Tensor],
                   device: str | torch.device = "cuda") -> Generator:
    """:func:`make_generator` with ``weights`` (a reference-layout state
    dict, e.g. from ``utils.port_weights.load_generator_weights``) loaded
    ``strict=True``."""
    gen = make_generator(config, device)
    gen.load_state_dict(weights, strict=True)
    return gen


def check_training_ported(config: Config) -> None:
    """Raise for every training option this slice has not ported: the
    reference schedule with constant-LR Adam, the critic on the fine field
    alone, and the MAE/MSE/MSSSIM/Wass metric pass are what it runs.

    ``hp.fused_epoch`` and ``hp.remat`` only shape the JAX package's XLA
    program (one ``lax.scan`` per epoch; activation rematerialization) and
    leave the math alone, so they are accepted and ignored; the port's
    DRB backward recomputes its block from the input in any case."""
    hp = config.hp
    unported = {
        "lr_schedule != 'constant'": hp.lr_schedule != "constant",
        "lr_warmup_steps": bool(hp.lr_warmup_steps),
        "ema_decay": bool(hp.ema_decay),
        "grad_accum > 1": hp.grad_accum > 1,
        "schedule='fused'": hp.schedule == "fused",
        "freq_sep": hp.freq_sep,
        "critic_conditional": config.critic_conditional,
        "divergence_lambda": bool(hp.divergence_lambda),
        "vorticity_lambda": bool(hp.vorticity_lambda),
        "eof_lambda": bool(hp.eof_lambda),
        "augment_flips": hp.augment_flips,
        "metrics_reuse_fake": hp.metrics_reuse_fake,
        "fused_critic_pass": hp.fused_critic_pass,
    }
    for name, on in unported.items():
        if on:
            raise ValueError(f"{name} is not ported yet: it comes with a later slice of "
                             "the port's training")


def make_critic(config: Config, device: str | torch.device = "cuda",
                rng: Optional[torch.Generator] = None) -> Critic:
    """The critic for ``config`` on ``device``, its weights drawn from
    ``rng`` (default: a generator seeded with ``config.seed`` plus
    :data:`CRITIC_SEED_OFFSET`) by torch's default-init distribution."""
    check_training_ported(config)
    dev = resolve_device(device)
    critic = Critic(base=config.filters, fine_size=config.fine_size,
                    in_channels=config.critic_in_channels)
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


@dataclass
class GANTrainState:
    """Both networks, their optimizers and the step counter (the reference's
    ``num_steps``); the train step advances ``step`` by one."""

    step: int
    generator: Generator
    critic: Critic
    g_opt: torch.optim.Adam
    c_opt: torch.optim.Adam


def make_train_state(config: Config, device: str | torch.device = "cuda") -> GANTrainState:
    """Seeded generator and critic on ``device``, each with its Adam, at
    step 0. Both modules are left in train mode."""
    gen = make_generator(config, device).train()
    critic = make_critic(config, device).train()
    return GANTrainState(step=0, generator=gen, critic=critic,
                         g_opt=make_optimizer(config, gen), c_opt=make_optimizer(config, critic))
