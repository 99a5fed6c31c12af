"""Model construction (counterpart of ``downgan_tpu/training/state.py``).

This slice ports the generator half of ``make_models``: the serving path
needs no critic, optimizer or train state.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from downgan_tpu_torch.config.config import Config
from downgan_tpu_torch.models.generator import Generator
from downgan_tpu_torch.models.layers import init_torch_default_


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
