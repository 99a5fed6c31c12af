"""Losses of the WGAN-GP step (counterpart of ``downgan_tpu/ops/losses.py``,
lines 21-36). Pure functions of tensors that return device scalars, so the
trainer accumulates them on the device. The physics losses (divergence,
vorticity, EOF) and the frequency-separation filters come with a later
slice of the port."""
from __future__ import annotations

import torch


def wass_loss(c_real_mean: torch.Tensor, c_fake_mean: torch.Tensor) -> torch.Tensor:
    """Wasserstein distance estimate: E[C(real)] - E[C(fake)]."""
    return c_real_mean - c_fake_mean


def content_loss(hr: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """Pixel-wise L1 (the MAE metric)."""
    return (hr - fake).abs().mean()


def content_mse_loss(hr: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """Pixel-wise MSE (the MSE metric)."""
    return (hr - fake).square().mean()
