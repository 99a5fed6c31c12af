"""Losses of the WGAN-GP step (counterpart of ``downgan_tpu/ops/losses.py``).
Pure functions of NCHW tensors that return device scalars, so the trainer
accumulates them on the device. Channel 0 is u and channel 1 is v; dim 2
is lat (y) and dim 3 is lon (x).

Every standard deviation here is the population one (``correction=0``), as
``jnp.std``: ``torch.std`` defaults to the unbiased one. The terms that
divide by one take its function as ``std``: under data parallelism the
train step passes the global batch's (``parallel/dp.py::global_std``).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F


def wass_loss(c_real_mean: torch.Tensor, c_fake_mean: torch.Tensor) -> torch.Tensor:
    """Wasserstein distance estimate: E[C(real)] - E[C(fake)]."""
    return c_real_mean - c_fake_mean


def content_loss(hr: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """Pixel-wise L1 (the MAE metric)."""
    return (hr - fake).abs().mean()


def content_mse_loss(hr: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """Pixel-wise MSE (the MSE metric)."""
    return (hr - fake).square().mean()


def _finite_differences(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """du/dy and dv/dx forward differences on the interior grid (regular
    grid, no spacing division), ``losses.py:39-48``."""
    dudy = x[:, 0, 1:, 1:] - x[:, 0, :-1, 1:]
    dvdx = x[:, 1, 1:, 1:] - x[:, 1, 1:, :-1]
    return dudy, dvdx


def population_std(x: torch.Tensor) -> torch.Tensor:
    """The population std of all of ``x``'s elements (``jnp.std``)."""
    return x.std(correction=0)


Std = Callable[[torch.Tensor], torch.Tensor]


def _normalized_mse(a: torch.Tensor, b: torch.Tensor, std: Std) -> torch.Tensor:
    """MSE between ``a`` and ``b``, each divided by its own std."""
    return (a / std(a) - b / std(b)).square().mean()


def divergence_loss(hr: torch.Tensor, fake: torch.Tensor,
                    std: Std = population_std) -> torch.Tensor:
    """MSE between std-normalized divergence fields (``losses.py:51-63``;
    golden value 0.0018 on the reference's Gaussian fixture)."""
    dudy_r, dvdx_r = _finite_differences(hr)
    dudy_f, dvdx_f = _finite_differences(fake)
    return _normalized_mse(dudy_r + dvdx_r, dudy_f + dvdx_f, std)


def vorticity_loss(hr: torch.Tensor, fake: torch.Tensor,
                   std: Std = population_std) -> torch.Tensor:
    """MSE between std-normalized vorticity fields (``losses.py:66-78``;
    golden value 0.00144)."""
    dudy_r, dvdx_r = _finite_differences(hr)
    dudy_f, dvdx_f = _finite_differences(fake)
    return _normalized_mse(dvdx_r - dudy_r, dvdx_f - dudy_f, std)


def eof_loss(components: torch.Tensor, hr: torch.Tensor, fake: torch.Tensor,
             std: Std = population_std) -> torch.Tensor:
    """MSE between std-normalized EOF projections of real and fake
    (``losses.py:81-101``). ``components`` is (n_comp, H*W), shared by
    every channel, or (n_comp, C, H*W); the fields are flattened over
    (H, W) row-major, as the JAX package flattens them."""
    b, c = hr.shape[:2]
    hr_flat, fake_flat = hr.reshape(b, c, -1), fake.reshape(b, c, -1)
    eq = "bcp,kp->bck" if components.ndim == 2 else "bcp,kcp->bck"
    proj_r = torch.einsum(eq, hr_flat, components)
    proj_f = torch.einsum(eq, fake_flat, components)
    return _normalized_mse(proj_f, proj_r, std)


def low_pass(x: torch.Tensor, filter_size: int = 5) -> torch.Tensor:
    """Replicate padding then a ``filter_size`` square mean with stride 1,
    shape-preserving: the frequency-separation trainer's low-pass band
    (``losses.py:104-118``)."""
    pad = filter_size // 2
    return F.avg_pool2d(F.pad(x, (pad, pad, pad, pad), mode="replicate"), filter_size, stride=1)


def high_pass(x: torch.Tensor, filter_size: int = 5) -> torch.Tensor:
    """The high-frequency residual ``x - low_pass(x)``."""
    return x - low_pass(x, filter_size)
