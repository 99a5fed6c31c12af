"""Shared layer pieces for the port's models (counterpart of
``downgan_tpu/models/layers.py``).

The port runs NCHW, PyTorch's own layout, so the JAX package's explicit
padding and depth-to-space helpers become stock modules:

* a 3x3 conv is ``nn.Conv2d(kernel_size=3, padding=1)``, which pads (1, 1)
  like the JAX ``Conv3x3``;
* pixel shuffle is ``nn.PixelShuffle(2)``, whose channel order the JAX
  ``pixel_shuffle`` reproduces in NHWC;
* initialisation is torch's default, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
  weight and bias of every conv and dense layer (the JAX package's
  ``torch_conv_kernel_init`` and ``torch_dense_kernel_init``), drawn here
  from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

GEN_SLOPE = 0.01  # torch nn.LeakyReLU() default, used throughout the generator
CRITIC_SLOPE = 0.2


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel_size=3, padding=1)


@torch.no_grad()
def init_torch_default_(module: nn.Module, rng: torch.Generator) -> None:
    """Redraw every Conv2d's and Linear's weight and bias from
    U(+-1/sqrt(fan_in)) — the distribution of torch's default init — using
    ``rng``, on the CPU, so a seed gives the same weights whatever the
    device."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            for p in (m.weight, m.bias):
                if p is not None:
                    draw = torch.empty(p.shape).uniform_(-bound, bound, generator=rng)
                    p.copy_(draw)
