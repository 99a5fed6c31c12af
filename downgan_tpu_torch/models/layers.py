"""Shared layer pieces for the port's models (counterpart of
``downgan_tpu/models/layers.py``).

The port runs NCHW, PyTorch's own layout, so the JAX package's explicit
padding and depth-to-space helpers become stock modules:

* a 3x3 conv is ``nn.Conv2d(kernel_size=3, padding=1)``, which pads (1, 1)
  like the JAX ``Conv3x3``; the SRResNet's 9x9 conv pads 4, like its
  ``nn.Conv(kernel_size=(9, 9), padding=((4, 4), (4, 4)))`` (:func:`conv`,
  with or without a bias);
* pixel shuffle is ``nn.PixelShuffle(2)``, whose channel order the JAX
  ``pixel_shuffle`` reproduces in NHWC;
* a layer that computes in a dtype is :class:`Conv2d` or :class:`Linear`
  with a ``compute_dtype``: flax's ``nn.Conv(dtype=bf16,
  param_dtype=f32)`` (``Conv3x3``) and ``nn.Dense(dtype=bf16)`` keep fp32
  parameters and, at each call, cast the input, kernel and bias to bf16,
  compute with fp32 accumulation and return bf16. These do the same with
  explicit casts, so the parameters (and Adam, the EMA and checkpoints)
  stay fp32 and the state-dict keys stay the reference's. Not
  ``torch.autocast``: its per-op lists keep reductions and some pointwise
  ops in fp32 and cast others, a different mixture from flax's, where every
  op of the model runs in the compute dtype;
* initialisation is torch's default, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
  weight and bias of every conv and dense layer (the JAX package's
  ``torch_conv_kernel_init`` and ``torch_dense_kernel_init``), drawn here
  from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

GEN_SLOPE = 0.01  # torch nn.LeakyReLU() default, used throughout the generator
CRITIC_SLOPE = 0.2


def torch_dtype(name: str) -> torch.dtype:
    """``hp.compute_dtype`` ("float32" or "bfloat16") -> the torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``: input, weight and bias
    are cast to it at each call (a no-op in fp32), the parameters stay as
    they are."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x, weight = x.to(dt), self.weight.to(dt)
        bias = None if self.bias is None else self.bias.to(dt)
        if dt == torch.bfloat16 and x.device.type == "cpu":
            # PyTorch's CPU bf16 convolution gets its double backward (the
            # GP's) wrong for stride 1 at 64x64 and larger: its weight term
            # comes out ~100 % off float64. The same function (bf16
            # operands, fp32 sums, one rounding to bf16) as an fp32
            # convolution of the bf16 values; its backward rounds its
            # gradients to bf16 at the same casts.
            bias = None if bias is None else bias.float()
            return self._conv_forward(x.float(), weight.float(), bias).to(dt)
        return self._conv_forward(x, weight, bias)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype``, as :class:`Conv2d`."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def conv(cin: int, cout: int, kernel_size: int = 3, bias: bool = True,
         compute_dtype: torch.dtype = torch.float32) -> Conv2d:
    """A stride-1 conv padded ``kernel_size // 2`` on every side, so the
    output keeps the input's size."""
    return Conv2d(cin, cout, kernel_size=kernel_size, padding=kernel_size // 2, bias=bias,
                  compute_dtype=compute_dtype)


def conv3x3(cin: int, cout: int, compute_dtype: torch.dtype = torch.float32) -> Conv2d:
    return conv(cin, cout, 3, compute_dtype=compute_dtype)


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


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsample of an NCHW batch by an integer factor:
    (B, C, H, W) -> (B, C, H*f, W*f), a broadcast and a reshape. It lifts
    the coarse covariates onto the fine grid for the conditional critic."""
    b, c, h, w = x.shape
    f = factor
    return x[:, :, :, None, :, None].expand(b, c, h, f, w, f).reshape(b, c, h * f, w * f)
