"""Plain PyTorch reference of the florida networks: the RRDB generator and
the VGG-style WGAN critic as functions of a dict of parameters.

This file imports torch alone: no kernel, module or helper of the program
under test. It follows the published model (nannau/DoWnGAN,
``networks/generator.py`` and ``networks/critic.py``): every convolution
is ``F.conv2d`` and every dense block five convolutions over growing
concatenations. Parameter keys are the upstream state-dict keys, so one
dict of weights drawn by the benchmark loads into the program and feeds
this reference alike.

Precision. ``mode`` names the arithmetic of every convolution and dense
layer: ``"fp32"`` (fp32 operands, fp32 sums, TF32 off: the reference),
``"tf32"`` (operands rounded to TF32: on a card the tensor cores' own
TF32, elsewhere an emulation that rounds the operands' mantissas to 10
bits) and ``"fp8"`` (operands and results rounded to float8 e4m3 and the
gradients that flow back to e5m2, one scale per tensor, fp32 sums). The
last two are the controls: the reference put in the program's place one
precision below the configuration's.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

GEN_SLOPE = 0.01      # nn.LeakyReLU() default, all through the generator
CRITIC_SLOPE = 0.2
RES_SCALE = 0.2       # dense-block and RRDB residual scale
CRITIC_SPECS = ((1, 1, True), (1, 2, False), (2, 1, False), (2, 2, False),
                (4, 1, False), (4, 2, False), (8, 1, False), (8, 2, False))
MODES = ("fp32", "tf32", "fp8")

Params = Dict[str, torch.Tensor]
Spec = List[Tuple[str, Tuple[int, ...], int]]


def num_upsample(cfg: dict) -> int:
    return (cfg["fine_size"] // cfg["coarse_size"]).bit_length() - 1


def generator_spec(cfg: dict) -> Spec:
    """(key, shape, fan_in) of every generator parameter, upstream keys."""
    f, cin, p = cfg["filters"], cfg["n_covariates"], cfg["n_predictands"]
    out: Spec = []

    def conv(key, o, i):
        out.append((f"{key}.weight", (o, i, 3, 3), i * 9))
        out.append((f"{key}.bias", (o,), i * 9))

    conv("conv1", f, cin)
    for i in range(cfg["num_res_blocks"]):
        for j in range(3):
            for k in range(1, 6):
                conv(f"res_blocks.{i}.dense_blocks.{j}.b{k}.0", f, k * f)
    conv("conv2", f, f)
    for u in range(num_upsample(cfg)):
        conv(f"upsampling.{3 * u}", 4 * f, f)
    conv("conv3.0", f, f)
    conv("conv3.2", p, f)
    return out


def critic_spec(cfg: dict) -> Spec:
    """(key, shape, fan_in) of every critic parameter, upstream keys."""
    base, cin = cfg["filters"], cfg["n_predictands"]
    out: Spec = []
    for i, (mult, _, bias) in enumerate(CRITIC_SPECS):
        out.append((f"features.{2 * i}.weight", (mult * base, cin, 3, 3), cin * 9))
        if bias:
            out.append((f"features.{2 * i}.bias", (mult * base,), cin * 9))
        cin = mult * base
    flat = 8 * base * (cfg["fine_size"] // 16) ** 2
    out += [("classifier.0.weight", (100, flat), flat), ("classifier.0.bias", (100,), flat),
            ("classifier.2.weight", (1, 100), 100), ("classifier.2.bias", (1,), 100)]
    return out


def _tf32_emulated(t: torch.Tensor) -> torch.Tensor:
    """``t`` (fp32) with its mantissa rounded to TF32's 10 bits, to nearest even."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def _fp8_scaled(t: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``t`` rounded to float8 under one per-tensor scale (amax to the
    format's largest finite value)."""
    top = torch.finfo(dtype).max
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8(torch.autograd.Function):
    """The fp8 recipe's rounding point: the operand to e4m3 going forward,
    its gradient to e5m2 coming back; a second derivative passes through."""

    @staticmethod
    def forward(ctx, t):
        return _fp8_scaled(t)

    @staticmethod
    def backward(ctx, grad):
        return _Fp8Grad.apply(grad)


class _Fp8Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grad):
        return _fp8_scaled(grad, torch.float8_e5m2)

    @staticmethod
    def backward(ctx, grad):
        return grad


def lower(t: Optional[torch.Tensor], mode: str) -> Optional[torch.Tensor]:
    """An operand as ``mode`` computes with it. TF32's rounding is
    straight through for autograd (its gradient is the identity); fp8's
    rounds the gradient that flows back through it to e5m2. The GP's
    double backward runs on the rounded operands."""
    if t is None or mode == "fp32" or (mode == "tf32" and t.device.type == "cuda"):
        return t
    if mode == "fp8":
        return _Fp8.apply(t)
    rounded = _tf32_emulated(t.detach())
    return t + (rounded - t).detach()


@contextlib.contextmanager
def arithmetic(mode: str):
    """The backend flags of ``mode``: TF32 on for ``"tf32"`` (a card's
    tensor cores round the operands themselves), off otherwise; restored on
    exit."""
    if mode not in MODES:
        raise ValueError(f"unknown precision {mode!r}; one of {MODES}")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _stored(y: torch.Tensor, mode: str) -> torch.Tensor:
    """A layer's result as ``mode`` stores it: fp8 keeps its results in
    fp8 too; TF32 rounds operands only."""
    return lower(y, mode) if mode == "fp8" else y


def conv(x, w, b, mode: str, stride: int = 1) -> torch.Tensor:
    return _stored(F.conv2d(lower(x, mode), lower(w, mode), lower(b, mode), stride=stride,
                            padding=1), mode)


def dense_block(x: torch.Tensor, p: Params, key: str, mode: str) -> torch.Tensor:
    """Five 3x3 convs, stage k over the concatenation of the input and
    the k-1 earlier (LeakyReLU'd) stage outputs; the fifth, unactivated,
    scaled by 0.2 and added to the input."""
    acts = x
    for k in range(1, 6):
        y = conv(acts, p[f"{key}.b{k}.0.weight"], p[f"{key}.b{k}.0.bias"], mode)
        if k < 5:
            acts = torch.cat([acts, F.leaky_relu(y, GEN_SLOPE)], dim=1)
    return y * RES_SCALE + x


def generator(p: Params, x: torch.Tensor, cfg: dict, mode: str = "fp32") -> torch.Tensor:
    """(B, C, h, w) covariates -> (B, P, H, W) fields: conv1, the RRDB trunk
    (three dense blocks each, residual 0.2), conv2 plus the trunk's skip,
    pixel-shuffle upsampling by 2 per stage, conv, LeakyReLU, conv."""
    out1 = conv(x, p["conv1.weight"], p["conv1.bias"], mode)
    h = out1
    for i in range(cfg["num_res_blocks"]):
        r = h
        for j in range(3):
            r = dense_block(r, p, f"res_blocks.{i}.dense_blocks.{j}", mode)
        h = r * RES_SCALE + h
    out = out1 + conv(h, p["conv2.weight"], p["conv2.bias"], mode)
    for u in range(num_upsample(cfg)):
        key = f"upsampling.{3 * u}"
        out = F.pixel_shuffle(F.leaky_relu(conv(out, p[f"{key}.weight"], p[f"{key}.bias"], mode),
                                           GEN_SLOPE), 2)
    out = F.leaky_relu(conv(out, p["conv3.0.weight"], p["conv3.0.bias"], mode), GEN_SLOPE)
    return conv(out, p["conv3.2.weight"], p["conv3.2.bias"], mode)


def critic(p: Params, x: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
    """(B, P, H, W) fields -> (B, 1) scores: eight 3x3 convs (strides 1, 2
    alternating; a bias on the first only), LeakyReLU(0.2), then
    Linear(100), LeakyReLU(0.2), Linear(1)."""
    for i, (_, stride, bias) in enumerate(CRITIC_SPECS):
        key = f"features.{2 * i}"
        x = F.leaky_relu(conv(x, p[f"{key}.weight"], p.get(f"{key}.bias") if bias else None,
                              mode, stride), CRITIC_SLOPE)
    x = x.flatten(1)
    x = F.leaky_relu(_stored(F.linear(lower(x, mode), lower(p["classifier.0.weight"], mode),
                                      lower(p["classifier.0.bias"], mode)), mode), CRITIC_SLOPE)
    return _stored(F.linear(lower(x, mode), lower(p["classifier.2.weight"], mode),
                            lower(p["classifier.2.bias"], mode)), mode)
