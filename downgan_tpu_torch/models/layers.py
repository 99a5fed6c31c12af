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
  from an explicit ``torch.Generator``;
* the critic's conv is :class:`CriticConv2d`: where its input needs a
  gradient, the gradient penalty's double backward takes the weight term
  of each conv on the convolution backward's weight-gradient route
  (:func:`critic_conv2d`), not as stock autograd's convolution with a
  kernel of the layer's whole output size.
"""
from __future__ import annotations

import math
import threading

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


_count_lock = threading.Lock()


def _will_run(ctx, i: int) -> bool:
    """Whether the backward under way reaches input ``i`` of ``ctx``'s node:
    autograd prunes a gradient nobody asked for (``grad(..., inputs)``,
    ``backward(inputs=...)``), and a custom Function has to ask."""
    node = ctx.next_functions[i][0]
    if node is None:
        return False
    try:
        return torch._C._will_engine_execute_node(node)
    except RuntimeError:  # a leaf that ``autograd.grad`` returns: it is asked for
        return True


#: Samples a weight-gradient call of the double backward takes at most on
#: the card. cuDNN's heuristics give florida's fifth critic layer (32 -> 64
#: channels, 32x32) 428 MiB of workspace at B=128 and 27.5 MiB at B=32
#: (H100, fp32); the pieces' sum costs 0.8 ms more a critic update.
WGRAD_SAMPLES = 32


def _weight_term(g_out: torch.Tensor, gg_x: torch.Tensor, weight: torch.Tensor,
                 conv) -> torch.Tensor:
    """The weight gradient of a convolution with input ``gg_x`` and output
    gradient ``g_out``: ``convolution_backward`` (cuDNN's wgrad on the card)
    over pieces of at most :data:`WGRAD_SAMPLES` samples, summed. On the
    CPU it is one call of PyTorch's im2col-and-GEMM convolution, oneDNN off
    for it (process-wide): oneDNN's fp32 backward-weights leaves the GP's
    first-layer weight gradient 3.3e-6-3.8e-6 off float64 at florida's
    shapes (B=4), the GEMM 1.9e-7-2.1e-7."""
    def wgrad(go: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
        return torch.ops.aten.convolution_backward(go, gx, weight, None, *conv,
                                                   [False, True, False])[1]

    if g_out.device.type == "cpu":
        enabled = torch.backends.mkldnn.enabled
        torch.backends.mkldnn.enabled = False
        try:
            return wgrad(g_out, gg_x)
        finally:
            torch.backends.mkldnn.enabled = enabled
    out = None
    for go, gx in zip(g_out.split(WGRAD_SAMPLES), gg_x.split(WGRAD_SAMPLES)):
        out = wgrad(go, gx) if out is None else out.add_(wgrad(go, gx))
    return out


class _ConvBackward(torch.autograd.Function):
    """A convolution's first backward, (gO, x, W) -> (gI, gW, gb) as
    ``convolution_backward`` computes them, differentiable once more. The
    double backward's weight term comes from <ggI, dgrad(gO, W)> =
    <conv(ggI, W), gO>: a weight gradient with ``ggI`` as the input and
    ``gO`` as the output gradient, where stock autograd runs a convolution
    whose kernel is the layer's whole output. It saves (gO, x, W), as stock
    ``ConvolutionBackwardBackward0`` does."""

    @staticmethod
    def forward(ctx, g_out, x, weight, conv, mask):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(g_out, x, weight)
        ctx.conv = conv
        bias_sizes = [weight.shape[0]] if mask[2] else None
        return torch.ops.aten.convolution_backward(g_out, x, weight, bias_sizes, *conv,
                                                   mask)

    @staticmethod
    def backward(ctx, gg_x, gg_w, gg_b):
        g_out, x, weight = ctx.saved_tensors
        stride, padding, dilation, _, _, groups = ctx.conv
        need_g_out, need_x, need_w = ctx.needs_input_grad[:3]
        grad_g_out = grad_x = grad_w = None
        if need_g_out:
            terms = []
            if gg_x is not None:
                terms.append(F.conv2d(gg_x, weight, None, stride, padding, dilation, groups))
            if gg_w is not None:
                terms.append(F.conv2d(x, gg_w, None, stride, padding, dilation, groups))
            if gg_b is not None:
                terms.append(gg_b.reshape(1, -1, 1, 1).expand_as(g_out))
            if terms:
                grad_g_out = sum(terms[1:], terms[0])
        if need_w and gg_x is not None:
            grad_w = _weight_term(g_out, gg_x, weight, ctx.conv)
            with _count_lock:
                critic_conv2d.double_backwards += 1
        if need_x and gg_w is not None:
            grad_x = torch.ops.aten.convolution_backward(
                g_out, x, gg_w, None, *ctx.conv, [True, False, False])[0]
        return grad_g_out, grad_x, grad_w, None, None


class _CriticConv(torch.autograd.Function):
    """``F.conv2d`` whose backward is :class:`_ConvBackward`, so a
    ``create_graph`` gradient through it records that node. Saves (x, W),
    as stock ``ConvolutionBackward0`` does."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, groups):
        ctx.save_for_backward(x, weight)
        ctx.conv = (stride, padding, dilation, False, (0,) * len(stride), groups)
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g_out):
        x, weight = ctx.saved_tensors
        mask = [ctx.needs_input_grad[i] and _will_run(ctx, i) for i in range(3)]
        grads = _ConvBackward.apply(g_out, x, weight, ctx.conv, mask)
        return *grads, None, None, None, None


def critic_conv2d(x: torch.Tensor, weight: torch.Tensor, bias, stride, padding, dilation,
                  groups: int) -> torch.Tensor:
    """``F.conv2d`` with a double backward on the weight-gradient route
    (:class:`_ConvBackward`); the same values and the same work. Process-wide
    and never reset, as ``drb_forward.launches``:
    ``critic_conv2d.double_backwards`` counts its weight terms, one a conv a
    double backward."""
    return _CriticConv.apply(x, weight, bias, tuple(stride), tuple(padding), tuple(dilation),
                             groups)


critic_conv2d.double_backwards = 0


class CriticConv2d(Conv2d):
    """The critic's :class:`Conv2d` (zero padding given as numbers). Where a
    double backward can follow, the input needing a gradient under grad mode
    (the gradient penalty's forward, the generator loss's critic), it
    convolves through :func:`critic_conv2d`; elsewhere (the critic's real
    and fake forwards, the metric pass) through the stock ``F.conv2d``."""

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor, bias):
        if torch.is_grad_enabled() and x.requires_grad:
            return critic_conv2d(x, weight, bias, self.stride, self.padding, self.dilation,
                                 self.groups)
        return super()._conv_forward(x, weight, bias)


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
