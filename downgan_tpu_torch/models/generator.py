"""The generator families, NCHW (counterpart of
``downgan_tpu/models/generator.py``, which has the first two).

:class:`Generator`, the ESRGAN-style residual-in-residual dense network:
conv1 -> N x RRDB -> conv2 + global skip -> K x [conv(4F), LeakyReLU,
PixelShuffle(2)] -> conv, LeakyReLU, conv. Florida: (B, 7, 16, 16) ->
(B, 2, 128, 128), 1,696,514 params. A stochastic generator
(``config.noise_channels = k``) takes k latent channels after the
covariates: only conv1 widens (1,697,090 params at k = 4).

Attribute names reproduce the reference state-dict keys (``conv1``,
``res_blocks.{i}.dense_blocks.{j}.b{k}.0``, ``conv2``, ``upsampling.{0,3,6}``,
``conv3.{0,2}``), so a file written by the JAX package's ``export-torch``
loads with ``strict=True``.

Every DenseResidualBlock runs through ``ops/cuda/drb.py::drb``: on a CUDA
tensor the CUDA kernel (through ``DRBFunction`` when autograd needs a
gradient: its backward is ``drb_backward_kernel`` for DoWnGAN's block in
fp32 at 16x16, and a cuDNN recompute otherwise), on a CPU tensor its plain
twin, under autograd or not.

``compute_dtype`` (``hp.compute_dtype``) is the JAX ``Generator``'s
``dtype``: the input is cast to it, every conv, activation, residual add,
DRB and pixel shuffle computes in it, the parameters stay fp32 and the
output is fp32. In bf16 the DRBs take the bf16 kernel.

:class:`ESRGANGenerator`, ESRGAN's generator at its own block widths (Wang
et al., "ESRGAN", ECCV 2018 Workshops, arXiv:1809.00219; code
xinntao/ESRGAN ``RRDBNet_arch.py``): the same trunk, keys and upsampler,
with dense blocks that grow by :data:`ESRGAN_GROWTH` channels a stage
(RRDBNet's ``gc``) rather than by ``filters``, and LeakyReLU(:data:`ESRGAN_SLOPE`)
all through. At ``filters=64, num_res_blocks=23`` (RRDBNet's nf, nb) on the
florida shapes: 17,068,994 params; stage s of a block convolves 64 + 32(s -
1) channels to 32, stage 5 192 to 64. Two departures from RRDBNet, kept
from DoWnGAN: the upsampler (conv to 4F, LeakyReLU, PixelShuffle(2) a
stage, three for 8x, in place of nearest x2 + conv) and the 7 -> 2
channels. fp32 only: on the card its DRBs take ``drb_kernel_wide``.

:class:`SRResNetGenerator`, the SRGAN-style family: 9x9 conv + PReLU ->
N x [conv, PReLU, conv + input] -> conv + :class:`InstanceNorm` + global
skip -> K x [conv(4F), PixelShuffle(2), PReLU] -> 9x9 conv; the 3x3 convs
have no bias. Florida: 115,414 params. It has no DRB, so it runs on stock
cuDNN convolutions alone (the JAX package left it to XLA). Its state-dict
keys are the port's own (the JAX package's ``export-torch`` covers the RRDB
only) and follow the flax tree: ``conv1.{weight,bias}``,
``prelu1.weight``, ``res_blocks.{i}.{conv1,conv2}.weight``,
``res_blocks.{i}.prelu.weight``, ``conv2.weight``, ``bn2.{weight,bias}``,
``up{i}.weight``, ``up_prelu{i}.weight``, ``conv3.{weight,bias}``
(``utils/port_weights.py::srresnet_state_dict_from_flax``). Its PReLU and
norm scale and shift with fp32 parameters, so, as in flax, their outputs
are fp32 when the network computes in bf16; the next conv casts back.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from downgan_tpu_torch.models.layers import GEN_SLOPE, conv, conv3x3
from downgan_tpu_torch.ops.cuda.drb import drb, pack_drb_weights, stage_widths
from downgan_tpu_torch.utils.profiling import annotate

ESRGAN_GROWTH = 32  # RRDBNet_arch.py (xinntao/ESRGAN): gc, num_grow_ch
ESRGAN_SLOPE = 0.2  # RRDBNet_arch.py: nn.LeakyReLU(negative_slope=0.2) throughout


class DenseResidualBlock(nn.Module):
    """Five conv stages over growing concatenations; stage k convolves
    filters + growth*(k-1) channels down to ``growth`` (stage 5: to
    ``filters``), LeakyReLU(``slope``) on all but the last, output scaled by
    0.2 and added to the input. ``growth`` defaults to ``filters`` (DoWnGAN's
    block: stage k convolves k*filters channels)."""

    def __init__(self, filters: int, growth: int | None = None, slope: float = GEN_SLOPE):
        super().__init__()
        self.slope = slope
        for k, (cin, cout) in enumerate(stage_widths(filters, growth), start=1):
            act = [nn.LeakyReLU(slope)] if k < 5 else []
            setattr(self, f"b{k}", nn.Sequential(conv3x3(cin, cout), *act))
        self._packed = None
        self._packed_key = None

    def stage_params(self):
        """([w_1..w_5], [b_1..b_5]): the five convs' OIHW weights and biases."""
        convs = [getattr(self, f"b{k}")[0] for k in range(1, 6)]
        return [c.weight for c in convs], [c.bias for c in convs]

    def _packed_weights(self, weights, biases, dtype=torch.float32) -> torch.Tensor:
        # Pack once per weight set and dtype: repack only when a parameter
        # moved or was written in place (load_state_dict and torch's
        # single-tensor and foreach Adam bump the version; its fused Adam
        # does not, and training.state.make_optimizer takes foreach), or
        # when the block runs in another dtype (an fp32 and a bf16 pack of
        # the same parameters differ). Inference tensors (parameters made
        # inside torch.inference_mode()) keep no version counter: they are
        # packed on every forward and never cached. A repack is a drb.pack
        # span; a cache hit is not.
        params = (*weights, *biases)
        if any(t.is_inference() for t in params):
            with annotate("drb.pack"):
                return pack_drb_weights(weights, biases, dtype)
        key = (dtype, *((t.device, t.data_ptr(), t._version) for t in params))
        if key != self._packed_key:
            with annotate("drb.pack"):
                self._packed = pack_drb_weights(weights, biases, dtype)
            self._packed_key = key
        return self._packed

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weights, biases = self.stage_params()
        return drb(x, weights, biases, self._packed_weights(weights, biases, x.dtype),
                   self.slope)


class RRDB(nn.Module):
    """Three DRBs with an outer skip scaled by 0.2."""

    def __init__(self, filters: int, growth: int | None = None, slope: float = GEN_SLOPE):
        super().__init__()
        self.dense_blocks = nn.Sequential(*[DenseResidualBlock(filters, growth, slope)
                                            for _ in range(3)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_blocks(x) * 0.2 + x


class Generator(nn.Module):
    """RRDB super-resolution generator. Input (N, in_channels, h, w), output
    (N, n_predictands, h * 2**num_upsample, w * 2**num_upsample) fp32,
    computed in ``compute_dtype``. ``growth`` and ``slope`` are the dense
    blocks' (:class:`DenseResidualBlock`) and every LeakyReLU's."""

    def __init__(self, filters: int = 16, in_channels: int = 7,
                 n_predictands: int = 2, num_res_blocks: int = 16,
                 num_upsample: int = 3, compute_dtype: torch.dtype = torch.float32,
                 growth: int | None = None, slope: float = GEN_SLOPE):
        super().__init__()
        self.compute_dtype = compute_dtype
        conv = functools.partial(conv3x3, compute_dtype=compute_dtype)
        self.conv1 = conv(in_channels, filters)
        self.res_blocks = nn.Sequential(*[RRDB(filters, growth, slope)
                                          for _ in range(num_res_blocks)])
        self.conv2 = conv(filters, filters)
        up = []
        for _ in range(num_upsample):
            up += [conv(filters, 4 * filters), nn.LeakyReLU(slope), nn.PixelShuffle(2)]
        self.upsampling = nn.Sequential(*up)
        self.conv3 = nn.Sequential(conv(filters, filters), nn.LeakyReLU(slope),
                                   conv(filters, n_predictands))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.conv1(x.to(self.compute_dtype))
        out = out1 + self.conv2(self.res_blocks(out1))
        return self.conv3(self.upsampling(out)).float()


class ESRGANGenerator(Generator):
    """:class:`Generator` with ESRGAN's dense blocks: growth
    :data:`ESRGAN_GROWTH`, LeakyReLU(:data:`ESRGAN_SLOPE`) throughout; the
    same keys. fp32 only (module docstring)."""

    def __init__(self, filters: int = 64, in_channels: int = 7,
                 n_predictands: int = 2, num_res_blocks: int = 23,
                 num_upsample: int = 3, compute_dtype: torch.dtype = torch.float32):
        if compute_dtype != torch.float32:
            raise ValueError(f"generator_arch 'esrgan' computes in float32 only, not "
                             f"{compute_dtype}; bf16 compute runs generator_arch 'rrdb'")
        super().__init__(filters, in_channels, n_predictands, num_res_blocks, num_upsample,
                         compute_dtype, growth=ESRGAN_GROWTH, slope=ESRGAN_SLOPE)


class PReLU(nn.Module):
    """Parametric ReLU with one learnable slope, initially 0.25:
    ``where(x >= 0, x, a * x)`` (the JAX ``PReLU``; 0 at x = 0). The slope
    is an fp32 parameter, so a bf16 input gives an fp32 output, as the flax
    module's ``alpha * x`` does."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight * x)


class InstanceNorm(nn.Module):
    """The JAX ``BatchNorm`` of the SRResNet: each sample normalized by its
    own per-channel mean and biased variance over H and W (eps 1e-5), then
    scaled and shifted by learnable per-channel parameters. No running
    statistics, so training and evaluation compute the same, and a sample's
    output does not depend on its batch. Not ``nn.BatchNorm2d``.

    As ``jnp.mean`` and ``jnp.var`` of a bf16 input, the statistics are
    summed in fp32 and rounded to the input's dtype; the normalization
    computes in that dtype and the fp32 scale and shift make it fp32."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True).to(x.dtype)
        var = xf.var(dim=(2, 3), correction=0, keepdim=True).to(x.dtype)
        norm = (x - mean) * torch.rsqrt(var + self.eps)
        return norm * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


class SRResNetBlock(nn.Module):
    """conv (no bias) -> PReLU -> conv (no bias), plus the input."""

    def __init__(self, channels: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = conv(channels, channels, bias=False, compute_dtype=compute_dtype)
        self.prelu = PReLU()
        self.conv2 = conv(channels, channels, bias=False, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.prelu(self.conv1(x))) + x


class SRResNetGenerator(nn.Module):
    """SRGAN-style generator with the :class:`Generator`'s contract: input
    (N, in_channels, h, w), output (N, n_predictands, h * 2**num_upsample,
    w * 2**num_upsample) fp32, convs computing in ``compute_dtype``."""

    def __init__(self, filters: int = 16, in_channels: int = 7,
                 n_predictands: int = 2, num_res_blocks: int = 16,
                 num_upsample: int = 3, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.num_upsample = num_upsample
        self.conv1 = conv(in_channels, filters, 9, compute_dtype=compute_dtype)
        self.prelu1 = PReLU()
        self.res_blocks = nn.Sequential(*[SRResNetBlock(filters, compute_dtype)
                                          for _ in range(num_res_blocks)])
        self.conv2 = conv(filters, filters, bias=False, compute_dtype=compute_dtype)
        self.bn2 = InstanceNorm(filters)
        for i in range(num_upsample):
            setattr(self, f"up{i}", conv(filters, 4 * filters, bias=False,
                                         compute_dtype=compute_dtype))
            setattr(self, f"up_prelu{i}", PReLU())
        self.shuffle = nn.PixelShuffle(2)
        self.conv3 = conv(filters, n_predictands, 9, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.prelu1(self.conv1(x.to(self.compute_dtype)))
        out = out1 + self.bn2(self.conv2(self.res_blocks(out1)))
        for i in range(self.num_upsample):
            # the shuffle before the PReLU (the RRDB's LeakyReLU comes first)
            out = getattr(self, f"up_prelu{i}")(self.shuffle(getattr(self, f"up{i}")(out)))
        return self.conv3(out).float()
