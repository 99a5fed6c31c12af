"""Plain PyTorch reference of ESRGAN's generator at its published widths,
its training step, and the yardsticks of its dense block and its step.

Imports torch and the benchmark's own reference alone: no kernel, module or
helper of the program under test. The generator follows ESRGAN (Wang et
al., "ESRGAN: Enhanced Super-Resolution Generative Adversarial Networks",
ECCV 2018 Workshops, arXiv:1809.00219; xinntao/ESRGAN ``RRDBNet_arch.py``,
nf = 64, nb = 23, gc = 32): conv1, ``num_res_blocks`` residual-in-residual
dense blocks of three dense blocks each, conv2 plus the trunk's skip. A
dense block is five 3x3 convs: stage k reads filters + 32 (k - 1) channels
and writes 32, stage 5 reads filters + 128 and writes ``filters``;
LeakyReLU(0.2) on stages 1-4; the block's and the RRDB's residuals are
scaled by 0.2. LeakyReLU is 0.2 all through the generator.

Departures from RRDBNet, the program's as well: the upsampler is
DoWnGAN's (conv to 4 filters, LeakyReLU, pixel shuffle by 2, per factor of
2: three for 8x) in place of RRDBNet's nearest x2 + conv; the head is
conv, LeakyReLU, conv; the channels are the task's (7 covariates in, 2
fields out). The critic is the florida one (:func:`nets.critic`) at base
``filters``. Parameter keys are the program's (DoWnGAN's), so one dict of
weights drawn by the benchmark loads into both.

``mode`` is :mod:`nets`' arithmetic: ``"fp32"`` (the reference) or a
control one precision down.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench import flops, inputs
from portbench.reference import nets, train

GROWTH = 32      # RRDBNet_arch.py gc (num_grow_ch)
SLOPE = 0.2      # RRDBNet_arch.py LeakyReLU(negative_slope=0.2)
RES_SCALE = nets.RES_SCALE


def stage_widths(filters: int, growth: int = GROWTH) -> List[Tuple[int, int]]:
    """(inputs, outputs) of a dense block's five stages."""
    return [(filters + growth * (s - 1), growth if s < 5 else filters) for s in range(1, 6)]


def generator_spec(cfg: dict) -> nets.Spec:
    """(key, shape, fan_in) of every generator parameter, the program's keys."""
    f, cin, p = cfg["filters"], cfg["n_covariates"], cfg["n_predictands"]
    out: nets.Spec = []

    def conv(key, o, i):
        out.append((f"{key}.weight", (o, i, 3, 3), i * 9))
        out.append((f"{key}.bias", (o,), i * 9))

    conv("conv1", f, cin)
    for i in range(cfg["num_res_blocks"]):
        for j in range(3):
            for k, (ci, co) in enumerate(stage_widths(f), start=1):
                conv(f"res_blocks.{i}.dense_blocks.{j}.b{k}.0", co, ci)
    conv("conv2", f, f)
    for u in range(nets.num_upsample(cfg)):
        conv(f"upsampling.{3 * u}", 4 * f, f)
    conv("conv3.0", f, f)
    conv("conv3.2", p, f)
    return out


def network_weights(cfg: dict, seed: int, device) -> Tuple[dict, dict]:
    """The run's weights: this generator's and the critic's, drawn as
    :func:`inputs.network_weights` draws the florida ones."""
    return (inputs.draw_weights(generator_spec(cfg), seed, "generator", device),
            inputs.draw_weights(nets.critic_spec(cfg), seed, "critic", device))


def dense_block(x: torch.Tensor, p: nets.Params, key: str, mode: str) -> torch.Tensor:
    acts = x
    for k in range(1, 6):
        y = nets.conv(acts, p[f"{key}.b{k}.0.weight"], p[f"{key}.b{k}.0.bias"], mode)
        if k < 5:
            acts = torch.cat([acts, F.leaky_relu(y, SLOPE)], dim=1)
    return y * RES_SCALE + x


def generator(p: nets.Params, x: torch.Tensor, cfg: dict, mode: str = "fp32") -> torch.Tensor:
    """(B, C, h, w) covariates -> (B, P, H, W) fields."""
    out1 = nets.conv(x, p["conv1.weight"], p["conv1.bias"], mode)
    h = out1
    for i in range(cfg["num_res_blocks"]):
        r = h
        for j in range(3):
            r = dense_block(r, p, f"res_blocks.{i}.dense_blocks.{j}", mode)
        h = r * RES_SCALE + h
    out = out1 + nets.conv(h, p["conv2.weight"], p["conv2.bias"], mode)
    for u in range(nets.num_upsample(cfg)):
        key = f"upsampling.{3 * u}"
        out = F.pixel_shuffle(F.leaky_relu(nets.conv(out, p[f"{key}.weight"], p[f"{key}.bias"],
                                                     mode), SLOPE), 2)
    out = F.leaky_relu(nets.conv(out, p["conv3.0.weight"], p["conv3.0.bias"], mode), SLOPE)
    return nets.conv(out, p["conv3.2.weight"], p["conv3.2.bias"], mode)


class RefTrainer(train.RefTrainer):
    """:class:`train.RefTrainer` (the step, the round, Adam, the metric
    pass, the faults) with ESRGAN's generator."""

    def G(self, x):
        return generator(dict(zip(self.g_keys, self.g)), x, self.cfg, self.mode)


# ---- yardsticks

def drb_flops_per_sample(filters: int, growth: int, h: int, w: int) -> int:
    """Sum over the five stages of 2 * 9 * inputs * outputs * H * W:
    122,683,392 at (64, 32, 16x16); ``flops.drb_flops_per_sample`` at
    growth = filters."""
    return sum(2 * 9 * cin * cout * h * w for cin, cout in stage_widths(filters, growth))


def drb_weight_bytes(filters: int, growth: int) -> int:
    """The fp32 kernel's packed weights: TF32 hi and lo parts of every
    stage's weights, and the fp32 biases."""
    widths = stage_widths(filters, growth)
    return 2 * 4 * sum(9 * cin * cout for cin, cout in widths) + 4 * sum(co for _, co in widths)


def drb_bound_seconds(batch: int, filters: int, growth: int, h: int, w: int) -> float:
    """The least time one fp32 launch over ``batch`` samples can take: three
    TF32 passes of its FLOPs at the TF32 peak, or its input, output and
    packed weights at the memory rate, whichever is longer."""
    ops = 3 * batch * drb_flops_per_sample(filters, growth, h, w)
    nbytes = 2 * batch * filters * h * w * 4 + drb_weight_bytes(filters, growth)
    return max(ops / flops.PEAK_FLOPS["float32"], nbytes / flops.PEAK_BYTES)


def reference_train_flops(cfg: dict) -> float:
    """FLOPs of one reference-schedule step of the ESRGAN reference,
    averaged over a cycle of ``critic_iterations`` steps (one generator
    update among them), counted on ``meta``."""
    hp = cfg["hp"]
    if hp["schedule"] != "reference":
        raise ValueError("the ESRGAN reference counts the reference schedule only")
    b, n = hp["batch_size"], hp["critic_iterations"]
    cs, fs = cfg["coarse_size"], cfg["fine_size"]

    def meta(spec) -> Dict[str, torch.Tensor]:
        return {key: torch.empty(shape, device="meta") for key, shape, _ in spec}

    ref = RefTrainer(cfg, meta(generator_spec(cfg)), meta(nets.critic_spec(cfg)))

    def cycle():
        for _ in range(n):
            ref.step(torch.empty((b, cfg["n_covariates"], cs, cs), device="meta"),
                     torch.empty((b, cfg["n_predictands"], fs, fs), device="meta"),
                     torch.empty((b, 1, 1, 1), device="meta"))

    return flops.count_flops(cycle) / n
