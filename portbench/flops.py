"""Operations and bytes: the yardstick of the benchmark's shares.

``FlopCount`` is a frozen copy of the port's census mode: a
``TorchDispatchMode`` adding ``torch.utils.flop_counter.flop_registry``'s
formula for every matmul and convolution it sees (forward, backward and
the GP's double backward). Here it counts the benchmark's plain reference
(:mod:`portbench.reference`) on the ``meta`` device, shapes only, so a
change to the program never changes the count. Every tap counts, padding
included; elementwise work, Adam and the EMA are left out.

The DRB's formula: per sample, sum over stages s = 1..5 of
2 * 9 * (s F) * F * H * W FLOPs (17.69 MFLOP at F = 16, 16 x 16), and the
bytes a launch must move: its input and output once, in the launch's
dtype, and its packed weights once (fp32: TF32 hi and lo parts of the five
stages' weights and the biases; bf16: the weights in bf16 and the biases
in fp32).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

#: NVIDIA H100 SXM dense peaks at 700 W (data sheet): TF32 tensor cores
#: (the port's fp32 DRB reaches fp32 accuracy by 3xTF32 splits on them,
#: so fp32's 67 TFLOP/s outside the tensor cores is no ceiling), bf16,
#: and HBM3 bandwidth.
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


class FlopCount(TorchDispatchMode):
    """Sums ``flop_registry``'s count over the ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += int(formula(*args, **kwargs, out_val=out))
        return out


def count_flops(fn: Callable[[], object]) -> int:
    with FlopCount() as counter:
        fn()
    return counter.total


def drb_flops_per_sample(filters: int, h: int, w: int) -> int:
    return sum(2 * 9 * (s * filters) * filters * h * w for s in range(1, 6))


def drb_weight_bytes(filters: int, dtype: str) -> int:
    weights = 9 * filters * filters * 15          # five stages, s F inputs each
    if dtype == "float32":
        return 2 * 4 * weights + 4 * 5 * filters  # TF32 hi and lo parts, fp32 biases
    return 2 * weights + 4 * 5 * filters          # bf16 weights, fp32 biases


def drb_bound_seconds(batch: int, filters: int, h: int, w: int, dtype: str) -> float:
    """The least time one DRB launch over ``batch`` samples can take."""
    flops = batch * drb_flops_per_sample(filters, h, w)
    nbytes = (2 * batch * filters * h * w * DTYPE_BYTES[dtype]
              + drb_weight_bytes(filters, dtype))
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def _meta_weights(spec):
    return {key: torch.empty(shape, device="meta") for key, shape, _ in spec}


def reference_train_flops(cfg: dict) -> float:
    """FLOPs of one call of the training window: a reference-schedule
    step averaged over a cycle of ``critic_iterations`` steps (one
    generator update among them), or one fused round."""
    from portbench.reference import nets
    from portbench.reference.train import RefTrainer

    hp = cfg["hp"]
    b, n = hp["batch_size"], hp["critic_iterations"]
    cs, fs = cfg["coarse_size"], cfg["fine_size"]
    ref = RefTrainer(cfg, _meta_weights(nets.generator_spec(cfg)),
                     _meta_weights(nets.critic_spec(cfg)))

    def draw(*shape):
        return torch.empty(shape, device="meta")

    def alpha():
        return draw(b, 1, 1, 1)

    if hp["schedule"] == "fused":
        return float(count_flops(lambda: ref.round(
            draw(n, b, cfg["n_covariates"], cs, cs), draw(n, b, cfg["n_predictands"], fs, fs),
            [alpha() for _ in range(n)])))

    def cycle():
        for _ in range(n):
            ref.step(draw(b, cfg["n_covariates"], cs, cs), draw(b, cfg["n_predictands"], fs, fs),
                     alpha())

    return count_flops(cycle) / n


def reference_generate_flops_per_sample(cfg: dict) -> float:
    """FLOPs of the reference generator's forward, per sample."""
    from portbench.reference import nets

    p = _meta_weights(nets.generator_spec(cfg))
    x = torch.empty((1, cfg["n_covariates"], cfg["coarse_size"], cfg["coarse_size"]),
                    device="meta")
    with torch.no_grad():
        return float(count_flops(lambda: nets.generator(p, x, cfg)))
