"""Analytic FLOP census of the WGAN-GP train step (counterpart of
``downgan_tpu/utils/flops.py``).

The step is cut into its loop-free pieces, each counted once and combined
with the schedule's multiplicities, as the JAX package's census does:

  * ``fake_gen``: one generator forward at the full batch (the critic
    update's fake);
  * ``critic_vag_microbatch``: the critic loss and its gradient in the
    critic's parameters (two critic forwards or one fused 2B pass, the
    GP's double backward) at the microbatch, times ``grad_accum``;
  * ``gen_vag_microbatch``: the generator loss and its gradient in the
    generator's parameters (G forward, critic forward, backward through
    both) at the microbatch, times ``grad_accum``; every
    ``critic_iterations`` steps on the reference schedule
    (``g_updates_in_window``), once a round on the fused one;
  * ``metrics``: the ``hp.metrics_to_calculate`` registry and the critic
    pair, plus a fresh generator forward unless ``metrics_reuse_fake``.
Adam and the EMA are O(params) elementwise work and are left out, as in the
JAX census.

How a piece is counted: its PyTorch code runs under :class:`FlopCount`, a
``TorchDispatchMode`` that adds ``torch.utils.flop_counter.flop_registry``'s
formula for every matmul and convolution it sees (forward, backward and the
GP's double backward; ``FlopCounterMode`` itself cannot run
``autograd.grad(create_graph=True)``, its module tracker raises). The
networks run on the ``meta`` device by default: shapes only, no data, the
same number on any machine. On the card a DRB runs through a ctypes kernel
the dispatcher never sees, and its backward recomputes with cuDNN; on
the census's own networks every DRB is its plain twin, called directly
(:func:`_drbs_on_twin`; ``ops/cuda/drb.py::drb_forward_reference``), whose
nine shifted products a stage are the block's convolutions, so each DRB
counts its five convs once. ``device="cpu"`` runs each piece on real data
at batch 1 and scales it by the piece's batch (every counted op is linear
in the batch): a cross-check of the ``meta`` count.

Every tap counts, padding included. XLA's cost analysis, which the JAX
census reads, counts only the taps of a SAME convolution that fall inside
the image, and adds one FLOP an element for elementwise ops, which the
registry leaves out. On the DRB's 16x16 images 8.2 % of the taps are
padding (16 % at 8x8), so the port's count of a generator forward is above
XLA's (florida: 1.0351e9 FLOPs a sample against 9.68e8).
"""
from __future__ import annotations

from collections import Counter
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

#: Dense peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
#: sheet, no sparsity), TFLOP/s by compute dtype: bf16 on the tensor cores;
#: fp32 with TF32 off (the port's fp32 setting) outside them.
H100_PEAK_TFLOPS = {"bfloat16": 989.0, "float32": 67.0}


class FlopCount(TorchDispatchMode):
    """Sums ``flop_registry``'s count over the ops dispatched inside it:
    ``total`` and ``by_op`` (op name -> FLOPs)."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.by_op: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            self.total += n
            self.by_op[str(func._overloadpacket)] += n
        return out


def _drbs_on_twin(module: torch.nn.Module) -> torch.nn.Module:
    """Every DenseResidualBlock of ``module`` computed by the plain twin
    (differentiable by autograd, on any device, ``meta`` included)."""
    from downgan_tpu_torch.models.generator import DenseResidualBlock
    from downgan_tpu_torch.ops.cuda.drb import drb_forward_reference

    for block in module.modules():
        if isinstance(block, DenseResidualBlock):
            block.forward = lambda x, block=block: drb_forward_reference(
                x, *block.stage_params(), slope=block.slope)
    return module


def count_flops(fn: Callable[[], object]) -> int:
    """FLOPs of the matmuls and convolutions ``fn()`` runs."""
    with FlopCount() as counter:
        fn()
    return counter.total


def train_flop_census(config, scan_steps: int = 1, with_metrics: bool = True,
                      start_step: int = 0, eof_components=None,
                      device: str = "meta") -> dict:
    """FLOPs of ``scan_steps`` iterations of ``config``'s train step: a
    reference-schedule step or, under ``hp.schedule == "fused"``, a fused
    round (``critic_iterations`` critic updates on their own minibatches and
    one generator update). Returns ``{"total_flops", "flops_per_step",
    "pieces"}``; the totals are zeros when a piece it needs counted zero, as
    the JAX census's are. ``eof_components`` only shapes the EOF term
    (placeholder zeros by default). ``device`` is ``"meta"`` or ``"cpu"``
    (module docstring)."""
    from downgan_tpu_torch.training.state import make_critic, make_generator
    from downgan_tpu_torch.training.wgan import (
        build_metric_pass,
        critic_loss,
        g_updates_in_window,
        generator_loss,
    )

    if device not in ("meta", "cpu"):
        raise ValueError(f"the census runs on 'meta' or 'cpu', not {device!r}")
    hp = config.hp
    batch = hp.batch_size
    k = max(1, hp.grad_accum)
    mb = batch // k
    cs, fs = config.coarse_size, config.fine_size
    gen = _drbs_on_twin(make_generator(config, device).train())
    critic = make_critic(config, device).train()
    g_params, c_params = list(gen.parameters()), list(critic.parameters())
    eof = None
    if hp.eof_lambda:
        eof = (torch.zeros((hp.ncomp, config.n_predictands, fs * fs))
               if eof_components is None else torch.as_tensor(eof_components)[:hp.ncomp])
        eof = eof.to(device, torch.float32)

    def draw(*shape):
        return torch.randn(shape, device=device)

    def piece(fn: Callable[[int], object], b: int) -> int:
        # meta: the piece at its batch; cpu: at batch 1, scaled.
        if device == "meta":
            return count_flops(lambda: fn(b))
        return b * count_flops(lambda: fn(1))

    def fake_gen(b):
        with torch.no_grad():
            gen(draw(b, config.generator_in_channels, cs, cs))

    def critic_vag(b):
        loss, _, _ = critic_loss(config, critic, draw(b, config.critic_in_channels, fs, fs),
                                 draw(b, config.critic_in_channels, fs, fs),
                                 torch.rand((b, 1, 1, 1), device=device))
        torch.autograd.grad(loss, c_params)

    def gen_vag(b):
        loss = generator_loss(config, gen, critic, draw(b, config.generator_in_channels, cs, cs),
                              draw(b, config.n_predictands, fs, fs), eof)
        torch.autograd.grad(loss, g_params)

    score = build_metric_pass(config)

    def metrics_pass(b):
        score(critic, draw(b, config.n_predictands, fs, fs), draw(b, config.n_predictands, fs, fs),
              draw(b, config.n_covariates, cs, cs))

    f_fake_gen = piece(fake_gen, batch)
    f_c_vag = piece(critic_vag, mb)
    f_g_vag = piece(gen_vag, mb)
    metrics_expected = with_metrics and bool(hp.metrics_to_calculate)
    f_metrics = piece(metrics_pass, batch) if metrics_expected else 0
    pieces = {"fake_gen": float(f_fake_gen), "critic_vag_microbatch": float(f_c_vag),
              "gen_vag_microbatch": float(f_g_vag), "metrics": float(f_metrics)}
    # A census missing a piece it must count would understate the total.
    if not (f_fake_gen and f_c_vag and f_g_vag and (f_metrics or not metrics_expected)):
        return {"total_flops": 0.0, "flops_per_step": 0.0, "pieces": pieces}

    f_critic_update = f_fake_gen + k * f_c_vag
    f_gen_update = k * f_g_vag
    if hp.schedule == "fused":
        # n critic updates, one generator update, one metric pass a round
        # (a fresh fake unless metrics_reuse_fake reuses the last critic fake).
        per_round = (hp.critic_iterations * f_critic_update + f_gen_update
                     + (((0 if hp.metrics_reuse_fake else f_fake_gen) + f_metrics)
                        if with_metrics else 0))
        total = scan_steps * per_round
    else:
        # A critic update and a metric pass every step; a generator update
        # where step % critic_iterations == 0 over [start, start + K).
        n_g = g_updates_in_window(start_step, scan_steps, hp.critic_iterations)
        per_step_metrics = ((f_metrics if hp.metrics_reuse_fake else f_fake_gen + f_metrics)
                            if with_metrics else 0)
        total = scan_steps * (f_critic_update + per_step_metrics) + n_g * f_gen_update
    return {"total_flops": float(total), "flops_per_step": float(total) / scan_steps,
            "pieces": pieces}
