"""Plain PyTorch reference of ESRGAN's networks and of one reference-schedule
WGAN-GP step, for the CPU tests of the port's ``generator_arch: "esrgan"``.

It imports torch alone: no kernel, module or helper of the port, no JAX.
Every convolution is ``F.conv2d`` in fp32 with TF32 off (:func:`fp32`).

Generator: ESRGAN's (Wang et al., "ESRGAN", ECCV 2018 Workshops,
arXiv:1809.00219; xinntao/ESRGAN ``RRDBNet_arch.py``): conv1, ``nb``
residual-in-residual dense blocks, each three dense blocks of five 3x3
convs (stage k reads nf + gc (k - 1) channels and writes gc, stage 5 writes
nf; LeakyReLU 0.2 on stages 1-4; the block's and the RRDB's residuals
scaled by 0.2), conv2 plus the trunk's skip. Departures, as the port's:
the upsampler is DoWnGAN's (conv to 4 nf, LeakyReLU 0.2, pixel shuffle by 2,
per factor of 2) in place of RRDBNet's nearest x2 + conv, the head is conv,
LeakyReLU 0.2, conv, and the channels are the task's (covariates in,
predictands out). Parameter keys are the port's (DoWnGAN's) state-dict keys.

Critic: DoWnGAN's VGG-style WGAN critic (eight 3x3 convs, channel
multipliers 1, 1, 2, 2, 4, 4, 8, 8 of ``filters``, strides 1, 2
alternating, a bias on the first only, LeakyReLU 0.2, Linear(100),
LeakyReLU 0.2, Linear(1)).

Step (DoWnGAN ``mlflow_tools/train.py``, step 0 of the reference
schedule): a critic update on E[C(fake)] - E[C(real)] + w_gp GP, the fake
made without a graph, GP = E[(sqrt(|grad_x C(x)|^2 + 1e-12) - 1)^2] at
x = alpha real + (1 - alpha) fake; then a generator update against the
updated critic on -gamma E[C(G(coarse))] + content_lambda L1(G(coarse),
fine). Adam written out: bias-corrected moments, eps outside the root.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

GROWTH = 32       # RRDBNet_arch.py gc
SLOPE = 0.2       # RRDBNet_arch.py LeakyReLU(negative_slope=0.2)
RES_SCALE = 0.2   # dense-block and RRDB residual scale
CRITIC_SLOPE = 0.2
CRITIC_SPECS = ((1, 1, True), (1, 2, False), (2, 1, False), (2, 2, False),
                (4, 1, False), (4, 2, False), (8, 1, False), (8, 2, False))

Params = Dict[str, torch.Tensor]


@contextlib.contextmanager
def fp32():
    """TF32 off for convolutions and matmuls inside; restored on exit."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def stage_widths(nf: int, gc: int = GROWTH) -> List[Tuple[int, int]]:
    """(inputs, outputs) of a dense block's five stages."""
    return [(nf + gc * (k - 1), gc if k < 5 else nf) for k in range(1, 6)]


def generator_spec(nf: int, nb: int, cin: int, cout: int, num_upsample: int,
                   gc: int = GROWTH) -> List[Tuple[str, Tuple[int, ...]]]:
    """(key, shape) of every generator parameter, in the module's order."""
    out = []

    def conv(key, o, i):
        out.extend([(f"{key}.weight", (o, i, 3, 3)), (f"{key}.bias", (o,))])

    conv("conv1", nf, cin)
    for i in range(nb):
        for j in range(3):
            for k, (ci, co) in enumerate(stage_widths(nf, gc), start=1):
                conv(f"res_blocks.{i}.dense_blocks.{j}.b{k}.0", co, ci)
    conv("conv2", nf, nf)
    for u in range(num_upsample):
        conv(f"upsampling.{3 * u}", 4 * nf, nf)
    conv("conv3.0", nf, nf)
    conv("conv3.2", cout, nf)
    return out


def critic_spec(base: int, cin: int, fine_size: int) -> List[Tuple[str, Tuple[int, ...]]]:
    out = []
    for i, (mult, _, bias) in enumerate(CRITIC_SPECS):
        out.append((f"features.{2 * i}.weight", (mult * base, cin, 3, 3)))
        if bias:
            out.append((f"features.{2 * i}.bias", (mult * base,)))
        cin = mult * base
    flat = 8 * base * (fine_size // 16) ** 2
    return out + [("classifier.0.weight", (100, flat)), ("classifier.0.bias", (100,)),
                  ("classifier.2.weight", (1, 100)), ("classifier.2.bias", (1,))]


def dense_block(x: torch.Tensor, p: Params, key: str) -> torch.Tensor:
    acts = x
    for k in range(1, 6):
        y = F.conv2d(acts, p[f"{key}.b{k}.0.weight"], p[f"{key}.b{k}.0.bias"], padding=1)
        if k < 5:
            acts = torch.cat([acts, F.leaky_relu(y, SLOPE)], dim=1)
    return y * RES_SCALE + x


def generator(p: Params, x: torch.Tensor, nb: int, num_upsample: int) -> torch.Tensor:
    def conv(key, t):
        return F.conv2d(t, p[f"{key}.weight"], p[f"{key}.bias"], padding=1)

    out1 = conv("conv1", x)
    h = out1
    for i in range(nb):
        r = h
        for j in range(3):
            r = dense_block(r, p, f"res_blocks.{i}.dense_blocks.{j}")
        h = r * RES_SCALE + h
    out = out1 + conv("conv2", h)
    for u in range(num_upsample):
        out = F.pixel_shuffle(F.leaky_relu(conv(f"upsampling.{3 * u}", out), SLOPE), 2)
    return conv("conv3.2", F.leaky_relu(conv("conv3.0", out), SLOPE))


def critic(p: Params, x: torch.Tensor) -> torch.Tensor:
    for i, (_, stride, bias) in enumerate(CRITIC_SPECS):
        key = f"features.{2 * i}"
        x = F.leaky_relu(F.conv2d(x, p[f"{key}.weight"], p.get(f"{key}.bias") if bias else None,
                                  stride=stride, padding=1), CRITIC_SLOPE)
    x = F.leaky_relu(F.linear(x.flatten(1), p["classifier.0.weight"], p["classifier.0.bias"]),
                     CRITIC_SLOPE)
    return F.linear(x, p["classifier.2.weight"], p["classifier.2.bias"])


def adam_first_step(p: torch.Tensor, g: torch.Tensor, lr: float, b1: float, b2: float,
                    eps: float = 1e-8) -> torch.Tensor:
    """The parameter after Adam's first update from zero moments."""
    m, v = (1 - b1) * g, (1 - b2) * g * g
    return p - lr / (1 - b1) * m / ((v / (1 - b2)).sqrt() + eps)


def reference_step(g_params: Params, c_params: Params, coarse: torch.Tensor,
                   fine: torch.Tensor, alpha: torch.Tensor, hp: dict, nb: int,
                   num_upsample: int) -> dict:
    """Step 0 of the reference schedule from ``g_params``/``c_params``:
    ``critic_loss``, ``gen_loss``, each network's gradients (``c_grads``,
    ``g_grads``) and its parameters after the update (``c_new``, ``g_new``)."""
    with fp32():
        g = {k: v.detach().clone().requires_grad_(True) for k, v in g_params.items()}
        c = {k: v.detach().clone().requires_grad_(True) for k, v in c_params.items()}
        w_gp = hp["gp_lambda"] ** 2 if hp["double_gp_lambda"] else hp["gp_lambda"]
        with torch.no_grad():
            fake = generator(g, coarse, nb, num_upsample)
        interp = (alpha * fine + (1 - alpha) * fake).detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(critic(c, interp).sum(), interp, create_graph=True)
        gp = (torch.sqrt(grad.flatten(1).square().sum(1) + 1e-12) - 1).square().mean()
        c_loss = critic(c, fake).mean() - critic(c, fine).mean() + w_gp * gp
        c_grads = dict(zip(c, torch.autograd.grad(c_loss, list(c.values()))))
        opt = (hp["lr"], hp["beta1"], hp["beta2"])
        c_new = {k: adam_first_step(c[k].detach(), c_grads[k], *opt) for k in c}
        fake = generator(g, coarse, nb, num_upsample)
        g_loss = (-hp["gamma"] * critic(c_new, fake).mean()
                  + hp["content_lambda"] * (fine - fake).abs().mean())
        g_grads = dict(zip(g, torch.autograd.grad(g_loss, list(g.values()))))
        g_new = {k: adam_first_step(g[k].detach(), g_grads[k], *opt) for k in g}
    return {"critic_loss": float(c_loss.detach()), "gen_loss": float(g_loss.detach()),
            "c_grads": c_grads,
            "g_grads": g_grads, "c_new": c_new, "g_new": g_new}
