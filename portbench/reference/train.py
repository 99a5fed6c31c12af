"""Plain PyTorch reference of the WGAN-GP training step, the fused
n-critic round, Adam and the metric pass (MAE, MSE, MS-SSIM, Wass).

Imports torch, numpy and the reference networks only. It follows the
published training loop (nannau/DoWnGAN ``mlflow_tools/train.py``,
``config/hyperparams.py``):

* a critic update on every step: loss = E[C(fake)] - E[C(real)]
  + w_gp * GP, with the fake made without a graph, GP = E[(|grad_x C(x)| - 1)^2]
  at x = alpha real + (1 - alpha) fake (per-sample alpha; the norm with a
  1e-12 guard under the square root), w_gp = gp_lambda^2 when the
  lambda is doubled;
* a generator update when step % critic_iterations == 0 (step 0
  included), against the updated critic:
  loss = -gamma E[C(G(coarse))] + content_lambda L1(G(coarse), fine);
* the metric pass scored by the updated critic on a fresh fake from the
  updated generator, or on the critic update's fake under
  ``metrics_reuse_fake``.
The fused round (``schedule: fused``): critic updates on each of n
minibatches, each on a fake of the round's starting generator, then one
generator update on the last minibatch, then the metric pass on it.

Adam is written out (bias-corrected moments, eps outside the square
root), each network with its own moments and count.

The GP's per-sample alpha of step s is U[0, 1) drawn on the run's device
from a ``torch.Generator`` seeded with
``SeedSequence((seed, s)).generate_state(1, uint64)[0]``: the rule the
program states for its draws, worked out here again.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import nets

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
WIN_SIZE, WIN_SIGMA = 7, 1.5
C1, C2 = 0.01 ** 2, 0.03 ** 2


def gp_alpha(seed: int, step: int, batch: int, device) -> torch.Tensor:
    state = int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0])
    rng = torch.Generator(device=device).manual_seed(state)
    return torch.rand((batch, 1, 1, 1), generator=rng, device=device)


def epoch_rows(seed: int, epoch: int, n: int, batch: int) -> np.ndarray:
    """(steps, batch) rows of an epoch: a permutation of ``n`` from
    ``numpy.random.default_rng((seed, epoch))``, cut to whole batches."""
    idx = np.random.default_rng((seed, epoch)).permutation(n)
    steps = n // batch
    return idx[:steps * batch].reshape(steps, batch)


def first_rows(seed: int, n: int, batch: int, batches: int, per_call: int = 1) -> np.ndarray:
    """The rows of the first ``batches`` batches of a run, epoch after
    epoch; each epoch cut to whole calls of ``per_call`` batches (a fused
    round takes ``critic_iterations``)."""
    out, epoch = [], 0
    while sum(len(r) for r in out) < batches:
        rows = epoch_rows(seed, epoch, n, batch)
        out.append(rows[:len(rows) // per_call * per_call])
        epoch += 1
    return np.concatenate(out)[:batches]


# ---- MS-SSIM (pytorch_msssim.MS_SSIM(win_size=7, data_range=1) on fields
# min-max normalized per channel over the batch)

def _gauss(device) -> torch.Tensor:
    c = torch.arange(WIN_SIZE, dtype=torch.float32, device=device) - WIN_SIZE // 2
    g = torch.exp(-(c ** 2) / (2.0 * WIN_SIGMA ** 2))
    return g / g.sum()


def _blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    c, k = x.shape[1], win.numel()
    x = F.conv2d(x, win.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, win.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def ms_ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    win = _gauss(x.device)
    weights = torch.tensor(MS_SSIM_WEIGHTS, dtype=torch.float32, device=x.device)
    levels = len(MS_SSIM_WEIGHTS)
    mcs = []
    for i in range(levels):
        mu_x, mu_y = _blur(x, win), _blur(y, win)
        sxx = _blur(x * x, win) - mu_x * mu_x
        syy = _blur(y * y, win) - mu_y * mu_y
        sxy = _blur(x * y, win) - mu_x * mu_y
        cs_map = (2 * sxy + C2) / (sxx + syy + C2)
        ssim = (((2 * mu_x * mu_y + C1) / (mu_x * mu_x + mu_y * mu_y + C1)) * cs_map).mean((2, 3))
        if i < levels - 1:
            mcs.append(torch.relu(cs_map.mean((2, 3))))
            pad = (x.shape[3] % 2, 0, x.shape[2] % 2, 0)
            x, y = (F.avg_pool2d(F.pad(t, pad), 2, 2) for t in (x, y))
    stack = torch.stack(mcs + [torch.relu(ssim)])
    return torch.prod(stack ** weights[:, None, None], dim=0).mean()


def minmax(x: torch.Tensor) -> torch.Tensor:
    lo = x.amin(dim=(0, 2, 3), keepdim=True)
    span = x.amax(dim=(0, 2, 3), keepdim=True) - lo
    return (x - lo) / torch.where(span > 0, span, torch.ones_like(span))


class Adam:
    """Adam over a list of tensors, updated in place."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, b1: float, b2: float,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(m, (v.sqrt() / c2 ** 0.5).add_(self.eps), value=-self.lr / c1)


class RefTrainer:
    """The reference's train state and its step and round.

    ``gen`` and ``critic`` are the benchmark's weights (cloned, fp32).
    ``mode`` is the arithmetic (:mod:`nets`). ``keep_rows`` < 1 computes
    every loss on the first ``keep_rows`` share of each batch (the
    "half the batch left out" fault); ``frozen`` skips every optimizer
    step (the "state returned unchanged" fault). ``alpha`` for a step may
    be passed (the FLOP count on ``meta`` cannot draw it)."""

    def __init__(self, cfg: dict, gen: Dict[str, torch.Tensor],
                 critic: Dict[str, torch.Tensor], mode: str = "fp32",
                 keep_rows: float = 1.0, frozen: bool = False):
        hp = cfg["hp"]
        self.cfg, self.hp, self.mode = cfg, hp, mode
        self.keep_rows, self.frozen = keep_rows, frozen
        self.g_keys, self.c_keys = list(gen), list(critic)
        self.g = [gen[k].detach().clone().float().requires_grad_(True) for k in self.g_keys]
        self.c = [critic[k].detach().clone().float().requires_grad_(True) for k in self.c_keys]
        opt = dict(lr=hp["lr"], b1=hp["beta1"], b2=hp["beta2"])
        self.g_opt, self.c_opt = Adam(self.g, **opt), Adam(self.c, **opt)
        self.gp_weight = hp["gp_lambda"] ** 2 if hp["double_gp_lambda"] else hp["gp_lambda"]
        self.step_count = 0

    # -- pieces ----------------------------------------------------------
    def G(self, x):
        return nets.generator(dict(zip(self.g_keys, self.g)), x, self.cfg, self.mode)

    def C(self, x):
        return nets.critic(dict(zip(self.c_keys, self.c)), x, self.mode)

    def _rows(self, *ts):
        if self.keep_rows >= 1.0:
            return ts
        n = max(1, int(ts[0].shape[0] * self.keep_rows))
        return tuple(t[:n] for t in ts)

    def critic_update(self, coarse, fine, alpha) -> Tuple[float, ...]:
        """One critic update; returns (loss, E[C(real)], E[C(fake)]) as
        tensors and the fake it scored."""
        coarse, fine, alpha = self._rows(coarse, fine, alpha)
        with torch.no_grad():
            fake = self.G(coarse)
        c_real, c_fake = self.C(fine).mean(), self.C(fake).mean()
        interp = (alpha * fine + (1.0 - alpha) * fake).detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(self.C(interp).sum(), interp, create_graph=True)
        gp = (torch.sqrt(grad.flatten(1).square().sum(1) + 1e-12) - 1.0).square().mean()
        loss = c_fake - c_real + self.gp_weight * gp
        grads = torch.autograd.grad(loss, self.c)
        if not self.frozen:
            self.c_opt.step(self.c, grads)
        return loss.detach(), c_real.detach(), c_fake.detach(), fake

    def generator_update(self, coarse, fine) -> torch.Tensor:
        coarse, fine = self._rows(coarse, fine)
        fake = self.G(coarse)
        loss = (-self.C(fake).mean() * self.hp["gamma"]
                + self.hp["content_lambda"] * (fine - fake).abs().mean())
        grads = torch.autograd.grad(loss, self.g)
        if not self.frozen:
            self.g_opt.step(self.g, grads)
        return loss.detach()

    @torch.no_grad()
    def metric_pass(self, fake, fine) -> Dict[str, torch.Tensor]:
        fake, fine = self._rows(fake, fine)
        c_real, c_fake = self.C(fine).mean(), self.C(fake).mean()
        return {"MAE": (fine - fake).abs().mean(), "MSE": (fine - fake).square().mean(),
                "MSSSIM": ms_ssim(minmax(fine), minmax(fake)), "Wass": c_real - c_fake,
                "c_real": c_real, "c_fake": c_fake}

    # -- schedules ---------------------------------------------------------
    def step(self, coarse, fine, alpha: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One reference-schedule step; advances the step count by one."""
        s = self.step_count
        if alpha is None:
            alpha = gp_alpha(self.cfg["seed"], s, fine.shape[0], fine.device)
        c_loss, _, _, fake = self.critic_update(coarse, fine, alpha)
        out = {"critic_loss": c_loss}
        if s % self.hp["critic_iterations"] == 0:
            out["gen_loss"] = self.generator_update(coarse, fine)
        self.step_count += 1
        if not self.hp["metrics_reuse_fake"]:
            with torch.no_grad():
                fake = self.G(self._rows(coarse)[0])
        out.update(self.metric_pass(fake, fine))
        return out

    def round(self, coarse_n, fine_n, alphas: Optional[Sequence[torch.Tensor]] = None
              ) -> Dict[str, torch.Tensor]:
        """One fused round over (n, B, ...) stacks; advances the count by n."""
        n = coarse_n.shape[0]
        losses = []
        for i in range(n):
            alpha = (gp_alpha(self.cfg["seed"], self.step_count, fine_n.shape[1], fine_n.device)
                     if alphas is None else alphas[i])
            c_loss, _, _, fake = self.critic_update(coarse_n[i], fine_n[i], alpha)
            losses.append(c_loss)
            self.step_count += 1
        out = {"critic_loss": torch.stack(losses).mean(),
               "gen_loss": self.generator_update(coarse_n[-1], fine_n[-1])}
        if not self.hp["metrics_reuse_fake"]:
            with torch.no_grad():
                fake = self.G(self._rows(coarse_n[-1])[0])
        out.update(self.metric_pass(fake, fine_n[-1]))
        return out

    # -- what the comparison reads ----------------------------------------
    def named(self) -> List[Tuple[str, torch.Tensor, torch.Tensor]]:
        """(leaf name, parameter, Adam first moment) of both networks."""
        return ([("generator." + k, p, m) for k, p, m in zip(self.g_keys, self.g, self.g_opt.m)]
                + [("critic." + k, p, m) for k, p, m in zip(self.c_keys, self.c, self.c_opt.m)])
