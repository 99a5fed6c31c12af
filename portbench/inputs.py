"""The benchmark's inputs, made from ``--seed`` on the run's device: the
networks' weights and the fields. Both sides, the program and the
reference, are handed these same tensors.

Weights follow PyTorch's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in))
for every weight and bias, drawn as one uniform vector per network from a
``torch.Generator`` on the device and cut into the parameters of
:func:`portbench.reference.nets.generator_spec` / ``critic_spec``.

Fields are gaussian random fields with a power-law spectrum (slope -1.5,
wind-like), made by an FFT on the device in blocks of samples: the fine
fields (N, P, H, W); the coarse covariates (N, C, h, w) are the fine
fields' block means for the first P channels and independent fields at
the coarse size for the rest; each stack is standardized to mean 0 and
std 1, as the staged florida data are. The run's peak memory counts
set-up, so the fields are made in blocks and standardized in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from portbench.reference import nets

_WEIGHT_TAGS = {"generator": 1, "critic": 2}
_FIELD_TAG = 3
_BLOCK = 512  # samples an FFT block: keeps the transient small beside the set


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for a torch.Generator from the run's seed and tags."""
    return int(np.random.SeedSequence((seed, *tags)).generate_state(1, np.uint64)[0] >> 1)


def draw_weights(spec: nets.Spec, seed: int, tag: str, device) -> Dict[str, torch.Tensor]:
    """One network's parameters (fp32, on ``device``) for ``spec``."""
    rng = torch.Generator(device=device).manual_seed(sub_seed(seed, _WEIGHT_TAGS[tag]))
    sizes = [int(np.prod(shape)) for _, shape, _ in spec]
    flat = torch.rand(sum(sizes), generator=rng, device=device).mul_(2).sub_(1)
    out = {}
    for (key, shape, fan_in), piece in zip(spec, flat.split(sizes)):
        out[key] = piece.view(shape).mul(fan_in ** -0.5)
    return out


def network_weights(cfg: dict, seed: int, device) -> Tuple[dict, dict]:
    return (draw_weights(nets.generator_spec(cfg), seed, "generator", device),
            draw_weights(nets.critic_spec(cfg), seed, "critic", device))


def _fields(rng: torch.Generator, n: int, size: int, device) -> torch.Tensor:
    """(n, size, size) power-law gaussian fields, each of unit std."""
    f = torch.fft.fftfreq(size, device=device)
    r = torch.sqrt(f[:, None] ** 2 + f[None, :] ** 2)
    amp = torch.where(r > 0, r.clamp_min(1e-12) ** -0.75, torch.zeros_like(r))
    noise = torch.randn((n, size, size), generator=rng, device=device)
    out = torch.fft.ifft2(torch.fft.fft2(noise) * amp).real
    return out / out.flatten(1).std(dim=1).clamp_min(1e-12)[:, None, None]


def _standardize(t: torch.Tensor) -> torch.Tensor:
    """In place, so making the set adds no second copy of it to the peak."""
    return t.sub_(t.mean()).div_(t.std())


@torch.no_grad()
def training_fields(cfg: dict, n: int, seed: int, device, with_fine: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coarse (n, C, h, w), fine (n, P, H, W)), fp32 on ``device``;
    without ``with_fine`` every covariate is an independent field and the
    fine stack is None."""
    c, cs, fs = cfg["n_covariates"], cfg["coarse_size"], cfg["fine_size"]
    p = cfg["n_predictands"] if with_fine else 0
    rng = torch.Generator(device=device).manual_seed(sub_seed(seed, _FIELD_TAG))
    fine = torch.empty((n, p, fs, fs), device=device)
    coarse = torch.empty((n, c, cs, cs), device=device)
    k = fs // cs
    for lo in range(0, n, _BLOCK):
        m = min(_BLOCK, n - lo)
        for ch in range(p):
            fine[lo:lo + m, ch] = _fields(rng, m, fs, device)
        coarse[lo:lo + m, :p] = fine[lo:lo + m].reshape(m, p, cs, k, cs, k).mean((3, 5))
        for ch in range(p, c):
            coarse[lo:lo + m, ch] = _fields(rng, m, cs, device)
    return _standardize(coarse), _standardize(fine) if with_fine else None


@torch.no_grad()
def covariate_series(cfg: dict, n: int, seed: int, device) -> np.ndarray:
    """(n, h, w, C) float32 covariates in host memory (NHWC, the layout of
    the program's generate path), made on ``device`` and copied back."""
    coarse, _ = training_fields(cfg, n, seed, device, with_fine=False)
    return coarse.permute(0, 2, 3, 1).contiguous().cpu().numpy()
