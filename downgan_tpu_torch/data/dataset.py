"""Device-resident dataset and synthetic data (counterpart of
``downgan_tpu/data/dataset.py``).

``epoch_permutation`` and ``synthetic_dataset`` are the port's own copies of
the JAX package's numpy code and give bit-identical arrays for the same
seed: the batch-order rule and the synthetic fields are shared, so a run of
either package sees the same batches. ``DeviceDataset`` keeps the whole
split on the device as NCHW float32 and gathers each batch there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def epoch_permutation(n: int, rng: np.random.Generator, batch_size: int,
                      shuffle: bool = True) -> np.ndarray:
    """(n_steps, batch_size) drop-last permutation index matrix, int32."""
    idx = rng.permutation(n) if shuffle else np.arange(n)
    n_steps = n // batch_size
    return idx[: n_steps * batch_size].reshape(n_steps, batch_size).astype(np.int32)


@dataclass
class DeviceDataset:
    """Paired (coarse, fine) tensors resident on one device, NCHW float32:
    coarse (N, n_covariates, h, w), fine (N, n_predictands, H, W)."""

    coarse: torch.Tensor
    fine: torch.Tensor

    def __post_init__(self) -> None:
        if self.coarse.shape[0] != self.fine.shape[0] or self.coarse.device != self.fine.device:
            raise ValueError("coarse and fine need the same length and device")

    def __len__(self) -> int:
        return int(self.coarse.shape[0])

    @property
    def device(self) -> torch.device:
        return self.coarse.device

    def epoch_perm(self, rng: np.random.Generator, batch_size: int,
                   shuffle: bool = True) -> np.ndarray:
        return epoch_permutation(len(self), rng, batch_size, shuffle)

    def gather(self, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch at ``idx`` (a 1-D int tensor on the set's device)."""
        return self.coarse.index_select(0, idx), self.fine.index_select(0, idx)

    @staticmethod
    def from_numpy(coarse: np.ndarray, fine: np.ndarray,
                   device: str | torch.device) -> "DeviceDataset":
        """From NHWC arrays (the layout of ``synthetic_dataset`` and of the
        JAX package's data tiers)."""
        def put(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
            return t.to(device).permute(0, 3, 1, 2).contiguous()

        return DeviceDataset(put(coarse), put(fine))


def _correlated_field(rng: np.random.Generator, shape: Tuple[int, int, int],
                      slope: float = -1.5) -> np.ndarray:
    """(T, H, W) gaussian random fields with a power-law radial spectrum."""
    t, h, w = shape
    noise = rng.standard_normal(shape).astype(np.float32)
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    r = np.sqrt(fy**2 + fx**2)
    r[0, 0] = 1.0
    amp = r ** (slope / 2.0)
    amp[0, 0] = 0.0
    f = np.fft.fft2(noise, axes=(-2, -1)) * amp[None]
    field = np.real(np.fft.ifft2(f, axes=(-2, -1)))
    field = field / field.std()
    return field.astype(np.float32)


def synthetic_dataset(n_samples: int = 256, coarse_size: int = 16, fine_size: int = 128,
                      n_covariates: int = 7, n_predictands: int = 2, seed: int = 0,
                      covariate_noise: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic paired (coarse, fine) set, NHWC, standardized: correlated
    wind-like fine fields; their block averages as the first
    ``n_predictands`` covariates (plus white noise of std
    ``covariate_noise``), independent correlated fields as the rest."""
    rng = np.random.default_rng(seed)
    factor = fine_size // coarse_size

    fine = np.stack(
        [_correlated_field(rng, (n_samples, fine_size, fine_size)) for _ in range(n_predictands)],
        axis=-1,
    )
    coarse_from_fine = fine.reshape(
        n_samples, coarse_size, factor, coarse_size, factor, n_predictands
    ).mean(axis=(2, 4))
    if covariate_noise > 0.0:
        coarse_from_fine = coarse_from_fine + covariate_noise * rng.standard_normal(
            coarse_from_fine.shape
        ).astype(np.float32)
    extra = np.stack(
        [
            _correlated_field(rng, (n_samples, coarse_size, coarse_size))
            for _ in range(n_covariates - n_predictands)
        ],
        axis=-1,
    ) if n_covariates > n_predictands else np.zeros((n_samples, coarse_size, coarse_size, 0),
                                                    np.float32)
    coarse = np.concatenate([coarse_from_fine, extra], axis=-1)

    coarse = (coarse - coarse.mean()) / coarse.std()
    fine = (fine - fine.mean()) / fine.std()
    return coarse.astype(np.float32), fine.astype(np.float32)
