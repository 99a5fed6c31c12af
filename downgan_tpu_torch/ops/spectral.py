"""Spectral fidelity metric: the radially averaged log spectral distance
(counterpart of ``downgan_tpu/ops/spectral.py``), on NCHW tensors.

The radial average is one matmul with a dense (n_bins, H*W) averaging
matrix, built once by numpy per image size and kept on each device it is
used on, so a metric pass copies nothing from the host.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _radial_bin_matrix(h: int, w: int) -> np.ndarray:
    """(n_bins, h*w) matrix averaging FFT power into integer radial bins."""
    fy = np.fft.fftfreq(h) * h
    fx = np.fft.fftfreq(w) * w
    r = np.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2)
    bins = np.round(r).astype(np.int32).reshape(-1)
    n_bins = int(bins.max()) + 1
    mat = np.zeros((n_bins, h * w), dtype=np.float32)
    mat[bins, np.arange(h * w)] = 1.0
    counts = mat.sum(axis=1, keepdims=True)
    return mat / np.maximum(counts, 1.0)


@functools.lru_cache(maxsize=8)
def _radial_bin_tensor(h: int, w: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_radial_bin_matrix(h, w)).to(device)


def radial_spectrum(x: torch.Tensor) -> torch.Tensor:
    """Radially averaged power spectrum per sample and channel: (B, C, H, W)
    -> (B, C, n_bins). The FFT runs in fp32 whatever ``x``'s dtype (cuFFT
    takes no bf16), as the JAX package casts before ``fft2``."""
    b, c, h, w = x.shape
    f = torch.fft.fft2(x.float())
    power = (f.real.square() + f.imag.square()).reshape(b, c, h * w)
    return torch.einsum("bcp,kp->bck", power, _radial_bin_tensor(h, w, x.device))


def ralsd(fake: torch.Tensor, real: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Radially Averaged Log Spectral Distance in dB:
    ``sqrt(mean_k (10 log10(P_fake(k) / P_real(k)))^2)`` on the spectra
    averaged over the batch (before the log), over channels and bins,
    skipping the DC bin."""
    p_fake = radial_spectrum(fake).mean(dim=0)
    p_real = radial_spectrum(real).mean(dim=0)
    log_ratio = 10.0 * (torch.log10(p_fake + eps) - torch.log10(p_real + eps))
    return log_ratio[:, 1:].square().mean().sqrt()
