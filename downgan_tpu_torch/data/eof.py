"""EOF (PCA) analysis of climate fields (the port's own copy of
``downgan_tpu/data/eof.py``): a numpy SVD with sklearn's conventions
(mean-centred over samples, components = right singular vectors), the
basis the generator's EOF loss (``ops/losses.py::eof_loss``) projects
onto, and :func:`low_pass_eof_batch` on NCHW tensors.

The fit takes NHWC numpy fields, as the data tiers hold them on the host.
Each channel is flattened over (H, W) row-major, which is also how an NCHW
tensor flattens, so a basis fit here applies to the port's NCHW batches
as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EOFBasis:
    """Leading EOFs of a (samples, pixels) field collection.

    ``components``: (n_comp, n_pixels); ``mean``: (n_pixels,);
    ``explained_variance``: (n_comp,).
    """

    components: np.ndarray
    mean: np.ndarray
    explained_variance: np.ndarray

    @property
    def n_components(self) -> int:
        return self.components.shape[0]


def _randomized_svd(x: np.ndarray, k: int, oversample: int = 10, iters: int = 2, seed: int = 0):
    """Leading-k (singular values, right singular vectors) by randomized
    subspace iteration (Halko et al. 2011), the solver sklearn's
    ``svd_solver="auto"`` picks at real-data scale; deterministic (fixed
    seed), two power iterations."""
    rng = np.random.default_rng(seed)
    m = min(k + oversample, min(x.shape))
    q, _ = np.linalg.qr(x @ rng.standard_normal((x.shape[1], m)))
    for _ in range(iters):
        z, _ = np.linalg.qr(x.T @ q)
        q, _ = np.linalg.qr(x @ z)
    _, s, vt = np.linalg.svd(q.T @ x, full_matrices=False)
    return s[:k], vt[:k]


def fit_eofs(data: np.ndarray, n_components: int) -> EOFBasis:
    """PCA by SVD of the mean-centred (samples, pixels) ``data``: the
    economy SVD, or the randomized solver once both sides exceed 2,048."""
    data = np.asarray(data, dtype=np.float64)
    mean = data.mean(axis=0)
    centered = data - mean
    n = min(n_components, min(centered.shape))
    if min(centered.shape) > 2048:
        s, vt = _randomized_svd(centered, n)
    else:
        _, s, vt = np.linalg.svd(centered, full_matrices=False)
        s, vt = s[:n], vt[:n]
    explained = (s ** 2) / max(data.shape[0] - 1, 1)
    return EOFBasis(components=vt.astype(np.float32), mean=mean.astype(np.float32),
                    explained_variance=explained.astype(np.float32))


def project(basis: EOFBasis, fields: np.ndarray) -> np.ndarray:
    """(samples, pixels) -> (samples, n_comp) EOF projections (centred)."""
    return (np.asarray(fields) - basis.mean) @ basis.components.T


def reconstruct(basis: EOFBasis, projections: np.ndarray) -> np.ndarray:
    """(samples, n_comp) -> (samples, pixels) low-rank reconstruction."""
    return projections @ basis.components + basis.mean


def fit_eofs_per_channel(fields: np.ndarray, n_components: int, return_means: bool = False):
    """Per-channel EOFs of an NHWC field set -> the (n_comp, C, H*W) stack
    :func:`~downgan_tpu_torch.ops.losses.eof_loss` takes;
    ``return_means=True`` also returns the per-channel PCA means, (C,
    H*W)."""
    n, h, w, c = fields.shape
    comps, means = [], []
    for ch in range(c):
        basis = fit_eofs(fields[..., ch].reshape(n, h * w), n_components)
        comps.append(basis.components)
        means.append(basis.mean)
    stacked = np.stack(comps, axis=1)
    if return_means:
        return stacked, np.stack(means, axis=0)
    return stacked


def low_pass_eof_batch(batch: torch.Tensor, components: torch.Tensor,
                       mean: Optional[torch.Tensor] = None,
                       add_mean_back: bool = True) -> torch.Tensor:
    """Project an NCHW batch onto leading EOFs and reconstruct it: a
    spatial low-pass in EOF space. ``components`` is (n_comp, C, H*W) from
    :func:`fit_eofs_per_channel` or (n_comp, H*W) shared by the channels;
    ``mean`` the matching PCA means, (C, H*W) or (H*W,). ``mean=<pca
    means>, add_mean_back=False`` reproduces the reference's sklearn
    ``transform`` then ``components.T @ Z`` without the mean added back."""
    b, c, h, w = batch.shape
    flat = batch.reshape(b, c, h * w)
    if mean is not None:
        flat = flat - mean
    if components.ndim == 2:
        proj = torch.einsum("bcp,kp->bck", flat, components)
        rec = torch.einsum("bck,kp->bcp", proj, components)
    else:
        proj = torch.einsum("bcp,kcp->bck", flat, components)
        rec = torch.einsum("bck,kcp->bcp", proj, components)
    if mean is not None and add_mean_back:
        rec = rec + mean
    return rec.reshape(b, c, h, w)
