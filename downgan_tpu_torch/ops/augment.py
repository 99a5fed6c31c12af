"""Physics-aware flip augmentation of (coarse, fine) training pairs
(counterpart of ``downgan_tpu/ops/augment.py``), on NCHW tensors.

Wind is a vector field, so a mirror is physical only if the component
along the mirrored axis changes sign: a lon flip mirrors dim 3 (x) and
negates the u channels, a lat flip mirrors dim 2 (y) and negates the v
channels. Scalar covariates just mirror. Both fields of a sample share one
decision, so the pair stays aligned.

torch cannot draw the JAX package's ``bernoulli`` masks, so
:func:`random_flip_pair` takes the per-sample masks as arguments; the
train step draws them on its own device (``training/wgan.py::flip_masks``).
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

LON_DIM, LAT_DIM = 3, 2


def _axis_flip(x: torch.Tensor, dim: int, negate_channels: Sequence[int]) -> torch.Tensor:
    """Mirror ``x`` (NCHW) along ``dim`` and negate the vector components
    whose direction that mirror reverses. (Negated in place on the new
    tensor: a sign vector built from the channel list would be a host copy
    per step.)"""
    flipped = x.flip(dim)
    for ch in negate_channels:
        flipped[:, ch].neg_()
    return flipped


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.view(-1, 1, 1, 1), a, b)


def random_flip_pair(coarse: torch.Tensor, fine: torch.Tensor, flip_lon: torch.Tensor,
                     flip_lat: torch.Tensor, u_channels_coarse: Sequence[int] = (0,),
                     v_channels_coarse: Sequence[int] = (1,), u_channels_fine: Sequence[int] = (0,),
                     v_channels_fine: Sequence[int] = (1,)) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample lon and lat mirror flips of an NCHW batch pair where the
    bool masks ``flip_lon`` and ``flip_lat`` (B,) say so, sign-correcting
    the named u (lon flip) and v (lat flip) channels."""
    coarse = _where(flip_lon, _axis_flip(coarse, LON_DIM, u_channels_coarse), coarse)
    fine = _where(flip_lon, _axis_flip(fine, LON_DIM, u_channels_fine), fine)
    coarse = _where(flip_lat, _axis_flip(coarse, LAT_DIM, v_channels_coarse), coarse)
    fine = _where(flip_lat, _axis_flip(fine, LAT_DIM, v_channels_fine), fine)
    return coarse, fine


def make_augment(config) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """``augment(coarse, fine, flip_lon, flip_lat) -> (coarse, fine)`` with
    the config's vector-channel layout bound."""
    c = config

    def augment(coarse: torch.Tensor, fine: torch.Tensor, flip_lon: torch.Tensor,
                flip_lat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return random_flip_pair(coarse, fine, flip_lon, flip_lat,
                                u_channels_coarse=c.u_channels_coarse,
                                v_channels_coarse=c.v_channels_coarse,
                                u_channels_fine=c.u_channels_fine,
                                v_channels_fine=c.v_channels_fine)

    return augment
