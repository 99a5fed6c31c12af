"""MS-SSIM metric, NCHW (counterpart of ``downgan_tpu/ops/msssim.py``).

The reference's metric is ``pytorch_msssim.MS_SSIM(win_size=7,
data_range=1, channel=2)`` on min-max normalized fields. Here, as in the
JAX package: a separable gaussian window (7 wide, sigma 1.5) applied as a
depthwise VALID blur, K = (0.01, 0.03), 5 scales with the published
weights, relu-clamped contrast terms, and 2x average pooling between scales
that pads one zero at the top/left of an odd axis and always divides by 4.

The min-max normalization is batch-global per channel and carries the JAX
package's constant-channel guard: a channel of span 0 normalizes to 0
instead of dividing by zero, so two equal constant channels score 1.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

MS_SSIM_WEIGHTS: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
WIN_SIZE, WIN_SIGMA = 7, 1.5
# (K1 * data_range)^2 and (K2 * data_range)^2 with K = (0.01, 0.03) and
# data_range 1: the fields are min-max normalized to [0, 1] first.
C1, C2 = 0.01 ** 2, 0.03 ** 2


def _gaussian_kernel(device) -> torch.Tensor:
    coords = torch.arange(WIN_SIZE, dtype=torch.float32, device=device) - WIN_SIZE // 2
    g = torch.exp(-(coords ** 2) / (2.0 * WIN_SIGMA ** 2))
    return g / g.sum()


def _blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable depthwise gaussian blur, VALID padding."""
    c, k = x.shape[1], win.numel()
    x = F.conv2d(x, win.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, win.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def _ssim_per_channel(x: torch.Tensor, y: torch.Tensor,
                      win: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ssim, cs), each (B, C)."""
    mu_x, mu_y = _blur(x, win), _blur(y, win)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_xx = _blur(x * x, win) - mu_xx
    sigma_yy = _blur(y * y, win) - mu_yy
    sigma_xy = _blur(x * y, win) - mu_xy
    cs_map = (2.0 * sigma_xy + C2) / (sigma_xx + sigma_yy + C2)
    ssim_map = ((2.0 * mu_xy + C1) / (mu_xx + mu_yy + C1)) * cs_map
    return ssim_map.mean(dim=(2, 3)), cs_map.mean(dim=(2, 3))


def _downsample(x: torch.Tensor) -> torch.Tensor:
    """2x average pool; an odd axis gets one zero at its top/left, and the
    divisor is always 4 (the reference's ``avg_pool2d(padding=H%2, W%2)``)."""
    x = F.pad(x, (x.shape[3] % 2, 0, x.shape[2] % 2, 0))
    return F.avg_pool2d(x, kernel_size=2, stride=2)


def ms_ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Multi-scale SSIM of two (B, C, H, W) fields in [0, 1]; the smallest
    scale must be wider than the window, as in pytorch_msssim."""
    x, y = x.float(), y.float()
    levels = len(MS_SSIM_WEIGHTS)
    if (min(x.shape[2], x.shape[3]) >> (levels - 1)) <= WIN_SIZE:
        raise ValueError(f"{tuple(x.shape[2:])} is too small for {levels} MS-SSIM levels "
                         f"with a window of {WIN_SIZE}")
    win = _gaussian_kernel(x.device)
    w = torch.tensor(MS_SSIM_WEIGHTS, dtype=torch.float32, device=x.device)
    mcs = []
    for i in range(levels):
        ssim_val, cs = _ssim_per_channel(x, y, win)
        if i < levels - 1:
            mcs.append(torch.relu(cs))
            x, y = _downsample(x), _downsample(y)
    stack = torch.stack(mcs + [torch.relu(ssim_val)], dim=0)  # (levels, B, C)
    return torch.prod(stack ** w[:, None, None], dim=0).mean()


def minmax_normalize_per_channel(x: torch.Tensor) -> torch.Tensor:
    """Batch-global per-channel min-max normalization to [0, 1], with the
    constant-channel guard (span 0 -> the channel becomes 0, not NaN)."""
    mins = x.amin(dim=(0, 2, 3), keepdim=True)
    span = x.amax(dim=(0, 2, 3), keepdim=True) - mins
    return (x - mins) / torch.where(span > 0, span, torch.ones_like(span))


def msssim_metric(hr: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """The reference's MSSSIM metric: min-max normalize both fields, then
    MS-SSIM with win_size=7, data_range=1."""
    return ms_ssim(minmax_normalize_per_channel(hr), minmax_normalize_per_channel(fake))
