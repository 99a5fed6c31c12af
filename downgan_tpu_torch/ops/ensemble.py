"""Ensemble (probabilistic) verification metrics for the stochastic
generator (counterpart of ``downgan_tpu/ops/ensemble.py``), on tensors.

CRPS is the fair (unbiased) ensemble estimator (Ferro 2008):

    CRPS = E|X - y| - (1 / (2 M (M-1))) * sum_{i,j} |x_i - x_j|

For a degenerate ensemble (all members equal) it is the MAE, so CRPS < MAE
means the spread is informative. The pair term is summed pair by pair into
one field-sized buffer: the whole (M, M, ...) difference tensor would be
1.2 GB at M = 8 over 144 florida fields in fp32.
"""
from __future__ import annotations

import torch


def crps_ensemble(members: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """Fair CRPS of an (M, ...) ensemble against ``truth`` (...), averaged
    over every field point; the MAE when M < 2."""
    m = members.shape[0]
    term1 = (members - truth[None]).abs().mean(dim=0)
    if m < 2:
        return term1.mean()
    pairs = torch.zeros_like(truth, dtype=term1.dtype)
    for i in range(m):
        for j in range(i + 1, m):
            pairs += (members[i] - members[j]).abs()
    # sum over ordered pairs (i, j) = 2 * sum over i < j
    return (term1 - pairs / (m * (m - 1))).mean()


def ensemble_spread(members: torch.Tensor) -> torch.Tensor:
    """Mean per-point ensemble standard deviation (ddof = 1, the fair CRPS
    convention); 0 when M < 2."""
    if members.shape[0] < 2:
        return torch.zeros((), device=members.device)
    return members.std(dim=0, correction=1).mean()
