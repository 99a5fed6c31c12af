"""Metric registry (counterpart of ``downgan_tpu/ops/metrics.py``).

Names map to ``f(real, fake) -> scalar`` functions; the train step and the
test pass resolve ``hp.metrics_to_calculate`` through it. ``Wass`` needs
the critic and is computed by the step itself.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch

from downgan_tpu_torch.ops.losses import (
    content_loss,
    content_mse_loss,
    divergence_loss,
    vorticity_loss,
)
from downgan_tpu_torch.ops.msssim import msssim_metric
from downgan_tpu_torch.ops.spectral import ralsd

FieldMetric = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

METRIC_REGISTRY: Dict[str, FieldMetric] = {
    "MAE": content_loss,
    "MSE": content_mse_loss,
    "MSSSIM": msssim_metric,
    "Divergence": divergence_loss,
    "Vorticity": vorticity_loss,
    "RALSD": lambda real, fake: ralsd(fake, real),
}


def resolve_metrics(names: Iterable[str]) -> Dict[str, FieldMetric]:
    names = list(names)
    unknown = [n for n in names if n != "Wass" and n not in METRIC_REGISTRY]
    if unknown:
        raise KeyError(f"unknown metrics {unknown}; registry has {sorted(METRIC_REGISTRY)}")
    return {n: METRIC_REGISTRY[n] for n in names if n != "Wass"}
