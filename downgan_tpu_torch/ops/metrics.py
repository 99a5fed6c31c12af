"""Metric registry (counterpart of ``downgan_tpu/ops/metrics.py``).

Names map to ``f(real, fake) -> scalar`` functions; the train step and the
test pass resolve ``hp.metrics_to_calculate`` through it. ``Wass`` needs
the critic and is computed by the step itself.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch

from downgan_tpu_torch.ops.losses import content_loss, content_mse_loss
from downgan_tpu_torch.ops.msssim import msssim_metric

FieldMetric = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

METRIC_REGISTRY: Dict[str, FieldMetric] = {
    "MAE": content_loss,
    "MSE": content_mse_loss,
    "MSSSIM": msssim_metric,
}
# In the JAX package's registry, not yet in the port's.
NOT_PORTED = ("Divergence", "Vorticity", "RALSD")


def resolve_metrics(names: Iterable[str]) -> Dict[str, FieldMetric]:
    names = list(names)
    later = [n for n in names if n in NOT_PORTED]
    if later:
        raise ValueError(f"metrics {later} are not ported yet: they come with a later "
                         "slice of the port")
    unknown = [n for n in names if n != "Wass" and n not in METRIC_REGISTRY]
    if unknown:
        raise KeyError(f"unknown metrics {unknown}; registry has {sorted(METRIC_REGISTRY)}")
    return {n: METRIC_REGISTRY[n] for n in names if n != "Wass"}
