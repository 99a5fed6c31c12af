"""Experiment tracking: the MLflow-style local filesystem tracker of the JAX
package, as the port's own copy (same on-disk layout)."""
from downgan_tpu_torch.tracking.experiment import (
    define_experiment,
    hyperparams_dict,
    log_hyperparams,
    write_tags,
)
from downgan_tpu_torch.tracking.store import Run, TrackingStore

__all__ = ["Run", "TrackingStore", "define_experiment", "hyperparams_dict",
           "log_hyperparams", "write_tags"]
