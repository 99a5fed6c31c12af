"""Experiment setup (the port's own copy of
``downgan_tpu/tracking/experiment.py``; reference
``DoWnGAN/mlflow_tools/mlflow_utils.py``), over the port's ``Config``.

The JAX package's interactive picker (stdin prompts) is not copied: the
port's CLI names its experiment with ``--experiment``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from downgan_tpu_torch.config.config import Config, HyperParams
from downgan_tpu_torch.tracking.store import Run, TrackingStore


def hyperparams_dict(config: Config) -> Dict[str, Any]:
    """Flat param dict: every HyperParams field + the workload shape."""
    out: Dict[str, Any] = {f.name: getattr(config.hp, f.name)
                           for f in dataclasses.fields(HyperParams)}
    for key in ("region", "scale_factor", "coarse_size", "fine_size",
                "n_covariates", "n_predictands", "filters", "num_res_blocks", "seed"):
        out[key] = getattr(config, key)
    return out


def log_hyperparams(run: Run, config: Config) -> None:
    run.log_params(hyperparams_dict(config))


def define_experiment(store: TrackingStore, name: str, tag: Optional[str] = None) -> str:
    """The id of the experiment ``name``, created if needed."""
    return store.create_experiment(name, tags={"mlflow.note.content": tag} if tag else None)


def write_tags(run: Run, description: Optional[str] = None) -> None:
    """Attach a run-description tag (``mlflow_utils.py:44-50``)."""
    if description:
        run.set_tags({"description": description})
