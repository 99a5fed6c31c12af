"""Experiment setup (the port's own copy of
``downgan_tpu/tracking/experiment.py``; reference
``DoWnGAN/mlflow_tools/mlflow_utils.py``), over the port's ``Config``.

``define_experiment`` and ``write_tags`` take ``interactive``: the
reference's stdin experiment picker and run-description prompt
(``mlflow_utils.py:13-50``), behind ``cli train --interactive``.
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


def define_experiment(store: TrackingStore, name: Optional[str] = None,
                      interactive: bool = False, tag: Optional[str] = None) -> str:
    """The id of the experiment ``name``, created if needed. With
    ``interactive`` and no name, list the existing experiments on stdout and
    read an id or a new name from stdin (the reference's picker)."""
    if interactive and name is None:
        existing = store.experiments()
        print("Which experiment would you like to use?")
        for exp_id, info in existing.items():
            print(f"  [{exp_id}] {info['name']}")
        choice = input("Enter an id, or a new experiment name: ").strip()
        if choice in existing:
            return choice
        name = choice
    if name is None:
        raise ValueError("experiment name required in non-interactive mode")
    return store.create_experiment(name, tags={"mlflow.note.content": tag} if tag else None)


def write_tags(run: Run, description: Optional[str] = None, interactive: bool = False) -> None:
    """Attach a run-description tag (``mlflow_utils.py:44-50``); with
    ``interactive`` and no description, read it from stdin."""
    if interactive and description is None:
        description = input("Provide a description of the run: ").strip()
    if description:
        run.set_tags({"description": description})
