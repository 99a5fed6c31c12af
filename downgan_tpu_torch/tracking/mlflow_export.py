"""Export tracked runs to an MLflow FileStore directory (the port's own copy
of ``downgan_tpu/tracking/mlflow_export.py``, over the port's store).

The reference's run history lives in an MLflow FileStore that ``mlflow
ui`` and ``MlflowClient`` scripts open directly (``DoWnGAN/GAN/stage.py:66-70``,
``mlflow_tools/mlflow_server_cmd.py:4``). ``cli export-mlflow`` writes any
tracked run (or a whole experiment) as such a tree, and ``cli train
--mlflow-dir`` mirrors a run into one while it trains. The format is plain
files, so nothing here imports ``mlflow``::

    mlruns/<exp_id>/meta.yaml                  # experiment metadata
    mlruns/<exp_id>/<run_id32>/meta.yaml       # run metadata
    .../params/<key>                           # one file, value as text
    .../metrics/<key>                          # "<ts_ms> <value> <step>" lines
    .../tags/<key>                             # one file per tag
    .../artifacts/...                          # copied verbatim

Run ids are widened deterministically to MLflow's 32-hex form (the store's
are 16-hex); ``mlflow.runName`` is set from the tracked run name so the UI
shows the same labels.
"""
from __future__ import annotations

import os
import shutil
import time
from typing import Optional

# MLflow validates keys to alnum + ./_- ; _safe sanitizes the same way the
# store names its on-disk histories, so exported file names match the store's.
from downgan_tpu_torch.tracking.store import Run, TrackingStore, _safe as _fname

#: MLflow RunStatus enum values (mlflow/entities/run_status.py).
_STATUS = {"RUNNING": 1, "SCHEDULED": 2, "FINISHED": 3, "FAILED": 4, "KILLED": 5}


def _write_yaml(path: str, mapping: dict) -> None:
    # yaml.safe_dump(default_flow_style=False) is how MLflow's own FileStore
    # writes meta.yaml, so quoting, key order and scalars round-trip.
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(mapping, f, default_flow_style=False)


def _ms(seconds: Optional[float]) -> Optional[int]:
    return None if seconds is None else int(float(seconds) * 1000)


def widen_run_id(run_id: str) -> str:
    """Deterministically widen a 16-hex tracker run id to MLflow's 32-hex."""
    return (run_id * ((32 // max(len(run_id), 1)) + 1))[:32]


def export_run(run: Run, dest_root: str, experiment_name: Optional[str] = None,
               mlflow_experiment_id: Optional[str] = None,
               include_checkpoints: bool = False) -> str:
    """Write one tracked run as an MLflow FileStore run under ``dest_root``
    (the directory an MLflow UI is pointed at); returns the run directory.

    Artifacts are copied verbatim except the run's ``checkpoints/`` subtree
    unless ``include_checkpoints``: every retained full train state (both
    networks and both Adam states, times ``max_checkpoints``) lies there,
    and an MLflow UI has no use for it (``export`` moves weights)."""
    store = run.store
    exp_info = store.experiments().get(run.experiment_id, {})
    exp_name = experiment_name or exp_info.get("name", f"experiment_{run.experiment_id}")
    exp_id = mlflow_experiment_id or run.experiment_id
    exp_dir = os.path.join(dest_root, exp_id)
    os.makedirs(exp_dir, exist_ok=True)

    meta = run.meta
    created_ms = _ms(meta.get("created")) or 0
    if not os.path.exists(os.path.join(exp_dir, "meta.yaml")):
        _write_yaml(os.path.join(exp_dir, "meta.yaml"), {
            "artifact_location": "file://" + os.path.abspath(exp_dir),
            "creation_time": created_ms,
            "experiment_id": exp_id,
            "last_update_time": created_ms,
            "lifecycle_stage": "active",
            "name": exp_name,
        })

    run_id32 = widen_run_id(run.run_id)
    run_dir = os.path.join(exp_dir, run_id32)
    art_dir = os.path.join(run_dir, "artifacts")
    for sub in ("metrics", "params", "tags"):
        os.makedirs(os.path.join(run_dir, sub), exist_ok=True)

    start_ms = _ms(meta.get("start_time")) or created_ms
    _write_yaml(os.path.join(run_dir, "meta.yaml"), {
        "artifact_uri": "file://" + os.path.abspath(art_dir),
        "end_time": _ms(meta.get("end_time")),
        "entry_point_name": "",
        "experiment_id": exp_id,
        "lifecycle_stage": "active",
        "run_id": run_id32,
        "run_name": meta.get("run_name", run.run_id),
        "run_uuid": run_id32,
        "source_name": "",
        "source_type": 4,  # LOCAL
        "source_version": "",
        "start_time": start_ms,
        "status": _STATUS.get(meta.get("status", "FINISHED"), 3),
        "user_id": os.environ.get("USER", "downgan"),
    })

    for key, value in run.params.items():
        with open(os.path.join(run_dir, "params", _fname(key)), "w") as f:
            f.write(f"{value}\n")

    tags = dict(meta.get("tags", {}))
    tags.setdefault("mlflow.runName", meta.get("run_name", run.run_id))
    for key, value in tags.items():
        with open(os.path.join(run_dir, "tags", _fname(key)), "w") as f:
            f.write(f"{value}\n")

    for name in run.metric_names:
        with open(os.path.join(run_dir, "metrics", _fname(name)), "w") as f:
            for row in run.metric_history(name):
                f.write(f"{_ms(row['wall_time'])} {row['value']} {row['step']}\n")

    if os.path.isdir(run.artifact_dir):
        def _skip_ckpts(dirpath, names):
            if not include_checkpoints and os.path.samefile(dirpath, run.artifact_dir):
                return {"checkpoints"} & set(names)
            return set()

        shutil.copytree(run.artifact_dir, art_dir, dirs_exist_ok=True, ignore=_skip_ckpts)
    else:
        os.makedirs(art_dir, exist_ok=True)
    return run_dir


def export_experiment(store: TrackingStore, experiment_id: str, dest_root: str,
                      include_checkpoints: bool = False) -> list:
    """Export every run of an experiment; returns the run directories."""
    return [export_run(r, dest_root, include_checkpoints=include_checkpoints)
            for r in store.runs(experiment_id)]


class MlflowLiveRun:
    """Live MLflow FileStore mirror of a tracked run (``Run.attach_sink``):
    each epoch lands in the FileStore as it is logged, so an ``mlflow ui``
    follows the run live, as the reference's per-epoch MLflow logging does
    (``mlflow_tools/mlflow_epoch.py:40-50``).

    Laid out as :func:`export_run` lays the same run out: construction
    seeds the run directory with ``export_run`` (RUNNING, params, tags, the
    artifacts so far), ``log_metrics`` appends MLflow's ``"<ts_ms> <value>
    <step>"`` lines, and ``end`` exports again (the store's final status and
    end time, the late artifacts, the metric files rewritten from the
    store's history). A later ``export-mlflow`` of the run changes nothing."""

    def __init__(self, run: Run, dest_root: str):
        self._run = run
        self.dest_root = dest_root
        self.run_dir = export_run(run, dest_root)
        self._metrics_dir = os.path.join(self.run_dir, "metrics")

    def log_metrics(self, metrics: dict, step: int) -> None:
        os.makedirs(self._metrics_dir, exist_ok=True)
        now_ms = int(time.time() * 1000)
        for key, value in metrics.items():
            with open(os.path.join(self._metrics_dir, _fname(key)), "a") as f:
                f.write(f"{now_ms} {float(value)} {int(step)}\n")

    def end(self, status: str = "FINISHED") -> None:
        # Run.end forwards here after writing its final meta.
        export_run(self._run, self.dest_root)
