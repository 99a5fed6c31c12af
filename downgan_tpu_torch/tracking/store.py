"""Filesystem tracking store (the port's own copy of
``downgan_tpu/tracking/store.py``): experiments, runs, params, metrics and
artifacts as plain JSON/CSV files, in the same layout, so the JAX
package's ``TrackingStore``, ``serve-tracking`` and ``export-mlflow`` read
a run the port wrote::

    <root>/
      experiments.json                  # id -> {name, tags, created}
      <exp_id>/<run_id>/
        meta.json                       # run metadata (status, times, tags)
        params.json                     # flat param dict
        metrics/<name>.csv              # step,value,wall_time rows
        artifacts/...                   # CSVs, config.json, checkpoints, best/

Every write appends or atomically replaces, so a crash never corrupts the
history. A run forwards its metrics and its end to the live mirrors
attached to it (``Run.attach_sink``, e.g.
``tracking/mlflow_export.py::MlflowLiveRun``) after each local write.
"""
from __future__ import annotations

import csv
import json
import os
import re
import shutil
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

#: Run ids are lowercase uuid4-hex prefixes (``create_run``). Anything else
#: (path separators, ``.``/``..``) is refused before it reaches the
#: filesystem.
_RUN_ID_RE = re.compile(r"^[0-9a-f]{8,32}$")


def _atomic_write_json(path: str, obj: Any) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, default=str)
    os.replace(tmp, path)


def _read_json(path: str, default: Any = None) -> Any:
    if not os.path.exists(path):
        return default
    with open(path) as f:
        return json.load(f)


class Run:
    """A single tracked run. Use as a context manager or via start/end."""

    def __init__(self, store: "TrackingStore", experiment_id: str, run_id: str):
        self.store = store
        self.experiment_id = experiment_id
        self.run_id = run_id
        self.run_dir = os.path.join(store.root, experiment_id, run_id)
        self.artifact_dir = os.path.join(self.run_dir, "artifacts")
        self._metrics_dir = os.path.join(self.run_dir, "metrics")
        # Live mirrors: each log_metric(s) and end is forwarded after the
        # local write, so the store stays the source of truth.
        self._sinks: List[Any] = []

    def attach_sink(self, sink: Any) -> "Run":
        """Attach a live mirror with ``log_metrics(dict, step)`` and
        ``end(status)`` (``mlflow_export.MlflowLiveRun``)."""
        self._sinks.append(sink)
        return self

    def _ensure_dirs(self) -> None:
        # Not in __init__: constructing a Run to read one creates nothing.
        os.makedirs(self.artifact_dir, exist_ok=True)
        os.makedirs(self._metrics_dir, exist_ok=True)

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "Run":
        self._ensure_dirs()
        meta = self.meta
        meta.setdefault("start_time", time.time())
        meta["status"] = "RUNNING"
        _atomic_write_json(os.path.join(self.run_dir, "meta.json"), meta)
        return self

    def end(self, status: str = "FINISHED") -> None:
        meta = self.meta
        meta["end_time"] = time.time()
        meta["status"] = status
        _atomic_write_json(os.path.join(self.run_dir, "meta.json"), meta)
        # After the local write: a sink that re-exports sees the final
        # status and end time.
        for sink in self._sinks:
            sink.end(status)

    def __enter__(self) -> "Run":
        return self.start()

    def __exit__(self, exc_type, *exc) -> None:
        self.end("FAILED" if exc_type else "FINISHED")

    @property
    def meta(self) -> Dict[str, Any]:
        return _read_json(os.path.join(self.run_dir, "meta.json"), {})

    # -- params / tags -------------------------------------------------
    def log_param(self, key: str, value: Any) -> None:
        self.log_params({key: value})

    def log_params(self, params: Dict[str, Any]) -> None:
        os.makedirs(self.run_dir, exist_ok=True)
        path = os.path.join(self.run_dir, "params.json")
        merged = _read_json(path, {})
        merged.update({k: _jsonable(v) for k, v in params.items()})
        _atomic_write_json(path, merged)

    @property
    def params(self) -> Dict[str, Any]:
        return _read_json(os.path.join(self.run_dir, "params.json"), {})

    def set_tags(self, tags: Dict[str, str]) -> None:
        os.makedirs(self.run_dir, exist_ok=True)
        meta = self.meta
        meta.setdefault("tags", {}).update(tags)
        _atomic_write_json(os.path.join(self.run_dir, "meta.json"), meta)

    # -- metrics -------------------------------------------------------
    def _write_metric(self, key: str, value: float, step: int) -> None:
        os.makedirs(self._metrics_dir, exist_ok=True)
        path = os.path.join(self._metrics_dir, f"{_safe(key)}.csv")
        new = not os.path.exists(path)
        with open(path, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(["step", "value", "wall_time"])
            w.writerow([step, float(value), time.time()])

    def log_metric(self, key: str, value: float, step: int) -> None:
        self._write_metric(key, value, step)
        for sink in self._sinks:
            sink.log_metrics({key: value}, step)

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        for k, v in metrics.items():
            self._write_metric(k, v, step)
        for sink in self._sinks:
            sink.log_metrics(metrics, step)

    def metric_history(self, key: str) -> List[Dict[str, float]]:
        path = os.path.join(self._metrics_dir, f"{_safe(key)}.csv")
        if not os.path.exists(path):
            return []
        with open(path, newline="") as f:
            return [
                {"step": int(r["step"]), "value": float(r["value"]),
                 "wall_time": float(r["wall_time"])}
                for r in csv.DictReader(f)
            ]

    @property
    def metric_names(self) -> List[str]:
        if not os.path.isdir(self._metrics_dir):
            return []
        return sorted(
            os.path.splitext(p)[0]
            for p in os.listdir(self._metrics_dir)
            if p.endswith(".csv")
        )

    # -- artifacts -----------------------------------------------------
    def log_artifact(self, local_path: str, artifact_subdir: str = "") -> str:
        self._ensure_dirs()
        dest_dir = os.path.join(self.artifact_dir, artifact_subdir)
        os.makedirs(dest_dir, exist_ok=True)
        dest = os.path.join(dest_dir, os.path.basename(local_path))
        shutil.copy2(local_path, dest)
        return dest

    def artifact_path(self, *parts: str) -> str:
        path = os.path.join(self.artifact_dir, *parts)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    def append_csv_row(self, filename: str, row: Dict[str, Any]) -> None:
        """Append-only CSV in the artifact dir (the reference's per-run
        metric CSV, ``mlflow_tools/mlflow_epoch.py:19-27``)."""
        path = self.artifact_path(filename)
        new = not os.path.exists(path)
        with open(path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row.keys()))
            if new:
                w.writeheader()
            w.writerow(row)


class TrackingStore:
    """Root store: experiment registry + run factory."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    @property
    def _registry_path(self) -> str:
        return os.path.join(self.root, "experiments.json")

    def experiments(self) -> Dict[str, Dict[str, Any]]:
        return _read_json(self._registry_path, {})

    def experiment_by_name(self, name: str) -> Optional[str]:
        for exp_id, info in self.experiments().items():
            if info.get("name") == name:
                return exp_id
        return None

    def create_experiment(self, name: str, tags: Optional[Dict[str, str]] = None) -> str:
        # The registry update is a read-modify-write: an exclusive lock makes
        # concurrent trainers on one root mint distinct ids.
        import fcntl

        with open(os.path.join(self.root, ".registry.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            existing = self.experiment_by_name(name)
            if existing is not None:
                return existing
            reg = self.experiments()
            exp_id = str(len(reg))
            while exp_id in reg or os.path.isdir(os.path.join(self.root, exp_id)):
                exp_id = str(int(exp_id) + 1)
            reg[exp_id] = {"name": name, "tags": tags or {}, "created": time.time()}
            _atomic_write_json(self._registry_path, reg)
            os.makedirs(os.path.join(self.root, exp_id), exist_ok=True)
            return exp_id

    def create_run(self, experiment_id: str, run_name: Optional[str] = None) -> Run:
        run_id = uuid.uuid4().hex[:16]
        run = Run(self, experiment_id, run_id)
        run._ensure_dirs()
        _atomic_write_json(
            os.path.join(run.run_dir, "meta.json"),
            {"run_id": run_id, "experiment_id": experiment_id,
             "run_name": run_name or run_id, "status": "SCHEDULED",
             "created": time.time(), "tags": {}},
        )
        return run

    def get_run(self, run_id: str) -> Run:
        if not _RUN_ID_RE.match(run_id):
            raise KeyError(f"invalid run id {run_id!r}")
        for exp_id in self.experiments():
            if os.path.isdir(os.path.join(self.root, exp_id, run_id)):
                return Run(self, exp_id, run_id)
        raise KeyError(f"run {run_id!r} not found under {self.root}")

    def runs(self, experiment_id: str) -> Iterator[Run]:
        exp_dir = os.path.join(self.root, experiment_id)
        if not os.path.isdir(exp_dir):
            return
        for run_id in sorted(os.listdir(exp_dir)):
            if os.path.isdir(os.path.join(exp_dir, run_id)):
                yield Run(self, experiment_id, run_id)


def _safe(name: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in name)


def _jsonable(v: Any) -> Any:
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)
