"""Checkpoints of the full train state (counterpart of
``downgan_tpu/utils/checkpoint.py``, which uses Orbax).

One ``torch.save`` file per epoch step, ``<directory>/<step>.pt``, holding
:meth:`GANTrainState.state_dict`: both networks, both Adam states, the
step and the EMA generator. Each file is written to a temporary name,
flushed to disk and renamed into place, so a crash mid-save leaves the
previous checkpoints whole. Files are read with
``torch.load(weights_only=True)``: a checkpoint holds tensors, numbers,
strings, lists and dicts, never a pickled object.

Across ranks (``parallel/``) the state is the same on every rank and the
directory is shared: every rank calls :meth:`CheckpointManager.save`, rank
0 writes, and all of them meet at a barrier before and after, so each sees
the same files and returns the same answer; every rank restores from the
directory.
"""
from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from downgan_tpu_torch.parallel.mesh import in_group, rank

_STEP_FILE = re.compile(r"(\d+)\.pt")


class CheckpointManager:
    """Full-train-state checkpoints in ``directory`` with the JAX package's
    retention: ``max_to_keep`` latest steps (None or 0 keeps every epoch,
    the reference's behaviour, ``mlflow_tools/mlflow_epoch.py:65-69``), and
    ``keep_period=k`` additionally pins every step with ``step % k == 0``
    outside that window."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 keep_period: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep or None
        self.keep_period = keep_period

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state, force: bool = False) -> bool:
        """Write ``state.state_dict()`` as ``step``. As Orbax: without
        ``force`` a step at or below the latest one is skipped (returns
        False); ``force`` saves it, but never over an existing step. In a
        process group every rank calls it and rank 0 writes."""
        # Every rank decides from the same listing: the directory changes
        # only inside save, between the barriers of the previous call.
        steps = self.all_steps()
        if force and step in steps:
            raise ValueError(f"a checkpoint of step {step} already exists in {self.directory}")
        if not force and steps and steps[-1] >= step:
            return False
        collective = in_group()
        if collective:
            dist.barrier()  # every rank has listed the directory before rank 0 changes it
        if rank() == 0:
            os.makedirs(self.directory, exist_ok=True)
            save_params(self._path(step), state.state_dict())
            self._prune()
        if collective:
            dist.barrier()  # the file is whole before any rank reads the directory again
        return True

    def _prune(self) -> None:
        if self.max_to_keep is None:
            return
        for step in self.all_steps()[:-self.max_to_keep]:
            if not (self.keep_period and step % self.keep_period == 0):
                os.remove(self._path(step))

    def restore(self, step: Optional[int] = None) -> dict:
        """The state dict saved as ``step`` (default: the latest), on the
        CPU; ``GANTrainState.load_state_dict`` puts it on the state's
        device."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        retained = self.all_steps()
        if step not in retained:
            raise FileNotFoundError(
                f"epoch/step {step} is not among the retained checkpoints "
                f"{retained}. The default retention keeps a rolling "
                "window of 3 full train states; train with "
                "Config.max_checkpoints=0 (keep every epoch, the reference's "
                "behavior) or keep_checkpoint_every=k to make older epochs "
                "restorable.")
        return load_params(self._path(step))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        found = (_STEP_FILE.fullmatch(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def wait(self) -> None:
        """Saves are synchronous; kept for the JAX manager's interface."""

    def close(self) -> None:
        """Nothing to release; kept for the JAX manager's interface."""


def save_params(path: str, obj: Any) -> None:
    """``torch.save`` ``obj`` (tensors, numbers, strings, lists, dicts) to
    ``path`` atomically: a temporary file, flushed to disk, then renamed."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_params(path: str) -> Any:
    """What :func:`save_params` wrote, on the CPU, unpickling no object."""
    return torch.load(path, map_location="cpu", weights_only=True)
