"""Training loop (counterpart of the device-resident, reference-schedule
path of ``downgan_tpu/training/trainer.py``).

Per epoch: the batch order from ``epoch_permutation`` of
``np.random.default_rng((seed, epoch))``, every batch gathered on the
device, the train step's metrics summed on the device, one host sync at
the end of the epoch, ``gen_loss`` rescaled to its mean over the generator
updates actually run, ``NonFiniteLossError`` on a non-finite mean, then a
test pass over every test sample (:func:`full_split_metric_pass`).
Checkpoints, tracking, plots, EMA, best-metric bundles and preemption come
with later slices of the port.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from downgan_tpu_torch.config.config import Config
from downgan_tpu_torch.data.dataset import DeviceDataset
from downgan_tpu_torch.training.state import make_train_state
from downgan_tpu_torch.training.wgan import (
    build_eval_metrics,
    build_train_step,
    g_updates_in_window,
)


class NonFiniteLossError(RuntimeError):
    """Training diverged: an epoch's mean metrics contain NaN/Inf."""


def _add(sums: Dict[str, torch.Tensor], metrics: Dict[str, torch.Tensor]) -> None:
    for k, v in metrics.items():
        sums[k] = sums[k] + v if k in sums else v.detach().clone()


def _to_host_means(sums: Dict[str, torch.Tensor], n: int) -> Dict[str, float]:
    """One device-to-host copy for the whole dict."""
    if not sums:
        return {}
    values = torch.stack([v.float() for v in sums.values()]).cpu().tolist()
    return {k: v / max(n, 1) for k, v in zip(sums, values)}


def full_split_metric_pass(ds: DeviceDataset, batch_size: int,
                           eval_batch: Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]
                           ) -> Dict[str, float]:
    """Metric means over EVERY sample of ``ds``: full batches in order, then
    a ragged tail as its own smaller batch (so MS-SSIM's batch-global
    normalization sees the tail alone, as the reference's last partial
    batch), each batch weighted equally. ``eval_batch(coarse, fine)``
    returns device scalars, summed on the device; one host sync."""
    idx = torch.arange(len(ds), device=ds.device)
    sums: Dict[str, torch.Tensor] = {}
    starts = range(0, len(ds), batch_size)  # the last start is the tail's, if any
    for lo in starts:
        _add(sums, eval_batch(*ds.gather(idx[lo:lo + batch_size])))
    return _to_host_means(sums, len(starts))


class Trainer:
    """WGAN-GP trainer over device-resident train and test sets.

    ``train(epochs)`` returns, and prints as one JSON line each, the
    per-epoch records ``{"epoch", "steps", "seconds", "train",
    "test"}`` (``test`` is absent without a test set); ``history`` keeps
    every epoch's record. ``seconds`` is the train part of the epoch, to
    its host sync. ``forwards`` counts the generator forwards by kind: the
    train step's ``critic_fake``, ``update`` and ``metric``, and the test
    pass's ``test``."""

    def __init__(self, config: Config, train: DeviceDataset,
                 test: Optional[DeviceDataset] = None, device: str | torch.device = "cuda"):
        self.config = config
        self.state = make_train_state(config, device)
        self.device = next(self.state.generator.parameters()).device
        for name, ds in (("train", train), ("test", test)):
            if ds is not None and ds.device != self.device:
                raise ValueError(f"the {name} set lies on {ds.device}, the trainer on {self.device}")
        if len(train) < config.hp.batch_size:
            raise ValueError(f"{len(train)} training samples make no batch of "
                             f"{config.hp.batch_size}")
        self.train_ds, self.test_ds = train, test
        self.epoch = 0
        self.history: List[dict] = []
        self.step_fn = build_train_step(config, self.state.generator, self.state.critic)
        self._eval = build_eval_metrics(config)
        self.forwards = self.step_fn.forwards
        self.forwards["test"] = 0

    def _epoch_rng(self) -> np.random.Generator:
        """Permutations are a pure function of (seed, epoch), as in the JAX
        package's trainer."""
        return np.random.default_rng((self.config.seed, self.epoch))

    def run_train_epoch(self) -> tuple[int, Dict[str, float]]:
        hp = self.config.hp
        perm = torch.from_numpy(self.train_ds.epoch_perm(self._epoch_rng(), hp.batch_size))
        perm = perm.to(self.device, torch.long)
        start = self.state.step
        sums: Dict[str, torch.Tensor] = {}
        for idx in perm:
            _add(sums, self.step_fn(self.state, *self.train_ds.gather(idx)))
        n = len(perm)
        means = _to_host_means(sums, n)
        # gen_loss is an exact 0.0 on the steps that skip the generator
        # update; rescale the mean to the mean over the updates run.
        n_upd = g_updates_in_window(start, n, hp.critic_iterations)
        if "gen_loss" in means and n_upd:
            means["gen_loss"] *= n / n_upd
        return n, means

    def run_test_pass(self) -> Dict[str, float]:
        gen, critic = self.state.generator, self.state.critic

        def eval_batch(coarse, fine):
            self.forwards["test"] += 1
            return self._eval(gen, critic, coarse, fine)

        return full_split_metric_pass(self.test_ds, self.config.hp.batch_size, eval_batch)

    def train(self, epochs: Optional[int] = None) -> List[dict]:
        epochs = self.config.hp.epochs if epochs is None else epochs
        first = len(self.history)
        while self.epoch < epochs:
            t0 = time.perf_counter()
            n, train_means = self.run_train_epoch()  # ends in a host sync
            record = {"epoch": self.epoch, "steps": n, "seconds": time.perf_counter() - t0,
                      "train": train_means}
            bad = sorted(k for k, v in train_means.items() if not np.isfinite(v))
            if bad:
                raise NonFiniteLossError(
                    f"non-finite training metrics at epoch {self.epoch}: {bad}")
            if self.test_ds is not None and len(self.test_ds) > 0:
                record["test"] = self.run_test_pass()
            print(json.dumps(record), flush=True)
            self.history.append(record)
            self.epoch += 1
        return self.history[first:]
