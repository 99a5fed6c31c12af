"""Training loop (counterpart of the single-device paths of
``downgan_tpu/training/trainer.py``: device-resident on both schedules,
host-fed on the reference one).

Per epoch: the batch order from ``epoch_permutation`` of
``np.random.default_rng((seed, epoch))``, every batch gathered on the
device (a ``DeviceDataset``) or brought there by ``prefetch_batches`` (a
``HostDataset`` in host RAM, or a ``StreamDataset`` on disk; the same
batches, so the same trajectory), the train step's metrics summed on the
device, one host sync at the end of the epoch. On the reference schedule one step takes one batch
and ``gen_loss`` is rescaled to its mean over the generator updates
actually run; on the fused schedule the order is cut to whole rounds of
``critic_iterations`` batches (``trainer.py:449-473``), one round takes
one (n, B) block and ``gen_loss`` is its one update's. Then the means are
logged to the tracked run, and a
``NonFiniteLossError`` on a non-finite mean before anything is
checkpointed; then a test pass over every test sample
(:func:`full_split_metric_pass`), which also scores the EMA generator when
it selects a best epoch; the best bundle on an improvement; a checkpoint
every ``save_every`` epochs. SIGTERM stops the loop at the next epoch
boundary with the full state checkpointed, and :meth:`Trainer.maybe_resume`
continues the exact trajectory.

Every ``plot_every`` epochs a tracked run gets the grid figure of each
split (``trainer.py:620-633`` of the JAX package, reference
``gen_grid_plots.py``): 20 samples picked with replacement by a fixed seed
(``utils/plots.py::grid_sample_indices``), their fakes made for them alone
by the live generator on the trainer's device (:func:`grid_rows`: the DRB
kernel on the card), drawn with matplotlib into the run's artifact
directory (``<split>_images.png``, and ``<split>_images_epoch_<N>.png``
every 10th epoch). Without matplotlib (the card's machine has none) the
trainer says so once and computes no rows; the rows come from rank 0 only,
and not once SIGTERM asked to stop. ``tensorboard_dir`` also logs each
epoch's tagged means through ``tracking/tensorboard.py`` (tensorboardX).

Data-parallel training (``multihost``, the JAX package's multi-host
branch, ``trainer.py:125-186``): one process per card in a process group
(``parallel.multihost.initialize``). Every rank builds the same seeded
state, and rank 0's is broadcast to the others
(``parallel.mesh.replicate_state``). Each rank takes its contiguous rows of
every global batch of the shared permutation: gathered on its device from
a replicated ``DeviceDataset`` (``parallel.dp.device_batches``, whatever
``hp.fused_epoch`` says), or read alone from a ``HostDataset`` or
``StreamDataset`` through ``prefetch_batches``. The step averages the
gradients and the metrics across the ranks, so every rank ends each step
with the same weights and the same means, and ``halt_on_nonfinite``
decides alike everywhere. The test pass runs whole on every rank (the same
weights and batches, so the same means as one process). Tracking, printed
lines and best bundles come from rank 0; checkpoints are written by rank 0
between barriers and restored by every rank. The stop at an epoch boundary
after a SIGTERM is agreed by all ranks (any rank preempted: all stop at the
same epoch). The EOF basis is fit on every rank and rank 0's is broadcast,
so the ranks use the same bits whatever LAPACK's threads did.

A stochastic generator (``config.noise_channels > 0``) needs nothing of the
loop: the step draws its training latents as functions of ``(seed, step,
stream)`` (``wgan.py::train_latent``) and every test pass, device-resident,
host-fed or streamed, EMA scoring included, scores the one fixed
realization (``wgan.py::fixed_latent`` through ``build_eval_metrics``). So
a checkpoint holds no latent state, and a resume draws the latents the
uninterrupted run would have.

Under ``hp.eof_lambda > 0`` the trainer fits the EOF basis of the
generator's EOF term from the training fine fields when it is built
(:func:`training_eof_components`, ``trainer.py:245-254`` of the JAX
package), on every residency tier, unless one is given.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from downgan_tpu_torch.config.config import Config
from downgan_tpu_torch.data.dataset import DeviceDataset
from downgan_tpu_torch.data.eof import fit_eofs_per_channel
from downgan_tpu_torch.data.feed import FeedStats, HostDataset, prefetch_batches
from downgan_tpu_torch.inference import write_generator_bundle
from downgan_tpu_torch.parallel.dp import GroupSync, device_batches
from downgan_tpu_torch.parallel.mesh import (
    batch_rows,
    broadcast_tensors,
    in_group,
    rank,
    replicate_state,
    rows_of,
    world_size,
)
from downgan_tpu_torch.training.state import make_train_state
from downgan_tpu_torch.training.wgan import (
    LOCAL_SYNC,
    build_eval_metrics,
    build_fused_round,
    build_train_step,
    fixed_latent,
    g_updates_in_window,
    with_latent,
)
from downgan_tpu_torch.utils.plots import gen_grid_images, grid_sample_indices, have_matplotlib
from downgan_tpu_torch.utils.profiling import annotate

EMA_SUFFIX = "__ema"


class NonFiniteLossError(RuntimeError):
    """Training diverged: an epoch's mean metrics contain NaN/Inf."""


def _add(sums: Dict[str, torch.Tensor], metrics: Dict[str, torch.Tensor]) -> None:
    """Add a step's metrics into the epoch's device sums (a
    ``trainer.accumulate`` span)."""
    with annotate("trainer.accumulate"):
        for k, v in metrics.items():
            sums[k] = sums[k] + v if k in sums else v.detach().clone()


def _to_host_means(sums: Dict[str, torch.Tensor], n: int) -> Dict[str, float]:
    """One device-to-host copy for the whole dict: the epoch's one host
    sync (a ``trainer.epoch_sync`` span)."""
    if not sums:
        return {}
    with annotate("trainer.epoch_sync"):
        values = torch.stack([v.float() for v in sums.values()]).cpu().tolist()
    return {k: v / max(n, 1) for k, v in zip(sums, values)}


def full_split_metric_pass(ds: DeviceDataset | HostDataset, batch_size: int,
                           eval_batch: Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]],
                           device: str | torch.device | None = None) -> Dict[str, float]:
    """Metric means over EVERY sample of ``ds``: full batches in order, then
    a ragged tail as its own smaller batch (so MS-SSIM's batch-global
    normalization sees the tail alone, as the reference's last partial
    batch), each batch weighted equally. ``eval_batch(coarse, fine)``
    returns device scalars, summed on the device; one host sync. A host
    dataset's batches come through ``prefetch_batches`` onto ``device``."""
    n = len(ds)
    starts = range(0, n, batch_size)  # the last start is the tail's, if any
    if isinstance(ds, DeviceDataset):
        idx = torch.arange(n, device=ds.device)
        batches = (ds.gather(idx[lo:lo + batch_size]) for lo in starts)
    else:
        batches = prefetch_batches(ds, [np.arange(lo, min(lo + batch_size, n)) for lo in starts],
                                   device)
    sums: Dict[str, torch.Tensor] = {}
    for coarse, fine in batches:
        _add(sums, eval_batch(coarse, fine))
    return _to_host_means(sums, len(starts))


def grid_rows(config: Config, gen: torch.nn.Module, ds, n_samples: int = 20, seed: int = 0
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The (coarse, fake, real) NHWC float32 rows of a grid figure: the
    samples :func:`~downgan_tpu_torch.utils.plots.grid_sample_indices` picks
    from ``ds`` (on a device, in host RAM or on disk), and the fakes
    ``gen`` makes for them alone on its device, a stochastic generator with
    the fixed latent (:func:`~downgan_tpu_torch.training.wgan.fixed_latent`)."""
    idx = grid_sample_indices(len(ds), n_samples, seed)
    device = next(gen.parameters()).device
    if isinstance(ds, DeviceDataset):
        coarse, fine = ds.gather(torch.as_tensor(idx, device=ds.device))
    else:
        coarse, fine = (torch.from_numpy(np.ascontiguousarray(a[idx], np.float32))
                        .permute(0, 3, 1, 2) for a in (ds.coarse, ds.fine))
    coarse = coarse.to(device).contiguous()
    z = None
    if config.noise_channels:
        n, _, h, w = coarse.shape
        z = torch.from_numpy(fixed_latent(config, (n, h, w, config.noise_channels)))
        z = z.permute(0, 3, 1, 2).to(device)
    with torch.no_grad():
        fake = gen(with_latent(coarse, z))
    nhwc = lambda t: t.permute(0, 2, 3, 1).float().cpu().numpy()  # noqa: E731
    return nhwc(coarse), nhwc(fake), nhwc(fine)


def training_eof_components(train: DeviceDataset | HostDataset, n_components: int) -> np.ndarray:
    """The (n_components, C, H*W) per-channel EOF stack of ``train``'s fine
    fields, wherever they lie: a device set's NCHW tensor is brought to
    the host and viewed NHWC (each channel flattens over (H, W) row-major in
    both layouts), a host or streamed set's NHWC rows are read whole."""
    if isinstance(train, DeviceDataset):
        fine = train.fine.cpu().numpy().transpose(0, 2, 3, 1)
    else:
        fine = np.asarray(train.fine)
    return fit_eofs_per_channel(fine, n_components)


class Trainer:
    """WGAN-GP trainer over train and test sets on the device
    (``DeviceDataset``) or, on the reference schedule, in host RAM or on
    disk (``HostDataset``, ``StreamDataset``: ``feed_stats`` then holds
    each train epoch's :class:`~downgan_tpu_torch.data.feed.FeedStats`).

    ``train(epochs)`` returns the per-epoch records ``{"epoch", "steps",
    "seconds", "train", "test"}`` (``test`` is absent without a test set or
    after a preemption; ``test_ema`` holds the EMA generator's test means
    when it is scored) and prints them as one JSON line each, every
    ``print_every`` epochs; ``history`` keeps every epoch's record.
    ``steps`` counts steps on the reference schedule and rounds on the
    fused one. ``seconds`` is the train part of the epoch, to its host
    sync.
    ``forwards`` counts the generator forwards by kind: the train step's
    ``critic_fake``, ``update`` and ``metric``, the test pass's ``test``
    and, when the EMA generator is scored, ``test_ema``.

    ``run`` is an optional :class:`downgan_tpu_torch.tracking.Run`,
    ``checkpoint_manager`` an optional
    :class:`downgan_tpu_torch.utils.checkpoint.CheckpointManager`.
    ``track_best`` names a test metric: after each test pass that improves
    it (``best_mode`` "max" or "min", default "max" for MS-SSIM), the
    serving weights (the EMA generator when ``hp.ema_decay > 0``, which is
    then also what is scored) are written as a bundle to ``best_dir``
    (default ``<run artifacts>/best``) beside a ``best.json``.

    ``eof_components`` is the EOF basis of the ``hp.eof_lambda`` term;
    without one the trainer fits it from ``train``
    (``eof_fit_seconds`` then says how long that took).

    ``multihost`` trains data-parallel over the ranks of the job's process
    group (module docstring); None turns it on when the group has more
    than one rank. Each rank passes the same config and sets
    (``hp.batch_size`` is the global batch and must divide over the ranks)
    and its own ``device``; ``run`` counts on rank 0 only.

    ``plot_every`` is the grid figures' cadence in epochs (module
    docstring; ``plot_forwards`` counts their generator forwards, apart from
    ``forwards``); ``tensorboard_dir`` also logs the epoch means to
    TensorBoard."""

    def __init__(self, config: Config, train: DeviceDataset,
                 test: Optional[DeviceDataset] = None, device: str | torch.device = "cuda",
                 run=None, checkpoint_manager=None, save_every: Optional[int] = None,
                 print_every: Optional[int] = None, halt_on_nonfinite: bool = True,
                 track_best: Optional[str] = None, best_mode: Optional[str] = None,
                 best_dir: Optional[str] = None, eof_components=None,
                 multihost: Optional[bool] = None, plot_every: int = 1,
                 tensorboard_dir: Optional[str] = None):
        self.config = config
        self.multihost = world_size() > 1 if multihost is None else multihost
        if self.multihost and not in_group():
            raise ValueError("multihost training needs a process group: call "
                             "parallel.multihost.initialize first")
        # A trainer that is not data-parallel takes whole batches, even in a group.
        self.rank, self.world = (rank(), world_size()) if self.multihost else (0, 1)
        self._primary = rank() == 0
        rows_of(config.hp.batch_size, self.rank, self.world)  # refuses a batch that does not divide
        self.state = make_train_state(config, device)
        self.device = next(self.state.generator.parameters()).device
        if self.multihost:
            replicate_state(self.state)
        for name, ds in (("train", train), ("test", test)):
            if isinstance(ds, DeviceDataset) and ds.device != self.device:
                raise ValueError(f"the {name} set lies on {ds.device}, the trainer on {self.device}")
        self._host_fed = isinstance(train, HostDataset)
        if self._host_fed and config.hp.fused_epoch:
            raise ValueError(
                "HostDataset training needs hp.fused_epoch=False: the fused epoch "
                "gathers batches from device-resident arrays; the per-step loop streams "
                "host batches through data.feed instead")
        if self._host_fed and config.hp.schedule == "fused":
            raise ValueError(
                "HostDataset training supports schedule='reference' only (the fused "
                "n-critic round consumes stacked multi-batch inputs, which the host feed "
                "does not assemble)")
        self.feed_stats: List[FeedStats] = []
        if len(train) < config.hp.batch_size:
            raise ValueError(f"{len(train)} training samples make no batch of "
                             f"{config.hp.batch_size}")
        self.train_ds, self.test_ds = train, test
        # Tracking comes from rank 0 only; every rank checkpoints (rank 0
        # writes) and tracks the best value (rank 0 writes the bundle).
        self.run, self.ckpt = (run if self._primary else None), checkpoint_manager
        self.save_every = config.hp.save_every if save_every is None else save_every
        self.print_every = config.hp.print_every if print_every is None else print_every
        if self.save_every < 1 or self.print_every < 1 or plot_every < 1:
            raise ValueError("save_every/print_every/plot_every are epoch cadences and must be "
                             ">= 1 (use a huge value to effectively disable)")
        self.plot_every = plot_every
        # Figures for a tracked run (rank 0's) where matplotlib can draw them.
        self._plots = self.run is not None and have_matplotlib()
        if self.run is not None and not self._plots:
            self._say("grid figures skipped: matplotlib is not installed here")
        self.plot_forwards = 0
        self.tb = None
        if tensorboard_dir is not None:
            from downgan_tpu_torch.tracking.tensorboard import TensorBoardSink

            self.tb = TensorBoardSink(tensorboard_dir)
        # No reference equivalent (the reference trains on through NaNs):
        # stop on the first non-finite epoch, before it is checkpointed, so
        # the latest checkpoint stays a good restore point.
        self.halt_on_nonfinite = halt_on_nonfinite
        self.preempted = False

        self.track_best = track_best
        self.best_value: Optional[float] = None
        self.best_epoch: Optional[int] = None
        if track_best:
            if test is None:
                raise ValueError("track_best selects on a TEST metric and needs a test dataset")
            # The test pass emits exactly the configured metrics; any other
            # name would never match and no bundle would be written.
            known = set(config.hp.metrics_to_calculate)
            if track_best not in known:
                raise ValueError(f"track_best metric {track_best!r} is not produced by this "
                                 f"run's test pass; available: {sorted(known)}")
            if best_mode is None:
                best_mode = "max" if track_best.upper().startswith("MSSSIM") else "min"
            if best_mode not in ("max", "min"):
                raise ValueError(f"best_mode must be 'max' or 'min', got {best_mode!r}")
            if best_dir is None and run is not None:
                best_dir = os.path.join(run.artifact_dir, "best")
            if best_dir is None and self._primary:
                raise ValueError("track_best needs best_dir (or a tracked run whose "
                                 "artifact dir provides the default <artifacts>/best)")
        self.best_mode, self.best_dir = best_mode, best_dir

        self.eof_fit_seconds: Optional[float] = None
        if config.hp.eof_lambda and eof_components is None:
            t0 = time.perf_counter()
            eof_components = training_eof_components(train, config.hp.ncomp)
            if self.multihost:
                basis = torch.from_numpy(eof_components)
                broadcast_tensors([basis], self.device)
                eof_components = basis.numpy()
            self.eof_fit_seconds = time.perf_counter() - t0
            self._say(f"EOF basis: {eof_components.shape[0]} components per channel fit from "
                      f"{len(train)} training fields in {self.eof_fit_seconds:.2f} s")
        self.eof_components = eof_components

        self.epoch = 0
        self.history: List[dict] = []
        build = build_fused_round if config.hp.schedule == "fused" else build_train_step
        self.step_fn = build(config, self.state.generator, self.state.critic,
                             eof_components=eof_components,
                             sync=GroupSync() if self.multihost else LOCAL_SYNC)
        self._eval = build_eval_metrics(config)
        self.forwards = self.step_fn.forwards
        self.forwards["test"] = 0
        # The bundle holds the EMA weights, so selection scores them.
        self._score_ema = bool(track_best) and self.state.g_ema is not None
        if self._score_ema:
            self.forwards["test_ema"] = 0

    # -- resume and warm start -------------------------------------------
    def maybe_resume(self) -> bool:
        """Restore the latest checkpoint, if there is one, and continue at
        the epoch after it (checkpoints are written after an epoch ends).
        The best-epoch record is read back from ``best.json`` when it
        tracks the same metric and mode, so the first test pass after a
        resume does not overwrite a better bundle. Returns whether it
        resumed."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        last = self.ckpt.latest_step()
        self.state.load_state_dict(self.ckpt.restore(last))
        self.epoch = last + 1
        if self.track_best and self.best_dir is not None:  # rank 0's, across ranks
            best_json = os.path.join(self.best_dir, "best.json")
            if os.path.exists(best_json):
                with open(best_json) as f:
                    rec = json.load(f)
                if rec.get("metric") == self.track_best and rec.get("mode") == self.best_mode:
                    self.best_value = float(rec["value"])
                    self.best_epoch = int(rec.get("epoch", -1))
        self._say(f"resumed from checkpoint of epoch {last}; continuing at epoch {self.epoch}")
        return True

    def warm_start(self, g_weights: Mapping[str, torch.Tensor],
                   c_weights: Optional[Mapping[str, torch.Tensor]] = None) -> None:
        """Start from pretrained weights (a bundle's): the generator's, the
        EMA reset to them, and optionally the critic's. Optimizer states and
        the step stay fresh. Call before training, after
        :meth:`maybe_resume` (a resume supersedes a warm start)."""
        self.state.generator.load_state_dict(g_weights)
        if self.state.g_ema is not None:
            self.state.g_ema.load_state_dict(g_weights)
        if c_weights is not None:
            self.state.critic.load_state_dict(c_weights)
        what = "generator+critic" if c_weights is not None else "generator"
        self._say(f"warm start: {what} params loaded; optimizer state and step counter start "
                  "fresh")

    def _say(self, message: str) -> None:
        """A status line on stderr, from rank 0 only."""
        if self._primary:
            print(message, file=sys.stderr, flush=True)

    # -- epoch internals ---------------------------------------------------
    def _epoch_rng(self) -> np.random.Generator:
        """Permutations are a pure function of (seed, epoch), as in the JAX
        package's trainer."""
        return np.random.default_rng((self.config.seed, self.epoch))

    def run_train_epoch(self) -> tuple[int, Dict[str, float]]:
        """One epoch of steps (reference schedule) or rounds (fused);
        returns their count and the epoch's train means."""
        hp = self.config.hp
        perm = self.train_ds.epoch_perm(self._epoch_rng(), hp.batch_size)
        start = self.state.step
        sums: Dict[str, torch.Tensor] = {}
        if self._host_fed:
            # Each rank reads only its rows of every global batch.
            stats = FeedStats()
            self.feed_stats.append(stats)
            rows = batch_rows(perm, self.rank, self.world, axis=-1)
            for coarse, fine in prefetch_batches(self.train_ds, rows, self.device, stats=stats):
                _add(sums, self.step_fn(self.state, coarse, fine))
            return self._train_means(start, len(perm), sums)
        n = 0
        for coarse, fine in device_batches(self.config, self.train_ds, perm, self.rank,
                                           self.world):
            _add(sums, self.step_fn(self.state, coarse, fine))
            n += 1
        if hp.schedule == "fused":
            return n, _to_host_means(sums, n)
        return self._train_means(start, n, sums)

    def _train_means(self, start: int, n: int, sums: Dict[str, torch.Tensor]
                     ) -> tuple[int, Dict[str, float]]:
        """The reference schedule's epoch means over ``n`` steps from step
        ``start``. ``gen_loss`` is an exact 0.0 on the steps that skip the
        generator update: its mean is rescaled to the mean over the updates
        run."""
        means = _to_host_means(sums, n)
        n_upd = g_updates_in_window(start, n, self.config.hp.critic_iterations)
        if "gen_loss" in means and n_upd:
            means["gen_loss"] *= n / n_upd
        return n, means

    def run_test_pass(self) -> Dict[str, float]:
        """Test means of the live generator and, when the EMA generator is
        scored, of it too under ``<name>__ema`` keys, from the same batches
        in one pass (the JAX package's ``build_eval_metrics_pair``)."""
        gen, critic, ema = self.state.generator, self.state.critic, self.state.g_ema

        def eval_batch(coarse, fine):
            self.forwards["test"] += 1
            out = self._eval(gen, critic, coarse, fine)
            if self._score_ema:
                self.forwards["test_ema"] += 1
                out.update({k + EMA_SUFFIX: v for k, v in self._eval(ema, critic, coarse,
                                                                     fine).items()})
            return out

        return full_split_metric_pass(self.test_ds, self.config.hp.batch_size, eval_batch,
                                      self.device)

    def _update_best(self, means: Dict[str, float]) -> None:
        """On an improvement of the tracked metric in ``means`` (the test
        means of the serving weights), write those weights as a bundle and
        ``best.json`` (``metric``, ``mode``, ``value``, ``epoch``, ``ema``)."""
        use_ema = self.state.g_ema is not None
        if use_ema and self.run is not None and self.track_best in means:
            self.run.log_metrics({f"{self.track_best}_ema_test": float(means[self.track_best])},
                                 step=self.epoch)
        val = means.get(self.track_best)
        if val is None or not np.isfinite(val):
            return
        if self.best_value is not None and not (
                val > self.best_value if self.best_mode == "max" else val < self.best_value):
            return
        self.best_value, self.best_epoch = float(val), self.epoch
        if not self._primary:
            return
        serving = self.state.g_ema if use_ema else self.state.generator
        write_generator_bundle(self.best_dir, self.config, serving.state_dict())
        with open(os.path.join(self.best_dir, "best.json"), "w") as f:
            json.dump({"metric": self.track_best, "mode": self.best_mode,
                       "value": self.best_value, "epoch": self.epoch, "ema": use_ema}, f, indent=2)
        if self.run is not None:
            self.run.log_metrics({f"best_{self.track_best}_test": self.best_value}, step=self.epoch)

    def _log_epoch(self, split: str, means: Dict[str, float]) -> None:
        tagged = {f"{k}_{split}": v for k, v in means.items()}
        if self.tb is not None:
            self.tb.log_metrics(tagged, step=self.epoch)
            self.tb.flush()
        if self.run is None:
            return
        self.run.log_metrics(tagged, step=self.epoch)
        self.run.append_csv_row(f"{split}_metrics.csv", {"epoch": self.epoch, **means})

    def _plot_split(self, split: str, ds) -> None:
        """The grid figure of ``split`` at this epoch, every ``plot_every``
        epochs, when the trainer draws figures."""
        if not self._plots or self.epoch % self.plot_every:
            return
        coarse, fake, real = grid_rows(self.config, self.state.generator, ds)
        self.plot_forwards += 1
        gen_grid_images(self.run.artifact_dir, coarse, fake, real, self.epoch, split,
                        select=False)

    def _install_preemption_handler(self):
        """SIGTERM -> a clean stop at the next epoch boundary with the full
        state checkpointed (spot reclaims, maintenance, evictions send
        SIGTERM; its default action would lose everything since the last
        checkpoint). The handler only sets a flag. Returns ``(installed,
        previous_handler)``; off the main thread nothing is installed."""
        if threading.current_thread() is not threading.main_thread():
            return False, None

        def on_term(signum, frame):
            self.preempted = True

        try:
            return True, signal.signal(signal.SIGTERM, on_term)
        except ValueError:  # an embedded interpreter that refuses handlers
            return False, None

    def _should_stop(self) -> bool:
        """Whether to stop at this epoch boundary: this process was sent
        SIGTERM or, across ranks, any rank was (a SUM all-reduce of the
        flags), so every rank stops at the same epoch and meets the final
        checkpoint's barriers."""
        if self.multihost:
            flag = torch.tensor([float(self.preempted)], device=self.device)
            torch.distributed.all_reduce(flag)
            self.preempted = bool(flag.item() > 0)
        return self.preempted

    # -- main loop ---------------------------------------------------------
    def train(self, epochs: Optional[int] = None) -> List[dict]:
        epochs = self.config.hp.epochs if epochs is None else epochs
        first = len(self.history)
        installed, previous = self._install_preemption_handler()
        try:
            self._train_loop(epochs)
            # Saved while the handler is still installed, so a second
            # SIGTERM during the save sets the flag instead of killing the
            # process mid-write. An epochs=0 run trained nothing and writes
            # no checkpoint a later resume would pick up.
            if self.ckpt is not None and self.epoch > 0:
                self.ckpt.save(self.epoch - 1, self.state)
                self.ckpt.wait()
        finally:
            if installed:
                # None: the previous handler was set outside Python and
                # cannot be restored; the default action is.
                signal.signal(signal.SIGTERM, previous if previous is not None else signal.SIG_DFL)
            if self.tb is not None:
                # Every event on disk when train returns (a later log reopens it).
                self.tb.close()
        return self.history[first:]

    def _train_loop(self, epochs: int) -> None:
        while self.epoch < epochs:
            t0 = time.perf_counter()
            n, train_means = self.run_train_epoch()  # ends in a host sync
            record = {"epoch": self.epoch, "steps": n, "seconds": time.perf_counter() - t0,
                      "train": train_means}
            self._log_epoch("train", train_means)
            bad = sorted(k for k, v in train_means.items() if not np.isfinite(v))
            if bad and self.halt_on_nonfinite:
                raise NonFiniteLossError(
                    f"non-finite training metrics at epoch {self.epoch}: {bad} — state not "
                    "checkpointed; restore the last checkpoint and lower lr / inspect data "
                    "(set halt_on_nonfinite=False to train through)")
            # Checked straight after the train epoch: within a preemption's
            # grace period the test pass and the best bundle would take the
            # time the checkpoint needs.
            stopping = self._should_stop()
            if not stopping:
                self._plot_split("train", self.train_ds)
            if not stopping and self.test_ds is not None and len(self.test_ds) > 0:
                means = self.run_test_pass()
                record["test"] = {k: v for k, v in means.items() if not k.endswith(EMA_SUFFIX)}
                self._log_epoch("test", record["test"])
                if self._score_ema:
                    record["test_ema"] = {k[:-len(EMA_SUFFIX)]: v for k, v in means.items()
                                          if k.endswith(EMA_SUFFIX)}
                if self.track_best:
                    self._update_best(record.get("test_ema", record["test"]))
                self._plot_split("test", self.test_ds)
            if self.ckpt is not None and self.epoch % self.save_every == 0:
                self.ckpt.save(self.epoch, self.state)
            if self._primary and self.epoch % self.print_every == 0:
                print(json.dumps(record), flush=True)
            self.history.append(record)
            self.epoch += 1
            # Checked again, so a SIGTERM that lands during the test pass or
            # the save stops here rather than after one more train epoch.
            if stopping or self._should_stop():
                tail = ("full state checkpointed; resume continues the exact trajectory"
                        if self.ckpt is not None else
                        "no checkpoint manager configured; state NOT saved")
                self._say(f"preempted (SIGTERM): stopping after epoch {self.epoch - 1}; {tail}")
                break
