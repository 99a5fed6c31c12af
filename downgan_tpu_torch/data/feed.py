"""Host-RAM dataset and its batch feed onto the device (counterpart of
``downgan_tpu/data/feed.py``).

The device-resident ``DeviceDataset`` holds a whole split on the card. A
set too big for that stays in host RAM (:class:`HostDataset`) or on disk
(``data/stream.py``), and :func:`prefetch_batches` brings one batch at a
time: one reader thread gathers the batch's rows, in the epoch's order,
into a ring of pinned host buffers and starts their copy to the device on
a copy stream of its own, ``prefetch`` batches ahead of the consumer. The
batches are NCHW on the device, made from the NHWC rows as
``DeviceDataset.from_numpy`` makes them, so training from either residency
takes the same bits.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Tuple

import numpy as np
import torch

from downgan_tpu_torch.data.dataset import epoch_permutation


class HostDataset:
    """Paired (coarse, fine) arrays resident in host RAM, NHWC float32."""

    def __init__(self, coarse: np.ndarray, fine: np.ndarray):
        if coarse.shape[0] != fine.shape[0]:
            raise ValueError(f"coarse/fine sample counts differ: {coarse.shape[0]} vs "
                             f"{fine.shape[0]}")
        self.coarse = np.ascontiguousarray(coarse, dtype=np.float32)
        self.fine = np.ascontiguousarray(fine, dtype=np.float32)

    def __len__(self) -> int:
        return int(self.coarse.shape[0])

    def epoch_perm(self, rng: np.random.Generator, batch_size: int,
                   shuffle: bool = True) -> np.ndarray:
        """The drop-last permutation ``DeviceDataset`` draws (one shared rule:
        the residency tiers see the same batch order)."""
        return epoch_permutation(len(self), rng, batch_size, shuffle)


@dataclass
class FeedStats:
    """What one :func:`prefetch_batches` run did. The reader thread's host
    seconds: ``read_s`` gathering (and, from disk, decoding) rows into the
    pinned buffers, ``ring_wait_s`` waiting for a buffer's previous copy to
    finish before refilling it. ``consumer_wait_ms`` is device time."""

    batches: int = 0
    read_s: float = 0.0
    ring_wait_s: float = 0.0
    pinned_bytes: int = 0
    waits: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = field(default_factory=list)

    def consumer_wait_ms(self) -> float:
        """Device milliseconds the consumer's stream stalled on the copies'
        events (0 off the card). Read it after the consumer's work has
        been synchronized."""
        return sum(before.elapsed_time(after) for before, after in self.waits)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2).contiguous()


class _PinnedSlot:
    """One ring entry: pinned NHWC buffers for a batch's coarse and fine rows
    and the event of the last copy that read them."""

    def __init__(self, dataset, rows: int):
        self.coarse = torch.empty((rows, *dataset.coarse.shape[1:]), pin_memory=True)
        self.fine = torch.empty((rows, *dataset.fine.shape[1:]), pin_memory=True)
        self.copied = None

    def fill(self, dataset, idx: np.ndarray) -> List[torch.Tensor]:
        """The rows ``idx`` of ``dataset`` in this slot's buffers: views of
        their first ``len(idx)`` rows."""
        views = []
        for src, buf in ((dataset.coarse, self.coarse), (dataset.fine, self.fine)):
            view = buf[:len(idx)]
            if isinstance(src, np.ndarray):
                np.take(src, idx, axis=0, out=view.numpy())
            else:  # a LazyField: rows read and decoded from disk
                view.numpy()[...] = src[idx]
            views.append(view)
        return views


def prefetch_batches(dataset, perm: Iterable[np.ndarray], device: str | torch.device,
                     prefetch: int = 2, stats: FeedStats | None = None,
                     copy_stream: torch.cuda.Stream | None = None
                     ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Yield the (coarse, fine) batches of ``dataset`` at each index array of
    ``perm`` (rows of an epoch permutation, or batches of any sizes), NCHW
    float32 on ``device``, with up to ``prefetch`` batches read ahead.

    ``dataset`` has NHWC ``coarse``/``fine`` fields that take an index
    array (a :class:`HostDataset`'s arrays or a stream's ``LazyField``s).
    One reader thread keeps batch order and read order deterministic; an
    exception there is raised here, at the batch it was reading.

    On a CUDA device each batch is gathered into one of ``prefetch`` pinned
    buffers and copied with ``non_blocking`` on a copy stream, then made
    NCHW there; the current stream waits on the copy's event before it uses
    the batch. A buffer is refilled only after the event of the copy that
    last read it has completed. ``copy_stream`` is that stream (default: a
    new one). On the CPU the batches are plain tensors.
    """
    device = torch.device(device)
    stats = FeedStats() if stats is None else stats
    batches = [np.asarray(idx) for idx in perm]
    if not batches:
        return
    depth = max(1, prefetch)

    if device.type == "cuda":
        copy_stream = torch.cuda.Stream(device) if copy_stream is None else copy_stream
        rows = max(len(idx) for idx in batches)
        ring = [_PinnedSlot(dataset, rows) for _ in range(min(depth, len(batches)))]
        stats.pinned_bytes = sum(s.coarse.nbytes + s.fine.nbytes for s in ring)

        def read(i: int, idx: np.ndarray):
            slot = ring[i % len(ring)]
            if slot.copied is not None:
                t0 = time.perf_counter()
                slot.copied.synchronize()
                stats.ring_wait_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            coarse, fine = slot.fill(dataset, idx)
            stats.read_s += time.perf_counter() - t0
            with torch.cuda.stream(copy_stream):
                coarse = _nchw(coarse.to(device, non_blocking=True))
                fine = _nchw(fine.to(device, non_blocking=True))
                slot.copied = torch.cuda.Event()
                slot.copied.record(copy_stream)
            stats.batches += 1
            return coarse, fine, slot.copied
    else:
        def read(i: int, idx: np.ndarray):
            t0 = time.perf_counter()
            coarse, fine = (torch.from_numpy(np.asarray(src[idx], np.float32))
                            for src in (dataset.coarse, dataset.fine))
            stats.read_s += time.perf_counter() - t0
            stats.batches += 1
            return _nchw(coarse), _nchw(fine), None

    def hand_over(coarse, fine, copied):
        if copied is not None:
            current = torch.cuda.current_stream(device)
            before, after = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            before.record(current)
            current.wait_event(copied)
            after.record(current)
            stats.waits.append((before, after))
            coarse.record_stream(current)
            fine.record_stream(current)
        return coarse, fine

    ex = ThreadPoolExecutor(max_workers=1)
    try:
        pending = [ex.submit(read, i, idx) for i, idx in enumerate(batches[:depth])]
        for i in range(depth, len(batches) + depth):
            done = pending.pop(0)
            if i < len(batches):
                pending.append(ex.submit(read, i, batches[i]))
            yield hand_over(*done.result())
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
