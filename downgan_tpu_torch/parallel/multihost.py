"""Multi-process training: joining the job and feeding rows (counterpart of
``downgan_tpu/parallel/multihost.py``).

One process per card, all running the same command, joined by
``torch.distributed``:

  * :func:`initialize` -- ``init_process_group`` from explicit arguments or
    from the environment ``torchrun`` (``python -m torch.distributed.run``)
    sets; a no-op in a lone process, so the same entry point runs
    everywhere;
  * :func:`process_batch_slice` -- which rows of a global batch this rank
    feeds (every rank reads only its rows);
  * :func:`make_global_batch` -- those rows, NHWC on the host, as the NCHW
    batch on this rank's device.

The Trainer consumes them (``Trainer(multihost=...)``, ``cli train
--multihost``). The gloo backend runs the same job on the CPU
(``tests/test_torch_dp.py``, two ranks over a file store).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from downgan_tpu_torch.parallel.mesh import in_group, rank, rows_of, world_size

# A collective that waits longer than this raises instead of hanging the job.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the job's default process group; a no-op in a lone process.

    With no arguments the job is read from the variables ``torchrun`` sets
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``); without them this is a lone process and nothing
    happens. A torchrun job of one rank is a group of one: its collectives
    run. ``coordinator_address`` is ``host:port`` of rank 0 (a TCP store)
    or a URL ``torch.distributed`` takes (``tcp://...``, ``file://...``);
    with it ``num_processes`` and ``process_id`` are required.
    ``num_processes <= 1`` is a lone process.

    The backend is NCCL where CUDA is available, else gloo (``backend``
    overrides). Before the group forms, the card of local rank
    ``LOCAL_RANK`` (default: ``process_id`` modulo the visible cards)
    becomes the current device, so ``"cuda"`` means this rank's card.
    A collective that waits ``timeout`` raises.

    A repeat call is tolerated; every other failure raises, so a job never
    quietly becomes N lone runs."""
    if num_processes is not None and num_processes <= 1:
        return
    if in_group():
        return
    if coordinator_address is None and num_processes is None and process_id is None:
        if "WORLD_SIZE" not in os.environ:
            return  # a lone process: nothing to join
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(f"WORLD_SIZE is set but {', '.join(missing)} is not: launch "
                               "with python -m torch.distributed.run or pass the coordinator")
        init_method = "env://"
        num_processes, process_id = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("initialize needs coordinator_address, num_processes and "
                             "process_id together (or none, under torchrun)")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        if backend == "nccl":
            kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=timeout, **kwargs)


def local_device(device: str | torch.device) -> torch.device:
    """``device``, with a bare ``"cuda"`` meaning this rank's card (the
    current device :func:`initialize` set) inside a process group."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and in_group():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def process_batch_slice(global_batch: int, process_index: Optional[int] = None,
                        process_count: Optional[int] = None) -> Tuple[int, int]:
    """[start, stop) rows of the global batch this process feeds (default:
    this rank of the job). The global batch must divide over the ranks."""
    pc = world_size() if process_count is None else process_count
    pi = rank() if process_index is None else process_index
    rows = rows_of(global_batch, pi, pc)
    return rows.start, rows.stop


def make_global_batch(local_rows: np.ndarray, device: str | torch.device,
                      batch_axis: int = 0) -> torch.Tensor:
    """This rank's rows of a global batch, NHWC on the host (the rows of
    :func:`process_batch_slice` along ``batch_axis``: 0 for (B, H, W, C)
    batches, 1 for the fused schedule's (n_critic, B, H, W, C) stacks), as
    the NCHW float32 tensor the step takes, on ``device``. Each rank holds
    only its rows; the gradient all-reduce joins them."""
    if local_rows.ndim != batch_axis + 4:
        raise ValueError(f"expected (..., B, H, W, C) rows with the batch on axis "
                         f"{batch_axis}, got shape {local_rows.shape}")
    t = torch.from_numpy(np.ascontiguousarray(local_rows, dtype=np.float32)).to(device)
    return t.movedim(-1, batch_axis + 1).contiguous()
