"""Ranks of the port's data-parallel tests (``tests/test_torch_dp.py``,
``tests/test_torch_dp_trainer.py``): functions that ``torch.multiprocessing``
spawns, one process a rank, joined over gloo through a ``file://`` store,
and the case runner the tests also call in one process. Imports nothing of
JAX, so the card's ``-m cuda`` leg runs it too."""
from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch

from downgan_tpu_torch.config.config import Config
from downgan_tpu_torch.parallel.mesh import batch_rows, replicate_state
from downgan_tpu_torch.parallel.multihost import initialize
from downgan_tpu_torch.training.state import make_train_state
from downgan_tpu_torch.training.wgan import LOCAL_SYNC, build_fused_round, build_train_step

TIMEOUT = datetime.timedelta(seconds=120)  # a rank that hangs fails the test
# The whole spawned job (alone it takes 10-20 s on one worker): ranks still
# running then are killed and the test fails, instead of holding the suite.
SPAWN_TIMEOUT_S = 300


def spawn(fn, args: tuple, nprocs: int, timeout_s: float = SPAWN_TIMEOUT_S) -> None:
    """``torch.multiprocessing.spawn(fn, args, nprocs)`` with a deadline: a
    rank's exception is raised here, and ranks still running after
    ``timeout_s`` seconds are terminated and raise ``TimeoutError``."""
    import torch.multiprocessing as mp

    context = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = time.monotonic() + timeout_s
    while not context.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() < deadline:
            continue
        alive = [p.pid for p in context.processes if p.is_alive()]
        for p in context.processes:
            if p.is_alive():
                p.terminate()
        for p in context.processes:
            p.join(10)
        raise TimeoutError(f"spawned ranks {alive} still running after {timeout_s} s")


def join(rank: int, world: int, store: str, device: str) -> None:
    """Join the job of ``world`` ranks over gloo through the file ``store``;
    on the card every rank is local rank 0 of the one card."""
    torch.set_num_threads(1)
    if device.startswith("cuda"):
        os.environ["LOCAL_RANK"] = "0"
    initialize(f"file://{store}", world, rank, backend="gloo", timeout=TIMEOUT)


def to_cpu(obj):
    """``obj`` (nested dicts and lists of tensors) with every tensor on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    return obj


def run_case(case: dict, device: str, sync=LOCAL_SYNC) -> dict:
    """Train ``case``'s steps on ``device`` as rank ``sync.rank`` of
    ``sync.world``: the config (JSON), optional starting weights (``init``),
    global batches ``coarse``/``fine`` (steps, B, C, h, w), or (rounds, n,
    B, ...) on the fused schedule, and optional global ``alphas`` per
    step. Across ranks the seeded state is broadcast from rank 0, and the
    steps run as ``parallel.dp.build_dp_epoch`` over the batches as one
    device-resident set in order (or, with ``alphas``, the step with
    ``sync`` on each rank's rows of every batch). Returns every step's
    metrics and the final state, on the CPU."""
    from downgan_tpu_torch.data.dataset import DeviceDataset
    from downgan_tpu_torch.parallel.dp import build_dp_epoch

    cfg = Config.from_json(case["config"])
    state = make_train_state(cfg, device)
    if "init" in case:
        state.generator.load_state_dict(case["init"]["generator"])
        state.critic.load_state_dict(case["init"]["critic"])
    coarse, fine = case["coarse"], case["fine"]
    if sync.world > 1:
        replicate_state(state)
    if sync.world > 1 and "alphas" not in case:
        epoch = build_dp_epoch(cfg, state.generator, state.critic)
        ds = DeviceDataset(*(t.reshape(-1, *t.shape[-3:]).to(device) for t in (coarse, fine)))
        perm = np.arange(len(ds)).reshape(-1, cfg.hp.batch_size)
        metrics = [to_cpu(m) for m in epoch(state, ds, perm)]
        return {"metrics": metrics, "state": to_cpu(state.state_dict())}
    build = build_fused_round if cfg.hp.schedule == "fused" else build_train_step
    step = build(cfg, state.generator, state.critic, sync=sync)
    metrics = []
    for i, (c, f) in enumerate(zip(coarse, fine)):
        axis = c.ndim - 4  # the batch axis: 0, or 1 in a fused round's stacks
        c, f = (batch_rows(t, sync.rank, sync.world, axis).to(device) for t in (c, f))
        kw = {"alpha": case["alphas"][i].to(device)} if "alphas" in case else {}
        metrics.append(to_cpu(step(state, c, f, **kw)))
    return {"metrics": metrics, "state": to_cpu(state.state_dict())}


def drb_cache_case(rank: int, device: str) -> dict:
    """Rank r builds its state from seed r, so rank 1 starts from other
    weights, and runs a generator forward, which caches each DRB block's
    packed weights; then rank 0's state is broadcast. Returns both forwards
    and whether every block's cached pack equals a fresh pack of its
    weights after the broadcast."""
    from downgan_tpu_torch.models.generator import DenseResidualBlock
    from downgan_tpu_torch.ops.cuda.drb import pack_drb_weights

    cfg = Config(coarse_size=8, fine_size=32, filters=8, num_res_blocks=1, seed=rank)
    state = make_train_state(cfg, device)
    x = torch.randn((2, cfg.n_covariates, 8, 8), generator=torch.Generator().manual_seed(5))
    x = x.to(device)
    with torch.no_grad():
        before = state.generator(x)
        replicate_state(state)
        after = state.generator(x)
    fresh = [torch.equal(b._packed, pack_drb_weights(*b.stage_params(), x.dtype))
             for b in state.generator.modules() if isinstance(b, DenseResidualBlock)]
    return {"before": before.cpu(), "after": after.cpu(), "packs_fresh": fresh}


def step_cases(rank: int, world: int, store: str, workdir: str, device: str) -> None:
    """Rank ``rank``'s part of ``test_torch_dp.py``: every case of
    ``workdir/cases.pt`` under ``parallel.dp.GroupSync``, then the DRB cache
    case; the results go to ``workdir/rank<rank>.pt``."""
    from downgan_tpu_torch.parallel.dp import GroupSync

    join(rank, world, store, device)
    cases = torch.load(os.path.join(workdir, "cases.pt"), weights_only=True)
    sync = GroupSync()
    out = {name: run_case(case, device, sync) for name, case in cases.items()}
    out["drb_cache"] = drb_cache_case(rank, device)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def train_argv(config_path: str, checkpoint_dir: str, tracking_root: str, epochs: int,
               host_feed: bool) -> list:
    """``cli train`` on the tiny config: 48 synthetic samples (43 to train:
    5 steps of 8 an epoch), the best MAE tracked, on the CPU."""
    return ["train", "--config", config_path, "--synthetic", "--samples", "48", "--epochs",
            str(epochs), "--device", "cpu", "--checkpoint-dir", checkpoint_dir,
            "--tracking-root", tracking_root, "--track-best", "MAE",
            *(["--host-feed"] if host_feed else [])]


def flat_state(trainer) -> dict:
    """Every tensor of a trainer's train state by name, on the CPU."""
    out = {}

    def walk(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(f"{prefix}.{k}", v)
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(f"{prefix}.{i}", v)
        elif isinstance(obj, torch.Tensor):
            out[prefix[1:]] = obj.detach().cpu()

    walk("", trainer.state.state_dict())
    return out


def trainer_cases(rank: int, world: int, store: str, workdir: str, config_path: str) -> None:
    """Rank ``rank``'s part of ``test_torch_dp_trainer.py``: ``cli train
    --multihost`` for 2 epochs, and for 1 epoch then ``--resume`` to 2, on
    the device-resident set and with ``--host-feed``. Counts the checkpoint
    and bundle files this rank writes; the results go to
    ``workdir/rank<rank>.pt``."""
    import downgan_tpu_torch.training.trainer as trainer_module
    import downgan_tpu_torch.utils.checkpoint as checkpoint_module
    from downgan_tpu_torch.cli.__main__ import main

    torch.set_num_threads(1)
    writes = {"checkpoints": 0, "bundles": 0}
    save_params, write_bundle = checkpoint_module.save_params, trainer_module.write_generator_bundle

    def counting(kind, real):
        def wrapped(*args, **kwargs):
            writes[kind] += 1
            return real(*args, **kwargs)
        return wrapped

    checkpoint_module.save_params = counting("checkpoints", save_params)
    trainer_module.write_generator_bundle = counting("bundles", write_bundle)
    join_flags = ["--multihost", "--coordinator", f"file://{store}", "--num-processes",
                  str(world), "--process-id", str(rank)]
    out = {}
    for path in ("device", "host_feed"):
        host_feed = path == "host_feed"
        track = os.path.join(workdir, f"tracking_rank{rank}_{path}")
        runs = {}
        for name, epochs, extra in (("full", 2, []), ("first", 1, []), ("resumed", 2, ["--resume"])):
            ckpt = os.path.join(workdir, f"ckpt_{path}_{'full' if name == 'full' else 'split'}")
            trainer = main(train_argv(config_path, ckpt, track, epochs, host_feed)
                           + join_flags + extra)
            runs[name] = {"history": trainer.history, "state": flat_state(trainer),
                          "forwards": dict(trainer.forwards)}
        out[path] = {"runs": runs, "tracking_exists": os.path.exists(track)}
    out["writes"] = writes
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
