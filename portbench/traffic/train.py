"""Training traffic: the port's trainer step over its device-resident set.

Set-up makes the train set on the device from the seed (``train_samples``
fields of the configuration's shapes), builds the program's
``training.trainer.Trainer`` on it, loads the benchmark's weights into
its state, and drives ``Trainer.step_fn`` (``build_train_step`` on the
reference schedule, ``build_fused_round`` on the fused one) over
``parallel.dp.device_batches`` of epoch permutations drawn as the trainer
draws them (``numpy.random.default_rng((seed, epoch))``), one host sync at
each epoch's end, as ``Trainer.run_train_epoch``. The first
``checked_calls`` calls of that feed are the ones the reference follows;
set-up then runs on to a whole round, so every shape of the window is
warm.

The window runs whole rounds (``critic_iterations`` steps on the
reference schedule, one fused round on the other) until ``--seconds`` have
passed, then synchronizes: the rate (named by the cell's ``rate_metric``,
``train_patches_per_s`` by default) is the batch times the critic steps
completed over the whole window. A call whose metrics are
not all finite counts as failed. ``--trace 1`` then profiles
``trace_calls`` more calls.
"""
from __future__ import annotations

import json
import time
from typing import Dict, Iterator

import numpy as np
import torch

from portbench import compare, inputs, trace
from portbench.reference import nets
from portbench.reference.train import RefTrainer, first_rows
from portbench.run import Marks, Outcome, Run


def _calls(tr, ds, config) -> Iterator[Dict[str, torch.Tensor]]:
    """The trainer's step over its epochs, one call's metrics at a time."""
    from downgan_tpu_torch.parallel import dp
    from downgan_tpu_torch.training import trainer as trainer_mod

    epoch = 0
    while True:
        perm = ds.epoch_perm(np.random.default_rng((config.seed, epoch)), config.hp.batch_size)
        sums: Dict[str, torch.Tensor] = {}
        n = 0
        for coarse, fine in dp.device_batches(config, ds, perm):
            metrics = tr.step_fn(tr.state, coarse, fine)
            trainer_mod._add(sums, metrics)
            n += 1
            yield metrics
        trainer_mod._to_host_means(sums, n)  # the epoch's one host sync
        epoch += 1


def _host(named) -> Dict[str, torch.Tensor]:
    """Leaf name -> an fp32 copy in host memory (a copy also on the CPU,
    where the optimizer goes on updating the tensor in place)."""
    return {k: t.detach().to("cpu", torch.float32, copy=True) for k, t in named}


def _program_m1(state) -> Dict[str, torch.Tensor]:
    out = {}
    for net, module, opt in (("generator", state.generator, state.g_opt),
                             ("critic", state.critic, state.c_opt)):
        for k, p in module.named_parameters():
            moment = opt.state.get(p, {}).get("exp_avg")  # none: the optimizer never stepped
            out[f"{net}.{k}"] = torch.zeros_like(p) if moment is None else moment
    return _host(out.items())


def _params(state) -> Dict[str, torch.Tensor]:
    return {**{f"generator.{k}": p for k, p in state.generator.named_parameters()},
            **{f"critic.{k}": p for k, p in state.critic.named_parameters()}}


class Setup:
    """The cell's inputs, the program's trainer on them, its feed, and its
    readings over the checked calls (what :func:`compare.train_gaps` reads)."""

    def __init__(self, r: Run):
        from downgan_tpu_torch.data.dataset import DeviceDataset
        from downgan_tpu_torch.training import trainer as trainer_mod

        self.config = config = r.config
        if config.hp.compute_dtype == "float32":  # fp32 computes in fp32: TF32 off, as `cli train`
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.dev = dev = torch.device(r.device)
        self.n_samples = r.cell["train_samples"]
        coarse, fine = inputs.training_fields(r.raw, self.n_samples, r.seed, dev)
        self.ds = DeviceDataset(coarse, fine)
        r.phase("train set made")
        self.g_w, self.c_w = inputs.network_weights(r.raw, r.seed, dev)
        self.tr = trainer_mod.Trainer(config, self.ds, device=dev)
        self.tr.state.generator.load_state_dict(self.g_w)
        self.tr.state.critic.load_state_dict(self.c_w)
        start = {**{f"generator.{k}": v for k, v in self.g_w.items()},
                 **{f"critic.{k}": v for k, v in self.c_w.items()}}
        self.feed = _calls(self.tr, self.ds, config)
        r.phase("trainer built")

        # ---- the checked calls, through the window's own call and feed
        self.prog = prog = {"calls": []}
        for i in range(r.cell["checked_calls"]):
            metrics = next(self.feed)
            prog["calls"].append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                prog["m1"] = _program_m1(self.tr.state)
        prog["delta"] = _host((k, p.detach() - start[k]) for k, p in _params(self.tr.state).items())
        r.phase("checked calls run")

    def reference_rows(self, r: Run):
        """The checked calls' rows of the set, in call order."""
        hp = self.config.hp
        k = hp.critic_iterations if hp.schedule == "fused" else 1
        rows = first_rows(r.seed, self.n_samples, hp.batch_size, r.cell["checked_calls"] * k, k)
        rows = torch.as_tensor(rows.reshape(-1), device=self.dev)
        return self.ds.coarse[rows], self.ds.fine[rows]


def run(r: Run) -> Outcome:
    su = Setup(r)
    hp, dev, feed, tr = su.config.hp, su.dev, su.feed, su.tr
    fused = hp.schedule == "fused"
    per_round = 1 if fused else hp.critic_iterations
    while not fused and tr.state.step % per_round:  # warm-up to a round's start
        next(feed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    r.mark_setup_done()

    # ---- the window: whole rounds until the time is up
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    calls = 0
    marks = Marks(dev)
    t0 = time.perf_counter()
    while True:
        for _ in range(per_round):
            metrics = next(feed)
            bad += ~torch.stack([v.float() for v in metrics.values()]).isfinite().all()
            calls += 1
        marks.mark()
        if time.perf_counter() - t0 >= r.seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    failed = int(bad)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    patches_per_call = hp.batch_size * (hp.critic_iterations if fused else 1)
    window = {"calls": calls, "seconds": elapsed, "patches": calls * patches_per_call,
              "compute_dtype": hp.compute_dtype, "drb_batch": hp.batch_size, "kind": "train"}
    r.say(marks.summary(patches_per_call * (1 if fused else per_round), "round"))

    profiled = None
    if r.trace:
        k = r.cell["trace_calls"]

        def traced():
            for _ in range(k):
                next(feed)
            return {"calls": k}

        profiled = trace.profiled(traced)

    # ---- the reference follows the checked calls, once the program is freed
    del feed, tr, metrics
    su.feed = su.tr = None
    ref_coarse, ref_fine = su.reference_rows(r)
    su.ds = None
    ref = follow(r.raw, su.g_w, su.c_w, ref_coarse, ref_fine, r.cell["checked_calls"])
    r.say("checked calls, gap by key: " + json.dumps(compare.call_gaps(su.prog, ref)))
    r.say("worst leaves: " + json.dumps(compare.worst_leaves(su.prog, ref)))
    checks = compare.train_gaps(su.prog, ref)
    rate = r.cell.get("rate_metric", "train_patches_per_s")
    return Outcome(e2e={rate: window["patches"] / elapsed}, attempted=calls,
                   failed=failed, peak_bytes=peak, checks=checks, window=window,
                   trace=profiled)


def follow(cfg: dict, g_w, c_w, coarse, fine, calls: int, mode: str = "fp32",
           **faults) -> dict:
    """The reference's readings over ``calls`` calls of ``cfg``'s schedule on
    the rows ``coarse``/``fine`` (in call order), from the weights
    ``g_w``/``c_w``: what :func:`compare.train_gaps` reads. ``mode`` and
    ``faults`` (``RefTrainer``'s ``keep_rows``, ``frozen``) make the
    control and the planted faults."""
    hp = cfg["hp"]
    fused = hp["schedule"] == "fused"
    with nets.arithmetic(mode):
        ref = RefTrainer(cfg, g_w, c_w, mode=mode, **faults)
        start = {k: p.detach().clone() for k, p, _ in ref.named()}
        out = {"calls": []}
        b, n = hp["batch_size"], hp["critic_iterations"]
        for i in range(calls):
            if fused:
                sl = slice(i * n * b, (i + 1) * n * b)
                m = ref.round(coarse[sl].reshape(n, b, *coarse.shape[1:]),
                              fine[sl].reshape(n, b, *fine.shape[1:]))
            else:
                m = ref.step(coarse[i * b:(i + 1) * b], fine[i * b:(i + 1) * b])
            out["calls"].append({k: float(v) for k, v in m.items()})
            if i == 0:
                out["m1"] = _host((k, mom) for k, _, mom in ref.named())
        out["delta"] = _host((k, p.detach() - start[k]) for k, p, _ in ref.named())
    return out
