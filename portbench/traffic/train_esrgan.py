"""Training traffic for ESRGAN's networks: ``traffic/train.py`` wired to the
ESRGAN reference (``reference/esrgan.py``).

The same traffic as ``train.py``: the train set made on the device from
the seed, the program's ``Trainer`` on it with the benchmark's weights,
``Trainer.step_fn`` over ``device_batches`` of the trainer's epoch
permutations, the first ``checked_calls`` calls followed by the reference,
whole rounds for ``--seconds``, then ``trace_calls`` profiled calls. Its
``Setup``, ``run`` and ``follow`` are copies of ``train.py``'s, which draw
the florida generator's weights and follow the florida reference; the
helpers they share are ``train.py``'s own.
"""
from __future__ import annotations

import json
import time

import torch

from portbench import compare, inputs, trace
from portbench.reference import esrgan, nets
from portbench.reference.train import first_rows
from portbench.run import Marks, Outcome, Run
from portbench.traffic.train import _calls, _host, _params, _program_m1


class Setup:
    """The cell's inputs, the program's trainer on them, its feed, and its
    readings over the checked calls (what :func:`compare.train_gaps` reads)."""

    def __init__(self, r: Run):
        from downgan_tpu_torch.data.dataset import DeviceDataset
        from downgan_tpu_torch.training import trainer as trainer_mod

        self.config = config = r.config
        torch.backends.cudnn.allow_tf32 = False  # fp32 with TF32 off, as `cli train`
        torch.backends.cuda.matmul.allow_tf32 = False
        self.dev = dev = torch.device(r.device)
        self.n_samples = r.cell["train_samples"]
        coarse, fine = inputs.training_fields(r.raw, self.n_samples, r.seed, dev)
        self.ds = DeviceDataset(coarse, fine)
        r.phase("train set made")
        self.g_w, self.c_w = esrgan.network_weights(r.raw, r.seed, dev)
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
        rows = first_rows(r.seed, self.n_samples, self.config.hp.batch_size,
                          r.cell["checked_calls"])
        rows = torch.as_tensor(rows.reshape(-1), device=self.dev)
        return self.ds.coarse[rows], self.ds.fine[rows]


def run(r: Run) -> Outcome:
    su = Setup(r)
    hp, dev, feed, tr = su.config.hp, su.dev, su.feed, su.tr
    per_round = hp.critic_iterations
    while tr.state.step % per_round:  # warm-up to a round's start
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
    window = {"calls": calls, "seconds": elapsed, "patches": calls * hp.batch_size,
              "compute_dtype": hp.compute_dtype, "drb_batch": hp.batch_size, "kind": "train"}
    r.say(marks.summary(hp.batch_size * per_round, "round"))

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
    return Outcome(e2e={"train_patches_per_s": window["patches"] / elapsed}, attempted=calls,
                   failed=failed, peak_bytes=peak, checks=checks, window=window,
                   trace=profiled)


def follow(cfg: dict, g_w, c_w, coarse, fine, calls: int, mode: str = "fp32",
           **faults) -> dict:
    """The ESRGAN reference's readings over ``calls`` reference-schedule
    steps on the rows ``coarse``/``fine`` (in call order), from the weights
    ``g_w``/``c_w``: what :func:`compare.train_gaps` reads. ``mode`` and
    ``faults`` (``RefTrainer``'s ``keep_rows``, ``frozen``) make the
    control and the planted faults."""
    b = cfg["hp"]["batch_size"]
    with nets.arithmetic(mode):
        ref = esrgan.RefTrainer(cfg, g_w, c_w, mode=mode, **faults)
        start = {k: p.detach().clone() for k, p, _ in ref.named()}
        out = {"calls": []}
        for i in range(calls):
            m = ref.step(coarse[i * b:(i + 1) * b], fine[i * b:(i + 1) * b])
            out["calls"].append({k: float(v) for k, v in m.items()})
            if i == 0:
                out["m1"] = _host((k, mom) for k, _, mom in ref.named())
        out["delta"] = _host((k, p.detach() - start[k]) for k, p, _ in ref.named())
    return out
