"""Readings of a cell's control and planted faults, at the cell's own size,
for setting the limits of its correctness numbers.

    python3 -m portbench.tools.control --workload CELL --seeds 1,2,3 [--device cuda]

For each seed it makes the cell's inputs as a run does, computes the
reference (fp32, TF32 off), with ``--program`` reads the program's own
checked calls as a run's set-up makes them (no window), and puts in the
program's place:

* ``control``: the reference one precision below the configuration's
  (TF32 for fp32; float8 e4m3 with a per-tensor scale for bf16);
* training cells: ``half_batch`` (every loss over the first half of
  each batch), ``unchanged`` (no optimizer step);
* answer cells: ``altered`` (one answer's first value off by one unit of
  the field).
One JSON line per seed and reading, with the numbers the cell compares
(training: also each metric's worst gap over the calls, ``by_key``).
"""
from __future__ import annotations

import argparse
import json
import sys

import torch


def lower_mode(raw: dict) -> str:
    return "tf32" if raw["hp"]["compute_dtype"] == "float32" else "fp8"


def train_readings(r, dev, program: bool = False, only=()):
    from portbench import compare, inputs
    from portbench.reference.train import first_rows
    from portbench.traffic.train import Setup, follow

    hp = r.raw["hp"]
    calls = r.cell["checked_calls"]
    if program:  # the program's own checked calls, as a run's set-up makes them
        su = Setup(r)
        prog, (coarse, fine), g_w, c_w = su.prog, su.reference_rows(r), su.g_w, su.c_w
        del su
    else:
        n = r.cell["train_samples"]
        coarse, fine = inputs.training_fields(r.raw, n, r.seed, dev)
        g_w, c_w = inputs.network_weights(r.raw, r.seed, dev)
        k = hp["critic_iterations"] if hp["schedule"] == "fused" else 1
        rows = torch.as_tensor(first_rows(r.seed, n, hp["batch_size"], calls * k, k).reshape(-1),
                               device=dev)
        coarse, fine = coarse[rows], fine[rows]
    ref = follow(r.raw, g_w, c_w, coarse, fine, calls)
    yield "excluded", {"leaves": compare.excluded_leaves(ref)}
    readings = [("control", {"mode": lower_mode(r.raw)}), ("half_batch", {"keep_rows": 0.5}),
                ("unchanged", {"frozen": True})]
    if only:
        readings = [(name, kw) for name, kw in readings if name in only]
    if program:
        yield "program", _train_reading(prog, ref)
    for name, kw in readings:
        yield name, _train_reading(follow(r.raw, g_w, c_w, coarse, fine, calls, **kw), ref)


def _train_reading(got: dict, ref: dict) -> dict:
    from portbench import compare

    by_key: dict = {}
    for gaps in compare.call_gaps(got, ref):
        for k, v in gaps.items():
            by_key[k] = max(by_key.get(k, 0.0), v)
    return {**compare.train_gaps(got, ref), "by_key": by_key,
            "worst": compare.worst_leaves(got, ref)}


def answer_readings(r, dev, patches: int = 600):
    from portbench import compare, inputs
    from portbench.traffic.generate import reference_blocks

    series = inputs.covariate_series(r.raw, patches, r.seed, dev)
    g_w, _ = inputs.network_weights(r.raw, r.seed, dev)
    spans = [(s, min(150, patches - s)) for s in range(0, patches, 150)]
    ref = reference_blocks(r.raw, g_w, series, spans, dev)
    low = reference_blocks(r.raw, g_w, series, spans, dev, mode=lower_mode(r.raw))
    yield "control", {"answer_gap": compare.answer_gap(zip(low, ref))}
    altered = [b.copy() for b in ref]
    altered[0].flat[0] += 1.0
    yield "altered", {"answer_gap": compare.answer_gap(zip(altered, ref))}


def main(argv=None) -> int:
    from portbench import run as bench_run

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--program", action="store_true",
                    help="training cells: also read the program's checked calls")
    ap.add_argument("--only", default="",
                    help="training cells: the readings to take, comma-separated "
                         "(control, half_batch, unchanged; default all)")
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    for seed in (int(s) for s in a.seeds.split(",")):
        r = bench_run.prepare(a.workload, seed, 0.0, False, a.device)
        kind = r.cell.get("kind", r.workload["traffic"])
        only = tuple(x for x in a.only.split(",") if x)
        readings = (train_readings(r, dev, a.program, only) if kind == "train"
                    else answer_readings(r, dev))
        for name, values in readings:
            print(json.dumps({"workload": a.workload, "seed": seed, "reading": name, **values}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
