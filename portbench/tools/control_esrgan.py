"""``tools/control.py`` for the ESRGAN training cell: readings of its control
and planted faults at the cell's own size, for setting its limits.

    python3 -m portbench.tools.control_esrgan --seeds 1,2,3 [--program] [--only control]

The same readings as ``tools/control.py``'s training cells (``control``:
the reference in TF32; ``half_batch``; ``unchanged``; with ``--program``
the program's own checked calls as a run's set-up makes them), made with
``traffic/train_esrgan.py``'s ``Setup`` and ``follow``, which draw ESRGAN's
weights and follow ESRGAN's reference. One JSON line per seed and reading.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

WORKLOAD = "train.florida-esrgan"


def train_readings(r, dev, program: bool = False, only=()):
    from portbench import compare, inputs
    from portbench.reference import esrgan
    from portbench.reference.train import first_rows
    from portbench.tools.control import _train_reading, lower_mode
    from portbench.traffic.train_esrgan import Setup, follow

    calls = r.cell["checked_calls"]
    if program:  # the program's own checked calls, as a run's set-up makes them
        su = Setup(r)
        prog, (coarse, fine), g_w, c_w = su.prog, su.reference_rows(r), su.g_w, su.c_w
        del su
    else:
        n = r.cell["train_samples"]
        coarse, fine = inputs.training_fields(r.raw, n, r.seed, dev)
        g_w, c_w = esrgan.network_weights(r.raw, r.seed, dev)
        rows = torch.as_tensor(first_rows(r.seed, n, r.raw["hp"]["batch_size"], calls).reshape(-1),
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


def main(argv=None) -> int:
    from portbench import run as bench_run

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--program", action="store_true",
                    help="also read the program's checked calls")
    ap.add_argument("--only", default="",
                    help="the readings to take, comma-separated (control, half_batch, "
                         "unchanged; default all)")
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    only = tuple(x for x in a.only.split(",") if x)
    for seed in (int(s) for s in a.seeds.split(",")):
        r = bench_run.prepare(WORKLOAD, seed, 0.0, False, a.device)
        for name, values in train_readings(r, dev, a.program, only):
            print(json.dumps({"workload": WORKLOAD, "seed": seed, "reading": name, **values}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
