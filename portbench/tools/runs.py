"""Run cells of the benchmark one after another, each in its own process,
and summarize their result lines.

    python3 -m portbench.tools.runs --out DIR RUN [RUN ...]

Each RUN is ``workload:seed:seconds:trace``. Every run's standard output
and error go to ``DIR/<n>_<workload>_<seed>_<trace>.{out,err}``; a JSON
summary line per run, and the card's name and power limit first, go to
standard output and to ``DIR/summary.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("runs", nargs="+")
    a = ap.parse_args(argv)
    os.makedirs(a.out, exist_ok=True)
    summary = open(os.path.join(a.out, "summary.jsonl"), "a")

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        summary.write(line + "\n")
        summary.flush()

    emit({"card": card()})
    for i, spec in enumerate(a.runs):
        workload, seed, seconds, trace = spec.split(":")
        stem = os.path.join(a.out, f"{i:02d}_{workload}_{seed}_{trace}")
        t0 = time.perf_counter()
        with open(stem + ".out", "w") as out, open(stem + ".err", "w") as err:
            rc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload,
                                 "--seed", seed, "--seconds", seconds, "--trace", trace],
                                stdout=out, stderr=err).returncode
        rec = {"run": i, "workload": workload, "seed": int(seed), "trace": int(trace), "rc": rc,
               "wall_s": round(time.perf_counter() - t0, 2)}
        try:
            with open(stem + ".out") as f:
                res = json.loads(f.read().strip().splitlines()[-1])
            rec.update(correct=res["correct"], attempted=res["attempted"], failed=res["failed"],
                       metrics={k: v["value"] for k, v in res["metrics"].items()},
                       checks={k: v["value"] for k, v in res["checks"].items()})
            if "busy_s" in res["device"]:
                rec.update(busy_s=res["device"]["busy_s"], window_s=res["device"]["window_s"])
            rec["kind"] = res["device"]["kind"]
        except (OSError, ValueError, IndexError, KeyError):
            with open(stem + ".err") as f:
                rec["err_tail"] = f.read()[-1500:]
        emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
