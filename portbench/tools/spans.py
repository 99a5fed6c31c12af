"""Run one cell traced and print where its device time and idle time go,
by the program's spans.

    python3 -m portbench.tools.spans --workload <cell> --seed <n> [--seconds 30] [--out F]

From the root of a checkout, on the card. The cell runs as ``portbench.run
--trace 1`` runs it (set-up, the timed window, the traced sub-window, the
reference). Printed: the card's name and power limit; a row a span name
(``spans.table``): count, host ms and host self ms, attributed device ms,
device idle ms under it and idle self ms; the shares of busy time
attributed to a span, launched outside every span and without a launch
event, and of idle time under a span (``spans.coverage``); the phases'
readings (``spans.phases``); the traced window's rate; and the cell's
per-layer metrics as its readers read them. The spans come from the
exported trace that ``spans.capturing`` keeps beside ``trace.profiled``'s.
``--out`` also writes all of it as one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys

from portbench import run, spans
from portbench.tools.runs import card

COLUMNS = ("count", "host_ms", "host_self_ms", "device_ms", "idle_ms", "idle_self_ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    run._cache_dirs()
    bench = run.load_benchmark()
    r = run.prepare(a.workload, a.seed, a.seconds, True, "cuda", bench)
    with spans.capturing() as got:
        out = run.load_module("traffic", r.cell.get("kind", r.workload["traffic"])).run(r)
    out.run = r
    tr, (st,) = out.trace, got
    rows = spans.table(st)
    cover = spans.coverage(st)
    unit = next(iter(tr.units))  # calls or chunks, as the timed window counts them
    per_unit = out.window["patches"] / out.window[unit]
    report = {"card": card(), "workload": a.workload, "seed": a.seed, "window_s": tr.window_s,
              "busy_s": tr.busy_s(), "units": tr.units,
              "traced_patches_per_s": tr.units[unit] * per_unit / tr.window_s,
              "coverage": cover, "spans": rows,
              "phases": {k: v for k, v in spans.phases(st).items() if v is not None},
              "metrics": {m["name"]: run.load_module("metrics", m["name"]).read(out)
                          for m in run.cell_metrics(bench, a.workload, "per_layer")}}
    print(f"{report['card']}; {a.workload} seed {a.seed}: traced window "
          f"{tr.window_s * 1e3:.1f} ms, {tr.units}, busy {tr.busy_s() * 1e3:.1f} ms")
    print(f"{'span':<44}" + "".join(f"{c:>14}" for c in COLUMNS))
    for row in rows:
        print(f"{row['span']:<44}" + "".join(
            f"{row[c]:>14d}" if c == "count" else f"{row[c]:>14.3f}" for c in COLUMNS))
    print("coverage: " + json.dumps(cover))
    print("phases: " + json.dumps(report["phases"]))
    print("metrics: " + json.dumps(report["metrics"]))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
