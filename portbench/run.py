"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; everything else is found by name:

* ``portbench/cells/<cell>.json``: the cell's traffic parameters, its
  traffic ``kind`` and the limits of its correctness numbers;
* ``portbench/configs/<config>.json``: the program's configuration as it
  is run, with its ``source``, ``assumed`` and ``reduced`` keys;
* ``portbench/traffic/<kind>.py``: the traffic's code, ``run(Run) -> Outcome``;
* ``portbench/metrics/<metric>.py``: a per-layer reader,
  ``read(Outcome) -> float | None``, called in ``--trace 1`` runs.

The run fails, and prints no result, without a CUDA card (or with fewer
than the cell asks for), and when ``sys.modules`` holds JAX, its
libraries or the JAX package once the window has closed. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number compared with its limit (also the last
lines of standard error).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "downgan_tpu")
CONFIG_META = ("source", "assumed", "reduced")
GIB = float(1 << 30)


def _cache_dirs() -> None:
    """Every compile cache at a fixed path inside the checkout."""
    cache = HERE / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(*parts: str) -> dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def program_config(raw: dict, seed: int):
    """The program's ``Config`` of a configuration file, seeded with the run's seed."""
    from downgan_tpu_torch.config.config import Config

    body = {k: v for k, v in raw.items() if k not in CONFIG_META}
    body["seed"] = seed
    return Config.from_json(json.dumps(body))


@dataclass
class Run:
    """One run of one cell: what the traffic's ``run`` is given."""

    workload: dict
    cell: dict
    raw: dict           # the configuration file's program keys, seeded
    seed: int
    seconds: float
    trace: bool
    device: str
    setup_done_s: Optional[float] = None

    @property
    def config(self):
        return program_config(self.raw, self.seed)

    def mark_setup_done(self) -> None:
        """The window starts now: set-up is the process's age."""
        self.setup_done_s = process_age_s()

    def phase(self, label: str) -> None:
        """A line on standard error: the set-up phase done, at the process's age."""
        self.say(f"phase {label} at {process_age_s():.2f} s")

    @staticmethod
    def say(message: str) -> None:
        print(message, file=sys.stderr, flush=True)


@dataclass
class Outcome:
    """What the traffic's ``run`` returns: its end-to-end values by metric name, the
    work attempted and failed, the peak, the traced sub-window, the
    correctness numbers, and whatever its readers need (``window``)."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    peak_bytes: int
    checks: Dict[str, float]
    window: Dict[str, Any] = field(default_factory=dict)
    trace: Any = None
    run: Optional[Run] = None
    memo: Dict[str, Any] = field(default_factory=dict)

    def cached(self, key: str, fn: Callable[[], Any]) -> Any:
        if key not in self.memo:
            self.memo[key] = fn()
        return self.memo[key]


class Marks:
    """When each unit of the window's work ended (a round, a chunk), on the
    card's clock by CUDA events, and the host's minor page faults over the
    window: a line on standard error that says whether the window's rate
    holds steady (its two halves), what a unit costs, and how busy the host
    was (the process's CPU seconds, and the seconds the hypervisor took
    from the machine's CPUs, ``steal`` in ``/proc/stat``)."""

    def __init__(self, dev):
        import resource

        self._rusage = lambda: resource.getrusage(resource.RUSAGE_SELF).ru_minflt
        self.cuda = dev.type == "cuda"
        self.events: list = []
        self.faults, self.steal, self.cpu = self._rusage(), _steal_s(), time.process_time()
        self.start = self._now()

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def mark(self) -> None:
        self.events.append(self._now())

    def ends_s(self) -> List[float]:
        """Seconds from the window's start to each mark; after a synchronize."""
        if self.cuda:
            return [self.start.elapsed_time(e) / 1e3 for e in self.events]
        return [t - self.start for t in self.events]

    def summary(self, work_per_unit: float, unit: str) -> str:
        faults = self._rusage() - self.faults
        host = (f"process CPU {time.process_time() - self.cpu:.2f} s, steal "
                f"{_steal_s() - self.steal:.2f} s")
        ends = self.ends_s()
        if len(ends) < 2:
            return f"window: {len(ends)} {unit}(s), {faults} minor page faults; {host}"
        half = max(i for i, t in enumerate(ends) if t <= ends[-1] / 2 or i == 0)
        first = (half + 1) * work_per_unit / ends[half]
        second = (len(ends) - half - 1) * work_per_unit / max(ends[-1] - ends[half], 1e-9)
        gaps = sorted(b - a for a, b in zip([0.0] + ends, ends))
        q = statistics.quantiles(gaps, n=10) if len(gaps) > 2 else gaps
        return (f"window halves: {first:.1f} / {second:.1f} patches/s over {half + 1} / "
                f"{len(ends) - half - 1} {unit}s; a {unit}: p10 {1e3 * q[0]:.2f} ms, median "
                f"{1e3 * statistics.median(gaps):.2f} ms, p90 {1e3 * q[-1]:.2f} ms; "
                f"{faults / len(ends):.0f} minor page faults a {unit}; {host}")


def _steal_s() -> float:
    """Seconds the hypervisor has taken from this machine's CPUs, summed."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return float(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return float("nan")


def cell_metrics(bench: dict, workload: str, section: str) -> List[dict]:
    """The metrics of ``section`` that ``workload`` reports: those without
    a ``workloads`` key, and those that list it."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def prepare(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            bench: Optional[dict] = None, overrides: Optional[dict] = None) -> Run:
    """The :class:`Run` of one cell. ``overrides`` replaces keys of the cell
    file and of the configuration (``"config"``, with ``"hp"`` merged),
    for tests at small sizes on the CPU."""
    bench = load_benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = load_json("cells", f"{workload}.json")
    raw = load_json("configs", f"{entry['config']}.json")
    overrides = dict(overrides or {})
    cfg_over = overrides.pop("config", {})
    cell.update(overrides)
    raw.update({k: v for k, v in cfg_over.items() if k != "hp"})
    raw["hp"] = {**raw["hp"], **cfg_over.get("hp", {})}
    raw = {k: v for k, v in raw.items() if k not in CONFIG_META}
    raw["seed"] = seed
    return Run(workload=entry, cell=cell, raw=raw, seed=seed, seconds=seconds, trace=trace,
               device=device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             bench: Optional[dict] = None, overrides: Optional[dict] = None) -> dict:
    """Drive one run and return its result (not yet printed); the
    arguments as :func:`prepare`'s."""
    bench = load_benchmark() if bench is None else bench
    run = prepare(workload, seed, seconds, trace, device, bench, overrides)
    cell = run.cell
    traffic = load_module("traffic", cell.get("kind", run.workload["traffic"]))
    out: Outcome = traffic.run(run)
    out.run = run

    metrics: Dict[str, dict] = {}
    if not trace:
        values = dict(out.e2e, setup_s=run.setup_done_s, peak_mem_gib=out.peak_bytes / GIB)
        for m in cell_metrics(bench, workload, "end_to_end"):
            if m["name"] in values and values[m["name"]] is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, workload, "per_layer"):
            value = load_module("metrics", m["name"]).read(out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    limits = cell["limits"]
    checks = {name: {"value": out.checks.get(name, math.inf), "limit": limit}
              for name, limit in limits.items()}
    checks["failed"] = {"value": out.failed, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": _device_name(device), "count": 1, "memory_peak_bytes": out.peak_bytes}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s()
        dev["window_s"] = out.trace.window_s
        result["breakdown"] = out.trace.breakdown()
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in checks.items()}
    return result


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e300


def _device_name(device: str) -> str:
    if not device.startswith("cuda"):
        return "cpu"
    import torch

    return torch.cuda.get_device_name(torch.device(device))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _cache_dirs()
    bench = load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    print(f"phase torch imported at {process_age_s():.2f} s", file=sys.stderr)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"this cell needs {entry['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", bench)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in the run's process: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
