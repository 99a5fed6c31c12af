"""A profiled sub-window and what the per-layer readers take from it.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities), synchronizes, exports the Chrome trace to a file in the
run's temporary directory, reads it back and deletes it. The returned
:class:`Trace` holds the device's kernels, copies and sets as
(name, start_us, dur_us), the host's operator spans, and the traced
window's length on the host clock.

``busy_s`` is the union of the device intervals (kernels, memcpy,
memset): time in which an operation ran on the device. The breakdown's
``device_ops`` sums device time by name; its ``idle_gaps`` are the
longest stretches with nothing on the device, each named by the innermost
host operator running at the gap's middle.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

Interval = Tuple[str, float, float]  # (name, start_us, dur_us)


@dataclass
class Trace:
    window_s: float
    kernels: List[Interval] = field(default_factory=list)
    copies: List[Interval] = field(default_factory=list)
    host_ops: List[Interval] = field(default_factory=list)
    units: dict = field(default_factory=dict)  # work done in the traced window, by kind

    @property
    def device(self) -> List[Interval]:
        return self.kernels + self.copies

    def busy_s(self, intervals: Optional[List[Interval]] = None) -> float:
        spans = sorted((s, s + d) for _, s, d in (self.device if intervals is None else intervals))
        total, end = 0.0, float("-inf")
        for lo, hi in spans:
            if hi > end:
                total += hi - max(lo, end)
                end = hi
        return total / 1e6

    def matching(self, pattern: str) -> List[Interval]:
        rx = re.compile(pattern)
        return [k for k in self.kernels if rx.search(k[0])]

    def breakdown(self, top: int = 10) -> dict:
        by_name = defaultdict(float)
        for name, _, dur in self.device:
            by_name[name] += dur / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        spans = sorted((s, s + d) for _, s, d in self.device)
        end = spans[0][1] if spans else 0.0
        for lo, hi in spans[1:]:
            if lo > end:
                gaps.append((end, lo))
            end = max(end, hi)
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for lo, hi in gaps[:top]:
            mid = (lo + hi) / 2
            cover = [(s, n) for n, s, d in self.host_ops if s <= mid <= s + d]
            named.append([max(cover)[1] if cover else "no host op", (hi - lo) / 1e6])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def profiled(fn: Callable[[], dict]) -> Trace:
    """Run ``fn`` (which returns the units of work it did) under the
    profiler and return its :class:`Trace`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        units = fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    tr = Trace(window_s=window, units=units)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        item = (e.get("name", ""), float(e["ts"]), float(e["dur"]))
        cat = e.get("cat", "")
        if cat == "kernel":
            tr.kernels.append(item)
        elif cat in ("gpu_memcpy", "gpu_memset"):
            tr.copies.append(item)
        elif cat == "cpu_op":
            tr.host_ops.append(item)
    return tr
