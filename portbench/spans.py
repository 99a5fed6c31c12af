"""The device's time and idle time by the program's spans, from a traced
window's Chrome trace.

:func:`capturing` keeps, in its own process, each Chrome trace that
``torch.profiler`` exports while it is open (as ``trace.profiled`` exports
the ``--trace 1`` sub-window's), parsed into a :class:`SpanTrace`: the
device intervals (kernels, memcpy, memset) as (name, start_us, dur_us),
each one's launch time on the host (the start of the ``cuda_runtime`` or
``cuda_driver`` event with the same ``correlation``, None where the trace
has none), the program's spans (``user_annotation`` events:
``utils/profiling.py::annotate`` and torch's own ``record_function``) as
(name, start_us, dur_us, tid), a span still open when the profile ended
left out, and the calling thread. ``trace.py``'s :class:`Trace`, which the
per-layer readers take, keeps neither spans nor launches; this module
reads the same exported file beside it.

* A device interval is attributed to span S when its launch on the host
  falls inside an interval of a span named S, on any thread: time
  decides, not the thread. The main thread is blocked in ``*.backward``
  while autograd's device thread launches, so those launches fall inside
  the main thread's span.
* A span's device time is the union of the device intervals attributed to
  it, nested spans' included.
* An idle gap (a stretch between device intervals with nothing on the
  device, as ``Trace.breakdown`` finds them) is put down to the innermost
  span open on the calling thread (``SpanTrace.tid``) at the gap's
  midpoint: the latest to start of those open there.
* An interval whose launch event is missing is unattributed, and counted
  as such (:func:`coverage`).

``tools/spans.py`` prints :func:`table`, :func:`coverage` and
:func:`phases`; a span absent from the trace reads None there.
"""
from __future__ import annotations

import json
import threading
from bisect import bisect_right
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

Interval = Tuple[str, float, float]  # (name, start_us, dur_us)
Span = Tuple[str, float, float, int]  # (name, start_us, dur_us, tid)


@dataclass
class SpanTrace:
    device: List[Interval] = field(default_factory=list)
    launch_us: List[Optional[float]] = field(default_factory=list)  # parallel to device
    spans: List[Span] = field(default_factory=list)
    tid: Optional[int] = None  # the thread that ran the profiled function


def from_events(events: List[dict], tid: Optional[int]) -> SpanTrace:
    """The :class:`SpanTrace` of a Chrome trace's ``traceEvents``, profiled
    from the thread ``tid`` (its native id)."""
    tr = SpanTrace(tid=tid)
    launched, ids = {}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        item = (e.get("name", ""), float(e["ts"]), float(e["dur"]))
        cat, corr = e.get("cat", ""), e.get("args", {}).get("correlation")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            tr.device.append(item)
            ids.append(corr)
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launched[corr] = item[1]
        elif cat == "user_annotation" and e.get("args", {}).get("finished", True):
            tr.spans.append((*item, e.get("tid")))
    tr.launch_us = [launched.get(c) for c in ids]
    return tr


@contextmanager
def capturing() -> Iterator[List[SpanTrace]]:
    """Within it, each Chrome trace that a ``torch.profiler.profile`` exports
    is also read into a :class:`SpanTrace`, appended to the yielded list;
    the thread that enters is the calling thread."""
    from torch.profiler import profile

    got: List[SpanTrace] = []
    tid = threading.get_native_id()
    export = profile.export_chrome_trace

    def keep(self, path):
        done = export(self, path)
        with open(path) as f:
            got.append(from_events(json.load(f).get("traceEvents", []), tid))
        return done

    profile.export_chrome_trace = keep
    try:
        yield got
    finally:
        profile.export_chrome_trace = export


Window = Tuple[List[float], List[float]]  # merged (starts, ends), sorted


def _merge(intervals) -> Window:
    starts, ends = [], []
    for lo, hi in sorted(intervals):
        if ends and lo <= ends[-1]:
            ends[-1] = max(ends[-1], hi)
        else:
            starts.append(lo)
            ends.append(hi)
    return starts, ends


def _inside(window: Window, t: float) -> bool:
    i = bisect_right(window[0], t) - 1
    return i >= 0 and t <= window[1][i]


def _union_us(intervals) -> float:
    starts, ends = _merge(intervals)
    return sum(hi - lo for lo, hi in zip(starts, ends))


def _windows(tr) -> Dict[str, Window]:
    by_name = defaultdict(list)
    for name, start, dur, _ in tr.spans:
        by_name[name].append((start, start + dur))
    return {name: _merge(iv) for name, iv in by_name.items()}


def _launched(tr):
    """(start, end, launch) of each device interval whose launch is known."""
    return [(s, s + d, t) for (_, s, d), t in zip(tr.device, tr.launch_us) if t is not None]


def device_us(tr, name: str) -> Optional[float]:
    """Microseconds of device time attributed to span ``name``; None when
    the trace has no such span."""
    window = _windows(tr).get(name)
    if window is None:
        return None
    return _union_us((s, e) for s, e, t in _launched(tr) if _inside(window, t))


def count(tr, name: str) -> int:
    return sum(1 for n, *_ in tr.spans if n == name)


def device_ms_per(tr, name: str, per: Optional[str] = None) -> Optional[float]:
    """Device ms attributed to span ``name``, per span named ``per``
    (default ``name`` itself); None without a trace or either span."""
    if tr is None:
        return None
    n = count(tr, per or name)
    us = device_us(tr, name)
    return us / 1e3 / n if us is not None and n else None


def host_ms(tr, name: str) -> Optional[float]:
    """Mean host duration (ms) of span ``name``; None without one."""
    if tr is None:
        return None
    durs = [d for n, _, d, _ in tr.spans if n == name]
    return sum(durs) / len(durs) / 1e3 if durs else None


def phases(tr) -> Dict[str, Optional[float]]:
    """The phases' readings: device ms attributed to a phase's span, per
    span (``drb.backward`` per ``generator.update``), and the mean host ms
    of ``train.call``; None where the trace has no such span."""
    return {"critic_update_ms": device_ms_per(tr, "critic.update"),
            "generator_update_ms": device_ms_per(tr, "generator.update"),
            "metric_pass_ms": device_ms_per(tr, "metric.pass"),
            "drb_backward_ms": device_ms_per(tr, "drb.backward", per="generator.update"),
            "host_call_ms": host_ms(tr, "train.call"),
            "generate_forward_ms": device_ms_per(tr, "generate.forward")}


def gaps(tr) -> List[Tuple[float, float]]:
    """The stretches between device intervals with nothing on the device."""
    starts, ends = _merge((s, s + d) for _, s, d in tr.device)
    return list(zip(ends[:-1], starts[1:]))


def innermost(tr, t: float) -> Optional[str]:
    """The innermost span open on the calling thread at ``t``."""
    open_ = [(s, -d, n) for n, s, d, tid in tr.spans if tid == tr.tid and s <= t <= s + d]
    return max(open_)[2] if open_ else None


def _self_us(tr) -> Dict[str, float]:
    """Host self time by span name: each span's duration less the part its
    child spans on its thread cover."""
    out = defaultdict(float)
    by_tid = defaultdict(list)
    for n, s, d, tid in tr.spans:
        by_tid[tid].append((s, -d, n))
    for spans in by_tid.values():
        stack: List[list] = []  # [end, name, child time]
        for s, neg_d, n in sorted(spans):
            while stack and stack[-1][0] <= s:
                end, name, child = stack.pop()
                out[name] -= child
            if stack:
                stack[-1][2] += -neg_d
            out[n] += -neg_d
            stack.append([s - neg_d, n, 0.0])
        for _, name, child in stack:
            out[name] -= child
    return out


def table(tr) -> List[dict]:
    """A row a span name, by device time: its count, host ms and host self
    ms (summed), attributed device ms, device idle ms under it (gaps whose
    midpoint falls inside one of its intervals, on any thread) and idle
    self ms (gaps put down to it as the innermost span on the calling
    thread)."""
    windows = _windows(tr)
    launched = _launched(tr)
    holes = gaps(tr)
    self_us = _self_us(tr)
    idle_self = defaultdict(float)
    for lo, hi in holes:
        idle_self[innermost(tr, (lo + hi) / 2)] += hi - lo
    rows = []
    for name, window in windows.items():
        rows.append({
            "span": name, "count": count(tr, name),
            "host_ms": sum(d for n, _, d, _ in tr.spans if n == name) / 1e3,
            "host_self_ms": self_us[name] / 1e3,
            "device_ms": _union_us((s, e) for s, e, t in launched if _inside(window, t)) / 1e3,
            "idle_ms": sum(hi - lo for lo, hi in holes if _inside(window, (lo + hi) / 2)) / 1e3,
            "idle_self_ms": idle_self[name] / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def _overlap_us(window: Window, lo: float, hi: float) -> float:
    """How much of [lo, hi] the merged ``window`` covers."""
    starts, ends = window
    i = max(bisect_right(starts, lo) - 1, 0)
    total = 0.0
    while i < len(starts) and starts[i] < hi:
        total += max(0.0, min(hi, ends[i]) - max(lo, starts[i]))
        i += 1
    return total


def coverage(tr) -> dict:
    """Shares (0-1) of the device's busy time attributed to some span,
    whose launch event is missing, and launched outside every span; of
    the idle time between device intervals, the part that a span on the
    calling thread covers (``idle_under_span``, time against time), and
    the part in gaps whose midpoint a span covers (``idle_gaps_named``:
    the gaps :func:`table` puts down to a span). The two differ by the
    gaps that straddle the host's moves from one span to the next."""
    every = _merge((s, s + d) for n, s, d, _ in tr.spans)
    calling = _merge((s, s + d) for n, s, d, tid in tr.spans if tid == tr.tid)
    busy = _union_us((s, s + d) for _, s, d in tr.device)
    missing = _union_us((s, s + d) for (_, s, d), t in zip(tr.device, tr.launch_us)
                        if t is None)
    inside = _union_us((s, e) for s, e, t in _launched(tr) if _inside(every, t))
    outside = _union_us((s, e) for s, e, t in _launched(tr) if not _inside(every, t))
    holes = gaps(tr)
    idle = sum(hi - lo for lo, hi in holes)
    under = sum(_overlap_us(calling, lo, hi) for lo, hi in holes)
    named = sum(hi - lo for lo, hi in holes if innermost(tr, (lo + hi) / 2) is not None)

    def share(x, whole):
        return x / whole if whole else None

    return {"busy_ms": busy / 1e3, "busy_attributed": share(inside, busy),
            "busy_missing_launch": share(missing, busy),
            "busy_outside_spans": share(outside, busy),
            "idle_ms": idle / 1e3, "idle_under_span": share(under, idle),
            "idle_gaps_named": share(named, idle)}
