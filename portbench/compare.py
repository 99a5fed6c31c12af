"""The numbers that decide ``correct``, each a gap between what the timed
path produced and what the plain reference computes from the same inputs.

Training (``train_gaps``), over the first ``checked_calls`` calls of the
window's step (or fused round), which set-up drives through the window's
own call and feed:

* ``loss_gap``: the worst relative gap of ``critic_loss`` and, where a
  generator update ran, ``gen_loss``, over the calls;
* ``metric_gap``: the worst relative gap of MAE, MSE and MS-SSIM, and of
  Wass measured against the critic's mean score magnitude
  ((|E C(real)| + |E C(fake)|) / 2, when that is larger than |Wass|: Wass
  is a difference of two scores), over the calls;
* ``field_gap``: the same over MAE, MSE and MS-SSIM alone, the fields'
  numbers, which a bf16 Wass does not drown;
* ``grad1_gap``: after the first call, leaf by leaf, the gap between the
  norms of Adam's first moment (0.1 x the gradient where the network
  updated once), against the reference leaf's norm or the network's
  median leaf norm, whichever is larger; the worst leaf;
* ``delta_gap``: the same for each leaf's change after the last checked
  call. Leaves whose first moment in the reference is under 1e-3 of the
  network's median leaf move by round-off alone under Adam (the critic's
  last bias: E C(fake) - E C(real) does not depend on it) and are left out;
* ``grad1_diff``, ``delta_diff``: the first moment and the change as one
  vector a network, |program - reference| / |reference|, the worst
  network. A gap of norms barely sees unbiased rounding (it is
  orthogonal to the vector for the most part), so where the control one
  precision down reads like the program on the gaps of norms, these
  separate them.
A cell compares the numbers its ``limits`` name.

Answers checked one by one (``answer_gap``): the worst, over the sampled
answers, of max |program - reference| / max |reference|.

A non-finite reading is a gap of infinity.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence

LOSS_KEYS = ("critic_loss", "gen_loss")
FIELD_KEYS = ("MAE", "MSE", "MSSSIM")
EXCLUDE_BELOW = 1e-3


def _rel(p: float, r: float, scale: float) -> float:
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    return abs(p - r) / max(abs(r), scale, 1e-30)


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return 0.0 if not n else (s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2]))


def _network(leaf: str) -> str:
    return leaf.split(".", 1)[0]


def _leaf_gaps(prog: Mapping[str, float], ref: Mapping[str, float],
               leaves: Sequence[str]) -> Dict[str, float]:
    """Each leaf's gap of norms, against its own reference norm or its
    network's median leaf's, whichever is larger."""
    out = {}
    for net in sorted({_network(k) for k in leaves}):
        mine = [k for k in leaves if _network(k) == net]
        med = _median([ref[k] for k in mine])
        out.update({k: _rel(prog[k], ref[k], med) for k in mine})
    return out


def call_gaps(prog: dict, ref: dict) -> List[Dict[str, float]]:
    """Each checked call's gap by key (what ``loss_gap`` and
    ``metric_gap`` take the worst of)."""
    out = []
    for p, r in zip(prog["calls"], ref["calls"]):
        scale = 0.5 * (abs(r["c_real"]) + abs(r["c_fake"]))
        out.append({k: _rel(p[k], r[k], scale if k == "Wass" else 0.0)
                    for k in (*LOSS_KEYS, *FIELD_KEYS, "Wass") if k in r})
    return out


def excluded_leaves(ref: dict) -> List[str]:
    """Leaves whose first moment in the reference is under
    :data:`EXCLUDE_BELOW` of their network's median leaf."""
    m1 = _norms(ref["m1"])
    out = []
    for net in sorted({_network(k) for k in m1}):
        mine = [k for k in m1 if _network(k) == net]
        med = _median([m1[k] for k in mine])
        out += [k for k in mine if m1[k] < EXCLUDE_BELOW * med]
    return sorted(out)


def _diff(prog: Mapping, ref: Mapping, leaves: Sequence[str]) -> float:
    """The worst network's |program - reference| over |reference|, each
    network's leaves taken as one vector."""
    worst = 0.0
    for net in sorted({_network(k) for k in leaves}):
        mine = [k for k in leaves if _network(k) == net]
        num = math.sqrt(sum(float((prog[k] - ref[k]).double().square().sum()) for k in mine))
        den = math.sqrt(sum(float(ref[k].double().square().sum()) for k in mine))
        worst = max(worst, num / max(den, 1e-30) if math.isfinite(num) else math.inf)
    return worst


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog``/``ref``: {"calls": [metric dicts], "m1": {leaf: tensor},
    "delta": {leaf: tensor}}; the reference's call dicts also carry
    ``c_real`` and ``c_fake``."""
    by_call = call_gaps(prog, ref)
    loss = max((g[k] for g in by_call for k in LOSS_KEYS if k in g), default=math.inf)
    metric = max((g[k] for g in by_call for k in (*FIELD_KEYS, "Wass")), default=math.inf)
    field = max((g[k] for g in by_call for k in FIELD_KEYS), default=math.inf)
    if len(prog["calls"]) != len(ref["calls"]):
        loss = math.inf
    grad1, delta = _leaf_readings(prog, ref)
    moved = _moved(ref)
    return {"loss_gap": loss, "metric_gap": metric, "field_gap": field,
            "grad1_gap": max(grad1.values()), "delta_gap": max(delta.values()),
            "grad1_diff": _diff(prog["m1"], ref["m1"], sorted(ref["m1"])),
            "delta_diff": _diff(prog["delta"], ref["delta"], moved)}


def _moved(ref: dict) -> List[str]:
    out = set(excluded_leaves(ref))
    return [k for k in sorted(ref["m1"]) if k not in out]


def _norms(tensors: Mapping) -> Dict[str, float]:
    return {k: float(t.double().norm()) for k, t in tensors.items()}


def _leaf_readings(prog: dict, ref: dict):
    return (_leaf_gaps(_norms(prog["m1"]), _norms(ref["m1"]), sorted(ref["m1"])),
            _leaf_gaps(_norms(prog["delta"]), _norms(ref["delta"]), _moved(ref)))


def worst_leaves(prog: dict, ref: dict, top: int = 3) -> Dict[str, list]:
    """The leaves with the largest gaps, for a look at what sets the worst."""
    grad1, delta = _leaf_readings(prog, ref)
    return {name: sorted(([k, v] for k, v in g.items()), key=lambda kv: -kv[1])[:top]
            for name, g in (("grad1", grad1), ("delta", delta))}


def answer_gap(pairs) -> float:
    """``pairs``: (program answer, reference answer) numpy arrays."""
    import numpy as np

    worst = 0.0
    for p, r in pairs:
        p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
        if p.shape != r.shape or not np.isfinite(p).all():
            return math.inf
        worst = max(worst, float(np.abs(p - r).max() / max(np.abs(r).max(), 1e-30)))
    return worst
