"""Arithmetic shared by the per-layer readers in ``metrics/``: each reader
file names its metric and calls one of these on the run's
:class:`~portbench.run.Outcome`. A reader that finds nothing to read
returns None, and the run leaves its metric out."""
from __future__ import annotations

from typing import Optional

from portbench import flops

#: The DRB kernels of the program, by the dtype they compute in, as their
#: names appear in the device trace (``ops/cuda/drb.cu``).
DRB_KERNELS = {"float32": r"\bdrb_kernel<", "bfloat16": r"\bdrb_kernel_bf16<"}


def window_mfu(out, flops_per_unit: float, unit: str) -> Optional[float]:
    """Share (%) of the dtype's peak: FLOPs of the work the window
    completed over the whole window."""
    w = out.window
    if not w.get(unit) or not w.get("seconds"):
        return None
    achieved = flops_per_unit * w[unit] / w["seconds"]
    return 100.0 * achieved / flops.PEAK_FLOPS[w["compute_dtype"]]


def train_mfu(out) -> Optional[float]:
    if out.window.get("kind") != "train":
        return None
    per_call = out.cached("train_flops", lambda: flops.reference_train_flops(out.run.raw))
    return window_mfu(out, per_call, "calls")


def gen_mfu(out) -> Optional[float]:
    if out.window.get("kind") != "generate":
        return None
    per_patch = out.cached("gen_flops",
                           lambda: flops.reference_generate_flops_per_sample(out.run.raw))
    return window_mfu(out, per_patch, "patches")


def drb_roofline(out) -> Optional[float]:
    """Share (%) of the DRB launches' summed bound in their summed device
    time, over the traced sub-window; each launch over ``drb_batch``
    samples of the configuration's filters and coarse size."""
    if out.trace is None:
        return None
    dtype = out.window["compute_dtype"]
    launches = out.trace.matching(DRB_KERNELS[dtype])
    if not launches:
        return None
    raw = out.run.raw
    bound = flops.drb_bound_seconds(out.window["drb_batch"], raw["filters"],
                                    raw["coarse_size"], raw["coarse_size"], dtype)
    return 100.0 * bound * len(launches) / (sum(d for _, _, d in launches) / 1e6)


def device_idle(out) -> Optional[float]:
    if out.trace is None or out.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - out.trace.busy_s() / out.trace.window_s)


def per_unit_ms(out, seconds: float, unit: str) -> Optional[float]:
    n = out.trace.units.get(unit) if out.trace is not None else None
    return 1e3 * seconds / n if n else None
