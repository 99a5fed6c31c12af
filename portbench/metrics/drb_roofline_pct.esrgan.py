"""drb_roofline_pct.esrgan: the wide DRB kernel's launches in the traced
training calls (``drb_kernel_wide``, ESRGAN's block), their summed bound
(max of 3 x FLOPs over the TF32 peak, bytes over 3.35 TB/s, by the growth
formula of ``reference/esrgan.py``) over their summed device time."""
from __future__ import annotations

from typing import Optional

from portbench.reference import esrgan

KERNEL = r"\bdrb_kernel_wide\b"


def read(out) -> Optional[float]:
    if out.trace is None:
        return None
    launches = out.trace.matching(KERNEL)
    if not launches:
        return None
    raw = out.run.raw
    bound = esrgan.drb_bound_seconds(out.window["drb_batch"], raw["filters"], esrgan.GROWTH,
                                     raw["coarse_size"], raw["coarse_size"])
    return 100.0 * bound * len(launches) / (sum(d for _, _, d in launches) / 1e6)
