"""train_mfu_pct.esrgan: the ESRGAN reference step's FLOPs (``reference/
esrgan.py``, on ``meta``) times the calls the window completed, over the
whole window, as a share of the fp32 (TF32 tensor-core) peak, 495 TFLOP/s
(H100 SXM, 700 W)."""
from __future__ import annotations

from typing import Optional

from portbench import readers
from portbench.reference import esrgan


def read(out) -> Optional[float]:
    if out.window.get("kind") != "train":
        return None
    per_call = out.cached("train_flops_esrgan",
                          lambda: esrgan.reference_train_flops(out.run.raw))
    return readers.window_mfu(out, per_call, "calls")
