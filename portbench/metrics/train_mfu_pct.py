"""train_mfu_pct: the reference step's (or round's) FLOPs times the calls the
window completed, over the whole window, as a share of the compute
dtype's peak (495 TFLOP/s TF32 for fp32, 989 bf16; H100 SXM, 700 W)."""
from portbench.readers import train_mfu as read  # noqa: F401
