"""gen_mfu_pct: the reference generator forward's FLOPs per patch times the
patches the window copied back, over the whole window, as a share of the
compute dtype's peak."""
from portbench.readers import gen_mfu as read  # noqa: F401
