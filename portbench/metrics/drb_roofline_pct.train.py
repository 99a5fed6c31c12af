"""drb_roofline_pct.train: the DRB kernel launches of the traced training
calls, their summed bound (max of FLOPs over peak, bytes over 3.35 TB/s)
over their summed device time."""
from portbench.readers import drb_roofline as read  # noqa: F401
