"""drb_roofline_pct.tuned: the DRB kernel launches of the traced tuned training
calls, their summed bound (max of FLOPs over peak, bytes over 3.35 TB/s)
over their summed device time."""
from portbench.readers import drb_roofline as read  # noqa: F401
