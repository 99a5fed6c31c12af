"""drb_roofline_pct.gen: the DRB kernel launches of the traced generate
chunks, their summed bound over their summed device time."""
from portbench.readers import drb_roofline as read  # noqa: F401
