"""device_idle_pct.gen: 1 - (union of device intervals / traced window),
over the traced generate chunks."""
from portbench.readers import device_idle as read  # noqa: F401
