"""device_idle_pct.train: 1 - (union of device kernel, memcpy and memset
intervals / traced window), over the traced training calls."""
from portbench.readers import device_idle as read  # noqa: F401
