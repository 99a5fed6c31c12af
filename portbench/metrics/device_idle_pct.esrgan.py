"""device_idle_pct.esrgan: 1 - (union of device kernel, memcpy and memset
intervals / traced window), over the traced ESRGAN training calls."""
from portbench.readers import device_idle as read  # noqa: F401
