"""copy_out_ms.gen: device time of the device-to-host copies in the traced
generate chunks, per chunk."""
from portbench.readers import per_unit_ms


def read(out):
    if out.trace is None:
        return None
    copies = [d for name, _, d in out.trace.copies if "DtoH" in name]
    return per_unit_ms(out, sum(copies) / 1e6, "chunks") if copies else None
