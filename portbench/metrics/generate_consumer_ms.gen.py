"""generate_consumer_ms.gen: the host ms a caller held each block of the
generate loop, from its ``yield`` to the next request, per chunk:
``1e3 * generate_fields_iter.consumer_s / generate_fields_iter.chunks``,
the program's process-wide counters over the whole run. The window's
consumer is the cell's finite check of each block; the two warm-up chunks
and the traced chunks (held for next to nothing) count too, and dilute the
window's mean by about 1 %. None where the program keeps no such
counters."""


def read(out):
    if out.window.get("kind") != "generate":
        return None
    from downgan_tpu_torch import inference

    loop = inference.generate_fields_iter
    chunks = getattr(loop, "chunks", 0)
    return 1e3 * loop.consumer_s / chunks if chunks else None
