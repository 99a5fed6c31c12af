"""gen_patches_per_s.loop: the patches that the generate loop copied back
to host memory over the whole window, per second of it. Per-layer, as its
runs spread by more than half of the largest bound an end-to-end metric
may have (the pageable copy back runs through the host's memory)."""


def read(out):
    w = out.window
    if w.get("kind") != "generate" or not w.get("seconds"):
        return None
    return w["patches"] / w["seconds"]
