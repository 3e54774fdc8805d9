"""Launch calls the host made a frame (kernel launches, async copies and
sets; a CUDA graph's launch once), from ``tracing.reduce_profile`` over
the labelled stretch."""


def read(trace):
    lab = trace.get("labelled") or {}
    if not lab.get("launches") or not lab.get("frames"):
        return None
    return lab["launches"] / lab["frames"]
