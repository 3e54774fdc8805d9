"""The row path's device milliseconds a frame: unproject and ray samples,
corner rows, extraction, the dirty mask and the integration's updates and
scatters (CUDA events around each call, summed) over the window."""


def read(trace):
    ms = trace.get("spans_ms", {}).get("rowops")
    if ms is None or not trace.get("frames_spanned"):
        return None
    return ms / trace["frames_spanned"]
