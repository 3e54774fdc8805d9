"""FusionNet's device milliseconds a frame (``Pipeline._network_estimate``,
CUDA events around each call) over the window."""


def read(trace):
    ms = trace.get("spans_ms", {}).get("fusionnet")
    if ms is None or not trace.get("frames_spanned"):
        return None
    return ms / trace["frames_spanned"]
