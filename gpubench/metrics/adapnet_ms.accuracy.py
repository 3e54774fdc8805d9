"""AdapNet++'s device milliseconds a frame
(``Pipeline._predict_semantics_batched``, CUDA events) over the window."""


def read(trace):
    ms = trace.get("spans_ms", {}).get("adapnet")
    if ms is None or not trace.get("frames_spanned"):
        return None
    return ms / trace["frames_spanned"]
