"""AdapNet++'s device milliseconds a frame: the work launched under the
port's ``adapnet`` span (the labels' pre-pass over a chunk), at any depth,
over the labelled stretch."""


def read(trace):
    lab = trace.get("labelled") or {}
    ms = lab.get("spans_device_ms", {}).get("adapnet")
    if ms is None or not lab.get("device_ms") or not lab.get("frames"):
        return None
    return ms / lab["frames"]
