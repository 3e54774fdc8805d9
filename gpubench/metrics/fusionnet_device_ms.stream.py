"""FusionNet's device milliseconds a frame: the work launched under the
port's ``fusionnet`` span (``Pipeline._network_estimate``), at any depth
and from the executor's replayed graphs, over the labelled stretch."""


def read(trace):
    lab = trace.get("labelled") or {}
    ms = lab.get("spans_device_ms", {}).get("fusionnet")
    if ms is None or not lab.get("device_ms") or not lab.get("frames"):
        return None
    return ms / lab["frames"]
