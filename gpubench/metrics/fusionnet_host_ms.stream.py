"""FusionNet's host milliseconds a frame: the port's ``fusionnet`` span
(``Pipeline._network_estimate``: the fold check, the input copies, the
graph's launch, the output copy), over the frames the port counted in the
traced window."""


def read(trace):
    host = trace.get("host") or {}
    ms = host.get("spans", {}).get("fusionnet")
    if ms is None or not host.get("frames"):
        return None
    return ms / host["frames"]
