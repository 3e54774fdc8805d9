"""The row path's device milliseconds a frame: the work launched under the
port's ``rowops.*`` spans (samples and corner rows, the dirty mask,
extraction, updates, scatters; siblings, none inside another), at any
depth and from graphs replayed there, over the labelled stretch."""


def read(trace):
    lab = trace.get("labelled") or {}
    ms = [v for k, v in lab.get("spans_device_ms", {}).items()
          if k.startswith("rowops.")]
    if not ms or not lab.get("device_ms") or not lab.get("frames"):
        return None
    return sum(ms) / lab["frames"]
