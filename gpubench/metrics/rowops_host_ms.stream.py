"""The row path's host milliseconds a frame: the port's ``rowops.*`` spans
(siblings, none inside another) summed, over the frames the port counted
in the traced window."""


def read(trace):
    host = trace.get("host") or {}
    ms = [v for k, v in host.get("spans", {}).items()
          if k.startswith("rowops.")]
    if not ms or not host.get("frames"):
        return None
    return sum(ms) / host["frames"]
