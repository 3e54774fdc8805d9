"""Share of the calls into a graphed layer that replayed a CUDA graph: the
port's counters ``<x>.replays`` over ``<x>.replays`` + ``<x>.eager``,
summed over every such pair, in the traced window."""


def read(trace):
    counters = (trace.get("host") or {}).get("counters", {})
    replays = sum(v for k, v in counters.items() if k.endswith(".replays"))
    eager = sum(v for k, v in counters.items() if k.endswith(".eager"))
    if not replays + eager:
        return None
    return 100.0 * replays / (replays + eager)
