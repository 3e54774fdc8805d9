"""Median time from handing one frame in to its integration being
complete (synchronised), without the wait for its due time or for the
frame before it (host clock), over the window."""

import statistics


def read(trace):
    s = trace.get("service_ms")
    return statistics.median(s) if s else None
