"""Median host milliseconds of the port's ``chunk`` span of one frame:
from the hand-in to ``fuse_sequence_rows``' return, before the
synchronise, over the traced window."""

import statistics


def read(trace):
    ms = (trace.get("host") or {}).get("chunk_ms")
    return statistics.median(ms) if ms else None
