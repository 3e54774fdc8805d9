"""Share of the traced stretch of a stream in which the device ran no
operation: 100 x (1 - busy / wall), from the profiler's trace; nothing
where the trace saw no device work."""


def read(trace):
    if not trace.get("wall_s") or not trace.get("busy_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["wall_s"])
