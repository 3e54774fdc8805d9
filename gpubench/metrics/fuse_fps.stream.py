"""Frames fused a second by the closed loop over the whole window of the
traced run (every frame handed in over the window's host time, ending in
a synchronise): the host-clock rate, which in speed.stream swings too
widely from process to process to hold a bound."""


def read(trace):
    return trace.get("window_fps") or None
