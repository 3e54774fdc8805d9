"""The whole step's share of the card's bf16 peak: the reference nets'
FLOPs a frame (counted once on the meta device) times the frames of the
traced stretch, over its wall time, against 989 TFLOP/s; nothing where
the trace saw no device work."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "gpubench_peaks", os.path.join(os.path.dirname(__file__), "_peaks.py"))
_peaks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_peaks)


def read(trace):
    if not (trace.get("wall_s") and trace.get("busy_s")
            and trace.get("flops_per_frame")):
        return None
    rate = trace["flops_per_frame"] * trace["frames"] / trace["wall_s"]
    return 100.0 * rate / _peaks.BF16_FLOPS
