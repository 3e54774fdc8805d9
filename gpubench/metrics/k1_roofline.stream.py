"""K1 (``csrc/shadow_build.cu`` ``shadow_build_kernel``, the dirty shadow
build) against its byte bound: each call's dirty share of the tiles (the
dirty carry the port's ``RowStream`` hands it, read before each block as
the stretch's frames are handed in again) times the geo and shadow bytes
(``chip_smoke.py``'s accounting), summed over the device-only stretch, at
3.35 TB/s, over the kernel's device time there."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "gpubench_peaks", os.path.join(os.path.dirname(__file__), "_peaks.py"))
_peaks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_peaks)


def read(trace):
    k1 = trace.get("k1") or {}
    if not k1.get("device_s") or not k1.get("bytes"):
        return None
    return 100.0 * (k1["bytes"] / _peaks.HBM_BYTES) / k1["device_s"]
