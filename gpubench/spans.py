"""The traced run's stretches, read off the port's own tracer
(``segfusion_tpu_torch/utils/tracing.py``) and ``torch.profiler``.

- The window runs under ``tracing.enabled()``: the port's spans and
  counters, on the host's clock (:func:`host_readings`).
- A device-only stretch (:func:`profile` with ``host=False``) gives the
  device's busy time, its kernels by name and K1's device time
  (:func:`device_readings`).
- A count-only stretch hands the device stretch's frames to the port
  again, one block at a time, and reads the dirty carry that K1 is given
  before each block (``harness.k1_bytes``); no time is read from it.
- A labelled stretch, ``tracing.enabled(labels=True)`` under the profiler
  with the host's operations, reduced by ``tracing.reduce_profile``: each
  launch call, the device time of the work it launched and the device's
  idle gaps, put down to the innermost port span open at the call
  (:func:`labelled_readings`). A CUDA graph's kernels go to the span the
  graph was replayed in, so a layer replayed from a graph stays readable
  as long as its graph is replayed under the layer's span.

Nothing here replaces an attribute of the port.
"""

from __future__ import annotations

import collections
from typing import List

import torch

__all__ = ["profile", "busy_seconds", "merge_intervals", "device_readings",
           "host_readings", "labelled_readings", "idle_gaps"]

K1_KERNEL = "shadow_build_kernel"     # csrc/shadow_build.cu, K1 and K2


def profile(fn, device, host: bool):
    """``fn()`` under ``torch.profiler``: device activity, and with
    ``host`` the host's operations too (which slow the host)."""
    acts = [torch.profiler.ProfilerActivity.CPU] \
        if host or device.type != "cuda" else []
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        window = fn()
    return prof, window


def _device_events(prof):
    """(name, start_ns, end_ns) of each device event of a trace, from the
    profiler's raw results (a window's million launches parse in seconds
    this way, in minutes through ``prof.events()``)."""
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            s = e.start_ns()
            yield e.name(), s, s + e.duration_ns()


def busy_seconds(prof) -> float:
    """Seconds in which an operation ran on the device."""
    iv = [(s, e) for _, s, e in _device_events(prof)]
    return sum(e - s for s, e in merge_intervals(iv)) * 1e-9


def merge_intervals(iv):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_readings(prof, window) -> dict:
    """The device-only stretch: its wall and busy seconds, frames, device
    seconds by kernel name and K1's device seconds."""
    kernels = collections.Counter()
    iv = []
    for name, s, e in _device_events(prof):
        kernels[name] += (e - s) * 1e-9
        iv.append((s, e))
    busy = sum(e - s for s, e in merge_intervals(iv)) * 1e-9
    return {"wall_s": window["wall_s"], "busy_s": busy,
            "frames": window["frames"], "kernels": kernels,
            "k1_device_s": sum(v for k, v in kernels.items()
                               if K1_KERNEL in k)}


def host_readings(tr) -> dict:
    """The window's spans and counters (a ``tracing.Tracer``): host ms by
    span name, each chunk's host ms and the counters."""
    return {"frames": tr.counters["frames"],
            "spans": {k: v["host_ms"] for k, v in tr.summary().items()},
            "chunk_ms": tr.durations_ms("chunk"),
            "counters": dict(tr.counters)}


def labelled_readings(reduction: dict, frames: int) -> dict:
    """The labelled stretch's ``tracing.reduce_profile``: launch calls,
    device ms at any depth under each span, and its frames."""
    return {"frames": frames, "launches": reduction["launches"],
            "device_ms": reduction["device_ms"],
            "spans_device_ms": {k: v["device_ms_total"]
                                for k, v in reduction["spans"].items()}}


def idle_gaps(reduction: dict) -> List[list]:
    """The ten longest idle seconds by the span the host was in when the
    device woke; ``unclaimed`` where no span was open."""
    gaps = collections.Counter({k: v["idle_s"]
                                for k, v in reduction["spans"].items()})
    gaps["unclaimed"] = reduction["unclaimed"]["idle_s"]
    return [[n, s] for n, s in gaps.most_common(10) if s > 0]
