"""Spans around the calls into the port's layers, and the reduction of a
``torch.profiler`` trace to the device's busy time, its kernels and its
idle gaps.

The spans wrap the port's functions from outside, as
``tools/profile_torch_headline.py`` does: each call records a pair of CUDA
events (``mode="events"``: device time between them, launch gaps inside
the layer included) or a ``torch.profiler.record_function`` label
(``mode="labels"``: what the host was doing when the device went idle);
``mode="count"`` only keeps K1's dirty masks.
"""

from __future__ import annotations

import collections
from typing import Dict, List

import torch

__all__ = ["LAYERS", "Spans", "profile", "summarise", "busy_seconds",
           "merge_intervals", "gaps_by_layer"]

# layer -> the port's functions whose calls make it up
LAYERS = {
    "adapnet": [("pipe", "_predict_semantics_batched")],
    "fusionnet": [("pipe", "_network_estimate")],
    "rowops": [("geometry", "unproject"), ("geometry", "sample_ray_points"),
               ("rowvol", "corner_rows"), ("rowvol", "extract_rows"),
               ("rowvol", "dirty_tile_mask"), ("rowvol", "row_updates"),
               ("rowvol", "scatter_updates")],
    "k1": [("rowvol", "build_shadow_dirty"), ("rowvol", "build_shadow")],
}


class Spans:
    """Wraps the layers' functions for the life of the ``with`` block."""

    def __init__(self, run, mode: str):
        from segfusion_tpu_torch.ops import geometry, rowvol
        self.run, self.mode = run, mode
        self.owners = {"pipe": run.pipe, "geometry": geometry,
                       "rowvol": rowvol}
        self.events: Dict[str, List] = collections.defaultdict(list)
        self.k1_dirty: List[torch.Tensor] = []
        self.saved = []

    def _wrap(self, layer, attr, fn):
        cuda = self.run.device.type == "cuda"

        def wrapped(*a, **k):
            if attr == "build_shadow_dirty":
                self.k1_dirty.append(a[2])
            elif attr == "build_shadow":
                self.k1_dirty.append(None)
            if self.mode == "labels":
                with torch.profiler.record_function(f"layer:{layer}"):
                    return fn(*a, **k)
            if not cuda or self.mode == "count":
                return fn(*a, **k)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            self.events[layer].append((start, end))
            return out
        return wrapped

    def __enter__(self):
        for layer, targets in LAYERS.items():
            for name, attr in targets:
                owner = self.owners[name]
                fn = getattr(owner, attr)
                self.saved.append((owner, attr, owner.__dict__.get(attr)))
                setattr(owner, attr, self._wrap(layer, attr, fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, old in reversed(self.saved):
            if old is None:         # an instance attribute over the method
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
        self.saved.clear()
        return False

    def totals(self) -> Dict[str, float]:
        """Device milliseconds per layer over the block."""
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
        return {layer: sum(s.elapsed_time(e) for s, e in pairs)
                for layer, pairs in self.events.items()}


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


def busy_seconds(prof) -> float:
    """Seconds in which an operation ran on the device, from a trace's
    raw events (a window's million launches parse in seconds this way,
    in minutes through ``prof.events()``)."""
    iv = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            s = e.start_ns()
            iv.append((s, s + e.duration_ns()))
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


def gaps_by_layer(busy, labels, t0, t1):
    """Seconds of device idleness in [t0, t1] (us) by the innermost host
    label open when the device woke (``labels``: (name, start, end) us);
    idleness under no label is the host between layers."""
    gaps = collections.Counter()
    prev = t0
    edges = [(s, e) for s, e in busy] + [(t1, t1)]
    for s, e in edges:
        if s > prev:
            inner = [(le - ls, name) for name, ls, le in labels
                     if ls <= s <= le]
            name = min(inner)[1] if inner else "host between layers"
            gaps[name] += (s - prev) * 1e-6
        prev = max(prev, e)
    return gaps


def host_gaps(prof, window) -> collections.Counter:
    """Idle seconds of a stretch traced with host labels, by layer."""
    busy_iv, labels, host = [], [], []
    for evt in prof.events():
        tr = evt.time_range
        on_device = evt.device_type == torch.autograd.DeviceType.CUDA
        if evt.name.startswith("layer:"):
            if not on_device:
                labels.append((evt.name[6:], tr.start, tr.end))
            continue
        (busy_iv if on_device else host).append((tr.start, tr.end))
    busy = merge_intervals(busy_iv)
    t0 = min([s for s, _ in host] + [s for s, _ in busy]) if host else 0.0
    return gaps_by_layer(busy, labels, t0, t0 + window["wall_s"] * 1e6)


def summarise(prof, window, sp: Spans, run, gaps_prof, gaps_window) -> dict:
    """The numbers of a stretch traced on the device alone (``prof``) for
    the metric readers and the breakdown; the idle gaps by layer come from
    a second stretch traced with the host's labels (``gaps_prof``)."""
    kernels = collections.Counter()
    busy_iv, k1_s = [], 0.0
    for evt in prof.events():
        tr = evt.time_range
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.name] += (tr.end - tr.start) * 1e-6
            busy_iv.append((tr.start, tr.end))
            if "shadow_build_kernel" in evt.name:
                k1_s += (tr.end - tr.start) * 1e-6
    busy = merge_intervals(busy_iv)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps = host_gaps(gaps_prof, gaps_window)
    lay = run.layout
    geo_b = lay.geo_rows * 128 * run.pipe.geo_dtype.itemsize
    shadow_b = lay.shadow_rows * 128 * 4
    k1_bytes = 0.0
    for dirty in sp.k1_dirty:       # chip_smoke.py's K1 byte accounting
        frac = 1.0 if dirty is None else float(
            dirty[:-1].float().mean())
        k1_bytes += frac * (geo_b + shadow_b)
    return {"wall_s": window["wall_s"], "busy_s": busy_s, "frames": window["frames"],
            "k1": {"device_s": k1_s, "bytes": k1_bytes},
            "breakdown": {
                "device_ops": [[n, s] for n, s in kernels.most_common(10)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(10)]}}
