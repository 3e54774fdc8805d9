#!/usr/bin/env python3
"""Where the port's headline frame goes, on one CUDA device.

    python3 tools/profile_torch_headline.py [--frames 32] [--out DIR]

Runs the headline slice (segfusion_tpu_torch.headline: 448^3, 256x256,
frame_block 4, semantics every 8th block, bf16 geo and nets) and reports

* per stage, device time between CUDA events recorded around each stage
  call (semantic pre-pass, ray geometry, corner rows, shadow build,
  extraction, FusionNet, integration, dirty mask), summed over one chunk;
* the chunk's host wall time and the device's busy share (sum of kernel
  times from torch.profiler over the wall time);
* the kernels with the most device time.

Stage times include any device idle time inside the stage (launch gaps).
Writes ``profile_headline.json`` (the numbers) under ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from segfusion_tpu_torch.headline import (build_pipeline,  # noqa: E402
                                          headline_config, headline_volume,
                                          render_frames)
from segfusion_tpu_torch.ops import geometry, rowvol  # noqa: E402


class StageTimer:
    """Wraps callables so each call records a CUDA event pair."""

    def __init__(self):
        self.events = collections.defaultdict(list)
        self.on = False

    def wrap(self, name, fn):
        def timed(*a, **k):
            if not self.on:
                return fn(*a, **k)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            self.events[name].append((start, end))
            return out
        return timed

    def totals(self):
        torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in pairs)
                for name, pairs in self.events.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile: torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    pipe = build_pipeline(headline_config(), dev)
    frames = render_frames(args.frames, 256, 256, dev)
    volume = headline_volume(dev)
    layout = rowvol.RowLayout.for_shape(tuple(volume.num.shape))

    timer = StageTimer()
    pipe._predict_semantics_batched = timer.wrap(
        "semantic pre-pass (AdapNet++)", pipe._predict_semantics_batched)
    pipe.fusion_net.forward = timer.wrap("FusionNet v3",
                                         pipe.fusion_net.forward)
    for mod, name, label in [
            (geometry, "unproject", "unproject + ray samples"),
            (geometry, "sample_ray_points", "unproject + ray samples"),
            (rowvol, "corner_rows", "corner rows"),
            (rowvol, "build_shadow_dirty", "shadow build (dirty kernel)"),
            (rowvol, "build_shadow", "shadow build (full kernel)"),
            (rowvol, "dirty_tile_mask", "dirty tile mask"),
            (rowvol, "extract_rows", "extraction"),
            (rowvol, "integrate_rows", "integration (scatter-add/max)")]:
        setattr(mod, name, timer.wrap(label, getattr(mod, name)))

    warm = {k: v[:4] for k, v in frames.items()}
    s = pipe._new_stream(layout, pipe._enter_rows(layout, volume))
    pipe.fuse_sequence_rows(layout, s, warm)
    s = pipe._new_stream(layout, pipe._enter_rows(layout, volume))
    pipe.fuse_sequence_rows(layout, s, frames)        # steady state
    torch.cuda.synchronize()

    timer.on = True
    t0 = time.perf_counter()
    s = pipe.fuse_sequence_rows(layout, s, frames)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stages = timer.totals()
    timer.on = False

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        s = pipe.fuse_sequence_rows(layout, s, frames)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.name] += evt.device_time_total / 1e3  # us -> ms
    busy_ms = sum(kernels.values())
    if busy_ms == 0:
        print("profile: torch.profiler recorded no device time; only the "
              "CUDA-event stage times below are valid", file=sys.stderr)

    n = args.frames
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"chunk of {n} frames: {wall_ms:.2f} ms wall = "
          f"{n / wall_ms * 1e3:.2f} frames/s (stage events on)")
    for name, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {name:34s} {ms:9.2f} ms  {ms / n:7.3f} ms/frame  "
              f"{100 * ms / wall_ms:5.1f}%")
    print(f"profiled chunk: {prof_wall_ms:.2f} ms wall, kernels "
          f"{busy_ms:.2f} ms busy -> device idle share "
          f"{1 - busy_ms / prof_wall_ms:.3f}")
    top = kernels.most_common(15)
    for name, ms in top:
        print(f"  {ms:9.2f} ms  {name[:100]}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_headline.json"), "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "frames": n,
                   "wall_ms": wall_ms, "stages_ms": stages,
                   "profiled_wall_ms": prof_wall_ms, "busy_ms": busy_ms,
                   "top_kernels_ms": top}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
