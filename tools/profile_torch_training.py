#!/usr/bin/env python3
"""Where the port's training frame goes, on one CUDA device.

    python3 tools/profile_torch_training.py [--out DIR]

Runs the full-width training configuration of ``chip_smoke.py`` phase 9
(448^3, 256x256, FusionNet v3 gf 6 with the semantic head in bf16 on
float32 master weights, chunks of 8 frames through
``Pipeline.train_sequence_rows``, one rmsprop update a chunk) and reports

* per stage, device time between CUDA events recorded around each stage
  call (ray geometry, corner rows, shadow build, extraction of the volume
  and of the gt, FusionNet forward, loss, backward, integration, dirty
  mask, optimizer step), summed over one chunk;
* the chunk's host wall time and the device's busy share (sum of kernel
  times from torch.profiler over the wall time);
* the kernels with the most device time.

Stage times include any device idle time inside the stage. Writes
``profile_training.json`` under ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke  # noqa: E402
from profile_torch_headline import StageTimer  # noqa: E402
from segfusion_tpu_torch.core import pipeline as pipeline_mod  # noqa: E402
from segfusion_tpu_torch.headline import render_frames  # noqa: E402
from segfusion_tpu_torch.ops import geometry, rowvol  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile: torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = chip_smoke.train_config()
    n = int(cfg.TRAINING.optimization.accumulation_steps)
    pipe, layout, stream, gt_shadow, opt = chip_smoke.trainer(cfg, dev, 448)
    frames = chip_smoke.with_labels(render_frames(n, 256, 256, dev))
    resets = [False] * n

    timer = StageTimer()
    pipe.fusion_net.forward = timer.wrap("FusionNet forward",
                                         pipe.fusion_net.forward)
    opt.step = timer.wrap("optimizer step (clip + rmsprop)", opt.step)
    pipeline_mod.fusion_loss = timer.wrap("loss", pipeline_mod.fusion_loss)
    torch.Tensor.backward = timer.wrap("backward", torch.Tensor.backward)
    for mod, name, label in [
            (geometry, "unproject", "unproject + ray samples"),
            (geometry, "sample_ray_points", "unproject + ray samples"),
            (rowvol, "corner_rows", "corner rows"),
            (rowvol, "build_shadow_dirty", "shadow build (dirty kernel)"),
            (rowvol, "dirty_tile_mask", "dirty tile mask"),
            (rowvol, "extract_rows", "extraction (volume + gt)"),
            (rowvol, "integrate_rows", "integration (scatter-add)")]:
        setattr(mod, name, timer.wrap(label, getattr(mod, name)))

    def chunk(s):
        opt.zero_grad()
        _, s = pipe.train_sequence_rows(layout, s, gt_shadow, frames, resets)
        opt.step()
        return s

    stream = chunk(chunk(stream))                    # warm-up
    torch.cuda.synchronize()
    timer.on = True
    t0 = time.perf_counter()
    stream = chunk(stream)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stages = timer.totals()
    timer.on = False

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        stream = chunk(stream)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = collections.Counter()
    launches = 0
    for evt in prof.events():
        # the optimizer's record_function range shows on the device
        # timeline too: count kernels only
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and not evt.name.startswith("Optimizer.")):
            kernels[evt.name] += evt.device_time_total / 1e3  # us -> ms
            launches += 1
    busy_ms = sum(kernels.values())
    if busy_ms == 0:
        print("profile: torch.profiler recorded no device time; only the "
              "CUDA-event stage times below are valid", file=sys.stderr)

    print(f"device: {chip_smoke.card_line()}")
    print(f"chunk of {n} training frames: {wall_ms:.2f} ms wall = "
          f"{n / wall_ms * 1e3:.2f} frames/s (stage events on)")
    for name, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {name:34s} {ms:9.2f} ms  {ms / n:7.3f} ms/frame  "
              f"{100 * ms / wall_ms:5.1f}%")
    print(f"profiled chunk: {prof_wall_ms:.2f} ms wall, kernels "
          f"{busy_ms:.2f} ms busy -> device idle share "
          f"{1 - busy_ms / prof_wall_ms:.3f}; {launches} kernel launches")
    top = kernels.most_common(12)
    for name, ms in top:
        print(f"  {ms:9.2f} ms  {name[:100]}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_training.json"), "w") as f:
        json.dump({"device": chip_smoke.card_line(), "frames": n,
                   "wall_ms": wall_ms, "stages_ms": stages,
                   "profiled_wall_ms": prof_wall_ms, "busy_ms": busy_ms,
                   "launches": launches, "top_kernels_ms": top}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
