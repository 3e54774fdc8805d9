#!/usr/bin/env python3
"""Where one segmentation training step goes, on one CUDA device.

    python3 tools/profile_torch_segmentation.py [--out DIR]

Runs ``chip_smoke.py`` phase 11's configuration (AdapNet++ at ResNet-50
widths, 30 classes, bf16 on f32 master weights, batch 8 of 256x256
Synthetic frames, sgd + poly_lr) for stage 1 and stage 2 through the
trainer's step (``train_segmentation``'s loop body) and reports, per
stage, device time between CUDA events recorded around each stage call
(inputs to the device, encoders, eASPP / SSMA, decoder, loss, backward,
optimizer step), summed over one step; the step's host wall time; the
device's busy share (kernel times from torch.profiler over the wall
time), the kernel launches a step and the kernels with the most device
time. Stage times include any device idle time inside the stage. Writes
``profile_segmentation.json`` under ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke  # noqa: E402
from profile_torch_headline import StageTimer  # noqa: E402
from segfusion_tpu_torch import train_segmentation as seg  # noqa: E402
from segfusion_tpu_torch.config import (get_data_config,  # noqa: E402
                                        with_defaults)
from segfusion_tpu_torch.data import get_data  # noqa: E402
from segfusion_tpu_torch.utils.optim import get_optimizer  # noqa: E402
from segfusion_tpu_torch.utils.schedulers import get_schedule  # noqa: E402


def profile_stage(stage: int, dev, path: str) -> dict:
    cfg = with_defaults(chip_smoke.seg_config(path, stage, "tof_depth"))
    data = get_data("Synthetic", get_data_config(cfg, "train"), device=dev)
    batch = {k: np.stack([np.asarray(data[i][k]) for i in range(8)])
             for k in ("image", "tof_depth", "semantic_gt")}
    model = seg.new_adapnet(cfg.SEMANTIC_2D_MODEL, 0).to(dev)
    model.set_dropout_generator(torch.Generator(device=dev).manual_seed(0))
    opt = get_optimizer(cfg.TRAINING.optimizer, model,
                        get_schedule(0.005, cfg.TRAINING.scheduler))

    timer = StageTimer()
    seg.prepare_input_data = timer.wrap("inputs to the device",
                                        seg.prepare_input_data)
    for name in ("encoder_mod1", "encoder_mod2"):
        if hasattr(model, name):
            m = getattr(model, name)
            m.forward = timer.wrap("encoders", m.forward)
    for name in ("eASPP", "eASPP_mod1", "eASPP_mod2", "ssma_s1", "ssma_s2",
                 "ssma_res"):
        if hasattr(model, name):
            m = getattr(model, name)
            m.forward = timer.wrap("eASPP + SSMA", m.forward)
    model.decoder.forward = timer.wrap("decoder (+ aux heads)",
                                       model.decoder.forward)
    loss_fn = timer.wrap("loss (3 heads)", seg.cross_entropy)
    backward = timer.wrap("backward", torch.Tensor.backward)
    opt.step = timer.wrap("optimizer step (sgd)", opt.step)

    def step():
        inputs, target = seg.prepare_input_data(batch, cfg, dev)
        opt.zero_grad()
        outs = model.train()(*seg._modalities(model, inputs, "tof_depth"))
        loss = sum(lw * loss_fn(o.permute(0, 2, 3, 1), target,
                                ignore_index=0)
                   for lw, o in zip(seg.LOSS_WEIGHTS, outs))
        backward(loss)
        opt.step()

    for _ in range(3):                                   # warm-up
        step()
    torch.cuda.synchronize()
    timer.on = True
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stages = timer.totals()
    timer.on = False

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = collections.Counter()
    launches = 0
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and not evt.name.startswith("Optimizer.")):
            kernels[evt.name] += evt.device_time_total / 1e3  # us -> ms
            launches += 1
    busy_ms = sum(kernels.values())
    print(f"stage {stage} step (batch 8, 256x256, bf16 on f32 master "
          f"weights): {wall_ms:.2f} ms wall = {8e3 / wall_ms:.2f} images/s "
          f"(stage events on)")
    for name, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {name:26s} {ms:9.2f} ms  {100 * ms / wall_ms:5.1f}%")
    print(f"  profiled step: {prof_wall_ms:.2f} ms wall, kernels "
          f"{busy_ms:.2f} ms busy -> device idle share "
          f"{1 - busy_ms / prof_wall_ms:.3f}; {launches} kernel launches")
    if busy_ms == 0:
        print("  torch.profiler recorded no device time; only the "
              "CUDA-event stage times are valid", file=sys.stderr)
    top = kernels.most_common(8)
    for name, ms in top:
        print(f"    {ms:9.2f} ms  {name[:100]}")
    return {"stage": stage, "wall_ms": wall_ms, "stages_ms": stages,
            "profiled_wall_ms": prof_wall_ms, "busy_ms": busy_ms,
            "launches": launches, "top_kernels_ms": top}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile: torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"device: {chip_smoke.card_line()}")
    with tempfile.TemporaryDirectory(prefix="profile_seg_") as path:
        results = [profile_stage(s, dev, path) for s in (1, 2)]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_segmentation.json"), "w") as f:
        json.dump({"device": chip_smoke.card_line(), "steps": results}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
