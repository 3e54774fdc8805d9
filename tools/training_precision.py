#!/usr/bin/env python3
"""How far the port's training lands from float64, on the card and on the
CPU.

    python3 tools/training_precision.py

Runs ``chip_smoke.py`` phase 10's stream (64^3, 32x32 frames, FusionNet
v3 gf 2, 2 chunks of 4 with a reset, lr 1e-4) on the CPU in float64 (the
reference) and float32, and on the card in float32 with cuDNN on and off
and in float64, under the SGD rule (momentum 0.9) and rmsprop; for each
it prints the losses and, against the reference, the first chunk's
gradients (max over the largest, relative L2), the parameters after both
updates (over the update's L2 norm) and the volume (weights, tsdf where
the weight exceeds 0.05). Then, for each convolution of one frame's
training step on the card, its float32 forward and both backwards
against float64 on the same inputs (max error over the largest value).
TF32 off throughout.
"""

from __future__ import annotations

import os
import sys

import torch
from torch.nn.grad import conv2d_input, conv2d_weight

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def streams(dev, frames, resets):
    for rule in ("sgd", "rmsprop"):
        cfg = cs.small_train_config(rule)
        ref = cs.small_training_run(cfg, "cpu", frames, resets,
                                    torch.float64)
        obs = ref[4].weights > 0.05
        for tag, d, dt, cudnn in (("cpu f32", "cpu", torch.float32, True),
                                  ("card f32", dev, torch.float32, True),
                                  ("card f32 cuDNN off", dev, torch.float32,
                                   False),
                                  ("card f64", dev, torch.float64, True)):
            with torch.backends.cudnn.flags(enabled=cudnn):
                losses, g, p, _, out = cs.small_training_run(
                    cfg, d, frames, resets, dt)
            dg = g.double() - ref[1].double()
            dp = p.double() - ref[2].double()
            dw = out.weights.cpu().double() - ref[4].weights.double()
            dt_ = out.tsdf.cpu().double() - ref[4].tsdf.double()
            print(f"{rule:8s} {tag:19s} losses {losses} (f64 {ref[0]}); "
                  f"grad max {float(dg.abs().max() / ref[1].abs().max()):.3g}"
                  f" l2 {float(dg.norm() / ref[1].norm()):.3g}; params / "
                  f"update {float(dp.norm() / ref[3].norm()):.3g}; weights "
                  f"{float(dw.abs().max()):.3g}, tsdf "
                  f"{float(dt_[obs].abs().max()):.3g}", flush=True)


def conv_errors(dev, frames):
    """Each convolution of one frame's step: f32 against f64 on the same
    inputs and output gradients."""
    pipe, layout, stream, gt_shadow, _ = cs.trainer(
        cs.small_train_config("sgd"), dev, 64, seed=3)
    seen = {}

    def keep_input(m, inputs, out):
        seen.setdefault(m, [None, None])[0] = inputs[0].detach()

    def keep_grad(m, grad_in, grad_out):
        seen[m][1] = grad_out[0].detach()

    for m in pipe.fusion_net.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(keep_input)
            m.register_full_backward_hook(keep_grad)
    pipe.train_sequence_rows(layout, stream, gt_shadow,
                             {k: v[:1].to(dev) for k, v in frames.items()},
                             [False])

    def err(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())
    worst = [0.0, 0.0, 0.0]
    for m, (x, go) in seen.items():
        kw = dict(stride=m.stride, padding=m.padding, dilation=m.dilation)
        w64, x64, go64 = m.weight.double(), x.double(), go.double()
        errs = (err(torch.nn.functional.conv2d(x, m.weight, m.bias, **kw),
                    torch.nn.functional.conv2d(x64, w64, m.bias.double(),
                                               **kw)),
                err(conv2d_weight(x, m.weight.shape, go, **kw),
                    conv2d_weight(x64, m.weight.shape, go64, **kw)),
                err(conv2d_input(x.shape, m.weight, go, **kw),
                    conv2d_input(x.shape, w64, go64, **kw)))
        worst = [max(a, b) for a, b in zip(worst, errs)]
    print(f"card f32 convolutions against f64 ({len(seen)} layers, worst "
          f"over the largest value): forward {worst[0]:.3g}, weight "
          f"gradient {worst[1]:.3g}, input gradient {worst[2]:.3g}")


def main() -> int:
    if not torch.cuda.is_available():
        print("training_precision: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}")
    frames = cs.with_labels(cs.render_frames(8, 32, 32, "cpu"))
    streams(torch.device("cuda", 0), frames, [False] * 6 + [True, False])
    conv_errors(torch.device("cuda", 0), frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
