#!/usr/bin/env python3
"""How far the port's training lands from float64, on the card and on the
CPU, and what each remedy for the card's f32 gradients costs.

    python3 tools/training_precision.py

Runs ``chip_smoke.py`` phase 10's stream (64^3, 32x32 frames, FusionNet
v3 gf 2, 2 chunks of 4 with a reset, lr 1e-4) on the CPU in float64 (the
reference) and in float32, and on the card in float32 and float64, under
the SGD rule (momentum 0.9) and rmsprop, TF32 off throughout:

* "cpu f32", "card f32": the port as it stands (BatchNorm's one-pass
  variance as Flax's default; a float32 training step on a card runs its
  convolutions with cuDNN off, ``models/layers.training_convolutions``);
* "cuDNN on": the step with cuDNN's convolutions, as the port trained
  before; with BatchNorm's variance in two passes; with cuDNN's
  ``benchmark`` and with ``deterministic``; with each convolution's bias
  added after it ("bias apart"), so that autograd's reduction and not
  the convolution's backward sums its gradient;
* "cpu f32 two-pass": the two passes on the CPU.

For each it prints the losses and, against the reference, the first
chunk's gradients (max over the largest, relative L2), the parameters
after both updates (over the update's L2 norm) and the volume (weights,
tsdf where the weight exceeds 0.05), and the stream's ms a chunk (host
clock, synchronised, after a warm-up run); for the CPU and the cuDNN run
under SGD, the parameter tensors that carry most of the gradient error.
First, the first chunk's frames module by module (cuDNN on against the
CPU's float64); then the cost at full width: ms of one train-mode
forward and backward of phase 9's net (v3 gf 6 with the semantic head, 8
frames of 256x256) in f32 and in bf16 on f32 master weights under each
card setting; last, each convolution of one frame's training step on the
card, its float32 forward and both backwards against float64 on the same
inputs (max error over the largest value).
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch
from torch.nn.grad import conv2d_input, conv2d_weight

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from segfusion_tpu_torch.core import pipeline as pipeline_mod  # noqa: E402
from segfusion_tpu_torch.models import layers  # noqa: E402
from segfusion_tpu_torch.models.fusionnet import build_fusion_net  # noqa: E402,E501


def two_pass_variance(xf, mean):
    """BatchNorm's variance in two passes, ``mean((x - mean)^2)`` (Flax's
    ``use_fast_variance=False``)."""
    return (xf - mean[:, None, None]).square().mean((0, 2, 3))


def bias_apart(self, x):
    """Conv2d.forward with the bias added after the convolution, so that
    autograd's reduction, not the convolution's backward, sums its
    gradient."""
    y = self._conv_forward(x, self.weight.to(x.dtype), None)
    return y + self.bias.to(x.dtype)[:, None, None]


def _no_repair(dtype, device):
    return contextlib.nullcontext()


@contextlib.contextmanager
def remedy(repair=True, variance=None, benchmark=False, deterministic=False,
           conv=None):
    """A run's setting: the port's repair (cuDNN off for a float32
    training step) or cuDNN kept, with ``benchmark`` / ``deterministic``;
    BatchNorm's variance formula and the Conv2d forward where given. TF32
    stays off."""
    saved = (pipeline_mod.training_convolutions, layers.batch_variance,
             layers.Conv2d.forward)
    if not repair:
        pipeline_mod.training_convolutions = _no_repair
    if variance is not None:
        layers.batch_variance = variance
    if conv is not None:
        layers.Conv2d.forward = conv
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=benchmark,
                                        deterministic=deterministic,
                                        allow_tf32=False):
            yield
    finally:
        (pipeline_mod.training_convolutions, layers.batch_variance,
         layers.Conv2d.forward) = saved


REMEDIES = [  # (label, device, remedy settings)
    ("cpu f32", "cpu", {}),
    ("cpu f32 two-pass", "cpu", {"variance": two_pass_variance}),
    ("card f32", "card", {}),
    ("card f32 cuDNN on", "card", {"repair": False}),
    ("card f32 cuDNN on two-pass", "card",
     {"repair": False, "variance": two_pass_variance}),
    ("card f32 cuDNN on benchmark", "card",
     {"repair": False, "benchmark": True}),
    ("card f32 cuDNN on deterministic", "card",
     {"repair": False, "deterministic": True}),
    ("card f32 cuDNN on bias apart", "card",
     {"repair": False, "conv": bias_apart}),
]


def breakdown(cfg, g, ref):
    """The parameter tensors that carry most of a gradient error: their
    share of its squared L2, their largest error over the reference's
    largest gradient, and the relative L2 over every other tensor."""
    names = [(n, p.numel()) for n, p in
             build_fusion_net(cfg.FUSION_MODEL).named_parameters()]
    rows, at = [], 0
    for n, k in names:
        d = (g[at:at + k].double() - ref[at:at + k].double())
        rows.append((float(d.square().sum()), float(d.abs().max()), n,
                     at, k))
        at += k
    total = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    gmax = float(ref.abs().max())
    top = ", ".join(f"{n} {100 * e / total:.1f}% (max {m / gmax:.3g})"
                    for e, m, n, _, _ in rows[:6])
    rest = torch.ones(len(ref), dtype=torch.bool)
    for _, _, n, at, k in rows[:6]:
        rest[at:at + k] = False
    d = g.double()[rest] - ref.double()[rest]
    return (f"largest shares of the error: {top}; relative L2 over the "
            f"other tensors {float(d.norm() / ref.double()[rest].norm()):.3g}")


def streams(dev, frames, resets):
    for rule in ("sgd", "rmsprop"):
        cfg = cs.small_train_config(rule)
        ref = cs.small_training_run(cfg, "cpu", frames, resets,
                                    torch.float64)
        obs = ref[4].weights > 0.05
        runs = [(label, dev if where == "card" else "cpu", torch.float32,
                 settings) for label, where, settings in REMEDIES]
        runs.append(("card f64", dev, torch.float64, {}))
        for label, d, dt, settings in runs:
            with remedy(**settings):
                cs.small_training_run(cfg, d, frames, resets, dt)  # warm-up
                losses, g, p, _, out, ms = cs.small_training_run(
                    cfg, d, frames, resets, dt)
            dg = g.double() - ref[1].double()
            dp = p.double() - ref[2].double()
            dw = out.weights.cpu().double() - ref[4].weights.double()
            dt_ = out.tsdf.cpu().double() - ref[4].tsdf.double()
            print(f"{rule:8s} {label:32s} losses {losses} (f64 {ref[0]}); "
                  f"grad max {float(dg.abs().max() / ref[1].abs().max()):.3g}"
                  f" l2 {float(dg.norm() / ref[1].norm()):.3g}; params / "
                  f"update {float(dp.norm() / ref[3].norm()):.3g}; weights "
                  f"{float(dw.abs().max()):.3g}, tsdf "
                  f"{float(dt_[obs].abs().max()):.3g}; {ms:.2f} ms a chunk",
                  flush=True)
            if rule == "sgd" and label in ("card f32 cuDNN on", "cpu f32"):
                print(f"         {label}: {breakdown(cfg, g, ref[1])}",
                      flush=True)


def full_width_cost(dev):
    """ms of one train-mode forward + backward of phase 9's net on 8
    frames of 256x256 under each card remedy, f32 and bf16 compute."""
    cfg = cs.train_config()
    net = cs.seeded_init(build_fusion_net(cfg.FUSION_MODEL),
                         torch.Generator().manual_seed(0)).to(dev).train()
    net.set_dropout_generator(torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    n_points = int(cfg.FUSION_MODEL.n_points)
    data = {k: torch.rand((8, 256, 256, c), generator=g, device=dev)
            for k, c in (("tsdf_values", n_points),
                         ("tsdf_weights", n_points), ("tsdf_frame", 1),
                         ("semantic_frame", 1))}

    def step():
        net.zero_grad(set_to_none=True)
        with pipeline_mod.training_convolutions(net.compute_dtype, dev):
            net(data).sum().backward()

    for compute in (torch.float32, torch.bfloat16):
        net.compute_dtype = compute
        for label, where, settings in REMEDIES:
            if where != "card":
                continue
            with remedy(**settings):
                ms = cs.cuda_ms(step, iters=5, warmup=2)
            print(f"full width ({str(compute)[6:]}): {label:32s} "
                  f"{ms:.2f} ms a chunk of 8 (forward + backward)",
                  flush=True)


def forward_errors(dev, frames, n_frames=4):
    """The first chunk's frames through the training step, module by
    module: each convolution's and BatchNorm's output on the card in f32
    with cuDNN on against the CPU's f64 on the same stream (max error over
    the largest value, or over 1e-3 where that is smaller); prints the
    worst, and the BatchNorm channels of the first frame whose batch
    variance (f64) is below the epsilon."""
    calls = {}
    for tag, d, dt in (("f64", "cpu", torch.float64),
                       ("card", dev, torch.float32)):
        pipe, layout, stream, gt_shadow, _ = cs.trainer(
            cs.small_train_config("sgd"), d, 64, seed=3)
        pipe.fusion_net.to(dt)
        pipe.fusion_net.compute_dtype = dt
        seen = calls[tag] = []
        for name, m in pipe.fusion_net.named_modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.BatchNorm2d)):
                m.register_forward_hook(
                    lambda m, i, o, name=name: seen.append(
                        (name, m, i[0].detach().double().cpu(),
                         o.detach().double().cpu())))
        with remedy(repair=False):
            for i in range(n_frames):
                _, stream = pipe.train_sequence_rows(
                    layout, stream, gt_shadow,
                    {k: v[i:i + 1].to(d) for k, v in frames.items()},
                    [False])
    worst, small = (0.0, ""), 0
    per_frame = len(calls["f64"]) // n_frames
    for k, (ref, got) in enumerate(zip(calls["f64"], calls["card"])):
        e = float((got[3] - ref[3]).abs().max()
                  / max(float(ref[3].abs().max()), 1e-3))
        worst = max(worst, (e, f"frame {k // per_frame} {ref[0]}"))
        if k < per_frame and isinstance(ref[1], torch.nn.BatchNorm2d):
            small += int((ref[2].var((0, 2, 3), unbiased=False)
                          < 1e-5).sum())
    print(f"forward, cuDNN on against the CPU's f64, {len(calls['f64'])} "
          f"module calls over {n_frames} frames: worst {worst[0]:.3g} "
          f"({worst[1]}); frame 0 has {small} BatchNorm channels with a "
          "batch variance below 1e-5", flush=True)


def conv_errors(dev, frames):
    """Each convolution of one frame's step with cuDNN: f32 against f64 on
    the same inputs and output gradients."""
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
    with remedy(repair=False):
        pipe.train_sequence_rows(layout, stream, gt_shadow,
                                 {k: v[:1].to(dev) for k, v in
                                  frames.items()}, [False])

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
    dev = torch.device("cuda", 0)
    frames = cs.with_labels(cs.render_frames(8, 32, 32, "cpu"))
    forward_errors(dev, frames)
    streams(dev, frames, [False] * 6 + [True, False])
    full_width_cost(dev)
    conv_errors(dev, frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
