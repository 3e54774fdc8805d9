#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``segfusion_tpu_torch``) on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each of which raises (exit code 1, no result line) on failure:

1. the card's name and power limit (nvidia-smi);
2. build of the CUDA kernels from ``segfusion_tpu_torch/csrc`` (nvcc,
   sm_90a, one process per source, started together) and their ptxas
   report, and of the host marching cubes (g++);
3. each slot kernel against its plain PyTorch version at 448^3, bf16 and
   f32 geo state (a random canonical volume entered into slot form, then
   a few ``integrate_rows`` updates): shadow builds bit-exact, reconcile
   slot bit-exact, reconcile key exact; kernel and plain times from CUDA
   events, GB/s of minimum traffic and the fraction of the bound; then the
   two shadow builds, full and dirty, bit-exact at the ragged shapes 84^3
   and (96, 88, 84) in both dtypes;
3b. the median kernel (K5) against its plain version on a 448^3 uint8
   label volume (30 classes) and a full-byte one, sizes 5 and 3:
   bit-exact; times and voxels/s; bit-exact at the ragged shapes too;
   then K5's and P4's wrappers refusing a wrong dtype, size or bin count;
3c. the launch floor (an empty kernel of ``csrc/probes.cu``, printed as
   ``launch_floor_ms``), then the probe kernels
   (``segfusion_tpu_torch/probes``, ``csrc/probes.cu``, the ports of the
   Pallas probes of ``tools/``) against their plain versions at the tools'
   own sizes, the gathers, the offset copy, the box sum and the lane
   roll, the four-roll sum, the narrow pad and the lane take also at
   ragged, misaligned and clamped inputs, other shifts and indices of any
   int32, the device-memory gather on the shared route's table (timed
   only), the gather-sum at other table sizes and term counts on indices
   of any int32, and the window copy at windows past every face (each label
   names the route the kernel takes): bit-exact, or within the stated
   tolerance (the scatter-add's atomics on random updates); each library
   call of a kernel-shaped result (``embedding_bag``, ``gather``, the
   linear lane bodies' matrix products) with its error against the plain
   version; kernel, plain and library-call times (under 0.1 ms:
   the median of 5 replays of 200 calls in a CUDA graph, with the
   replays' spread), the traffic bound and the probe's rate; then each probe
   module's ``main`` once, as ``python -m
   segfusion_tpu_torch.probes.<name>`` runs it;
4. the headline configuration through ``Pipeline.fuse_sequence_rows``:
   AdapNet++ stage 2 + FusionNet v3 (growth factor 6, semantics), 448^3
   at 1 cm, 256x256 frames, frame_block 4, sem_integrate_every 8, bf16
   geo, nets in bf16, seeded random weights; 2 chunks of 32 frames, then
   the exit reconcile;
4b. the evaluation of that fused 448^3 volume through the port's Database
   (gt: the same synthetic room sampled at 1 cm): ``filter``,
   ``filter_semantics`` (one K5 launch), ``evaluate``,
   ``evaluate_semantics``, ``evaluate_fscore``, ``get_mesh`` and a ply
   ``save``, each timed;
5. the exact recurrence (frame_block 1, every frame's semantics, f32 geo,
   dirty-shadow carry off, so the full shadow build runs);
6. the same small stream (64^3, 32x32, f32 nets, TF32 off) on the card and
   on the CPU (the plain versions), compared;
7. ``fuse_many`` through the port's Database over its Synthetic dataset;
8. the evaluation entry point ``segfusion_tpu_torch.test_fusion`` on the
   configuration of configs/fusion/synthetic_tpu_demo_joint.yaml (16
   frames instead of 60);
9. training at full width (``bench.py`` ``bench_train``): FusionNet v3
   (growth factor 6, the semantic head, gt labels) in bf16 on float32
   master weights, 448^3 at 1 cm with the gt from the synthetic room's
   SDF, 256x256 frames, chunks of 8 through ``train_sequence_rows`` with
   the dirty carry, one rmsprop update a chunk (lr 1e-5, momentum 0.9,
   weight decay 0.01, eps 1e-9, poly_lr, global-norm clipping): a warm-up
   chunk, 3 timed chunks, then one ``_peek_rows``; training frames/s, ms
   a chunk and the peak device memory;
10. the same small training stream (64^3, 32x32, f32, TF32 off, dropout
   0, 2 chunks of 4 with a reset) on the card (cuDNN on) and on the CPU
   (the plain versions): loss, gradients, updated parameters and volume
   compared;
   then ``segfusion_tpu_torch.train_fusion.train_fusion`` on the
   configuration of configs/fusion/synthetic_small.yaml (1 epoch, 8
   frames), its best.ckpt fed back through ``test_fusion``.

Launch counts are reset just before each main-path run (3c's probe
mains, 4, 4b, 5, 8, 9 and the trainer of 10) and read just after; the
kernel checks' launches are not counted.

Then one JSON line of per-kernel results, the card line again, and last
``{"ok": true, "device": {...}}``. Exits non-zero without a result where
torch sees no CUDA device.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from segfusion_tpu_torch import test_fusion as entry
from segfusion_tpu_torch.config import Config, default_config
from segfusion_tpu_torch.core.database import Database
from segfusion_tpu_torch.core.pipeline import Pipeline
from segfusion_tpu_torch.core.volume import Voxelgrid
from segfusion_tpu_torch.data.synthetic import Synthetic, SyntheticScene
from segfusion_tpu_torch.headline import (HEADLINE_SHAPE, build_pipeline,
                                          headline_config, headline_volume,
                                          render_frames)
from segfusion_tpu_torch.models import seeded_init
from segfusion_tpu_torch.models.adapnet import SegmenterAdapter
from segfusion_tpu_torch.models.fusionnet import build_fusion_net
from segfusion_tpu_torch.ops import rowvol
from segfusion_tpu_torch.ops.integrate import pack_semantic_key
from segfusion_tpu_torch.ops.kernels import _build
from segfusion_tpu_torch.ops.kernels import median3d as k5
from segfusion_tpu_torch.ops.kernels import shadow_build as sb
from segfusion_tpu_torch.probes import _lib as probe_lib
from segfusion_tpu_torch import seg_quality_demo as seg_demo
from segfusion_tpu_torch import test_segmentation as seg_test
from segfusion_tpu_torch import train_segmentation as seg_train
from segfusion_tpu_torch.train_fusion import train_fusion
from segfusion_tpu_torch.utils.losses import cross_entropy
from segfusion_tpu_torch.utils.optim import get_optimizer
from segfusion_tpu_torch.utils.schedulers import get_schedule
from segfusion_tpu_torch.probes import (dynamic_gather, pallas_caps,
                                        pallas_caps2, pallas_caps3,
                                        random_access, shadow_debug,
                                        shadow_variants)
from segfusion_tpu_torch.utils.mesh import MCUBES_SOURCE

PALLAS = "segfusion_tpu/ops/pallas/shadow_build.py"
SOURCE = "segfusion_tpu_torch/csrc/shadow_build.cu"
K5_PALLAS = "segfusion_tpu/ops/pallas/median3d.py:104"
K5_SOURCE = "segfusion_tpu_torch/csrc/median3d.cu"
PROBE_SOURCE = "segfusion_tpu_torch/csrc/probes.cu"
PROBES = (shadow_variants, random_access, dynamic_gather, pallas_caps3,
          pallas_caps, pallas_caps2, shadow_debug)
# probe wrapper -> the Pallas kernel (body) of tools/ it replaces
PROBE_REPLACES = {
    "dma_only": "tools/probe_shadow_variants.py:91",
    "gather_smem": "tools/probe_random_access.py:89",
    "take": "tools/probe_random_access.py:123",
    "scatter_add": "tools/probe_random_access.py:157",
    "box_sum": "tools/probe_random_access.py:194",
    "gather_rows_sum": "tools/probe_dynamic_gather.py:25",
    "take_lanes": "tools/probe_dynamic_gather.py:91",
    "window_copy": "tools/probe_pallas_caps3.py:27",
    "flat_copy": "tools/probe_pallas_caps3.py:40",
    "f16_pack": "tools/probe_pallas_caps.py:36",
    "lane_swap": "tools/probe_pallas_caps.py:44",
    "roll64": "tools/probe_pallas_caps.py:51",
    "reshape_slices": "tools/probe_pallas_caps.py:59",
    "qshift": "tools/probe_pallas_caps.py:68",
    "iota_mask": "tools/probe_pallas_caps.py:76",
    "f16_unpack": "tools/probe_pallas_caps.py:84",
    "store16": "tools/probe_pallas_caps2.py:34",
    "rolls_sum": "tools/probe_pallas_caps2.py:42",
    "narrow_pad": "tools/probe_pallas_caps2.py:52",
    "regroup": "tools/probe_pallas_caps2.py:63",
    "offset_copy": "tools/probe_pallas_caps2.py:73",
    "roll1": "tools/probe_shadow_debug.py:17",
}
# H100 SXM: the float32 rate outside the tensor cores (the median's
# operation bound; the memory rate is probe_lib.HBM_BYTES_PER_S)
F32_OPS_PER_S = 67e12


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def reset_counts():
    sb.reset_launch_counts()
    k5.reset_launch_counts()


def read_counts() -> dict:
    return sb.launch_counts() | k5.launch_counts()


def bytes_ms(nbytes: float) -> float:
    return nbytes / probe_lib.HBM_BYTES_PER_S * 1e3


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 3: kernels against their plain versions ----------------------------

def slot_state(L, geo_dtype, dev, seed=0):
    """A reachable slot state: random canonical volume -> rows_from_volume,
    then integrate_rows of 3 random 65536-ray frames (writer invariant
    kept)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (L.X, L.Y, L.Z)
    w = torch.rand(shape, generator=g, device=dev) * 4
    w = torch.where(torch.rand(shape, generator=g, device=dev) < 0.5, w, 0.0)
    num = torch.randn(shape, generator=g, device=dev) * 0.05 * w
    key = torch.randint(0, 2 ** 31 - 1, shape, generator=g, device=dev,
                        dtype=torch.int32)
    geo, krows = rowvol.rows_from_volume(num, w, key, L, geo_dtype=geo_dtype)
    del num, w, key
    n, p, t = 65536, 9, 7
    hi = torch.tensor([L.X, L.Y, L.Z], device=dev, dtype=torch.float32)
    for _ in range(3):
        c = torch.rand((n, 1, 3), generator=g, device=dev) * (hi + 4) - 2
        d = torch.nn.functional.normalize(
            torch.randn((n, 1, 3), generator=g, device=dev), dim=-1)
        offs = torch.arange(-(p // 2), p // 2 + 1, device=dev,
                            dtype=torch.float32)[None, :, None]
        cr = rowvol.corner_rows(c + offs * d, L)
        values = torch.randn((n, t), generator=g, device=dev) * 0.1
        sem_key = pack_semantic_key(
            torch.rand(n, generator=g, device=dev),
            torch.randint(0, 30, (n,), generator=g, device=dev))
        mask = torch.rand(n, generator=g, device=dev) > 0.1
        rowvol.integrate_rows(geo, krows, cr, values, sem_key, mask, t)
    return geo, krows


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def random_shadow_and_mask(L, nj, dev, seed=1):
    """A random previous shadow and a random 0.5 dirty-tile mask (with its
    trailing sentinel), as a dirty build finds them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    prev = torch.randint(-2 ** 31, 2 ** 31 - 1, (L.shadow_rows, 128),
                         generator=g, device=dev, dtype=torch.int32)
    dirty = torch.cat([
        (torch.rand(L.X * nj, generator=g, device=dev) < 0.5).int(),
        torch.zeros(1, dtype=torch.int32, device=dev)])
    return prev, dirty


def check_kernels(dev):
    """Bit-exactness and times at 448^3; returns per-kernel results (bf16
    geo, the headline dtype; the shadow builds also with ``*_f32`` keys)
    for the JSON line."""
    L = rowvol.RowLayout.for_shape(HEADLINE_SHAPE)
    ty, nj = rowvol.shadow_tiling(L)
    results = {}
    for geo_dtype in (torch.bfloat16, torch.float32):
        tag = str(geo_dtype).replace("torch.", "")
        geo, krows = slot_state(L, geo_dtype, dev)
        prev, dirty = random_shadow_and_mask(L, nj, dev)
        dirty_frac = float(dirty[:-1].float().mean())

        full_k = sb.build_shadow(geo, L, ty)
        full_p = sb.build_shadow_plain(geo, L)
        dirty_k = sb.build_shadow_dirty(geo, prev.clone(), dirty, L, ty)
        dirty_p = sb.build_shadow_dirty_plain(geo, prev.clone(), dirty, L,
                                              ty)
        num_k, w_k = sb.reconcile_slot(geo, L)
        num_p, w_p = sb.reconcile_slot_plain(geo, L)
        key_k = sb.reconcile_key(krows, L)
        key_p = sb.reconcile_key_plain(krows, L)
        torch.cuda.synchronize()
        checks = {
            "build_shadow": torch.equal(full_k, full_p),
            "build_shadow_dirty": torch.equal(dirty_k, dirty_p),
            "reconcile_slot": (
                torch.equal(num_k.view(torch.int32), num_p.view(torch.int32))
                and torch.equal(w_k.view(torch.int32),
                                w_p.view(torch.int32))),
            "reconcile_key": torch.equal(key_k, key_p),
        }
        errs = {
            "build_shadow": max_abs(full_k, full_p),
            "build_shadow_dirty": max_abs(dirty_k, dirty_p),
            "reconcile_slot": max(max_abs(num_k, num_p), max_abs(w_k, w_p)),
            "reconcile_key": max_abs(key_k, key_p),
        }
        nonzero = int((full_k != 0).sum())
        del full_p, dirty_p, num_p, w_p, key_p
        scratch = prev.clone()
        times = {
            "build_shadow": (
                cuda_ms(lambda: sb.build_shadow(geo, L, ty), 20),
                cuda_ms(lambda: sb.build_shadow_plain(geo, L), 5)),
            "build_shadow_dirty": (
                cuda_ms(lambda: sb.build_shadow_dirty(geo, scratch, dirty, L,
                                                      ty), 20),
                cuda_ms(lambda: sb.build_shadow_dirty_plain(
                    geo, scratch, dirty, L, ty), 5)),
            "reconcile_slot": (
                cuda_ms(lambda: sb.reconcile_slot(geo, L), 20),
                cuda_ms(lambda: sb.reconcile_slot_plain(geo, L), 5)),
            "reconcile_key": (
                cuda_ms(lambda: sb.reconcile_key(krows, L), 20),
                cuda_ms(lambda: sb.reconcile_key_plain(krows, L), 5)),
        }
        geo_b = geo.numel() * geo.element_size()
        key_b = krows.numel() * 4
        vox = L.X * L.Y * L.Z
        moved = {"build_shadow": geo_b + key_b,
                 "build_shadow_dirty": dirty_frac * (geo_b + key_b),
                 "reconcile_slot": geo_b + 8 * vox,
                 "reconcile_key": key_b + 4 * vox}
        log(f"kernels {tag} geo at 448^3 (dirty fraction {dirty_frac:.3f}, "
            f"{nonzero} non-zero shadow words):")
        for name, ok in checks.items():
            k_ms, p_ms = times[name]
            b_ms = bytes_ms(moved[name])
            log(f"  {name:20s} exact={ok} max_abs_err={errs[name]} "
                f"kernel {k_ms:.4f} ms ({moved[name] / k_ms / 1e6:.1f} GB/s "
                f"of minimum traffic, bound {b_ms:.4f} ms, "
                f"{b_ms / k_ms:.3f} of the bound)  plain {p_ms:.4f} ms")
            if not ok:
                raise RuntimeError(f"{name} ({tag}) disagrees with its "
                                   "plain version")
            if geo_dtype == torch.bfloat16:
                # no single PyTorch call computes a shadow build or a
                # reconcile: library_ms is null
                results[name] = {"max_abs_err": errs[name], "ms": k_ms,
                                 "plain_ms": p_ms, "bound_ms": b_ms,
                                 "bound_by": "bytes", "library_ms": None}
            elif name.startswith("build_shadow"):
                results[name].update(max_abs_err_f32=errs[name], ms_f32=k_ms,
                                     plain_ms_f32=p_ms, bound_ms_f32=b_ms)
        del geo, krows, prev, scratch, full_k, dirty_k, num_k, w_k, key_k
        torch.cuda.empty_cache()
    check_ragged_shadow(dev)
    return results


# the ragged shapes the shadow build must also take: Z % 32 != 0 with
# G > 2 GK (84^3: GK 3, G 8) and a TY that is no multiple of 8 (pick_ty
# gives 84); a small TY of 8 (Y = 88) over X = 96
RAGGED_SHAPES = ((84, 84, 84), (96, 88, 84))


def check_ragged_shadow(dev):
    """The full and the dirty shadow build (a random 0.5 mask into a
    random previous shadow) bit-exact against their plain versions at the
    ragged shapes, bf16 and f32 geo."""
    for shape in RAGGED_SHAPES:
        L = rowvol.RowLayout.for_shape(shape)
        ty, nj = rowvol.shadow_tiling(L)
        for geo_dtype in (torch.bfloat16, torch.float32):
            tag = str(geo_dtype).replace("torch.", "")
            geo, _ = slot_state(L, geo_dtype, dev, seed=2)
            prev, dirty = random_shadow_and_mask(L, nj, dev, seed=3)
            full_k = sb.build_shadow(geo, L, ty)
            full_p = sb.build_shadow_plain(geo, L)
            dirty_k = sb.build_shadow_dirty(geo, prev.clone(), dirty, L, ty)
            dirty_p = sb.build_shadow_dirty_plain(geo, prev.clone(), dirty,
                                                  L, ty)
            torch.cuda.synchronize()
            exact = (torch.equal(full_k, full_p),
                     torch.equal(dirty_k, dirty_p))
            log(f"  shadow builds at {shape} {tag} (TY {ty}, NJ {nj}, G "
                f"{L.G}, GK {L.GK}, dirty fraction "
                f"{float(dirty[:-1].float().mean()):.3f}): build_shadow "
                f"exact={exact[0]} build_shadow_dirty exact={exact[1]}")
            if not all(exact):
                raise RuntimeError(f"shadow build at {shape} ({tag}) "
                                   "disagrees with its plain version")


# -- phase 3b: the median kernel against its plain version --------------------

def label_volume(shape, dev, n_classes=30, block=16, salt=0.1, seed=0):
    """uint8 labels with spatial structure: ``n_classes`` classes over
    block^3 regions, plus ``salt`` of the voxels set to random classes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    coarse = torch.randint(0, n_classes, [-(-d // block) for d in shape],
                           generator=g, device=dev, dtype=torch.uint8)
    vol = coarse.repeat_interleave(block, 0).repeat_interleave(block, 1) \
        .repeat_interleave(block, 2)[:shape[0], :shape[1], :shape[2]]
    noise = torch.randint(0, n_classes, shape, generator=g, device=dev,
                          dtype=torch.uint8)
    salted = torch.rand(shape, generator=g, device=dev) < salt
    return torch.where(salted, noise, vol).contiguous()


# the ragged shapes the median must also take: Z no multiple of 4 or 16,
# Y no multiple of 16, X no multiple of 8
MEDIAN_RAGGED = ((33, 17, 5), (96, 88, 86), (84, 84, 84))


def full_byte_volume(shape, dev, seed=1):
    """uint8 uniform over 0..255: every pass of the radix select runs."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g, device=dev,
                         dtype=torch.uint8)


def check_median(dev):
    """K5 bit-exact to its plain version at 448^3 for sizes 5 and 3, on
    the 30-class label volume and on a full-byte one, and at the ragged
    shapes; returns the size-5 30-class result for the JSON line, with
    the size-3 and full-byte times beside it."""
    vox = HEADLINE_SHAPE[0] * HEADLINE_SHAPE[1] * HEADLINE_SHAPE[2]
    times = {}
    result = None
    for kind, make in (("30 classes, 10% salt", label_volume),
                       ("full-byte uniform", full_byte_volume)):
        vol = make(HEADLINE_SHAPE, dev)
        for size in (5, 3):
            got = k5.median_filter3d(vol, size)
            want = k5.median_filter3d_plain(vol, size)
            torch.cuda.synchronize()
            exact = torch.equal(got, want)
            err = max_abs(got, want)
            changed = float((got != vol).float().mean())
            del got, want
            k_ms = cuda_ms(lambda: k5.median_filter3d(vol, size), 20)
            p_ms = cuda_ms(lambda: k5.median_filter3d_plain(vol, size), 2,
                           warmup=1)
            times[kind, size] = k_ms
            log(f"median_filter3d size {size} at 448^3 uint8 ({kind}; "
                f"{changed:.3f} of voxels changed): exact={exact} "
                f"max_abs_err={err} kernel {k_ms:.4f} ms "
                f"({vox / k_ms / 1e6:.4g} Gvoxel/s)  plain {p_ms:.4f} ms "
                f"({vox / p_ms / 1e6:.4g} Gvoxel/s)")
            if not exact:
                raise RuntimeError(f"median_filter3d size {size} ({kind}) "
                                   "disagrees with its plain version")
            if size == 5 and make is label_volume:
                # bytes: the volume read and written once; operations: the
                # fewest comparisons a median of 125 values takes (124 per
                # voxel), one operation each at the float32 rate. No
                # single PyTorch call computes a 3-D median filter.
                b_ms = bytes_ms(2 * vox)
                o_ms = 124 * vox / F32_OPS_PER_S * 1e3
                result = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                          "bound_ms": max(b_ms, o_ms),
                          "bound_by": ("bytes" if b_ms >= o_ms
                                       else "operations"),
                          "library_ms": None}
        del vol
    result.update(ms_size3=times["30 classes, 10% salt", 3],
                  ms_full_byte=times["full-byte uniform", 5],
                  ms_full_byte_size3=times["full-byte uniform", 3])
    for shape in MEDIAN_RAGGED:
        for make in (label_volume, full_byte_volume):
            vol = make(shape, dev)
            for size in (5, 3):
                exact = torch.equal(k5.median_filter3d(vol, size),
                                    k5.median_filter3d_plain(vol, size))
                if not exact:
                    raise RuntimeError(
                        f"median_filter3d size {size} at {shape} "
                        f"({make.__name__}) disagrees with its plain version")
    log(f"  median_filter3d exact at {MEDIAN_RAGGED}, sizes 5 and 3, 30 "
        "classes and full-byte")
    check_refusals(dev)
    torch.cuda.empty_cache()
    return result


def check_refusals(dev):
    """K5's and P4's wrappers refuse what their kernels do not take on a
    CUDA tensor: a wrong dtype, an unknown size, too many bins."""
    vol = torch.zeros((8, 8, 8), dtype=torch.int32, device=dev)
    idx = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    upd = torch.ones((1, 4), device=dev)
    cases = [
        ("median int32", TypeError, lambda: k5.median_filter3d(vol, 5)),
        ("median size 7", ValueError,
         lambda: k5.median_filter3d(vol.to(torch.uint8), 7)),
        ("scatter_add int64 indices", TypeError,
         lambda: random_access.scatter_add(idx.long(), upd, 8)),
        ("scatter_add oversize", ValueError,
         lambda: random_access.scatter_add(
             idx, upd, random_access.scatter_add_max_bins() + 1)),
    ]
    for what, error, call in cases:
        try:
            call()
        except error:
            continue
        raise RuntimeError(f"{what}: the wrapper did not raise {error}")
    log(f"  refusals on the card: {[what for what, _, _ in cases]} raise")


# -- phase 3c: the probe kernels against their plain versions -----------------

class Case(NamedTuple):
    """One probe kernel on one input: ``kernel`` / ``plain`` / ``library``
    compute the same result; ``nbytes`` is the least traffic (inputs read
    once, outputs written once, counting what this input touches);
    ``name`` is the kernels-line entry the case gives, if any."""
    label: str
    name: Optional[str]
    kernel: Callable
    plain: Callable
    library: Optional[Callable]
    nbytes: float
    elems: Optional[int] = None      # for a ns/elem rate
    tol: float = 0.0                 # 0: bit-exact
    # the library call's result has the kernel's shape: print its error
    # against the plain version beside its time
    check_library: bool = False


# calls under 0.1 ms: REPLAY_ITERS calls in one CUDA graph, replayed
# REPLAYS times; the median replay, with the spread of the replays
REPLAY_ITERS, REPLAYS = 200, 5


def device_ms(fn, dev, eager_ms: float):
    """(ms per call, [min, max] over the replays): ``eager_ms`` and no
    spread for a call of 0.1 ms or more, else the graph replays'."""
    if eager_ms >= 0.1:
        return eager_ms, None
    t = sorted(probe_lib.device_times(fn, dev, REPLAY_ITERS, REPLAYS))
    return t[len(t) // 2], [t[0], t[-1]]


def spread_text(ms, spread) -> str:
    return (f"{ms:.6f}" if spread is None
            else f"{ms:.6f} [{spread[0]:.6f}-{spread[1]:.6f}]")


def launch_floor(dev):
    """Log the empty kernel of csrc/probes.cu, timed as the probes are:
    what any launch costs in a graph replay on this card."""
    ms, spread = device_ms(lambda: probe_lib.noop(dev), dev, 0.0)
    log(f"launch_floor_ms {spread_text(ms, spread)} (an empty kernel; "
        f"{REPLAYS} replays of {REPLAY_ITERS} calls in one CUDA graph)")


def touched(flat_index: torch.Tensor, size: int) -> int:
    """How many of ``size`` entries ``flat_index`` reads."""
    mask = torch.zeros(size, dtype=torch.bool, device=flat_index.device)
    mask[flat_index.reshape(-1)] = True
    return int(mask.sum())


def window_rows(offs: torch.Tensor, A: int, B: int, wa: int, wb: int):
    """The 128-lane rows of an (A, B, 128) source that P11's windows read:
    (row index of every window in order, count of distinct rows)."""
    o = offs.cpu().numpy()
    covered = np.zeros((A, B), bool)
    rows = []
    for k in range(len(o) // 2):
        a = min(max(int(o[2 * k]), 0), A - wa)
        b = min(max(int(o[2 * k + 1]), 0), B - wb)
        covered[a:a + wa, b:b + wb] = True
        rows.append(((a + np.arange(wa))[:, None] * B
                     + b + np.arange(wb)[None, :]).reshape(-1))
    return (torch.as_tensor(np.concatenate(rows), device=offs.device),
            int(covered.sum()))


def gather_cases(dev, g):
    ra, dg = random_access, dynamic_gather

    def randint(hi, *shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    cases = []
    n = 1 << 16
    table = torch.randn((1, 32 ** 3), generator=g, device=dev)
    idx = randint(32 ** 3, 1, n)
    i64 = idx.long()
    # (default arguments bind the inputs: ``idx`` is rebound below)
    cases.append(Case("gather_smem 32^3 table, 65536 indices", "gather_smem",
                      lambda idx=idx: ra.gather_smem(table, idx),
                      lambda idx=idx: ra.gather_plain(table, idx),
                      lambda: torch.take(table, i64),
                      4 * touched(i64, 32 ** 3) + 8 * n, n))
    # ragged and misaligned: a table of 1,001 floats (head and tail by
    # thread loads), views 4 bytes past a 16-byte boundary (the table;
    # the indices, which then go as scalars), 999 indices (a scalar tail)
    for size, m_table, m_idx, count in ((512, 0, 0, n), (1001, 0, 0, n),
                                        (32 ** 3, 1, 0, n),
                                        (1001, 1, 1, 999)):
        t = torch.randn(size + m_table, generator=g, device=dev)[m_table:]
        ix = randint(size, count + m_idx)[m_idx:]
        for fn in (ra.gather_smem, ra.take):
            cases.append(Case(
                f"{fn.__name__} {size} table{' (misaligned view)' * m_table}"
                f", {count} indices{' (misaligned view)' * m_idx}", None,
                lambda fn=fn, t=t, ix=ix: fn(t[None], ix[None]),
                lambda t=t, ix=ix: ra.gather_plain(t[None], ix[None]), None,
                4 * touched(ix.long(), size) + 8 * count, count))
    for size in (512, 32 ** 3, 64 ** 3):
        t = torch.randn((1, size), generator=g, device=dev)
        ix = randint(size, n // 128, 128)
        cases.append(Case(
            f"take {size} table ({ra.take_route(t)})",
            "take" if size == 64 ** 3 else None,
            lambda t=t, ix=ix: ra.take(t, ix),
            lambda t=t, ix=ix: ra.gather_plain(t, ix),
            lambda t=t, ix=ix.long(): torch.take(t, ix),
            4 * touched(ix.long(), size) + 8 * n, n))
    # the device-memory route at 64^3 on 999 indices and on an index view
    # 4 bytes past a 16-byte boundary; then, for measurement only, its
    # kernel on the 32^3 table that take gathers from shared memory
    # (beside the shared route's case above)
    t = torch.randn((1, 64 ** 3), generator=g, device=dev)
    for count, m_idx in ((999, 0), (n, 1)):
        ix = randint(64 ** 3, count + m_idx)[m_idx:][None]
        cases.append(Case(
            f"take {64 ** 3} table ({ra.take_route(t)}), {count} indices"
            f"{' (misaligned view)' * m_idx}", None,
            lambda t=t, ix=ix: ra.take(t, ix),
            lambda t=t, ix=ix: ra.gather_plain(t, ix),
            lambda t=t, ix=ix.long(): torch.take(t, ix),
            4 * touched(ix.long(), 64 ** 3) + 8 * count, count))
    t = torch.randn((1, 32 ** 3), generator=g, device=dev)
    ix = randint(32 ** 3, n // 128, 128)
    cases.append(Case(
        f"take {32 ** 3} table through the device-memory kernel "
        "(measurement only)", None,
        lambda t=t, ix=ix: ra._take_device_memory(t, ix),
        lambda t=t, ix=ix: ra.gather_plain(t, ix),
        lambda t=t, ix=ix.long(): torch.take(t, ix),
        4 * touched(ix.long(), 32 ** 3) + 8 * n, n))
    bins = 32 ** 3
    idx = randint(bins, 1, n)
    acc = torch.zeros(bins, device=dev)
    flat = idx.reshape(-1).long()
    for kind, upd, tol in (
            ("all-one", torch.ones((1, n), device=dev), 0.0),
            # atomics add in no fixed order: |d| <= 1e-5 on bins of ~2
            # standard normal updates
            ("normal", torch.randn((1, n), generator=g, device=dev), 1e-5)):
        cases.append(Case(
            f"scatter_add 32^3 bins, {n} {kind} updates",
            "scatter_add" if tol == 0 else None,
            lambda upd=upd: ra.scatter_add(idx, upd, bins),
            lambda upd=upd: ra.scatter_add_plain(idx, upd, bins),
            lambda upd=upd.reshape(-1): acc.index_add_(0, flat, upd),
            8 * n + 4 * bins, n, tol))
    vol = torch.rand((256, 256, 256), generator=g, device=dev)
    odd = torch.rand((96, 80, 70), generator=g, device=dev)
    mis = torch.rand(96 * 80 * 72 + 1, generator=g, device=dev)[1:] \
        .reshape(96, 80, 72)
    # the probe's box; starts at an odd z and 65 short of the far z face
    # (not 16-byte aligned: thread loads in the TMA kernel); SZ = 70, not a
    # multiple of 4, and a volume seen 4 bytes past a 16-byte boundary
    # (thread loads);
    # boxes of 48 and 13; a start past the far x and z faces and the near
    # y face (clamped)
    for v, start, box in ((vol, (8, 16, 32), 64), (vol, (8, 16, 33), 64),
                          (vol, (8, 16, 191), 64), (odd, (5, 7, 3), 64),
                          (mis, (5, 7, 3), 64), (vol, (8, 16, 32), 48),
                          (vol, (8, 16, 31), 13), (vol, (300, -7, 250), 64)):
        pos = torch.tensor(start, dtype=torch.int32, device=dev)
        x0, y0, z0 = (min(max(p, 0), n - box) for p, n in zip(start,
                                                               v.shape))
        probe = v is vol and start == (8, 16, 32) and box == 64
        cases.append(Case(
            f"box_sum {box}^3 box of a {'x'.join(map(str, v.shape))} volume"
            f"{' (misaligned view)' * (v is mis)} at {start} "
            f"[{ra.box_route(v, start, box)}]", "box_sum" if probe else None,
            lambda v=v, pos=pos, box=box: ra.box_sum(v, pos, box),
            lambda v=v, pos=pos, box=box: ra.box_sum_plain(v, pos, box),
            lambda v=v, x0=x0, y0=y0, z0=z0, box=box:
                v[x0:x0 + box, y0:y0 + box, z0:z0 + box].sum(0),
            4 * box ** 3 + 4 * box ** 2))
    lanes = torch.arange(128, device=dev)

    def rows_sum_bytes(ix, S, inner):
        terms = torch.arange(inner, device=dev)[:, None, None]
        reads = touched((ix.long()[None] + terms) % S * 128 + lanes,
                        S * 128)
        return 4 * reads + 8 * ix.numel()

    for S, dtype in ((32768, torch.float32), (8192, torch.int32)):
        t = (torch.randn((S, 128), generator=g, device=dev)
             if dtype == torch.float32 else randint(2 ** 31 - 1, S, 128))
        ix = randint(S, S, 128)
        library = None
        if dtype == torch.float32:
            # embedding_bag sums the same eight entries a bag, the table
            # seen as S * 128 rows of one float; its (S * 128, 8) index is
            # built outside the timed call
            terms = torch.arange(8, device=dev)
            bags = (((ix.long()[..., None] + terms) % S) * 128
                    + lanes[:, None]).reshape(-1, 8).int()
            library = (lambda t=t, bags=bags, S=S:
                       torch.nn.functional.embedding_bag(
                           bags, t.view(-1, 1), mode="sum").view(S, 128))
        cases.append(Case(
            f"gather_rows_sum S={S} {'f32' if S == 32768 else 'u32'}, 8 "
            f"terms [{dg.rows_sum_route(8)}]",
            "gather_rows_sum" if S == 32768 else None,
            lambda t=t, ix=ix: dg.gather_rows_sum(t, ix),
            lambda t=t, ix=ix: dg.gather_rows_sum_plain(t, ix), library,
            rows_sum_bytes(ix, S, 8), S * 128 * 8,
            check_library=library is not None))
    # 777 rows of indices from -3 S to 3 S with the int32 extremes among
    # them, at 1, 8 and 9 terms (9 > S at S = 8); an index view 4 bytes past
    # a 16-byte boundary; a u32 table
    for S, inner, mis, dtype in [(S, inner, 0, torch.float32)
                                 for S in (8, 513, 32768)
                                 for inner in (1, 8, 9)] + [
            (32768, 8, 1, torch.float32), (513, 9, 1, torch.int32)]:
        t = (torch.randn((S, 128), generator=g, device=dev)
             if dtype == torch.float32 else randint(2 ** 31 - 1, S, 128))
        raw = torch.randint(-3 * S, 3 * S, (777 * 128 + mis,), generator=g,
                            device=dev, dtype=torch.int32)
        raw[::97] = -2 ** 31
        raw[1::89] = 2 ** 31 - 1
        ix = raw[mis:].view(777, 128)
        cases.append(Case(
            f"gather_rows_sum S={S} "
            f"{'f32' if dtype == torch.float32 else 'u32'}, {inner} terms, "
            "777 rows of any int32"
            f"{' (misaligned view)' * mis} [{dg.rows_sum_route(inner)}]",
            None, lambda t=t, ix=ix, inner=inner: dg.gather_rows_sum(
                t, ix, inner),
            lambda t=t, ix=ix, inner=inner: dg.gather_rows_sum_plain(
                t, ix, inner), None,
            rows_sum_bytes(ix, S, inner), ix.numel() * inner))
    # P7: the probe's (128, 128) on in-range indices, then indices of any
    # int32 (the extremes among them) at 3, 19 and 777 rows, a table and an
    # index each seen 4 bytes past a 16-byte boundary, and 100 lanes (the
    # last three the lane loop); torch.gather's index, in range, is built
    # outside the timed call
    def any_int32(rows, C, mis=0):
        raw = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows * C + mis,),
                            generator=g, device=dev, dtype=torch.int32)
        raw[::97] = -2 ** 31
        raw[1::89] = 2 ** 31 - 1
        return raw[mis:].view(rows, C)

    takes = [("(128, 128)", torch.rand((128, 128), generator=g, device=dev),
              randint(128, 128, 128))]
    takes += [(f"({r}, 128), any int32 index",
               torch.rand((r, 128), generator=g, device=dev),
               any_int32(r, 128)) for r in (128, 3, 19, 777)]
    takes += [("(19, 128) misaligned table view, any int32 index",
               torch.rand(19 * 128 + 1, generator=g, device=dev)[1:]
               .view(19, 128), any_int32(19, 128)),
              ("(19, 128), misaligned index view of any int32",
               torch.rand((19, 128), generator=g, device=dev),
               any_int32(19, 128, mis=1)),
              ("(8, 100), any int32 index",
               torch.rand((8, 100), generator=g, device=dev),
               any_int32(8, 100))]
    for i, (label, t, ix) in enumerate(takes):
        R, C = t.shape
        src = ix.long() % C
        rows = torch.arange(R, device=dev)[:, None] * C
        cases.append(Case(
            f"take_lanes {label} [{dg.take_lanes_route(t, ix)}]",
            "take_lanes" if i == 0 else None,
            lambda t=t, ix=ix: dg.take_lanes(t, ix),
            lambda t=t, ix=ix: dg.take_lanes_plain(t, ix),
            lambda t=t, src=src: torch.gather(t, 1, src),
            4 * touched(rows + src, R * C) + 8 * R * C, R * C,
            check_library=True))
    return cases


def copy_cases(dev, g):
    sv, c3 = shadow_variants, pallas_caps3
    L = rowvol.RowLayout.for_shape(HEADLINE_SHAPE)
    geo = torch.rand((L.geo_rows, 128), generator=g, device=dev)
    strided = geo.view(torch.int32)[:L.X * (L.Y + 2) * L.G] \
        .view(L.X, L.Y + 2, L.G, 128)[:, 1:L.Y + 1, 0:2 * L.GK:2]
    out = torch.empty((L.X, L.Y, L.GK, 128), dtype=torch.int32, device=dev)
    cases = [Case("dma_only 448^3 (f32 geo)", "dma_only",
                  lambda: sv.dma_only(geo, L),
                  lambda: sv.dma_only_plain(geo, L),
                  lambda: out.copy_(strided), sv.dma_only_bytes(L))]
    inputs = c3.inputs(dev)
    x3, x2, x4 = (v[1][0] for v in list(inputs.values())[:3])

    def offsets(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    # the probe's four cases, then windows past every face (clamped): a
    # (57, 7) window (57 a-rows, 399 rows, split 8 ways unevenly), 405
    # contiguous rows, and the large windows
    copies = [(label, fn, args) for label, (fn, args, _, _) in inputs.items()]
    copies += [
        ("strided (57, 7, 128) windows past every face", c3.window_copy,
         (x3, offsets(-5, -3, 4000, 30, 3543, 21, 100, 2 ** 31 - 1), 57, 7)),
        ("contiguous 405 rows past both ends", c3.flat_copy,
         (x2, offsets(-7, 0, 10 ** 6, 0, 100395, 0, 5, 0), 405)),
        ("strided (4, 1624, 128) windows past every face", c3.window_copy,
         (x4, offsets(-1, -5, 9, 20000, 4, 10976, 2, 7), 4, 1624)),
        ("contiguous 6496 rows past both ends", c3.flat_copy,
         (x2, offsets(-3, 0, 10 ** 7, 0, 94304, 0, 11, 0), 6496))]
    for label, fn, args in copies:
        src, offs, wa = args[:3]
        wb = args[3] if fn is c3.window_copy else 1
        src3 = src if src.dim() == 3 else src[:, None]
        rows, distinct = window_rows(offs, *src3.shape[:2], wa, wb)
        out_rows = wb if fn is c3.window_copy else wa
        plain = (c3.window_copy_plain if fn is c3.window_copy
                 else c3.flat_copy_plain)
        # library: one index_select copying the same windows
        cases.append(Case(
            f"{fn.__name__}: {label} [{c3.copy_route(wa, wb)}]",
            fn.__name__ if wa * wb == 406 else None,
            lambda fn=fn, args=args: fn(*args),
            lambda plain=plain, args=args: plain(*args),
            lambda s2=src3.reshape(-1, 128), rows=rows:
                torch.index_select(s2, 0, rows),
            512 * (distinct + out_rows)))
    return cases


def lane_cases(dev, g):
    """The lane bodies (P8, P9, P10, P12) on standard normal inputs of the
    tools' shapes; bytes: the lanes and rows each body reads, once, and
    its output. The library calls of the linear bodies are one matrix
    product with a 0/1/2/3 matrix built outside the timed call."""
    c1, c2, sd = pallas_caps, pallas_caps2, shadow_debug
    x8 = torch.randn((8, 128), generator=g, device=dev)
    x32 = torch.randn((32, 512), generator=g, device=dev)
    x16 = torch.randn((16, 128), generator=g, device=dev)
    x3 = torch.randn((8, 28, 16), generator=g, device=dev)
    big = torch.randn((64, 128), generator=g, device=dev)
    first4 = torch.arange(4, device=dev)
    n8, n32, n16 = 8 * 128 * 4, 32 * 512 * 4, 16 * 128 * 4   # bytes
    # (source lane, output lane) matrices: out = x @ W
    eye = torch.eye(128, device=dev)
    w_store16 = eye.clone()
    w_store16[:32, :32] = 0.0
    w_store16[range(16), range(16)] = 2.0
    w_store16[range(16), range(16, 32)] = 3.0
    w_rolls = sum(torch.roll(eye, s, 1) for s in (1, 15, 16, 48))
    w_narrow = eye + torch.roll(eye, 16, 1)
    w_narrow[:, 16:] = 0.0
    eye16 = torch.eye(16, device=dev)
    w_regroup = torch.cat([eye16, 2.0 * eye16])
    # reshape_slices on (8, 2048) rows of 4 x 512 lanes: every output lane
    # j takes lanes c, 640 + c and 1920 + c of its row, c = j mod 128
    lane = torch.arange(2048, device=dev)
    w_slices = torch.zeros((2048, 2048), device=dev)
    for first in (0, 512 + 128, 3 * 512 + 384):
        w_slices[first + lane % 128, lane] = 1.0
    table = [
        (c1.f16_pack, x8, None, 2 * n8),
        (c1.lane_swap, x8,
         lambda: torch.cat([x8[:, 64:], x8[:, :64]], 1), 2 * n8),
        (c1.roll64, x8, lambda: torch.roll(x8, 64, 1), 2 * n8),
        (c1.reshape_slices, x32,
         lambda: torch.mm(x32.view(8, 2048), w_slices).view(32, 512),
         n32 * 3 // 16 + n32),
        (c1.qshift, x32, lambda: torch.nn.functional.pad(x32, (0, 0, 4, -4)),
         2 * n32 - 4 * 512 * 4),
        (c1.iota_mask, x32, lambda: x32.index_fill(0, first4, 0.0),
         2 * n32 - 4 * 512 * 4),
        # the high 16 bits of each word are its odd half on little-endian
        (c1.f16_unpack, x8, lambda: x8.view(torch.float16)[:, 1::2].float(),
         2 * n8),
        (c2.store16, x16, lambda: torch.mm(x16, w_store16),
         n16 * 112 // 128 + n16),
        (c2.rolls_sum, x16, lambda: torch.mm(x16, w_rolls), 2 * n16),
        (c2.narrow_pad, x16, lambda: torch.mm(x16, w_narrow),
         n16 * 32 // 128 + n16),
        (c2.regroup, x3, lambda: torch.matmul(x3.view(8, 14, 32), w_regroup),
         8 * 28 * 16 * 4 * 3 // 2),
        (c2.offset_copy, big, lambda: torch.add(big[:32], 1.0),
         2 * 32 * 128 * 4),
        (sd.roll1, x8, lambda: torch.roll(x8, 1, 1), 2 * n8),
    ]
    plain = c1.PLAIN | c2.PLAIN | {sd.roll1: sd.roll1_plain}
    rolls = (c1.roll64, sd.roll1, c2.rolls_sum, c2.narrow_pad)
    cases = [Case(f"{fn.__name__} {tuple(x.shape)}"
                  + (f" [{c1.roll_route(x)}]" if fn in rolls else ""),
                  fn.__name__, lambda fn=fn, x=x: fn(x),
                  lambda fn=fn, x=x: plain[fn](x), lib, nbytes,
                  check_library=lib is not None)
             for fn, x, lib, nbytes in table]
    # rolls_sum and narrow_pad at 3 and 19 rows, and on the lane loop's
    # inputs: a view 4 bytes past a 16-byte boundary and 100 lanes
    # (narrow_pad reads lanes 0-15 and their 16 sources)
    mis16 = torch.randn(16 * 128 + 1, generator=g, device=dev)[1:] \
        .reshape(16, 128)
    for x in (torch.randn((3, 128), generator=g, device=dev),
              torch.randn((19, 128), generator=g, device=dev), mis16,
              torch.randn((8, 100), generator=g, device=dev)):
        rows, C = x.shape
        for fn, nbytes in ((c2.rolls_sum, 2 * x.numel() * 4),
                           (c2.narrow_pad, rows * 32 * 4 + x.numel() * 4)):
            cases.append(Case(
                f"{fn.__name__} {tuple(x.shape)}"
                f"{' (misaligned view)' * (x is mis16)} [{c1.roll_route(x)}]",
                None, lambda fn=fn, x=x: fn(x),
                lambda fn=fn, x=x: c2.PLAIN[fn](x), None, nbytes))
    # the lane roll at shifts 3 and -5, and on the lane loop's inputs: 100
    # lanes and a view 4 bytes past a 16-byte boundary
    mis8 = torch.randn(8 * 128 + 1, generator=g, device=dev)[1:] \
        .reshape(8, 128)
    x100 = torch.randn((8, 100), generator=g, device=dev)
    for x, shift in ((x8, 3), (x8, -5), (x100, 1), (x100, -5), (mis8, 1),
                     (mis8, 3)):
        cases.append(Case(
            f"roll_lanes {tuple(x.shape)}{' (misaligned view)' * (x is mis8)}"
            f" shift {shift} [{c1.roll_route(x)}]", None,
            lambda x=x, shift=shift: c1.roll_lanes(x, shift),
            lambda x=x, shift=shift: c1.roll_lanes_plain(x, shift),
            lambda x=x, shift=shift: torch.roll(x, shift, 1),
            2 * x.numel() * 4))
    # P10 on a misaligned view of x (scalar) and on 3-row blocks of
    # (64, 126) (a 16-byte head and tail in every block)
    mis = torch.randn(64 * 128 + 1, generator=g, device=dev)[1:] \
        .reshape(64, 128)
    odd = torch.randn((64, 126), generator=g, device=dev)
    for label, x, args in (("(64, 128) misaligned view", mis, ()),
                           ("(64, 126), 4 blocks of 3 rows", odd, (4, 3))):
        cases.append(Case(f"offset_copy {label}", None,
                          lambda x=x, args=args: c2.offset_copy(x, *args),
                          lambda x=x, args=args: c2.offset_copy_plain(
                              x, *args), None,
                          2 * c2.offset_copy_plain(x, *args).numel() * 4))
    return cases


def probe_counts() -> dict:
    counts = {}
    for m in PROBES:
        counts |= m.launch_counts()
    return counts


def check_probes(dev):
    """The launch floor, then every probe kernel against its plain version
    at the tools' sizes (and P2/P3/P5/P6/P7/P10/P11/P12 and P9's rolls_sum
    and narrow_pad at ragged, misaligned and clamped inputs);
    returns the kernels-line results, then runs each probe's main once
    with the launch counts reset and returns those counts too.

    Times come from CUDA events around 20 back-to-back calls; where such
    a call takes under 0.1 ms, the host's launch overhead is most of it,
    and the kernel's (or library call's) time is taken instead from
    REPLAY_ITERS calls captured in a CUDA graph and replayed REPLAYS
    times (``probes._lib.device_times``): the median replay, with the
    spread of the replays. ``eager_ms`` is the back-to-back time, host
    overhead included; plain versions are timed that way only."""
    g = torch.Generator(device=dev).manual_seed(7)
    results = {}
    launch_floor(dev)
    log("probe kernels (csrc/probes.cu) against their plain versions "
        f"(times under 0.1 ms: median of {REPLAYS} replays of "
        f"{REPLAY_ITERS} calls [min-max]):")
    for case in copy_cases(dev, g) + gather_cases(dev, g) + lane_cases(dev,
                                                                       g):
        got, want = case.kernel(), case.plain()
        torch.cuda.synchronize()
        err = max_abs(got, want)
        ok = (got.dtype == want.dtype and torch.equal(got, want)
              if case.tol == 0 else err <= case.tol)
        del got, want
        e_ms = cuda_ms(case.kernel, 20)
        k_ms, k_spread = device_ms(case.kernel, dev, e_ms)
        p_ms = cuda_ms(case.plain, 3, warmup=1)
        l_ms, l_spread = (device_ms(case.library, dev,
                                    cuda_ms(case.library, 20))
                          if case.library else (None, None))
        b_ms = bytes_ms(case.nbytes)
        rate = (f"{k_ms * 1e6 / case.elems:.4f} ns/elem" if case.elems
                else f"{case.nbytes / k_ms / 1e6:.1f} GB/s")
        lib = "n/a" if l_ms is None else spread_text(l_ms, l_spread)
        lib_err = None
        if case.check_library:
            lib_err = max_abs(case.library(), case.plain())
            lib += f" (library_max_abs_err {lib_err})"
        log(f"  {case.label}: {'exact' if case.tol == 0 else 'tol'}="
            f"{ok} max_abs_err={err} kernel_ms {spread_text(k_ms, k_spread)}"
            f" (eager_ms {e_ms:.4f}) plain_ms {p_ms:.4f} library_ms {lib} "
            f"bound_ms {b_ms:.6f} ({rate})")
        if not ok:
            raise RuntimeError(f"{case.label}: the kernel disagrees with its "
                               "plain version")
        if case.name:
            results[case.name] = {"max_abs_err": err, "ms": k_ms,
                                  "plain_ms": p_ms, "bound_ms": b_ms,
                                  "bound_by": "bytes", "library_ms": l_ms,
                                  "ms_spread": k_spread,
                                  "library_ms_spread": l_spread}
            if lib_err is not None:
                results[case.name]["library_max_abs_err"] = lib_err
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    for m in PROBES:
        m.reset_launch_counts()
    t0 = time.perf_counter()
    for m in PROBES:
        log(f"-- python -m {m.__name__}")
        m.main(dev)
    torch.cuda.synchronize()
    counts = probe_counts()
    log(f"probe mains: {time.perf_counter() - t0:.2f} s; launches {counts}")
    require(counts, list(PROBE_REPLACES), "probe mains")
    if set(results) != set(PROBE_REPLACES):
        raise RuntimeError("probe results missing for "
                           f"{set(PROBE_REPLACES) - set(results)}")
    torch.cuda.empty_cache()
    return results, counts


# -- phases 4-8: the main path ------------------------------------------------

def run_stream(pipe, volume, chunks, warm=None):
    """Enter, fuse ``chunks`` (frame dicts) through fuse_sequence_rows,
    exit. A ``warm`` chunk first runs on a throw-away stream. Returns
    (volume, launch counts, fuse seconds, total seconds)."""
    layout = rowvol.RowLayout.for_shape(tuple(volume.num.shape))
    if warm is not None:
        s = pipe._new_stream(layout, pipe._enter_rows(layout, volume))
        pipe.fuse_sequence_rows(layout, s, warm)
        del s
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    s = pipe._new_stream(layout, pipe._enter_rows(layout, volume))
    for frames in chunks:
        s = pipe.fuse_sequence_rows(layout, s, frames)
    torch.cuda.synchronize()
    t_fuse = time.perf_counter() - t0
    out = pipe._exit_rows(layout, s.rv)
    del s
    torch.cuda.synchronize()
    counts = read_counts()
    return out, counts, t_fuse, time.perf_counter() - t0


def check_volume(out, what: str):
    finite = bool(torch.isfinite(out.num).all()
                  and torch.isfinite(out.weights).all())
    observed = int((out.weights > 0).sum())
    ids = torch.unique(out.semantics[out.semkey > 0]).tolist()
    log(f"  {what}: finite={finite} observed_voxels={observed} "
        f"semantic_ids={len(ids)}")
    if not finite or observed == 0 or len(ids) < 2:
        raise RuntimeError(f"{what}: implausible fused volume")


def require(counts, names, what):
    zero = [n for n in names if counts[n] == 0]
    if zero:
        raise RuntimeError(f"{what}: kernels not launched: {zero}")


def headline(dev):
    cfg = headline_config()
    pipe = build_pipeline(cfg, dev)
    frames = render_frames(32, 256, 256, dev)
    volume = headline_volume(dev, HEADLINE_SHAPE)
    # warm-up: a whole chunk, so allocator growth and cuDNN's first
    # calls stay out of the timed run
    out, counts, t_fuse, t_all = run_stream(pipe, volume, [frames, frames],
                                            warm=frames)
    log(f"headline (448^3, 256x256, frame_block 4, sem every 8, bf16 geo, "
        f"bf16 nets): 64 frames in {t_fuse:.3f} s = {64 / t_fuse:.2f} "
        f"frames/s ({64 / t_all:.2f} frames/s with the exit reconcile); "
        f"launches {counts}")
    check_volume(out, "headline volume")
    require(counts, ["build_shadow_dirty", "reconcile_slot",
                     "reconcile_key"], "headline")
    counts_eval = evaluate_headline(dev, cfg, out)
    del out
    # the exact recurrence, sharing the nets
    cfg2 = copy.deepcopy(cfg)
    cfg2.SETTINGS.update(frame_block=1, sem_integrate_every=1,
                         geo_dtype="float32", dirty_shadow="off")
    pipe2 = Pipeline(cfg2, segmenter=pipe.segmenter,
                     fusion_net=pipe.fusion_net, device=dev)
    short = {k: v[:16] for k, v in frames.items()}
    warm = {k: v[:4] for k, v in frames.items()}
    out, counts2, t_fuse, t_all = run_stream(pipe2, volume, [short], warm)
    log(f"exact recurrence (frame_block 1, sem every 1, f32 geo, full "
        f"shadow builds): 16 frames in {t_fuse:.3f} s = "
        f"{16 / t_fuse:.2f} frames/s ({16 / t_all:.2f} with the exit "
        f"reconcile); launches "
        f"{counts2}")
    check_volume(out, "exact-recurrence volume")
    require(counts2, ["build_shadow", "reconcile_slot", "reconcile_key"],
            "exact recurrence")
    return {k: counts[k] + counts_eval[k] + counts2[k] for k in counts}


class HeadlineRoom:
    """The headline's scene as a dataset for the Database: the gt TSDF and
    labels of SyntheticScene(seed=0, half=2.2) on the 448^3 grid at 1 cm
    with origin -2.24 (pad 4), sampled in x-slabs on a thread pool (the
    whole grid's float64 coordinates would take several GB)."""

    scenes = ["headline_room"]

    def get_grid(self, scene_id, truncation, semantic_grid=False):
        scene = SyntheticScene(seed=0, half=2.2)
        res, pad, n = 0.01, 4, HEADLINE_SHAPE[0]
        lo = -scene.half - pad * res
        ax = lo + np.arange(n) * res
        sdf = np.empty((n, n, n), np.float32)
        labels = np.empty((n, n, n), np.uint8)

        def slab(x0, sx=16):
            x, y, z = np.meshgrid(ax[x0:x0 + sx], ax, ax, indexing="ij")
            d, lab = scene.sdf_and_labels(np.stack([x, y, z], axis=-1))
            sdf[x0:x0 + sx] = np.clip(d, -truncation, truncation)
            labels[x0:x0 + sx] = lab

        with ThreadPoolExecutor(8) as pool:
            list(pool.map(slab, range(0, n, 16)))
        bbox = np.array([[lo, lo + n * res]] * 3)
        return (Voxelgrid(res).from_array(sdf, bbox),
                Voxelgrid(res).from_array(labels, bbox)
                if semantic_grid else None)


def evaluate_headline(dev, cfg, volume):
    """The evaluation path on the fused 448^3 headline volume: outlier
    filter, label median (K5), the three metric families, the semantic
    mesh and a ply save. Returns the launch counts of this run."""
    t0 = time.perf_counter()
    data_cfg = copy.deepcopy(cfg.DATA)
    data_cfg.update(semantic_grid=True, n_classes=30)
    db = Database(HeadlineRoom(), data_cfg, device=dev)
    s = db.scenes[0]
    if db.volumes[s].num.shape != volume.num.shape:
        raise RuntimeError("the gt grid does not match the headline volume")
    db.update(s, volume)
    log(f"evaluation at 448^3: gt built in {time.perf_counter() - t0:.3f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as out_dir:
        metrics, mesh, counts = run_stages(db, s, out_dir)
    n_verts, n_faces = len(mesh[0]), len(mesh[1])
    log(f"  mesh: {n_verts} vertices, {n_faces} faces; launches {counts}")
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    if bad or len(metrics) != 9:
        raise RuntimeError(f"evaluation: missing or non-finite metrics "
                           f"{bad or metrics}")
    if n_faces == 0 or not np.isfinite(mesh[0]).all():
        raise RuntimeError("evaluation: empty or non-finite mesh")
    if counts["median_filter3d"] != 1:
        raise RuntimeError(f"evaluation: median kernel launched "
                           f"{counts['median_filter3d']} times, not once")
    return counts


def run_stages(db, s, out_dir):
    """Each evaluation stage once, timed; (metrics, mesh, launch counts)."""
    torch.cuda.synchronize()
    reset_counts()
    stages = [
        ("filter(2.0)", lambda: db.filter(2.0)),
        ("filter_semantics(5)", lambda: db.filter_semantics(5)),
        ("evaluate", lambda: db.evaluate("test")[0]),
        ("evaluate_semantics", lambda: db.evaluate_semantics("test")[0]),
        ("evaluate_fscore", lambda: db.evaluate_fscore(0.05)[0]),
        ("get_mesh(semantics=True)", lambda: db.get_mesh(s, True)),
        # ply: the card's machine may have no h5py for the hdf5 volumes
        ("save(ply)", lambda: db.save(out_dir, "ply", s)),
    ]
    metrics, mesh = {}, None
    for name, fn in stages:
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if isinstance(r, dict):
            metrics.update(r)
        elif name.startswith("get_mesh"):
            mesh = r
        log(f"  {name:26s} {dt:.3f} s" + (f"  {r}" if isinstance(r, dict)
                                          else ""))
    return metrics, mesh, read_counts()


def small_reference(dev):
    """The port on the card against the port on the CPU (plain versions):
    64^3, 32x32, 6 frames, exact recurrence, f32 nets with TF32 off.
    Tolerances as in tests/test_torch_pipeline.py (f32)."""
    cfg = headline_config(32, 32)
    cfg.FUSION_MODEL.update(growth_factor=2, compute_dtype="float32")
    cfg.SEMANTIC_2D_MODEL.compute_dtype = "float32"
    cfg.SETTINGS.update(frame_block=1, sem_integrate_every=1,
                        geo_dtype="float32")
    cpu_pipe = build_pipeline(cfg, "cpu", seed=3)
    seg = SegmenterAdapter(copy.deepcopy(cpu_pipe.segmenter.model).to(dev))
    gpu_pipe = Pipeline(cfg, segmenter=seg, device=dev,
                        fusion_net=copy.deepcopy(cpu_pipe.fusion_net))
    frames = render_frames(6, 32, 32, "cpu")
    outs = []
    for pipe, d in ((cpu_pipe, "cpu"), (gpu_pipe, dev)):
        vol = headline_volume(d, (64, 64, 64))
        outs.append(pipe.fuse_sequence(
            vol, {k: v.to(d) for k, v in frames.items()}))
    ref, got = outs
    rw, gw = ref.weights, got.weights.cpu()
    obs = rw > 0.05
    w_err = float((gw - rw).abs().max())
    t_err = float((got.tsdf.cpu()[obs] - ref.tsdf[obs]).abs().max())
    lab = ref.semkey > 0
    id_share = float((got.semantics.cpu()[lab] == ref.semantics[lab])
                     .float().mean())
    log(f"small reference (card vs CPU plain path, 64^3, 6 frames): "
        f"max |dw| {w_err:.3g}, max |dtsdf| {t_err:.3g} on "
        f"{int(obs.sum())} voxels, semantic id agreement {id_share:.4f}")
    if not (torch.allclose(gw, rw, atol=1e-3, rtol=1e-3) and t_err <= 1e-3
            and int(obs.sum()) > 1000 and id_share >= 0.99):
        raise RuntimeError("card and CPU paths disagree on the small input")


def fuse_many_run(dev):
    """Database + Synthetic (default 84^3 grid, padded to 84x88x84)
    through fuse_many with the headline settings at 256x256."""
    cfg = headline_config()
    cfg.DATA.update(n_frames=6, voxel_resolution=0.05, noise_sigma=0.01)
    data = Synthetic(cfg.DATA, device=dev)
    db = Database(data, cfg.DATA, device=dev)
    pipe = build_pipeline(cfg, dev, seed=5)
    batches = []
    for i in range(len(data)):
        item = data[i]
        batches.append({k: (np.asarray(v)[None] if isinstance(v, np.ndarray)
                            else v) for k, v in item.items()}
                       | {"frame_id": [item["frame_id"]]})
    t0 = time.perf_counter()
    pipe.fuse_many(batches, db, chunk=4)
    torch.cuda.synchronize()
    s = data.scenes[0]
    log(f"fuse_many: {len(batches)} frames, volume "
        f"{tuple(db.volumes[s].num.shape)}, {time.perf_counter() - t0:.3f} s")
    if not db.state[s]:
        raise RuntimeError("fuse_many did not update the database")
    check_volume(db.volumes[s], "fuse_many volume")


def entry_point(dev):
    """``segfusion_tpu_torch.test_fusion`` with the configuration of
    configs/fusion/synthetic_tpu_demo_joint.yaml, cut to 16 frames; hdf5
    saving replaced by ply (the card's machine may have no h5py)."""
    cfg = default_config()
    cfg.SETTINGS.update(save_mode="ply", num_workers=0)
    cfg.FUSION_MODEL.update(name="v3", n_points=9, n_tail_points=7,
                            growth_factor=6, use_semantics=True,
                            compute_dtype="bfloat16")
    cfg.SEMANTIC_2D_MODEL.update(stage=1, n_classes=8)
    cfg.TESTING.update(outlier_filter_val=1)
    cfg.DATA.update(dataset="Synthetic", semantics="class8",
                    semantic_strategy="gt", semantic_grid=True,
                    input="tof_depth", resx=256, resy=256, n_frames=16,
                    n_scenes=1, voxel_resolution=0.05, noise_sigma=0.01,
                    init_value=0.24, pad=2)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_entry_") as path:
        cfg.SETTINGS.experiment_path = path
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        results = entry.test_fusion(cfg, dev)
        torch.cuda.synchronize()
        counts = read_counts()
    log(f"test_fusion entry point (synthetic_tpu_demo_joint, 16 frames, "
        f"84x88x84): {time.perf_counter() - t0:.3f} s; launches {counts}")
    log(f"  eval_results {json.dumps(results)}")
    bad = [k for k, v in results.items() if not np.isfinite(v)]
    if bad or len(results) != 9:
        raise RuntimeError(f"test_fusion: missing or non-finite metrics "
                           f"{bad or results}")
    require(counts, ["median_filter3d", "build_shadow_dirty",
                     "reconcile_slot", "reconcile_key"], "test_fusion")
    return counts


# -- phases 9-10: training ---------------------------------------------------

def train_config(h: int = 256, w: int = 256):
    """The headline configuration with gt labels and the training section
    of configs/fusion/replica_accuracy.yaml (bench.py bench_train)."""
    cfg = headline_config(h, w)
    cfg.DATA.semantic_strategy = "gt"
    cfg.TRAINING.optimizer = {"name": "rmsprop", "lr": 1e-5,
                              "momentum": 0.9, "weight_decay": 0.01,
                              "eps": 1e-9}
    cfg.TRAINING.scheduler = {"name": "poly_lr", "max_iter": 50000}
    cfg.TRAINING.optimization = {"reset_strategy": False, "reset_prob": 0.01,
                                 "clipping": True, "accumulation_steps": 8}
    return cfg


def room_gt(n: int, dev, truncation: float = 0.1) -> torch.Tensor:
    """SyntheticScene(seed=0, half=2.2)'s SDF, truncated, at the voxel
    centres of headline_volume(n^3) (bench.py bench_train's gt), sampled
    in x-slabs on a thread pool."""
    scene = SyntheticScene(seed=0, half=2.2)
    res = 4.48 / n
    ax = -2.24 + (np.arange(n) + 0.5) * res
    sdf = np.empty((n, n, n), np.float32)

    def slab(x0, sx=16):
        x, y, z = np.meshgrid(ax[x0:x0 + sx], ax, ax, indexing="ij")
        d, _ = scene.sdf_and_labels(np.stack([x, y, z], axis=-1))
        sdf[x0:x0 + sx] = np.clip(d, -truncation, truncation)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(slab, range(0, n, 16)))
    return torch.as_tensor(sdf, device=dev)


def with_labels(frames):
    """gt labels for the semantic input: the depth quantised to 30
    classes (bench.py bench_train)."""
    sem = torch.clamp(frames["depth"] / 9.0 * 29.0, 0, 29).to(torch.uint8)
    return dict(frames, semantic_gt=sem)


def trainer(cfg, dev, n: int, seed: int = 0):
    """(pipeline, layout, stream, gt shadow, optimizer) over an empty n^3
    headline volume; the net seeded on the host, so every device starts
    from the same weights."""
    net = seeded_init(build_fusion_net(cfg.FUSION_MODEL),
                      torch.Generator().manual_seed(seed))
    pipe = Pipeline(cfg, fusion_net=net, device=dev, train=True)
    volume = headline_volume(dev, (n, n, n))
    layout = rowvol.RowLayout.for_shape((n, n, n))
    gt = room_gt(n, dev)
    gt_shadow = pipe._gt_shadow(layout, gt)
    stream = pipe._new_stream(layout, pipe._enter_rows(layout, volume))
    del gt, volume        # the packed and entered forms stay
    opt_cfg = cfg.TRAINING.optimizer
    optimizer = get_optimizer(
        opt_cfg, pipe.fusion_net,
        get_schedule(float(opt_cfg.lr), cfg.TRAINING.scheduler),
        clipping=bool(cfg.TRAINING.optimization.clipping))
    return pipe, layout, stream, gt_shadow, optimizer


def train_chunk(pipe, layout, stream, gt_shadow, optimizer, frames, resets):
    optimizer.zero_grad()
    loss, stream = pipe.train_sequence_rows(layout, stream, gt_shadow,
                                            frames, resets)
    optimizer.step()
    return float(loss), stream


def running_stats(net) -> torch.Tensor:
    return torch.cat([b.detach().float().reshape(-1)
                      for n, b in net.named_buffers() if "running" in n])


def training(dev, n: int = 448, hw: int = 256):
    """Phase 9: the full-width training configuration (n^3, hw x hw
    frames); returns the launch counts of the timed run."""
    cfg = train_config(hw, hw)
    accum = int(cfg.TRAINING.optimization.accumulation_steps)
    t0 = time.perf_counter()
    pipe, layout, stream, gt_shadow, optimizer = trainer(cfg, dev, n)
    frames = with_labels(render_frames(accum, hw, hw, dev))
    resets = [False] * accum
    net = pipe.fusion_net
    torch.cuda.synchronize()
    log(f"training at {n}^3: gt packed and state entered in "
        f"{time.perf_counter() - t0:.3f} s")
    params0 = [p.detach().clone() for p in net.parameters()]
    stats0 = running_stats(net)
    loss, stream = train_chunk(pipe, layout, stream, gt_shadow, optimizer,
                               frames, resets)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    n_chunks = 3
    t0 = time.perf_counter()
    losses = []
    for _ in range(n_chunks):
        loss, stream = train_chunk(pipe, layout, stream, gt_shadow,
                                   optimizer, frames, resets)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = pipe._peek_rows(layout, stream.rv)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    moved = max(float((p.detach() - q).abs().max())
                for p, q in zip(net.parameters(), params0))
    stats_moved = float((running_stats(net) - stats0).abs().max())
    n_frames = n_chunks * accum
    log(f"training ({n}^3, {hw}x{hw}, v3 gf 6 + semantic head, bf16 on f32 "
        f"master weights, chunks of {accum}, rmsprop + poly_lr + "
        f"clipping): {n_frames} frames in {dt:.3f} s = "
        f"{n_frames / dt:.2f} training frames/s, "
        f"{1e3 * dt / n_chunks:.1f} ms a chunk; peak device memory "
        f"{peak:.2f} GiB; losses {losses}; largest parameter move "
        f"{moved:.3g}, running statistics {stats_moved:.3g}; launches "
        f"{counts}; card {card_line()}")
    finite = bool(torch.isfinite(out.num).all()
                  and torch.isfinite(out.weights).all())
    if not all(np.isfinite(losses)) or moved == 0 or stats_moved == 0:
        raise RuntimeError("training: non-finite loss, or the parameters "
                           "or running statistics did not move")
    if not finite or int((out.weights > 0).sum()) == 0:
        raise RuntimeError("training: implausible peeked volume")
    require(counts, ["build_shadow_dirty", "reconcile_slot",
                     "reconcile_key"], "training")
    return counts


def small_train_config(rule: str):
    """Phase 10's configuration: 32x32 frames, v3 gf 2 in f32, dropout 0,
    the exact recurrence in f32 geo, the phase-9 optimizer with ``rule``
    at lr 1e-4."""
    cfg = train_config(32, 32)
    cfg.FUSION_MODEL.update(growth_factor=2, compute_dtype="float32",
                            dropout=0.0)
    cfg.SETTINGS.update(frame_block=1, sem_integrate_every=1,
                        geo_dtype="float32")
    cfg.TRAINING.optimizer.update(name=rule, lr=1e-4)
    return cfg


def small_training_run(cfg, dev, frames, resets, dtype=None):
    """2 chunks of 4 over an empty 64^3 volume, the net in ``dtype``
    (default: the configured one): (chunk losses, the first chunk's
    gradients, the parameters and their change after both updates, the
    exited volume, ms a chunk), on the host; ms from the host clock
    around the chunks, synchronised on a card."""
    pipe, layout, stream, gt_shadow, opt = trainer(cfg, dev, 64, seed=3)
    if dtype is not None:     # in place: the optimizer keeps its tensors
        pipe.fusion_net.to(dtype)
        pipe.fusion_net.compute_dtype = dtype
    params0 = torch.cat([p.detach().reshape(-1).cpu()
                         for p in pipe.fusion_net.parameters()])
    losses, grads, seconds = [], None, 0.0
    on_card = torch.device(dev).type == "cuda"
    for c in range(2):
        fr = {k: v[4 * c:4 * c + 4].to(dev) for k, v in frames.items()}
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss, stream = pipe.train_sequence_rows(layout, stream, gt_shadow,
                                                fr, resets[4 * c:4 * c + 4])
        if grads is None:
            grads = torch.cat([p.grad.detach().reshape(-1).cpu()
                               for p in pipe.fusion_net.parameters()])
        opt.step()
        losses.append(float(loss))
        seconds += time.perf_counter() - t0
    params = torch.cat([p.detach().reshape(-1).cpu()
                        for p in pipe.fusion_net.parameters()])
    out = pipe._exit_rows(layout, stream.rv)
    return losses, grads, params, params - params0, out, 500.0 * seconds


def training_reference(dev):
    """Phase 10: the same small training stream on the card, as users run
    it (cuDNN on), and on the CPU (plain versions): 64^3, 32x32, f32 nets,
    TF32 off, dropout 0, 2 chunks of 4 with a reset before the second
    chunk's third frame, the phase-9 optimizer with the SGD rule
    (momentum 0.9) at lr 1e-4: rmsprop scales each element's step to
    about lr whatever its gradient, so an element whose gradient is
    rounding noise around 0 (a bias ahead of a BatchNorm) steps a full lr
    of either sign on either device, while SGD's step carries the
    gradients' agreement (rmsprop is held to optax on the CPU by the tests
    and runs here in phase 9).

    BatchNorm's variance takes two passes (``models/layers.py``): with
    the one pass ``mean(x^2) - mean^2`` the card's gradients lay 0.375
    (relative L2) from a float64 run's with cuDNN's convolutions
    (tools/training_precision.py). Tolerances (measured CPU f32 against
    CPU f64 beside them): the losses within rtol 1e-5 (2e-7); the
    first chunk's gradients within 1e-2 of the largest (1.0e-3); the
    parameters within 1e-2 of the update's L2 norm (0.0055); the volume
    as phase 6: weights atol 1e-3 + rtol 1e-3, tsdf 1e-3 where the weight
    exceeds 0.05 (8.5e-6)."""
    cfg = small_train_config("sgd")
    frames = with_labels(render_frames(8, 32, 32, "cpu"))
    resets = [False] * 6 + [True, False]
    l_ref, g_ref, p_ref, step, v_ref, _ = small_training_run(
        cfg, "cpu", frames, resets)
    losses, g, p, _, v, ms = small_training_run(cfg, dev, frames, resets)
    obs = v_ref.weights > 0.05
    errors = {"losses": losses,
              "grad": float((g - g_ref).abs().max() / g_ref.abs().max()),
              "grad_l2": float((g - g_ref).norm() / g_ref.norm()),
              "param_l2": float((p - p_ref).norm() / step.norm()),
              "w": float((v.weights.cpu() - v_ref.weights).abs().max()),
              "tsdf": float((v.tsdf.cpu()[obs] - v_ref.tsdf[obs])
                            .abs().max())}
    log(f"training reference (card with cuDNN vs CPU plain path, 64^3, 2 "
        f"chunks of 4, {int(obs.sum())} observed voxels; CPU losses "
        f"{l_ref}): {errors}; {ms:.2f} ms a chunk on the card")
    ok = (np.allclose(losses, l_ref, rtol=1e-5)
          and errors["grad"] <= 1e-2 and errors["param_l2"] <= 1e-2
          and torch.allclose(v.weights.cpu(), v_ref.weights, atol=1e-3,
                             rtol=1e-3)
          and errors["tsdf"] <= 1e-3 and int(obs.sum()) > 1000)
    if not ok:
        raise RuntimeError("card and CPU training disagree on the small "
                           "input")


def synthetic_small_config(path: str):
    """configs/fusion/synthetic_small.yaml built in Python (the card's
    machine has no PyYAML), cut to 8 frames; ply saves only (it may have
    no h5py)."""
    return Config({
        "SETTINGS": {"num_workers": 0, "experiment_path": path,
                     "save_mode": "ply", "eval_freq": 16, "log_freq": 8,
                     "seed": 1911},
        "FUSION_MODEL": {"name": "v3", "output_scale": 1.0, "n_points": 5,
                         "n_tail_points": 4, "growth_factor": 2,
                         "use_semantics": False},
        "SEMANTIC_2D_MODEL": {"stage": 1, "n_classes": 8},
        "TRAINING": {"n_epochs": 1,
                     "optimizer": {"name": "rmsprop", "lr": 1e-4,
                                   "momentum": 0.9, "weight_decay": 0.01,
                                   "eps": 1e-9},
                     "scheduler": {"name": "poly_lr", "max_iter": 1000},
                     "loss": {"name": "fusion", "w_l1": 1.0, "w_l2": 10,
                              "w_cos": 0.1},
                     "optimization": {"reset_strategy": False,
                                      "reset_prob": 0.01, "clipping": True,
                                      "accumulation_steps": 4}},
        "TESTING": {"outlier_filter_val": 0.5},
        "DATA": {"dataset": "Synthetic", "semantics": None,
                 "semantic_strategy": "gt", "semantic_grid": False,
                 "data_load_strategy": "max_depth_diversity",
                 "input": "tof_depth", "resx": 48, "resy": 48, "n_frames": 8,
                 "n_scenes": 1, "voxel_resolution": 0.1,
                 "noise_sigma": 0.004, "init_value": 0.24, "pad": 2}})


def train_entry_point(dev):
    """``train_fusion`` on synthetic_small (1 epoch, 8 frames), then its
    best.ckpt through ``test_fusion``; returns the launch counts."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as path:
        cfg = synthetic_small_config(path)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        net, ws = train_fusion(cfg, dev)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        files = sorted(os.listdir(ws.model_path))
        tcfg = synthetic_small_config(os.path.join(path, "test"))
        tcfg.TESTING.fusion_model_path = os.path.join(ws.model_path,
                                                      "best.ckpt")
        loaded = entry.test_fusion(tcfg, dev)
        dcfg = synthetic_small_config(os.path.join(path, "direct"))
        direct = entry.test_fusion(dcfg, dev, fusion_net=net)
        torch.cuda.synchronize()
        counts = read_counts()
    log(f"train_fusion entry point (synthetic_small, 8 frames of 48x48): "
        f"{t_train:.3f} s, wrote {files}; test_fusion from best.ckpt "
        f"{json.dumps(loaded)}; launches {counts}")
    if files != ["best.ckpt", "last.ckpt"]:
        raise RuntimeError(f"train_fusion wrote {files}")
    # the card's float scatter-add sums in any order: metrics within 1e-4,
    # the mesh F-scores within 0.01 (tests/test_torch_test_fusion.py)
    far = [k for k in direct if not abs(loaded[k] - direct[k]) <= (
        0.01 if k.startswith("mesh_") else 1e-4)]
    if far or set(loaded) != set(direct):
        raise RuntimeError(f"test_fusion from best.ckpt differs from the "
                           f"trained net: {far}")
    require(counts, ["build_shadow_dirty", "reconcile_slot",
                     "reconcile_key"], "train_fusion")
    return counts


# -- phases 11-13: segmentation -----------------------------------------------

def seg_config(path: str, stage: int = 1, input_key: str = "tof_depth",
               **pretrained):
    """configs/segmentation/replica_{depth,rgb,multi}.yaml's model and
    optimizer built in Python (the card's machine has no PyYAML):
    AdapNet++ at ResNet-50 widths, 30 classes, bf16 compute on f32
    master weights, batch 8, sgd at lr 0.005 (momentum 0.9, weight decay
    5e-4), poly_lr, num_workers 8 (the port's loader decodes in one
    background thread); on Synthetic 256x256 frames (Replica is not in
    the repo), 3 epochs of 4 steps (32 frames of one scene), 2 strips."""
    return Config({
        "SETTINGS": {"num_workers": 8, "experiment_path": path,
                     "seed": 1911},
        "SEMANTIC_2D_MODEL": {"name": "adapnet", "stage": stage,
                              "n_classes": 30, "compute_dtype": "bfloat16",
                              **pretrained},
        "TRAINING": {"train_batch_size": 8, "train_shuffle": True,
                     "val_batch_size": 4, "n_epochs": 3,
                     "optimizer": {"name": "sgd", "lr": 0.005,
                                   "nesterov": True, "momentum": 0.9,
                                   "weight_decay": 0.0005},
                     "scheduler": {"name": "poly_lr", "max_iter": 50},
                     "optimization": {"random_mask": stage == 2,
                                      "mask_prob": 0.25}},
        "TESTING": {"test_batch_size": 1, "n_visualizations": 2},
        "DATA": {"dataset": "Synthetic", "input": input_key,
                 "target": "semantic_gt", "semantics": "class30",
                 "resx": 256, "resy": 256, "n_frames": 32, "n_scenes": 1,
                 "voxel_resolution": 0.1, "noise_sigma": 0.01,
                 "init_value": 0.1, "pad": 2}})


def moved(model, cfg):
    """(largest parameter move, largest running-statistic move) of a
    trained AdapNet from the weights it started from."""
    start = seg_train.new_adapnet(cfg.SEMANTIC_2D_MODEL,
                                  int(cfg.SETTINGS.seed))
    seg_train._initial_weights(start, cfg.SEMANTIC_2D_MODEL, _Quiet())
    now, then = model.state_dict(), start.state_dict()
    par = max(float((now[k].cpu() - then[k]).abs().max())
              for k, _ in start.named_parameters())
    run = max(float((now[k].cpu() - then[k]).abs().max())
              for k in then if "running" in k)
    return par, run


class _Quiet:
    """A workspace stand-in for ``_initial_weights``."""

    def log(self, msg, mode="train"):
        pass


def segmentation(dev, root: str):
    """Phase 11: stage 1 on tof_depth, stage 1 on image, stage 2 with the
    transplant from those two best checkpoints and random masking; each
    printed with images/s and ms a step after the first epoch, the peak
    device memory, its losses and how far its weights moved. Returns the
    stage-2 and the tof stage-1 best.ckpt."""
    best = {}
    for name, stage, key, pre in (
            ("stage 1 tof", 1, "tof_depth", {}),
            ("stage 1 rgb", 1, "image", {}),
            ("stage 2 rgb+tof", 2, "tof_depth", None)):
        if pre is None:
            pre = {"pretrained_rgb": best["stage 1 rgb"],
                   "pretrained_tof": best["stage 1 tof"]}
        cfg = seg_config(os.path.join(root, name.replace(" ", "_")), stage,
                         key, **pre)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        model, ws, hist = seg_train.train_segmentation(cfg, dev, name)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        steps = sum(hist["steps"][1:])
        secs = sum(hist["train_seconds"][1:])
        par, run = moved(model, cfg)
        losses = hist["train_loss"]
        log(f"segmentation {name} (AdapNet++ stage {stage}, 256x256, "
            f"batch 8, bf16 on f32 master weights, sgd + poly_lr): "
            f"{8 * steps / secs:.2f} images/s, {1e3 * secs / steps:.1f} ms "
            f"a step after the first epoch (first epoch "
            f"{hist['train_seconds'][0]:.2f} s, all {total:.2f} s); peak "
            f"device memory {peak:.2f} GiB; losses {losses}; val mIoU "
            f"{[round(m['Mean IoU'], 4) for m in hist['val']]}; largest "
            f"parameter move {par:.3g}, running statistics {run:.3g}")
        if (not all(np.isfinite(losses)) or losses[-1] >= losses[0]
                or par == 0 or run == 0):
            raise RuntimeError(f"segmentation {name}: non-finite or "
                               "rising loss, or the weights did not move")
        best[name] = os.path.join(ws.model_path, "best.ckpt")
        if not os.path.exists(best[name]):
            raise RuntimeError(f"segmentation {name}: no best.ckpt")
        del model
        torch.cuda.empty_cache()
    return best["stage 2 rgb+tof"], best["stage 1 tof"]


def segmentation_test(dev, root: str, ckpt: str):
    """Phase 11b: ``test_segmentation`` on the stage-2 best.ckpt."""
    cfg = seg_config(os.path.join(root, "test"), 2, "tof_depth")
    cfg.TESTING.semantic_2d_model_path = ckpt
    t0 = time.perf_counter()
    metrics = seg_test.test_segmentation(cfg, dev)
    vis = os.path.join(cfg.SETTINGS.experiment_path, cfg.TIMESTAMP,
                       "output", "vis")
    files = sorted(os.listdir(vis))
    log(f"test_segmentation (stage 2, 32 frames): "
        f"{time.perf_counter() - t0:.2f} s; {metrics}; strips {files}")
    sizes = {os.path.getsize(os.path.join(vis, f)) for f in files}
    if (files != ["0000.png", "0001.png"] or min(sizes) == 0
            or not all(np.isfinite(v) for v in metrics.values())):
        raise RuntimeError("test_segmentation: missing strips or "
                           "non-finite metrics")


def predict_entry_point(dev, seg_ckpt: str):
    """Phase 11c: ``test_fusion`` with ``semantic_strategy: predict``,
    the stage-1 tof checkpoint of phase 11 as the segmenter (the
    reference's train-then-fuse workflow), on phase 8's configuration
    with 30 classes; returns the launch counts."""
    cfg = default_config()
    cfg.SETTINGS.update(save_mode="ply", num_workers=0)
    cfg.FUSION_MODEL.update(name="v3", n_points=9, n_tail_points=7,
                            growth_factor=6, use_semantics=True,
                            compute_dtype="bfloat16")
    cfg.SEMANTIC_2D_MODEL.update(stage=1, n_classes=30,
                                 compute_dtype="bfloat16")
    cfg.TESTING.update(outlier_filter_val=1, semantic_2d_model_path=seg_ckpt)
    cfg.DATA.update(dataset="Synthetic", semantics="class30",
                    semantic_strategy="predict", semantic_grid=True,
                    input="tof_depth", resx=256, resy=256, n_frames=16,
                    n_scenes=1, voxel_resolution=0.05, noise_sigma=0.01,
                    init_value=0.24, pad=2)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_predict_") as path:
        cfg.SETTINGS.experiment_path = path
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        results = entry.test_fusion(cfg, dev)
        torch.cuda.synchronize()
        counts = read_counts()
    log(f"test_fusion with the stage-1 tof segmenter predicting (16 frames, "
        f"30 classes): {time.perf_counter() - t0:.3f} s; launches {counts}")
    log(f"  eval_results {json.dumps(results)}")
    bad = [k for k, v in results.items() if not np.isfinite(v)]
    if bad or len(results) != 9:
        raise RuntimeError(f"test_fusion (predict): missing or non-finite "
                           f"metrics {bad or results}")
    require(counts, ["median_filter3d", "build_shadow_dirty",
                     "reconcile_slot", "reconcile_key"], "test_fusion predict")
    return counts


def seg_step(model, x, y, lr=0.005):
    """One stage-1 train step: the trainer's loss, its gradients, one SGD
    update (momentum 0.9, weight decay 5e-4); (loss, flat gradients, flat
    parameters after the update, flat running statistics), on the host."""
    opt = get_optimizer(Config({"name": "sgd", "momentum": 0.9,
                                "weight_decay": 0.0005}), model,
                        get_schedule(lr, None))
    outs = model.train()(x)
    loss = sum(lw * cross_entropy(o.permute(0, 2, 3, 1), y, ignore_index=0)
               for lw, o in zip(seg_train.LOSS_WEIGHTS, outs))
    loss.backward()

    def flat(ts):
        return torch.cat([t.detach().reshape(-1).double().cpu() for t in ts])
    grads = flat(p.grad for p in model.parameters())
    opt.step()
    return (float(loss.detach()), grads, flat(model.parameters()),
            flat(b for n, b in model.named_buffers() if "running" in n))


def segmentation_reference(dev):
    """Phase 12: one stage-1 train step (32x32 Synthetic depth frames,
    batch 2, 4 classes, the layer3 dropout off, f32, TF32 off) on the
    card (cuDNN on, as the trainer runs it) and on the CPU, and in float64
    on the CPU, from one seeded init.
    The f32 gradients of this random net are ill-conditioned (JAX's own
    lie 0.16 of the largest from float64 at this size;
    tests/test_torch_adapnet.py), so the card is held to float64 within
    twice the CPU's f32 distance from it, plus a floor: the loss
    (relative; floor 1e-5), the gradients (over the largest; 1e-3), the
    parameters after one SGD step (over the update's largest; 1e-3) and
    the running statistics (1e-4). Measured (H100 80GB HBM3, 700 W): the
    CPU's f32 loss 2.5e-5 from float64, the gradients 0.111, the
    parameters 0.111, the statistics 2.6e-4; the card's 2.0e-5, 0.150,
    0.150 and 3.2e-4 with cuDNN's convolutions (0.146 with cuDNN off:
    unlike FusionNet's, this step keeps them)."""
    cfg = Config({"n_classes": 4, "stage": 1, "resn50_dropout": False})
    data = Synthetic(Config({"resx": 32, "resy": 32, "n_frames": 2,
                             "voxel_resolution": 0.1}), device="cpu")
    x = torch.stack([torch.as_tensor(data[i]["tof_depth"])
                     for i in range(2)])[:, None].expand(-1, 3, -1, -1)
    y = torch.stack([torch.as_tensor(data[i]["semantic_gt"]).long()
                     for i in range(2)])
    init = seg_train.new_adapnet(cfg, 5)
    runs = {}
    for name, d, dt in (("f64", "cpu", torch.float64),
                        ("cpu", "cpu", torch.float32),
                        ("card", dev, torch.float32)):
        model = copy.deepcopy(init).to(d, dt)
        runs[name] = seg_step(model, x.to(d, dt), y.to(d))
    ref = runs["f64"]
    step = (ref[2] - torch.cat([p.detach().reshape(-1).double()
                                for p in init.parameters()])).abs().max()

    def errors(run):
        return {"loss": abs(run[0] - ref[0]) / abs(ref[0]),
                "grad": float((run[1] - ref[1]).abs().max()
                              / ref[1].abs().max()),
                "params": float((run[2] - ref[2]).abs().max() / step),
                "stats": float((run[3] - ref[3]).abs().max())}
    e_cpu, e_card = errors(runs["cpu"]), errors(runs["card"])
    log(f"segmentation reference (stage 1, 32x32, batch 2, one SGD step; "
        f"against CPU float64): card {e_card}; CPU f32 {e_cpu}; losses "
        f"card {runs['card'][0]}, CPU {runs['cpu'][0]}")
    floor = {"loss": 1e-5, "grad": 1e-3, "params": 1e-3, "stats": 1e-4}
    far = [k for k in e_card if e_card[k] > 2 * e_cpu[k] + floor[k]]
    if far:
        raise RuntimeError(f"segmentation step: card and CPU disagree on "
                           f"{far}")


def seg_quality(dev, root: str):
    """Phase 13: ``seg_quality_demo`` on configs/segmentation/
    synthetic_tpu_demo.yaml built in Python: stage-1 AdapNet++ on
    128x128 depth, 8 classes, 3 scenes of 24 frames, 4 epochs, sgd at lr
    0.01; the trained best.ckpt's unseen-scene mIoU at least twice the
    random init's."""
    cfg = Config({
        "SETTINGS": {"num_workers": 0, "seed": 1911,
                     "experiment_path": os.path.join(root, "seg_demo")},
        "SEMANTIC_2D_MODEL": {"name": "adapnet", "stage": 1,
                              "n_classes": 8},
        "TRAINING": {"train_batch_size": 4, "train_shuffle": True,
                     "val_batch_size": 4, "n_epochs": 4,
                     "optimizer": {"name": "sgd", "lr": 0.01,
                                   "momentum": 0.9, "weight_decay": 0.0001},
                     "scheduler": {"name": "poly_lr", "max_iter": 400},
                     "optimization": {"random_mask": False,
                                      "mask_prob": 0.1}},
        "TESTING": {"n_visualizations": 0},
        "DATA": {"dataset": "Synthetic", "semantics": "class8",
                 "input": "tof_depth", "target": "depth_gt",
                 "target_seg": "semantic_gt", "resx": 128, "resy": 128,
                 "n_frames": 24, "n_scenes": 3, "voxel_resolution": 0.05,
                 "noise_sigma": 0.004, "init_value": 0.24, "pad": 2}})
    t0 = time.perf_counter()
    rand, trained, _ = seg_demo.seg_quality_demo(cfg, dev)
    log(f"seg quality demo (synthetic_tpu_demo): val mIoU on an unseen "
        f"scene, trained {trained['Mean IoU']:.4f} against random init "
        f"{rand['Mean IoU']:.4f}; {time.perf_counter() - t0:.2f} s")
    if not trained["Mean IoU"] >= 2 * rand["Mean IoU"]:
        raise RuntimeError("seg quality demo: the trained mIoU is not twice "
                           "the random init's")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("torch.backends.cudnn.allow_tf32 = False, "
        "torch.backends.cuda.matmul.allow_tf32 = False")

    t0 = time.perf_counter()
    builds = [lambda: _build.load_library("shadow_build"),
              lambda: _build.load_library("median3d"),
              lambda: _build.load_library("probes"),
              lambda: _build.load_host_library(MCUBES_SOURCE)]
    with ThreadPoolExecutor(len(builds)) as pool:
        infos = [info for _, info in pool.map(lambda b: b(), builds)]
    log(f"build: {len(infos)} libraries in parallel, "
        f"{time.perf_counter() - t0:.2f} s")
    for info in infos:
        log(f"  {info['path']}: compiler {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")

    results = check_kernels(dev)
    results["median_filter3d"] = check_median(dev)
    probe_results, probe_launches = check_probes(dev)
    launches = headline(dev)
    small_reference(dev)
    fuse_many_run(dev)
    for k, n in entry_point(dev).items():
        launches[k] += n
    for phase in (training, train_entry_point):
        for k, n in phase(dev).items():
            launches[k] += n
        torch.cuda.empty_cache()
    training_reference(dev)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_seg_") as root:
        stage2, tof = segmentation(dev, root)
        segmentation_test(dev, root, stage2)
        for k, n in predict_entry_point(dev, tof).items():
            launches[k] += n
        segmentation_reference(dev)
        seg_quality(dev, root)
    log(f"phases 11-13 (segmentation): {time.perf_counter() - t0:.1f} s")

    replaces = {"build_shadow_dirty": f"{PALLAS}:359",
                "build_shadow": f"{PALLAS}:254",
                "reconcile_slot": f"{PALLAS}:462",
                "reconcile_key": f"{PALLAS}:576",
                "median_filter3d": K5_PALLAS}
    kernels = [{"name": name, "route": "cuda",
                "source": K5_SOURCE if name == "median_filter3d" else SOURCE,
                "replaces": replaces[name], "launches": launches[name],
                **results[name]} for name in replaces]
    kernels += [{"name": name, "route": "cuda", "source": PROBE_SOURCE,
                 "replaces": where, "launches": probe_launches[name],
                 **probe_results[name]}
                for name, where in PROBE_REPLACES.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
