#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``segfusion_tpu_torch``) on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each of which raises (exit code 1, no result line) on failure:

1. the card's name and power limit (nvidia-smi);
2. build of the CUDA kernels from ``segfusion_tpu_torch/csrc`` (nvcc,
   sm_90a, one process per source, started together) and their ptxas
   report, and of the host libraries (g++: marching cubes, the
   rasterizer, the mesh simplifier, the zstd decoder);
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
   geo, nets in bf16 (FusionNet through the folded executor), seeded
   random weights; 2 chunks of 32 frames, then the exit reconcile;
4b. the evaluation of that fused 448^3 volume through the port's Database
   (gt: the same synthetic room sampled at 1 cm): ``filter``,
   ``filter_semantics`` (one K5 launch), ``evaluate``,
   ``evaluate_semantics``, ``evaluate_fscore``, ``get_mesh`` and a
   ``save`` in "test" mode (hdf5 volumes and the two ply meshes), each
   timed;
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
   master weights (the matmul-form training forward), 448^3 at 1 cm
   with the gt from the synthetic room's
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
   frames), its best.ckpt fed back through ``test_fusion``;
11. segmentation training at ResNet-50 widths (configs/segmentation/
   replica_{depth,rgb,multi}.yaml's model and optimizer, 256x256, batch
   8, bf16): AdapNet++ stage 1 on depth, stage 1 on the image, stage 2
   with the transplant of both and random masking; images/s, ms a step,
   peak memory, losses; 11b ``test_segmentation`` on the stage-2
   checkpoint (metrics and strips); 11c ``test_fusion`` with the stage-1
   depth model predicting the labels (K1/K3/K4/K5);
12. one stage-1 train step on the card and on the CPU against float64;
13. ``seg_quality_demo`` (trained unseen-scene mIoU at least twice the
   random init's);
14. the per-frame step, the flat scalar path, FusionNet v1/v2 and the
   classic fusion, at the headline's scale (448^3 at 1 cm, 256x256,
   v3 gf 6 with the semantic head, AdapNet++ stage 2, bf16 nets), each
   sub-phase timed:
   a. per-frame ``Pipeline.fuse`` of 8 frames through the Database
      (K2, K3 and K4 each 8 times), frames/s;
   b. ``integration: scalar`` ``fuse_sequence`` in both gather
      precisions (2 chunks of 8), frames/s, the packing pass's ms; the
      same 16 frames through the row path against the scalar path, with
      f32 nets (tests/test_rowvol.py's bound) and bf16 nets (a stated
      bound: ``scalar_path``);
   c. phase 6's small stream through the flat path and per-frame steps,
      card against CPU;
   d. ``fuse_training`` at phase 9's width (8 frames, rmsprop a frame),
      training frames/s and peak memory; ``train_fusion`` with
      ``use_sequence: false`` and ``accumulation_steps: 2`` on
      synthetic_small, its best.ckpt through ``test_fusion`` with
      ``sequence_chunk: 1`` on synthetic_tpu_demo_joint's configuration
      (K1 to K5);
   e. FusionNet v1, v2 and a stack_heads v3 at 256x256: f32 forward card
      against CPU, a train-mode step; v2 through ``fuse_sequence_rows``;
   f. the classic fusion (``TSDFVolume`` API, ``tsdf_from_depth_views``
      at 256^3, ``distance_transform``, ``tvl1_refine`` at 128^3), card
      against CPU;
15. the parallel runners (``segfusion_tpu_torch/parallel``):
   a. K1-K4 through the scene-folded entry points (one launch on X' =
      S * X) on 2 scenes of 320^3 f32 and 3 of 84^3 bf16, bit-exact
      against the per-scene calls and the plain versions (K1 also with an
      unbatched carry), folded times beside the byte bound; and on 3
      scenes of 448^3 f32, past 2^31 geo elements, against the per-scene
      calls;
   b. ``bench.py`` multi512 through ``SceneParallelFusion.run_sequences``
      (2 scenes x 512x512, 320^3 at 1 cm, AdapNet++ stage 2 + v3 gf 6,
      bf16 nets, f32 geo, frame_block 1): aggregate frames/s and peak
      memory, the same streams one after the other through
      ``fuse_sequence`` beside it, the two compared (bf16 nets at full
      size, f32 nets at 96^3);
   c. ``run`` / ``step`` over phase 6's stream for two scenes, row path
      and ``integration: scalar``, card against CPU;
   d. the ``shard_kernels`` wrappers on 4 x-slabs of 448^3 on one card,
      bit-exact against the unsharded kernels;
   e. ``SpatialShardedFusion`` ``step`` and ``fuse_sequence`` over 2
      slabs against the unsharded pipeline, row path and scalar;
   f. ``parallel.multihost_worker`` as two processes on the card (gloo);
16. the folded FusionNet v3 executor (``models/fusionnet_fast``, which a
   bf16 v3 pipeline runs by default, as the JAX package's does) and the
   host tools:
   a. the executor against the eager module at full width (gf 6 with the
      semantic head, a block of 4 x 256x256): every ``fused_conv3x3`` x
      ``fused_vortex`` form in f32 within rtol 2e-4 / atol 2e-5, in bf16
      max and mean |d| from the f32 forward beside the eager bf16
      module's; ms and kernels per forward; card against CPU at gf 2;
   b. the headline (phase 4) and multi512 (15b) with the executor and
      with ``fused_net: off``, in turns: frames/s;
   c. phase 9's training with the matmul-form training forward and with
      ``fused_net_train: off``: training frames/s, peak memory; a small
      bf16 training stream card against CPU;
   d. a reference-named v3 ``.pth.tar`` through ``convert_checkpoint``
      (and ``python -m``), then ``test_fusion`` from it (K1/K3/K4/K5);
   e. ``python -m segfusion_tpu_torch.preprocess.{scale,fuse,simplify}``
      on one closed mesh (fuse at the tool's defaults, on the card, with
      ``--save_sdf``: its gzip hdf5 read back bit-exact against the same
      fusion in this process);
   f. ``trace`` around a headline block, ``nan_guard`` on a NaN;
17. the real-data loaders on their datasets' own layouts, written from
   Synthetic rooms (depth rendered on the card) and loaded with the
   configs' YAML files:
   a. the host libraries (cv2 and PIL; every hdf5 file through the
      port's own codec, ``utils/hdf5.py``);
   a'. each Replica room's gt grid, ``gt_semantic_sdf/semantic_sdf.hdf``
      (2 x 400^3 f32 at 1 cm, 512 MB), written through the port's writer
      and read back bit-exact; one gzip-chunked copy (as
      ``preprocess.fuse`` writes) the same; seconds and MB/s;
   b. a Replica tree (2 rooms x 32 frames of 512x512, raw camera
      matrices) through the port's ``Replica`` at replica_accuracy.yaml's
      256x256: poses within 1e-5, gt depth to the millimetre, the two
      rooms interleaved frame by frame; host ms a frame;
   d. ``train_fusion`` on replica_accuracy.yaml (v3 gf 6 with the
      semantic head, AdapNet++ stage 2 predicting 30 classes, bf16 nets,
      f16packed gathers, rmsprop with accumulation 8, ``save_mode:
      test``) over room 0's 32 frames into its gt grid (404^3 after the
      pad), validating on room 1: training frames/s, the validation's
      seconds, the gzip-9 hdf5 saves' seconds, peak memory, K1-K4; every
      ``.hf5`` read back bit-exact;
   c. ``test_fusion`` on replica_accuracy.yaml over room 1's 32 frames
      from 17d's best.ckpt into the gt grid: stage seconds, metrics,
      the saved volumes read back bit-exact, K1/K3/K4/K5;
   e. ``train_segmentation`` on replica_multi.yaml (stage 2, RGB + ToF,
      batch 8, bf16) for one epoch over the tree from seeded stage-1
      checkpoints, then ``test_segmentation`` on its best.ckpt;
   f. a raw ScanNet scan (32 frames of 640x480, a ply, no hdf):
      ``test_fusion`` on scannet.yaml over ``create_grid``'s 401^3 grid
      at 1 cm (seeded v3 gf 6 and 21-class stage-2 checkpoints at the
      config's paths; ``save_mode: test``, the volumes read back
      bit-exact; K1/K3/K4/K5), each stage and the loader timed; then
      ``test_segmentation`` on scannet_multi.yaml writing one benchmark
      PNG a frame;
   g. every augmentation key on a 256x256 pair;
18. ``quality_demo`` on synthetic_tpu_demo_joint.yaml, 2 of its 3 epochs
   of 60 frames: the trained TSDF IoU and mesh F-score must each beat
   random init's by DEMO_MARGIN;
19. the orbax checkpoints (``utils/checkpoints.py``
   ``save_checkpoint_orbax`` / ``load_checkpoint_orbax`` over the port's
   zstd, OCDBT and zarr codecs; the zstd decoder ``csrc/zstd.cpp`` is
   built with the other host libraries in phase 2):
   a. phase 9's trained state (FusionNet v3 gf 6 with the semantic
      head, its bf16 copies, the rmsprop state, the step counter), the
      headline's AdapNet++ stage 2 (bf16) and a 448^3 float32 + uint8
      scene volume saved and loaded back without a template and with the
      state itself as the template (tensors back on the card): every
      leaf bit-equal; host seconds and MB/s of each; then ``fuse_many``
      (phase 7's stream, then the label median) with the restored nets,
      bit-equal to the same stream with the nets in memory, both under
      ``torch.use_deterministic_algorithms`` (the integration's atomic
      scatter-adds otherwise differ from run to run in the low bits);
   b. the committed orbax checkpoint that the JAX package wrote
      (``segfusion_tpu_torch/utils/fixtures/orbax_small``, real zstd:
      Huffman literals, FSE sequences, several blocks) loaded onto the
      card and held leaf by leaf to the arrays its seed gives; each of
      its frames decoded by the C++ decoder and by the plain one, equal.

Launch counts are reset just before each main-path run (3c's probe
mains, 4, 4b, 5, 8, 9, the trainer of 10, 11c, 14's runs, 15b, c and e,
16b, c and d, 17d's ``train_fusion``, 17c's and 17f's ``test_fusion``,
18 and 19a's ``fuse_many`` with the restored nets) and read just after;
the kernel checks' launches are not counted.

Then one JSON line of per-kernel results, the card line again, and last
``{"ok": true, "device": {...}}``. Exits non-zero without a result where
torch sees no CUDA device.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from segfusion_tpu_torch import test_fusion as entry
from segfusion_tpu_torch.config import (Config, default_config,
                                        get_data_config, load_config)
from segfusion_tpu_torch.core import tsdf_volume as ctv
from segfusion_tpu_torch.core.database import Database
from segfusion_tpu_torch.core.pipeline import Pipeline
from segfusion_tpu_torch.core.volume import Voxelgrid, init_scene_volume
from segfusion_tpu_torch.data import Replica, ScanNet, get_data
from segfusion_tpu_torch.data.augmentations import get_composed_augmentations
from segfusion_tpu_torch.data.replica import raw_camera_matrix
from segfusion_tpu_torch.data.synthetic import Synthetic, SyntheticScene
from segfusion_tpu_torch.headline import (HEADLINE_SHAPE, build_pipeline,
                                          headline_config, headline_volume,
                                          render_frames)
from segfusion_tpu_torch.models import seeded_init
from segfusion_tpu_torch.models.adapnet import SegmenterAdapter, build_adapnet
from segfusion_tpu_torch.models import fusionnet_fast as ff
from segfusion_tpu_torch.models.fusionnet import build_fusion_net
from segfusion_tpu_torch.convert_checkpoint import convert_checkpoint
from segfusion_tpu_torch.ops import distance_transform as cdt
from segfusion_tpu_torch.ops import geometry, rowvol
from segfusion_tpu_torch.ops import tvl1 as ctvl1
from segfusion_tpu_torch.ops.raycast import render_depth
from segfusion_tpu_torch.ops.tsdf_fusion import tsdf_from_depth_views
from segfusion_tpu_torch.ops.integrate import pack_semantic_key
from segfusion_tpu_torch.ops.kernels import _build
from segfusion_tpu_torch.ops.kernels import median3d as k5
from segfusion_tpu_torch.ops.kernels import shadow_build as sb
from segfusion_tpu_torch.parallel import shard_kernels
from segfusion_tpu_torch.parallel.mesh import data_parallel_mesh, scene_mesh
from segfusion_tpu_torch.parallel.scene_parallel import (SceneParallelFusion,
                                                         stack_volumes,
                                                         unstack_volumes)
from segfusion_tpu_torch.parallel.spatial import (SpatialShardedFusion,
                                                  unshard_volume_spatial)
from segfusion_tpu_torch.probes import _lib as probe_lib
from segfusion_tpu_torch import seg_quality_demo as seg_demo
from segfusion_tpu_torch.quality_demo import quality_demo
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
from segfusion_tpu_torch.utils import hdf5, torch_convert
from segfusion_tpu_torch.utils import fixtures, ocdbt, zstd
from segfusion_tpu_torch.utils.checkpoints import (load_checkpoint_orbax,
                                                   save_checkpoint,
                                                   save_checkpoint_orbax)
from segfusion_tpu_torch.utils.convert import (fusionnet_from_checkpoint,
                                               to_flax)
from segfusion_tpu_torch.utils.mesh import MCUBES_SOURCE, marching_cubes
from segfusion_tpu_torch.utils.meshio import read_off, write_off, write_ply
from segfusion_tpu_torch.utils.rasterize import RASTERIZE_SOURCE
from segfusion_tpu_torch.preprocess.common import load_mesh
from segfusion_tpu_torch.preprocess.fuse import fuse_mesh
from segfusion_tpu_torch.utils.simplify import (SIMPLIFY_SOURCE,
                                                simplify_quadric)
from segfusion_tpu_torch.utils.tracing import nan_guard, trace

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
# the joint quality demo (phase 18): the trained net's TSDF IoU and mesh
# F-score must each beat random init's by this much
DEMO_MARGIN = 0.1


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
        ("save(test)", lambda: db.save(out_dir, "test", s)),
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
    counts = read_counts()
    log(f"  hdf5 volumes read back bit-exact: "
        f"{read_back(db, s, saved_name(out_dir, s))}")
    return metrics, mesh, counts


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
    configs/fusion/synthetic_tpu_demo_joint.yaml, cut to 16 frames."""
    cfg = default_config()
    cfg.SETTINGS.update(save_mode="test", num_workers=0)
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


def trainer(cfg, dev, n: int, seed: int = 0, gt=None):
    """(pipeline, layout, stream, gt shadow, optimizer) over an empty n^3
    headline volume (``gt``: the room's n^3 gt, sampled here when None);
    the net seeded on the host, so every device starts from the same
    weights."""
    net = seeded_init(build_fusion_net(cfg.FUSION_MODEL),
                      torch.Generator().manual_seed(seed))
    pipe = Pipeline(cfg, fusion_net=net, device=dev, train=True)
    volume = headline_volume(dev, (n, n, n))
    layout = rowvol.RowLayout.for_shape((n, n, n))
    gt = room_gt(n, dev) if gt is None else gt
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
    frames); returns the launch counts of the timed run and the trained
    net with its optimizer (phase 19 checkpoints them)."""
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
    return counts, {"fusion_net": net, "optimizer": optimizer}


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
    """configs/fusion/synthetic_small.yaml built in Python, cut to 8
    frames."""
    return Config({
        "SETTINGS": {"num_workers": 0, "experiment_path": path,
                     "save_mode": "test", "eval_freq": 16, "log_freq": 8,
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
    optimizer built in Python:
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
    cfg.SETTINGS.update(save_mode="test", num_workers=0)
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


# -- phase 14: the per-frame step, the flat path, FusionNet v1/v2, classic --

def host_batches(frames, scene: str, input_key: str):
    """A (T, ...) device frame dict as the loader's host batches."""
    host = {k: v.cpu().numpy() for k, v in frames.items()}
    names = {"depth": input_key}
    return [{names.get(k, k): v[i:i + 1] for k, v in host.items()
             if k != "depth_input"} | {"frame_id": [f"{scene}/{i}"]}
            for i in range(len(host["depth"]))]


def per_frame_fuse(dev, pipe, frames, db):
    """Phase 14a: ``Pipeline.fuse`` a frame at a time into the Database;
    every frame enters slot form, runs one row step with a full shadow
    build (K2) and exits (K3, K4). Returns the launch counts."""
    batches = host_batches(frames, db.scenes[0], pipe.config.DATA.input)
    pipe.fuse(batches[0], db)                                  # warm-up
    db.reset()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for b in batches:
        pipe.fuse(b, db)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    n = len(batches)
    log(f"14a per-frame fuse (448^3, 256x256, v3 gf 6 + AdapNet++ stage 2, "
        f"bf16 nets, bf16 geo, through the Database): {n} frames in "
        f"{dt:.3f} s = {n / dt:.2f} frames/s; launches {counts}")
    check_volume(db.volumes[db.scenes[0]], "per-frame fuse volume")
    for k in ("build_shadow", "reconcile_slot", "reconcile_key"):
        if counts[k] != n:
            raise RuntimeError(f"per-frame fuse: {k} launched {counts[k]} "
                               f"times for {n} frames")
    return counts


def rows_against_scalar(dev, base, chunks, net_dtype: str):
    """The 16 frames through the scalar path (f16packed gathers) and the
    row path (f32 geo, frame_block 1, semantics every frame), the nets in
    ``net_dtype``: (max |dw|, max |dnum|, voxels past atol 1e-4 + rtol
    1e-4, observed voxels, keys differing, the row run's launch
    counts)."""
    outs = []
    for integration in ("scalar", "rows"):
        cfg = copy.deepcopy(base.config)
        cfg.FUSION_MODEL.compute_dtype = net_dtype
        cfg.SETTINGS.update(integration=integration, frame_block=1,
                            sem_integrate_every=1, geo_dtype="float32",
                            gather_precision="f16packed")
        pipe = Pipeline(cfg, segmenter=base.segmenter, device=dev,
                        fusion_net=copy.deepcopy(base.fusion_net))
        if integration == "scalar":
            vol = headline_volume(dev)
            for c in chunks:
                vol = pipe.fuse_sequence(vol, c)
            outs.append(vol)
        else:
            vol, counts, _, _ = run_stream(pipe, headline_volume(dev), chunks)
            outs.append(vol)
    v, ref = outs
    dw = (v.weights - ref.weights).abs()
    dn = (v.num - ref.num).abs()
    over = ((dw > 1e-4 + 1e-4 * ref.weights.abs())
            | (dn > 1e-4 + 1e-4 * ref.num.abs()))
    return (float(dw.max()), float(dn.max()), int(over.sum()),
            int((ref.weights > 0).sum()), int((v.semkey != ref.semkey).sum()),
            counts)


def scalar_path(dev, base, frames):
    """Phase 14b: SETTINGS.integration scalar at 448^3, two chunks of 8
    through ``fuse_sequence`` with each gather precision, timed; the
    packing pass timed alone. Then the same 16 frames through the row path
    (f32 geo, frame_block 1, semantics every frame) against the scalar
    path with f16packed gathers (the same bf16 words feed both nets), as
    tests/test_rowvol.py:201-202 compares them: with f32 nets (TF32 off)
    num and w within atol 1e-4 + rtol 1e-4 and the keys exact. With the
    headline's bf16 nets the bound does not hold: the two paths sum the
    geo state in another order, so a packed bf16 word now and then rounds
    one ulp apart, and a bf16 net turns that into an output one bf16 ulp
    apart (~4e-4 at 0.1), which the next frames integrate. That run is
    held to an explicit bound instead: keys exact, at most 1% of the
    observed voxels past the f32 bound and |dnum| below 0.02 (measured on
    an H100 in three runs: 20,835 to 21,668 of 7,659,821 observed voxels,
    0.27-0.28%, |dnum| 1.08e-3 to 1.30e-3; with f32 nets none past the
    bound, |dnum| 1.59e-5).
    Returns the row runs' launch counts."""
    chunks = [{k: v[i:i + 8] for k, v in frames.items()} for i in (0, 8)]
    vol = None
    for gather in ("f16packed", "f32"):
        cfg = copy.deepcopy(base.config)
        cfg.SETTINGS.update(integration="scalar", gather_precision=gather)
        pipe = Pipeline(cfg, segmenter=base.segmenter,
                        fusion_net=base.fusion_net, device=dev)
        del vol
        vol = pipe.fuse_sequence(headline_volume(dev), chunks[0])   # warm-up
        vol = headline_volume(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in chunks:
            vol = pipe.fuse_sequence(vol, c)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"14b scalar path, gather_precision {gather} (448^3, 256x256, "
            f"frame_block 4 and sem every 8 unused, bf16 nets): 16 frames "
            f"in {dt:.3f} s = {16 / dt:.2f} frames/s")
        check_volume(vol, f"scalar {gather} volume")
    pack_ms = cuda_ms(lambda: geometry.pack16_numw(vol.num, vol.weights), 10)
    log(f"  the packing pass over 448^3 (pack16_numw, once a flat frame "
        f"with f16packed): {pack_ms:.3f} ms; bound "
        f"{bytes_ms(3 * 4 * vol.num.numel()):.3f} ms (bytes)")
    del vol
    counts = {}
    for net_dtype in ("float32", "bfloat16"):
        dw, dn, over, observed, keys_off, c = rows_against_scalar(
            dev, base, chunks, net_dtype)
        log(f"  scalar (f16packed) against the row path, {net_dtype} nets: "
            f"max |dw| {dw:.3g}, max |dnum| {dn:.3g}, voxels past atol 1e-4 "
            f"+ rtol 1e-4: {over} of {observed} observed, keys differing "
            f"{keys_off}; row launches {c}")
        require(c, ["build_shadow_dirty", "reconcile_slot", "reconcile_key"],
                "scalar comparison's row path")
        counts = {k: counts.get(k, 0) + n for k, n in c.items()}
        ok = keys_off == 0 and observed > 0 and (
            over == 0 if net_dtype == "float32"
            else over <= 1e-2 * observed and dn < 0.02)
        if not ok:
            raise RuntimeError(f"the scalar and row paths disagree at 448^3 "
                               f"({net_dtype} nets)")
    return counts


def small_flat_reference(dev):
    """Phase 14c: phase 6's stream (64^3, 32x32, 6 frames, f32 nets, TF32
    off) through the flat ``fuse_sequence`` and through per-frame
    ``fuse`` steps (the row path), each on the card and on the CPU;
    phase 6's tolerances (tests/test_torch_pipeline.py)."""
    cfg = headline_config(32, 32)
    cfg.FUSION_MODEL.update(growth_factor=2, compute_dtype="float32")
    cfg.SEMANTIC_2D_MODEL.compute_dtype = "float32"
    cfg.SETTINGS.update(frame_block=1, sem_integrate_every=1,
                        geo_dtype="float32")
    frames = render_frames(6, 32, 32, "cpu")
    for what in ("scalar fuse_sequence", "per-frame fuse"):
        c = copy.deepcopy(cfg)
        if what.startswith("scalar"):
            c.SETTINGS.integration = "scalar"
        cpu_pipe = build_pipeline(c, "cpu", seed=3)
        seg = SegmenterAdapter(copy.deepcopy(cpu_pipe.segmenter.model).to(dev))
        gpu_pipe = Pipeline(c, segmenter=seg, device=dev,
                            fusion_net=copy.deepcopy(cpu_pipe.fusion_net))
        outs = []
        for pipe, d in ((cpu_pipe, "cpu"), (gpu_pipe, dev)):
            vol = headline_volume(d, (64, 64, 64))
            fr = {k: v.to(d) for k, v in frames.items()}
            if what.startswith("scalar"):
                vol = pipe.fuse_sequence(vol, fr)
            else:
                for i in range(6):
                    vol = pipe.step_fuse_impl(
                        vol, {k: x[i:i + 1] for k, x in fr.items()})
            outs.append(vol)
        ref, got = outs
        rw, gw = ref.weights, got.weights.cpu()
        obs = rw > 0.05
        t_err = float((got.tsdf.cpu()[obs] - ref.tsdf[obs]).abs().max())
        lab = ref.semkey > 0
        share = float((got.semantics.cpu()[lab] == ref.semantics[lab])
                      .float().mean())
        log(f"14c {what} (card vs CPU, 64^3, 6 frames): max |dw| "
            f"{float((gw - rw).abs().max()):.3g}, max |dtsdf| {t_err:.3g} on "
            f"{int(obs.sum())} voxels, semantic id agreement {share:.4f}")
        if not (torch.allclose(gw, rw, atol=1e-3, rtol=1e-3)
                and t_err <= 1e-3 and int(obs.sum()) > 1000
                and share >= 0.99):
            raise RuntimeError(f"{what}: card and CPU disagree")


def flat_training(dev, db):
    """Phase 14d: ``fuse_training`` at phase 9's width (448^3, 256x256, v3
    gf 6 + semantic head, bf16 on f32 master weights, gt labels), 8
    frames through the Database, one rmsprop step (phase 9's optimizer)
    after each; a warm-up frame first."""
    cfg = train_config()
    net = seeded_init(build_fusion_net(cfg.FUSION_MODEL),
                      torch.Generator().manual_seed(0))
    pipe = Pipeline(cfg, fusion_net=net, device=dev, train=True)
    opt_cfg = cfg.TRAINING.optimizer
    optimizer = get_optimizer(opt_cfg, pipe.fusion_net, get_schedule(
        float(opt_cfg.lr), cfg.TRAINING.scheduler), clipping=True)
    batches = host_batches(with_labels(render_frames(9, 256, 256, dev)),
                           db.scenes[0], cfg.DATA.input)
    db.reset()
    params0 = [p.detach().clone() for p in pipe.fusion_net.parameters()]
    stats0 = running_stats(pipe.fusion_net)

    def step(b):
        optimizer.zero_grad()
        loss = pipe.fuse_training(b, db)
        optimizer.step()
        return float(loss)
    step(batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    losses = [step(b) for b in batches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    moved_p = max(float((p.detach() - q).abs().max())
                  for p, q in zip(pipe.fusion_net.parameters(), params0))
    moved_s = float((running_stats(pipe.fusion_net) - stats0).abs().max())
    vol = db.volumes[db.scenes[0]]
    log(f"14d fuse_training (448^3, 256x256, v3 gf 6 + semantic head, bf16 "
        f"on f32 master weights, rmsprop a frame): 8 frames in {dt:.3f} s "
        f"= {8 / dt:.2f} training frames/s; peak device memory "
        f"{peak:.2f} GiB; losses {losses}; largest parameter move "
        f"{moved_p:.3g}, running statistics {moved_s:.3g}")
    if (not all(np.isfinite(losses)) or moved_p == 0 or moved_s == 0
            or not bool(torch.isfinite(vol.num).all())
            or int((vol.weights > 0).sum()) == 0):
        raise RuntimeError("fuse_training: non-finite loss or volume, or "
                           "the weights did not move")


def flat_train_entry_point(dev):
    """Phase 14d, continued: ``train_fusion`` on synthetic_small with
    ``use_sequence: false`` and ``accumulation_steps: 2`` (1 epoch, 8
    frames; its validation ``fuse_many`` runs K1/K3/K4), then its
    best.ckpt through ``test_fusion`` with ``sequence_chunk: 1`` on the
    configuration of synthetic_tpu_demo_joint.yaml (16 frames, 84x88x84,
    semantics: K2/K3/K4 a frame, K5 once) with synthetic_small's net.
    Returns the launch counts."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_flat_") as path:
        cfg = synthetic_small_config(path)
        cfg.TRAINING.optimization.update(use_sequence=False,
                                         accumulation_steps=2)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        net, ws = train_fusion(cfg, dev)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        tcfg = demo_joint_config(os.path.join(path, "test"))
        tcfg.FUSION_MODEL = copy.deepcopy(cfg.FUSION_MODEL)
        tcfg.TESTING.update(sequence_chunk=1, fusion_model_path=os.path.join(
            ws.model_path, "best.ckpt"))
        t0 = time.perf_counter()
        results = entry.test_fusion(tcfg, dev)
        torch.cuda.synchronize()
        counts = read_counts()
        with open(os.path.join(ws.log_path, "train.log")) as f:
            log_lines = [line.strip() for line in f if ": loss " in line]
    log(f"14d train_fusion, use_sequence false, accumulation_steps 2 "
        f"(synthetic_small, 8 frames of 48x48): {t_train:.3f} s; "
        f"{log_lines}; test_fusion from its best.ckpt, sequence_chunk 1 "
        f"(demo_joint, 16 frames): {time.perf_counter() - t0:.3f} s "
        f"{json.dumps(results)}; launches {counts}")
    bad = [k for k, v in results.items() if not np.isfinite(v)]
    if bad or len(results) != 9:
        raise RuntimeError(f"test_fusion (per frame): missing or non-finite "
                           f"metrics {bad or results}")
    require(counts, ["build_shadow_dirty", "build_shadow", "reconcile_slot",
                     "reconcile_key", "median_filter3d"],
            "flat train_fusion and per-frame test_fusion")
    if counts["build_shadow"] != 16:
        raise RuntimeError(f"per-frame test_fusion: {counts['build_shadow']}"
                           " full shadow builds for 16 frames")
    return counts


def demo_joint_config(path: str):
    """configs/fusion/synthetic_tpu_demo_joint.yaml built in Python, cut
    to 16 frames (phase 8's configuration)."""
    cfg = default_config()
    cfg.SETTINGS.update(save_mode="test", num_workers=0,
                        experiment_path=path)
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
    return cfg


def fusion_nets(dev, hw: int = 256):
    """Phase 14e: FusionNet v1, v2 (growth factor 6) and a stack_heads v3
    with the semantic input at 256x256, 9 points: the f32 forward (TF32
    off) on the card against the CPU (atol 1e-4), one train-mode step of
    each on the card (SGD, dropout from the net's generator); then v2 in
    bf16 through ``fuse_sequence_rows`` for one chunk of 8 at 448^3.
    Returns that chunk's launch counts."""
    g = torch.Generator().manual_seed(11)
    data = {"tsdf_values": torch.randn(1, hw, hw, 9, generator=g) * 0.05,
            "tsdf_weights": torch.rand(1, hw, hw, 9, generator=g) * 3,
            "tsdf_frame": torch.rand(1, hw, hw, 1, generator=g) * 3,
            "semantic_frame": torch.rand(1, hw, hw, 1, generator=g)}
    for name, extra in (("v1", {}), ("v2", {}), ("v3", {"stack_heads": True})):
        cfg = Config({"name": name, "n_points": 9, "use_semantics": True,
                      "output_scale": 1.0, "growth_factor": 6, **extra})
        net = seeded_init(build_fusion_net(cfg), torch.Generator()
                          .manual_seed(5)).eval()
        with torch.no_grad():
            want = net(data)
            card = copy.deepcopy(net).to(dev)
            got = card({k: v.to(dev) for k, v in data.items()}).cpu()
        err = float((got - want).abs().max())
        card.train().set_dropout_generator(
            torch.Generator(device=dev).manual_seed(1))
        opt = get_optimizer(Config({"name": "sgd", "momentum": 0.9}), card,
                            get_schedule(1e-3, None))
        before = [p.detach().clone() for p in card.parameters()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = card({k: v.to(dev) for k, v in data.items()})
        loss = out.square().mean()
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        moved_p = max(float((p.detach() - q).abs().max())
                      for p, q in zip(card.parameters(), before))
        log(f"14e FusionNet {name}{' stack_heads' if extra else ''} ({hw}x{hw}, "
            f"9 points, semantic input, {sum(p.numel() for p in net.parameters())}"
            f" parameters): f32 forward card vs CPU max |d| {err:.3g}; one "
            f"train-mode SGD step {1e3 * dt:.1f} ms, loss "
            f"{float(loss.detach()):.5g}, largest parameter move "
            f"{moved_p:.3g}")
        if not (err <= 1e-4 and torch.isfinite(loss) and moved_p > 0):
            raise RuntimeError(f"FusionNet {name}: card and CPU disagree, or "
                               "its train step failed")
    cfg = headline_config()
    cfg.FUSION_MODEL.name = "v2"
    pipe = build_pipeline(cfg, dev, seed=7)
    frames = render_frames(8, 256, 256, dev)
    out, counts, t_fuse, _ = run_stream(pipe, headline_volume(dev), [frames])
    log(f"14e v2 through fuse_sequence_rows (448^3, 256x256, headline "
        f"settings): 8 frames in {t_fuse:.3f} s = {8 / t_fuse:.2f} frames/s;"
        f" launches {counts}")
    check_volume(out, "v2 volume")
    require(counts, ["build_shadow_dirty", "reconcile_slot",
                     "reconcile_key"], "v2 fuse_sequence_rows")
    return counts


def classic_fusion(dev, n: int = 256, hw: int = 256,
                   wall_res: float = 0.01):
    """Phase 14f: the classic fusion on the card against the CPU. The
    TSDFVolume / MulticlassTSDFVolume API on tests/test_tsdf_volume_api.py's
    wall (two fuses, sanity_fuse, label votes, depth_rendering);
    ``tsdf_from_depth_views`` at 256^3 over 8 views of the synthetic room
    (256x256); ``distance_transform`` and ``tvl1_refine`` at 128^3.
    Elementwise: values within 1e-5 on all but 0.1% of the voxels (a
    projection within an ulp of a pixel edge may round to the next
    pixel; tests/test_torch_classic.py), distances within 1e-4 (integer
    sums), TV-L1 within 1e-5."""
    def compare(what, got, want, atol=1e-5, share=1e-3):
        got = torch.as_tensor(np.asarray(got)).double()
        want = torch.as_tensor(np.asarray(want)).double()
        d = (got - want).abs()
        far = float((d > atol).double().mean())
        log(f"    {what}: max |d| {float(d.max()):.3g}, share past "
            f"{atol:g}: {far:.3g}")
        if far > share:
            raise RuntimeError(f"classic fusion: {what} card vs CPU")

    bbox = np.array([[-1.0, 1.0], [-1.0, 1.0], [0.0, 3.0]])
    h = w = hw
    f = 0.6 * w
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    depth = np.full((h, w), 2.0, np.float32)
    proj = (k @ np.eye(4)[:3]).astype(np.float32)
    labels = np.full((h, w), 3, np.uint8)
    labels[:, : w // 2] = 5
    res = {}
    for d in ("cpu", dev):
        t0 = time.perf_counter()
        mc = ctv.MulticlassTSDFVolume(bbox, wall_res, n_classes=8,
                                      max_distance=0.05, device=d)
        mc.fuse(proj, depth, labels)
        mc.fuse(proj, depth * np.float32(1.01), labels[::-1])
        mc.sanity_fuse(proj, depth)
        res[str(d)] = (mc.volume, mc.weights, mc.free_space, mc.get_mask(),
                       mc.label_probs, mc.labels,
                       mc.depth_rendering(np.eye(4, dtype=np.float32), k,
                                          (h, w)), time.perf_counter() - t0)
    log(f"14f MulticlassTSDFVolume at {mc.shape} (wall, {hw}x{hw}): card "
        f"{res[str(dev)][-1]:.3f} s, CPU {res['cpu'][-1]:.3f} s")
    for name, a, b in zip(("tsdf", "weights", "free space", "mask",
                           "label probabilities", "labels", "rendered depth"),
                          res[str(dev)], res["cpu"]):
        compare(name, a, b)

    frames = render_frames(8, hw, hw, "cpu")
    kk = frames["intrinsics"][0].double()
    projs = torch.stack([(kk @ torch.linalg.inv(e.double())[:3]).float()
                         for e in frames["extrinsics"]])
    shape, origin, vres = (n,) * 3, [-2.24] * 3, 4.48 / n
    views = {}
    for d in ("cpu", dev):
        tsdf_from_depth_views(frames["depth"], projs, shape, origin, vres,
                              0.05, device=d)           # warm-up
        if d != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        views[str(d)] = [t.cpu() for t in tsdf_from_depth_views(
            frames["depth"], projs, shape, origin, vres, 0.05, device=d)]
        views[str(d) + "_s"] = time.perf_counter() - t0
    log(f"14f tsdf_from_depth_views ({n}^3, 8 views of {hw}x{hw}): card "
        f"{views[str(dev) + '_s']:.3f} s, CPU {views['cpu_s']:.3f} s; "
        f"observed voxels {int((views['cpu'][1] > 0).sum())}")
    compare("tsdf", views[str(dev)][0], views["cpu"][0])
    compare("weights", views[str(dev)][1], views["cpu"][1])

    occ = (torch.rand((n // 2,) * 3,
                      generator=torch.Generator().manual_seed(2))
           > 0.999).float()
    tsdf = torch.clamp(views["cpu"][0][::2, ::2, ::2].contiguous(), -1, 1)
    wts = views["cpu"][1][::2, ::2, ::2].contiguous()
    for name, fn, atol in (
            ("distance_transform",
             lambda d: cdt.distance_transform(
                 torch.where(occ > 0, 0.0, cdt.INF).to(d)), 1e-4),
            ("occupancy_to_sdf",
             lambda d: cdt.occupancy_to_sdf(occ.to(d), 0.035), 1e-5),
            ("tvl1_refine",
             lambda d: ctvl1.tvl1_refine(tsdf.to(d), wts.to(d)), 1e-5)):
        want = fn("cpu")
        fn(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(dev)
        torch.cuda.synchronize()
        log(f"14f {name} at {n // 2}^3: card "
            f"{time.perf_counter() - t0:.3f} s")
        compare(name, got.cpu(), want, atol=atol, share=0.0)


def phase14(dev):
    """Phase 14 (a-f); returns the main-path launch counts."""
    t_all = time.perf_counter()
    cfg = headline_config()
    base = build_pipeline(cfg, dev)
    frames = render_frames(16, 256, 256, dev)
    t0 = time.perf_counter()
    db = Database(HeadlineRoom(), cfg.DATA, device=dev)
    counts = per_frame_fuse(dev, base, {k: v[:8] for k, v in frames.items()},
                            db)
    log(f"  14a: {time.perf_counter() - t0:.1f} s")
    for name, run in (("14b", lambda: scalar_path(dev, base, frames)),
                      ("14c", lambda: small_flat_reference(dev)),
                      ("14d", lambda: flat_training(dev, db)),
                      ("14d train_fusion", lambda: flat_train_entry_point(
                          dev)),
                      ("14e", lambda: fusion_nets(dev)),
                      ("14f", lambda: classic_fusion(dev))):
        t0 = time.perf_counter()
        more = run()
        torch.cuda.empty_cache()
        log(f"  {name}: {time.perf_counter() - t0:.1f} s")
        for k, n in (more or {}).items():
            counts[k] += n
    del db, base
    torch.cuda.empty_cache()
    log(f"phase 14: {time.perf_counter() - t_all:.1f} s")
    return counts


# -- phase 15: the parallel runners -------------------------------------------

MULTI_SHAPE = (320, 320, 320)       # bench.py multi512: 3.2 m at 1 cm


def stacked_slot_states(L, geo_dtype, dev, S, seed=0):
    """S reachable slot states (``slot_state``) stacked: (S, geo_rows,
    128) geo and (S, key_rows, 128) keys."""
    geos, keys = zip(*[slot_state(L, geo_dtype, dev, seed=seed + s)
                       for s in range(S)])
    return torch.stack(geos), torch.stack(keys)


def folded_kernels(dev):
    """Phase 15a: K1-K4 through the scene-folded entry points (one launch
    on X' = S * X) on S=2 scenes of 320^3 f32 geo (multi512's layout) and
    S=3 of 84^3 bf16 (ragged): bit-exact against the per-scene calls and
    against the plain versions on the folded layout; K1 also with an
    unbatched carry (one shadow and one mask for all scenes). Folded
    K1-K4 timed at 320^3. Returns the folded results for the kernels
    line."""
    results = {}
    for shape, S, geo_dtype in ((MULTI_SHAPE, 2, torch.float32),
                                ((84, 84, 84), 3, torch.bfloat16)):
        tag = f"S={S} x {shape[0]}^3 {str(geo_dtype)[6:]}"
        L = rowvol.RowLayout.for_shape(shape)
        Lf = L._replace(X=S * L.X)
        ty, nj = rowvol.shadow_tiling(L)
        geo, keys = stacked_slot_states(L, geo_dtype, dev, S)
        geo_f = geo.view(S * L.geo_rows, 128)
        g = torch.Generator(device=dev).manual_seed(7)
        prev = torch.randint(-2 ** 31, 2 ** 31 - 1, (S, L.shadow_rows, 128),
                             generator=g, device=dev, dtype=torch.int32)
        dirty = (torch.rand((S, L.X * nj + 1), generator=g, device=dev)
                 < 0.5).int()
        dirty[:, -1] = 0
        flags = torch.cat([dirty[:, :-1].reshape(-1), dirty[0, -1:]])

        def per_scene(fn):
            return torch.stack([fn(s) for s in range(S)])

        full = sb.build_shadow_v(geo, L, ty)
        d_k = sb.build_shadow_dirty_v(geo, prev.clone(), dirty, L, ty)
        u_k = sb.build_shadow_dirty_v(geo, prev[0].clone(), dirty[0].clone(),
                                      L, ty)
        num_k, w_k = sb.reconcile_slot_v(geo, L)
        key_k = sb.reconcile_key_v(keys, L)
        got = {
            "build_shadow": (full, per_scene(
                lambda s: sb.build_shadow(geo[s], L, ty)),
                sb.build_shadow_plain(geo_f, Lf).view_as(full)),
            "build_shadow_dirty": (d_k, per_scene(
                lambda s: sb.build_shadow_dirty(geo[s], prev[s].clone(),
                                                dirty[s].contiguous(), L,
                                                ty)),
                sb.build_shadow_dirty_plain(
                    geo_f, prev.clone().view(-1, 128), flags, Lf,
                    ty).view_as(d_k)),
            "build_shadow_dirty (unbatched carry)": (u_k, per_scene(
                lambda s: sb.build_shadow_dirty(geo[s], prev[0].clone(),
                                                dirty[0].contiguous(), L,
                                                ty)), None),
            "reconcile_slot": (torch.stack([num_k, w_k]), torch.stack([
                per_scene(lambda s: sb.reconcile_slot(geo[s], L)[i])
                for i in (0, 1)]), torch.stack([
                    a.view(S, L.X, L.Y, L.Z)
                    for a in sb.reconcile_slot_plain(geo_f, Lf)])),
            "reconcile_key": (key_k, per_scene(
                lambda s: sb.reconcile_key(keys[s], L)),
                sb.reconcile_key_plain(keys.view(-1, 128), Lf).view_as(
                    key_k)),
        }
        torch.cuda.synchronize()
        log(f"15a folded kernels, {tag} (X' = {Lf.X}, "
            f"{geo.numel() / 2 ** 30:.3f} G geo elements):")
        for name, (k, per, plain) in got.items():
            bits = k.view(torch.int32) if k.is_floating_point() else k
            exact = (torch.equal(bits, per.view(bits.dtype))
                     and (plain is None
                          or torch.equal(bits, plain.view(bits.dtype))))
            err = max(max_abs(k, per),
                      0.0 if plain is None else max_abs(k, plain))
            log(f"  {name:38s} exact against the per-scene calls"
                f"{'' if plain is None else ' and the plain version'}="
                f"{exact} max_abs_err={err}")
            if not exact:
                raise RuntimeError(f"folded {name} ({tag}) disagrees")
            if shape == MULTI_SHAPE and name in sb.launch_counts():
                results[name] = {"max_abs_err_folded": err}
        del got, full, d_k, u_k, num_k, w_k, key_k
        if shape != MULTI_SHAPE:
            continue
        scratch = prev.clone()
        geo_b = geo.numel() * geo.element_size()
        key_b = keys.numel() * 4
        vox = S * L.X * L.Y * L.Z
        frac = float(dirty[:, :-1].float().mean())
        runs = {
            "build_shadow": (lambda: sb.build_shadow_v(geo, L, ty),
                             geo_b + key_b),
            "build_shadow_dirty": (lambda: sb.build_shadow_dirty_v(
                geo, scratch, dirty, L, ty), frac * (geo_b + key_b)),
            "reconcile_slot": (lambda: sb.reconcile_slot_v(geo, L),
                               geo_b + 8 * vox),
            "reconcile_key": (lambda: sb.reconcile_key_v(keys, L),
                              key_b + 4 * vox),
        }
        for name, (fn, moved) in runs.items():
            ms = cuda_ms(fn, 20)
            b_ms = bytes_ms(moved)
            log(f"  {name:20s} folded {ms:.4f} ms ({moved / ms / 1e6:.1f} "
                f"GB/s of minimum traffic, bound {b_ms:.4f} ms, "
                f"{b_ms / ms:.3f} of the bound"
                + (f"; dirty fraction {frac:.3f}"
                   if name == "build_shadow_dirty" else "") + ")")
            results[name].update(ms_folded=ms, bound_ms_folded=b_ms)
        del geo, keys, prev, scratch, geo_f
        torch.cuda.empty_cache()
    return results


def folded_past_2_31(dev):
    """Phase 15a: the fold past 2^31 geo elements, S=3 scenes of 448^3
    f32 geo (3 x 725.7 M): folded K2, K1 (a fresh stream's unbatched
    all-dirty carry), K3 and K4 bit-exact against the per-scene calls, a
    scene at a time (the kernels index with 64-bit element offsets)."""
    S = 3
    L = rowvol.RowLayout.for_shape(HEADLINE_SHAPE)
    ty, nj = rowvol.shadow_tiling(L)
    geo, keys = stacked_slot_states(L, torch.float32, dev, S, seed=11)
    ok = {}
    out = sb.build_shadow_v(geo, L, ty)
    ok["build_shadow"] = all(torch.equal(out[s], sb.build_shadow(
        geo[s], L, ty)) for s in range(S))
    del out
    prev = torch.zeros((L.shadow_rows, 128), dtype=torch.int32, device=dev)
    dirty = torch.ones(L.X * nj + 1, dtype=torch.int32, device=dev)
    dirty[-1] = 0
    out = sb.build_shadow_dirty_v(geo, prev, dirty, L, ty)
    ok["build_shadow_dirty"] = all(torch.equal(out[s], sb.build_shadow_dirty(
        geo[s], prev.clone(), dirty, L, ty)) for s in range(S))
    del out
    num, w = sb.reconcile_slot_v(geo, L)
    ok["reconcile_slot"] = all(
        torch.equal(a[s].view(torch.int32), b.view(torch.int32))
        for s in range(S)
        for a, b in zip((num, w), sb.reconcile_slot(geo[s], L)))
    del num, w
    out = sb.reconcile_key_v(keys, L)
    ok["reconcile_key"] = all(torch.equal(out[s], sb.reconcile_key(
        keys[s], L)) for s in range(S))
    torch.cuda.synchronize()
    log(f"15a folded kernels past 2^31, S=3 x 448^3 float32 ({geo.numel()} "
        f"geo elements, 2^31 = {2 ** 31}): exact against the per-scene "
        f"calls {ok}")
    if geo.numel() <= 2 ** 31 or not all(ok.values()):
        raise RuntimeError("the fold past 2^31 elements disagrees")
    del geo, keys, out
    torch.cuda.empty_cache()


def multi_config(h: int, w: int, net_dtype: str = "bfloat16"):
    """``bench.py`` multi512's settings: the headline's nets (AdapNet++
    stage 2 predicting + FusionNet v3 gf 6 with the semantic head), f32
    geo, frame_block 1, semantics every frame, the dirty carry on."""
    cfg = headline_config(h, w)
    cfg.FUSION_MODEL.compute_dtype = net_dtype
    cfg.SEMANTIC_2D_MODEL.compute_dtype = net_dtype
    cfg.SETTINGS.update(frame_block=1, sem_integrate_every=1,
                        geo_dtype="float32", dirty_shadow="on")
    return cfg


def multi_frames(S: int, n: int, h: int, w: int, dev, reps: int = 1):
    """(S, n * reps, ...) frames: scene s renders SyntheticScene(seed=s,
    half=1.5) from n poses, repeated ``reps`` times."""
    per = [render_frames(n, h, w, dev, scene=SyntheticScene(seed=s, half=1.5))
           for s in range(S)]
    return {k: torch.stack([torch.cat([p[k]] * reps) for p in per])
            for k in per[0]}


def multi_volumes(S: int, shape, dev):
    return stack_volumes([init_scene_volume(shape, [-1.6] * 3,
                                            3.2 / shape[0], 0.1, device=dev)
                          for _ in range(S)])


def one_after_the_other(pipe, frames, passes: int, shape, dev):
    """Each scene's stream through ``fuse_sequence`` ``passes`` times,
    scene after scene; (volumes, seconds of the last pass over all
    scenes)."""
    vols = [init_scene_volume(shape, [-1.6] * 3, 3.2 / shape[0], 0.1,
                              device=dev) for _ in range(frames["depth"].shape[0])]
    dt = 0.0
    for p in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vols = [pipe.fuse_sequence(v, {k: x[s] for k, x in frames.items()})
                for s, v in enumerate(vols)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    return vols, dt


class Agreement(NamedTuple):
    """Two runs' volumes over all scenes: max |dw|, max |dnum|; voxels
    whose w is past atol 1e-4 + rtol 1e-4, voxels whose num or w is;
    observed voxels (w > 0); on the voxels with w > 0.05, max |dtsdf| and
    the counts past 1e-3 and 1e-2; keys differing."""
    dw: float
    dn: float
    w_over: int
    over: int
    observed: int
    dtsdf: float
    tsdf_over_1e3: int
    tsdf_over_1e2: int
    keys_off: int


def folded_against_sequential(folded, seq) -> Agreement:
    dw = dn = dt = 0.0
    w_over = over = observed = t3 = t2 = keys_off = 0
    for v, ref in zip(folded, seq):
        a = (v.weights - ref.weights).abs()
        b = (v.num - ref.num).abs()
        dw, dn = max(dw, float(a.max())), max(dn, float(b.max()))
        wo = a > 1e-4 + 1e-4 * ref.weights.abs()
        w_over += int(wo.sum())
        over += int((wo | (b > 1e-4 + 1e-4 * ref.num.abs())).sum())
        observed += int((ref.weights > 0).sum())
        obs = ref.weights > 0.05
        t = (v.tsdf[obs] - ref.tsdf[obs]).abs()
        dt = max(dt, float(t.max()))
        t3 += int((t > 1e-3).sum())
        t2 += int((t > 1e-2).sum())
        keys_off += int((v.semkey != ref.semkey).sum())
    return Agreement(dw, dn, w_over, over, observed, dt, t3, t2, keys_off)


def agreement_text(a: Agreement) -> str:
    return (f"max |dw| {a.dw:.3g}, max |dnum| {a.dn:.3g}, voxels past atol "
            f"1e-4 + rtol 1e-4: {a.over} of {a.observed} observed (w alone: "
            f"{a.w_over}); tsdf where w > 0.05: max |dtsdf| {a.dtsdf:.3g}, "
            f"past 1e-3 {a.tsdf_over_1e3}, past 1e-2 {a.tsdf_over_1e2}; "
            f"keys differing {a.keys_off}")


def bf16_nets_agree(a: Agreement) -> bool:
    """The bound for the bf16-net comparison of 15b (see ``multi512``)."""
    return (a.keys_off == 0 and a.w_over == 0 and a.observed > 0
            and a.tsdf_over_1e3 <= 2e-2 * a.observed
            and a.tsdf_over_1e2 <= 1e-3 * a.observed and a.dtsdf <= 0.05)


def multi512(dev):
    """Phase 15b: ``bench.py`` multi512 at full width through
    ``SceneParallelFusion.run_sequences``: 2 scenes x 512x512, 320^3 at 1
    cm each, 8 rendered frames a scene repeated twice; a warm-up run,
    then one timed (aggregate frames/s, peak memory). The same streams
    fused one after the other through ``fuse_sequence`` (a figure, not a
    claim), and the two held together. With bf16 nets at full size: keys
    exact, weights within atol 1e-4 + rtol 1e-4 (geometry only: the
    atomics' order), and the tsdf (num / w where w > 0.05) within 1e-3 on
    all but 2% of the observed voxels, within 1e-2 on all but 0.1%, and
    within 0.05 everywhere: cuDNN's bf16 FusionNet gives a batch of two
    frames other outputs than one frame at a time (10.5% of them, by up to
    2e-4, on an H100), and the recurrence carries them (measured on an
    H100 in two runs: 66,006 and 67,606 past 1e-3, 801 and 867 past 1e-2
    of 8,227,908 observed voxels, max 0.0264). With f32 nets (TF32 off,
    cuDNN's deterministic algorithms: its default f32 AdapNet++ gives
    scores ~1e-8 apart from one call to the next) at 96^3 and 128x128, 4
    frames a scene twice: every voxel within atol 1e-4 + rtol 1e-4 and
    keys exact. Returns the launch counts of the runs."""
    cfg = multi_config(512, 512)
    pipe = build_pipeline(cfg, dev)
    frames = multi_frames(2, 8, 512, 512, dev, reps=2)
    n = frames["depth"].shape[0] * frames["depth"].shape[1]
    runner = SceneParallelFusion(pipe)
    vols = runner.run_sequences(multi_volumes(2, MULTI_SHAPE, dev), frames)
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vols = runner.run_sequences(vols, frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"15b multi512 (2 scenes x 512x512, 320^3 at 1 cm, AdapNet++ stage "
        f"2 + v3 gf 6, bf16 nets, f32 geo, frame_block 1, sem every frame, "
        f"dirty carry; mesh {len(runner.mesh.devices)} device): {n} frames "
        f"in {dt:.3f} s = {n / dt:.2f} aggregate frames/s; peak "
        f"{peak:.2f} GiB; launches {counts}")
    folded = unstack_volumes(vols, 2)
    for s, v in enumerate(folded):
        check_volume(v, f"multi512 scene {s}")
    require(counts, ["build_shadow_dirty", "reconcile_slot",
                     "reconcile_key"], "multi512")
    reset_counts()
    seq, dt_seq = one_after_the_other(pipe, frames, 2, MULTI_SHAPE, dev)
    more = read_counts()
    log(f"  the same streams one after the other through fuse_sequence: "
        f"{n} frames in {dt_seq:.3f} s = {n / dt_seq:.2f} frames/s "
        f"(folded / one after the other: {dt_seq / dt:.3f}); launches "
        f"{more}")
    agree = folded_against_sequential(folded, seq)
    log(f"  folded against one after the other, bf16 nets: "
        f"{agreement_text(agree)}")
    if not bf16_nets_agree(agree):
        raise RuntimeError("multi512: the folded run and the scenes one "
                           "after the other disagree (bf16 nets)")
    del vols, folded, seq, runner, pipe, frames
    torch.cuda.empty_cache()
    # the reduced f32 check
    cfg = multi_config(128, 128, "float32")
    pipe = build_pipeline(cfg, dev, seed=4)
    frames = multi_frames(2, 4, 128, 128, dev, reps=2)
    reset_counts()
    torch.backends.cudnn.deterministic = True
    try:
        folded = unstack_volumes(SceneParallelFusion(pipe).run_sequences(
            multi_volumes(2, (96, 96, 96), dev), frames), 2)
        seq, _ = one_after_the_other(pipe, frames, 1, (96, 96, 96), dev)
    finally:
        torch.backends.cudnn.deterministic = False
    c = read_counts()
    ids_off = sum(int((v.semantics != r.semantics).sum())
                  for v, r in zip(folded, seq))
    log(f"  f32 nets, cuDNN deterministic: semantic ids differing {ids_off}")
    agree = folded_against_sequential(folded, seq)
    log(f"  f32 nets, 96^3, 128x128, 2 x 8 frames: {agreement_text(agree)}")
    if not (agree.over == 0 and agree.keys_off == 0
            and agree.observed > 1000):
        raise RuntimeError("multi-scene fusion: the folded run and the "
                           "scenes one after the other disagree (f32 nets)")
    return {k: counts[k] + more[k] + c[k] for k in counts}


def small_streams():
    """Phase 6's small stream (64^3, 32x32, 6 frames) for two scenes, the
    second over SyntheticScene(seed=1): host frames, one list a scene."""
    fr = [render_frames(6, 32, 32, "cpu"),
          render_frames(6, 32, 32, "cpu",
                        scene=SyntheticScene(seed=1, half=2.2))]
    return [[{k: v[i].numpy() for k, v in f.items()} for i in range(6)]
            for f in fr]


def small_config():
    """Phase 6's configuration: f32 nets (TF32 off), the exact
    recurrence."""
    cfg = headline_config(32, 32)
    cfg.FUSION_MODEL.update(growth_factor=2, compute_dtype="float32")
    cfg.SEMANTIC_2D_MODEL.compute_dtype = "float32"
    cfg.SETTINGS.update(frame_block=1, sem_integrate_every=1,
                        geo_dtype="float32")
    return cfg


def card_and_cpu_pipelines(cfg, dev, seed=3):
    cpu_pipe = build_pipeline(cfg, "cpu", seed=seed)
    seg = SegmenterAdapter(copy.deepcopy(cpu_pipe.segmenter.model).to(dev))
    return cpu_pipe, Pipeline(cfg, segmenter=seg, device=dev,
                              fusion_net=copy.deepcopy(cpu_pipe.fusion_net))


def compare_small(what, ref, got):
    """Phase 6's tolerances: weights atol 1e-3 + rtol 1e-3, tsdf 1e-3
    where the weight passes 0.05, semantic ids on 99% of labelled
    voxels."""
    rw, gw = ref.weights.cpu(), got.weights.cpu()
    obs = rw > 0.05
    t_err = float((got.tsdf.cpu()[obs] - ref.tsdf.cpu()[obs]).abs().max())
    lab = ref.semkey.cpu() > 0
    share = float((got.semantics.cpu()[lab] == ref.semantics.cpu()[lab])
                  .float().mean())
    log(f"  {what}: max |dw| {float((gw - rw).abs().max()):.3g}, max "
        f"|dtsdf| {t_err:.3g} on {int(obs.sum())} voxels, semantic id "
        f"agreement {share:.4f}")
    if not (torch.allclose(gw, rw, atol=1e-3, rtol=1e-3) and t_err <= 1e-3
            and int(obs.sum()) > 1000 and share >= 0.99):
        raise RuntimeError(f"{what}: card and CPU disagree")


def small_runner(dev):
    """Phase 15c: ``SceneParallelFusion.run`` (a ``step`` a frame) over
    phase 6's stream for two scenes, on the row path and under
    ``integration: scalar``, on the card against the CPU. Returns the
    card runs' launch counts."""
    streams = small_streams()
    counts = {}
    for integration in ("rows", "scalar"):
        cfg = small_config()
        cfg.SETTINGS.integration = integration
        cpu_pipe, gpu_pipe = card_and_cpu_pipelines(cfg, dev)
        ref = SceneParallelFusion(cpu_pipe, scene_mesh(devices=["cpu"])).run(
            [headline_volume("cpu", (64, 64, 64)) for _ in range(2)],
            streams)
        torch.cuda.synchronize()
        reset_counts()
        got = SceneParallelFusion(gpu_pipe).run(
            [headline_volume(dev, (64, 64, 64)) for _ in range(2)], streams)
        torch.cuda.synchronize()
        c = read_counts()
        log(f"15c run/step, {integration}, 2 scenes (card vs CPU, 64^3, 6 "
            f"frames): launches {c}")
        for s in range(2):
            compare_small(f"scene {s}", ref[s], got[s])
        if integration == "rows":
            for k in ("build_shadow", "reconcile_slot", "reconcile_key"):
                if c[k] != 6:
                    raise RuntimeError(f"15c: {k} launched {c[k]} times "
                                       "for 6 folded steps")
        counts = {k: counts.get(k, 0) + n for k, n in c.items()}
    return counts


def sharded_kernels(dev):
    """Phase 15d: the four ``shard_kernels`` wrappers over 4 x-slabs of
    448^3 (bf16 geo) on the one card (mesh [cuda:0] x 4), bit-exact
    against the unsharded kernels; the dirty build (a random 0.5 mask
    into a random previous shadow) in place in each slab's shadow."""
    L = rowvol.RowLayout.for_shape(HEADLINE_SHAPE)
    ty, nj = rowvol.shadow_tiling(L)
    mesh = data_parallel_mesh("x", [dev] * 4)
    geo, keys = slot_state(L, torch.bfloat16, dev, seed=5)
    prev, dirty = random_shadow_and_mask(L, nj, dev, seed=6)
    sharded_prev = prev.clone()
    ok = {
        "build_shadow": torch.equal(
            torch.cat(shard_kernels.sharded_build_shadow(geo, L, mesh)),
            sb.build_shadow(geo, L, ty)),
        "build_shadow_dirty": (
            shard_kernels.sharded_build_shadow_dirty(
                geo, sharded_prev, dirty, L, mesh) is not None
            and torch.equal(sharded_prev, sb.build_shadow_dirty(
                geo, prev.clone(), dirty, L, ty))),
        "reconcile_slot": all(
            torch.equal(torch.cat(a).view(torch.int32), b.view(torch.int32))
            for a, b in zip(shard_kernels.sharded_reconcile_slot(geo, L,
                                                                 mesh),
                            sb.reconcile_slot(geo, L))),
        "reconcile_key": torch.equal(
            torch.cat(shard_kernels.sharded_reconcile_key(keys, L, mesh)),
            sb.reconcile_key(keys, L)),
    }
    torch.cuda.synchronize()
    log(f"15d shard_kernels, 4 x-slabs of 448^3 bf16 on one card: "
        f"{ok}")
    if not all(ok.values()):
        raise RuntimeError("sharded kernels disagree with the unsharded")


def spatial(dev):
    """Phase 15e: ``SpatialShardedFusion`` ``step`` (6 frames) and
    ``fuse_sequence`` over 2 x-slabs on the card (mesh [cuda:0] x 2)
    against the unsharded pipeline on the card, phase 6's stream, on the
    row path and under ``integration: scalar``: num within
    tests/test_spatial_sharding.py's 1e-3 and keys exact; weights within
    its atol 1e-4 plus rtol 1e-5, for the card's float atomics sum a
    voxel's updates in any order (the flat path's unsharded step against
    itself is printed beside it; measured on an H100: the sharded flat
    step 2.44e-4 from the unsharded one, the row path 6.1e-5; the CPU
    tests hold both bit-exact). Returns the sharded row runs' launch
    counts."""
    frames = render_frames(6, 32, 32, dev)
    counts = {}
    for integration in ("rows", "scalar"):
        cfg = small_config()
        cfg.SETTINGS.integration = integration
        pipe = build_pipeline(cfg, dev, seed=3)
        runner = SpatialShardedFusion(pipe,
                                      data_parallel_mesh("x", [dev] * 2))
        torch.cuda.synchronize()
        reset_counts()
        slabs = runner.shard(headline_volume(dev, (64, 64, 64)))
        for i in range(6):
            slabs = runner.step(slabs, {k: x[i] for k, x in frames.items()})
        stepped = unshard_volume_spatial(slabs)
        streamed = unshard_volume_spatial(runner.fuse_sequence(
            runner.shard(headline_volume(dev, (64, 64, 64))), frames))
        torch.cuda.synchronize()
        c = read_counts()
        refs = []
        for _ in range(2):
            ref = headline_volume(dev, (64, 64, 64))
            for i in range(6):
                ref = pipe.step_fuse_impl(ref, {k: x[i:i + 1]
                                                for k, x in frames.items()})
            refs.append(ref)
        spread = float((refs[0].weights - refs[1].weights).abs().max())
        ref_seq = pipe.fuse_sequence(headline_volume(dev, (64, 64, 64)),
                                     frames)
        for what, v, r in (("step", stepped, refs[0]),
                           ("fuse_sequence", streamed, ref_seq)):
            dw = (v.weights - r.weights).abs()
            w_ok = bool((dw <= 1e-4 + 1e-5 * r.weights.abs()).all())
            dn = float((v.num - r.num).abs().max())
            keys = int((v.semkey != r.semkey).sum())
            obs = int((r.weights > 0.05).sum())
            log(f"15e spatial {what}, {integration}, 2 slabs (64^3, 6 "
                f"frames): max |dw| {float(dw.max()):.3g} (the unsharded "
                f"step against itself: {spread:.3g}), max |dnum| {dn:.3g}, "
                f"keys differing {keys}, {obs} observed voxels")
            if not (w_ok and dn <= 1e-3 and keys == 0 and obs > 1000):
                raise RuntimeError(f"spatial {what} ({integration}) "
                                   "disagrees with the unsharded pipeline")
        log(f"  launches {c}")
        if integration == "rows":
            require(c, ["build_shadow", "build_shadow_dirty",
                        "reconcile_slot", "reconcile_key"], "spatial")
        counts = {k: counts.get(k, 0) + n for k, n in c.items()}
    return counts


def multihost_run():
    """Phase 15f: ``segfusion_tpu_torch.parallel.multihost_worker`` as two
    processes on the one card, joined by ``torch.distributed`` over gloo
    on localhost: the scene shards disjoint and covering, the all-reduced
    total the same on both and equal to the sum of the locals."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "segfusion_tpu_torch.parallel.multihost_worker",
         str(i), "2", str(port), "--device", "cuda"], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                raise RuntimeError(f"multihost worker failed:\n{err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    recs = [json.loads([ln for ln in out.splitlines()
                        if "MULTIHOST_OK" in ln][-1]) for out in outs]
    for r in recs:
        log(f"15f {json.dumps(r)}")
    scenes = [set(r["scenes"]) for r in recs]
    total = sum(r["local_sum"] for r in recs)
    if not (sorted(r["process"] for r in recs) == [0, 1]
            and not (scenes[0] & scenes[1])
            and len(scenes[0] | scenes[1]) == 5
            and all(r["backend"] == "gloo" and r["device"].startswith("cuda")
                    for r in recs)
            and all(abs(r["global_sum"] - total) <= 1e-9 * total
                    for r in recs) and total > 0):
        raise RuntimeError("multihost: shards or the all-reduce are wrong")


def phase15(dev):
    """Phase 15 (a-f); returns (the folded kernel results, the main-path
    launch counts of 15b, 15c and 15e)."""
    t_all = time.perf_counter()
    counts = {}
    t0 = time.perf_counter()
    folded = folded_kernels(dev)
    folded_past_2_31(dev)
    log(f"  15a: {time.perf_counter() - t0:.1f} s")
    for name, run in (("15b", lambda: multi512(dev)),
                      ("15c", lambda: small_runner(dev)),
                      ("15d", lambda: sharded_kernels(dev)),
                      ("15e", lambda: spatial(dev)),
                      ("15f", multihost_run)):
        t0 = time.perf_counter()
        more = run()
        torch.cuda.empty_cache()
        log(f"  {name}: {time.perf_counter() - t0:.1f} s")
        for k, n in (more or {}).items():
            counts[k] = counts.get(k, 0) + n
    log(f"phase 15: {time.perf_counter() - t_all:.1f} s")
    return folded, counts


# -- phase 16: the folded FusionNet executor and the host tools --------------

EXECUTOR_FORMS = (("dots9", False), ("im2col", False), ("dots9", True),
                  ("im2col", True))


def bn_perturbed(net, seed: int):
    """``net`` with random BatchNorm scales, biases and running
    statistics drawn on the host from ``seed``, so a fold has work."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(0.8 + 0.4 * torch.rand(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return net


def net_inputs(b: int, h: int, w: int, dev, seed: int, n_points: int = 9):
    """FusionNet's NHWC input dict (with the semantic frame) drawn on the
    host from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    d = {"tsdf_values": 0.05 * torch.randn(b, h, w, n_points, generator=g),
         "tsdf_weights": 3.0 * torch.rand(b, h, w, n_points, generator=g),
         "tsdf_frame": 0.5 + 2.5 * torch.rand(b, h, w, 1, generator=g),
         "semantic_frame": torch.rand(b, h, w, 1, generator=g)}
    return {k: v.to(dev) for k, v in d.items()}


def kernels_per_call(fn) -> int:
    """CUDA kernels one call of ``fn`` runs, from torch.profiler's device
    events (the runtime's launch calls where the trace has none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    device = sum(1 for e in events if e.device_type == DeviceType.CUDA)
    if device:
        return device
    return sum(1 for e in events if "LaunchKernel" in e.name)


def executor_forms(dev):
    """Phase 16a: the folded executor (``models/fusionnet_fast``) against
    the eager module at full width (v3 gf 6 with the semantic head, a
    block of 4 frames of 256x256, random BatchNorm statistics): in f32
    (TF32 off) every form (``fused_conv3x3`` dots9 / im2col x
    ``fused_vortex`` plain / packed) within tests/test_fastnet.py's rtol
    2e-4 / atol 2e-5; in bf16 max and mean |d| from the f32 eager
    forward, the executor's within tests/test_fastnet.py's bf16 bound
    (max 0.08, mean 0.02), the eager bf16 module's beside it; ms and
    kernels per forward of each; then card against CPU on phase 6's
    small width (gf 2, 32x32): f32 within rtol 2e-4 / atol 2e-5, bf16
    max |d| within 8e-3 and mean within 1e-3 (the bound
    tests/test_torch_fastnet.py holds two bf16 roundings of the executor
    to)."""
    cfg = headline_config()
    net = bn_perturbed(seeded_init(build_fusion_net(cfg.FUSION_MODEL),
                                   torch.Generator().manual_seed(11)), 12)
    net = net.to(dev).eval()
    inputs = net_inputs(4, 256, 256, dev, 13)
    eager16 = copy.deepcopy(net).to(torch.bfloat16)
    rows = []
    with torch.no_grad():
        ref = net(inputs).reshape(4, 256 * 256, -1)
        rows.append(("eager f32", 0.0, 0.0, cuda_ms(lambda: net(inputs), 5),
                     kernels_per_call(lambda: net(inputs))))
        e16 = eager16(inputs).reshape(ref.shape)
        rows.append(("eager bf16", float((e16 - ref).abs().max()),
                     float((e16 - ref).abs().mean()),
                     cuda_ms(lambda: eager16(inputs), 5),
                     kernels_per_call(lambda: eager16(inputs))))
        bad = []
        for mode, pack in EXECUTOR_FORMS:
            for dt in (torch.float32, torch.bfloat16):
                fast = ff.FastV3(net, dtype=dt, conv3x3=mode,
                                 pack_vortex=pack)
                got = fast(inputs)
                d = (got - ref).abs()
                name = (f"executor {'f32' if dt == torch.float32 else 'bf16'}"
                        f" {mode} {'packed' if pack else 'plain'}")
                rows.append((name, float(d.max()), float(d.mean()),
                             cuda_ms(lambda: fast(inputs), 5),
                             kernels_per_call(lambda: fast(inputs))))
                ok = (torch.allclose(got, ref, rtol=2e-4, atol=2e-5)
                      if dt == torch.float32
                      else float(d.max()) <= 0.08 and float(d.mean()) <= 0.02)
                if not ok or not bool(torch.isfinite(got).all()):
                    bad.append(name)
    log("16a FusionNet v3 gf 6 + semantic head, 4 x 256x256, forward "
        "(against the f32 eager module, TF32 off; ms from CUDA events, "
        "5 calls; kernels per forward from torch.profiler):")
    for name, mx, mean, ms, k in rows:
        log(f"  {name}: max |d| {mx:.3g}, mean |d| {mean:.3g}, "
            f"{ms:.3f} ms, {k} kernels")
    if bad:
        raise RuntimeError(f"16a: the executor disagrees with the eager "
                           f"module: {bad}")
    # card against CPU at phase 6's width
    small = headline_config(32, 32)
    small.FUSION_MODEL.growth_factor = 2
    cpu_net = bn_perturbed(seeded_init(build_fusion_net(small.FUSION_MODEL),
                                       torch.Generator().manual_seed(14)),
                           15).eval()
    card_net = copy.deepcopy(cpu_net).to(dev)
    errs = {}
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            for mode, pack in EXECUTOR_FORMS:
                want = ff.FastV3(cpu_net, dtype=dt, conv3x3=mode,
                                 pack_vortex=pack)(net_inputs(2, 32, 32,
                                                              "cpu", 16))
                got = ff.FastV3(card_net, dtype=dt, conv3x3=mode,
                                pack_vortex=pack)(net_inputs(2, 32, 32, dev,
                                                             16)).cpu()
                d = (got - want).abs()
                errs[(str(dt)[6:], mode, pack)] = (float(d.max()),
                                                   float(d.mean()))
                ok = (torch.allclose(got, want, rtol=2e-4, atol=2e-5)
                      if dt == torch.float32
                      else float(d.max()) <= 8e-3 and float(d.mean()) <= 1e-3)
                if not ok:
                    bad.append((str(dt), mode, pack))
    log(f"  card against CPU, gf 2, 2 x 32x32 (max, mean |d|): {errs}")
    if bad:
        raise RuntimeError(f"16a: card and CPU executors disagree: {bad}")


def in_turns(runs, turns: int = 2):
    """Each ``runs`` callable ``turns`` times, alternating; name -> the
    list of what each returned."""
    out = {name: [] for name in runs}
    for _ in range(turns):
        for name, fn in runs.items():
            out[name].append(fn())
    return out


def executor_streams(dev):
    """Phase 16b: the headline (phase 4's configuration, 2 chunks of 32)
    and multi512 (15b's) with the executor (``fused_net`` by default on
    a bf16 v3) and with ``fused_net: off`` (the eager module cast to
    bf16) in one process, in turns after a warm-up each: frames/s, and
    the two headline volumes held together (the nets round differently,
    so they are held only to the recurrence's scale: observed voxels and
    keys exact in share, the tsdf where both observe within 0.05 on 99%
    of them). Returns the launch counts of the timed runs."""
    cfg = headline_config()
    pipe = build_pipeline(cfg, dev)
    off_cfg = copy.deepcopy(cfg)
    off_cfg.SETTINGS.fused_net = "off"
    off = Pipeline(off_cfg, segmenter=pipe.segmenter,
                   fusion_net=copy.deepcopy(pipe.fusion_net), device=dev)
    if not pipe.fused_net or off.fused_net:
        raise RuntimeError("16b: the executor settings were not read")
    frames = render_frames(32, 256, 256, dev)
    volume = headline_volume(dev, HEADLINE_SHAPE)
    total = {k: 0 for k in read_counts()}
    outs = {}

    def stream(p, name):
        def run():
            out, counts, t_fuse, _ = run_stream(p, volume, [frames, frames])
            for k in total:
                total[k] += counts[k]
            outs[name] = out
            return 64 / t_fuse
        return run

    for p in (pipe, off):
        run_stream(p, volume, [frames], warm=frames)
    fps = in_turns({"executor": stream(pipe, "executor"),
                    "eager": stream(off, "eager")})
    a, b = outs["executor"], outs["eager"]
    both = (a.weights > 0.05) & (b.weights > 0.05)
    dt = (a.tsdf[both] - b.tsdf[both]).abs()
    share = float((dt <= 0.05).float().mean())
    log(f"16b headline frames/s, in turns: executor {fps['executor']}, "
        f"fused_net off {fps['eager']}; volumes: {int(both.sum())} voxels "
        f"observed by both, tsdf max |d| {float(dt.max()):.3g}, within "
        f"0.05 on {share:.4f}; card {card_line()}")
    for out, name in ((a, "executor"), (b, "eager")):
        check_volume(out, f"16b headline volume ({name})")
    if share < 0.99:
        raise RuntimeError("16b: the executor's and the eager module's "
                           "headline volumes disagree")
    del outs, a, b, volume, off, pipe, frames
    torch.cuda.empty_cache()
    mcfg = multi_config(512, 512)
    pipe = build_pipeline(mcfg, dev)
    off_cfg = copy.deepcopy(mcfg)
    off_cfg.SETTINGS.fused_net = "off"
    off = Pipeline(off_cfg, segmenter=pipe.segmenter,
                   fusion_net=copy.deepcopy(pipe.fusion_net), device=dev)
    frames = multi_frames(2, 8, 512, 512, dev, reps=2)
    n = frames["depth"].shape[0] * frames["depth"].shape[1]

    def multi(p):
        runner = SceneParallelFusion(p)

        def run():
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vols = runner.run_sequences(multi_volumes(2, MULTI_SHAPE, dev),
                                        frames)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = read_counts()
            for k in total:
                total[k] += counts[k]
            del vols
            return n / dt
        return run

    runs = {"executor": multi(pipe), "eager": multi(off)}
    for fn in runs.values():
        fn()                                            # warm-up
    fps = in_turns(runs)
    log(f"16b multi512 aggregate frames/s, in turns: executor "
        f"{fps['executor']}, fused_net off {fps['eager']}")
    return total


def bf16_train_chunk(cfg, dev, frames, seed: int = 3):
    """One chunk of 4 training frames (the configured compute dtype) over
    an empty 64^3 volume: (loss, gradients, running statistics) on the
    host."""
    pipe, layout, stream, gt_shadow, _ = trainer(cfg, dev, 64, seed=seed)
    loss, _ = pipe.train_sequence_rows(layout, stream, gt_shadow,
                                       {k: v.to(dev) for k, v in
                                        frames.items()}, [False] * 4)
    grads = torch.cat([p.grad.detach().reshape(-1).cpu()
                       for p in pipe.fusion_net.parameters()])
    return float(loss), grads, running_stats(pipe.fusion_net).cpu()


def executor_training(dev, n: int = 448, hw: int = 256):
    """Phase 16c: phase 9's training (448^3, 256x256, chunks of 8,
    rmsprop) with the matmul-form training forward (``fused_net_train``
    by default on bf16 v3) and with ``fused_net_train: off``: a warm-up
    chunk and 2 timed chunks each, training frames/s and peak memory;
    then a small bf16 stream (phase 10's 64^3 / 32x32 / gf 2, dropout
    0, one chunk of 4) card against CPU, both on the matmul form: the
    loss within rtol 1e-2; the gradients and the running statistics no
    further apart (max |d|) than twice the CPU's bf16 run is from its f32
    run (two bf16 roundings of one computation; at batch 1 BatchNorm
    amplifies a one-ulp flip in a nearly constant channel). Returns the
    launch counts."""
    total = {k: 0 for k in read_counts()}
    gt = room_gt(n, dev)
    for setting in ("auto", "off"):
        cfg = train_config(hw, hw)
        cfg.SETTINGS.fused_net_train = setting
        accum = int(cfg.TRAINING.optimization.accumulation_steps)
        pipe, layout, stream, gt_shadow, opt = trainer(cfg, dev, n, gt=gt)
        if pipe.fused_net_train != (setting == "auto"):
            raise RuntimeError("16c: fused_net_train was not read")
        frames = with_labels(render_frames(accum, hw, hw, dev))
        resets = [False] * accum
        loss, stream = train_chunk(pipe, layout, stream, gt_shadow, opt,
                                   frames, resets)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        losses = []
        for _ in range(2):
            loss, stream = train_chunk(pipe, layout, stream, gt_shadow, opt,
                                       frames, resets)
            losses.append(loss)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        for k in total:
            total[k] += counts[k]
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        log(f"16c training, fused_net_train {setting} "
            f"({'matmul form' if pipe.fused_net_train else 'eager module'}"
            f"): {2 * accum} frames in {dt:.3f} s = {2 * accum / dt:.2f} "
            f"training frames/s; peak {peak:.2f} GiB; losses {losses}")
        if not all(np.isfinite(losses)):
            raise RuntimeError(f"16c: non-finite training loss ({setting})")
        del pipe, stream, gt_shadow, opt, frames
        torch.cuda.empty_cache()
    del gt
    cfg = small_train_config("sgd")
    cfg.SETTINGS.fused_net_train = "on"
    frames = with_labels(render_frames(4, 32, 32, "cpu"))
    l32, g32, s32 = bf16_train_chunk(cfg, "cpu", frames)
    cfg.FUSION_MODEL.compute_dtype = "bfloat16"
    l_ref, g_ref, s_ref = bf16_train_chunk(cfg, "cpu", frames)
    loss, g, st = bf16_train_chunk(cfg, dev, frames)
    errs = {"loss": (loss, l_ref, l32),
            "grad": float((g - g_ref).abs().max()),
            "grad_bf16_vs_f32_cpu": float((g_ref - g32).abs().max()),
            "grad_largest": float(g32.abs().max()),
            "stats": float((st - s_ref).abs().max()),
            "stats_bf16_vs_f32_cpu": float((s_ref - s32).abs().max())}
    log(f"  small bf16 training stream, card against CPU (matmul form; "
        f"the CPU's bf16 against its f32 for scale): {errs}")
    if not (np.isclose(loss, l_ref, rtol=1e-2)
            and errs["grad"] <= 2 * errs["grad_bf16_vs_f32_cpu"]
            and errs["stats"] <= 2 * errs["stats_bf16_vs_f32_cpu"]):
        raise RuntimeError("16c: card and CPU bf16 training disagree")
    return total


def reference_fusion_checkpoint(fm, path: str, seed: int, dev):
    """A reference-style FusionNet ``.pth.tar`` for the FUSION_MODEL
    section ``fm``: its convolutions and BatchNorms in execution order
    under the names ``module.layer<i>``, random values, saved from the
    card; returns the source net."""
    net = bn_perturbed(seeded_init(build_fusion_net(fm),
                                   torch.Generator().manual_seed(seed)),
                       seed + 1)
    state = {}
    for i, (_, kind, layer) in enumerate(
            torch_convert._ordered_port_layers(net, fm)):
        attrs = (("weight", "bias") if kind == "conv" else
                 ("weight", "bias", "running_mean", "running_var"))
        for attr in attrs:
            state[f"module.layer{i}.{attr}"] = getattr(layer,
                                                       attr).detach().to(dev)
    torch.save({"model_state": state, "epoch": 3}, path)
    return net


def converted_checkpoint(dev):
    """Phase 16d: a reference-named v3 ``.pth.tar`` (gf 6, the semantic
    head) through ``convert_checkpoint`` (the function, then ``python -m
    segfusion_tpu_torch.convert_checkpoint`` with ``--config`` where
    PyYAML is installed, else its refusal), the written checkpoint equal
    to the source net, then ``test_fusion`` from it on
    synthetic_tpu_demo_joint's configuration. Returns the launch
    counts."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_convert_") as path:
        cfg = demo_joint_config(os.path.join(path, "test"))
        src = os.path.join(path, "best.pth.tar")
        ckpt = os.path.join(path, "fusion_best.ckpt")
        net = reference_fusion_checkpoint(cfg.FUSION_MODEL, src, 21, dev)
        t0 = time.perf_counter()
        convert_checkpoint("fusion", src, ckpt, cfg.FUSION_MODEL,
                           strip_prefix="module")
        t_convert = time.perf_counter() - t0
        loaded = fusionnet_from_checkpoint(ckpt, cfg.FUSION_MODEL)
        same = all(torch.equal(a, b) for a, b in zip(
            loaded.state_dict().values(), net.state_dict().values()))
        yml = os.path.join(path, "fusion.yaml")
        with open(yml, "w") as f:
            f.write("FUSION_MODEL:\n  name: v3\n  n_points: 9\n"
                    "  n_tail_points: 7\n  growth_factor: 6\n"
                    "  use_semantics: true\n  output_scale: 1.0\n")
        cli = subprocess.run(
            [sys.executable, "-m", "segfusion_tpu_torch.convert_checkpoint",
             "--type", "fusion", "--config", yml, "--in", src, "--out",
             os.path.join(path, "cli.ckpt"), "--strip-prefix", "module"],
            capture_output=True, text=True, timeout=300)
        try:
            import yaml  # noqa: F401
            has_yaml = True
        except ImportError:
            has_yaml = False
        if has_yaml:
            cli_ok = cli.returncode == 0 and open(
                os.path.join(path, "cli.ckpt"), "rb").read() == open(
                    ckpt, "rb").read()
        else:
            cli_ok = cli.returncode != 0 and "yaml" in cli.stderr
        cfg.TESTING.fusion_model_path = ckpt
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        results = entry.test_fusion(cfg, dev)
        torch.cuda.synchronize()
        counts = read_counts()
    log(f"16d convert_checkpoint (v3 gf 6 + semantic head, "
        f"{len(torch_convert._ordered_port_layers(net, cfg.FUSION_MODEL))} "
        f"layers): {t_convert:.3f} s, equal to the source net: {same}; "
        f"python -m with --config (PyYAML "
        f"{'installed' if has_yaml else 'missing'}): "
        f"{'as expected' if cli_ok else cli.stderr[-400:]}; test_fusion "
        f"from it: {time.perf_counter() - t0:.3f} s {json.dumps(results)}; "
        f"launches {counts}")
    bad = [k for k, v in results.items() if not np.isfinite(v)]
    if not same or not cli_ok or bad or len(results) != 9:
        raise RuntimeError("16d: the converted checkpoint is wrong or "
                           "test_fusion from it failed")
    require(counts, ["median_filter3d", "build_shadow_dirty",
                     "reconcile_slot", "reconcile_key"], "16d test_fusion")
    return counts


def watertight_share(faces: np.ndarray) -> float:
    """The share of edges that exactly two faces share."""
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                    faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    return float((counts == 2).mean())


def preprocessing(dev):
    """Phase 16e: one closed mesh (a sphere of radius 1.3 at (2, -1, 0.5),
    marching cubes of its SDF on 48^3) through ``python -m
    segfusion_tpu_torch.preprocess.scale`` -> ``fuse`` (the tool's
    defaults: 100 views, 256^3, 640x640, the TSDF fusion on the card;
    ``--save_sdf``, whose gzip hdf5 the port's reader reads back
    bit-exact against the same fusion in this process) ->
    ``simplify --method cluster --cluster 0.01`` (the tool's quadric
    default on the 256^3 mesh is a host cost of minutes: 151.4 s beside
    an H100), each step timed; the QEM decimator in this process on
    the input sphere to 5000 faces. The checks of tests/test_preprocess.py:
    the scaled mesh in the unit cube, the fused one watertight (99% of
    its edges shared by two faces) at the scaled radius 0.45 (median
    within 0.03), the clustered one with fewer faces at that radius
    within 0.05; the QEM mesh at most 5000 faces at its input's radius
    within 0.01."""
    n = 48
    x, y, z = np.mgrid[:n, :n, :n].astype(np.float32)
    c = (n - 1) / 2
    sdf = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) - 0.4 * n
    v, f, _ = marching_cubes(sdf, 0.0, spacing=1.0 / n)
    v = (v - v.mean(0)) * (1.3 / 0.4) + np.array([2.0, -1.0, 0.5])
    seconds = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pre_") as path:
        dirs = {k: os.path.join(path, k)
                for k in ("raw", "scaled", "fused", "simple")}
        os.makedirs(dirs["raw"])
        write_off(os.path.join(dirs["raw"], "ball.off"), v, f)
        for step, src, dst, extra in (
                ("scale", "raw", "scaled", []),
                ("fuse", "scaled", "fused", ["--save_sdf"]),
                ("simplify", "fused", "simple",
                 ["--method", "cluster", "--cluster", "0.01"])):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m",
                 f"segfusion_tpu_torch.preprocess.{step}", "--in_dir",
                 dirs[src], "--out_dir", dirs[dst], *extra],
                capture_output=True, text=True, timeout=600)
            seconds[step] = round(time.perf_counter() - t0, 3)
            if proc.returncode != 0:
                raise RuntimeError(f"16e preprocess.{step} failed:\n"
                                   f"{proc.stderr[-2000:]}")
        meshes = {k: read_off(os.path.join(dirs[k], "ball.off"))
                  for k in ("scaled", "fused", "simple")}
        t0 = time.perf_counter()
        with hdf5.File(os.path.join(dirs["fused"], "ball_sdf.hdf")) as fh:
            sdf_file, attrs = fh["sdf"], dict(fh.attrs)
        seconds["read ball_sdf.hdf"] = round(time.perf_counter() - t0, 3)
        tsdf, _, origin, voxel = fuse_mesh(
            *load_mesh(os.path.join(dirs["scaled"], "ball.off")),
            device=dev)
    bbox = np.stack([origin, origin + voxel * 256], axis=1)
    log(f"16e fuse --save_sdf: {sdf_file.shape} {sdf_file.dtype} read "
        f"through the port's reader, attributes {attrs}")
    if not (same_bits(sdf_file, tsdf[None]) and attrs["voxel_size"] == voxel
            and np.array_equal(attrs["bbox"], bbox)):
        raise RuntimeError("16e: fuse --save_sdf's hdf5 differs from the "
                           "fusion in this process")
    t0 = time.perf_counter()
    qv, qf = simplify_quadric(v, f, 5000)
    seconds["quadric in process"] = round(time.perf_counter() - t0, 3)
    meshes["quadric"] = (qv - v.mean(0), qf)
    radius = {k: float(np.median(np.linalg.norm(m[0], axis=1)))
              for k, m in meshes.items()}
    r_in = float(np.median(np.linalg.norm(v - v.mean(0), axis=1)))
    tight = watertight_share(meshes["fused"][1])
    faces = {k: len(m[1]) for k, m in meshes.items()}
    log(f"16e preprocessing ({len(f)} faces in): seconds a step "
        f"{seconds} (each step a new process); faces {faces}; median radius "
        f"{radius} (input {r_in:.4f}); fused watertight share {tight:.4f}")
    if not (np.abs(meshes["scaled"][0]).max() <= 0.5 and tight > 0.99
            and abs(radius["fused"] - 0.45) < 0.03
            and faces["simple"] < faces["fused"]
            and abs(radius["simple"] - 0.45) < 0.05
            and 0 < faces["quadric"] <= 5000
            and abs(radius["quadric"] - r_in) < 0.01):
        raise RuntimeError("16e: the preprocessed meshes fail the checks")


def tracing_tools(dev):
    """Phase 16f: ``trace`` around one headline block (phase 4's
    configuration, 4 frames) writes a Chrome trace holding device
    kernels and ``spans.json``, whose spans claim the block's launches
    and device time; ``nan_guard`` passes finite results through and
    trips on an injected NaN on the card."""
    cfg = headline_config()
    pipe = build_pipeline(cfg, dev)
    frames = {k: v[:4] for k, v in render_frames(4, 256, 256, dev).items()}
    volume = headline_volume(dev, HEADLINE_SHAPE)
    layout = rowvol.RowLayout.for_shape(HEADLINE_SHAPE)
    stream = pipe._new_stream(layout, pipe._enter_rows(layout, volume))
    pipe.fuse_sequence_rows(layout, stream, frames)          # warm-up
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as path:
        with trace(path):
            pipe.fuse_sequence_rows(layout, stream, frames)
            torch.cuda.synchronize()
        name = os.path.join(path, "trace.json")
        size = os.path.getsize(name)
        with open(name) as fh:
            events = json.load(fh)["traceEvents"]
        with open(os.path.join(path, "spans.json")) as fh:
            spans = json.load(fh)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy_ms = sum(e.get("dur", 0) for e in kernels) / 1e3
    chunk = spans["reduction"]["spans"].get("chunk", {})
    unclaimed_ms = spans["reduction"]["unclaimed"]["device_ms"]
    guarded = nan_guard(lambda t: torch.log(t) * 2)
    ok = bool(torch.isfinite(guarded(torch.ones(8, device=dev))).all())
    try:
        guarded(torch.tensor([1.0, -1.0], device=dev))
        tripped = False
    except FloatingPointError:
        tripped = True
    log(f"16f trace of one headline block: {size} bytes, {len(events)} "
        f"events, {len(kernels)} device kernels, {busy_ms:.3f} ms of "
        f"kernel time; spans: {spans['counters']}, "
        f"{chunk.get('launches_total', 0)} launches and "
        f"{chunk.get('device_ms_total', 0.0):.3f} device ms in the chunk, "
        f"{unclaimed_ms:.3f} ms unclaimed; nan_guard passes finite {ok}, "
        f"trips on a NaN {tripped}")
    if (not kernels or not ok or not tripped
            or spans["counters"]["frames"] != 4
            or not chunk.get("launches_total") or unclaimed_ms > 0.0):
        raise RuntimeError("16f: the trace, its spans or the NaN guard "
                           "failed")


def phase16(dev):
    """Phase 16: the folded executor and the host tools; returns the
    launch counts of its main-path runs."""
    t_all = time.perf_counter()
    total = {k: 0 for k in read_counts()}
    executor_forms(dev)
    for part in (executor_streams, executor_training, converted_checkpoint):
        t0 = time.perf_counter()
        for k, n in part(dev).items():
            total[k] += n
        torch.cuda.empty_cache()
        log(f"  ({part.__name__}: {time.perf_counter() - t0:.1f} s)")
    preprocessing(dev)
    tracing_tools(dev)
    log(f"phase 16: {time.perf_counter() - t_all:.1f} s")
    return total


# -- phase 17: the real-data loaders on their datasets' own layouts ----------

REPLICA_FUSION = "configs/fusion/replica_accuracy.yaml"
REPLICA_SEG = "configs/segmentation/replica_multi.yaml"
SCANNET_FUSION = "configs/fusion/scannet.yaml"
SCANNET_SEG = "configs/segmentation/scannet_multi.yaml"
DEMO_JOINT = "configs/fusion/synthetic_tpu_demo_joint.yaml"
REPLICA_DIRS = ("left_depth_gt", "left_depth_noise_5.0", "left_rgb",
                "left_camera_matrix", "left_class30")
SCANNET_DIRS = ("depth", "color", "label-filt", "pose", "intrinsic")
# a Synthetic room's parts (0 no surface, 1 walls, 2 sphere, 3 box) as
# Replica class30 ids (wall, beanbag, table) and ScanNet raw label ids
# (wall, chair, otherfurniture: NYU-40 ids 1, 5 and 39 through the tsv)
REPLICA_OF_PART = np.array([0, 26, 1, 23], np.uint8)
SCANNET_RAW_OF_PART = np.array([0, 1, 5, 39], np.uint16)
# ScanNet's depth camera at 640x480
SCANNET_DEPTH_K = np.array([[577.870605, 0, 319.5], [0, 577.870605, 239.5],
                            [0, 0, 1]], np.float32)


def room_views(scene, poses, intrinsics, h: int, w: int, dev, fine: float):
    """(depth maps (n, h, w) f32, each pixel's room part (n, h, w)) of the
    Synthetic room ``scene`` from camera-to-world ``poses``: the port's
    ``render_depth`` on ``dev`` over the room's SDF sampled at ``fine``
    metres; part 0 where no surface was hit."""
    g, _ = scene.grid(fine, 10.0, pad=2)
    depth = render_depth(
        torch.as_tensor(g.volume, device=dev),
        torch.as_tensor(poses, device=dev),
        torch.as_tensor(intrinsics, device=dev),
        torch.as_tensor(g.origin, device=dev), g.resolution, h, w,
        near=0.05, far=4.0 * scene.half, n_steps=512).cpu().numpy()
    pts = geometry.unproject(torch.as_tensor(depth), torch.as_tensor(poses),
                             torch.as_tensor(intrinsics)).numpy()
    parts = scene.surface_labels(pts).reshape(depth.shape)
    return depth, np.where(depth > 0, parts, 0)


def room_gt_grid(scene, voxel: float, dev) -> np.ndarray:
    """Replica's gt grid of the Synthetic room ``scene``: (2, n, n, n)
    f32, the room's SDF and its surface parts as class30 ids
    (REPLICA_OF_PART) at ``voxel`` metres over [-half, half]^3 (as
    tests/test_torch_test_fusion.py's ``write_semantic_sdf`` samples
    ``scene.sdf`` and ``scene.surface_labels``), the three parts'
    distances computed on ``dev`` in float64, x-slab by x-slab."""
    n = int(round(2 * scene.half / voxel))
    f64 = dict(dtype=torch.float64, device=dev)
    ax = -scene.half + torch.arange(n, **f64) * voxel
    ids = torch.as_tensor(REPLICA_OF_PART.astype(np.float32), device=dev)
    sphere_c, box_c, box_h = (torch.as_tensor(v, **f64) for v in (
        scene.sphere_c, scene.box_c, scene.box_h))
    grid = torch.empty((2, n, n, n), dtype=torch.float32, device=dev)

    def box(q):
        return (q.clamp_min(0).norm(dim=-1)
                + q.amax(dim=-1).clamp_max(0))

    for x0 in range(0, n, 40):
        pts = torch.stack(torch.meshgrid(ax[x0:x0 + 40], ax, ax,
                                         indexing="ij"), dim=-1)
        parts = torch.stack([
            -box(pts.abs() - scene.half),                          # walls
            (pts - sphere_c).norm(dim=-1) - scene.sphere_r,
            box((pts - box_c).abs() - box_h)], dim=-1)
        sdf, nearest = parts.min(dim=-1)
        grid[0, x0:x0 + 40] = sdf.float()
        grid[1, x0:x0 + 40] = ids[nearest + 1]
    return grid.cpu().numpy()


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.ascontiguousarray(a).tobytes()
            == np.ascontiguousarray(b).tobytes())


def write_gt_grid(path: str, grid: np.ndarray, scene, voxel: float,
                  **compression) -> dict:
    """The gt grid ``grid`` of ``scene`` (``room_gt_grid``) written at
    ``path`` as Replica's semantic sdf hdf (dataset ``sdf``, attributes
    ``voxel_size`` and ``bbox``) through the port's writer, contiguous
    unless ``compression`` names gzip, then read back through its reader
    and required bit-exact. Returns the sizes, seconds and MB/s."""
    bbox = np.array([[-scene.half, scene.half]] * 3)
    t1 = time.perf_counter()
    with hdf5.File(path, "w") as f:
        f.create_dataset("sdf", data=grid, **compression)
        f.attrs["voxel_size"] = voxel
        f.attrs["bbox"] = bbox
    t2 = time.perf_counter()
    with hdf5.File(path, "r") as f:
        back = f["sdf"]
        attrs = dict(f.attrs)
    t3 = time.perf_counter()
    if not (same_bits(back, grid) and attrs["voxel_size"] == voxel
            and np.array_equal(attrs["bbox"], bbox)):
        raise RuntimeError(f"{path}: the gt grid read back differs")
    mb = grid.nbytes / 2 ** 20
    return {"shape": grid.shape, "MB": round(mb, 1),
            "file MB": round(os.path.getsize(path) / 2 ** 20, 1),
            "write s": round(t2 - t1, 3),
            "write MB/s": round(mb / (t2 - t1), 1),
            "read s": round(t3 - t2, 3), "read MB/s": round(mb / (t3 - t2),
                                                            1)}


def read_back(db, scene: str, name_of) -> list:
    """Each hdf5 volume that a "tsdf" / "test" save of ``db``'s
    ``scene`` wrote (``name_of(plane)`` its path) read through the
    port's reader and required bit-exact to the Database's cropped
    volume; [(file, shape, dtype, read seconds)]."""
    vol, out = db.volumes[scene], []
    planes = [("TSDF", "tsdf"), ("weights", "weights")] + (
        [("semantics", "semantics")] if db.semantics else [])
    for key, plane in planes:
        path = name_of(plane)
        t0 = time.perf_counter()
        with hdf5.File(path, "r") as f:
            got = f[key]
        dt = time.perf_counter() - t0
        if not same_bits(got, db._crop(getattr(vol, plane), scene)):
            raise RuntimeError(f"{path}: {key} read back differs from the "
                               "Database's volume")
        out.append((os.path.basename(path), got.shape, str(got.dtype),
                    round(dt, 3)))
    return out


def saved_name(path: str, scene: str):
    """``Database.save``'s hdf5 file of a plane."""
    base = scene.replace("/", ".")
    return lambda plane: os.path.join(path, f"{base}.{plane}.hf5")


@contextlib.contextmanager
def hdf5_saves_checked():
    """Within the block, each ``Database.save`` and
    ``save_to_workspace`` in "tsdf" / "test" mode is followed by
    ``read_back`` of every ``.hf5`` it wrote (outside the save's own
    time where the save is timed by ``stage_seconds``); yields the list
    of (file, shape, dtype, read seconds)."""
    checked = []
    originals = {name: getattr(Database, name)
                 for name in ("save", "save_to_workspace")}

    def save(self, path, save_mode="ply", scene_id=None):
        originals["save"](self, path, save_mode, scene_id)
        if save_mode in ("tsdf", "test"):
            checked.extend(read_back(self, scene_id,
                                     saved_name(path, scene_id)))

    def save_to_workspace(self, workspace, mode, save_mode="ply"):
        originals["save_to_workspace"](self, workspace, mode, save_mode)
        if save_mode in ("tsdf", "test"):
            for s in self.scenes:
                if self.state[s]:
                    base = s.replace("/", ".")
                    checked.extend(read_back(self, s, lambda plane: (
                        os.path.join(workspace.output_path, f"{base}."
                                     f"{plane.replace('semantics', 'semantic')}"
                                     f"_{mode}.hf5"))))

    Database.save, Database.save_to_workspace = save, save_to_workspace
    try:
        yield checked
    finally:
        for name, fn in originals.items():
            setattr(Database, name, fn)


def write_replica_tree(root: str, seeds, n_frames: int, res: int, dev,
                       fine: float, gt_voxel: Optional[float] = None):
    """A Replica tree under ``root`` from Synthetic rooms: for each seed a
    scene ``room_<seed>`` with one trajectory ``1`` of ``n_frames`` res x
    res frames: ``left_rgb`` (seeded colour), ``left_depth_gt`` (uint16
    mm), ``left_depth_noise_5.0`` (the same with seeded 5 mm noise),
    ``left_class30`` (REPLICA_OF_PART) and ``left_camera_matrix`` (each
    pose in Replica's raw convention, ``raw_camera_matrix``); where
    ``gt_voxel`` is given, the room's gt grid at that voxel size
    (``room_gt_grid``), ``gt_semantic_sdf/semantic_sdf.hdf``, through the
    port's writer (``write_gt_grid``); and the scene list ``list.txt`` in
    lists/replica's line format. Returns (the list's path, {scene:
    (poses, depth mm, the gt grid's sampling seconds and
    ``write_gt_grid``'s record, or None)})."""
    import cv2
    rng = np.random.RandomState(17)
    f = res / 2.0                       # hfov 90
    intrinsics = np.array([[f, 0, f], [0, f, f], [0, 0, 1]], np.float32)
    truth, lines = {}, []
    for seed in seeds:
        scene = SyntheticScene(seed)
        name = f"room_{seed}"
        base = os.path.join(root, name, "1")
        for sub in REPLICA_DIRS:
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        poses = scene.camera_poses(n_frames)
        depth, parts = room_views(scene, poses, intrinsics, res, res, dev,
                                  fine)
        mm = np.round(depth * 1000).astype(np.uint16)
        noisy = np.where(depth > 0,
                         depth + rng.normal(0, 0.005, depth.shape), 0)
        noisy_mm = np.round(np.clip(noisy, 0, 65.535) * 1000).astype(
            np.uint16)
        for i in range(n_frames):
            def out(sub, ext=".png"):
                return os.path.join(base, sub, f"{i}{ext}")
            cv2.imwrite(out("left_rgb"),
                        rng.randint(0, 256, (res, res, 3), dtype=np.uint8))
            cv2.imwrite(out("left_depth_gt"), mm[i])
            cv2.imwrite(out("left_depth_noise_5.0"), noisy_mm[i])
            cv2.imwrite(out("left_class30"), REPLICA_OF_PART[parts[i]])
            np.savetxt(out("left_camera_matrix", ".txt"),
                       raw_camera_matrix(poses[i]))
        gt = None
        if gt_voxel is not None:
            sdf_dir = os.path.join(root, name, "gt_semantic_sdf")
            os.makedirs(sdf_dir, exist_ok=True)
            t0 = time.perf_counter()
            grid = room_gt_grid(scene, gt_voxel, dev)
            gt = {"sample s": round(time.perf_counter() - t0, 3)}
            gt.update(write_gt_grid(
                os.path.join(sdf_dir, "semantic_sdf.hdf"), grid, scene,
                gt_voxel))
        truth[name] = (poses, mm, gt)
        lines.append(" ".join(f"{name}/1/{d}" for d in REPLICA_DIRS))
    path = os.path.join(root, "list.txt")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path, truth


def box_mesh(lo: float, hi: float):
    """(vertices (8, 3), faces (12, 3)) of the cube [lo, hi]^3."""
    verts = np.array([[x, y, z] for x in (lo, hi) for y in (lo, hi)
                      for z in (lo, hi)], np.float32)
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                      [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                      [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return verts, faces


def write_scannet_tree(root: str, seed: int, n_frames: int, dev,
                       fine: float, h: int = 480, w: int = 640,
                       scene_name: str = "scene0000_00"):
    """A raw ScanNet scan (no hdf) under ``root`` from the Synthetic room
    ``seed``: ``scans/<scene>/`` with ``color/*.jpg`` (seeded colour),
    ``depth/*.png`` (uint16 mm), ``label-filt/*.png`` (uint16 raw ids,
    SCANNET_RAW_OF_PART), ``pose/*.txt`` (camera-to-world),
    ``intrinsic/intrinsic_depth.txt`` (SCANNET_DEPTH_K) and
    ``<scene>_vh_clean_2.ply`` (the room's walls); the tsv label map
    (raw id i -> NYU-40 id i for i <= 40) and the scene list, one
    ``scans/<scene>`` line (the loader takes a line's first entry as the
    scan's directory, so lists/scannet's lines, which start with
    ``scans/<scene>/depth``, do not load). Returns (the list's path,
    poses, depth mm)."""
    import cv2
    rng = np.random.RandomState(23)
    sdir = os.path.join(root, "scans", scene_name)
    for sub in SCANNET_DIRS:
        os.makedirs(os.path.join(sdir, sub), exist_ok=True)
    k4 = np.eye(4)
    k4[:3, :3] = SCANNET_DEPTH_K
    np.savetxt(os.path.join(sdir, "intrinsic", "intrinsic_depth.txt"), k4)
    scene = SyntheticScene(seed)
    poses = scene.camera_poses(n_frames)
    depth, parts = room_views(scene, poses, SCANNET_DEPTH_K, h, w, dev, fine)
    mm = np.round(depth * 1000).astype(np.uint16)
    for i in range(n_frames):
        cv2.imwrite(os.path.join(sdir, "color", f"{i}.jpg"),
                    rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
        cv2.imwrite(os.path.join(sdir, "depth", f"{i}.png"), mm[i])
        cv2.imwrite(os.path.join(sdir, "label-filt", f"{i}.png"),
                    SCANNET_RAW_OF_PART[parts[i]])
        np.savetxt(os.path.join(sdir, "pose", f"{i}.txt"), poses[i])
    verts, faces = box_mesh(-scene.half, scene.half)
    write_ply(os.path.join(sdir, scene_name + "_vh_clean_2.ply"), verts,
              faces)
    with open(os.path.join(root, "scannetv2-labels.combined.tsv"),
              "w") as fh:
        fh.write("id\traw_category\tnyu40id\n")
        for raw in range(1, 41):
            fh.write(f"{raw}\tcategory{raw}\t{raw}\n")
    path = os.path.join(root, "list.txt")
    with open(path, "w") as fh:
        fh.write(f"scans/{scene_name}\n")
    return path, poses, mm


@contextlib.contextmanager
def stage_seconds(targets, starts: Optional[dict] = None):
    """Within the block, each ``(owner, name)`` method is wrapped to add
    its host seconds to the yielded dict under ``"Owner.name"``; a method
    ``synced`` also waits for the card before its clock stops (the loader's
    ``__getitem__``, which runs in the prefetch thread, does not). The
    clock of each method's first call goes into ``starts``, where given."""
    secs, saved = {}, []
    for owner, name, synced in targets:
        fn = getattr(owner, name)

        def timed(*args, _fn=fn, _key=f"{owner.__name__}.{name}",
                  _sync=synced, **kwargs):
            t0 = time.perf_counter()
            if starts is not None:
                starts.setdefault(_key, t0)
            try:
                return _fn(*args, **kwargs)
            finally:
                if _sync:
                    torch.cuda.synchronize()
                secs[_key] = secs.get(_key, 0.0) + time.perf_counter() - t0
        saved.append((owner, name, fn))
        setattr(owner, name, timed)
    try:
        yield secs
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def seeded_checkpoint(net, path: str, seed: int):
    """``net`` with seeded random weights, written as a Flax checkpoint at
    ``path``."""
    seeded_init(net, torch.Generator().manual_seed(seed))
    params, stats = to_flax(net)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_checkpoint({"params": params, "batch_stats": stats}, path)
    return path


def replica_loader(dev, root: str, frames: int = 32, res: int = 512):
    """Phases 17a' and 17b: the Replica tree (2 rooms x 32 frames of
    512x512, each room's gt grid at 1 cm through the port's writer, read
    back bit-exact; then one gzip-chunked copy of room 0's, as
    ``preprocess.fuse`` writes its sdf) and the port's loader on
    replica_accuracy.yaml (256x256, tof_depth, max_depth_diversity):
    every pose within 1e-5, every gt depth to the millimetre of the
    nearest resize of what was written, labels and mask; host ms a
    frame. Returns the scene list."""
    import cv2
    t0 = time.perf_counter()
    lst, truth = write_replica_tree(root, (0, 1), frames, res, dev, 0.025,
                                    gt_voxel=0.01)
    t_tree = time.perf_counter() - t0
    for name, (_, _, gt) in truth.items():
        log(f"17a' {name} gt grid (sampled on {dev}), the port's writer "
            f"and reader (contiguous): {json.dumps(gt)}")
    scene = SyntheticScene(0)
    grid = room_gt_grid(scene, 0.01, dev)
    gz = write_gt_grid(os.path.join(root, "room_0_gzip.hdf"), grid, scene,
                       0.01, compression="gzip")
    log(f"17a' room_0 gt grid, gzip-chunked (level 4, the chunk shape "
        f"{hdf5.guess_chunk(grid.shape, 4)}): {json.dumps(gz)}")
    del grid
    os.remove(os.path.join(root, "room_0_gzip.hdf"))
    cfg = load_config(REPLICA_FUSION)
    cfg.DATA.update(root_dir=root, test_scene_list=lst)
    ds = get_data("Replica", get_data_config(cfg, "test"), dev)
    order = [f"room_{i % 2}/1/{i // 2}" for i in range(2 * frames)]
    t0 = time.perf_counter()
    samples = [ds[i] for i in range(len(ds))]
    ms = (time.perf_counter() - t0) / len(samples) * 1e3
    pose_err = depth_err = 0.0
    for s in samples:
        scene, _, i = s["frame_id"].split("/")
        poses, mm, _ = truth[scene]
        pose_err = max(pose_err, float(np.abs(
            s["extrinsics"] - poses[int(i)]).max()))
        want = cv2.resize(mm[int(i)], (256, 256),
                          interpolation=cv2.INTER_NEAREST)
        depth_err = max(depth_err, float(np.abs(
            s["depth_gt"] * 1000 - want).max()))
        if (s["image"].shape != (256, 256, 3)
                or not set(np.unique(s["semantic_gt"])) <= set(
                    REPLICA_OF_PART.tolist())
                or not np.array_equal(s["mask"], (s["tof_depth"] > 0.05)
                                      & (s["tof_depth"] < 5.0))):
            raise RuntimeError(f"Replica frame {s['frame_id']}: image, "
                               "labels or mask wrong")
    log(f"17b Replica tree (2 rooms x {frames} frames, {res}x{res}, depth "
        f"rendered on {dev}, the gt grids): written in {t_tree:.2f} s; the "
        f"loader at "
        f"256x256: {len(samples)} frames, {ms:.3f} ms a frame on the host "
        f"(decode + "
        f"nearest resize + normalise); largest pose error {pose_err:.3g}, "
        f"largest depth error {depth_err:.3g} mm")
    if [s["frame_id"] for s in samples] != order:
        raise RuntimeError("Replica: max_depth_diversity did not "
                           "interleave the two rooms frame by frame")
    if pose_err > 1e-5 or depth_err > 0.5:
        raise RuntimeError(f"Replica: pose error {pose_err}, depth error "
                           f"{depth_err} mm")
    return lst


def replica_segmentation(dev, root: str, lst: str, frames: int = 64):
    """Phase 17e: ``train_segmentation`` on replica_multi.yaml (stage 2,
    RGB + ToF, SSMA, batch 8, bf16) over the tree's ``frames``, 1 epoch,
    from seeded stage-1 rgb / tof checkpoints at the config's paths; then
    ``test_segmentation`` on its best.ckpt."""
    cfg = load_config(REPLICA_SEG)
    model = cfg.SEMANTIC_2D_MODEL
    for key, seed in (("pretrained_rgb", 1), ("pretrained_tof", 2)):
        stage1 = Config(dict(model, stage=1))
        model[key] = seeded_checkpoint(build_adapnet(stage1),
                                       os.path.join(root, model[key]), seed)
    cfg.SETTINGS.experiment_path = os.path.join(root, "replica_seg")
    cfg.TRAINING.update(n_epochs=1, val_ratio=4)
    cfg.TESTING.update(test_ratio=4)
    cfg.DATA.update(root_dir=root, train_scene_list=lst, val_scene_list=lst,
                    test_scene_list=lst)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    net, ws, hist = seg_train.train_segmentation(cfg, dev, "phase 17e")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    steps, secs = hist["steps"][0], hist["train_seconds"][0]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"17e train_segmentation (replica_multi.yaml: stage 2 RGB + ToF, "
        f"256x256, batch 8, bf16; 1 epoch of {frames} Replica frames): "
        f"{8 * steps / secs:.2f} images/s over the epoch, first step "
        f"included ({steps} steps, {secs:.2f} s; all {total:.2f} s); peak "
        f"device memory {peak:.2f} GiB; loss {hist['train_loss']}; val "
        f"{hist['val']}")
    ckpt = os.path.join(ws.model_path, "best.ckpt")
    if not (all(np.isfinite(hist["train_loss"])) and os.path.exists(ckpt)):
        raise RuntimeError("17e: non-finite loss or no best.ckpt")
    del net
    cfg.TESTING.semantic_2d_model_path = ckpt
    cfg.TIMESTAMP = None
    t0 = time.perf_counter()
    metrics = seg_test.test_segmentation(cfg, dev)
    vis = os.path.join(cfg.SETTINGS.experiment_path, cfg.TIMESTAMP,
                       "output", "vis")
    log(f"17e test_segmentation on its best.ckpt ({frames // 4} frames): "
        f"{time.perf_counter() - t0:.2f} s; {metrics}; "
        f"{len(os.listdir(vis))} strips")
    if (len(os.listdir(vis)) != min(10, frames // 4)
            or not all(np.isfinite(v) for v in metrics.values())):
        raise RuntimeError("17e test_segmentation: strips or metrics")


def room_lists(root: str, lst: str):
    """One scene list a room of the tree's list: [room_0's, room_1's]."""
    with open(lst) as fh:
        lines = [ln for ln in fh.read().splitlines() if ln.strip()]
    paths = []
    for line in lines:
        path = os.path.join(root, line.split("/", 1)[0] + ".txt")
        with open(path, "w") as fh:
            fh.write(line + "\n")
        paths.append(path)
    return paths


def replica_fusion_config(root: str, path: str, seg_ckpt: str):
    """replica_accuracy.yaml as written (v3 gf 6 with the semantic head,
    AdapNet++ stage 2 predicting 30 classes, bf16 nets, f16packed
    gathers, rmsprop, accumulation 8, ``save_mode: test``, 256x256 from
    the 512x512 files), on the tree under ``root`` with the workspace at
    ``path`` and the seeded stage-2 checkpoint ``seg_ckpt``; one epoch,
    the loss logged at every update (8 frames)."""
    cfg = load_config(REPLICA_FUSION)
    cfg.SETTINGS.update(experiment_path=path, log_freq=8)
    cfg.TRAINING.n_epochs = 1
    cfg.TESTING.semantic_2d_model_path = seg_ckpt
    cfg.DATA.root_dir = root
    return cfg


def replica_train(dev, root: str, lists, seg_ckpt: str, frames: int = 32):
    """Phase 17d: ``train_fusion`` on replica_accuracy.yaml over room 0's
    ``frames`` (one epoch: frames / 8 updates) into its gt grid (400^3
    at 1 cm, 404^3 after the pad), validating on room 1's; the stage
    seconds, training frames/s (from the first training chunk to the
    first evaluation), the validation's seconds (``fuse_many`` to the
    first save), the gzip-9 saves' seconds and MB/s, peak memory and
    launch counts; every ``.hf5`` read back bit-exact. Returns
    (best.ckpt's path, the launch counts)."""
    from segfusion_tpu_torch.utils.workspace import Workspace
    cfg = replica_fusion_config(root, os.path.join(root, "replica_train"),
                                seg_ckpt)
    cfg.DATA.update(train_scene_list=lists[0], val_scene_list=lists[1])
    stages = [(Replica, "get_grid", False),
              (Pipeline, "train_sequence_rows", True),
              (Pipeline, "fuse_many", True)] + [
        (Database, name, True) for name in (
            "__init__", "filter", "evaluate", "save_to_workspace")] + [
        (Workspace, "_save_h5", False)]
    starts = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    with stage_seconds(stages, starts) as stage, \
            hdf5_saves_checked() as checked:
        t0 = time.perf_counter()
        net, ws = train_fusion(cfg, dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    train_s = starts["Database.evaluate"] - starts[
        "Pipeline.train_sequence_rows"]
    val_s = starts["Database.save_to_workspace"] - starts[
        "Pipeline.fuse_many"]
    h5_mb = sum(np.prod(shape) * np.dtype(dt).itemsize
                for _, shape, dt, _ in checked) / 2 ** 20
    with open(os.path.join(ws.log_path, "train.log")) as fh:
        losses = [float(ln.rsplit("loss", 1)[1]) for ln in fh
                  if ": loss " in ln]
    files = sorted(os.listdir(ws.model_path))
    shape = checked[0][1] if checked else None
    log(f"17d train_fusion (replica_accuracy.yaml: v3 gf 6 + semantic "
        f"head, stage 2 predicting 30 classes, bf16, f16packed, rmsprop, "
        f"accumulation 8, save_mode test; {frames} frames of room_0 at "
        f"{cfg.DATA.resx}x{cfg.DATA.resy} into the gt grid, validation on "
        f"room_1 into {shape} at 1 cm): "
        f"{secs:.3f} s in all; training {frames / train_s:.2f} frames/s, "
        f"first update included ({train_s:.3f} s); validation "
        f"{val_s:.3f} s; gzip-9 hdf5 saves {stage['Workspace._save_h5']:.3f}"
        f" s for {len(checked)} volumes of {h5_mb:.1f} MB "
        f"({h5_mb / stage['Workspace._save_h5']:.1f} MB/s); peak device "
        f"memory {peak:.2f} GiB; stages "
        f"{json.dumps({k: round(v, 3) for k, v in stage.items()})}; "
        f"losses {losses}; wrote {files}; launches {counts}")
    log(f"  hdf5 volumes read back bit-exact: {checked}")
    if not (len(losses) == frames // 8 and all(np.isfinite(losses))):
        raise RuntimeError(f"17d: losses {losses}")
    if files != ["best.ckpt", "last.ckpt"] or len(checked) != 6:
        raise RuntimeError(f"17d: wrote {files}, {len(checked)} volumes")
    require(counts, ["build_shadow_dirty", "reconcile_slot",
                     "reconcile_key"], "17d train_fusion")
    del net
    return os.path.join(ws.model_path, "best.ckpt"), counts


def replica_test(dev, root: str, lists, seg_ckpt: str, fusion_ckpt: str,
                 frames: int = 32):
    """Phase 17c: ``test_fusion`` on replica_accuracy.yaml over room 1's
    ``frames`` from 17d's best.ckpt into its gt grid: each stage and the
    loader timed, the metrics (finite; no quality bound after four
    updates), the ``save_mode: test`` volumes read back bit-exact;
    returns the launch counts."""
    cfg = replica_fusion_config(root, os.path.join(root, "replica_test"),
                                seg_ckpt)
    cfg.TESTING.fusion_model_path = fusion_ckpt
    cfg.DATA.test_scene_list = lists[1]
    stages = [(Replica, "__getitem__", False)] + [
        (Database, name, True) for name in (
            "__init__", "filter", "filter_semantics", "evaluate",
            "evaluate_fscore", "save")] + [(Pipeline, "fuse_many", True)]
    torch.cuda.synchronize()
    reset_counts()
    with stage_seconds(stages) as stage, hdf5_saves_checked() as checked:
        t0 = time.perf_counter()
        results = entry.test_fusion(cfg, dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = read_counts()
    fuse = stage["Pipeline.fuse_many"]
    log(f"17c test_fusion (replica_accuracy.yaml from 17d's best.ckpt, "
        f"{frames} frames of room_1 at {cfg.DATA.resx}x{cfg.DATA.resy} "
        f"into {checked[0][1] if checked else None} at 1 cm): "
        f"{secs:.3f} s in all; fuse_many {fuse:.3f} s = "
        f"{frames / fuse:.2f} frames/s; filter "
        f"{stage['Database.filter']:.3f} s, filter_semantics "
        f"{stage['Database.filter_semantics']:.3f} s, evaluate "
        f"{stage['Database.evaluate']:.3f} s, F-score "
        f"{stage['Database.evaluate_fscore']:.3f} s, save "
        f"{stage['Database.save']:.3f} s; stages "
        f"{json.dumps({k: round(v, 3) for k, v in stage.items()})}; "
        f"launches {counts}")
    log(f"  eval_results {json.dumps(results)}")
    log(f"  hdf5 volumes read back bit-exact: {checked}")
    if not results or not all(np.isfinite(v) for v in results.values()):
        raise RuntimeError(f"17c test_fusion: metrics {results}")
    if len(checked) != 3:
        raise RuntimeError(f"17c: {len(checked)} hdf5 volumes saved")
    require(counts, ["median_filter3d", "build_shadow_dirty",
                     "reconcile_slot", "reconcile_key"], "17c test_fusion")
    return counts


def scannet_raw(dev, root: str, frames: int = 32):
    """Phase 17f: a raw ScanNet scan (32 frames of 640x480, no hdf):
    ``test_fusion`` on scannet.yaml (320x240, v3 gf 6, AdapNet++ stage 2
    with 21 classes predicting; seeded checkpoints at the config's paths;
    ``save_mode: test``, the volumes read back bit-exact) over
    ``create_grid``'s 1 cm grid, then ``test_segmentation`` on
    scannet_multi.yaml with ``output_benchmark``; returns the launch
    counts of ``test_fusion``."""
    import cv2
    t0 = time.perf_counter()
    lst, _, _ = write_scannet_tree(root, 2, frames, dev, 0.025)
    log(f"17f ScanNet scan ({frames} frames, 640x480, depth rendered on "
        f"{dev}, no hdf) written in {time.perf_counter() - t0:.2f} s")
    cfg = load_config(SCANNET_FUSION)
    testing = cfg.TESTING
    testing.fusion_model_path = seeded_checkpoint(
        build_fusion_net(cfg.FUSION_MODEL),
        os.path.join(root, testing.fusion_model_path), 3)
    testing.semantic_2d_model_path = seeded_checkpoint(
        build_adapnet(cfg.SEMANTIC_2D_MODEL),
        os.path.join(root, testing.semantic_2d_model_path), 4)
    cfg.SETTINGS.experiment_path = os.path.join(root, "scannet_ws")
    cfg.DATA.update(root_dir=root, test_scene_list=lst)
    shape = get_data("ScanNet", get_data_config(cfg, "test"), dev
                     ).create_grid("scene0000_00", 0.1)[0].shape
    stages = [(ScanNet, "__getitem__", False)] + [
        (Database, name, True) for name in (
            "__init__", "filter", "filter_semantics", "evaluate",
            "evaluate_fscore", "save")] + [(Pipeline, "fuse_many", True)]
    torch.cuda.synchronize()
    reset_counts()
    with stage_seconds(stages) as stage, hdf5_saves_checked() as checked:
        t0 = time.perf_counter()
        results = entry.test_fusion(cfg, dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = read_counts()
    if len(checked) != 3:
        raise RuntimeError(f"17f: {len(checked)} hdf5 volumes saved")
    fuse = stage["Pipeline.fuse_many"]
    log(f"17f test_fusion (scannet.yaml, {frames} frames of 320x240 into "
        f"{shape} at 1 cm from the ply, v3 gf 6, stage 2 "
        f"predicting 21 classes): {secs:.3f} s in all; fuse_many "
        f"{fuse:.3f} s = {frames / fuse:.2f} frames/s; the loader "
        f"{stage['ScanNet.__getitem__']:.3f} s in its thread (a share "
        f"{stage['ScanNet.__getitem__'] / secs:.3f} of the wall time); "
        f"stages {json.dumps({k: round(v, 3) for k, v in stage.items()})}"
        f"; launches {counts}")
    log(f"  eval_results {json.dumps(results)}")
    log(f"  hdf5 volumes read back bit-exact: {checked}")
    if not results or not all(np.isfinite(v) for v in results.values()):
        raise RuntimeError(f"17f test_fusion: metrics {results}")
    require(counts, ["median_filter3d", "build_shadow_dirty",
                     "reconcile_slot", "reconcile_key"], "17f test_fusion")

    scfg = load_config(SCANNET_SEG)
    scfg.SETTINGS.experiment_path = os.path.join(root, "scannet_seg")
    scfg.TESTING.update(semantic_2d_model_path=testing.semantic_2d_model_path,
                        output_benchmark=True)
    scfg.DATA.update(root_dir=root, test_scene_list=lst)
    t0 = time.perf_counter()
    metrics = seg_test.test_segmentation(scfg, dev)
    bench = os.path.join(scfg.SETTINGS.experiment_path, scfg.TIMESTAMP,
                         "output", "benchmark")
    files = sorted(os.listdir(bench))
    first = cv2.imread(os.path.join(bench, files[0]), -1)
    log(f"17f test_segmentation (scannet_multi.yaml, output_benchmark): "
        f"{time.perf_counter() - t0:.2f} s; {metrics}; {len(files)} "
        f"benchmark PNGs, {files[0]} {first.shape} {first.dtype} ids "
        f"{np.unique(first).tolist()}")
    if (files != sorted(f"scene0000_00_{i}.png" for i in range(frames))
            or first.shape != (240, 320) or first.max() >= 21):
        raise RuntimeError("17f: benchmark PNGs missing or wrong")
    return counts


def augmentations_check():
    """Phase 17g: ``get_composed_augmentations`` over every key on a
    256x256 Replica-sized pair, seeded: shapes, dtypes, and the mask
    label-valued (the random rescale-and-crops at half the frame, so
    that the crop never has to enlarge, which resizes the mask
    bicubically as in the JAX package); host ms."""
    keys = {"gamma": 0.2, "hue": 0.1, "brightness": 0.2, "saturation": 0.2,
            "contrast": 0.2, "rcrop": 224, "ccrop": 200, "hflip": 0.5,
            "vflip": 0.5, "scale": 256, "rscale_crop": 128, "rsize": 128,
            "rsizecrop": 224, "rotate": 10, "translate": 8}
    rng = np.random.RandomState(5)
    img = rng.uniform(0, 255, (256, 256, 3)).astype(np.float32)
    mask = rng.randint(0, 30, (256, 256)).astype(np.uint8)
    t0 = time.perf_counter()
    out = {}
    for key, param in keys.items():
        aug = get_composed_augmentations({key: param}, rng=random.Random(7))
        out[key] = aug(img, mask)
    ms = (time.perf_counter() - t0) * 1e3
    bad = [k for k, (i, m) in out.items()
           if i.dtype != np.float32 or m.dtype != np.uint8
           or i.shape[:2] != m.shape
           or not set(np.unique(m)) <= set(np.unique(mask))]
    log(f"17g augmentations: {len(out)} keys on a 256x256 pair in "
        f"{ms:.1f} ms on the host; shapes "
        f"{ {k: i.shape[:2] for k, (i, _) in out.items()} }")
    if bad:
        raise RuntimeError(f"17g augmentations: {bad}")


def phase17(dev):
    """Phase 17: the real-data loaders on their datasets' layouts; returns
    the launch counts of its main-path runs (17d's train_fusion, 17c's
    and 17f's test_fusion)."""
    import cv2
    import PIL
    t_all = time.perf_counter()
    log(f"17a host libraries: cv2 {cv2.__version__}, PIL {PIL.__version__}"
        f"; hdf5 through segfusion_tpu_torch/utils/hdf5.py")
    counts = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_replica_") as root:
        lst = replica_loader(dev, root)
        replica_segmentation(dev, root, lst)
        torch.cuda.empty_cache()
        lists = room_lists(root, lst)
        cfg = load_config(REPLICA_FUSION)
        seg_ckpt = seeded_checkpoint(
            build_adapnet(cfg.SEMANTIC_2D_MODEL),
            os.path.join(root, cfg.TESTING.semantic_2d_model_path), 5)
        t0 = time.perf_counter()
        best, counts = replica_train(dev, root, lists, seg_ckpt)
        torch.cuda.empty_cache()
        for k, n in replica_test(dev, root, lists, seg_ckpt, best).items():
            counts[k] += n
        log(f"17c-d: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scannet_") as root:
        for k, n in scannet_raw(dev, root).items():
            counts[k] += n
    torch.cuda.empty_cache()
    augmentations_check()
    log(f"phase 17: {time.perf_counter() - t_all:.1f} s")
    return counts


def joint_demo(dev):
    """Phase 18: ``quality_demo`` on synthetic_tpu_demo_joint.yaml (60
    frames an epoch, 256x256, voxel 0.05, v3 gf 6 with the semantic head,
    bf16; ``save_mode: test``), cut from 3 epochs to 2: the config's 3 took 99-116 s
    on an H100 at 700 W, over the phase's ~90 s. The trained net against
    random weights, each through ``test_fusion``. Fails unless the trained
    TSDF IoU and mesh F-score each beat random init's by DEMO_MARGIN;
    returns the launch counts."""
    cfg = load_config(DEMO_JOINT)
    cfg.TRAINING.n_epochs = 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_demo_") as path:
        cfg.SETTINGS.experiment_path = path
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        trained, rand, _ = quality_demo(cfg, dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
    log(f"phase 18 joint quality demo (synthetic_tpu_demo_joint.yaml, 2 "
        f"epochs x 60 frames): {secs:.1f} s; launches {counts}")
    log(f"  trained {json.dumps(trained)}")
    log(f"  random {json.dumps(rand)}")
    short = [k for k in ("iou", "mesh_fscore")
             if not trained[k] >= rand[k] + DEMO_MARGIN]
    if short:
        raise RuntimeError(f"joint demo: trained {short} not above random "
                           f"init by {DEMO_MARGIN}")
    return counts


# -- phase 19: orbax checkpoints ----------------------------------------------

def nested(flat: dict) -> dict:
    """A module's state dict as nested dicts (its dotted names split)."""
    out: dict = {}
    for name, value in flat.items():
        node = out
        *head, last = name.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    return out


def flattened(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out |= flattened(v, f"{prefix}.{k}" if prefix else k)
        return out
    return {prefix: tree}


def leaf_bits(x):
    """(shape, element size, bytes) of a tensor, array or scalar leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        return (tuple(t.shape), t.element_size(),
                t.reshape(-1).view(torch.uint8).numpy().tobytes())
    if isinstance(x, (bool, int, float)):
        return (), None, repr(x).encode()
    a = np.asarray(x)
    return a.shape, a.itemsize, a.tobytes()


def require_same_leaves(ref: dict, got: dict, what: str):
    """Raises unless ``got`` holds ``ref``'s keys with bit-equal leaves."""
    ref_f, got_f = flattened(ref), flattened(got)
    if sorted(ref_f) != sorted(got_f):
        raise RuntimeError(f"{what}: keys differ: "
                           f"{sorted(set(ref_f) ^ set(got_f))[:5]}")
    bad = [k for k in ref_f if leaf_bits(ref_f[k]) != leaf_bits(got_f[k])]
    if bad:
        raise RuntimeError(f"{what}: {len(bad)} leaves differ, e.g. "
                           f"{bad[:5]}")


def checkpoint_state(dev, trained, adapnet, n: int = 448) -> dict:
    """Phase 9's trained FusionNet (float32 masters, their bf16 copies,
    the rmsprop state, the step counter), the headline's AdapNet++ stage
    2 and an n^3 float32 TSDF + uint8 label scene volume."""
    net, optimizer = trained["fusion_net"], trained["optimizer"]
    fusion = {k: v.detach() for k, v in net.state_dict().items()}
    ax = (torch.arange(n, device=dev, dtype=torch.float32) + 0.5) / n - 0.5
    dist = torch.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2
                      + ax[None, None, :] ** 2) - 0.3
    return {
        "fusion": nested(fusion),
        "fusion_bf16": nested({k: v.to(torch.bfloat16) for k, v in
                               fusion.items() if v.is_floating_point()}),
        "segmenter": nested({k: v.detach() for k, v in
                             adapnet.state_dict().items()}),
        "opt_state": optimizer.state_dict_flax(),
        "step": int(optimizer.count), "epoch": 1, "best_iou": 0.25,
        "scene": {"tsdf": torch.clamp(dist / 0.01, -1, 1),
                  "labels": label_volume((n, n, n), dev, seed=19)},
    }


def state_bytes(tree) -> int:
    return sum(len(leaf_bits(v)[2]) for v in flattened(tree).values())


def fuse_many_nets(cfg, dev, fusion_net, adapnet):
    """Phase 7's stream through ``fuse_many`` and the label median with
    the given nets; (the scene's volume, launch counts)."""
    data = Synthetic(cfg.DATA, device=dev)
    db = Database(data, cfg.DATA, device=dev)
    pipe = Pipeline(cfg, segmenter=SegmenterAdapter(adapnet.eval()),
                    fusion_net=fusion_net, device=dev)
    batches = []
    for i in range(len(data)):
        item = data[i]
        batches.append({k: (np.asarray(v)[None] if isinstance(v, np.ndarray)
                            else v) for k, v in item.items()}
                       | {"frame_id": [item["frame_id"]]})
    torch.cuda.synchronize()
    reset_counts()
    pipe.fuse_many(batches, db, chunk=4)
    db.filter_semantics()
    torch.cuda.synchronize()
    counts = read_counts()
    s = data.scenes[0]
    check_volume(db.volumes[s], "phase 19a fuse_many volume")
    return db.volumes[s], counts


def restored_nets(cfg, dev, restored, dtype):
    """A FusionNet v3 and an AdapNet++ built anew and loaded from a
    checkpoint read without a template (numpy and bf16 host leaves)."""
    def tensors(tree):
        return {k: torch.as_tensor(v) for k, v in flattened(tree).items()}
    net = build_fusion_net(cfg.FUSION_MODEL)
    net.load_state_dict(tensors(restored["fusion"]))
    adapnet = build_adapnet(cfg.SEMANTIC_2D_MODEL).to(dev, dtype)
    adapnet.load_state_dict(tensors(restored["segmenter"]))
    return net, adapnet


def orbax_round_trip(dev, trained):
    """Phase 19a; returns the launch counts of the restored nets' run."""
    cfg = headline_config()
    cfg.DATA.update(n_frames=6, voxel_resolution=0.05, noise_sigma=0.01)
    dtype = (torch.bfloat16 if cfg.SEMANTIC_2D_MODEL.get("compute_dtype")
             in ("bfloat16", "bf16") else torch.float32)
    adapnet = seeded_init(build_adapnet(cfg.SEMANTIC_2D_MODEL),
                          torch.Generator().manual_seed(5)).to(dev, dtype)
    state = checkpoint_state(dev, trained, adapnet)
    torch.cuda.synchronize()
    mb = state_bytes(state) / 1e6
    n_leaves = len(flattened(state))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_orbax_") as root:
        path = os.path.join(root, "ckpt")
        t0 = time.perf_counter()
        save_checkpoint_orbax(state, path)
        t_save = time.perf_counter() - t0
        on_disk = sum(os.path.getsize(os.path.join(b, f))
                      for b, _, fs in os.walk(path) for f in fs) / 1e6
        log(f"phase 19a save_checkpoint_orbax: {n_leaves} leaves, "
            f"{mb:.1f} MB in {t_save:.3f} s = {mb / t_save:.1f} MB/s "
            f"(host; {on_disk:.1f} MB on disk)")
        t0 = time.perf_counter()
        plain = load_checkpoint_orbax(path)
        t_load = time.perf_counter() - t0
        log(f"phase 19a load_checkpoint_orbax without a template: "
            f"{mb:.1f} MB in {t_load:.3f} s = {mb / t_load:.1f} MB/s (host)")
        t0 = time.perf_counter()
        templated = load_checkpoint_orbax(path, state)
        torch.cuda.synchronize()
        t_tmpl = time.perf_counter() - t0
        log(f"phase 19a load_checkpoint_orbax into the state's tensors on "
            f"the card: {mb:.1f} MB in {t_tmpl:.3f} s = "
            f"{mb / t_tmpl:.1f} MB/s (host, the copies to the card "
            f"included)")
    require_same_leaves(state, plain, "phase 19a load without a template")
    require_same_leaves(state, templated, "phase 19a load with a template")
    cuda_leaves = [k for k, v in flattened(templated).items()
                   if isinstance(v, torch.Tensor) and v.device != dev]
    if cuda_leaves or not isinstance(plain["scene"]["tsdf"], np.ndarray):
        raise RuntimeError(f"phase 19a: leaves off the card {cuda_leaves[:3]}"
                           f" or a tensor where numpy was due")
    log(f"phase 19a: every leaf bit-equal both ways ({n_leaves} leaves, "
        f"bf16 ones as torch.bfloat16, step {plain['step']})")
    del templated, state
    torch.cuda.empty_cache()

    net_b, adapnet_b = restored_nets(cfg, dev, plain, dtype)
    # the integration's atomic scatter-adds make two runs of one stream
    # differ in the low bits; torch's deterministic forms make them equal
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        vol_a, _ = fuse_many_nets(cfg, dev, trained["fusion_net"], adapnet)
        vol_b, counts = fuse_many_nets(cfg, dev, net_b, adapnet_b)
    finally:
        torch.use_deterministic_algorithms(was)
    fields = [f.name for f in dataclasses.fields(vol_a)
              if isinstance(getattr(vol_a, f.name), torch.Tensor)]
    bad = [f for f in fields if not torch.equal(getattr(vol_a, f),
                                                getattr(vol_b, f))]
    if bad or not fields:
        raise RuntimeError(f"phase 19a: fuse_many with the restored nets "
                           f"differs in {bad}")
    log(f"phase 19a fuse_many + label median with the restored nets: "
        f"bit-equal to the nets in memory, deterministic algorithms "
        f"({', '.join(fields)}); "
        f"launches {counts}")
    require(counts, ["reconcile_slot", "reconcile_key", "median_filter3d"],
            "phase 19a")
    if counts["build_shadow"] + counts["build_shadow_dirty"] == 0:
        raise RuntimeError("phase 19a: no shadow build launched")
    return counts


def orbax_fixture(dev):
    """Phase 19b: the JAX package's orbax checkpoint, real zstd."""
    seed = fixtures.orbax_small_state()
    bf16 = {".".join(k) for k in fixtures.BF16_LEAVES}
    template = {k: (torch.as_tensor(v, device=dev).to(torch.bfloat16)
                    if k in bf16 else torch.as_tensor(np.asarray(v),
                                                      device=dev))
                if isinstance(v, np.ndarray) else v
                for k, v in flattened(seed).items()}
    t0 = time.perf_counter()
    got = load_checkpoint_orbax(fixtures.ORBAX_SMALL, nested(template))
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    require_same_leaves(nested(template), got, "phase 19b fixture")
    store = ocdbt.open_store(fixtures.ORBAX_SMALL)
    frames = [store.read(k) for k in store.keys()
              if not k.endswith(b"/.zarray")]
    t0 = time.perf_counter()
    fast = [bytes(zstd.decompress(f)) for f in frames]
    t_fast = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = [zstd.decompress_plain(f) for f in frames]
    t_plain = time.perf_counter() - t0
    if fast != slow:
        raise RuntimeError("phase 19b: the C++ zstd decoder differs from "
                           "the plain one")
    n_in, n_out = sum(map(len, frames)), sum(map(len, fast))
    log(f"phase 19b orbax fixture (JAX package's save_checkpoint_orbax, "
        f"{len(template)} leaves): loaded onto the card in {t_load:.3f} s, "
        f"every leaf equal to its seed's; {len(frames)} zstd frames, "
        f"{n_in} -> {n_out} bytes: C++ {1e3 * t_fast:.2f} ms, plain "
        f"{1e3 * t_plain:.2f} ms, equal")


def orbax_checkpoints(dev, trained):
    """Phase 19; returns 19a's launch counts."""
    t0 = time.perf_counter()
    counts = orbax_round_trip(dev, trained)
    orbax_fixture(dev)
    log(f"phase 19: {time.perf_counter() - t0:.1f} s")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)}")
    log(f"card default: torch.backends.cuda.matmul."
        f"allow_bf16_reduced_precision_reduction = "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    log("torch.backends.cudnn.allow_tf32 = False, "
        "torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction "
        "= False")

    t0 = time.perf_counter()
    builds = [lambda: _build.load_library("shadow_build"),
              lambda: _build.load_library("median3d"),
              lambda: _build.load_library("probes"),
              lambda: _build.load_host_library(MCUBES_SOURCE),
              lambda: _build.load_host_library(RASTERIZE_SOURCE),
              lambda: _build.load_host_library(SIMPLIFY_SOURCE),
              lambda: _build.load_host_library(zstd.ZSTD_SOURCE)]
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
    counts, trained = training(dev)
    torch.cuda.empty_cache()
    for phase_counts in (counts, train_entry_point(dev)):
        for k, n in phase_counts.items():
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
    for k, n in phase14(dev).items():
        launches[k] += n
    folded, more = phase15(dev)
    for k, n in more.items():
        launches[k] += n
    for name, r in folded.items():
        results[name].update(r)
    for phase in (phase16, phase17, joint_demo):
        for k, n in phase(dev).items():
            launches[k] += n
        torch.cuda.empty_cache()
    for k, n in orbax_checkpoints(dev, trained).items():
        launches[k] += n

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
