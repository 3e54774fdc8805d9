"""Multi-process demo worker: one PROCESS of an N-process run.

Counterpart of ``tools/multihost_worker.py``. Executes the design of
``multihost.py`` end to end on separate processes:

  1. ``torch.distributed`` start-up through ``multihost.initialize`` (the
     flag-gated entry point), ``gloo`` or ``nccl`` as it chooses;
  2. scene-level data sharding: this process takes its
     ``local_scene_shard`` of the global scene list and fuses its own
     scenes with the ordinary single-host pipeline (seeded random
     FusionNet v3 weights, the same in every process) -- no voxel data
     crosses processes;
  3. the cross-process aggregate: the per-scene weight sums meet in one
     ``all_reduce``.

Run one process a rank, each with the same port, e.g. two on one card:

  python -m segfusion_tpu_torch.parallel.multihost_worker 0 2 29500 &
  python -m segfusion_tpu_torch.parallel.multihost_worker 1 2 29500

(``--device cpu`` on a machine without a card). Each prints one JSON line
tagged MULTIHOST_OK.
"""

from __future__ import annotations

import argparse
import json
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import default_config
from ..core.pipeline import Pipeline
from ..core.volume import init_scene_volume
from ..device import resolve_device
from . import multihost

SCENES = [f"scene_{i}" for i in range(5)]
H = W = 16
N_FRAMES = 2


def worker_config():
    """FusionNet v3 (5 samples, 4 tail samples, growth factor 2, no
    semantics) on 16x16 frames."""
    cfg = default_config()
    cfg.DATA.update(resx=W, resy=H, init_value=0.1)
    cfg.FUSION_MODEL.update(name="v3", n_points=5, n_tail_points=4,
                            growth_factor=2, use_semantics=False)
    return cfg


def scene_frames(index: int) -> dict:
    """Scene ``index``'s (T, ...) host frames: noisy depth around 1.25 m,
    seen from 1.5 m back along z."""
    rng = np.random.RandomState(100 + index)
    depth = 1.2 + 0.1 * rng.rand(N_FRAMES, H, W).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (N_FRAMES, 1, 1))
    poses[:, 2, 3] = -1.5
    f = 2.0 * W
    intr = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return {"depth": depth, "extrinsics": poses,
            "intrinsics": np.repeat(intr[None], N_FRAMES, 0),
            "mask": depth > 0}


def scene_volume(device):
    return init_scene_volume((16, 16, 16), [-0.8] * 3, 0.1, 0.1,
                             device=device)


def fuse_scenes(pipe: Pipeline, indices: Sequence[int]) -> float:
    """Fuse each scene's stream into a fresh volume; the sum of all their
    weights."""
    total = 0.0
    for i in indices:
        frames = {k: torch.as_tensor(v).to(pipe.device)
                  for k, v in scene_frames(i).items()}
        out = pipe.fuse_sequence(scene_volume(pipe.device), frames)
        total += float(out.weights.double().sum())
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("process_id", type=int)
    ap.add_argument("num_processes", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not multihost.initialize(coordinator_address=f"127.0.0.1:{args.port}",
                                num_processes=args.num_processes,
                                process_id=args.process_id):
        raise RuntimeError("the process group did not start")
    try:
        backend = dist.get_backend()
        device = resolve_device(args.device)
        if backend == "nccl":           # a card per rank
            device = torch.device("cuda", dist.get_rank()
                                  % torch.cuda.device_count())
        mine = multihost.local_scene_shard(SCENES)
        local = fuse_scenes(Pipeline(worker_config(), device=device),
                            [SCENES.index(s) for s in mine])
        total = torch.tensor([local], dtype=torch.float64,
                             device=device if backend == "nccl" else "cpu")
        dist.all_reduce(total)
        print(json.dumps({
            "tag": "MULTIHOST_OK", "process": dist.get_rank(),
            "processes": dist.get_world_size(), "backend": backend,
            "device": str(device), "multihost": multihost.is_multihost(),
            "scenes": mine, "local_sum": local,
            "global_sum": float(total[0])}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
