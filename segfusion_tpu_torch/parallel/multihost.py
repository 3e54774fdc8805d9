"""Multi-process scaling: process-group start-up and the scene split.

Port of ``segfusion_tpu/parallel/multihost.py`` on ``torch.distributed``.
Online fusion is embarrassingly parallel over SCENES: each process owns a
disjoint subset of the scene list (``local_scene_shard``), runs the
ordinary single-host pipeline (and ``scene_parallel``) over its own
devices, and only aggregate quantities -- training gradients, evaluation
sums -- cross processes, through one ``all_reduce``. No voxel data leaves
its process. Spatial sharding (``spatial``) stays within a process.

``initialize()`` starts the process group behind a config flag
(SETTINGS.multihost); with the flag off (the default) nothing starts and
single-process behaviour is unchanged. The backend is ``nccl`` where each
process has a card of its own, ``gloo`` otherwise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["initialize", "local_scene_shard", "is_multihost"]


def _backend_for(num_processes: int) -> str:
    """``nccl`` where this host's cards give each process its own,
    ``gloo`` otherwise (NCCL refuses two ranks on one card)."""
    return ("nccl" if torch.cuda.is_available()
            and torch.cuda.device_count() >= num_processes else "gloo")


def initialize(config=None, coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Start ``torch.distributed`` when multi-process mode is requested.

    Reads SETTINGS.multihost (bool) and SETTINGS.coordinator_address
    ("host:port"), SETTINGS.num_processes and SETTINGS.process_id from
    ``config``; explicit keyword arguments win. Nothing tells a process
    of its cluster, so all three must be given. Returns True if the
    process group is up. Idempotent."""
    if dist.is_available() and dist.is_initialized():
        return True
    settings = getattr(config, "SETTINGS", None)
    want = (bool(settings.get("multihost", False)) if settings is not None
            else coordinator_address is not None)
    if not want and coordinator_address is None:
        return False
    if settings is not None:
        coordinator_address = (coordinator_address
                               or settings.get("coordinator_address", None))
        num_processes = (num_processes
                         or settings.get("num_processes", None))
        process_id = (process_id if process_id is not None
                      else settings.get("process_id", None))
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("multi-process mode needs coordinator_address, "
                         "num_processes and process_id")
    dist.init_process_group(_backend_for(int(num_processes)),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def _rank_and_size():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_multihost() -> bool:
    return _rank_and_size()[1] > 1


def local_scene_shard(scenes: Sequence[str]) -> list:
    """This process's scene subset: a round-robin split of the global
    scene list by rank (deterministic, no communication). With one
    process this is the identity -- the single-host paths call it
    unconditionally."""
    i, n = _rank_and_size()
    return [s for k, s in enumerate(scenes) if k % n == i]
