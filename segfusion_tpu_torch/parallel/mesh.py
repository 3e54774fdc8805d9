"""Device meshes: data-parallel and scene-parallel placement.

Port of ``segfusion_tpu/parallel/mesh.py``. A ``Mesh`` is a plain record of
torch devices and one axis name; a sharded tree is a list with one entry
per mesh device, that device's slice of the tree. One process drives all
the devices of a mesh (``DTensor`` and ``DeviceMesh`` would need a process
and a process group per device), and a device may appear more than once
(several shards on one card). The default mesh is every visible CUDA
device; asking for it where torch sees none raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["Mesh", "data_parallel_mesh", "shard_batch", "replicate",
           "scene_mesh"]


class Mesh(NamedTuple):
    devices: Tuple[torch.device, ...]
    axis_name: str

    @property
    def size(self) -> int:
        return len(self.devices)


def data_parallel_mesh(axis_name: str = "data",
                       devices: Sequence = None) -> Mesh:
    """A 1-D mesh over ``devices`` (default: every visible CUDA device)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(resolve_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices, axis_name)


def scene_mesh(axis_name: str = "scene", devices: Sequence = None) -> Mesh:
    """Mesh for scene-parallel fusion: each device owns whole scenes
    (volume + frame stream), the natural parallel axis of online fusion."""
    return data_parallel_mesh(axis_name, devices)


def _tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the tensor (and numpy array) leaves of dicts, lists,
    tuples and dataclasses (``SceneVolume``); other leaves pass as they
    are."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(torch.as_tensor(tree))
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def shard_batch(mesh: Mesh, tree: Any, axis: int = 0) -> list:
    """Split every tensor leaf along ``axis`` into ``mesh.size`` equal
    contiguous parts, part i on device i; a leaf whose ``axis`` is missing
    or not divisible by the mesh size is replicated. Returns one tree a
    device."""
    n = mesh.size

    def part(i):
        def put(x):
            if x.dim() <= axis or x.shape[axis] % n:
                return x.to(mesh.devices[i])
            m = x.shape[axis] // n
            return x.narrow(axis, i * m, m).to(mesh.devices[i])
        return put

    return [_tree_map(part(i), tree) for i in range(n)]


def replicate(mesh: Mesh, tree: Any) -> list:
    """A copy of every tensor leaf on each mesh device: one tree a
    device."""
    return [_tree_map(lambda x, d=d: x.to(d), tree) for d in mesh.devices]
