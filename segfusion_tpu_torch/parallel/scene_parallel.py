"""Scene-parallel fusion: N scenes fused together across a device mesh.

Port of ``segfusion_tpu/parallel/scene_parallel.py``. The per-frame
recurrence is sequential within a scene but independent across scenes.
The runner stacks same-shape scene volumes on a leading axis and gives
each mesh device a contiguous group of whole scenes and a replica of the
nets; each device runs the scene-folded step of its group
(``Pipeline.step_fuse_scenes`` / ``fuse_sequence_scenes``: the nets once
over the group's frames, each slot kernel once over the group's folded
volume), with no communication. The groups are launched in turn from this
one host thread; CUDA's asynchrony overlaps the devices.

A stacked ``SceneVolume`` holds (S, X, Y, Z) tensors, origin (S, 3) and
resolution (S,); a sharded one is the list of the groups' stacked
volumes, one a device, in scene order.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Union

import torch

from ..core.pipeline import Pipeline
from ..core.volume import SceneVolume
from ..models.adapnet import SegmenterAdapter
from .mesh import Mesh, replicate, scene_mesh, shard_batch

__all__ = ["SceneParallelFusion", "stack_volumes", "unstack_volumes"]

Volumes = Union[SceneVolume, List[SceneVolume]]


def stack_volumes(volumes: List[SceneVolume]) -> SceneVolume:
    """Stack same-shape SceneVolumes on a new leading scene axis (on the
    first volume's device)."""
    shapes = {tuple(v.num.shape) for v in volumes}
    if len(shapes) != 1:
        raise ValueError(
            f"scene-parallel fusion needs equal volume shapes, got {shapes} "
            "(use DATA.pad_shape_multiple to bucket shapes)")
    dev = volumes[0].num.device

    def stack(name):
        return torch.stack([getattr(v, name).to(dev) for v in volumes])

    return SceneVolume(num=stack("num"), weights=stack("weights"),
                       semkey=stack("semkey"), origin=stack("origin"),
                       resolution=stack("resolution"),
                       init_value=volumes[0].init_value)


def unstack_volumes(stacked: Volumes, n: int) -> List[SceneVolume]:
    """The n scenes of a stacked (or sharded) volume, as views."""
    groups = stacked if isinstance(stacked, list) else [stacked]
    out = [SceneVolume(num=g.num[i], weights=g.weights[i],
                       semkey=g.semkey[i], origin=g.origin[i],
                       resolution=g.resolution[i], init_value=g.init_value)
           for g in groups for i in range(g.num.shape[0])]
    if len(out) != n:
        raise ValueError(f"{len(out)} scenes, expected {n}")
    return out


def _device_key(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class SceneParallelFusion:
    """Fuse S scenes together, each mesh device a contiguous group.

    Args:
      pipeline: a configured inference Pipeline; its nets are copied once
        to each other device of the mesh.
      mesh: a 1-D ``mesh.Mesh`` (axis 'scene'); defaults to every visible
        CUDA device.
    """

    def __init__(self, pipeline: Pipeline, mesh: Optional[Mesh] = None):
        self.pipeline = pipeline
        self.mesh = mesh if mesh is not None else scene_mesh()
        self._all_devices = self.mesh.devices
        self._replicas = {_device_key(pipeline.device): pipeline}

    def _replica(self, device: torch.device) -> Pipeline:
        """The pipeline whose nets live on ``device``."""
        key = _device_key(device)
        if key not in self._replicas:
            p = self.pipeline
            seg = (None if p.segmenter is None else SegmenterAdapter(
                copy.deepcopy(p.segmenter.model).to(key),
                p.segmenter.input_mode))
            self._replicas[key] = Pipeline(
                p.config, segmenter=seg,
                fusion_net=copy.deepcopy(p.fusion_net), device=key)
        return self._replicas[key]

    def _fit_mesh(self, n_scenes: int) -> None:
        """Fit the mesh to the largest divisor of ``n_scenes`` that the
        devices allow (every group the same size; idle trailing devices
        cost nothing). Always refit from the FULL device list, so a small
        batch (2 scenes on 8 devices) does not shrink the runner for later
        larger batches."""
        size = len(self._all_devices)
        d = max(k for k in range(1, min(size, n_scenes) + 1)
                if n_scenes % k == 0)
        if d != self.mesh.size:
            self.mesh = Mesh(self._all_devices[:d], self.mesh.axis_name)

    def shard_volumes(self, stacked: SceneVolume) -> List[SceneVolume]:
        """Split a stacked volume into the mesh's groups, each on its
        device (a group on the device the volume lies on is a view)."""
        self._fit_mesh(stacked.num.shape[0])
        return shard_batch(self.mesh, stacked)

    def replicate(self, tree):
        return replicate(self.mesh, tree)

    def _groups(self, volumes: Volumes) -> List[SceneVolume]:
        return (volumes if isinstance(volumes, list)
                else self.shard_volumes(volumes))

    @staticmethod
    def _split(frames: Dict, groups: List[SceneVolume]) -> List[Dict]:
        """The frames' scene axis cut to the groups, each on its device."""
        parts, a = [], 0
        for g in groups:
            b = a + g.num.shape[0]
            parts.append({k: torch.as_tensor(x)[a:b].to(g.num.device)
                          for k, x in frames.items()})
            a = b
        return parts

    def step(self, volumes: Volumes, frames: Dict) -> List[SceneVolume]:
        """One frame per scene: ``frames`` leaves lead with the scene axis.
        Returns the updated sharded volumes."""
        groups = self._groups(volumes)
        return [self._replica(g.num.device).step_fuse_scenes(
                    g, {k: x[:, None] for k, x in f.items()})
                for g, f in zip(groups, self._split(frames, groups))]

    def run_sequences(self, volumes: Volumes, frames: Dict
                      ) -> List[SceneVolume]:
        """Fuse whole frame streams for all scenes: ``frames`` leaves have
        shape (S, T, ...), ``volumes`` is the stacked (or sharded) state.
        Each device streams its group through ``fuse_sequence_scenes``
        (the multi-scene streaming shape, ``bench.py`` multi512)."""
        groups = self._groups(volumes)
        return [self._replica(g.num.device).fuse_sequence_scenes(g, f)
                for g, f in zip(groups, self._split(frames, groups))]

    def run(self, volumes: List[SceneVolume], frame_streams: List[List[Dict]]
            ) -> List[SceneVolume]:
        """Fuse aligned frame streams (stream i belongs to scene i; host
        frames as ``Pipeline._frame_from_batch`` gives them) one step a
        frame."""
        n = len(volumes)
        groups = self.shard_volumes(stack_volumes(volumes))
        for t in range(min(len(fs) for fs in frame_streams)):
            batch = {k: torch.stack([torch.as_tensor(fs[t][k])
                                     for fs in frame_streams])
                     for k in frame_streams[0][t]}
            groups = self.step(groups, batch)
        return unstack_volumes(groups, n)
