"""Scene volume state: Voxelgrid bbox math + device-resident SceneVolume.

Port of ``segfusion_tpu/core/volume.py``. The state is the accumulator
form: ``num`` = sum(w * tsdf update), ``weights`` = sum(w), ``semkey`` =
packed monotonic (score, id); the reference-visible ``tsdf``,
``semantics`` and ``scores`` views are materialised on access.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.integrate import unpack_semantic_key

__all__ = ["Voxelgrid", "SceneVolume", "init_scene_volume"]


class Voxelgrid:
    """Host-side voxel grid: an array + bbox/origin/resolution metadata."""

    def __init__(self, resolution: float):
        self.resolution = float(resolution)
        self.volume: Optional[np.ndarray] = None
        self.bbox: Optional[np.ndarray] = None

    def from_array(self, array: np.ndarray, bbox: np.ndarray):
        if array.ndim != 3:
            raise ValueError(f"expected a 3-D array, got {array.shape}")
        self.volume = array
        self.bbox = np.asarray(bbox, dtype=np.float64)
        return self

    @classmethod
    def create(cls, bbox, resolution: float, init_value=0.0,
               dtype=np.float32) -> "Voxelgrid":
        """A grid over ``bbox`` (3, 2) of ``ceil(extent / resolution)``
        voxels an axis, every voxel ``init_value``."""
        bbox = np.asarray(bbox, dtype=np.float64)
        shape = tuple(
            int(np.ceil((bbox[i, 1] - bbox[i, 0]) / resolution))
            for i in range(3))
        grid = cls(resolution)
        grid.from_array(np.full(shape, init_value, dtype=dtype), bbox)
        return grid

    @property
    def origin(self) -> np.ndarray:
        return self.bbox[:, 0].astype(np.float32)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self.volume.shape)

    def world_to_voxel(self, points: np.ndarray) -> np.ndarray:
        """World points (..., 3) -> continuous voxel coordinates."""
        return (np.asarray(points) - self.origin[None, :]) / self.resolution

    def voxel_to_world(self, indices: np.ndarray) -> np.ndarray:
        """Voxel coordinates (..., 3) -> world points."""
        return np.asarray(indices) * self.resolution + self.origin[None, :]


@dataclasses.dataclass
class SceneVolume:
    """Per-scene fusion state, tensors on one device."""
    num: torch.Tensor           # (xs, ys, zs) f32, sum(w * v)
    weights: torch.Tensor       # (xs, ys, zs) f32, sum(w)
    semkey: torch.Tensor        # (xs, ys, zs) int32 packed (score, id)
    origin: torch.Tensor        # (3,) f32
    resolution: torch.Tensor    # () f32
    init_value: float = 0.1

    @property
    def shape(self):
        return self.num.shape

    @property
    def tsdf(self) -> torch.Tensor:
        w = self.weights
        return torch.where(w > 0, self.num / torch.clamp_min(w, 1e-12),
                           float(self.init_value))

    @property
    def semantics(self) -> torch.Tensor:
        return unpack_semantic_key(self.semkey)[1]

    @property
    def scores(self) -> torch.Tensor:
        return unpack_semantic_key(self.semkey)[0]

    def reset(self, init_value: Optional[float] = None) -> "SceneVolume":
        """A fresh (all-zero) state of the same geometry and device."""
        return SceneVolume(
            num=torch.zeros_like(self.num),
            weights=torch.zeros_like(self.weights),
            semkey=torch.zeros_like(self.semkey),
            origin=self.origin,
            resolution=self.resolution,
            init_value=float(self.init_value if init_value is None
                             else init_value))


def init_scene_volume(shape: Tuple[int, int, int], origin, resolution: float,
                      init_value: float = 0.1, device="cuda") -> SceneVolume:
    """A fresh (all-zero) SceneVolume on ``device``."""
    device = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    return SceneVolume(
        num=torch.zeros(shape, dtype=torch.float32, device=device),
        weights=torch.zeros(shape, dtype=torch.float32, device=device),
        semkey=torch.zeros(shape, dtype=torch.int32, device=device),
        origin=torch.as_tensor(np.asarray(origin, np.float32),
                               device=device),
        resolution=torch.tensor(float(resolution), dtype=torch.float32,
                                device=device),
        init_value=float(init_value))
