"""Database: per-scene volume store (minimal port).

Port of the parts of ``segfusion_tpu/core/database.py`` that
``Pipeline.fuse_many`` needs: the constructor from a dataset's grids, the
row-path Y padding, ``volumes``, ``update`` and ``reset``. Filtering,
meshing, saving and evaluation come with the port of the median kernel.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .volume import SceneVolume, init_scene_volume

__all__ = ["Database"]


class Database:
    """Per scene: origin, resolution, unpadded grid shape and the current
    fusion state (on ``device``)."""

    def __init__(self, dataset, config, device=None):
        self.initial_value = float(config.init_value)
        self.device = device

        self.scenes = []
        self.state: Dict[str, bool] = {}
        self.origin: Dict[str, np.ndarray] = {}
        self.resolution: Dict[str, float] = {}
        self.grid_shape: Dict[str, tuple] = {}   # unpadded gt shape
        self.volumes: Dict[str, SceneVolume] = {}

        for s in dataset.scenes:
            gt = dataset.get_grid(s, self.initial_value)[0]
            self.scenes.append(s)
            self.origin[s] = np.asarray(gt.origin, np.float32)
            self.resolution[s] = float(gt.resolution)
            self.grid_shape[s] = tuple(gt.volume.shape)
        self.reset()

    @staticmethod
    def _padded_shape(shape):
        """Y padded to a multiple of 8, as the JAX package pads for its
        slab kernels; kept so the slot tensors match the reference's."""
        x, y, z = (int(d) for d in shape)
        return (x, -(-y // 8) * 8, z)

    def update(self, scene_id: str, volume: SceneVolume):
        """Store the post-integration state."""
        self.volumes[scene_id] = volume
        self.state[scene_id] = True

    def reset(self, scene_id: Optional[str] = None):
        """Fresh (all-zero) estimated volumes."""
        for s in [scene_id] if scene_id else self.scenes:
            self.state[s] = False
            self.volumes[s] = init_scene_volume(
                self._padded_shape(self.grid_shape[s]), self.origin[s],
                self.resolution[s], self.initial_value, device=self.device)
