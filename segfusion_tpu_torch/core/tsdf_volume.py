"""Classic (non-learned) TSDF volume classes over ``ops/tsdf_fusion.py``.

Port of ``segfusion_tpu/core/tsdf_volume.py``, the API of the reference's
native tsdf dependency: ``TSDFVolume.fuse`` (truncated running average
and free-space votes), ``sanity_fuse`` (visibility counting),
``MulticlassTSDFVolume.fuse`` (label-probability voting) and
``depth_rendering`` (``ops/raycast.render_depth``). The state stays on
``device`` (the card unless the caller names the CPU) between calls;
the properties return host numpy copies.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.raycast import render_depth
from ..ops.tsdf_fusion import (_project, fuse_frame,
                               fuse_frame_multiclass)

__all__ = ["TSDFVolume", "MulticlassTSDFVolume", "Volume"]

_FREE_SPACE_UNSET = 10.0e7  # the reference's sentinel


def _grid_shape(bbox, resolution):
    return tuple(int(np.ceil((bbox[i, 1] - bbox[i, 0]) / resolution))
                 for i in range(3))


class _Frame:
    """A frame's inputs as f32 tensors on the volume's device."""

    def __init__(self, device, proj, depth, origin, resolution, truncation):
        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                   device=device)
        self.proj, self.depth, self.origin = t(proj), t(depth), t(origin)
        self.resolution = t(resolution)
        self.truncation = t(truncation)


class TSDFVolume:
    """Truncated signed distance volume with free-space voting over the
    (3, 2) world ``bbox`` at ``resolution``; ``max_distance`` is the
    truncation band (metres)."""

    def __init__(self, bbox, resolution: float, max_distance: float = 0.1,
                 free_space_vote: float = 1.0, init_value: float = 0.0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.bbox = np.asarray(bbox, np.float64)
        self.resolution = float(resolution)
        self.max_distance = float(max_distance)
        self.free_space_vote = float(free_space_vote)
        self.shape = _grid_shape(self.bbox, resolution)
        dev = self.device
        self._tsdf = torch.full(self.shape, init_value or max_distance,
                                dtype=torch.float32, device=dev)
        self._weights = torch.zeros(self.shape, dtype=torch.float32,
                                    device=dev)
        self._free_space = torch.full(self.shape, _FREE_SPACE_UNSET,
                                      dtype=torch.float32, device=dev)
        self._update_mask = torch.zeros(self.shape, dtype=torch.int32,
                                        device=dev)

    @property
    def origin(self):
        return self.bbox[:, 0].astype(np.float32)

    @property
    def volume(self):
        return self._tsdf.cpu().numpy()

    @property
    def weights(self):
        return self._weights.cpu().numpy()

    @property
    def free_space(self):
        return self._free_space.cpu().numpy()

    def get_mask(self):
        """Per-voxel count of in-band observations."""
        return self._update_mask.cpu().numpy()

    def _frame(self, proj, depth, truncation=None):
        return _Frame(self.device, proj, depth, self.origin, self.resolution,
                      self.max_distance if truncation is None else truncation)

    def fuse(self, depth_proj_matrix, depth_map,
             weight_map: Optional[np.ndarray] = None):
        """Fuse one depth frame, with the free-space votes of the voxels
        between camera and surface."""
        f = self._frame(depth_proj_matrix, depth_map)
        wmap = (None if weight_map is None else torch.as_tensor(
            np.ascontiguousarray(weight_map, np.float32),
            device=self.device))
        self._tsdf, self._weights = fuse_frame(
            self._tsdf, self._weights, f.depth, f.proj, f.origin,
            f.resolution, f.truncation, wmap)
        self._free_space, self._update_mask = _free_space_and_mask(
            self._free_space, self._update_mask, f, self.free_space_vote)

    def sanity_fuse(self, depth_proj_matrix, depth_map):
        """Visibility only: count the in-band voxels, the TSDF untouched."""
        f = self._frame(depth_proj_matrix, depth_map)
        _, self._update_mask = _free_space_and_mask(
            self._free_space, self._update_mask, f, 0.0)

    def depth_rendering(self, extrinsics, intrinsics, shape: Tuple[int, int]):
        """Ray-march an (h, w) depth map from the fused volume."""
        h, w = shape

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                   device=self.device)
        return render_depth(self._tsdf, t(extrinsics), t(intrinsics),
                            t(self.origin), self.resolution, h,
                            w).cpu().numpy()


def _free_space_and_mask(free_space, update_mask, f: _Frame, vote: float):
    """One frame's free-space votes (voxels beyond the band in front of
    the surface: -vote, summed) and in-band observation counts."""
    _, valid, sdf = _project(tuple(free_space.shape), f.depth, f.proj,
                             f.origin, f.resolution)
    in_band = valid & (torch.abs(sdf) <= f.truncation)
    free = valid & (sdf > f.truncation)
    fs = torch.where(free & (free_space == _FREE_SPACE_UNSET), -vote,
                     torch.where(free, free_space - vote, free_space))
    return fs, update_mask + in_band.to(torch.int32)


class MulticlassTSDFVolume(TSDFVolume):
    """TSDF plus per-voxel label-probability voting."""

    def __init__(self, bbox, resolution: float, n_classes: int,
                 max_distance: float = 0.1, **kw):
        super().__init__(bbox, resolution, max_distance, **kw)
        self.n_classes = int(n_classes)
        self._label_probs = torch.zeros(self.shape + (self.n_classes,),
                                        dtype=torch.float32,
                                        device=self.device)

    @property
    def label_probs(self):
        return self._label_probs.cpu().numpy()

    @property
    def labels(self):
        return self._label_probs.argmax(-1).to(torch.uint8).cpu().numpy()

    def fuse(self, depth_proj_matrix, depth_map, label_map,
             weight_map=None):
        f = self._frame(depth_proj_matrix, depth_map)
        labels = torch.as_tensor(np.ascontiguousarray(label_map),
                                 device=self.device)
        self._tsdf, self._weights, self._label_probs = fuse_frame_multiclass(
            self._tsdf, self._weights, self._label_probs, f.depth, labels,
            f.proj, f.origin, f.resolution, f.truncation)
        self._free_space, self._update_mask = _free_space_and_mask(
            self._free_space, self._update_mask, f, self.free_space_vote)


class Volume:
    """Visibility counter: per voxel, the frames that observed it in
    band."""

    def __init__(self, bbox, resolution: float, device="cuda"):
        self.device = resolve_device(device)
        self.bbox = np.asarray(bbox, np.float64)
        self.resolution = float(resolution)
        self.shape = _grid_shape(self.bbox, resolution)
        self._count = torch.zeros(self.shape, dtype=torch.int32,
                                  device=self.device)
        self._free = torch.full(self.shape, _FREE_SPACE_UNSET,
                                dtype=torch.float32, device=self.device)

    @property
    def volume(self):
        return self._count.cpu().numpy()

    def fuse(self, depth_proj_matrix, depth_map, truncation: float = 0.1):
        f = _Frame(self.device, depth_proj_matrix, depth_map,
                   self.bbox[:, 0], self.resolution, truncation)
        self._free, self._count = _free_space_and_mask(self._free,
                                                       self._count, f, 1.0)
