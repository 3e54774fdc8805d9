"""Classic (non-learned) TSDF fusion: every voxel projected into the
depth map and updated by the truncated running average.

Port of ``segfusion_tpu/ops/tsdf_fusion.py`` (the reference's per-voxel
``TSDFVolume.fuse`` loops and libfusion's multi-view fusion), elementwise
over the voxel grid: a 3x4 projection of each voxel centre, one depth
lookup, a masked update. The tensors' device decides where it runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device

__all__ = ["fuse_frame", "fuse_frame_multiclass", "tsdf_from_depth_views"]


def _voxel_centers_camera_projection(shape, origin, resolution, proj_matrix):
    """(px, py, pz), each of ``shape``: every voxel (x0 + i res, ...)
    projected by the 3x4 world -> image matrix ``[K | 0] @ world2cam``."""
    dev = proj_matrix.device
    ix, iy, iz = (torch.arange(n, dtype=torch.float32, device=dev)
                  for n in shape)
    x = (origin[0] + ix * resolution)[:, None, None]
    y = (origin[1] + iy * resolution)[None, :, None]
    z = (origin[2] + iz * resolution)[None, None, :]
    p = proj_matrix.float()
    return tuple(p[r, 0] * x + p[r, 1] * y + p[r, 2] * z + p[r, 3]
                 for r in range(3))


def _project(shape, depth_map, proj_matrix, origin, resolution):
    """Per voxel: the clamped pixel index, whether it is valid (in front,
    in the image, depth != 0) and the signed distance depth - z."""
    h, w = depth_map.shape
    px, py, pz = _voxel_centers_camera_projection(shape, origin, resolution,
                                                  proj_matrix)
    in_front = pz > 0
    safe_z = torch.where(in_front, pz, 1.0)
    u = torch.round(px / safe_z).to(torch.int64)
    v = torch.round(py / safe_z).to(torch.int64)
    in_image = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    lin = torch.clamp(v, 0, h - 1) * w + torch.clamp(u, 0, w - 1)
    depth = depth_map.reshape(-1)[lin]
    valid = in_front & in_image & (depth != 0.0)
    return lin, valid, depth - pz


def fuse_frame(tsdf_volume: torch.Tensor, weights_volume: torch.Tensor,
               depth_map: torch.Tensor, proj_matrix: torch.Tensor,
               origin: torch.Tensor, resolution, truncation,
               weight_map: Optional[torch.Tensor] = None):
    """Fuse one (h, w) depth frame into (tsdf, weights) volumes: voxels
    behind the camera, outside the image or on invalid depth are
    skipped; those with |sdf| <= truncation take the weighted running
    average (per-pixel ``weight_map``, default 1). Returns new volumes."""
    lin, valid, sdf = _project(tuple(tsdf_volume.shape), depth_map,
                               proj_matrix, origin, resolution)
    wpix = (torch.ones_like(sdf) if weight_map is None
            else weight_map.reshape(-1)[lin])
    in_band = valid & (torch.abs(sdf) <= truncation)
    w_add = torch.where(in_band, wpix, 0.0)
    new_w = weights_volume + w_add
    new_v = torch.where(in_band, (weights_volume * tsdf_volume + w_add * sdf)
                        / torch.clamp_min(new_w, 1e-12), tsdf_volume)
    return new_v, new_w


def fuse_frame_multiclass(tsdf_volume, weights_volume, label_probs_volume,
                          depth_map, label_map, proj_matrix, origin,
                          resolution, truncation, n_classes: int = 0):
    """:func:`fuse_frame` (weight 1 a frame) plus a one-hot vote of the
    label seen at each in-band voxel's pixel into the (X, Y, Z, C)
    ``label_probs_volume``. Returns new (tsdf, weights, label_probs)."""
    lin, valid, sdf = _project(tuple(tsdf_volume.shape), depth_map,
                               proj_matrix, origin, resolution)
    label = label_map.reshape(-1)[lin].to(torch.int64)
    in_band = valid & (torch.abs(sdf) <= truncation)
    w_add = in_band.float()
    new_w = weights_volume + w_add
    new_v = torch.where(in_band, (weights_volume * tsdf_volume + w_add * sdf)
                        / torch.clamp_min(new_w, 1e-12), tsdf_volume)
    c = label_probs_volume.shape[-1]
    # one_hot of an out-of-range label is all zero, as jax.nn.one_hot's
    in_range = (label >= 0) & (label < c)
    onehot = torch.nn.functional.one_hot(torch.where(in_range, label, 0),
                                         c).float() * in_range[..., None]
    return new_v, new_w, label_probs_volume + onehot * w_add[..., None]


def tsdf_from_depth_views(depth_maps, proj_matrices, shape, origin,
                          resolution, truncation, init_value=None,
                          device="cuda"):
    """Multi-view TSDF fusion (libfusion's use): :func:`fuse_frame` over
    (V, h, w) depth maps and (V, 3, 4) projections into a fresh volume
    (tsdf ``init_value``, default ``truncation``; weights 0) on
    ``device``. Returns (tsdf, weights)."""
    dev = resolve_device(device)
    if init_value is None:
        init_value = truncation
    tsdf = torch.full(tuple(shape), float(init_value), dtype=torch.float32,
                      device=dev)
    wvol = torch.zeros(tuple(shape), dtype=torch.float32, device=dev)
    depths = torch.as_tensor(depth_maps, dtype=torch.float32, device=dev)
    projs = torch.as_tensor(proj_matrices, dtype=torch.float32, device=dev)
    org = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    res = torch.tensor(float(resolution), dtype=torch.float32, device=dev)
    trunc = torch.tensor(float(truncation), dtype=torch.float32, device=dev)
    for depth, proj in zip(depths, projs):
        tsdf, wvol = fuse_frame(tsdf, wvol, depth, proj, org, res, trunc)
    return tsdf, wvol
