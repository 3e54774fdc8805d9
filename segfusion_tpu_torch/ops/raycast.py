"""Depth rendering by ray marching a TSDF volume.

Port of ``segfusion_tpu/ops/raycast.py``: all rays march ``n_steps``
uniform samples in lockstep; the surface is the first positive-to-
non-positive sign change, refined linearly between the two samples. The
lockstep march is a Python loop here (``lax.scan`` in JAX); a leading
batch of poses renders all frames in one loop.
"""

from __future__ import annotations

import torch

from .geometry import unproject

__all__ = ["render_depth"]


def _sample_nearest(volume: torch.Tensor, points_v: torch.Tensor):
    """Nearest-voxel samples (inf outside the volume) and validity."""
    idx = torch.round(points_v).to(torch.int64)
    xs, ys, zs = volume.shape
    hi = torch.tensor([xs - 1, ys - 1, zs - 1], device=idx.device)
    valid = ((idx >= 0) & (idx <= hi)).all(-1)
    safe = torch.minimum(torch.clamp_min(idx, 0), hi)
    lin = (safe[..., 0] * ys + safe[..., 1]) * zs + safe[..., 2]
    vals = volume.reshape(-1)[lin]
    return torch.where(valid, vals, float("inf")), valid


@torch.no_grad()
def render_depth(tsdf_volume: torch.Tensor, extrinsics: torch.Tensor,
                 intrinsics: torch.Tensor, origin: torch.Tensor, resolution,
                 height: int, width: int, near: float = 0.1,
                 far: float = 8.0, n_steps: int = 384) -> torch.Tensor:
    """(..., height, width) z-depth maps (0 where no surface was hit) for
    camera-to-world poses ``extrinsics`` (..., 4, 4)."""
    batch = extrinsics.shape[:-2]
    ones = torch.ones(batch + (height, width), dtype=torch.float32,
                      device=extrinsics.device)
    pts1 = unproject(ones, extrinsics, intrinsics)        # (..., h*w, 3)
    eye = extrinsics[..., None, :3, 3].float()
    dirs = pts1 - eye
    # t along eye + t * dirs equals the pinhole depth (z in camera space)
    ts = torch.linspace(near, far, n_steps, dtype=torch.float32)

    def sample_at(t):
        pv = (eye + t * dirs - origin) / resolution
        return _sample_nearest(tsdf_volume, pv)

    prev_val, _ = sample_at(float(ts[0]))
    prev_t = float(ts[0])
    hit_t = torch.zeros(pts1.shape[:-1], dtype=torch.float32,
                        device=pts1.device)
    for t in ts[1:].tolist():
        val, valid = sample_at(t)
        crossing = ((prev_val > 0) & (val <= 0) & valid
                    & torch.isfinite(prev_val))
        denom = prev_val - val
        frac = torch.where(denom.abs() > 1e-12, prev_val / denom, 0.0)
        t_surf = prev_t + frac * (t - prev_t)
        hit_t = torch.where((hit_t == 0.0) & crossing, t_surf, hit_t)
        prev_val, prev_t = val, t
    return hit_t.reshape(batch + (height, width))
