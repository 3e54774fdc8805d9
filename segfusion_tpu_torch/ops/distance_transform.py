"""Squared Euclidean distance transform (Felzenszwalb-Huttenlocher).

Port of ``segfusion_tpu/ops/distance_transform.py``: the N-D transform is
axis-separable, and each 1-D pass computes d(i) = min_j f(j) + (i - j)^2
as a blocked min-plus reduction over j (O(n^2) operations, parallel over
rows and elementwise; for rows of <= 512 voxels it beats the sequential
lower-envelope scan on a device).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["distance_transform_1d", "distance_transform", "occupancy_to_sdf"]

INF = 1e12


def distance_transform_1d(f: torch.Tensor, block: int = 128) -> torch.Tensor:
    """(..., n) costs (0 at sources, INF elsewhere) -> (..., n) with
    out[..., i] = min_j f[..., j] + (i - j)^2, over blocks of ``block``
    candidates j."""
    n = f.shape[-1]
    dev = f.device
    f = f.float()
    idx = torch.arange(n, dtype=torch.float32, device=dev)
    out = torch.full(f.shape, INF, dtype=torch.float32, device=dev)
    for j0 in range(0, n, block):
        js = torch.arange(j0, min(j0 + block, n), dtype=torch.float32,
                          device=dev)
        d = idx[:, None] - js[None, :]                      # (n, b)
        cost = f[..., None, j0:j0 + block] + d * d          # (..., n, b)
        out = torch.minimum(out, cost.amin(-1))
    return out


def distance_transform(f: torch.Tensor) -> torch.Tensor:
    """N-D squared Euclidean distance transform (separable passes)."""
    out = f.float()
    for axis in range(out.dim()):
        out = distance_transform_1d(out.movedim(axis, -1)).movedim(-1, axis)
    return out


def occupancy_to_sdf(occupancy: torch.Tensor, resolution: float = 1.0,
                     truncation: Optional[float] = None) -> torch.Tensor:
    """Occupancy grid -> signed distance field by two distance transforms:
    the distance to the occupied set outside, minus the distance to the
    free set inside, times ``resolution``; clipped to +-``truncation``."""
    occ = occupancy > 0
    d_out = torch.sqrt(distance_transform(
        torch.where(occ, 0.0, INF))) * resolution
    d_in = torch.sqrt(distance_transform(
        torch.where(occ, INF, 0.0))) * resolution
    sdf = torch.where(occ, -d_in, d_out)
    if truncation is not None:
        sdf = torch.clamp(sdf, -truncation, truncation)
    return sdf
