"""TV-L1 TSDF refinement (Zach et al.'s primal-dual scheme).

Port of ``segfusion_tpu/ops/tvl1.py``: minimises TV(u) + lambda * w
|u - f| over the voxel grid (f the fused TSDF, w its weights) with
``n_iters`` first-order primal-dual steps of elementwise and shift
operations.
"""

from __future__ import annotations

import torch

__all__ = ["tvl1_refine"]


def _diff(u, axis):
    """Forward differences along ``axis``, 0 at the last index."""
    d = torch.diff(u, dim=axis)
    return torch.cat([d, torch.zeros_like(u.narrow(axis, 0, 1))], axis)


def _div_axis(p, axis):
    """Backward differences along ``axis`` (the adjoint of ``_diff``)."""
    n = p.shape[axis]
    return torch.cat([p.narrow(axis, 0, 1),
                      p.narrow(axis, 1, n - 2) - p.narrow(axis, 0, n - 2),
                      -p.narrow(axis, n - 2, 1)], axis)


@torch.no_grad()
def tvl1_refine(tsdf: torch.Tensor, weights: torch.Tensor, lam: float = 0.5,
                n_iters: int = 50, tau: float = 0.125,
                sigma: float = 0.125) -> torch.Tensor:
    """The refined (X, Y, Z) volume: unobserved voxels (w = 0) follow the
    TV term alone."""
    f = tsdf.float()
    w = weights.float()
    u = ubar = f
    p = [torch.zeros_like(f) for _ in range(3)]
    thresh = tau * lam * w
    for _ in range(n_iters):
        # dual ascent, projected onto |p| <= 1
        p = [pa + sigma * _diff(ubar, a) for a, pa in enumerate(p)]
        norm = torch.clamp_min(torch.sqrt(p[0] * p[0] + p[1] * p[1]
                                          + p[2] * p[2]), 1.0)
        p = [pa / norm for pa in p]
        # primal descent, weighted L1 shrinkage towards f
        v = u + tau * (_div_axis(p[0], 0) + _div_axis(p[1], 1)
                       + _div_axis(p[2], 2))
        diff = v - f
        u_new = f + torch.sign(diff) * torch.clamp_min(diff.abs() - thresh,
                                                       0.0)
        ubar = 2.0 * u_new - u
        u = u_new
    return u
