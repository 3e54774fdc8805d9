"""Volume filters: 3D median filter, outlier filter.

Port of ``segfusion_tpu/ops/filters.py``. ``median_filter3d`` is the plain
PyTorch median (the sorted middle of the size^3 edge-replicated shifted
views, any dtype); it lives beside its CUDA kernel in
``ops/kernels/median3d.py``, whose ``median_filter3d`` dispatches on the
tensor's device.
"""

from __future__ import annotations

import torch

from .kernels.median3d import median_filter3d_plain as median_filter3d

__all__ = ["median_filter3d", "outlier_filter"]


def outlier_filter(tsdf: torch.Tensor, weights: torch.Tensor,
                   threshold: float, init_value: float):
    """Reset voxels observed fewer than ``threshold`` times: tsdf to
    ``init_value``, weight to 0."""
    keep = weights >= threshold
    return (torch.where(keep, tsdf, init_value),
            torch.where(keep, weights, 0.0))
