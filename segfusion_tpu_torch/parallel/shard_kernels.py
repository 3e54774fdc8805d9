"""The slot kernels over an x-sharded row state, one x-slab a device.

Port of ``segfusion_tpu/parallel/shard_kernels.py``. All four
shadow/reconcile kernels are X-LOCAL: a voxel's reconcile reads only the 4
neighbour slots at the SAME x, the kernel grid is x-major and the row
arrays are x-major flat, so a contiguous dim-0 part of the geo, key or
shadow rows IS a standalone sub-volume with X' = X / n. Each wrapper runs
the kernel of each x-slab on the slab's own device (its plain version on
the CPU), with no communication.

A row state is given whole (one tensor, cut here into n slabs, each moved
to its device: a slab on the device the state lies on is a view) or as the
list of its n slabs; every result is the list of its n slabs.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch

from ..ops import rowvol
from ..ops.kernels import shadow_build as sb
from .mesh import Mesh

__all__ = ["sharded_build_shadow", "sharded_build_shadow_dirty",
           "sharded_reconcile_slot", "sharded_reconcile_key",
           "check_x_divisible"]

Rows = Union[torch.Tensor, Sequence[torch.Tensor]]


def check_x_divisible(layout: rowvol.RowLayout, mesh: Mesh,
                      axis: str = "x") -> int:
    if axis != mesh.axis_name:
        raise ValueError(f"mesh has axis '{mesh.axis_name}', not '{axis}'")
    n = mesh.size
    if layout.X % n != 0:
        raise ValueError(
            f"volume x extent {layout.X} not divisible by mesh axis "
            f"'{axis}' size {n} (pad with DATA.pad_shape_multiple)")
    return n


def _slabs(rows: Rows, mesh: Mesh) -> List[torch.Tensor]:
    """The n x-slabs of a row state, slab i on mesh device i."""
    if not isinstance(rows, torch.Tensor):
        return [r.to(d) for r, d in zip(rows, mesh.devices)]
    m = rows.shape[0] // mesh.size
    return [rows[i * m:(i + 1) * m].to(d)
            for i, d in enumerate(mesh.devices)]


def _slab_layout(layout, mesh, axis):
    n = check_x_divisible(layout, mesh, axis)
    return layout._replace(X=layout.X // n)


def sharded_build_shadow(geo: Rows, layout: rowvol.RowLayout, mesh: Mesh,
                         axis: str = "x") -> List[torch.Tensor]:
    """``rowvol.build_shadow`` over an x-sharded geo state: each device
    builds the shadow of its own x-slab."""
    Ls = _slab_layout(layout, mesh, axis)
    return [rowvol.build_shadow(g, Ls) for g in _slabs(geo, mesh)]


def sharded_build_shadow_dirty(geo: Rows, prev_shadow: Rows,
                               dirty: torch.Tensor,
                               layout: rowvol.RowLayout, mesh: Mesh,
                               axis: str = "x") -> List[torch.Tensor]:
    """``rowvol.build_shadow_dirty`` over x-sharded geo and shadow states
    (each slab's shadow updated in place). ``dirty`` is the global
    (X * NJ + 1,) tile mask (trailing sentinel, ``rowvol.dirty_tile_mask``);
    the tile grid is x-major, so its first X * NJ flags cut into the
    slabs' masks and each slab re-appends its own sentinel."""
    Ls = _slab_layout(layout, mesh, axis)
    _, NJ = rowvol.shadow_tiling(layout)
    nt = Ls.X * NJ
    out = []
    for i, (g, p) in enumerate(zip(_slabs(geo, mesh),
                                   _slabs(prev_shadow, mesh))):
        d = dirty[i * nt:(i + 1) * nt].to(g.device)
        d = torch.cat([d, torch.zeros(1, dtype=d.dtype, device=d.device)])
        out.append(rowvol.build_shadow_dirty(g, p, d, Ls))
    return out


def sharded_reconcile_slot(geo: Rows, layout: rowvol.RowLayout, mesh: Mesh,
                           axis: str = "x"):
    """``reconcile_slot`` over an x-sharded geo state -> the x-slabs of the
    canonical (num, w), each (X / n, Y, Z): two lists."""
    Ls = _slab_layout(layout, mesh, axis)
    pairs = [sb.reconcile_slot(g, Ls) for g in _slabs(geo, mesh)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def sharded_reconcile_key(key: Rows, layout: rowvol.RowLayout, mesh: Mesh,
                          axis: str = "x") -> List[torch.Tensor]:
    """``reconcile_key`` over an x-sharded key state -> the x-slabs of the
    canonical (X / n, Y, Z) packed keys."""
    Ls = _slab_layout(layout, mesh, axis)
    return [sb.reconcile_key(k, Ls) for k in _slabs(key, mesh)]
