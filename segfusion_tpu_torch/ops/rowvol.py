"""Slot-layout scene state: 128-lane rows for the fusion hot path.

Port of ``segfusion_tpu/ops/rowvol.py`` (see its module docstring for the
SLOT LAYOUT and the WRITER INVARIANT). Slot, key and shadow tensors keep the
JAX package's exact ``RowLayout``, including the padding that exists only
for Mosaic (G rounded up to a multiple of 4, SY aligned), so they compare
bit for bit with JAX's:

* geo state (scatter-add, f32 or bf16): rows (x, 1 + y_lo, z_lo // 16),
  128 lanes = 8 components x 16 z-slots;
* key state (scatter-max, int32): rows (x, y_lo, z_lo // 32), 128 lanes =
  4 corner components x 32 z-slots;
* gather shadow (int32 words of two bf16 halves; uint32 in JAX): same rows
  as the key state, 4 corner components of RECONCILED (num | w).

Only the committed formulations are ported: ``select128`` extraction (as a
gather of the one live lane per component) and the ``lane128`` update
placement. The shadow/reconcile passes go through
``kernels/shadow_build.py``: CUDA kernels for CUDA tensors, the plain
versions for CPU tensors. Scatters are in place (``index_add_`` /
``index_reduce_``) where the JAX package returned new arrays.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from .geometry import unpack16_numw
from .kernels import shadow_build as _sb

__all__ = ["RowLayout", "RowVolume", "rows_from_volume", "volume_from_rows",
           "build_shadow", "build_shadow_dirty", "shadow_from_canonical",
           "corner_rows", "extract_rows", "integrate_rows", "pick_ty",
           "shadow_tiling", "dirty_tile_mask", "rows_from_volumes",
           "volumes_from_rows", "build_shadow_v", "build_shadow_dirty_v",
           "corner_rows_scenes", "gather_words", "extract_words",
           "row_updates", "scatter_updates"]

# Integration ray-chunk target (rays per chunk), as in the JAX package:
# the (M, 128) update rows are materialised, so very large frames stream
# through in a few chunks.
_INTEGRATE_CHUNK = 262144

# Shadow-build y-tile height cap; the dirty-tile mask and the shadow
# kernel must tile identically.
SHADOW_MAX_TY = 56

shadow_from_canonical = _sb.shadow_from_canonical


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _nchunks(n: int, target: int) -> int:
    """Smallest chunk count that divides n with chunks <= target."""
    k = _cdiv(n, target)
    while n % k:
        k += 1
    return k


class RowLayout(NamedTuple):
    """Static layout constants derived from the canonical volume shape
    (identical to the JAX package's, padding included: G is 2 * GK rounded
    up to a multiple of 4, SY is Y + 2 halo rows padded so SY * G % 16 ==
    0)."""
    X: int
    Y: int
    Z: int
    G: int       # geo z-slot groups
    GK: int      # key/shadow z-slot groups: ceil(Z / 32)
    SY: int      # geo y-stride

    @staticmethod
    def for_shape(shape: Tuple[int, int, int]) -> "RowLayout":
        X, Y, Z = int(shape[0]), int(shape[1]), int(shape[2])
        GK = _cdiv(Z, 32)
        G = -(-2 * GK // 4) * 4
        SY = Y + 2
        while (SY * G) % 16:
            SY += 1
        return RowLayout(X=X, Y=Y, Z=Z, G=G, GK=GK, SY=SY)

    @property
    def geo_rows(self) -> int:
        return self.X * self.SY * self.G

    @property
    def key_rows(self) -> int:
        return self.X * self.Y * self.GK

    @property
    def shadow_rows(self) -> int:
        return self.X * self.Y * self.GK


@dataclasses.dataclass
class RowVolume:
    """Scene state in slot form, carried through a stream."""
    geo: torch.Tensor         # (geo_rows, 128) f32/bf16
    key: torch.Tensor         # (key_rows, 128) int32
    origin: torch.Tensor      # (3,) f32
    resolution: torch.Tensor  # () f32
    init_value: float

    def _replace(self, **kw) -> "RowVolume":
        return dataclasses.replace(self, **kw)


# -- canonical <-> slots ------------------------------------------------------

def rows_from_volume(num, w, key, layout: RowLayout,
                     geo_dtype=torch.float32):
    """Slot state from canonical (X, Y, Z) tensors: all mass in each
    voxel's own slot's component 0, everything else zero."""
    L = layout
    zp = 16 * L.G

    def slots0(a):
        ap = torch.nn.functional.pad(a.to(geo_dtype), (0, zp - L.Z))
        return ap.reshape(L.X, L.Y, L.G, 16)

    geo = torch.zeros((L.X, L.SY, L.G, 128), dtype=geo_dtype,
                      device=num.device)
    geo[:, 1:L.Y + 1, :, 0:16] = slots0(num)
    geo[:, 1:L.Y + 1, :, 64:80] = slots0(w)
    geo = geo.reshape(L.geo_rows, 128)

    krows = torch.zeros((L.key_rows, 128), dtype=torch.int32,
                        device=key.device)
    kp = torch.nn.functional.pad(key.to(torch.int32), (0, 32 * L.GK - L.Z))
    krows[:, :32] = kp.reshape(L.key_rows, 32)
    return geo, krows


def volume_from_rows(geo, key, layout: RowLayout):
    """Reconcile the slot states back to canonical (num, w, key)."""
    num, w = _sb.reconcile_slot(geo, layout)
    return num, w, _sb.reconcile_key(key, layout)


# S same-shape scenes stacked on a leading axis: every slot pass is
# x-local, so S scenes are one volume of S * X x-planes (the JAX package's
# vmap of these passes folds the same way)

def rows_from_volumes(num, w, key, layout: RowLayout,
                      geo_dtype=torch.float32):
    """:func:`rows_from_volume` of (S, X, Y, Z) canonical tensors ->
    (S, geo_rows, 128) geo and (S, key_rows, 128) key states."""
    S = num.shape[0]
    fold = (S * layout.X, layout.Y, layout.Z)
    geo, key = rows_from_volume(num.reshape(fold), w.reshape(fold),
                                key.reshape(fold),
                                layout._replace(X=S * layout.X), geo_dtype)
    return (geo.view(S, layout.geo_rows, 128),
            key.view(S, layout.key_rows, 128))


def volumes_from_rows(geo, key, layout: RowLayout):
    """Reconcile (S, rows, 128) slot states to (S, X, Y, Z) canonical
    (num, w, key): one launch of each reconcile kernel."""
    num, w = _sb.reconcile_slot_v(geo, layout)
    return num, w, _sb.reconcile_key_v(key, layout)


# -- gather shadow ------------------------------------------------------------

def pick_ty(Y: int, max_ty: Optional[int] = None) -> int:
    """Shadow y-tile height: the largest divisor of Y <= max_ty that is a
    multiple of 8, or all of Y when there is none (small Y only; the
    Database pads Y to a multiple of 8)."""
    if max_ty is None:
        max_ty = SHADOW_MAX_TY
    for ty in range(min(max_ty, Y), 0, -1):
        if Y % ty == 0 and ty % 8 == 0:
            return ty
    if Y > 4 * max_ty:
        raise ValueError(
            f"volume Y extent {Y} has no divisor that is a multiple of 8 "
            f"and <= {max_ty}; pad Y to a multiple of 8 (Database volumes "
            "are padded automatically)")
    return Y


def shadow_tiling(layout: RowLayout) -> Tuple[int, int]:
    """(TY, NJ): shadow-build y-tile height and tile count."""
    ty = pick_ty(layout.Y)
    return ty, layout.Y // ty


def build_shadow(geo, layout: RowLayout) -> torch.Tensor:
    """Slot state -> (shadow_rows, 128) int32 gather shadow."""
    return _sb.build_shadow(geo, layout, shadow_tiling(layout)[0])


def build_shadow_dirty(geo, prev_shadow, dirty, layout: RowLayout
                       ) -> torch.Tensor:
    """Incremental :func:`build_shadow`: rebuild only the tiles flagged in
    ``dirty`` (``dirty_tile_mask`` of the last integrated frame), keep the
    rest of ``prev_shadow``. Updates ``prev_shadow`` in place and returns
    it."""
    return _sb.build_shadow_dirty(geo, prev_shadow, dirty, layout,
                                  shadow_tiling(layout)[0])


def build_shadow_v(geo, layout: RowLayout) -> torch.Tensor:
    """:func:`build_shadow` of (S, geo_rows, 128) states, one launch."""
    return _sb.build_shadow_v(geo, layout, shadow_tiling(layout)[0])


def build_shadow_dirty_v(geo, prev_shadow, dirty, layout: RowLayout
                         ) -> torch.Tensor:
    """:func:`build_shadow_dirty` of S scenes, one launch (``prev_shadow``
    (S, shadow_rows, 128) updated in place, ``dirty`` (S, X * NJ + 1))."""
    return _sb.build_shadow_dirty_v(geo, prev_shadow, dirty, layout,
                                    shadow_tiling(layout)[0])


def dirty_tile_mask(points_v: torch.Tensor, layout: RowLayout
                    ) -> torch.Tensor:
    """(X * NJ + 1,) int32 conservative dirty mask over shadow tiles
    (x-slab, y-tile) for one integration footprint (``points_v`` (n, p,
    3), rays in scan order); the trailing 0 is a sentinel. Same bounds as
    the JAX package: per ray-tile min/max of the sample coordinates,
    padded by one voxel plus one of slack. Ray tiles are single rays up to
    65536 rays, then 2x2, 4x4, ... consecutive rays (bounded (X, T) mask)."""
    L = layout
    TY, NJ = shadow_tiling(L)
    n, p, _ = points_v.shape
    dev = points_v.device
    tile_px = 1
    while n // (tile_px * tile_px) > 65536:
        tile_px *= 2
    tt = tile_px * tile_px
    t_cnt = _cdiv(n, tt)
    pad_n = t_cnt * tt - n
    px = points_v[..., 0].reshape(-1)
    py = points_v[..., 1].reshape(-1)
    if pad_n:
        px = torch.cat([px, px[-1].expand(pad_n * p)])
        py = torch.cat([py, py[-1].expand(pad_n * p)])
    px = px.reshape(t_cnt, tt * p)
    py = py.reshape(t_cnt, tt * p)
    xmin = torch.clamp(torch.floor(px.amin(1)) - 2.0, 0, L.X - 1)
    xmax = torch.clamp(torch.floor(px.amax(1)) + 2.0, 0, L.X - 1)
    ymin = torch.clamp(torch.floor(py.amin(1)) - 2.0, -1, L.Y - 1)
    ymax = torch.clamp(torch.floor(py.amax(1)) + 1.0, -1, L.Y - 1)

    xs = torch.arange(L.X, dtype=torch.float32, device=dev)
    xok = (xs[None, :] >= xmin[:, None]) & (xs[None, :] <= xmax[:, None])
    j0 = torch.arange(NJ, dtype=torch.float32, device=dev) * TY
    jok = ((j0[None, :] + TY >= ymin[:, None])
           & (j0[None, :] - 1 <= ymax[:, None]))             # (T, NJ)
    # (X, T) @ (T, NJ) counts of 0/1 products: exact in f32
    mask = (xok.T.float() @ jok.float()) > 0
    flat = mask.reshape(-1).to(torch.int32)
    return torch.cat([flat, torch.zeros(1, dtype=torch.int32, device=dev)])


# -- corner geometry ----------------------------------------------------------

class CornerRows(NamedTuple):
    """Slot-addressed trilinear corner data; per-x-corner fields are
    corner-major (2, n, p), shared fields (n, p)."""
    sg_rows: torch.Tensor   # (2, n, p) geo slot row per x-corner
    sgs: torch.Tensor       # (n, p) geo z-slot (z_lo % 16)
    k_rows: torch.Tensor    # (2, n, p) key/shadow slot row per x-corner
    ksl: torch.Tensor       # (n, p) key/shadow z-slot (z_lo % 32)
    dz0: torch.Tensor       # (n, p) z-corner-0 offset from z_lo (0/1)
    dz1: torch.Tensor       # (n, p) z-corner-1 offset from z_lo (0/1)
    wx: torch.Tensor        # (2, n, p) x-corner weights
    vx: torch.Tensor        # (2, n, p) x-corner validity
    wyA: torch.Tensor       # (n, p) weight mass on column A (pair low y)
    wyB: torch.Tensor       # (n, p) weight mass on column B
    vyA: torch.Tensor       # (n, p) column A in-bounds
    vyB: torch.Tensor       # (n, p) column B in-bounds
    wz0: torch.Tensor       # (n, p) z-corner-0 weight
    wz1: torch.Tensor       # (n, p) z-corner-1 weight
    vz0: torch.Tensor       # (n, p) z-corner-0 in-bounds
    vz1: torch.Tensor       # (n, p) z-corner-1 in-bounds


def corner_rows(points_v: torch.Tensor, layout: RowLayout) -> CornerRows:
    """Slot/weight decomposition of the 8 trilinear corners (reference
    'center' interpolation scheme); int32 rows as in the JAX package."""
    L = layout
    idx = torch.floor(points_v)
    center = idx + 0.5
    neighbor = torch.sign(center - points_v)
    alpha = torch.abs(points_v - center)

    def axis(a, dim):
        c0 = idx[..., a].to(torch.int32)
        c1 = (idx[..., a] + neighbor[..., a]).to(torch.int32)
        v0 = (c0 >= 0) & (c0 < dim)
        v1 = (c1 >= 0) & (c1 < dim)
        return c0, c1, v0, v1, 1.0 - alpha[..., a], alpha[..., a]

    x0, x1, vx0, vx1, wx0, wx1 = axis(0, L.X)
    y0, y1, vy0, vy1, wy0, wy1 = axis(1, L.Y)
    z0, z1, vz0, vz1, wz0, wz1 = axis(2, L.Z)

    # y pair: physical columns A = y_lo, B = y_lo + 1 (clipped pair base;
    # out-of-range corners fall on masked, not wrong, columns)
    y_lo_c = torch.clamp(torch.minimum(y0, y1), 0, L.Y - 1)
    yA, yB = y_lo_c, y_lo_c + 1
    wyA = torch.where(y0 == yA, wy0, 0.0) + torch.where(y1 == yA, wy1, 0.0)
    wyB = torch.where(y0 == yB, wy0, 0.0) + torch.where(y1 == yB, wy1, 0.0)
    vyA = ((y0 == yA) & vy0) | ((y1 == yA) & vy1)
    vyB = ((y0 == yB) & vy0) | ((y1 == yB) & vy1)

    z0c = torch.clamp(z0, 0, L.Z - 1)
    z1c = torch.clamp(z1, 0, L.Z - 1)
    z_lo = torch.minimum(z0c, z1c)

    xs = torch.stack([torch.clamp(x0, 0, L.X - 1),
                      torch.clamp(x1, 0, L.X - 1)], 0)    # (2, n, p)
    sg_rows = (xs * L.SY + 1 + y_lo_c[None]) * L.G + (z_lo // 16)[None]
    k_rows = (xs * L.Y + y_lo_c[None]) * L.GK + (z_lo // 32)[None]

    return CornerRows(
        sg_rows=sg_rows, sgs=z_lo % 16, k_rows=k_rows, ksl=z_lo % 32,
        dz0=z0c - z_lo, dz1=z1c - z_lo,
        wx=torch.stack([wx0, wx1], 0).float(), vx=torch.stack([vx0, vx1], 0),
        wyA=wyA.float(), wyB=wyB.float(), vyA=vyA, vyB=vyB,
        wz0=wz0.float(), wz1=wz1.float(), vz0=vz0, vz1=vz1)


def corner_rows_scenes(points_v: torch.Tensor, layout: RowLayout
                       ) -> CornerRows:
    """:func:`corner_rows` of S scenes' samples, ``points_v`` (S, n, p, 3)
    in each scene's own voxel space, folded into one volume of S * X
    x-planes: rays scene-major, (2, S * n, p) / (S * n, p). Each scene's
    bounds (the x clamp and the validity masks) apply before its row
    offset is added, so a sample past scene s's last x-plane stays masked
    and its clamped rows stay in scene s."""
    S, n, p, _ = points_v.shape
    cr = corner_rows(points_v, layout)
    s = torch.arange(S, dtype=torch.int32, device=points_v.device)
    sg_rows = cr.sg_rows + (s * layout.geo_rows)[None, :, None, None]
    k_rows = cr.k_rows + (s * layout.key_rows)[None, :, None, None]
    cr = cr._replace(sg_rows=sg_rows, k_rows=k_rows)
    return CornerRows(*[a.reshape((2, S * n, p) if a.dim() == 4
                                  else (S * n, p)) for a in cr])


# -- extraction ---------------------------------------------------------------

_COMP_LANES = (0, 32, 64, 96)


def extract_rows(shadow: torch.Tensor, cr: CornerRows, init_value: float,
                 fill_value: float):
    """Trilinear (fusion_values, fusion_weights), each (n, p), from the
    gather shadow: per (ray, sample, x-corner) the 4 corner words of one
    slot row. The JAX package gathers the whole 128-lane row and sums the
    lanes whose slot matches (``select128``); exactly one lane per
    component matches, so gathering that lane is bit-identical. (The JAX
    ray chunking bounded its (2m, 128) row gather; the port's (2m, 4)
    gather needs none.)"""
    return extract_words(gather_words(shadow, cr.k_rows, cr.ksl), cr,
                         init_value, fill_value)


def gather_words(shadow: torch.Tensor, k_rows: torch.Tensor,
                 ksl: torch.Tensor, row_offset: int = 0, owned=None
                 ) -> torch.Tensor:
    """The (2 n p, 4) shadow words of each (x-corner, ray, sample): the 4
    corner components of its slot (``CornerRows.k_rows`` / ``ksl``).
    ``shadow`` may hold only the rows from ``row_offset`` on (an x-slab);
    then ``owned`` (2 n p,) bool says which corners lie in it, and the
    others read 0."""
    slot = ksl.reshape(-1).long()
    rows = k_rows.reshape(-1).long() - row_offset
    if owned is not None:
        rows = torch.where(owned, rows, 0)
    base = rows * 128 + torch.cat([slot, slot])
    lanes = torch.tensor(_COMP_LANES, dtype=torch.long, device=base.device)
    q = shadow.reshape(-1)[base[:, None] + lanes]
    return q if owned is None else torch.where(owned[:, None], q, 0)


def extract_words(q: torch.Tensor, cr: CornerRows, init_value: float,
                  fill_value: float):
    """The trilinear (fusion_values, fusion_weights) of
    :func:`extract_rows` from the gathered words ``q``."""
    n, p = cr.ksl.shape
    m = n * p
    qA0, qA1, qB0, qB1 = q.unbind(1)

    dz0 = cr.dz0.reshape(-1)
    dz1 = cr.dz1.reshape(-1)
    vz0 = cr.vz0.reshape(-1)
    vz1 = cr.vz1.reshape(-1)
    wz0 = cr.wz0.reshape(-1)
    wz1 = cr.wz1.reshape(-1)
    vyA = cr.vyA.reshape(-1)
    vyB = cr.vyB.reshape(-1)
    wyA = cr.wyA.reshape(-1)
    wyB = cr.wyB.reshape(-1)
    init, fill = float(init_value), float(fill_value)

    def column(q0, q1, vx, vy, wy):
        # z-candidate k reads slot component dz_k
        n0, w0 = unpack16_numw(torch.where(dz0 == 0, q0, q1))
        n1, w1 = unpack16_numw(torch.where(dz1 == 0, q0, q1))

        def corner(nc, wc, vz):
            v = torch.where(wc > 0, nc / torch.clamp_min(wc, 1e-12), init)
            valid = vx & vy & vz
            return torch.where(valid, v, fill), torch.where(valid, wc, 0.0)

        v0, fw0 = corner(n0, w0, vz0)
        v1, fw1 = corner(n1, w1, vz1)
        return wy * (wz0 * v0 + wz1 * v1), wy * (wz0 * fw0 + wz1 * fw1)

    fv = fw = 0.0
    for c in range(2):
        vx_c = cr.vx[c].reshape(-1)
        wx_c = cr.wx[c].reshape(-1)
        cs = slice(c * m, (c + 1) * m)
        vA, wA = column(qA0[cs], qA1[cs], vx_c, vyA, wyA)
        vB, wB = column(qB0[cs], qB1[cs], vx_c, vyB, wyB)
        fv = fv + wx_c * (vA + vB)
        fw = fw + wx_c * (wA + wB)
    # y-corners outside the clipped pair read fill_value with their full
    # trilinear weight and carry no fusion weight
    fv = fv + (1.0 - wyA - wyB) * fill
    return fv.reshape(n, p), fw.reshape(n, p)


# -- integration --------------------------------------------------------------

def _place(slots: torch.Tensor, vals: torch.Tensor, width: int):
    """(M,) slot + (M, C) values -> (M, C * width) rows with lane
    ``width * c + slot`` = vals[:, c], zeros elsewhere (the JAX
    ``lane128`` select tree: placement only, no arithmetic)."""
    M, C = vals.shape
    out = torch.zeros((M, C, width), dtype=vals.dtype, device=vals.device)
    out.scatter_(2, slots.long()[:, None, None].expand(M, C, 1),
                 vals[:, :, None])
    return out.reshape(M, C * width)


def integrate_rows(geo, key, cr: CornerRows, values, sem_key, ray_mask,
                   n_tail: int, do_sem: Optional[bool] = None):
    """Scatter a frame's (or block's) updates into the slot state, IN
    PLACE: one 128-lane scatter-add (4 (y, z) corners x {num, w}) and one
    128-lane scatter-max (4 corner keys) per (ray, tail sample, x-corner).
    ``values`` (n, n_tail) clipped estimates; ``sem_key`` (n,) packed keys
    or None; ``ray_mask`` (n,) bool or None. ``do_sem`` (a host bool, the
    JAX package's lax.cond gate) skips the key scatter when False; the geo
    scatter always runs. Returns ``(geo, key)``."""
    scatter_updates(geo, key, row_updates(cr, values, sem_key, ray_mask,
                                          n_tail, geo.dtype, do_sem))
    return geo, key


class RowUpdates(NamedTuple):
    """The placed-before-scatter updates of :func:`integrate_rows`: geo
    rows, z-slots and (M, 8) values; the key part None when the key
    scatter is skipped."""
    rows: torch.Tensor
    sgs: torch.Tensor
    vals8: torch.Tensor
    k_rows: Optional[torch.Tensor]
    ksl: Optional[torch.Tensor]
    kvals: Optional[torch.Tensor]
    n_tail: int


def row_updates(cr: CornerRows, values, sem_key, ray_mask, n_tail: int,
                geo_dtype, do_sem: Optional[bool] = None) -> RowUpdates:
    """The updates :func:`integrate_rows` scatters, one per (x-corner,
    ray, tail sample), in its order."""
    t = n_tail
    n = cr.ksl.shape[0]

    def flat(a):          # shared (n, p) -> tail-cut (m,)
        return a[:, :t].reshape(-1)

    def both(a):          # (m,) -> (2m,) corner-major duplication
        return torch.cat([a, a])

    dz0, dz1 = flat(cr.dz0), flat(cr.dz1)
    wz0 = flat(cr.wz0) * flat(cr.vz0)
    wz1 = flat(cr.wz1) * flat(cr.vz1)
    # weight mass landing on slot z-offset 0 / 1 (degenerate pairs have
    # dz0 == dz1 == 0 and fold onto offset 0)
    wz_at0 = torch.where(dz0 == 0, wz0, 0.0) + torch.where(dz1 == 0, wz1, 0.0)
    wz_at1 = torch.where(dz0 == 1, wz0, 0.0) + torch.where(dz1 == 1, wz1, 0.0)
    wyA = flat(cr.wyA) * flat(cr.vyA)
    wyB = flat(cr.wyB) * flat(cr.vyB)
    pA0, pA1 = wyA * wz_at0, wyA * wz_at1
    pB0, pB1 = wyB * wz_at0, wyB * wz_at1
    nvals = values[:, :t].float().reshape(-1)
    rm = (ray_mask[:, None].expand(n, t).reshape(-1)
          if ray_mask is not None else None)

    def corner_vals8(c):
        wx_c = cr.wx[c][:, :t].reshape(-1) * cr.vx[c][:, :t].reshape(-1)
        if rm is not None:
            wx_c = wx_c * rm
        nv_c = wx_c * nvals
        return torch.stack(
            [pA0 * nv_c, pA1 * nv_c, pB0 * nv_c, pB1 * nv_c,
             pA0 * wx_c, pA1 * wx_c, pB0 * wx_c, pB1 * wx_c], -1)  # (m, 8)

    # a 16-bit state rounds the (f32) update values to its dtype before
    # the placement (EARLY_CAST: bit-identical to rounding after it)
    vals8 = torch.cat([corner_vals8(0), corner_vals8(1)], 0).to(geo_dtype)
    rows = cr.sg_rows[:, :, :t].reshape(-1).long()
    sgs = both(flat(cr.sgs))

    run_sem = sem_key is not None and (do_sem is None or bool(do_sem))
    if run_sem:
        kf = sem_key.to(torch.int32)[:, None].expand(n, t).reshape(-1)
        if rm is not None:
            kf = torch.where(rm, kf, 0)
        vz0b, vz1b = flat(cr.vz0), flat(cr.vz1)
        m0 = ((dz0 == 0) & vz0b) | ((dz1 == 0) & vz1b)
        m1 = ((dz0 == 1) & vz0b) | ((dz1 == 1) & vz1b)
        vyAb, vyBb = flat(cr.vyA), flat(cr.vyB)

        def corner_kvals(c):
            kx = torch.where(cr.vx[c][:, :t].reshape(-1), kf, 0)
            return torch.stack(
                [torch.where(vyAb & m0, kx, 0), torch.where(vyAb & m1, kx, 0),
                 torch.where(vyBb & m0, kx, 0), torch.where(vyBb & m1, kx, 0)],
                -1)                                              # (m, 4)

        kvals = torch.cat([corner_kvals(0), corner_kvals(1)], 0)
        return RowUpdates(rows, sgs, vals8,
                          cr.k_rows[:, :, :t].reshape(-1).long(),
                          both(flat(cr.ksl)), kvals, t)
    return RowUpdates(rows, sgs, vals8, None, None, None, t)


def scatter_updates(geo, key, u: RowUpdates) -> None:
    """Scatter :func:`row_updates` into the slot state, in place: the geo
    scatter-add, and the key scatter-max where ``u`` has a key part, in
    ray chunks of the integration target."""
    M = u.rows.shape[0]
    kch = _nchunks(M, _INTEGRATE_CHUNK * 2 * u.n_tail) if M else 1
    bounds = [(i * M // kch, (i + 1) * M // kch) for i in range(kch)]
    for a, b in bounds:
        geo.index_add_(0, u.rows[a:b], _place(u.sgs[a:b], u.vals8[a:b], 16))
    if u.kvals is not None:
        for a, b in bounds:
            key.index_reduce_(0, u.k_rows[a:b],
                              _place(u.ksl[a:b], u.kvals[a:b], 32), "amax")
