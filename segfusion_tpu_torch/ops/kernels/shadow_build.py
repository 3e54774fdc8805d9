"""Shadow-build and reconcile kernels: CUDA for the card, plain PyTorch
beside each for the CPU and for checking.

Each wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches the hand-written kernel of ``csrc/shadow_build.cu``
(built with nvcc for sm_90a at first use by ``_build``, loaded with
ctypes) or raises. Each wrapper counts its kernel launches in
``<wrapper>.launches``.

| wrapper              | TPU kernel it replaces                          |
| -------------------- | ----------------------------------------------- |
| build_shadow_dirty   | shadow_build.py:359 build_shadow_dirty_pallas   |
| build_shadow         | shadow_build.py:254 build_shadow_pallas         |
| reconcile_slot       | shadow_build.py:462 reconcile_slot_pallas       |
| reconcile_key        | shadow_build.py:576 reconcile_key_pallas        |

(paths under ``segfusion_tpu/ops/pallas/``). The first two share one CUDA
kernel, one block per (x, y-tile) tile that stages each geo row once in
shared memory and reconciles each voxel once; the full build passes no
dirty flags. The source note in the .cu file says what bounds them on the
card and what the design does about it.

``layout`` is a ``rowvol.RowLayout``; ``ty`` the shadow y-tile height of
``rowvol.shadow_tiling`` (the dirty flags index (x, y-tile) tiles).

The ``*_v`` entry points take S scenes' states stacked on a leading axis,
``(S, rows, 128)``: the counterparts of the JAX package's ``custom_vmap``
rules (``shadow_build.py:600-736``). Every kernel is uniform over x, and a
scene's rows sit exactly where rows of x-planes ``s * X ..`` of one volume
of ``X' = S * X`` would, so each launches its kernel (or plain version)
once on ``layout._replace(X=S * X)``. A carry that arrives without the
scene axis (one shadow or one mask for all scenes) is broadcast first, as
the JAX rules' ``_bcast`` does. The kernels index with 64-bit element
offsets, so a fold may pass 2^31 elements.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..geometry import pack16_numw
from . import _build

__all__ = ["build_shadow", "build_shadow_dirty", "reconcile_slot",
           "reconcile_key", "build_shadow_plain", "build_shadow_dirty_plain",
           "reconcile_slot_plain", "reconcile_key_plain",
           "shadow_from_canonical", "launch_counts", "reset_launch_counts",
           "build_shadow_v", "build_shadow_dirty_v", "reconcile_slot_v",
           "reconcile_key_v"]


# -- plain versions -----------------------------------------------------------

def reconcile_slot_plain(geo: torch.Tensor, layout):
    """Sum the 4 neighbour-slot components back to canonical (num, w),
    each (X, Y, Z) f32: voxel (y, z) collects comp 0 of slot (y, z), comp 1
    of (y, z-1), comp 2 of (y-1, z), comp 3 of (y-1, z-1). A bf16 state is
    upcast first (exact). The (z-pair) + (z-pair) association order is the
    JAX package's (rowvol.py:302-309); bit-equality depends on it."""
    L = layout
    s = geo.float().reshape(L.X, L.SY, L.G, 8, 16)
    zs = 16 * L.G

    def plane(c):
        return s[:, :, :, c, :].reshape(L.X, L.SY, zs)

    def zsh(a):           # comp covers z_lo + 1 -> contribution from z - 1
        return F.pad(a, (1, 0))[:, :, :zs]

    def collect(c0, c1, c2, c3):
        # physical y lives at padded index 1 + y: comps 0/1 of voxel y
        # read index 1 + y, comps 2/3 (from slot row y - 1) read index y
        return ((plane(c0)[:, 1:L.Y + 1] + zsh(plane(c1))[:, 1:L.Y + 1])
                + (plane(c2)[:, 0:L.Y] + zsh(plane(c3))[:, 0:L.Y]))

    num = collect(0, 1, 2, 3)[:, :, :L.Z].contiguous()
    w = collect(4, 5, 6, 7)[:, :, :L.Z].contiguous()
    return num, w


def reconcile_key_plain(key: torch.Tensor, layout) -> torch.Tensor:
    """Max the 4 key-slot components back to canonical (X, Y, Z) int32;
    neighbours outside the volume count as 0."""
    L = layout
    s = key.reshape(L.X, L.Y, L.GK, 4, 32)
    zs = 32 * L.GK

    def plane(c):
        return s[:, :, :, c, :].reshape(L.X, L.Y, zs)

    def zsh(a):
        return F.pad(a, (1, 0))[:, :, :zs]

    def ysh(a):
        return F.pad(a, (0, 0, 1, 0))[:, :L.Y]

    k = torch.maximum(plane(0), zsh(plane(1)))
    k = torch.maximum(k, ysh(plane(2)))
    k = torch.maximum(k, ysh(zsh(plane(3))))
    return k[:, :, :L.Z].contiguous()


def shadow_from_canonical(num: torch.Tensor, w: torch.Tensor, layout
                          ) -> torch.Tensor:
    """Pack canonical (X, Y, Z) (num, w) into the (shadow_rows, 128) int32
    slot shadow: lane 32 c + s of row (x, y, gk) is [P, P(z+1), P(y+1),
    P(y+1, z+1)][c] at z = 32 gk + s, zero outside the volume."""
    L = layout
    zs = 32 * L.GK
    P = F.pad(pack16_numw(num, w), (0, zs - L.Z))

    def zp(a):           # P(y, z+1)
        return F.pad(a, (0, 1))[:, :, 1:]

    def yp(a):           # P(y+1, z)
        return F.pad(a, (0, 0, 0, 1))[:, 1:]

    comps = [P, zp(P), yp(P), zp(yp(P))]
    sh = torch.stack([c.reshape(L.X, L.Y, L.GK, 32) for c in comps], dim=3)
    return sh.reshape(L.shadow_rows, 128)


def build_shadow_plain(geo: torch.Tensor, layout) -> torch.Tensor:
    num, w = reconcile_slot_plain(geo, layout)
    return shadow_from_canonical(num, w, layout)


def build_shadow_dirty_plain(geo, prev_shadow, dirty, layout, ty: int):
    """Rebuild the (x, y-tile) tiles whose ``dirty`` flag is set, in place
    in ``prev_shadow`` (which is returned); clean tiles keep their words."""
    L = layout
    nj = L.Y // ty
    new = build_shadow_plain(geo, L).view(L.X, nj, ty * L.GK, 128)
    sel = dirty[:L.X * nj].reshape(L.X, nj) != 0
    prev_shadow.view(L.X, nj, ty * L.GK, 128)[sel] = new[sel]
    return prev_shadow


# -- the CUDA library ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    """``csrc/shadow_build.cu``, built at first use, with its signatures."""
    lib, _ = _build.load_library("shadow_build")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sf_shadow_build.argtypes = [p, i, p, p, i, i, i, i, i, i, i, p]
    lib.sf_reconcile_slot.argtypes = [p, i, p, p, i, i, i, i, i, p]
    lib.sf_reconcile_key.argtypes = [p, p, i, i, i, i, p]
    for fn in (lib.sf_shadow_build, lib.sf_reconcile_slot,
               lib.sf_reconcile_key):
        fn.restype = i
    return lib


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _device_of(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def _check_geo(geo: torch.Tensor, layout):
    if geo.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"geo must be float32 or bfloat16, got {geo.dtype}")
    if tuple(geo.shape) != (layout.geo_rows, 128) or not geo.is_contiguous():
        raise ValueError(f"geo must be a contiguous ({layout.geo_rows}, 128)"
                         f" tensor, got {tuple(geo.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_shadow(geo, out, dirty, layout, ty: int):
    L = layout
    if ty <= 0 or L.Y % ty:
        raise ValueError(f"bad shadow tiling TY={ty} for {L}")
    # the kernel copies geo rows and stores shadow words 16 bytes at a
    # time: every geo row (G * 128 elements) and both bases must be
    # 16-byte aligned
    if ((L.G * 128 * geo.element_size()) % 16 or geo.data_ptr() % 16
            or out.data_ptr() % 16):
        raise ValueError("shadow build: geo rows and the shadow must be "
                         "16-byte aligned")
    lib = _lib()
    _check(lib.sf_shadow_build(
        geo.data_ptr(), int(geo.dtype == torch.bfloat16), out.data_ptr(),
        None if dirty is None else dirty.data_ptr(), L.X, L.Y, L.Z, L.G,
        L.GK, L.SY, ty, _stream(geo)), "shadow_build_kernel")


# -- wrappers -----------------------------------------------------------------

def build_shadow(geo: torch.Tensor, layout, ty: int) -> torch.Tensor:
    """Slot geo state -> (shadow_rows, 128) int32 gather shadow."""
    if _device_of(geo, "build_shadow") == "cpu":
        return build_shadow_plain(geo, layout)
    _check_geo(geo, layout)
    out = torch.empty((layout.shadow_rows, 128), dtype=torch.int32,
                      device=geo.device)
    _launch_shadow(geo, out, None, layout, ty)
    build_shadow.launches += 1
    return out


def build_shadow_dirty(geo: torch.Tensor, prev_shadow: torch.Tensor,
                       dirty: torch.Tensor, layout, ty: int) -> torch.Tensor:
    """Rebuild only the dirty (x, y-tile) tiles of ``prev_shadow``, in
    place (the Pallas kernel aliases its previous shadow into the output
    the same way); returns ``prev_shadow``. ``dirty`` is the (X * NJ + 1,)
    int32 mask of ``rowvol.dirty_tile_mask``."""
    if _device_of(geo, "build_shadow_dirty") == "cpu":
        return build_shadow_dirty_plain(geo, prev_shadow, dirty, layout, ty)
    _check_geo(geo, layout)
    L = layout
    if (prev_shadow.dtype != torch.int32 or not prev_shadow.is_contiguous()
            or tuple(prev_shadow.shape) != (L.shadow_rows, 128)):
        raise ValueError("prev_shadow must be a contiguous "
                         f"({L.shadow_rows}, 128) int32 tensor")
    if (dirty.dtype != torch.int32 or not dirty.is_contiguous()
            or dirty.numel() < L.X * (L.Y // ty)):
        raise ValueError("dirty must be a contiguous int32 tile mask")
    if prev_shadow.device != geo.device or dirty.device != geo.device:
        raise ValueError("geo, prev_shadow and dirty must share a device")
    _launch_shadow(geo, prev_shadow, dirty, layout, ty)
    build_shadow_dirty.launches += 1
    return prev_shadow


def reconcile_slot(geo: torch.Tensor, layout):
    """Slot geo state -> canonical (num, w), each (X, Y, Z) f32."""
    if _device_of(geo, "reconcile_slot") == "cpu":
        return reconcile_slot_plain(geo, layout)
    _check_geo(geo, layout)
    L = layout
    num = torch.empty((L.X, L.Y, L.Z), dtype=torch.float32,
                      device=geo.device)
    w = torch.empty_like(num)
    lib = _lib()
    _check(lib.sf_reconcile_slot(
        geo.data_ptr(), int(geo.dtype == torch.bfloat16), num.data_ptr(),
        w.data_ptr(), L.X, L.Y, L.Z, L.G, L.SY, _stream(geo)),
        "reconcile_slot_kernel")
    reconcile_slot.launches += 1
    return num, w


def reconcile_key(key: torch.Tensor, layout) -> torch.Tensor:
    """Key slot state -> canonical (X, Y, Z) int32 packed keys."""
    if _device_of(key, "reconcile_key") == "cpu":
        return reconcile_key_plain(key, layout)
    L = layout
    if (key.dtype != torch.int32 or not key.is_contiguous()
            or tuple(key.shape) != (L.key_rows, 128)):
        raise ValueError(f"key must be a contiguous ({L.key_rows}, 128) "
                         "int32 tensor")
    out = torch.empty((L.X, L.Y, L.Z), dtype=torch.int32, device=key.device)
    lib = _lib()
    _check(lib.sf_reconcile_key(key.data_ptr(), out.data_ptr(), L.X, L.Y,
                                L.Z, L.GK, _stream(key)),
           "reconcile_key_kernel")
    reconcile_key.launches += 1
    return out


# -- scene-folded entry points -------------------------------------------------

def _folded(layout, S: int):
    return layout._replace(X=S * layout.X)


def _bcast(a: torch.Tensor, ndim: int, S: int) -> torch.Tensor:
    """``a`` with the scene axis: as it is where it has one (``ndim`` + 1
    dims), else a contiguous copy for each of the S scenes."""
    if a.dim() == ndim + 1:
        return a
    return a[None].expand((S,) + tuple(a.shape)).contiguous()


def build_shadow_v(geo: torch.Tensor, layout, ty: int) -> torch.Tensor:
    """(S, geo_rows, 128) slot states -> (S, shadow_rows, 128) shadows in
    one launch."""
    S = geo.shape[0]
    out = build_shadow(geo.reshape(S * layout.geo_rows, 128),
                       _folded(layout, S), ty)
    return out.view(S, layout.shadow_rows, 128)


def build_shadow_dirty_v(geo: torch.Tensor, prev_shadow: torch.Tensor,
                         dirty: torch.Tensor, layout, ty: int
                         ) -> torch.Tensor:
    """:func:`build_shadow_dirty` over S scenes in one launch: ``geo``
    (S, geo_rows, 128), ``prev_shadow`` (S, shadow_rows, 128) and ``dirty``
    (S, X * NJ + 1), each of them or all but one without the scene axis
    (then broadcast). The folded mask is each scene's first X * NJ flags,
    concatenated, then one sentinel 0. A batched ``prev_shadow`` is
    updated in place; returns the (S, shadow_rows, 128) shadows."""
    batched = [t.shape[0] for t, nd in ((geo, 2), (prev_shadow, 2),
                                        (dirty, 1)) if t.dim() == nd + 1]
    if not batched:
        raise ValueError("build_shadow_dirty_v: no operand has a scene axis")
    S = batched[0]
    nt = layout.X * (layout.Y // ty)
    geo = _bcast(geo, 2, S)
    prev_shadow = _bcast(prev_shadow, 2, S)
    dirty = _bcast(dirty, 1, S)
    flags = torch.cat([dirty[:, :nt].reshape(-1),
                       torch.zeros(1, dtype=dirty.dtype, device=dirty.device)])
    build_shadow_dirty(geo.reshape(S * layout.geo_rows, 128),
                       prev_shadow.view(S * layout.shadow_rows, 128), flags,
                       _folded(layout, S), ty)
    return prev_shadow


def reconcile_slot_v(geo: torch.Tensor, layout):
    """(S, geo_rows, 128) -> canonical (num, w), each (S, X, Y, Z)."""
    S = geo.shape[0]
    num, w = reconcile_slot(geo.reshape(S * layout.geo_rows, 128),
                            _folded(layout, S))
    shape = (S, layout.X, layout.Y, layout.Z)
    return num.view(shape), w.view(shape)


def reconcile_key_v(key: torch.Tensor, layout) -> torch.Tensor:
    """(S, key_rows, 128) -> canonical (S, X, Y, Z) packed keys."""
    S = key.shape[0]
    out = reconcile_key(key.reshape(S * layout.key_rows, 128),
                        _folded(layout, S))
    return out.view(S, layout.X, layout.Y, layout.Z)


_WRAPPERS = (build_shadow_dirty, build_shadow, reconcile_slot, reconcile_key)


def reset_launch_counts():
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
