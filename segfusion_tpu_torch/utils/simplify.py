"""Mesh decimation on the host: quadric edge collapse and grid vertex
clustering.

The QEM decimator is ``csrc/simplify.cpp``, a byte-for-byte copy of the
JAX package's ``segfusion_tpu/native/simplify.cpp``, built with g++ at
first use into ``build/segfusion_tpu_torch/``; it replaces the
reference's meshlabserver quadric decimation (TargetFaceNum 5000,
QualityThr 0.5). A failed build raises: there is no clustering fallback
behind :func:`simplify_quadric`. :func:`simplify_cluster` is the
preprocessing tool's ``--method cluster``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from ..ops.kernels import _build

__all__ = ["simplify_quadric", "simplify_cluster", "SIMPLIFY_SOURCE"]

SIMPLIFY_SOURCE = _build.CSRC / "simplify.cpp"

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


@functools.lru_cache(maxsize=None)
def _lib():
    lib, _ = _build.load_host_library(SIMPLIFY_SOURCE)
    lib.simplify_qem.restype = ctypes.c_int32
    lib.simplify_qem.argtypes = [_f32p, ctypes.c_int64, _i32p,
                                 ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_float, _f32p, _i32p, _i64p, _i64p]
    return lib


def simplify_quadric(vertices: np.ndarray, faces: np.ndarray,
                     target_faces: int = 5000, quality_thr: float = 0.5
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """QEM edge-collapse decimation to at most ``target_faces`` faces
    (optimal placement, normal preservation, cleanup of unused vertices);
    a mesh already at or below the target comes back unchanged."""
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"expected (n, 3) vertices and (m, 3) faces, got "
                         f"{v.shape} and {f.shape}")
    if target_faces < 1:
        raise ValueError(f"target_faces must be at least 1, got "
                         f"{target_faces}")
    if len(f) <= target_faces:
        return v, f
    if f.min() < 0 or f.max() >= len(v):
        raise ValueError("face indices outside the vertex array")
    out_v, out_f = np.empty_like(v), np.empty_like(f)
    onv, onf = ctypes.c_int64(), ctypes.c_int64()
    rc = _lib().simplify_qem(v.ctypes.data_as(_f32p), len(v),
                             f.ctypes.data_as(_i32p), len(f),
                             int(target_faces), float(quality_thr),
                             out_v.ctypes.data_as(_f32p),
                             out_f.ctypes.data_as(_i32p), ctypes.byref(onv),
                             ctypes.byref(onf))
    if rc != 0:
        raise RuntimeError(f"simplify_qem refused its input ({rc})")
    return out_v[:onv.value].copy(), out_f[:onf.value].copy()


def simplify_cluster(vertices: np.ndarray, faces: np.ndarray,
                     cluster: float) -> Tuple[np.ndarray, np.ndarray]:
    """Grid vertex clustering: snap to a ``cluster``-sized grid, merge
    each cell's vertices to their mean, drop degenerate faces."""
    verts = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)
    keys = np.floor(verts / cluster).astype(np.int64)
    lin = (keys[:, 0] * 73856093) ^ (keys[:, 1] * 19349663) \
        ^ (keys[:, 2] * 83492791)
    uniq, inverse = np.unique(lin, return_inverse=True)
    new_verts = np.zeros((len(uniq), 3), np.float64)
    counts = np.zeros(len(uniq), np.int64)
    np.add.at(new_verts, inverse, verts)
    np.add.at(counts, inverse, 1)
    new_verts /= counts[:, None]
    new_faces = inverse.reshape(-1)[faces]
    good = ((new_faces[:, 0] != new_faces[:, 1])
            & (new_faces[:, 1] != new_faces[:, 2])
            & (new_faces[:, 0] != new_faces[:, 2]))
    return new_verts.astype(np.float32), new_faces[good].astype(np.int32)
