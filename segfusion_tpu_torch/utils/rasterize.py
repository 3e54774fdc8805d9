"""Software z-buffer rasterizer of triangle meshes, on the host.

The C++ renderer is ``csrc/rasterize.cpp``, a byte-for-byte copy of the
JAX package's ``segfusion_tpu/native/rasterize.cpp``, built with g++ at
first use into ``build/segfusion_tpu_torch/`` (``ops/kernels/_build.py``,
the JAX package's flags). It replaces the reference's OpenGL renderer for
the offline mesh preprocessing (``preprocess/fuse.py``). There is no
numpy fallback: a failed build raises. :func:`rasterize_plain` is the
plain numpy version the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from ..ops.kernels import _build

__all__ = ["rasterize_depth", "rasterize", "rasterize_plain",
           "RASTERIZE_SOURCE"]

RASTERIZE_SOURCE = _build.CSRC / "rasterize.cpp"

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


@functools.lru_cache(maxsize=None)
def _lib():
    lib, _ = _build.load_host_library(RASTERIZE_SOURCE)
    head = [_f32p, ctypes.c_int64, _i32p, ctypes.c_int64, _f32p, _f32p]
    lib.rasterize_depth.restype = None
    lib.rasterize_depth.argtypes = head + [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
        _f32p]
    lib.rasterize_full.restype = None
    lib.rasterize_full.argtypes = head + [
        _f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
        ctypes.c_float, _f32p, _u8p, _u8p]
    return lib


def _inputs(vertices, faces, view, intrinsics):
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"expected (n, 3) vertices and (m, 3) faces, got "
                         f"{v.shape} and {f.shape}")
    if len(f) and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("face indices outside the vertex array")
    vw = np.ascontiguousarray(view, np.float32).reshape(4, 4)
    k = np.ascontiguousarray(intrinsics, np.float32).reshape(3, 3)
    return v, f, vw, k


def rasterize_depth(vertices: np.ndarray, faces: np.ndarray,
                    view: np.ndarray, intrinsics: np.ndarray, h: int,
                    w: int, znear: float = 0.05, zfar: float = 100.0
                    ) -> np.ndarray:
    """(h, w) float32 z-buffered depth of a triangle mesh (0: no hit).
    ``vertices`` (n, 3) world coordinates, ``faces`` (m, 3) indices,
    ``view`` the (4, 4) world -> camera matrix (z forward, y down, x
    right), ``intrinsics`` (3, 3)."""
    v, f, vw, k = _inputs(vertices, faces, view, intrinsics)
    out = np.zeros((h, w), np.float32)
    _lib().rasterize_depth(v.ctypes.data_as(_f32p), len(v),
                           f.ctypes.data_as(_i32p), len(f),
                           vw.ctypes.data_as(_f32p), k.ctypes.data_as(_f32p),
                           h, w, znear, zfar, out.ctypes.data_as(_f32p))
    return out


def rasterize(vertices: np.ndarray, faces: np.ndarray, view: np.ndarray,
              intrinsics: np.ndarray, h: int, w: int, znear: float = 0.05,
              zfar: float = 100.0, colors: Optional[np.ndarray] = None):
    """The reference renderer's triple: depth (h, w) float32 (0: no hit),
    mask (h, w) bool, rgb (h, w, 3) uint8. ``colors`` (n, 3) per-vertex
    in [0, 1], interpolated perspective-correct; without them the mesh
    is flat-shaded from the camera-space face normal."""
    v, f, vw, k = _inputs(vertices, faces, view, intrinsics)
    col = None
    if colors is not None:
        col = np.ascontiguousarray(colors, np.float32)
        if col.shape != v.shape:
            raise ValueError(f"colors {col.shape} for vertices {v.shape}")
    depth = np.zeros((h, w), np.float32)
    mask = np.zeros((h, w), np.uint8)
    rgb = np.zeros((h, w, 3), np.uint8)
    _lib().rasterize_full(
        v.ctypes.data_as(_f32p), len(v), f.ctypes.data_as(_i32p), len(f),
        vw.ctypes.data_as(_f32p), k.ctypes.data_as(_f32p),
        None if col is None else col.ctypes.data_as(_f32p), h, w, znear,
        zfar, depth.ctypes.data_as(_f32p), mask.ctypes.data_as(_u8p),
        rgb.ctypes.data_as(_u8p))
    return depth, mask.astype(bool), rgb


def rasterize_plain(vertices, faces, view, intrinsics, h, w, znear=0.05,
                    zfar=100.0, colors=None):
    """The same render in numpy, a triangle at a time (slow): (depth,
    rgb), as the JAX package's ``_rasterize_numpy``."""
    v, f, view, k = _inputs(vertices, faces, view, intrinsics)
    cam = v @ view[:3, :3].T + view[:3, 3]
    depth = np.zeros((h, w), np.float32)
    rgb = np.zeros((h, w, 3), np.uint8)
    fx, cx, fy, cy = k[0, 0], k[0, 2], k[1, 1], k[1, 2]
    for tri in f:
        a, b, c = cam[tri]
        if min(a[2], b[2], c[2]) < znear or max(a[2], b[2], c[2]) > zfar:
            continue
        pts = np.array([[fx * p[0] / p[2] + cx, fy * p[1] / p[2] + cy]
                        for p in (a, b, c)])
        x0 = max(0, int(np.floor(pts[:, 0].min())))
        x1 = min(w - 1, int(np.ceil(pts[:, 0].max())))
        y0 = max(0, int(np.floor(pts[:, 1].min())))
        y1 = min(h - 1, int(np.ceil(pts[:, 1].max())))
        if x0 > x1 or y0 > y1:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1 + 1) + 0.5,
                             np.arange(y0, y1 + 1) + 0.5)
        (ua, va), (ub, vb), (uc, vc) = pts
        area = (ub - ua) * (vc - va) - (uc - ua) * (vb - va)
        if abs(area) < 1e-12:
            continue
        w0 = ((ub - xs) * (vc - ys) - (uc - xs) * (vb - ys)) / area
        w1 = ((uc - xs) * (va - ys) - (ua - xs) * (vc - ys)) / area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        inv_z = w0 / a[2] + w1 / b[2] + w2 / c[2]
        with np.errstate(divide="ignore"):
            z = np.where(inv_z > 0, 1.0 / inv_z, 0.0)
        patch = depth[y0:y1 + 1, x0:x1 + 1]
        write = inside & (z >= znear) & (z <= zfar) \
            & ((patch == 0) | (z < patch))
        patch[write] = z[write]
        if colors is not None:
            ca, cb, cc = np.asarray(colors, np.float32)[tri]
            shade = (w0[..., None] / a[2] * ca + w1[..., None] / b[2] * cb
                     + w2[..., None] / c[2] * cc) * z[..., None]
        else:
            n = np.cross(b - a, c - a)
            nl = np.linalg.norm(n)
            s = 0.2 + 0.8 * abs(n[2]) / nl if nl > 0 else 0.2
            shade = np.broadcast_to(np.float64(s), z.shape + (3,))
        val = np.clip(shade, 0, 1) * 255.0 + 0.5
        rgb[y0:y1 + 1, x0:x1 + 1][write] = val[write].astype(np.uint8)
    return depth, rgb
