"""Marching-tetrahedra isosurface extraction on the host.

The C++ mesher is ``csrc/mcubes.cpp``, a byte-for-byte copy of the JAX
package's ``segfusion_tpu/native/mcubes.cpp``, built with g++ by the
``_build`` helper into ``build/segfusion_tpu_torch/`` with the JAX
package's compiler flags, so both packages mesh a volume identically. There
is no numpy fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..ops.kernels import _build

__all__ = ["marching_cubes", "MCUBES_SOURCE"]

MCUBES_SOURCE = _build.CSRC / "mcubes.cpp"


@functools.lru_cache(maxsize=None)
def _lib():
    lib, _ = _build.load_host_library(MCUBES_SOURCE)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.c_int64
    lib.mt_run.restype = ctypes.c_int
    lib.mt_run.argtypes = [f32p, i64, i64, i64, ctypes.c_float,
                           ctypes.c_float, ctypes.POINTER(f32p),
                           ctypes.POINTER(i32p), ctypes.POINTER(f32p),
                           ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.mt_free.restype = None
    lib.mt_free.argtypes = [ctypes.c_void_p]
    return lib


def marching_cubes(volume: np.ndarray, level: float = 0.0,
                   spacing: float = 1.0):
    """Isosurface of a host (X, Y, Z) volume at ``level``: vertices (n, 3)
    f32 scaled by ``spacing``, faces (m, 3) int32, normals (n, 3) f32
    pointing toward increasing values. Empty arrays where the level is not
    crossed (the JAX package's wrapper raises ValueError there)."""
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    if vol.ndim != 3:
        raise ValueError(f"expected a 3-D volume, got {vol.shape}")
    lib = _lib()
    f32p = ctypes.POINTER(ctypes.c_float)
    vp, npp = f32p(), f32p()
    fp = ctypes.POINTER(ctypes.c_int32)()
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.mt_run(vol.ctypes.data_as(f32p), *vol.shape,
                    ctypes.c_float(level), ctypes.c_float(spacing),
                    ctypes.byref(vp), ctypes.byref(fp), ctypes.byref(npp),
                    ctypes.byref(nv), ctypes.byref(nf))
    n, m = nv.value, nf.value
    out = None
    if rc == 0:
        out = (np.ctypeslib.as_array(vp, shape=(max(n, 1), 3))[:n].copy(),
               np.ctypeslib.as_array(fp, shape=(max(m, 1), 3))[:m].copy(),
               np.ctypeslib.as_array(npp, shape=(max(n, 1), 3))[:n].copy())
    for p in (vp, fp, npp):
        lib.mt_free(p)
    if out is None:
        raise MemoryError("mt_run could not allocate its outputs")
    return out
