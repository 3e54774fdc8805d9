"""Builds the port's native libraries at first use and loads them with
ctypes.

CUDA sources ``segfusion_tpu_torch/csrc/<name>.cu`` are compiled with nvcc
for sm_90a (a plain C interface, no PyTorch headers, so a build takes
seconds); host C++ sources with g++. Each shared library is named by a
hash of its source and flags under ``build/segfusion_tpu_torch/`` at the
repository root, so a changed source rebuilds and an unchanged one loads
what is there. A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "load_host_library", "CSRC", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "segfusion_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the JAX package builds its host libraries with the same flags
# (segfusion_tpu/native/mcubes.py), so both produce the same machine code
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {nvcc})")
    return nvcc


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    return gxx


def _build_and_load(source: Path, compiler: str, flags):
    """Compile ``source`` unless a library with its hash exists; returns
    ``(lib, info)``: info holds the .so path, the build seconds (0.0 when
    the library already existed) and the compiler's output."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    so = BUILD_DIR / f"{source.stem}_{tag[:16]}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([compiler, *flags, "-o", str(tmp),
                               str(source)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(compiler).name} failed "
                               f"({proc.returncode}) on {source}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)   # atomic: concurrent builds race harmlessly
        log = proc.stdout + proc.stderr
    return ctypes.CDLL(str(so)), {"path": str(so), "seconds": seconds,
                                  "log": log}


@functools.lru_cache(maxsize=None)
def load_library(name: str):
    """Build (nvcc, sm_90a) and load ``csrc/<name>.cu``; ``(lib, info)``.
    The caller declares the entry points' ctypes signatures."""
    return _build_and_load(CSRC / f"{name}.cu", _nvcc(), NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def load_host_library(source: Path):
    """Build (g++) and load a host C++ source with a plain C interface;
    ``(lib, info)``."""
    return _build_and_load(Path(source), _gxx(), GXX_FLAGS)
