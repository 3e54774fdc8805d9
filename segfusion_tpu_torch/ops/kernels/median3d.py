"""3-D median filter of a label volume (K5): CUDA for the card, plain
PyTorch beside it for the CPU and for checking.

``median_filter3d`` replaces the Pallas TPU kernel
``segfusion_tpu/ops/pallas/median3d.py:104`` (``median_filter3d_pallas``).
For a CPU tensor it takes the plain version; for a CUDA tensor it launches
the hand-written kernel of ``csrc/median3d.cu`` (built with nvcc for sm_90a
at first use by ``_build``, loaded with ctypes) or raises. The kernel takes
uint8 volumes (label ids) and sizes 3 and 5; the plain version any
integer or float dtype and any odd size. The kernel packs four z-voxels
into a 32-bit word and runs the bitwise radix select in byte lanes
(``tests/test_torch_median.py`` holds a numpy model of that arithmetic
against the JAX median); the source note in the .cu file says what bounds
the kernel on the card and what its design does about it.
Launches are counted in ``median_filter3d.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["median_filter3d", "median_filter3d_plain", "launch_counts",
           "reset_launch_counts"]

# values per x-slab of the plain version's (slab, Y, Z, size^3) stack: 125
# views of a whole 448^3 volume would not fit (11 GB of values plus 90 GB
# of int64 sort indices)
_SLAB_VALUES = 1 << 27
KERNEL_SIZES = (3, 5)


def median_filter3d_plain(volume: torch.Tensor, size: int = 5
                          ) -> torch.Tensor:
    """Edge-replicated size^3 median filter; keeps the dtype.

    The sorted middle of the size^3 shifted views, as the JAX package's
    ``ops/filters.py::median_filter3d``; the views are built from clamped
    index tensors (edge replication), one x-slab at a time."""
    if size % 2 != 1:
        raise ValueError(f"median filter size must be odd, got {size}")
    if volume.dim() != 3:
        raise ValueError(f"expected a 3-D volume, got {tuple(volume.shape)}")
    r = size // 2
    X, Y, Z = volume.shape
    k = size ** 3
    dev = volume.device

    def clamped(lo, hi, n):
        return torch.arange(lo, hi, device=dev).clamp_(0, n - 1)

    ys, zs = clamped(-r, Y + r, Y), clamped(-r, Z + r, Z)
    slab = max(1, _SLAB_VALUES // (k * Y * Z))
    out = torch.empty_like(volume)
    for x0 in range(0, X, slab):
        sx = min(slab, X - x0)
        padded = volume.index_select(0, clamped(x0 - r, x0 + sx + r, X)) \
            .index_select(1, ys).index_select(2, zs)
        views = [padded[dx:dx + sx, dy:dy + Y, dz:dz + Z]
                 for dx in range(size) for dy in range(size)
                 for dz in range(size)]
        stack = torch.stack(views, dim=-1)
        out[x0:x0 + sx] = stack.sort(dim=-1).values[..., k // 2]
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    """``csrc/median3d.cu``, built at first use, with its signature."""
    lib, _ = _build.load_library("median3d")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sf_median3d_u8.argtypes = [p, p, i, i, i, i, p]
    lib.sf_median3d_u8.restype = i
    return lib


def median_filter3d(volume: torch.Tensor, size: int = 5) -> torch.Tensor:
    """Edge-replicated size^3 median filter of a 3-D volume; same shape
    and dtype. CPU: the plain version. CUDA: the K5 kernel, for a
    contiguous uint8 volume and size 3 or 5 (anything else raises)."""
    if volume.device.type == "cpu":
        return median_filter3d_plain(volume, size)
    if volume.device.type != "cuda":
        raise ValueError(f"median_filter3d: unsupported device {volume.device}")
    if volume.dtype != torch.uint8:
        raise TypeError(f"the median kernel takes uint8 volumes, got "
                        f"{volume.dtype}")
    if size not in KERNEL_SIZES:
        raise ValueError(f"the median kernel takes sizes {KERNEL_SIZES}, "
                         f"got {size}")
    if volume.dim() != 3 or not volume.is_contiguous():
        raise ValueError("the median kernel takes a contiguous 3-D volume, "
                         f"got shape {tuple(volume.shape)}")
    X, Y, Z = volume.shape
    if -(-X // 8) > 65535 or -(-Y // 16) > 65535:
        raise ValueError(f"volume {tuple(volume.shape)} exceeds the kernel's "
                         "grid")
    out = torch.empty_like(volume)
    rc = _lib().sf_median3d_u8(
        volume.data_ptr(), out.data_ptr(), X, Y, Z, size,
        torch.cuda.current_stream(volume.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"median3d_u8_kernel launch failed: cudaError {rc}")
    median_filter3d.launches += 1
    return out


def reset_launch_counts():
    median_filter3d.launches = 0


def launch_counts() -> dict:
    return {"median_filter3d": median_filter3d.launches}


reset_launch_counts()
