"""Coordinate math and the packed-bf16 (num | w) word.

Port of ``segfusion_tpu/ops/geometry.py`` (``unproject``,
``sample_ray_points``, ``pack16_numw``, ``unpack16_numw``). Conventions are
the reference's: depth maps are (h, w), pixel (v, u) with depth d unprojects
to K^-1 [u d, v d, d]; ``extrinsics`` is camera-to-world; voxel coordinates
are (world - origin) / resolution.

Every function takes an optional leading batch axis (frames), written out
where the JAX package used ``vmap``.
"""

from __future__ import annotations

import torch

__all__ = ["INVALID_TSDF_FILL", "unproject", "sample_ray_points",
           "pack16_numw", "unpack16_numw"]

INVALID_TSDF_FILL = -0.1  # value read for out-of-bounds corners


def _apply3(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``p @ m^T`` for (..., n, 3) points and (..., 3, 3) matrices, as
    explicit f32 products: the coordinate math must stay full f32 (no
    TF32 or reduced-precision matmul path on the card)."""
    m = m[..., None, :, :]
    return torch.stack([p[..., 0] * m[..., i, 0] + p[..., 1] * m[..., i, 1]
                        + p[..., 2] * m[..., i, 2] for i in range(3)], -1)


def unproject(depth: torch.Tensor, extrinsics: torch.Tensor,
              intrinsics: torch.Tensor) -> torch.Tensor:
    """Back-project (..., h, w) depth maps to (..., h*w, 3) world points
    (``extrinsics`` (..., 4, 4) camera-to-world, ``intrinsics`` (..., 3, 3))."""
    h, w = depth.shape[-2:]
    dev = depth.device
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    d = depth.float()
    pts_p = torch.stack([u * d, v * d, d], -1).reshape(
        depth.shape[:-2] + (h * w, 3))
    k_inv = torch.linalg.inv(intrinsics.float())
    pts_c = _apply3(pts_p, k_inv)
    rot = extrinsics[..., :3, :3].float()
    trans = extrinsics[..., None, :3, 3].float()
    return _apply3(pts_c, rot) + trans


def sample_ray_points(points_w: torch.Tensor, eye_w: torch.Tensor,
                      origin: torch.Tensor, resolution, n_points: int
                      ) -> torch.Tensor:
    """``n_points`` voxel-space samples one voxel apart along each
    eye->surface ray, centred on the surface point and ordered front to
    back: points_w (..., n, 3), eye_w (..., 3) -> (..., n, n_points, 3)."""
    k = (n_points - 1) // 2
    center_v = (points_w - origin) / resolution
    eye_v = (eye_w[..., None, :] - origin) / resolution
    direction = center_v - eye_v
    norm = torch.linalg.vector_norm(direction, dim=-1, keepdim=True)
    direction = direction / torch.clamp_min(norm, 1e-12)
    offsets = torch.arange(-k, k + 1, dtype=torch.float32,
                           device=points_w.device)
    return (center_v[..., :, None, :]
            + offsets[:, None] * direction[..., :, None, :])


def pack16_numw(num: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(num, w) f32 -> one int32 word of two bf16 halves (num high, w low).

    Bit-identical to the JAX package's u32 word (view it as uint32 to
    compare). Rounding is RTNE by the add-half-to-even integer trick on
    the f32 bits, in int32 with wraparound: torch has no uint32 add,
    shift or compare on the CPU. Precondition: finite inputs."""
    nb = num.float().contiguous().view(torch.int32)
    wb = w.float().contiguous().view(torch.int32)
    nr = (nb + (0x7FFF + ((nb >> 16) & 1))) & -65536
    wr = ((wb + (0x7FFF + ((wb >> 16) & 1))) >> 16) & 0xFFFF
    return nr | wr


def unpack16_numw(g: torch.Tensor):
    """Inverse of :func:`pack16_numw`: int32 word -> (num f32, w f32)."""
    num = (g & -65536).view(torch.float32)
    w = (g << 16).view(torch.float32)
    return num, w
