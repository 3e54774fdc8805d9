"""Coordinate math, the packed-bf16 (num | w) word and the flat
trilinear extraction.

Port of ``segfusion_tpu/ops/geometry.py``. Conventions are the
reference's: depth maps are (h, w), pixel (v, u) with depth d unprojects
to K^-1 [u d, v d, d]; ``extrinsics`` is camera-to-world; voxel coordinates
are (world - origin) / resolution.

``unproject`` and ``sample_ray_points`` take an optional leading batch
axis (frames), written out where the JAX package used ``vmap``. The flat
extraction (``interpolation_weights`` .. ``extract_numw``) reads a
canonical (X, Y, Z) volume through linear voxel indices: the scalar path
that ``SETTINGS.integration: scalar`` selects. Its linear indices are
int64 (torch indexes with them; the values are the JAX package's int32
ones), formed from integer corner coordinates, never in float.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["INVALID_TSDF_FILL", "unproject", "sample_ray_points",
           "pack16_numw", "unpack16_numw", "interpolation_weights",
           "valid_index_mask", "clamp_indices", "trilinear_gather",
           "trilinear_gather_numw", "interpolation_corners_factored",
           "trilinear_gather_packed16", "ExtractedValues", "extract",
           "extract_numw"]

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


# -- the flat extraction --------------------------------------------------------

def interpolation_weights(points_v: torch.Tensor):
    """The reference's 8 interpolation corners of each (..., 3) point: the
    containing voxel and its neighbour towards ``sign(centre - p)`` per
    axis, weight ``|p - centre|`` on the neighbour; corners in (i, j, k)
    order, i outermost. Returns (indices (..., 8, 3) int64, may be out of
    bounds; weights (..., 8) f32)."""
    idx = torch.floor(points_v)
    center = idx + 0.5
    neighbor = torch.sign(center - points_v)
    alpha = torch.abs(points_v - center)
    alpha_inv = 1.0 - alpha
    corners, weights = [], []
    for i in (0, 1):
        wi = alpha_inv[..., 0] if i == 0 else alpha[..., 0]
        xi = idx[..., 0] if i == 0 else idx[..., 0] + neighbor[..., 0]
        for j in (0, 1):
            wj = alpha_inv[..., 1] if j == 0 else alpha[..., 1]
            yj = idx[..., 1] if j == 0 else idx[..., 1] + neighbor[..., 1]
            for k in (0, 1):
                wk = alpha_inv[..., 2] if k == 0 else alpha[..., 2]
                zk = idx[..., 2] if k == 0 else idx[..., 2] + neighbor[..., 2]
                weights.append(wi * wj * wk)
                corners.append(torch.stack([xi, yj, zk], -1))
    return (torch.stack(corners, -2).to(torch.int64),
            torch.stack(weights, -1).float())


def _flatten_index(indices: torch.Tensor, shape) -> torch.Tensor:
    """(..., 3) integer indices -> ``ys*zs*x + zs*y + z``."""
    _, ys, zs = shape
    return indices[..., 0] * (ys * zs) + indices[..., 1] * zs + indices[..., 2]


def valid_index_mask(indices: torch.Tensor, shape) -> torch.Tensor:
    """Per-corner in-bounds mask."""
    xs, ys, zs = shape
    return ((indices[..., 0] >= 0) & (indices[..., 0] < xs)
            & (indices[..., 1] >= 0) & (indices[..., 1] < ys)
            & (indices[..., 2] >= 0) & (indices[..., 2] < zs))


def clamp_indices(indices: torch.Tensor, shape) -> torch.Tensor:
    hi = torch.tensor([s - 1 for s in shape], dtype=indices.dtype,
                      device=indices.device)
    return torch.minimum(torch.clamp_min(indices, 0), hi)


def _corner_lin(points_v, shape):
    indices, weights = interpolation_weights(points_v)
    valid = valid_index_mask(indices, shape)
    lin = _flatten_index(clamp_indices(indices, shape), shape)
    return indices, weights, valid, lin


def trilinear_gather(points_v: torch.Tensor, tsdf_volume: torch.Tensor,
                     weights_volume: torch.Tensor,
                     fill_value: float = INVALID_TSDF_FILL):
    """Trilinear samples of an explicit value volume and a weight volume
    at (n, p, 3) voxel-space points; out-of-bounds corners read
    ``fill_value`` and weight 0. Returns (values (n, p), weights (n, p),
    indices (n, p, 8, 3), corner weights (n, p, 8))."""
    indices, weights, valid, lin = _corner_lin(points_v,
                                               tuple(tsdf_volume.shape))
    t_c = torch.where(valid, tsdf_volume.reshape(-1)[lin].float(),
                      fill_value)
    w_c = torch.where(valid, weights_volume.reshape(-1)[lin].float(), 0.0)
    return ((t_c * weights).sum(-1), (w_c * weights).sum(-1), indices,
            weights)


def _corner_values(num_c, w_c, valid, init_value, fill_value):
    v_c = torch.where(w_c > 0, num_c / torch.clamp_min(w_c, 1e-12),
                      init_value)
    return (torch.where(valid, v_c, fill_value),
            torch.where(valid, w_c, 0.0))


def trilinear_gather_numw(points_v: torch.Tensor, num_volume: torch.Tensor,
                          weights_volume: torch.Tensor, init_value: float,
                          fill_value: float = INVALID_TSDF_FILL):
    """:func:`trilinear_gather` over the accumulator state: each corner's
    value is ``num / w`` (``init_value`` where unobserved)."""
    indices, weights, valid, lin = _corner_lin(points_v,
                                               tuple(num_volume.shape))
    v_c, w_c = _corner_values(num_volume.reshape(-1)[lin],
                              weights_volume.reshape(-1)[lin], valid,
                              init_value, fill_value)
    return ((v_c * weights).sum(-1), (w_c * weights).sum(-1), indices,
            weights)


def interpolation_corners_factored(points_v: torch.Tensor, shape):
    """:func:`interpolation_weights` + bounds mask + linearisation built
    from two candidates per axis. Returns (lin (..., 8) int64, clamped;
    valid (..., 8) bool; weights (..., 8) f32), corners i outermost."""
    strides = (shape[1] * shape[2], shape[2], 1)
    idx = torch.floor(points_v)
    center = idx + 0.5
    neighbor = torch.sign(center - points_v)
    alpha = torch.abs(points_v - center)
    comp_lin, comp_val, comp_w = [], [], []
    for a in range(3):
        c0 = idx[..., a].to(torch.int64)
        c1 = c0 + neighbor[..., a].to(torch.int64)
        comp_val.append(((c0 >= 0) & (c0 < shape[a]),
                         (c1 >= 0) & (c1 < shape[a])))
        comp_lin.append((torch.clamp(c0, 0, shape[a] - 1) * strides[a],
                         torch.clamp(c1, 0, shape[a] - 1) * strides[a]))
        comp_w.append((1.0 - alpha[..., a], alpha[..., a]))
    lins, vals, ws = [], [], []
    for i in (0, 1):
        for j in (0, 1):
            for k in (0, 1):
                lins.append(comp_lin[0][i] + comp_lin[1][j] + comp_lin[2][k])
                vals.append(comp_val[0][i] & comp_val[1][j] & comp_val[2][k])
                ws.append(comp_w[0][i] * comp_w[1][j] * comp_w[2][k])
    return (torch.stack(lins, -1), torch.stack(vals, -1),
            torch.stack(ws, -1).float())


def trilinear_gather_packed16(points_v: torch.Tensor,
                              num_volume: torch.Tensor,
                              weights_volume: torch.Tensor, init_value: float,
                              fill_value: float = INVALID_TSDF_FILL):
    """One gather per corner instead of two: the whole volume is packed to
    (num | w) bf16 words (:func:`pack16_numw`) on every call, then each
    corner reads one word. Returns (values, weights, lin, valid, corner
    weights)."""
    packed = pack16_numw(num_volume, weights_volume).reshape(-1)
    lin, valid, weights = interpolation_corners_factored(
        points_v, tuple(num_volume.shape))
    num_c, w_c = unpack16_numw(packed[lin])
    v_c, w_c = _corner_values(num_c, w_c, valid, init_value, fill_value)
    return ((v_c * weights).sum(-1), (w_c * weights).sum(-1), lin, valid,
            weights)


class ExtractedValues(NamedTuple):
    """Per-ray extraction. ``lin``/``valid`` are set by the packed path
    (the integrator scatters through them); ``indices`` by the others."""
    fusion_values: torch.Tensor     # (h*w, n_points)
    fusion_weights: torch.Tensor    # (h*w, n_points)
    points: torch.Tensor            # (h*w, n_points, 3) voxel space
    depth: torch.Tensor             # (h*w,)
    indices: Optional[torch.Tensor]  # (h*w, n_points, 8, 3) or None
    weights: torch.Tensor           # (h*w, n_points, 8)
    pcl: torch.Tensor               # (h*w, 3) world-space surface points
    lin: Optional[torch.Tensor] = None    # (h*w, n_points, 8) int64
    valid: Optional[torch.Tensor] = None  # (h*w, n_points, 8) bool


def _ray_points(depth, extrinsics, intrinsics, origin, resolution, n_points):
    points_w = unproject(depth, extrinsics, intrinsics)
    points_v = sample_ray_points(points_w, extrinsics[:3, 3].float(), origin,
                                 resolution, n_points)
    return points_w, points_v


def extract(depth: torch.Tensor, extrinsics: torch.Tensor,
            intrinsics: torch.Tensor, tsdf_volume: torch.Tensor,
            weights_volume: torch.Tensor, origin: torch.Tensor, resolution,
            n_points: int = 9) -> ExtractedValues:
    """One (h, w) frame: unproject -> ray samples -> trilinear gather of
    an explicit value volume. Every pixel gives a ray."""
    points_w, points_v = _ray_points(depth, extrinsics, intrinsics, origin,
                                     resolution, n_points)
    fv, fw, indices, weights = trilinear_gather(points_v, tsdf_volume,
                                                weights_volume)
    return ExtractedValues(fv, fw, points_v, depth.reshape(-1), indices,
                           weights, points_w)


def extract_numw(depth: torch.Tensor, extrinsics: torch.Tensor,
                 intrinsics: torch.Tensor, num_volume: torch.Tensor,
                 weights_volume: torch.Tensor, origin: torch.Tensor,
                 resolution, init_value: float, n_points: int = 9,
                 packed16: bool = False) -> ExtractedValues:
    """:func:`extract` over the accumulator state; ``packed16`` gathers
    through the packed bf16 words (:func:`trilinear_gather_packed16`)."""
    points_w, points_v = _ray_points(depth, extrinsics, intrinsics, origin,
                                     resolution, n_points)
    if packed16:
        fv, fw, lin, valid, weights = trilinear_gather_packed16(
            points_v, num_volume, weights_volume, init_value)
        return ExtractedValues(fv, fw, points_v, depth.reshape(-1), None,
                               weights, points_w, lin, valid)
    fv, fw, indices, weights = trilinear_gather_numw(
        points_v, num_volume, weights_volume, init_value)
    return ExtractedValues(fv, fw, points_v, depth.reshape(-1), indices,
                           weights, points_w)
