"""The plain recurrence that a stream cell's volume is held to.

One frame at a time over canonical (X, Y, Z) float32 volumes, the
semantics of ``configs/fusion/*.yaml`` as the port states them (its
module docstrings and the JAX package's flat path): unproject the depth,
``n_points`` samples one voxel apart along each ray centred on the
surface, the reference's 8-corner "centre" trilinear scheme, corner
values ``num / w`` (``init_value`` where unobserved, -0.1 and weight 0
outside the volume) read through bfloat16-rounded (num, w) words
(``gather_precision: f16packed``), FusionNet, then the first
``n_tail_points`` clipped estimates scatter-added (w and w * v) into
every in-bounds corner, and with semantics the packed (score, id) key
scatter-maxed into them. Written from that description with plain
``torch`` operations; nothing of the port is imported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["FILL", "ray_samples", "corners", "extract", "integrate",
           "pack_key", "Volume", "step"]

FILL = -0.1                        # value of a corner outside the volume
_SCORE_SCALE = float((1 << 23) - 1)


class Volume:
    """Accumulator state: num = sum w * v, w = sum w, key = max packed key."""

    def __init__(self, shape, origin, resolution, init_value, device):
        self.num = torch.zeros(shape, dtype=torch.float32, device=device)
        self.w = torch.zeros(shape, dtype=torch.float32, device=device)
        self.key = torch.zeros(shape, dtype=torch.int32, device=device)
        self.origin = torch.as_tensor(origin, dtype=torch.float32,
                                      device=device)
        self.resolution = float(resolution)
        self.init_value = float(init_value)
        self.probe_sum, self.probe_n = 0.0, 0    # see ``step``'s ``probe``

    def tsdf(self):
        return torch.where(self.w > 0,
                           self.num / torch.clamp_min(self.w, 1e-12),
                           self.init_value)


def ray_samples(depth, extrinsics, intrinsics, origin, resolution,
                n_points: int):
    """(h, w) depth -> (h*w, n_points, 3) voxel-space samples, front to
    back, one voxel apart, centred on each pixel's surface point."""
    h, w = depth.shape
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                       device=depth.device),
                          torch.arange(w, dtype=torch.float32,
                                       device=depth.device), indexing="ij")
    d = depth.float()
    pix = torch.stack([u * d, v * d, d], -1).reshape(-1, 3)
    cam = pix @ torch.linalg.inv(intrinsics.double()).float().T
    world = cam @ extrinsics[:3, :3].float().T + extrinsics[:3, 3].float()
    centre = (world - origin) / resolution
    eye = (extrinsics[:3, 3].float() - origin) / resolution
    direction = centre - eye
    direction = direction / torch.clamp_min(
        direction.norm(dim=-1, keepdim=True), 1e-12)
    k = (n_points - 1) // 2
    steps = torch.arange(-k, k + 1, dtype=torch.float32, device=depth.device)
    return centre[:, None, :] + steps[:, None] * direction[:, None, :]


def corners(points, shape):
    """The 8 corners of each (..., 3) point: the containing voxel and its
    neighbour towards the point along each axis, the neighbour weighted by
    the point's distance from the voxel centre. Returns linear indices
    (clamped; int64), in-bounds masks and trilinear weights, (..., 8)."""
    base = torch.floor(points)
    step = torch.sign(base + 0.5 - points)
    frac = torch.abs(points - (base + 0.5))
    lin = valid = weight = None
    for a, size in enumerate(shape):
        stride = 1
        for s in shape[a + 1:]:
            stride *= s
        c = torch.stack([base[..., a], base[..., a] + step[..., a]], -1)
        wa = torch.stack([1.0 - frac[..., a], frac[..., a]], -1)
        ok = (c >= 0) & (c < size)
        la = torch.clamp(c, 0, size - 1).long() * stride
        if lin is None:
            lin, valid, weight = la, ok, wa
        else:   # outer product over this axis: corner order (i, j, k)
            lin = (lin[..., :, None] + la[..., None, :]).flatten(-2)
            valid = (valid[..., :, None] & ok[..., None, :]).flatten(-2)
            weight = (weight[..., :, None] * wa[..., None, :]).flatten(-2)
    return lin, valid, weight


def extract(vol: Volume, points):
    """Trilinear (values, weights), each (n, p), through bf16 words."""
    lin, valid, cw = corners(points, tuple(vol.num.shape))
    num = vol.num.reshape(-1)[lin].to(torch.bfloat16).float()
    w = vol.w.reshape(-1)[lin].to(torch.bfloat16).float()
    v = torch.where(w > 0, num / torch.clamp_min(w, 1e-12), vol.init_value)
    v = torch.where(valid, v, FILL)
    w = torch.where(valid, w, 0.0)
    return (v * cw).sum(-1), (w * cw).sum(-1)


def pack_key(scores, ids):
    """Score in [0, 1] on 23 bits above the 8-bit class id."""
    q = torch.clamp(torch.round(scores.float() * _SCORE_SCALE), 0.0,
                    _SCORE_SCALE).to(torch.int32)
    return q * 256 + ids.to(torch.int32)


def integrate(vol: Volume, points, values, ray_mask, key=None):
    """Scatter (n, t) estimates at (n, t, 3) samples into ``vol``."""
    lin, valid, cw = corners(points, tuple(vol.num.shape))
    valid = valid & ray_mask[:, None, None]
    cw = torch.where(valid, cw, 0.0)
    vol.w.view(-1).index_add_(0, lin.reshape(-1), cw.reshape(-1))
    vol.num.view(-1).index_add_(0, lin.reshape(-1),
                                (cw * values[:, :, None]).reshape(-1))
    if key is not None:
        k = torch.where(valid, key[:, None, None], 0)
        vol.key.view(-1).scatter_reduce_(0, lin.reshape(-1), k.reshape(-1),
                                         "amax")


def bf16_round(t):
    """``t`` rounded to bfloat16 (to nearest even), kept in its dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def step(vol: Volume, net, frame: Dict[str, torch.Tensor], n_points: int,
         n_tail: int, n_classes: int, sem: Optional[tuple] = None,
         probe: bool = False, probe_ids=None):
    """One frame into ``vol``: ``frame`` holds depth (h, w), mask (h, w),
    extrinsics, intrinsics; ``sem`` the frame's (ids, scores) (h*w,) or
    None. With ``probe`` the frame's net also runs with its products'
    operands rounded to bfloat16 (and, where the frame is labelled, on the
    labels ``probe_ids`` of a segmenter so rounded), and the mean gap of
    the clipped estimates (over the rays with depth) adds to
    ``vol.probe_sum``: how far bfloat16 rounding alone moves this frame's
    estimates. Returns the clipped estimates."""
    depth = frame["depth"]
    h, w = depth.shape
    pts = ray_samples(depth, frame["extrinsics"], frame["intrinsics"],
                      vol.origin, vol.resolution, n_points)
    fv, fw = extract(vol, pts)
    inputs = {"tsdf_values": fv.reshape(1, h, w, n_points),
              "tsdf_weights": fw.reshape(1, h, w, n_points),
              "tsdf_frame": depth.reshape(1, h, w, 1)}
    key = None
    if sem is not None:
        ids, scores = sem
        inputs["semantic_frame"] = ((1.0 + ids.float()) / n_classes).reshape(
            1, h, w, 1)
        key = pack_key(scores, ids)
    est = net(inputs)[0, :, :n_tail]
    est = torch.clamp(est, -vol.init_value, vol.init_value)
    ray_mask = (torch.where(frame["mask"], depth, 0.0) != 0.0).reshape(-1)
    if probe:
        from .layers import set_quantiser
        if probe_ids is not None:
            inputs = dict(inputs, semantic_frame=(
                (1.0 + probe_ids.float()) / n_classes).reshape(1, h, w, 1))
        set_quantiser(net, bf16_round)
        low = torch.clamp(net(inputs)[0, :, :n_tail], -vol.init_value,
                          vol.init_value)
        set_quantiser(net, None)
        vol.probe_sum += float((low - est).abs()[ray_mask].mean())
        vol.probe_n += 1
    integrate(vol, pts[:, :n_tail], est, ray_mask, key)
    return est
