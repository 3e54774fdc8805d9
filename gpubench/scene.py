"""The benchmark's input frames: a synthetic room, a closed camera orbit
and depth rendered on the device.

The room and the orbit are copied from
``segfusion_tpu_torch/data/synthetic.py`` (``SyntheticScene``: a box room
with a sphere and a box placed from the seed; ``camera_poses``: a circle
of radius 0.45 half looking across the room centre). The renderer is the
lockstep march of ``segfusion_tpu_torch/ops/raycast.py`` (first sign
change from free space into material, refined linearly), written again
here over the analytic SDF instead of a sampled grid. The port only
receives the frames.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

__all__ = ["Room", "render_orbit"]


class Room:
    """The synthetic room of ``half`` metres, its objects placed from
    ``seed`` as ``SyntheticScene`` places them."""

    def __init__(self, seed: int, half: float):
        rng = np.random.RandomState(int(seed) % (1 << 32))
        self.half = half
        self.sphere_c = rng.uniform(-0.8, 0.8, 3) * half * 0.4
        self.sphere_c[2] = -half * 0.5
        self.sphere_r = 0.35 * half
        self.box_c = -self.sphere_c * 0.8
        self.box_c[2] = -half * 0.6
        self.box_h = np.array([0.3, 0.25, 0.4]) * half

    def sdf(self, p: torch.Tensor) -> torch.Tensor:
        """Signed distance (negative inside material) at (..., 3) points."""
        def t(a):
            return torch.as_tensor(a, dtype=p.dtype, device=p.device)

        def box(q):
            return (torch.clamp_min(q, 0).norm(dim=-1)
                    + torch.clamp_max(q.amax(-1), 0))

        room = -box(p.abs() - self.half)
        sphere = (p - t(self.sphere_c)).norm(dim=-1) - self.sphere_r
        obj = box((p - t(self.box_c)).abs() - t(self.box_h))
        return torch.minimum(room, torch.minimum(sphere, obj))

    def orbit(self, n: int, radius_frac: float = 0.45) -> np.ndarray:
        """(n, 4, 4) camera-to-world poses of ``SyntheticScene``'s circle
        (camera x right, y down, z forward)."""
        poses = []
        r = self.half * radius_frac
        for i in range(n):
            a = 2 * math.pi * i / max(n, 1)
            eye = np.array([r * math.cos(a), r * math.sin(a),
                            0.25 * self.half * math.sin(2 * a)])
            target = np.array([-r * math.cos(a) * 1.5,
                               -r * math.sin(a) * 1.5, 0.0])
            fwd = target - eye
            fwd = fwd / np.linalg.norm(fwd)
            right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
            right /= np.linalg.norm(right)
            down = np.cross(fwd, right)
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, down, fwd
            c2w[:3, 3] = eye
            poses.append(c2w.astype(np.float32))
        return np.stack(poses)


@torch.no_grad()
def _march(room: Room, poses, intr, h: int, w: int, near: float, far: float,
           n_steps: int) -> torch.Tensor:
    dev = poses.device
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                          torch.arange(w, dtype=torch.float32, device=dev),
                          indexing="ij")
    pix = torch.stack([u, v, torch.ones_like(u)], -1).reshape(-1, 3)
    cam = pix @ torch.linalg.inv(intr.double()).float().T      # z = 1
    dirs = cam @ poses[:, :3, :3].transpose(1, 2)              # (B, n, 3)
    eye = poses[:, None, :3, 3]
    ts = torch.linspace(near, far, n_steps).tolist()
    prev = room.sdf(eye + ts[0] * dirs)
    hit = torch.zeros(prev.shape, dtype=torch.float32, device=dev)
    for t0, t1 in zip(ts[:-1], ts[1:]):
        val = room.sdf(eye + t1 * dirs)
        cross = (prev > 0) & (val <= 0) & (hit == 0)
        frac = prev / torch.where(cross, prev - val, 1.0)
        hit = torch.where(cross, t0 + frac * (t1 - t0), hit)
        prev = val
    return hit.reshape(-1, h, w)


@torch.no_grad()
def render_orbit(room: Room, n_poses: int, h: int, w: int, device,
                 gen: torch.Generator, noise_sigma: float,
                 n_steps: int = 192, batch: int = 64
                 ) -> Dict[str, torch.Tensor]:
    """The orbit's frames as the port's (T, ...) frame dict, starting at a
    pose drawn from ``gen`` (every seed the same frames, in another
    order round the cycle): ToF-like depth
    (``depth``, ``depth_input``: the rendered depth plus noise of sigma
    ``noise_sigma`` x max(depth, 0.5), drawn from ``gen``), a gray image
    from the clean depth, poses, pinhole intrinsics of a 90 degree field
    of view, and the valid-depth mask."""
    f = 0.5 * w
    intr = torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
                        dtype=torch.float32, device=device)
    start = int(torch.randint(n_poses, (1,), generator=gen, device=device))
    poses = torch.as_tensor(np.roll(room.orbit(n_poses), -start, axis=0),
                            device=device)
    far = 4.0 * room.half
    clean = torch.cat([_march(room, poses[i:i + batch], intr, h, w, 0.05,
                              far, n_steps)
                       for i in range(0, n_poses, batch)])
    noise = torch.randn(clean.shape, generator=gen, device=device)
    tof = torch.where(clean > 0, clean + noise * noise_sigma
                      * torch.clamp_min(clean, 0.5), 0.0)
    gray = torch.clamp(1.0 - clean / far, 0, 1) * 255.0
    return {"depth": tof, "depth_input": tof,
            "image": gray[..., None].expand(-1, -1, -1, 3),
            "extrinsics": poses,
            "intrinsics": intr.expand(n_poses, 3, 3),
            "mask": (clean > 0.05) & (clean < far)}
