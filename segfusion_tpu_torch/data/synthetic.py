"""Synthetic scenes: analytic SDFs + rendered depth trajectories.

Port of ``segfusion_tpu/data/synthetic.py`` (numpy scene definition, depth
rendered with the port's ``render_depth`` on a chosen device). A box room
with a sphere and a box; labels 0 free space, 1 walls, 2 sphere, 3 box.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from ..core.volume import Voxelgrid
from ..device import resolve_device
from ..ops.geometry import unproject
from ..ops.raycast import render_depth

__all__ = ["SyntheticScene", "Synthetic"]


def _room_sdf(pts: np.ndarray, half: float = 2.0) -> np.ndarray:
    """SDF of a closed box room (negative = inside wall material)."""
    q = np.abs(pts) - half
    outside_box = np.linalg.norm(np.maximum(q, 0), axis=-1) \
        + np.minimum(np.max(q, axis=-1), 0)
    return -outside_box


def _sphere_sdf(pts, center, r):
    return np.linalg.norm(pts - np.asarray(center), axis=-1) - r


def _box_sdf(pts, center, half):
    q = np.abs(pts - np.asarray(center)) - np.asarray(half)
    return np.linalg.norm(np.maximum(q, 0), axis=-1) \
        + np.minimum(np.max(q, axis=-1), 0)


class SyntheticScene:
    """One synthetic room with analytic SDF and semantic labels."""

    def __init__(self, seed: int = 0, half: float = 2.0):
        rng = np.random.RandomState(seed)
        self.half = half
        self.sphere_c = rng.uniform(-0.8, 0.8, 3) * half * 0.4
        self.sphere_c[2] = -half * 0.5
        self.sphere_r = 0.35 * half
        self.box_c = -self.sphere_c * 0.8
        self.box_c[2] = -half * 0.6
        self.box_h = np.array([0.3, 0.25, 0.4]) * half

    def _parts(self, pts):
        return (_room_sdf(pts, self.half),
                _sphere_sdf(pts, self.sphere_c, self.sphere_r),
                _box_sdf(pts, self.box_c, self.box_h))

    def sdf(self, pts: np.ndarray) -> np.ndarray:
        """The room's SDF at ``pts`` (the nearest part's)."""
        return self.sdf_and_labels(pts)[0]

    def labels(self, pts: np.ndarray) -> np.ndarray:
        """The nearest part's label inside the material, 0 in free
        space."""
        return self.sdf_and_labels(pts)[1]

    def surface_labels(self, pts: np.ndarray) -> np.ndarray:
        """Nearest-part label regardless of sign."""
        stack = np.stack(self._parts(pts), axis=-1)
        return (np.argmin(stack, axis=-1) + 1).astype(np.uint8)

    def sdf_and_labels(self, pts: np.ndarray):
        """The SDF (the nearest part's) and the labels (the nearest part's
        inside the material, 0 in free space) at ``pts``."""
        stack = np.stack(self._parts(pts), axis=-1)
        sdf = stack.min(axis=-1)
        lab = np.where(sdf > 0, 0, np.argmin(stack, axis=-1) + 1)
        return sdf, lab.astype(np.uint8)

    def grid(self, resolution: float, truncation: float, pad: int = 2):
        """Ground-truth TSDF (+ labels) sampled on a padded voxel grid."""
        lo = -self.half - pad * resolution
        hi = self.half + pad * resolution
        n = int(round((hi - lo) / resolution))
        ax = lo + np.arange(n) * resolution
        x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
        sdf, labels = self.sdf_and_labels(np.stack([x, y, z], axis=-1))
        sdf = np.clip(sdf, -truncation, truncation)
        bbox = np.array([[lo, hi], [lo, hi], [lo, hi]])
        g = Voxelgrid(resolution).from_array(sdf.astype(np.float32), bbox)
        gl = Voxelgrid(resolution).from_array(labels, bbox)
        return g, gl

    def camera_poses(self, n_frames: int, radius_frac: float = 0.45
                     ) -> np.ndarray:
        """Circular trajectory looking across the room centre; (n, 4, 4)
        camera-to-world matrices (camera x right, y down, z forward)."""
        poses = []
        r = self.half * radius_frac
        for i in range(n_frames):
            a = 2 * math.pi * i / max(n_frames, 1)
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
            c2w[:3, 0] = right
            c2w[:3, 1] = down
            c2w[:3, 2] = fwd
            c2w[:3, 3] = eye
            poses.append(c2w.astype(np.float32))
        return np.stack(poses)


class Synthetic:
    """Frame-dict dataset over synthetic scenes (reference dataset
    contract: frames with image / tof_depth / depth_gt / extrinsics /
    intrinsics / mask / semantic_gt / frame_id; ``scenes``; ``get_grid``).
    Depth is rendered on ``device``; frames are returned as numpy."""

    def __init__(self, config, device="cuda"):
        self.device = resolve_device(device)
        self.resx = int(config.resx)
        self.resy = int(config.resy)
        self.n_frames = int(config.get("n_frames", 20))
        self.noise_sigma = float(config.get("noise_sigma", 0.01))
        self.resolution = float(config.get("voxel_resolution", 0.05))
        self.pad = int(config.get("pad", 2))
        self.seed = int(config.get("seed", 0))
        n_scenes = int(config.get("n_scenes", 1))
        self.scenes: List[str] = [f"synthetic_scene_{i}"
                                  for i in range(n_scenes)]
        self._scene_objs = {s: SyntheticScene(seed=self.seed + i)
                            for i, s in enumerate(self.scenes)}
        self._frames: Dict[str, dict] = {}
        f = 0.5 * self.resx / math.tan(math.radians(90.0) / 2)  # hfov 90
        self.intrinsics = np.array([[f, 0, self.resx / 2.0],
                                    [0, f, self.resy / 2.0],
                                    [0, 0, 1]], np.float32)

    def __len__(self):
        return len(self.scenes) * self.n_frames

    def _render_scene(self, scene_id: str) -> dict:
        if scene_id not in self._frames:
            scene = self._scene_objs[scene_id]
            fine, _ = scene.grid(self.resolution * 0.5, 10.0, pad=2)
            poses = scene.camera_poses(self.n_frames)
            dev = self.device
            depths = render_depth(
                torch.as_tensor(fine.volume, device=dev),
                torch.as_tensor(poses, device=dev),
                torch.as_tensor(self.intrinsics, device=dev),
                torch.as_tensor(fine.origin, device=dev), fine.resolution,
                self.resy, self.resx, near=0.05, far=4.0 * scene.half,
                n_steps=512)
            self._frames[scene_id] = {"poses": poses,
                                      "depths": depths.cpu().numpy()}
        return self._frames[scene_id]

    def __getitem__(self, idx: int) -> dict:
        scene_id = self.scenes[idx // self.n_frames]
        fid = idx % self.n_frames
        data = self._render_scene(scene_id)
        scene = self._scene_objs[scene_id]
        depth_gt = data["depths"][fid]
        rng = np.random.RandomState(self.seed * 7919 + idx)
        noise = rng.randn(*depth_gt.shape).astype(np.float32) \
            * self.noise_sigma * np.maximum(depth_gt, 0.5)
        tof = np.where(depth_gt > 0, depth_gt + noise, 0.0).astype(np.float32)
        mask = (depth_gt > 0.05) & (depth_gt < 4.0 * scene.half)

        pose = data["poses"][fid]
        pts = unproject(torch.as_tensor(depth_gt), torch.as_tensor(pose),
                        torch.as_tensor(self.intrinsics)).numpy()
        sem = scene.surface_labels(pts).reshape(depth_gt.shape)
        sem = np.where(mask, sem, 0).astype(np.uint8)

        gray = np.clip(1.0 - depth_gt / (4.0 * scene.half), 0, 1)
        image = (np.stack([gray] * 3, axis=-1) * 255).astype(np.float32)
        return {
            "image": image,
            "tof_depth": tof,
            "depth_gt": depth_gt.astype(np.float32),
            "mask": mask,
            "semantic_gt": sem,
            "extrinsics": pose.astype(np.float32),
            "intrinsics": self.intrinsics,
            "frame_id": f"{scene_id}/{fid}",
        }

    def get_grid(self, scene_id: str, initial_value: float,
                 semantic_grid: bool = False):
        g, gl = self._scene_objs[scene_id].grid(self.resolution,
                                                initial_value, self.pad)
        return (g, gl if semantic_grid else None)

    def create_grid(self, scene_id: str, initial_value: float):
        return self.get_grid(scene_id, initial_value, False)
