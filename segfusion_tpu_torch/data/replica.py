"""Replica dataset loader.

Port of ``segfusion_tpu/data/replica.py``: per-frame dicts with the RGB
image (``left_rgb``), the noisy ToF depth (``left_depth_noise_5.0``) or the
gt depth, camera matrices re-rotated into the z-forward/y-down/x-right
convention, fixed hfov-90 intrinsics and 30-class semantic gt, and the gt
TSDF grid from ``gt_semantic_sdf/{semantic_,}sdf.hdf`` with truncation and
padding. Frames are decoded and resized with OpenCV on the host and stay
numpy arrays; the device is the caller's to choose.

Two frame orderings: ``hybrid`` interleaves at most
``load_scenes_at_once`` trajectories; ``max_depth_diversity`` is the flat
list sorted by frame index.
"""

from __future__ import annotations

import glob
import os
from typing import List

import numpy as np

from ..core.volume import Voxelgrid
from ..utils import hdf5
from ..utils.mapping import replica_color_palette

__all__ = ["Replica", "raw_camera_matrix"]

# image normalisation constants
_MEAN = np.array([179.66761167, 179.55742948, 188.2114891])
_STD = np.array([12.46442902, 12.55030275, 13.12021586])

_ROT_180_Y = np.array([[-1, 0, 0], [0, 1, 0], [0, 0, -1]], np.float32)
_ROT_180_Z = np.array([[-1, 0, 0], [0, -1, 0], [0, 0, 1]], np.float32)
_ROT_90_X = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)


def _fix_extrinsics(raw: np.ndarray) -> np.ndarray:
    """Re-rotate a raw Replica camera matrix to a z-forward/y-down/x-right
    camera-to-world matrix."""
    ext = np.linalg.inv(raw).astype(np.float32)
    rot = _ROT_180_Z @ _ROT_180_Y
    ext = rot @ ext[0:3, 0:4]
    ext = np.linalg.inv(np.concatenate([ext, [[0, 0, 0, 1]]], axis=0))
    ext34 = _ROT_90_X @ ext[0:3, 0:4]
    return np.concatenate([ext34, [[0, 0, 0, 1]]], axis=0).astype(np.float32)


def raw_camera_matrix(pose: np.ndarray) -> np.ndarray:
    """The raw Replica camera matrix (``left_camera_matrix/<frame>.txt``)
    that the loader turns into the camera-to-world ``pose``: the inverse
    of :func:`_fix_extrinsics`, ``R90x^T @ pose @ blockdiag(R180z R180y,
    1)``, in float64."""
    rot = np.eye(4)
    rot[:3, :3] = _ROT_180_Z @ _ROT_180_Y
    r90 = np.eye(4)
    r90[:3, :3] = _ROT_90_X
    return r90.T @ np.asarray(pose, np.float64) @ rot


class Replica:
    """Frame-dict dataset over a Replica tree (``DATA.root_dir``) and a
    scene list in ``lists/replica``'s line format. ``device`` is
    ``get_data``'s; the frames stay host arrays."""

    def __init__(self, config_data, device="cuda"):
        import cv2
        self._cv2 = cv2
        self.root_dir = config_data.root_dir
        self.resolution = (int(config_data.resy), int(config_data.resx))
        self.pad = int(config_data.pad)
        self.normalize = bool(config_data.get("normalize", True))
        self.frame_ratio = int(config_data.get("frame_ratio", 1) or 1)
        self.scene_list = config_data.scene_list
        self.input = config_data.input
        self.target = config_data.target
        self.semantics = config_data.get("semantics")
        self.truncation_strategy = config_data.get("truncation_strategy",
                                                   "standard")
        self.load_strategy = config_data.get("data_load_strategy",
                                             "max_depth_diversity")
        self.load_scenes_at_once = int(config_data.get(
            "load_scenes_at_once", 1) or 1)
        self._scenes: List[str] = []

        modality = {"tof_depth": "left_depth_noise_5.0",
                    "depth_gt": "left_depth_gt"}
        self.depth_dir = modality.get(self.input, "left_depth_gt")

        self._index = self._build_index()
        if self.semantics == "class30":
            self.rgb_map = replica_color_palette()

    # -- frame indexing -----------------------------------------------------

    def _trajectories(self) -> List[str]:
        """scene/trajectory relative dirs from the scene list file."""
        trajs = []
        with open(self.scene_list) as f:
            for line in f:
                entry = line.strip().split(" ")[0]
                if not entry:
                    continue
                traj = "/".join(entry.split("/")[:2])
                if traj not in trajs:
                    trajs.append(traj)
                scene = entry.split("/")[0]
                if scene not in self._scenes:
                    self._scenes.append(scene)
        return trajs

    def _frames_of(self, traj: str) -> List[str]:
        files = glob.glob(os.path.join(self.root_dir, traj, "left_rgb", "*"))
        frames = sorted(
            (os.path.splitext(os.path.basename(p))[0] for p in files),
            key=lambda s: int(s))
        return [f"{traj}/{f}" for f in frames]

    def _build_index(self) -> List[str]:
        trajs = self._trajectories()
        per_traj = {t: self._frames_of(t)[:: self.frame_ratio]
                    for t in trajs}
        if self.load_strategy == "hybrid":
            # interleave the trajectories in groups of load_scenes_at_once
            order: List[str] = []
            pending = list(trajs)
            while pending:
                group = pending[: self.load_scenes_at_once]
                pending = pending[self.load_scenes_at_once:]
                live = [iter(per_traj[t]) for t in group]
                while live:
                    for it in list(live):
                        try:
                            order.append(next(it))
                        except StopIteration:
                            live.remove(it)
            return order
        # max_depth_diversity: flat, sorted by frame index
        flat = [f for t in trajs for f in per_traj[t]]
        flat.sort(key=lambda s: int(s.rsplit("/", 1)[1]))
        return flat

    @property
    def scenes(self):
        return self._scenes

    def __len__(self):
        return len(self._index)

    # -- frame loading --------------------------------------------------------

    def _imread(self, path, flags=None):
        cv2 = self._cv2
        img = cv2.imread(path) if flags is None else cv2.imread(path, flags)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.resize(img, (self.resolution[1], self.resolution[0]),
                          interpolation=cv2.INTER_NEAREST)

    def _labels(self, path) -> np.ndarray:
        """A label PNG; of a 3-channel one, channel 0 of OpenCV's BGR
        order (the blue channel)."""
        sem = self._imread(path, -1)
        return sem[:, :, 0] if sem.ndim == 3 else sem

    def __getitem__(self, item: int) -> dict:
        frame_id = self._index[item]
        traj, frame = frame_id.rsplit("/", 1)
        base = os.path.join(self.root_dir, traj)

        sample = {"item_id": item, "frame_id": frame_id}

        image = self._imread(os.path.join(base, "left_rgb",
                                          frame + ".png"))[..., ::-1]  # RGB
        image = image.astype(np.float32)
        if self.normalize:
            image = (image - _MEAN[::-1]) / _STD[::-1]
        sample["image"] = image.astype(np.float32)          # (h, w, 3)

        if self.semantics:
            sem = self._labels(os.path.join(
                base, f"left_{self.semantics}", frame + ".png"))
            sample["semantic_gt"] = sem.astype(np.uint8)

        depth = self._imread(os.path.join(base, self.depth_dir,
                                          frame + ".png"), -1)
        depth = depth.astype(np.float32) / 1000.0
        sample[self.input] = depth
        sample["mask"] = (depth > 0.05) & (depth < 5.0)

        if self.target == "depth_gt" and self.input != "depth_gt":
            dgt = self._imread(os.path.join(base, "left_depth_gt",
                                            frame + ".png"), -1)
            sample["depth_gt"] = dgt.astype(np.float32) / 1000.0

        raw = np.loadtxt(os.path.join(base, "left_camera_matrix",
                                      frame + ".txt"))
        sample["extrinsics"] = _fix_extrinsics(raw)

        hfov = 90.0
        f = self.resolution[0] / 2.0 / np.tan(np.deg2rad(hfov) / 2)
        shift = self.resolution[0] / 2.0
        sample["intrinsics"] = np.array([[f, 0, shift], [0, f, shift],
                                         [0, 0, 1]], np.float32)
        return sample

    # -- visualisation frames -------------------------------------------------

    def get_input_frame(self, frame_id: str) -> np.ndarray:
        traj, frame = frame_id.rsplit("/", 1)
        img = self._imread(os.path.join(self.root_dir, traj, "left_rgb",
                                        frame + ".png"))
        return img[..., ::-1].astype(np.uint8)  # RGB

    def get_depth_frame(self, frame_id: str) -> np.ndarray:
        traj, frame = frame_id.rsplit("/", 1)
        d = self._imread(os.path.join(self.root_dir, traj, "left_depth_gt",
                                      frame + ".png"), -1).astype(np.float32)
        d = d / max(float(d.max()), 1e-6) * 255.0
        return np.repeat(d[..., None], 3, axis=-1).astype(np.uint8)

    def get_semantic_frame(self, frame_id: str) -> np.ndarray:
        traj, frame = frame_id.rsplit("/", 1)
        sem = self._labels(os.path.join(
            self.root_dir, traj, f"left_{self.semantics}", frame + ".png"))
        return self.rgb_map[sem.astype(np.int64)].astype(np.uint8)

    # -- grids ----------------------------------------------------------------

    def get_grid(self, scene: str, truncation: float,
                 semantic_grid: bool = False):
        """(gt TSDF grid, gt label grid or None) from the preprocessed hdf:
        truncated, then padded by DATA.pad voxels. Raises
        FileNotFoundError where the scene has no hdf, before anything is
        opened."""
        name = "semantic_sdf.hdf" if self.semantics else "sdf.hdf"
        path = os.path.join(self.root_dir, scene, "gt_semantic_sdf", name)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        with hdf5.File(path, "r") as f:
            sdf = f["sdf"]
            voxel_size = float(f.attrs["voxel_size"])
            bbox0 = np.asarray(f.attrs["bbox"])[:, 0]
        voxels = sdf[0].astype(np.float32)
        if self.truncation_strategy == "artificial":
            voxels[np.abs(voxels) >= truncation] = truncation
        elif self.truncation_strategy == "standard":
            voxels = np.clip(voxels, -truncation, truncation)
        labels = None
        if self.semantics:
            labels = sdf[1].astype(np.uint8)
            labels[np.abs(sdf[0]) > truncation] = 0

        voxels = np.pad(voxels, self.pad, "constant",
                        constant_values=-truncation)
        bbox = np.zeros((3, 2))
        bbox[:, 0] = bbox0 - self.pad * voxel_size
        bbox[:, 1] = bbox[:, 0] + voxel_size * np.array(voxels.shape)
        grid = Voxelgrid(voxel_size).from_array(voxels, bbox)
        if self.semantics and semantic_grid:
            labels = np.pad(labels, self.pad, "constant", constant_values=0)
            lgrid = Voxelgrid(voxel_size).from_array(labels, bbox)
            return (grid, lgrid)
        return (grid, None)

    def create_grid(self, scene: str, truncation: float):
        raise FileNotFoundError(
            f"no gt sdf for Replica scene {scene}; run the preprocessing "
            "tools (segfusion_tpu_torch.preprocess) first")
