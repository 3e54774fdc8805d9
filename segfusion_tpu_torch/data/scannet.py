"""ScanNet dataset loader.

Port of ``segfusion_tpu/data/scannet.py``: the color / depth / label-filt
/ pose directories of a scan, the per-scene ``intrinsic_depth.txt``
rescaled from 640x480 to the working resolution, raw label ids mapped to
NYU-40 through the official tsv, the gt grid from ``<scene>_sdf.hdf`` or
an empty grid over the ``_vh_clean_2.ply`` bbox at 1 cm voxels, and
benchmark-format 2D prediction output. Frames are decoded and resized
with OpenCV on the host and stay numpy arrays.
"""

from __future__ import annotations

import glob
import math
import os
from typing import List

import numpy as np

from ..core.volume import Voxelgrid
from ..utils import hdf5
from ..utils.mapping import scannet_to_nyu40_map
from ..utils.meshio import read_ply

__all__ = ["ScanNet"]

# image normalisation constants
_MEAN = np.array([99.09, 113.94, 126.81])
_STD = np.array([69.64, 71.31, 73.16])


class ScanNet:
    """Frame-dict dataset over ScanNet scans (``DATA.root_dir``) and a
    scene list of ``scans/<scene>`` lines. ``device`` is ``get_data``'s;
    the frames stay host arrays."""

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
        tsv = config_data.get("label_mapping_tsv") or os.path.join(
            str(self.root_dir or "."), "scannetv2-labels.combined.tsv")
        self.label_map = scannet_to_nyu40_map(tsv)

        self.load_strategy = config_data.get("data_load_strategy", "hybrid")
        self._scenes: List[str] = []
        self._scene_dirs = {}
        self._index: List[str] = []
        self.intrinsics = {}
        self._build_index()
        if self.load_strategy == "max_depth_diversity":
            # all scenes interleaved by frame index; 'hybrid' keeps each
            # scene's frames together
            self._index.sort(key=lambda fid: int(fid.rsplit("/", 1)[1]))

    def _build_index(self):
        with open(self.scene_list) as f:
            for line in f:
                entry = line.strip().split(" ")
                if not entry or not entry[0]:
                    continue
                rel = entry[0]
                scene = rel.split("/")[1] if "/" in rel else rel
                if scene in self._scenes:
                    continue
                self._scenes.append(scene)
                sdir = os.path.join(self.root_dir, rel) \
                    if self.root_dir else rel
                self._scene_dirs[scene] = sdir
                frames = sorted(
                    (os.path.splitext(os.path.basename(p))[0]
                     for p in glob.glob(os.path.join(sdir, "depth", "*"))),
                    key=lambda s: int(s))
                for fr in frames[:: self.frame_ratio]:
                    self._index.append(f"{scene}/{fr}")
                # the depth intrinsics of 640x480, rescaled
                k = np.loadtxt(os.path.join(sdir, "intrinsic",
                                            "intrinsic_depth.txt"))
                kx = self.resolution[1] / 640.0
                ky = self.resolution[0] / 480.0
                scale = np.array([[kx, 0, 0], [0, ky, 0], [0, 0, 1]],
                                 np.float32)
                self.intrinsics[scene] = (scale @ k[0:3, 0:3]).astype(
                    np.float32)

    @property
    def scenes(self):
        return self._scenes

    def __len__(self):
        return len(self._index)

    def _imread(self, path, flags=None):
        cv2 = self._cv2
        img = cv2.imread(path) if flags is None else cv2.imread(path, flags)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.resize(img, (self.resolution[1], self.resolution[0]),
                          interpolation=cv2.INTER_NEAREST)

    def __getitem__(self, item: int) -> dict:
        frame_id = self._index[item]
        scene, frame = frame_id.split("/")
        sdir = self._scene_dirs[scene]
        sample = {"item_id": item, "frame_id": frame_id}

        image = self._imread(os.path.join(sdir, "color",
                                          frame + ".jpg"))[..., ::-1]
        image = image.astype(np.float32)
        if self.normalize:
            image = (image - _MEAN[::-1]) / _STD[::-1]
        sample["image"] = image.astype(np.float32)

        if self.semantics:
            sem = self._imread(os.path.join(sdir, "label-filt",
                                            frame + ".png"), -1)
            sem = self.label_map[np.clip(sem, 0, len(self.label_map) - 1)]
            sample["semantic_gt"] = sem.astype(np.uint8)

        depth = self._imread(os.path.join(sdir, "depth", frame + ".png"), -1)
        depth = depth.astype(np.float32) / 1000.0
        sample[self.input] = depth
        sample["mask"] = depth > 0.01
        if self.target == "depth_gt" and self.input != "depth_gt":
            sample["depth_gt"] = depth

        sample["extrinsics"] = np.loadtxt(
            os.path.join(sdir, "pose", frame + ".txt")).astype(np.float32)
        sample["intrinsics"] = self.intrinsics[scene]
        return sample

    def _scan_file(self, scene: str, suffix: str) -> str:
        """``scans/<scene>/<scene><suffix>``, else the same under
        ``scans_test``."""
        file = os.path.join(self.root_dir, "scans", scene, scene + suffix)
        if not os.path.exists(file):
            file = file.replace("scans", "scans_test")
        return file

    def get_grid(self, scene: str, truncation: float,
                 semantic_grid: bool = False):
        """(gt TSDF grid, gt label grid or None) from ``<scene>_sdf.hdf``:
        truncated, then padded by DATA.pad voxels. Raises
        FileNotFoundError where the scan has no hdf, before anything is
        opened."""
        file = self._scan_file(scene, "_sdf.hdf")
        if not os.path.exists(file):
            raise FileNotFoundError(file)
        with hdf5.File(file, "r") as f:
            sdf = f["sdf"]
            voxel_size = float(f.attrs["voxel_size"])
            bbox0 = np.asarray(f.attrs["bbox"])[:, 0]
        voxels = sdf[0].astype(np.float32)
        if self.truncation_strategy == "artificial":
            voxels[np.abs(voxels) >= truncation] = truncation
        elif self.truncation_strategy == "standard":
            voxels = np.clip(voxels, -truncation, truncation)
        labels = None
        if semantic_grid:
            labels = sdf[1].astype(np.uint8)
            labels[np.abs(sdf[0]) > truncation] = 0
        voxels = np.pad(voxels, self.pad, "constant",
                        constant_values=-truncation)
        bbox = np.zeros((3, 2))
        bbox[:, 0] = bbox0 - self.pad * voxel_size
        bbox[:, 1] = bbox[:, 0] + voxel_size * np.array(voxels.shape)
        grid = Voxelgrid(voxel_size).from_array(voxels, bbox)
        if semantic_grid:
            labels = np.pad(labels, self.pad, "constant", constant_values=0)
            lgrid = Voxelgrid(voxel_size).from_array(labels, bbox)
            return (grid, lgrid)
        return (grid, None)

    def create_grid(self, scene: str, truncation: float):
        """An empty grid (every voxel ``truncation``) over the clean
        mesh's bbox at 1 cm voxels, padded by DATA.pad voxels."""
        points, _ = read_ply(self._scan_file(scene, "_vh_clean_2.ply"))
        voxel_size = 0.01
        bbox = np.zeros((3, 2))
        bbox[:, 0] = points.min(axis=0)
        bbox[:, 1] = points.max(axis=0)
        dims = [math.ceil((bbox[i, 1] - bbox[i, 0]) / voxel_size) + 1
                for i in range(3)]
        voxels = truncation * np.ones(dims, np.float32)
        voxels = np.pad(voxels, self.pad, "constant",
                        constant_values=truncation)
        bbox[:, 0] -= self.pad * voxel_size
        bbox[:, 1] = bbox[:, 0] + voxel_size * np.array(voxels.shape)
        return (Voxelgrid(voxel_size).from_array(voxels, bbox), None)

    def output_test(self, out_dir: str, frame_id: str, pred: np.ndarray):
        """Write one frame's 2D prediction as the ScanNet benchmark's
        ``<scene>_<frame>.png`` (8-bit gray)."""
        os.makedirs(out_dir, exist_ok=True)
        scene, frame = frame_id.split("/")
        self._cv2.imwrite(os.path.join(out_dir, f"{scene}_{frame}.png"),
                          pred.astype(np.uint8))
