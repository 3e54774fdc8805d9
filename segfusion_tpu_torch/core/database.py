"""Database: per-scene volume store, post-processing, meshing and metrics.

Port of ``segfusion_tpu/core/database.py``. Each scene's fusion state is a
:class:`SceneVolume` on ``device`` for the whole run, next to its gt TSDF
(a float32 tensor on the same device); gt labels stay on the host. Host
copies happen only at evaluation, meshing and save boundaries, cropped to
the unpadded gt shape first. The median filter of ``filter_semantics`` is
the K5 kernel for a CUDA volume and its plain version for a CPU one
(``ops/kernels/median3d.py``). Metrics, label colours and ply IO are the
port's own copies of the JAX package's host modules (``utils/``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.integrate import pack_semantic_key
from ..ops.kernels.median3d import median_filter3d
from ..utils import hdf5
from ..utils import metrics as metrics_lib
from ..utils.mapping import get_mapping
from ..utils.mesh import marching_cubes
from ..utils.meshio import write_ply
from .volume import SceneVolume, init_scene_volume

__all__ = ["Database"]


class Database:
    """Per scene: gt TSDF (+ gt labels), origin, resolution, unpadded grid
    shape and the current fusion state (on ``device``)."""

    def __init__(self, dataset, config, device="cuda"):
        self.device = device = resolve_device(device)
        self.initial_value = float(config.init_value)
        self.semantics = bool(config.get("semantics"))
        self.semantic_grid = bool(config.get("semantic_grid"))
        self.n_classes = int(config.get("n_classes", 0) or 0)
        self.pad_shape_multiple = int(config.get("pad_shape_multiple", 1)
                                      or 1)

        self.scenes = []
        self.state: Dict[str, bool] = {}
        self.origin: Dict[str, np.ndarray] = {}
        self.resolution: Dict[str, float] = {}
        self.grid_shape: Dict[str, tuple] = {}   # unpadded gt shape
        self.scenes_gt: Dict[str, torch.Tensor] = {}
        self.ids_gt: Dict[str, np.ndarray] = {}
        self.volumes: Dict[str, SceneVolume] = {}

        for s in dataset.scenes:
            try:
                grid = dataset.get_grid(s, self.initial_value,
                                        self.semantic_grid)
            except FileNotFoundError:
                # no gt for this scene (raw scans): an empty grid over the
                # scene's bounding box
                grid = dataset.create_grid(s, self.initial_value)
            gt = grid[0]
            self.scenes.append(s)
            self.origin[s] = np.asarray(gt.origin, np.float32)
            self.resolution[s] = float(gt.resolution)
            self.grid_shape[s] = tuple(gt.volume.shape)
            sx, sy, sz = gt.volume.shape

            shape = self._padded_shape(gt.volume.shape)
            gt_arr = torch.full(shape, self.initial_value,
                                dtype=torch.float32, device=device)
            gt_arr[:sx, :sy, :sz] = torch.as_tensor(
                np.asarray(gt.volume, np.float32), device=device)
            self.scenes_gt[s] = gt_arr

            if self.semantics and self.semantic_grid and grid[1] is not None:
                ids = np.zeros(shape, np.uint8)
                g1 = grid[1].volume
                ids[:g1.shape[0], :g1.shape[1], :g1.shape[2]] = \
                    g1.astype(np.uint8)
                self.ids_gt[s] = ids
        self.reset()

    # -- shape handling ---------------------------------------------------

    def _padded_shape(self, shape):
        """Every axis rounded up to DATA.pad_shape_multiple, then Y to a
        multiple of 8, as the JAX package pads for its slab kernels; kept
        so the slot tensors match the reference's. Metric-neutral: every
        evaluation, mesh and save crops to the gt shape first."""
        m = self.pad_shape_multiple
        x, y, z = (-(-int(d) // m) * m for d in shape)
        return (x, -(-y // 8) * 8, z)

    def _crop(self, arr, scene_id):
        """The unpadded (gt-shaped) part of a volume, as host numpy."""
        sx, sy, sz = self.grid_shape[scene_id]
        if isinstance(arr, torch.Tensor):
            return arr[:sx, :sy, :sz].cpu().numpy()
        return np.asarray(arr)[:sx, :sy, :sz]

    # -- Dataset-style access ---------------------------------------------

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, scene_id: str):
        v = self.volumes[scene_id]
        return {
            "origin": v.origin,
            "resolution": v.resolution,
            "gt": self.scenes_gt[scene_id],
            "current": v.tsdf,
            "weights": v.weights,
            "ids_est": v.semantics if self.semantics else None,
            "scores": v.scores if self.semantics else None,
            "ids_gt": self.ids_gt.get(scene_id) if self.semantics else None,
        }

    def update(self, scene_id: str, volume: SceneVolume):
        """Store the post-integration state."""
        self.volumes[scene_id] = volume
        self.state[scene_id] = True

    def reset(self, scene_id: Optional[str] = None):
        """Fresh (all-zero) estimated volumes."""
        for s in [scene_id] if scene_id else self.scenes:
            self.state[s] = False
            self.volumes[s] = init_scene_volume(
                self._padded_shape(self.grid_shape[s]), self.origin[s],
                self.resolution[s], self.initial_value, device=self.device)

    # -- post-processing ---------------------------------------------------

    def filter(self, value: float = 2.0):
        """Outlier removal: voxels with weight < value return to the
        unobserved state (num and weight 0); semantic keys stay."""
        for s in self.scenes:
            v = self.volumes[s]
            keep = v.weights >= value
            self.volumes[s] = dataclasses.replace(
                v, num=torch.where(keep, v.num, 0.0),
                weights=torch.where(keep, v.weights, 0.0))

    def filter_semantics(self, size: int = 5):
        """size^3 median filter of each label volume, run on the Y-padded
        volume as the JAX package runs it (so edge replication at the far
        Y face sees the pad voxels); scores keep their packed values. A
        CUDA volume goes through the K5 kernel, a CPU one through its plain
        version."""
        for s in self.scenes:
            v = self.volumes[s]
            ids = median_filter3d(v.semantics, size)
            self.volumes[s] = dataclasses.replace(
                v, semkey=pack_semantic_key(v.scores, ids))

    # -- meshing / saving --------------------------------------------------

    def _tsdf_mesh(self, scene_id: str):
        """(verts, faces, normals) of the estimated TSDF's zero level, in
        meters from the origin; empty where it has no zero crossing."""
        return marching_cubes(self._crop(self.volumes[scene_id].tsdf,
                                         scene_id),
                              0.0, spacing=self.resolution[scene_id])

    def _vertex_ids(self, scene_id: str, verts: np.ndarray) -> np.ndarray:
        """The estimated label of the voxel nearest each vertex."""
        ids_vol = self._crop(self.volumes[scene_id].semantics, scene_id)
        vi = np.clip(np.round(verts / self.resolution[scene_id])
                     .astype(np.int64), 0, np.array(ids_vol.shape) - 1)
        return ids_vol[vi[:, 0], vi[:, 1], vi[:, 2]]

    def get_mesh(self, scene_id: str, semantics: bool = False):
        """Marching-cubes mesh of the estimated TSDF, optionally with
        per-vertex semantic colours in [0, 1] (label 0 gray). Raises
        ValueError where the TSDF has no zero crossing."""
        verts, faces, normals = self._tsdf_mesh(scene_id)
        if not len(verts):
            raise ValueError(f"{scene_id}: no isosurface at level 0")
        rgb = None
        if semantics:
            map_rgb = get_mapping().copy()
            map_rgb[0] = [128, 128, 128]
            rgb = map_rgb[self._vertex_ids(scene_id, verts)] / 255.0
        return verts, faces, normals, rgb

    def save_to_workspace(self, workspace, mode, save_mode="ply"):
        """Volumes (hdf5) and meshes (ply) of every updated scene into the
        workspace's output directory; a scene without a surface gets no
        mesh."""
        for s in self.scenes:
            if not self.state[s]:
                continue
            base = s.replace("/", ".")
            if save_mode in ("tsdf", "test"):
                workspace.save_tsdf_data(f"{base}.tsdf_{mode}.hf5",
                                         self._crop(self.volumes[s].tsdf, s))
                workspace.save_weights_data(
                    f"{base}.weights_{mode}.hf5",
                    self._crop(self.volumes[s].weights, s))
                if self.semantics:
                    workspace.save_semantic_data(
                        f"{base}.semantic_{mode}.hf5",
                        self._crop(self.volumes[s].semantics, s))
            if save_mode in ("ply", "test"):
                verts, faces, normals = self._tsdf_mesh(s)
                if len(verts):
                    workspace.save_ply_mesh(f"{base}_{mode}.ply", verts,
                                            faces, normals)

    def save(self, path: str, save_mode: str = "ply",
             scene_id: Optional[str] = None):
        """hdf5 volumes ("tsdf", "test") and ply meshes ("ply", "test"; in
        "test" mode with semantics also a semantic-coloured ply with the
        ids in the alpha channel) of one scene into ``path``."""
        if scene_id is None:
            raise NotImplementedError("save needs a scene_id")
        base = scene_id.replace("/", ".")
        os.makedirs(path, exist_ok=True)

        if save_mode in ("tsdf", "test"):
            vol = self.volumes[scene_id]
            planes = [("tsdf", "TSDF", vol.tsdf),
                      ("weights", "weights", vol.weights)]
            if self.semantics:
                planes.append(("semantics", "semantics", vol.semantics))
            for name, key, data in planes:
                arr = self._crop(data, scene_id)
                with hdf5.File(os.path.join(path, f"{base}.{name}.hf5"),
                               "w") as hf:
                    hf.create_dataset(key, shape=arr.shape, data=arr)

        if save_mode in ("ply", "test"):
            semantic = self.semantics and save_mode == "test"
            verts, faces, normals, rgb = self.get_mesh(scene_id,
                                                       semantics=semantic)
            write_ply(os.path.join(path, f"{base}.ply"), verts, faces,
                      normals=normals)
            if semantic:
                rgba = np.concatenate(
                    [np.asarray(rgb * 255, np.uint8),
                     self._vertex_ids(scene_id, verts)[:, None]
                     .astype(np.uint8)], axis=1)
                write_ply(os.path.join(path, f"{base}_semantic.ply"), verts,
                          faces, normals=normals, colors=rgba)

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, mode="train", workspace=None):
        """Geometry metrics over observed voxels, averaged over scenes; in
        "test" mode also the per-scene results."""
        eval_results: Dict[str, float] = {}
        per_scene = {}
        for s in self.scenes:
            if not self.state[s]:
                continue
            est = self._crop(self.volumes[s].tsdf, s)
            gt = self._crop(self.scenes_gt[s], s)
            mask = self._crop(self.volumes[s].weights, s) > 0
            r = metrics_lib.evaluation(est, gt, mask)
            per_scene[s] = r
            for k, v in r.items():
                eval_results[k] = eval_results.get(k, 0.0) + v
            if workspace is not None:
                workspace.log(f"Evaluated {s}: {r}", mode)
        for k in eval_results:
            eval_results[k] /= max(len(self.scenes), 1)
        if mode == "test":
            return eval_results, per_scene
        return eval_results

    def evaluate_fscore(self, threshold: float = 0.05, mode="test",
                        workspace=None):
        """Mesh F-score: the estimated and gt TSDFs' zero-level meshes
        compared at ``threshold`` meters, averaged over the scenes where
        both have a surface; also the per-scene results."""
        results = {}
        agg = {"fscore": 0.0, "precision": 0.0, "recall": 0.0}
        n = 0
        for s in self.scenes:
            if not self.state[s]:
                continue
            voxel = self.resolution[s]
            ev = self._tsdf_mesh(s)[0]
            gv = marching_cubes(self._crop(self.scenes_gt[s], s), 0.0,
                                spacing=voxel)[0]
            if not (len(ev) and len(gv)):
                continue
            r = metrics_lib.fscore(ev, gv, threshold=threshold)
            results[s] = r
            for k in agg:
                agg[k] += r[k]
            n += 1
            if workspace is not None:
                workspace.log(f"F-score {s}: {r}", mode)
        if n:
            for k in agg:
                agg[k] /= n
        return agg, results

    def evaluate_semantics(self, mode="train", workspace=None):
        """Semantic metrics over observed voxels against the gt labels,
        averaged over scenes; also the per-scene class IoUs."""
        eval_results: Dict[str, float] = {}
        per_scene = {}
        for s in self.scenes:
            if not self.state[s] or s not in self.ids_gt:
                continue
            est = self._crop(self.volumes[s].semantics, s)
            gt = self._crop(self.ids_gt[s], s)
            mask = self._crop(self.volumes[s].weights, s) > 0
            r, cls_iou = metrics_lib.semantic_evaluation(est, gt, mask,
                                                         self.n_classes)
            per_scene[s] = cls_iou
            for k, v in r.items():
                eval_results[k] = eval_results.get(k, 0.0) + v
            if workspace is not None:
                workspace.log(f"Evaluated semantics {s}: {r}", mode)
        for k in eval_results:
            eval_results[k] /= max(len(self.scenes), 1)
        return eval_results, per_scene
