"""Spatially sharded fusion: one scene's voxel grid split along x.

Port of ``segfusion_tpu/parallel/spatial.py``. The JAX package places the
volume with an x-sharded NamedSharding and lets XLA's SPMD partitioner
split the gathers and scatters. PyTorch has no partitioner, so the row
step is partitioned by hand here, over the x-slabs of a device list:

* each device holds the slot state (geo and key rows) of its x-slab, a
  standalone sub-volume of X / n x-planes (``shard_kernels``), and builds
  and reconciles its shadows there;
* the ray geometry and the nets run once per frame (or block) on the
  pipeline's device, as the JAX package replicates them;
* each slab gathers the shadow words of the trilinear corners whose x it
  holds (the others read 0); the words meet on the pipeline's device,
  where exactly one slab gave each, and the trilinear sums run there;
* each update goes back to the slab that owns its target row.

The flat scalar path (``SETTINGS.integration: scalar``) is split the same
way: each slab gathers the words (packed bf16, or the f32 bits of num and
w) of the corners in its voxels, the sums run on the pipeline's device,
and each scatter-add and key scatter-max goes to the slab that owns its
voxel, in place.

Every scatter keeps the unsharded order of its updates, so on the CPU a
sharded step equals the unsharded one bit for bit. A single-device mesh
is the ordinary step. Unlike the JAX constructor,
which refuses its Pallas rows over more than one device (pallas_call does
not partition under SPMD), this port calls its kernels per slab and takes
any mesh whose size divides the x extent.

A sharded volume is the list of its x-slabs, ``SceneVolume``s of
(X / n, Y, Z) tensors, slab i on mesh device i, each with the scene's
origin and resolution.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..core.pipeline import RowStream, _prepare_fusion_input
from ..core.volume import SceneVolume
from ..ops import geometry, rowvol
from ..ops import integrate as integ
from . import shard_kernels as sk
from .mesh import Mesh, scene_mesh

__all__ = ["shard_volume_spatial", "unshard_volume_spatial",
           "SpatialShardedFusion"]


def shard_volume_spatial(volume: SceneVolume, mesh: Mesh
                         ) -> List[SceneVolume]:
    """The x-slabs of ``volume``, slab i on mesh device i (origin and
    resolution on every slab). The x extent must be divisible by the mesh
    size."""
    n = mesh.size
    xs = volume.num.shape[0]
    if xs % n != 0:
        raise ValueError(f"volume x extent {xs} not divisible by mesh "
                         f"size {n} (pad with DATA.pad_shape_multiple)")
    m = xs // n
    return [SceneVolume(num=volume.num[i * m:(i + 1) * m].to(d),
                        weights=volume.weights[i * m:(i + 1) * m].to(d),
                        semkey=volume.semkey[i * m:(i + 1) * m].to(d),
                        origin=volume.origin.to(d),
                        resolution=volume.resolution.to(d),
                        init_value=volume.init_value)
            for i, d in enumerate(mesh.devices)]


def unshard_volume_spatial(slabs: List[SceneVolume],
                           device=None) -> SceneVolume:
    """The whole volume of its x-slabs, on ``device`` (default: slab 0's)."""
    device = device if device is not None else slabs[0].num.device

    def cat(name):
        return torch.cat([getattr(s, name).to(device) for s in slabs])

    return SceneVolume(num=cat("num"), weights=cat("weights"),
                       semkey=cat("semkey"),
                       origin=slabs[0].origin.to(device),
                       resolution=slabs[0].resolution.to(device),
                       init_value=slabs[0].init_value)


class SpatialShardedFusion:
    """Run Pipeline fusion steps over an x-sharded volume.

    Frames go to the pipeline's device (they are small); the volume stays
    sharded across steps. Use for single huge scenes; for many normal
    scenes prefer ``scene_parallel`` (no traffic between devices)."""

    def __init__(self, pipeline, mesh: Optional[Mesh] = None):
        self.pipeline = pipeline
        self.mesh = mesh if mesh is not None else scene_mesh("x")

    def shard(self, volume: SceneVolume) -> List[SceneVolume]:
        return shard_volume_spatial(volume, self.mesh)

    def _frames(self, frames) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(x).to(self.pipeline.device)
                for k, x in frames.items()}

    def step(self, volume: List[SceneVolume], frame) -> List[SceneVolume]:
        """One frame (host or device arrays without a time axis)."""
        frame = {k: x[None] for k, x in self._frames(frame).items()}
        if self.mesh.size == 1:
            return [self.pipeline.step_fuse_impl(
                volume[0], self.pipeline._sem_prepass_frames(frame))]
        if not self.pipeline.row_path:
            return self._step_flat(volume, frame)
        layout = self._layout(volume)
        rv = self._enter(layout, volume)
        rv, _ = self._step_block(layout, rv,
                                 self.pipeline._sem_prepass_frames(frame))
        return self._exit(layout, rv, volume)

    def fuse_sequence(self, volume: List[SceneVolume], frames
                      ) -> List[SceneVolume]:
        """Fuse a whole (T, ...) frame stream over the x-sharded volume:
        the row path's block loop with the dirty-shadow carry, each slab's
        shadow built and reconciled on its device (``shard_kernels``)."""
        frames = self._frames(frames)
        pipe = self.pipeline
        if self.mesh.size == 1:
            return [pipe.fuse_sequence(volume[0], frames)]
        if not pipe.row_path:
            frames = pipe._sem_prepass_frames(frames)
            for i in range(frames["depth"].shape[0]):
                volume = self._step_flat(volume, {k: x[i:i + 1]
                                                  for k, x in frames.items()})
            return volume
        layout = self._layout(volume)
        rv = self._enter(layout, volume)
        stream = RowStream(rv, None, None)
        if pipe.dirty_shadow:
            # a zero shadow a slab and an all-dirty global mask: the first
            # step rebuilds every tile
            _, NJ = rowvol.shadow_tiling(layout)
            Ls = self._slab_layout(layout)
            dirty = torch.ones(layout.X * NJ + 1, dtype=torch.int32,
                               device=pipe.device)
            dirty[-1] = 0
            stream = RowStream(rv, [torch.zeros(
                (Ls.shadow_rows, 128), dtype=torch.int32, device=g.device)
                for g in rv.geo], dirty)
        stream = pipe._fuse_rows(layout, stream, frames, self._step_block,
                                 0)
        return self._exit(layout, stream.rv, volume)

    # -- the partitioned row step --------------------------------------------

    @staticmethod
    def _layout(volume: List[SceneVolume]) -> rowvol.RowLayout:
        X = sum(s.num.shape[0] for s in volume)
        return rowvol.RowLayout.for_shape((X,) + tuple(volume[0].num.shape[1:]))

    def _slab_layout(self, layout):
        return layout._replace(X=layout.X // sk.check_x_divisible(
            layout, self.mesh, self.mesh.axis_name))

    def _enter(self, layout, volume) -> rowvol.RowVolume:
        """Each slab's slot state on its device (the rows are x-local)."""
        Ls = self._slab_layout(layout)
        rows = [rowvol.rows_from_volume(s.num, s.weights, s.semkey, Ls,
                                        geo_dtype=self.pipeline.geo_dtype)
                for s in volume]
        dev = self.pipeline.device
        return rowvol.RowVolume(geo=[r[0] for r in rows],
                                key=[r[1] for r in rows],
                                origin=volume[0].origin.to(dev),
                                resolution=volume[0].resolution.to(dev),
                                init_value=volume[0].init_value)

    def _exit(self, layout, rv: rowvol.RowVolume, volume
              ) -> List[SceneVolume]:
        nums, ws = sk.sharded_reconcile_slot(rv.geo, layout, self.mesh,
                                             self.mesh.axis_name)
        keys = sk.sharded_reconcile_key(rv.key, layout, self.mesh,
                                        self.mesh.axis_name)
        return [SceneVolume(num=n, weights=w, semkey=k, origin=s.origin,
                            resolution=s.resolution,
                            init_value=s.init_value)
                for n, w, k, s in zip(nums, ws, keys, volume)]

    @torch.no_grad()
    def _step_block(self, layout, rv: rowvol.RowVolume, frames,
                    shadow_carry=None, do_sem=None):
        """``Pipeline.step_fuse_rows_block_impl`` over the slabs: ``rv``
        holds lists of slab rows, ``shadow_carry`` (slab shadows, global
        dirty mask). Returns ``(rv, new_carry)``."""
        pipe = self.pipeline
        mesh, axis = self.mesh, self.mesh.axis_name
        Ls = self._slab_layout(layout)
        depth = frames["depth"]                        # (k, h, w)
        k, h, w = depth.shape
        p, t = pipe.n_points, pipe.n_tail_points
        sem_ids, scores = (pipe._block_semantics(frames) if pipe.semantics
                           else (None, None))
        points_w = geometry.unproject(depth, frames["extrinsics"],
                                      frames["intrinsics"])
        points_v = geometry.sample_ray_points(
            points_w, frames["extrinsics"][:, :3, 3].float(), rv.origin,
            rv.resolution, p).reshape(k * h * w, p, 3)
        cr = rowvol.corner_rows(points_v, layout)
        if shadow_carry is not None:
            shadows = sk.sharded_build_shadow_dirty(
                rv.geo, shadow_carry[0], shadow_carry[1], layout, mesh, axis)
            new_carry = (shadows, rowvol.dirty_tile_mask(points_v[:, :t],
                                                         layout))
        else:
            shadows = sk.sharded_build_shadow(rv.geo, layout, mesh, axis)
            new_carry = None
        # each slab's words of the corners it holds; one slab gives each
        owner = cr.k_rows.reshape(-1) // Ls.key_rows
        q = 0
        for i, sh in enumerate(shadows):
            d = sh.device
            q = q + rowvol.gather_words(
                sh, cr.k_rows.to(d), cr.ksl.to(d), i * Ls.key_rows,
                (owner == i).to(d)).to(pipe.device)
        fv, fw = rowvol.extract_words(q, cr, pipe.init_value,
                                      geometry.INVALID_TSDF_FILL)
        inputs = pipe._row_net_inputs(fv, fw, depth, sem_ids)
        ray_mask = (torch.where(frames["mask"], depth, 0.0).reshape(-1)
                    != 0.0)
        u = pipe._estimate_updates(cr, inputs, sem_ids, scores, ray_mask,
                                   rv.geo[0].dtype, do_sem)
        # each update to the slab that owns its row (one x-plane owner for
        # the geo and the key row of an update)
        owner = u.rows // Ls.geo_rows
        for i, (g, key) in enumerate(zip(rv.geo, rv.key)):
            sel = owner == i

            def part(a, d=g.device):
                return None if a is None else a[sel].to(d)

            k_rows = part(u.k_rows)
            rowvol.scatter_updates(g, key, rowvol.RowUpdates(
                part(u.rows) - i * Ls.geo_rows, part(u.sgs), part(u.vals8),
                None if k_rows is None else k_rows - i * Ls.key_rows,
                part(u.ksl), part(u.kvals), u.n_tail))
        return rv, new_carry

    # -- the partitioned flat step --------------------------------------------

    @staticmethod
    def _gather_flat(words, lin, slab_vox: int) -> torch.Tensor:
        """The int32 words at the global linear indices ``lin``: each slab
        gives those of its own voxels (the others read 0), summed on
        ``lin``'s device, where exactly one slab gave each."""
        owner = lin // slab_vox
        q = 0
        for i, w in enumerate(words):
            d = w.device
            own = (owner == i).to(d)
            idx = torch.where(own, lin.to(d) - i * slab_vox, 0)
            q = q + torch.where(own, w.reshape(-1)[idx], 0).to(lin.device)
        return q

    @torch.no_grad()
    def _step_flat(self, volume: List[SceneVolume], frame
                   ) -> List[SceneVolume]:
        """``Pipeline.step_fuse_impl``'s flat path over the slabs
        (``frame`` leaves lead with 1), the slabs updated in place."""
        pipe = self.pipeline
        shape = (sum(s.num.shape[0] for s in volume),) + tuple(
            volume[0].num.shape[1:])
        slab_vox = volume[0].num.numel()
        sem_ids, scores = (pipe._frame_semantics(frame) if pipe.semantics
                           else (None, None))
        depth = frame["depth"][0]
        filtered = torch.where(frame["mask"][0], depth, 0.0)
        points_w, points_v = geometry._ray_points(
            depth, frame["extrinsics"][0], frame["intrinsics"][0],
            volume[0].origin.to(depth.device),
            volume[0].resolution.to(depth.device), pipe.n_points)
        if pipe.packed16_gather:
            lin, valid, weights = geometry.interpolation_corners_factored(
                points_v, shape)
            num_c, w_c = geometry.unpack16_numw(self._gather_flat(
                [geometry.pack16_numw(s.num, s.weights) for s in volume],
                lin, slab_vox))
            indices, lin_valid = None, (lin, valid)
        else:
            indices, weights = geometry.interpolation_weights(points_v)
            valid = geometry.valid_index_mask(indices, shape)
            lin = geometry._flatten_index(
                geometry.clamp_indices(indices, shape), shape)
            num_c, w_c = (self._gather_flat(
                [getattr(s, name).view(torch.int32) for s in volume], lin,
                slab_vox).view(torch.float32) for name in ("num", "weights"))
            lin_valid = (None, None)
        v_c, w_c = geometry._corner_values(num_c, w_c, valid, pipe.init_value,
                                           geometry.INVALID_TSDF_FILL)
        values = geometry.ExtractedValues(
            (v_c * weights).sum(-1), (w_c * weights).sum(-1), points_v,
            depth.reshape(-1), indices, weights, points_w, *lin_valid)
        inputs = _prepare_fusion_input(depth, values, sem_ids, pipe.n_points,
                                       pipe.n_classes, pipe.use_semantics)
        est = pipe.fusion_net(inputs).reshape(1, depth.numel(), -1)
        upd_values, upd_idx, upd_weights, ray_mask = pipe._volume_update_args(
            values, est[..., :pipe.n_points], filtered)
        if isinstance(upd_idx, tuple):
            lin, valid = upd_idx
        else:
            valid = geometry.valid_index_mask(upd_idx, shape)
            lin = geometry._flatten_index(
                geometry.clamp_indices(upd_idx, shape), shape)
        # integrate._scatter_add_geo's and integrate_semkey_lin's updates,
        # each to the slab that owns its voxel
        valid = integ._corner_mask(valid, ray_mask)
        w = torch.where(valid, upd_weights.float(), 0.0)
        nv = (w * upd_values.float()[:, :, None]).reshape(-1)
        w = w.reshape(-1)
        keys = (integ._keys(sem_ids, scores, valid) if pipe.semantics
                else None)
        lin = lin.reshape(-1)
        owner = lin // slab_vox
        for i, s in enumerate(volume):
            sel = owner == i
            d = s.num.device
            idx = (lin[sel] - i * slab_vox).to(d)
            s.weights.view(-1).index_add_(0, idx, w[sel].to(d))
            s.num.view(-1).index_add_(0, idx, nv[sel].to(d))
            if keys is not None:
                s.semkey.view(-1).scatter_reduce_(0, idx, keys[sel].to(d),
                                                  "amax")
        return volume
