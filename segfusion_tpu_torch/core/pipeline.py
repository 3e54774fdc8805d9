"""Pipeline: online joint inference over the slot-row scene state.

Port of the row inference path of ``segfusion_tpu/core/pipeline.py``:
``fuse_sequence_rows`` / ``fuse_many`` and what they call. Per frame (or
block of ``frame_block`` frames): semantic labels (AdapNet++ pre-pass or
ground truth) -> unproject + ray samples -> corner rows -> gather shadow
(dirty tiles only, when the carry is on) -> ``extract_rows`` -> FusionNet
v3 -> ``integrate_rows`` -> dirty mask for the next step. The stream exits
through the reconcile kernels into a canonical ``SceneVolume``.

The JAX ``lax.scan`` over frames is a Python loop; its ``lax.cond`` on the
semantic-decimation phase is an ``if`` on a host int. Kernel dispatch
follows the tensors' device (``ops/kernels/shadow_build.py``): a pipeline
on ``cuda`` runs the CUDA kernels, on ``cpu`` their plain versions.
Training (``step_train_rows_impl`` and the losses) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import seeded_init
from ..models.fusionnet import build_fusion_net
from ..ops import geometry
from ..ops import rowvol
from ..ops.integrate import pack_semantic_key
from .volume import SceneVolume

__all__ = ["Pipeline", "RowStream"]

# frames per segmenter forward in the semantic pre-pass
_SEM_BATCH = 8


class RowStream(NamedTuple):
    """Streaming state carried across frames and chunks: the slot volume
    plus the dirty-shadow carry (``shadow``: the gather shadow used for
    the last step, updated in place; ``dirty``: that step's integration
    footprint tile mask). ``shadow``/``dirty`` are None when the carry is
    off (SETTINGS.dirty_shadow: off): every step then rebuilds fully."""
    rv: rowvol.RowVolume
    shadow: Optional[torch.Tensor]   # (shadow_rows, 128) int32
    dirty: Optional[torch.Tensor]    # (X * NJ + 1,) int32


def _bf16_setting(value) -> bool:
    return value in ("bfloat16", "bf16")


class Pipeline:
    """Fusion net (+ optional 2D segmenter) and the row inference path.

    ``segmenter``: a ``models.adapnet.SegmenterAdapter`` (its model already
    on ``device``), required when DATA.semantic_strategy is "predict": it
    labels a whole chunk up front, ``_SEM_BATCH`` frames per forward.
    ``fusion_net``: a loaded FusionNetV3; when None one is built with
    random weights from ``generator`` (default seed 0). The net is moved
    to ``device`` ("cuda" unless the caller names the CPU) in
    FUSION_MODEL.compute_dtype."""

    def __init__(self, config, segmenter=None, fusion_net=None,
                 device="cuda", generator: Optional[torch.Generator] = None):
        self.config = config
        self.device = resolve_device(device)
        self.n_points = int(config.FUSION_MODEL.n_points)
        self.n_tail_points = int(config.FUSION_MODEL.n_tail_points)
        self.init_value = float(config.DATA.init_value)
        self.use_semantics = bool(config.FUSION_MODEL.use_semantics)
        self.semantics = bool(config.DATA.get("semantics"))
        self.semantic_strategy = config.DATA.get("semantic_strategy", "gt")
        self.n_classes = (int(config.SEMANTIC_2D_MODEL.n_classes)
                          if self.semantics else 0)
        if (self.semantics and self.semantic_strategy == "predict"
                and segmenter is None):
            raise ValueError("semantic_strategy 'predict' needs a segmenter")
        s = config.SETTINGS
        # the flat scalar path (and SETTINGS.gather_precision, which only
        # it reads) is not ported: refuse it rather than run the row path
        if s.get("integration", "rows") == "scalar":
            raise NotImplementedError(
                "SETTINGS.integration 'scalar' (the flat scalar path) is not "
                "ported (ROADMAP Queue 1 #5); use the row path ('rows')")
        # dirty-shadow carry: rebuild only the tiles the previous step's
        # integration touched (bit-identical; the mask is conservative)
        self.dirty_shadow = s.get("dirty_shadow", "on") != "off"
        # key scatter only on every k-th step of a chunk (k = 1: exact)
        self.sem_every = int(s.get("sem_integrate_every", 1))
        # frames per integration block (1: the exact per-frame recurrence)
        self.frame_block = max(1, int(s.get("frame_block", 1)))
        self.geo_dtype = (torch.bfloat16
                          if _bf16_setting(s.get("geo_dtype", "float32"))
                          else torch.float32)
        net_dtype = (torch.bfloat16 if _bf16_setting(
            config.FUSION_MODEL.get("compute_dtype")) else torch.float32)
        if fusion_net is None:
            fusion_net = seeded_init(
                build_fusion_net(config.FUSION_MODEL),
                generator or torch.Generator().manual_seed(0))
        self.fusion_net = fusion_net.to(self.device, net_dtype).eval()
        self.segmenter = segmenter

    # -- semantics ------------------------------------------------------------

    def _predict_semantics_batched(self, images, depths):
        """(T, h, w, 3) / (T, h, w) -> ids (T, h*w) uint8, scores (T, h*w)
        f32: softmax winner and its probability."""
        ids, scores = [], []
        for i in range(0, images.shape[0], _SEM_BATCH):
            logits = self.segmenter.apply_fn_batched(
                images[i:i + _SEM_BATCH], depths[i:i + _SEM_BATCH])
            probs = torch.softmax(logits.float(), -1)
            n = probs.shape[0]
            scores.append(probs.amax(-1).reshape(n, -1))
            ids.append(probs.argmax(-1).to(torch.uint8).reshape(n, -1))
        return torch.cat(ids), torch.cat(scores)

    def _sem_prepass_frames(self, frames):
        """Attach the chunk's predicted semantics (``sem_ids_pre`` /
        ``sem_scores_pre``) to a (T, ...) frame dict: the prediction
        depends only on the frame, so it runs batched before the loop."""
        if not (self.semantics and self.semantic_strategy == "predict"):
            return frames
        ids, scores = self._predict_semantics_batched(
            frames["image"], frames["depth_input"])
        return dict(frames, sem_ids_pre=ids, sem_scores_pre=scores)

    def _block_semantics(self, frames):
        """(sem_ids, scores), each (k, h*w): the pre-pass values, or the
        ground-truth labels with score 1."""
        if "sem_ids_pre" in frames:
            return frames["sem_ids_pre"], frames["sem_scores_pre"]
        k = frames["depth"].shape[0]
        sem_ids = frames["semantic_gt"].reshape(k, -1).to(torch.uint8)
        return sem_ids, torch.ones(sem_ids.shape, dtype=torch.float32,
                                   device=sem_ids.device)

    # -- slot state -----------------------------------------------------------

    def _enter_rows(self, layout, volume: SceneVolume) -> rowvol.RowVolume:
        geo, key = rowvol.rows_from_volume(volume.num, volume.weights,
                                           volume.semkey, layout,
                                           geo_dtype=self.geo_dtype)
        return rowvol.RowVolume(geo=geo, key=key, origin=volume.origin,
                                resolution=volume.resolution,
                                init_value=volume.init_value)

    def _rows_from_volume(self, volume: SceneVolume):
        layout = rowvol.RowLayout.for_shape(tuple(volume.num.shape))
        return layout, self._enter_rows(layout, volume)

    @staticmethod
    def _exit_rows(layout, rv: rowvol.RowVolume) -> SceneVolume:
        """Materialise the canonical state (the reconcile kernels). Callers
        drop the stream afterwards, which frees the slot state and the
        dirty-shadow carry in stream order."""
        num, w, key = rowvol.volume_from_rows(rv.geo, rv.key, layout)
        return SceneVolume(num=num, weights=w, semkey=key, origin=rv.origin,
                           resolution=rv.resolution,
                           init_value=rv.init_value)

    def _new_stream(self, layout, rv: rowvol.RowVolume) -> RowStream:
        """Fresh streaming state: an all-dirty mask over a zero shadow, so
        the first step rebuilds every tile."""
        if not self.dirty_shadow:
            return RowStream(rv, None, None)
        _, NJ = rowvol.shadow_tiling(layout)
        nt = layout.X * NJ
        dev = rv.geo.device
        shadow = torch.zeros((layout.shadow_rows, 128), dtype=torch.int32,
                             device=dev)
        dirty = torch.cat([torch.ones(nt, dtype=torch.int32, device=dev),
                           torch.zeros(1, dtype=torch.int32, device=dev)])
        return RowStream(rv, shadow, dirty)

    # -- steps ----------------------------------------------------------------

    def step_fuse_rows_block_impl(self, layout, rv: rowvol.RowVolume, frames,
                                  shadow_carry=None, do_sem=None):
        """k-frame block step (``frames`` leaves lead with k). Every frame
        extracts against the same pre-block state (one shadow build); the
        nets run batched over the block; the block's rays integrate
        through one geo scatter-add and one key scatter-max. k = 1 is the
        exact per-frame step (the JAX package's ``step_fuse_rows_impl``).
        ``shadow_carry`` (prev_shadow, dirty) turns
        on the dirty rebuild; the carried shadow is updated IN PLACE by
        the dirty kernel (the Pallas kernel aliases it the same way).
        Returns ``(rv, new_carry)`` (carry None iff shadow_carry was)."""
        depth = frames["depth"]                        # (k, h, w)
        k, h, w = depth.shape
        n = h * w
        p, t = self.n_points, self.n_tail_points
        filtered = torch.where(frames["mask"], depth, 0.0)
        if self.semantics:
            sem_ids, scores = self._block_semantics(frames)
        else:
            sem_ids = scores = None

        points_w = geometry.unproject(depth, frames["extrinsics"],
                                      frames["intrinsics"])   # (k, n, 3)
        eyes = frames["extrinsics"][:, :3, 3].float()
        points_v = geometry.sample_ray_points(
            points_w, eyes, rv.origin, rv.resolution, p).reshape(k * n, p, 3)
        cr = rowvol.corner_rows(points_v, layout)

        if shadow_carry is not None:
            prev_shadow, dirty = shadow_carry
            shadow = rowvol.build_shadow_dirty(rv.geo, prev_shadow, dirty,
                                               layout)
            # tail samples only: the scatters below touch only those rows
            new_carry = (shadow, rowvol.dirty_tile_mask(points_v[:, :t],
                                                        layout))
        else:
            shadow = rowvol.build_shadow(rv.geo, layout)
            new_carry = None
        fv, fw = rowvol.extract_rows(shadow, cr, self.init_value,
                                     geometry.INVALID_TSDF_FILL)

        inputs = {
            "tsdf_values": fv.reshape(k, h, w, p),
            "tsdf_weights": fw.reshape(k, h, w, p),
            "tsdf_frame": depth.reshape(k, h, w, 1),
        }
        if self.use_semantics:
            sem = (1.0 + sem_ids.float()) / self.n_classes
            inputs["semantic_frame"] = sem.reshape(k, h, w, 1)
        est = self.fusion_net(inputs).reshape(k, n, -1)[..., :p]

        upd_values = torch.clamp(est[..., :t], -self.init_value,
                                 self.init_value).reshape(k * n, t)
        ray_mask = filtered.reshape(-1) != 0.0
        sem_key = (pack_semantic_key(scores.reshape(-1), sem_ids.reshape(-1))
                   if self.semantics else None)
        geo, key = rowvol.integrate_rows(rv.geo, rv.key, cr, upd_values,
                                         sem_key, ray_mask, t, do_sem=do_sem)
        return rv._replace(geo=geo, key=key), new_carry

    # -- sequences ------------------------------------------------------------

    @torch.no_grad()
    def fuse_sequence_rows(self, layout, stream: RowStream,
                           frames: Dict[str, torch.Tensor]) -> RowStream:
        """Slot-state-to-slot-state fusion of a (T, ...) frame chunk:
        callers carry the RowStream across chunks and materialise a
        SceneVolume only at the end (``_exit_rows``). With frame_block k >
        1 the chunk pads to a multiple of k with all-masked copies of its
        last frame (no-op integrations). The semantic-decimation phase is
        per chunk: its step 0 always integrates semantics."""
        frames = self._sem_prepass_frames(frames)
        decimate = self.semantics and self.sem_every > 1
        T = frames["depth"].shape[0]
        kb = self.frame_block
        pad = (-T) % kb
        if pad:
            frames = {key: torch.cat([x, x[-1:].expand(
                (pad,) + x.shape[1:])]) for key, x in frames.items()}
            frames["mask"][T:] = False
        for idx in range((T + pad) // kb):
            block = {key: x[idx * kb:(idx + 1) * kb]
                     for key, x in frames.items()}
            carry = (None if stream.shadow is None
                     else (stream.shadow, stream.dirty))
            do_sem = (idx % self.sem_every == 0) if decimate else None
            rv, carry = self.step_fuse_rows_block_impl(
                layout, stream.rv, block, shadow_carry=carry, do_sem=do_sem)
            stream = (RowStream(rv, None, None) if carry is None
                      else RowStream(rv, carry[0], carry[1]))
        return stream

    def fuse_sequence(self, volume: SceneVolume, frames) -> SceneVolume:
        """Fuse a (T, ...) frame chunk into ``volume``: enter the slot
        form, stream, exit."""
        layout, rv = self._rows_from_volume(volume)
        stream = self.fuse_sequence_rows(layout, self._new_stream(layout, rv),
                                         frames)
        return self._exit_rows(layout, stream.rv)

    # -- host-facing API ------------------------------------------------------

    @staticmethod
    def _frame_from_batch(batch, input_key: str):
        """Host batch dict (leading batch dim 1) -> host (numpy) frame."""
        def squeeze(x):
            x = np.asarray(x)
            return x[0] if x.ndim and x.shape[0] == 1 else x

        frame = {
            "depth": squeeze(batch[input_key]).astype(np.float32),
            "extrinsics": squeeze(batch["extrinsics"]).astype(np.float32),
            "intrinsics": squeeze(batch["intrinsics"]).astype(np.float32),
            "mask": squeeze(batch["mask"]),
        }
        if "image" in batch:
            frame["image"] = squeeze(batch["image"]).astype(np.float32)
            frame["depth_input"] = frame["depth"]
        if "semantic_gt" in batch:
            frame["semantic_gt"] = squeeze(batch["semantic_gt"])
        return frame

    def _stack_host_frames(self, frames):
        """List of host frames -> one (T, ...) tensor per field on the
        pipeline's device."""
        return {k: torch.as_tensor(np.stack([f[k] for f in frames])).to(
            self.device) for k in frames[0]}

    def fuse_many(self, batches, database, chunk: int = 16,
                  max_live_scenes: int = 1):
        """Stream host batches through chunked ``fuse_sequence_rows``
        calls, buffering frames per scene (interleaved scene orders keep
        whole chunks); each chunk is tail-padded with all-masked no-op
        frames. A scene's slot state is carried across its chunks and
        written back to ``database`` once, when it is evicted (at most
        ``max_live_scenes`` carried at a time) or at the end."""
        pending: Dict[str, list] = {}
        rowstate: Dict[str, tuple] = {}   # insertion-ordered: LRU first

        def evict(scene_id: str):
            layout, stream = rowstate.pop(scene_id)
            database.update(scene_id, self._exit_rows(layout, stream.rv))

        def flush(scene_id: str):
            frames = pending.pop(scene_id, [])
            if not frames:
                return
            if len(frames) < chunk:  # pad with no-op frames (mask all False)
                pad = dict(frames[-1])
                pad["mask"] = np.zeros_like(frames[-1]["mask"])
                frames = frames + [pad] * (chunk - len(frames))
            stacked = self._stack_host_frames(frames)
            if scene_id not in rowstate:
                while len(rowstate) >= max(1, max_live_scenes):
                    evict(next(iter(rowstate)))
                volume = database.volumes[scene_id]
                layout = rowvol.RowLayout.for_shape(tuple(volume.num.shape))
                rowstate[scene_id] = (layout, self._new_stream(
                    layout, self._enter_rows(layout, volume)))
            layout, stream = rowstate.pop(scene_id)  # re-insert as newest
            rowstate[scene_id] = (layout, self.fuse_sequence_rows(
                layout, stream, stacked))

        for batch in batches:
            if not np.all(np.isfinite(np.asarray(batch["extrinsics"]))):
                continue
            scene_id = self._scene_of(batch)
            pending.setdefault(scene_id, []).append(
                self._frame_from_batch(batch, self.config.DATA.input))
            if len(pending[scene_id]) == chunk:
                flush(scene_id)
        for scene_id in list(pending):
            flush(scene_id)
        for scene_id in list(rowstate):
            evict(scene_id)

    @staticmethod
    def _scene_of(batch) -> str:
        fid = batch["frame_id"]
        if isinstance(fid, (list, tuple)):
            fid = fid[0]
        return str(fid).split("/", 1)[0]
