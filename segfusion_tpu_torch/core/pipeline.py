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

Training (``train_sequence_rows`` / ``step_train_rows_impl``) runs the
same front end per frame, then FusionNet in train mode against the
ground truth read from a packed gt shadow, and the fusion loss; each
frame's backward adds its gradients into the net's ``.grad`` (the JAX
package sums them over the chunk). Gradients stop at the net: the front
end, the shadow kernels and the integration run without autograd, and
the volume integrates the detached estimate (truncated BPTT of length
1). A training pipeline keeps float32 master weights and computes in
FUSION_MODEL.compute_dtype.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import seeded_init
from ..models.fusionnet import build_fusion_net
from ..models.layers import training_convolutions
from ..ops import geometry
from ..ops import rowvol
from ..ops.integrate import pack_semantic_key
from ..utils.losses import fusion_loss
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


def _fused_for_loss(fusion_values, fusion_weights, tsdf_est,
                    init_value: float):
    """The moving-average fusion the loss compares with the target:
    (w * old + clip(est)) / (w + 1) over the first n_points samples."""
    n = tsdf_est.shape[-1]
    tsdf_old = fusion_values[None, :, :n]
    weights = torch.clamp_min(fusion_weights[None, :, :n], 0.0)
    tsdf_new = torch.clamp(tsdf_est, -init_value, init_value)
    return (weights * tsdf_old + tsdf_new) / (weights + 1.0)


class Pipeline:
    """Fusion net (+ optional 2D segmenter) and the row inference path.

    ``segmenter``: a ``models.adapnet.SegmenterAdapter`` (its model already
    on ``device``), required when DATA.semantic_strategy is "predict": it
    labels a whole chunk up front, ``_SEM_BATCH`` frames per forward.
    ``fusion_net``: a loaded FusionNetV3; when None one is built with
    random weights from ``generator`` (default seed 0). The net is moved
    to ``device`` ("cuda" unless the caller names the CPU) and computes
    in FUSION_MODEL.compute_dtype; with ``train`` its parameters stay
    float32 (the optimizer's master weights) and its dropout draws from a
    generator on ``device`` seeded with SETTINGS.seed, else they are cast
    to the compute dtype."""

    def __init__(self, config, segmenter=None, fusion_net=None,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 train: bool = False):
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
        loss = config.get("TRAINING", {}).get("loss") or {}
        self.loss_weights = {k: float(loss.get(k, d)) for k, d in
                             (("w_l1", 1.0), ("w_l2", 10.0), ("w_cos", 0.1))}
        # key scatter only on every k-th step of a chunk (k = 1: exact)
        self.sem_every = int(s.get("sem_integrate_every", 1))
        # frames per integration block (1: the exact per-frame recurrence)
        # and the geo accumulator dtype; SEGFUSION_FRAME_BLOCK and
        # SEGFUSION_GEO_DTYPE override the config, as in the JAX package
        fb = os.environ.get("SEGFUSION_FRAME_BLOCK")
        self.frame_block = max(1, int(fb if fb else s.get("frame_block", 1)))
        self.geo_dtype = (torch.bfloat16 if _bf16_setting(
            os.environ.get("SEGFUSION_GEO_DTYPE")
            or s.get("geo_dtype", "float32")) else torch.float32)
        net_dtype = (torch.bfloat16 if _bf16_setting(
            config.FUSION_MODEL.get("compute_dtype")) else torch.float32)
        if fusion_net is None:
            fusion_net = seeded_init(
                build_fusion_net(config.FUSION_MODEL),
                generator or torch.Generator().manual_seed(0))
        self.fusion_net = fusion_net.to(
            self.device, torch.float32 if train else net_dtype).eval()
        self.fusion_net.compute_dtype = net_dtype
        if train:
            self.fusion_net.set_dropout_generator(torch.Generator(
                device=self.device).manual_seed(int(s.get("seed") or 0)))
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

    # the exit reconcile that keeps the row state (mid-stream evaluations
    # of a row-carrying trainer): the reconcile kernels write new tensors
    # and leave the slot state as it is, so it is the exit itself
    _peek_rows = _exit_rows

    @staticmethod
    def _reset_stream(stream: RowStream) -> RowStream:
        """Zero the scene state (a training reset), in place: zero geo and
        key rows; a zero state's shadow is all-zero words, so the carried
        shadow zeroes with a CLEAN dirty mask and the next frame rebuilds
        no reset tile."""
        stream.rv.geo.zero_()
        stream.rv.key.zero_()
        if stream.shadow is not None:
            stream.shadow.zero_()
            stream.dirty.zero_()
        return stream

    @staticmethod
    def _gt_shadow(layout, gt_tsdf: torch.Tensor) -> torch.Tensor:
        """The gt value volume packed once into a constant target shadow
        (w = 1): its extraction reads bf16-rounded gt values."""
        gt = gt_tsdf.float()
        return rowvol.shadow_from_canonical(gt, torch.ones_like(gt), layout)

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

    def _row_frontend(self, layout, rv: rowvol.RowVolume, frames, sem_ids,
                      shadow_carry=None):
        """The row-path front end of a k-frame block (``frames`` leaves
        lead with k): ray samples -> corner rows -> gather shadow (the
        dirty tiles only when ``shadow_carry`` (prev_shadow, dirty) is
        given; the carried shadow is updated IN PLACE, as the Pallas
        kernel aliases it) -> extraction -> the net's NHWC inputs
        (``sem_ids`` (k, h*w) feed the semantic frame). Returns ``(cr, fv,
        fw, inputs, ray_mask, new_carry)``; new_carry is None iff
        shadow_carry was."""
        depth = frames["depth"]                        # (k, h, w)
        k, h, w = depth.shape
        n = h * w
        p, t = self.n_points, self.n_tail_points
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
        ray_mask = (torch.where(frames["mask"], depth, 0.0).reshape(-1)
                    != 0.0)
        return cr, fv, fw, inputs, ray_mask, new_carry

    def step_fuse_rows_block_impl(self, layout, rv: rowvol.RowVolume, frames,
                                  shadow_carry=None, do_sem=None):
        """k-frame block step (``frames`` leaves lead with k). Every frame
        extracts against the same pre-block state (one shadow build); the
        nets run batched over the block; the block's rays integrate
        through one geo scatter-add and one key scatter-max. k = 1 is the
        exact per-frame step (the JAX package's ``step_fuse_rows_impl``).
        ``shadow_carry`` (prev_shadow, dirty) turns on the dirty rebuild.
        Returns ``(rv, new_carry)`` (carry None iff shadow_carry was)."""
        k, h, w = frames["depth"].shape
        n = h * w
        p, t = self.n_points, self.n_tail_points
        if self.semantics:
            sem_ids, scores = self._block_semantics(frames)
        else:
            sem_ids = scores = None
        cr, _, _, inputs, ray_mask, new_carry = self._row_frontend(
            layout, rv, frames, sem_ids, shadow_carry)
        est = self.fusion_net(inputs).reshape(k, n, -1)[..., :p]

        upd_values = torch.clamp(est[..., :t], -self.init_value,
                                 self.init_value).reshape(k * n, t)
        sem_key = (pack_semantic_key(scores.reshape(-1), sem_ids.reshape(-1))
                   if self.semantics else None)
        geo, key = rowvol.integrate_rows(rv.geo, rv.key, cr, upd_values,
                                         sem_key, ray_mask, t, do_sem=do_sem)
        return rv._replace(geo=geo, key=key), new_carry

    def step_train_rows_impl(self, layout, rv: rowvol.RowVolume, gt_shadow,
                             frame, shadow_carry=None):
        """One training frame (``frame`` leaves lead with 1) over the slot
        state: the front end and the gt extraction (one more 4-lane
        gather per (ray, sample, x-corner) from the constant ``gt_shadow``)
        without autograd; FusionNet in train mode; the fusion loss of the
        moving-average fusion against the gt; its backward, which adds the
        frame's gradients into the net's ``.grad``; then the detached,
        clipped estimate integrates (no semantics: the reference trains
        with ``test=False``). Returns ``(loss, rv, new_carry)``."""
        k, h, w = frame["depth"].shape
        n = h * w
        p, t = self.n_points, self.n_tail_points
        with torch.no_grad():
            sem_ids = (self._block_semantics(frame)[0]
                       if self.semantics and self.use_semantics else None)
            cr, fv, fw, inputs, ray_mask, new_carry = self._row_frontend(
                layout, rv, frame, sem_ids, shadow_carry)
            gv, _ = rowvol.extract_rows(gt_shadow, cr, self.init_value,
                                        geometry.INVALID_TSDF_FILL)
        est = self.fusion_net(inputs).reshape(k, n, -1)[..., :p]
        loss = fusion_loss(_fused_for_loss(fv, fw, est, self.init_value),
                           gv[None, :, :p], ray_mask[None],
                           **self.loss_weights)
        loss.backward()
        with torch.no_grad():
            upd_values = torch.clamp(est.detach()[0, :, :t], -self.init_value,
                                     self.init_value)
            geo, key = rowvol.integrate_rows(rv.geo, rv.key, cr, upd_values,
                                             None, ray_mask, t)
        return loss.detach(), rv._replace(geo=geo, key=key), new_carry

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

    def train_sequence_rows(self, layout, stream: RowStream, gt_shadow,
                            frames: Dict[str, torch.Tensor], reset_flags
                            ) -> Tuple[torch.Tensor, RowStream]:
        """Train over a (T, ...) frame chunk, one frame at a time (training
        ignores frame_block): a frame whose ``reset_flags`` entry is set
        first zeroes the state (``_reset_stream``); each frame's gradients
        add into the net's ``.grad``, and its BatchNorm running
        statistics move, an all-masked padding frame's too. The caller
        zeroes the gradients and steps the optimizer once per chunk.
        Returns ``(loss_sum, stream)``; the slot state and the gt shadow
        stay the caller's, carried across chunks. A float32 net on a card
        trains with cuDNN off (``models/layers.training_convolutions``).
        """
        if self.use_semantics:
            with torch.no_grad():
                frames = self._sem_prepass_frames(frames)
        T = frames["depth"].shape[0]
        loss_sum = torch.zeros((), device=self.device)
        self.fusion_net.train()
        try:
            with training_convolutions(self.fusion_net.compute_dtype,
                                       self.device):
                for i in range(T):
                    if bool(reset_flags[i]):
                        stream = self._reset_stream(stream)
                    frame = {key: x[i:i + 1] for key, x in frames.items()}
                    carry = (None if stream.shadow is None
                             else (stream.shadow, stream.dirty))
                    loss, rv, carry = self.step_train_rows_impl(
                        layout, stream.rv, gt_shadow, frame,
                        shadow_carry=carry)
                    stream = (RowStream(rv, None, None) if carry is None
                              else RowStream(rv, carry[0], carry[1]))
                    loss_sum = loss_sum + loss
        finally:
            self.fusion_net.eval()
        return loss_sum, stream

    def train_sequence(self, volume: SceneVolume, gt_tsdf: torch.Tensor,
                       frames, reset_flags) -> Tuple[torch.Tensor,
                                                     SceneVolume]:
        """:meth:`train_sequence_rows` from and to a canonical volume:
        enter the slot form, pack the gt shadow, train, exit. Returns
        ``(loss_sum, volume)``."""
        layout, rv = self._rows_from_volume(volume)
        gt_shadow = self._gt_shadow(layout, gt_tsdf)
        loss_sum, stream = self.train_sequence_rows(
            layout, self._new_stream(layout, rv), gt_shadow, frames,
            reset_flags)
        return loss_sum, self._exit_rows(layout, stream.rv)

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
                  max_live_scenes: Optional[int] = None):
        """Stream host batches through chunked ``fuse_sequence_rows``
        calls, buffering frames per scene (interleaved scene orders keep
        whole chunks); each chunk is tail-padded with all-masked no-op
        frames. A scene's slot state is carried across its chunks and
        written back to ``database`` once, when it is evicted (at most
        ``max_live_scenes`` carried at a time, default
        SETTINGS.max_live_row_scenes, else 1) or at the end."""
        if max_live_scenes is None:
            max_live_scenes = int(self.config.SETTINGS.get(
                "max_live_row_scenes", 1))
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
