"""Pipeline: online joint inference and training over the scene state.

Port of ``segfusion_tpu/core/pipeline.py``. The row path
(``fuse_sequence_rows`` / ``fuse_many``), per frame (or block of
``frame_block`` frames): semantic labels (AdapNet++ pre-pass or ground
truth) -> unproject + ray samples -> corner rows -> gather shadow (dirty
tiles only, when the carry is on) -> ``extract_rows`` -> FusionNet ->
``integrate_rows`` -> dirty mask for the next step. The stream exits
through the reconcile kernels into a canonical ``SceneVolume``.

The per-frame API (``fuse`` / ``fuse_training``) steps one frame of the
canonical volume: on the row path ``step_fuse_impl`` enters slot form,
runs one row step with a full shadow build and exits (K2, K3 and K4 once
a frame); ``step_train_impl`` and, under ``SETTINGS.integration:
scalar``, every step take the flat scalar path: extraction of the
canonical (num, w) volume through linear corner indices
(``ops/geometry.py``; ``SETTINGS.gather_precision``: the packed bf16
words or f32), FusionNet, and the scatter-add / key scatter-max into it
(``ops/integrate.py``), in place.

The JAX ``lax.scan`` over frames is a Python loop; its ``lax.cond`` on the
semantic-decimation phase is an ``if`` on a host int. Kernel dispatch
follows the tensors' device (``ops/kernels/shadow_build.py``): a pipeline
on ``cuda`` runs the CUDA kernels, on ``cpu`` their plain versions.

Scenes (``step_fuse_scenes`` / ``fuse_sequence_scenes``), the
counterpart of the JAX package's ``jax.vmap`` of ``step_fuse_impl`` and
``fuse_sequence_impl``: S same-shape scenes stacked on a leading axis (a
``SceneVolume`` of (S, X, Y, Z) tensors, origin (S, 3), resolution (S,);
frames (S, T, ...)) fuse together. The nets run once a step over all the
scenes' frames; on the row path the S slot states are one volume of S * X
x-planes for the kernels (one launch each, ``ops/kernels/shadow_build.py``
``*_v``), each scene's bounds applied before its row offset
(``rowvol.corner_rows_scenes``); the flat path extracts scene by scene
and integrates through linear indices offset by ``s * X * Y * Z``.

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

import contextlib
import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import seeded_init
from ..models import fusionnet_fast as ff
from ..models.fusionnet import build_fusion_net
from ..models.layers import training_convolutions
from ..ops import geometry
from ..ops import rowvol
from ..ops import integrate as integ
from ..ops.integrate import pack_semantic_key
from ..utils import tracing
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


def _prepare_fusion_input(depth, values: geometry.ExtractedValues, sem_ids,
                          n_points: int, n_classes: int,
                          use_semantics: bool) -> Dict[str, torch.Tensor]:
    """One (h, w) frame's NHWC net inputs from a flat extraction."""
    h, w = depth.shape
    inputs = {
        "tsdf_values": values.fusion_values.reshape(1, h, w, n_points),
        "tsdf_weights": values.fusion_weights.reshape(1, h, w, n_points),
        "tsdf_frame": depth.reshape(1, h, w, 1),
    }
    if use_semantics:
        sem = (1.0 + sem_ids.float()) / n_classes
        inputs["semantic_frame"] = sem.reshape(1, h, w, 1)
    return inputs


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
    """Fusion net (+ optional 2D segmenter), the row path and the flat
    scalar path.

    ``segmenter``: a ``models.adapnet.SegmenterAdapter`` (its model already
    on ``device``), required when DATA.semantic_strategy is "predict": it
    labels a whole chunk up front, ``_SEM_BATCH`` frames per forward.
    ``fusion_net``: a loaded FusionNet (v1, v2 or v3); when None one is
    built with
    random weights from ``generator`` (default seed 0). The net is moved
    to ``device`` ("cuda" unless the caller names the CPU) and computes
    in FUSION_MODEL.compute_dtype; with ``train`` or the folded executor
    its parameters stay float32 (the optimizer's master weights; the
    fold's input), else they are cast to the compute dtype. With
    ``train`` its dropout draws from a generator on ``device`` seeded
    with SETTINGS.seed. Every net call goes through
    :meth:`_network_estimate`: a bf16 v3 without stacked heads runs the
    folded executor (``models/fusionnet_fast``) at inference and its
    matmul-form twin in training, as the JAX package's Pipeline does
    (SETTINGS.fused_net / fused_net_train / fused_conv3x3 /
    fused_vortex)."""

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
        # the flat scalar path: SETTINGS.integration scalar; its gathers
        # read packed bf16 words unless SETTINGS.gather_precision is f32
        self.row_path = s.get("integration", "rows") != "scalar"
        self.packed16_gather = s.get("gather_precision",
                                     "f16packed") != "f32"
        # dirty-shadow carry: rebuild only the tiles the previous step's
        # integration touched (bit-identical; the mask is conservative)
        self.dirty_shadow = self.row_path and s.get("dirty_shadow",
                                                    "on") != "off"
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
        self.net_dtype = net_dtype = (torch.bfloat16 if _bf16_setting(
            config.FUSION_MODEL.get("compute_dtype")) else torch.float32)
        # the folded matmul-form executor (models/fusionnet_fast) for v3
        # with unstacked heads, as the JAX package reads these settings:
        # fused_net "auto" runs it on bf16 compute, fused_net_train "auto"
        # follows fused_net; f32 runs keep the eager module
        fm = config.FUSION_MODEL
        v3 = fm.name == "v3" and not bool(fm.get("stack_heads", False))
        fused = s.get("fused_net", "auto")
        self.fused_net = v3 and (fused == "on" or (
            fused == "auto" and net_dtype == torch.bfloat16))
        fused_train = s.get("fused_net_train", "auto")
        self.fused_net_train = v3 and (fused_train == "on" or (
            fused_train == "auto" and self.fused_net))
        self.fused_conv3x3 = s.get("fused_conv3x3", "dots9")
        self.fused_pack_vortex = s.get("fused_vortex", "plain") == "packed"
        self._fold_cache = None
        if fusion_net is None:
            fusion_net = seeded_init(
                build_fusion_net(config.FUSION_MODEL),
                generator or torch.Generator().manual_seed(0))
        # float32 parameters for training (the optimizer's masters) and
        # for the fold (folded in float32, cast once after)
        keep_f32 = train or self.fused_net
        self.fusion_net = fusion_net.to(
            self.device, torch.float32 if keep_f32 else net_dtype).eval()
        self.fusion_net.compute_dtype = net_dtype
        self.dropout_generator = None
        if train:
            self.dropout_generator = torch.Generator(
                device=self.device).manual_seed(int(s.get("seed") or 0))
            self.fusion_net.set_dropout_generator(self.dropout_generator)
        self.segmenter = segmenter

    # -- the fusion net -------------------------------------------------------

    def prepare_params(self):
        """The folded executor (``models.fusionnet_fast.FastV3``) of the
        net's current parameters and statistics. Cached, and folded again
        whenever one of them was replaced or changed in place (an
        optimizer step, a BatchNorm update, a loaded state): the cache
        key is each tensor and its version counter."""
        state = list(self.fusion_net.parameters()) + list(
            self.fusion_net.buffers())
        versions = tuple(t._version for t in state)
        cached = self._fold_cache
        if (cached is None or cached[1] != versions
                or len(cached[0]) != len(state)
                or any(a is not b for a, b in zip(cached[0], state))):
            with tracing.span("fusionnet.fold"):
                fast = ff.FastV3(self.fusion_net, dtype=self.net_dtype,
                                 conv3x3=self.fused_conv3x3,
                                 pack_vortex=self.fused_pack_vortex)
            self._fold_cache = cached = (state, versions, fast)
        return cached[2]

    def _network_estimate(self, inputs: Dict[str, torch.Tensor],
                          train: bool = False) -> torch.Tensor:
        """FusionNet over B frames' NHWC inputs -> (B, h*w, n_points)
        estimates: the folded executor at inference when ``fused_net``
        is on, the matmul-form training forward when ``train`` and
        ``fused_net_train`` are, else the eager module (in the mode the
        caller set)."""
        B, h, w = inputs["tsdf_frame"].shape[:3]
        with tracing.span("fusionnet"):
            if train and self.fused_net_train:
                est = ff.apply_v3_train(self.fusion_net, inputs,
                                        dtype=self.net_dtype,
                                        conv3x3=self.fused_conv3x3,
                                        generator=self.dropout_generator)
            elif not train and self.fused_net:
                est = self.prepare_params()(inputs)
            else:
                est = self.fusion_net(inputs).reshape(B, h * w, -1)
        return est[..., :self.n_points]

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
        ``sem_scores_pre``, (..., h*w)) to a (T, ...) or (S, T, ...) frame
        dict: the prediction depends only on the frame, so it runs batched
        over all the frames before the loop."""
        if ("sem_ids_pre" in frames or not (
                self.semantics and self.semantic_strategy == "predict")):
            return frames
        image, depth = frames["image"], frames["depth_input"]
        lead = depth.shape[:-2]
        with tracing.span("adapnet"):
            ids, scores = self._predict_semantics_batched(
                image.reshape((-1,) + image.shape[-3:]),
                depth.reshape((-1,) + depth.shape[-2:]))
        return dict(frames, sem_ids_pre=ids.reshape(lead + (-1,)),
                    sem_scores_pre=scores.reshape(lead + (-1,)))

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

    def _enter_rows_scenes(self, layout, volumes: SceneVolume
                           ) -> rowvol.RowVolume:
        """Stacked canonical volumes -> (S, rows, 128) slot states."""
        geo, key = rowvol.rows_from_volumes(volumes.num, volumes.weights,
                                            volumes.semkey, layout,
                                            geo_dtype=self.geo_dtype)
        return rowvol.RowVolume(geo=geo, key=key, origin=volumes.origin,
                                resolution=volumes.resolution,
                                init_value=volumes.init_value)

    @staticmethod
    def _exit_rows_scenes(layout, rv: rowvol.RowVolume) -> SceneVolume:
        num, w, key = rowvol.volumes_from_rows(rv.geo, rv.key, layout)
        return SceneVolume(num=num, weights=w, semkey=key, origin=rv.origin,
                           resolution=rv.resolution,
                           init_value=rv.init_value)

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
        the first step rebuilds every tile. For S scenes the carry starts
        without the scene axis and the first dirty build broadcasts it, as
        under the JAX package's vmap."""
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
        with tracing.span("rowops.front"):
            points_w = geometry.unproject(depth, frames["extrinsics"],
                                          frames["intrinsics"])  # (k, n, 3)
            eyes = frames["extrinsics"][:, :3, 3].float()
            points_v = geometry.sample_ray_points(
                points_w, eyes, rv.origin, rv.resolution, p).reshape(
                    k * n, p, 3)
            cr = rowvol.corner_rows(points_v, layout)

        if shadow_carry is not None:
            prev_shadow, dirty = shadow_carry
            with tracing.span("k1"):
                shadow = rowvol.build_shadow_dirty(rv.geo, prev_shadow,
                                                   dirty, layout)
            # tail samples only: the scatters below touch only those rows
            with tracing.span("rowops.dirty"):
                new_carry = (shadow, rowvol.dirty_tile_mask(points_v[:, :t],
                                                            layout))
        else:
            with tracing.span("k1"):
                shadow = rowvol.build_shadow(rv.geo, layout)
            new_carry = None
        with tracing.span("rowops.extract"):
            fv, fw = rowvol.extract_rows(shadow, cr, self.init_value,
                                         geometry.INVALID_TSDF_FILL)
            inputs = self._row_net_inputs(fv, fw, depth, sem_ids)
            ray_mask = (torch.where(frames["mask"], depth, 0.0).reshape(-1)
                        != 0.0)
        return cr, fv, fw, inputs, ray_mask, new_carry

    def _row_net_inputs(self, fv, fw, depth, sem_ids):
        """The NHWC net inputs of B frames' extraction: ``fv``/``fw``
        (B*h*w, p), ``depth`` (..., h, w) with B frames, ``sem_ids``
        (B, h*w) or None."""
        h, w = depth.shape[-2:]
        p = self.n_points
        inputs = {
            "tsdf_values": fv.reshape(-1, h, w, p),
            "tsdf_weights": fw.reshape(-1, h, w, p),
            "tsdf_frame": depth.reshape(-1, h, w, 1),
        }
        if self.use_semantics:
            sem = (1.0 + sem_ids.float()) / self.n_classes
            inputs["semantic_frame"] = sem.reshape(-1, h, w, 1)
        return inputs

    def _row_frontend_scenes(self, layout, rv: rowvol.RowVolume, frames,
                             sem_ids, shadow_carry=None):
        """:meth:`_row_frontend` of S scenes' k-frame blocks (``frames``
        leaves lead with (S, k); ``rv`` holds (S, rows, 128) states and
        each scene's origin and resolution): the samples of each scene in
        its own voxel space, the corner rows folded into one volume of
        S * X x-planes, one shadow build for all scenes (dirty: the
        carried (S, shadow_rows, 128) shadow, updated in place, and the
        (S, X * NJ + 1) masks, one a scene), one extraction. Rays are
        scene-major; ``sem_ids`` (S * k, h*w)."""
        depth = frames["depth"]                        # (S, k, h, w)
        S, k, h, w = depth.shape
        p, t = self.n_points, self.n_tail_points
        with tracing.span("rowops.front"):
            points_w = geometry.unproject(
                depth, frames["extrinsics"],
                frames["intrinsics"])                  # (S, k, n, 3)
            eyes = frames["extrinsics"][..., :3, 3].float()
            points_v = geometry.sample_ray_points(
                points_w, eyes, rv.origin[:, None, None],
                rv.resolution[:, None, None, None], p).reshape(
                    S, k * h * w, p, 3)
            cr = rowvol.corner_rows_scenes(points_v, layout)
        if shadow_carry is not None:
            prev_shadow, dirty = shadow_carry
            with tracing.span("k1"):
                shadow = rowvol.build_shadow_dirty_v(rv.geo, prev_shadow,
                                                     dirty, layout)
            with tracing.span("rowops.dirty"):
                new_carry = (shadow, torch.stack([
                    rowvol.dirty_tile_mask(pv[:, :t], layout)
                    for pv in points_v]))
        else:
            with tracing.span("k1"):
                shadow = rowvol.build_shadow_v(rv.geo, layout)
            new_carry = None
        with tracing.span("rowops.extract"):
            fv, fw = rowvol.extract_rows(shadow, cr, self.init_value,
                                         geometry.INVALID_TSDF_FILL)
            inputs = self._row_net_inputs(fv, fw, depth, sem_ids)
            ray_mask = (torch.where(frames["mask"], depth, 0.0).reshape(-1)
                        != 0.0)
        return cr, inputs, ray_mask, new_carry

    def _estimate_updates(self, cr, inputs, sem_ids, scores, ray_mask,
                          geo_dtype, do_sem=None) -> rowvol.RowUpdates:
        """FusionNet over the block's B frames, then the row updates of
        the clipped tail estimates (and with semantics the packed keys)."""
        t = self.n_tail_points
        est = self._network_estimate(inputs)
        with tracing.span("rowops.updates"):
            upd_values = torch.clamp(est[..., :t], -self.init_value,
                                     self.init_value).reshape(-1, t)
            sem_key = (pack_semantic_key(scores.reshape(-1),
                                         sem_ids.reshape(-1))
                       if self.semantics else None)
            return rowvol.row_updates(cr, upd_values, sem_key, ray_mask, t,
                                      geo_dtype, do_sem)

    def _integrate_estimate(self, rv: rowvol.RowVolume, cr, inputs, sem_ids,
                            scores, ray_mask, do_sem=None) -> None:
        """:meth:`_estimate_updates` into the slot state in place: one geo
        scatter-add, one key scatter-max."""
        upd = self._estimate_updates(cr, inputs, sem_ids, scores, ray_mask,
                                     rv.geo.dtype, do_sem)
        with tracing.span("rowops.scatter"):
            rowvol.scatter_updates(rv.geo.view(-1, 128),
                                   rv.key.view(-1, 128), upd)

    def step_fuse_rows_block_impl(self, layout, rv: rowvol.RowVolume, frames,
                                  shadow_carry=None, do_sem=None):
        """k-frame block step (``frames`` leaves lead with k). Every frame
        extracts against the same pre-block state (one shadow build); the
        nets run batched over the block; the block's rays integrate
        through one geo scatter-add and one key scatter-max. k = 1 is the
        exact per-frame step (the JAX package's ``step_fuse_rows_impl``).
        ``shadow_carry`` (prev_shadow, dirty) turns on the dirty rebuild.
        Returns ``(rv, new_carry)`` (carry None iff shadow_carry was)."""
        sem_ids, scores = (self._block_semantics(frames) if self.semantics
                           else (None, None))
        cr, _, _, inputs, ray_mask, new_carry = self._row_frontend(
            layout, rv, frames, sem_ids, shadow_carry)
        self._integrate_estimate(rv, cr, inputs, sem_ids, scores, ray_mask,
                                 do_sem)
        return rv, new_carry

    def step_fuse_rows_block_scenes(self, layout, rv: rowvol.RowVolume,
                                    frames, shadow_carry=None, do_sem=None):
        """:meth:`step_fuse_rows_block_impl` of S scenes (``frames``
        leaves lead with (S, k), ``rv`` holds (S, rows, 128) states): the
        nets run once over the S * k frames, the kernels once over the
        folded volume. Returns ``(rv, new_carry)``."""
        S, k = frames["depth"].shape[:2]
        sem_ids, scores = (self._block_semantics(
            {key: x.reshape((S * k,) + x.shape[2:])
             for key, x in frames.items()}) if self.semantics
            else (None, None))
        cr, inputs, ray_mask, new_carry = self._row_frontend_scenes(
            layout, rv, frames, sem_ids, shadow_carry)
        self._integrate_estimate(rv, cr, inputs, sem_ids, scores, ray_mask,
                                 do_sem)
        return rv, new_carry

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
        p, t = self.n_points, self.n_tail_points
        with torch.no_grad():
            sem_ids = (self._block_semantics(frame)[0]
                       if self.semantics and self.use_semantics else None)
            cr, fv, fw, inputs, ray_mask, new_carry = self._row_frontend(
                layout, rv, frame, sem_ids, shadow_carry)
            with tracing.span("rowops.extract"):
                gv, _ = rowvol.extract_rows(gt_shadow, cr, self.init_value,
                                            geometry.INVALID_TSDF_FILL)
        est = self._network_estimate(inputs, train=True)
        with tracing.span("train.loss"):
            loss = fusion_loss(_fused_for_loss(fv, fw, est, self.init_value),
                               gv[None, :, :p], ray_mask[None],
                               **self.loss_weights)
        with tracing.span("train.backward"):
            loss.backward()
        with torch.no_grad(), tracing.span("rowops.integrate"):
            upd_values = torch.clamp(est.detach()[0, :, :t], -self.init_value,
                                     self.init_value)
            geo, key = rowvol.integrate_rows(rv.geo, rv.key, cr, upd_values,
                                             None, ray_mask, t)
        return loss.detach(), rv._replace(geo=geo, key=key), new_carry

    # -- the per-frame step and the flat scalar path ---------------------------

    def _extract(self, depth, extrinsics, intrinsics, volume: SceneVolume):
        """Flat extraction of one (h, w) frame from the accumulator state
        (packed bf16 words or f32, SETTINGS.gather_precision)."""
        return geometry.extract_numw(
            depth, extrinsics, intrinsics, volume.num, volume.weights,
            volume.origin, volume.resolution, init_value=self.init_value,
            n_points=self.n_points, packed16=self.packed16_gather)

    def _extract_gt(self, depth, extrinsics, intrinsics, gt_tsdf,
                    volume: SceneVolume):
        """The gt extraction: the f32 gt value volume beside the estimate's
        weights."""
        return geometry.extract(depth, extrinsics, intrinsics, gt_tsdf,
                                volume.weights, volume.origin,
                                volume.resolution, n_points=self.n_points)

    def _volume_update_args(self, values: geometry.ExtractedValues,
                            tsdf_est, filtered_depth):
        """The first n_tail_points samples of each ray, clipped, and the
        rays with depth: (values, corner indices -- (lin, valid) from the
        packed extraction, else (n, t, 8, 3) -- corner weights, ray
        mask)."""
        t = self.n_tail_points
        upd_values = torch.clamp(tsdf_est[0, :, :t], -self.init_value,
                                 self.init_value)
        upd_weights = values.weights[:, :t]
        ray_mask = filtered_depth.reshape(-1) != 0.0
        if values.lin is not None:
            return (upd_values, (values.lin[:, :t], values.valid[:, :t]),
                    upd_weights, ray_mask)
        return upd_values, values.indices[:, :t], upd_weights, ray_mask

    @staticmethod
    def _integrate_geo(volume, upd_values, upd_idx, upd_weights, ray_mask):
        if isinstance(upd_idx, tuple):
            integ.integrate_numw_lin(volume.num, volume.weights, upd_values,
                                     *upd_idx, upd_weights, ray_mask)
        else:
            integ.integrate_numw(volume.num, volume.weights, upd_values,
                                 upd_idx, upd_weights, ray_mask)

    @staticmethod
    def _integrate_sem(volume, sem_ids, scores, upd_idx, ray_mask):
        if isinstance(upd_idx, tuple):
            integ.integrate_semkey_lin(volume.semkey, sem_ids, scores,
                                       *upd_idx, ray_mask)
        else:
            integ.integrate_semkey(volume.semkey, sem_ids, scores, upd_idx,
                                   ray_mask)

    def _frame_semantics(self, frame):
        """(sem_ids, scores), each (h*w,), of a 1-frame dict: the pre-pass
        values (run here where not attached) or the gt labels."""
        ids, scores = self._block_semantics(self._sem_prepass_frames(frame))
        return ids[0], scores[0]

    def _flat_frontend(self, volume: SceneVolume, frame, sem_ids):
        """(depth, masked depth, flat extraction, the net's inputs) of a
        1-frame dict."""
        depth = frame["depth"][0]
        filtered = torch.where(frame["mask"][0], depth, 0.0)
        values = self._extract(depth, frame["extrinsics"][0],
                               frame["intrinsics"][0], volume)
        inputs = _prepare_fusion_input(depth, values, sem_ids, self.n_points,
                                       self.n_classes, self.use_semantics)
        return depth, filtered, values, inputs

    @torch.no_grad()
    def step_fuse_impl(self, volume: SceneVolume, frame) -> SceneVolume:
        """One inference frame (``frame`` leaves lead with 1) of the
        canonical volume. Row path: enter slot form, one row step with a
        full shadow build (no carry), exit -- a new volume. Flat path:
        extract, FusionNet, then the scatter-add (and with semantics the
        key scatter-max) into ``volume`` in place, which is returned."""
        if self.row_path:
            layout, rv = self._rows_from_volume(volume)
            rv, _ = self.step_fuse_rows_block_impl(
                layout, rv, self._sem_prepass_frames(frame))
            return self._exit_rows(layout, rv)
        sem_ids, scores = (self._frame_semantics(frame) if self.semantics
                           else (None, None))
        depth, filtered, values, inputs = self._flat_frontend(volume, frame,
                                                              sem_ids)
        est = self._network_estimate(inputs)
        upd_values, upd_idx, upd_weights, ray_mask = \
            self._volume_update_args(values, est, filtered)
        self._integrate_geo(volume, upd_values, upd_idx, upd_weights,
                            ray_mask)
        if self.semantics:
            self._integrate_sem(volume, sem_ids, scores, upd_idx, ray_mask)
        return volume

    def step_train_impl(self, volume: SceneVolume, gt_tsdf: torch.Tensor,
                        frame) -> Tuple[torch.Tensor, SceneVolume]:
        """One training frame on the flat path (``frame`` leaves lead with
        1; the caller puts the net in train mode): the extraction and the
        f32 gt extraction without autograd, FusionNet, the fusion loss and
        its backward (the frame's gradients add into ``.grad``), then the
        detached, clipped estimate integrates into ``volume`` in place (no
        semantics: the reference trains with ``test=False``). Returns
        ``(loss, volume)``."""
        p = self.n_points
        with torch.no_grad():
            sem_ids = (self._frame_semantics(frame)[0]
                       if self.semantics and self.use_semantics else None)
            depth, filtered, values, inputs = self._flat_frontend(
                volume, frame, sem_ids)
            values_gt = self._extract_gt(depth, frame["extrinsics"][0],
                                         frame["intrinsics"][0], gt_tsdf,
                                         volume)
        est = self._network_estimate(inputs, train=True)
        ray_mask = filtered.reshape(-1) != 0.0
        loss = fusion_loss(_fused_for_loss(values.fusion_values,
                                           values.fusion_weights, est,
                                           self.init_value),
                           values_gt.fusion_values[None, :, :p],
                           ray_mask[None], **self.loss_weights)
        loss.backward()
        with torch.no_grad():
            self._integrate_geo(volume, *self._volume_update_args(
                values, est.detach(), filtered))
        return loss.detach(), volume

    @contextlib.contextmanager
    def _training(self):
        """The net in train mode (BatchNorm statistics move, dropout
        draws) under ``training_convolutions``; back in eval mode after."""
        self.fusion_net.train()
        try:
            with training_convolutions(self.fusion_net.compute_dtype,
                                       self.device):
                yield
        finally:
            self.fusion_net.eval()

    @staticmethod
    def _reset_volume(volume: SceneVolume) -> SceneVolume:
        """Zero the canonical state in place (a training reset)."""
        volume.num.zero_()
        volume.weights.zero_()
        volume.semkey.zero_()
        return volume

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
        return self._fuse_rows(layout, stream, frames,
                               self.step_fuse_rows_block_impl, 0)

    @torch.no_grad()
    def fuse_sequence_rows_scenes(self, layout, stream: RowStream,
                                  frames: Dict[str, torch.Tensor]
                                  ) -> RowStream:
        """:meth:`fuse_sequence_rows` of S scenes: ``stream`` carries
        (S, rows, 128) slot states, ``frames`` leaves lead with (S, T)."""
        return self._fuse_rows(layout, stream, frames,
                               self.step_fuse_rows_block_scenes, 1)

    def _fuse_rows(self, layout, stream: RowStream, frames, step,
                   axis: int) -> RowStream:
        """The block loop over time axis ``axis`` of ``frames``: one
        ``chunk`` span, a ``block`` span a block."""
        shape = frames["depth"].shape
        T = shape[axis]
        kb = self.frame_block
        with tracing.chunk(T * shape[0] if axis else T, kb):
            frames = self._sem_prepass_frames(frames)
            decimate = self.semantics and self.sem_every > 1
            pad = (-T) % kb
            if pad:
                frames = {key: torch.cat([x, x.narrow(axis, T - 1, 1).expand(
                    x.shape[:axis] + (pad,) + x.shape[axis + 1:])], axis)
                    for key, x in frames.items()}
                frames["mask"].narrow(axis, T, pad).fill_(False)
            for idx in range((T + pad) // kb):
                with tracing.block():
                    block = {key: x.narrow(axis, idx * kb, kb)
                             for key, x in frames.items()}
                    carry = (None if stream.shadow is None
                             else (stream.shadow, stream.dirty))
                    do_sem = (idx % self.sem_every == 0) if decimate else None
                    rv, carry = step(layout, stream.rv, block,
                                     shadow_carry=carry, do_sem=do_sem)
                    stream = (RowStream(rv, None, None) if carry is None
                              else RowStream(rv, carry[0], carry[1]))
        return stream

    def fuse_sequence(self, volume: SceneVolume, frames) -> SceneVolume:
        """Fuse a (T, ...) frame chunk into ``volume``: on the row path
        enter the slot form, stream, exit (a new volume); on the flat path
        one ``step_fuse_impl`` a frame, in place."""
        if not self.row_path:
            frames = self._sem_prepass_frames(frames)
            for i in range(frames["depth"].shape[0]):
                volume = self.step_fuse_impl(
                    volume, {k: x[i:i + 1] for k, x in frames.items()})
            return volume
        layout, rv = self._rows_from_volume(volume)
        stream = self.fuse_sequence_rows(layout, self._new_stream(layout, rv),
                                         frames)
        return self._exit_rows(layout, stream.rv)

    # -- scenes ----------------------------------------------------------------

    @torch.no_grad()
    def step_fuse_scenes(self, volumes: SceneVolume, frames) -> SceneVolume:
        """One inference frame of each of S stacked scenes (``frames``
        leaves lead with (S, 1)): ``jax.vmap`` of the JAX package's
        ``step_fuse_impl``. Row path: enter slot form, one folded row step
        with a full shadow build, exit -- new volumes. Flat path: each
        scene's extraction, FusionNet once over the S frames, then one
        scatter-add (and key scatter-max) into the stacked state in place
        through linear indices offset by ``s * X * Y * Z``."""
        if self.row_path:
            layout = rowvol.RowLayout.for_shape(tuple(volumes.num.shape[1:]))
            rv = self._enter_rows_scenes(layout, volumes)
            rv, _ = self.step_fuse_rows_block_scenes(
                layout, rv, self._sem_prepass_frames(frames))
            return self._exit_rows_scenes(layout, rv)
        frames = {k: x[:, 0] for k, x in frames.items()}   # S 1-frame dicts
        S = frames["depth"].shape[0]
        sem_ids, scores = (self._block_semantics(
            self._sem_prepass_frames(frames)) if self.semantics
            else (None, None))
        nvox = volumes.num[0].numel()
        per_scene, nets = [], []
        for s in range(S):
            vol = SceneVolume(num=volumes.num[s], weights=volumes.weights[s],
                              semkey=volumes.semkey[s],
                              origin=volumes.origin[s],
                              resolution=volumes.resolution[s],
                              init_value=volumes.init_value)
            depth, filtered, values, inputs = self._flat_frontend(
                vol, {k: x[s:s + 1] for k, x in frames.items()},
                None if sem_ids is None else sem_ids[s])
            per_scene.append((values, filtered))
            nets.append(inputs)
        est = self._network_estimate({k: torch.cat([i[k] for i in nets])
                                      for k in nets[0]})
        parts = []
        for s, (values, filtered) in enumerate(per_scene):
            upd_values, upd_idx, upd_weights, ray_mask = \
                self._volume_update_args(values, est[s:s + 1], filtered)
            if isinstance(upd_idx, tuple):
                lin, valid = upd_idx
            else:
                shape = tuple(volumes.num.shape[1:])
                valid = geometry.valid_index_mask(upd_idx, shape)
                lin = geometry._flatten_index(
                    geometry.clamp_indices(upd_idx, shape), shape)
            parts.append((upd_values, lin + s * nvox, valid, upd_weights,
                          ray_mask))
        upd_values, lin, valid, upd_weights, ray_mask = (
            torch.cat(a) for a in zip(*parts))
        integ.integrate_numw_lin(volumes.num, volumes.weights, upd_values,
                                 lin, valid, upd_weights, ray_mask)
        if self.semantics:
            integ.integrate_semkey_lin(volumes.semkey, sem_ids.reshape(-1),
                                       scores.reshape(-1), lin, valid,
                                       ray_mask)
        return volumes

    def fuse_sequence_scenes(self, volumes: SceneVolume, frames
                             ) -> SceneVolume:
        """Fuse S stacked scenes' (S, T, ...) frame chunks: ``jax.vmap`` of
        the JAX package's ``fuse_sequence_impl``. Row path: enter, stream
        through :meth:`fuse_sequence_rows_scenes`, exit (new volumes);
        flat path: one :meth:`step_fuse_scenes` a frame, in place."""
        if not self.row_path:
            frames = self._sem_prepass_frames(frames)
            for i in range(frames["depth"].shape[1]):
                volumes = self.step_fuse_scenes(
                    volumes, {k: x[:, i:i + 1] for k, x in frames.items()})
            return volumes
        layout = rowvol.RowLayout.for_shape(tuple(volumes.num.shape[1:]))
        rv = self._enter_rows_scenes(layout, volumes)
        stream = self.fuse_sequence_rows_scenes(
            layout, self._new_stream(layout, rv), frames)
        return self._exit_rows_scenes(layout, stream.rv)

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
        T = frames["depth"].shape[0]
        with tracing.chunk(T):
            if self.use_semantics:
                with torch.no_grad():
                    frames = self._sem_prepass_frames(frames)
            loss_sum = torch.zeros((), device=self.device)
            with self._training():
                for i in range(T):
                    with tracing.span("train.frame"):
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
        return loss_sum, stream

    def train_sequence(self, volume: SceneVolume, gt_tsdf: torch.Tensor,
                       frames, reset_flags) -> Tuple[torch.Tensor,
                                                     SceneVolume]:
        """:meth:`train_sequence_rows` from and to a canonical volume:
        enter the slot form, pack the gt shadow, train, exit. On the flat
        path one ``step_train_impl`` a frame into ``volume``, in place, a
        set ``reset_flags`` entry zeroing it first. Returns ``(loss_sum,
        volume)``."""
        if not self.row_path:
            if self.use_semantics:
                with torch.no_grad():
                    frames = self._sem_prepass_frames(frames)
            loss_sum = torch.zeros((), device=self.device)
            with self._training():
                for i in range(frames["depth"].shape[0]):
                    if bool(reset_flags[i]):
                        volume = self._reset_volume(volume)
                    loss, volume = self.step_train_impl(
                        volume, gt_tsdf,
                        {k: x[i:i + 1] for k, x in frames.items()})
                    loss_sum = loss_sum + loss
            return loss_sum, volume
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

    def fuse(self, batch, database):
        """One host batch (one frame) into ``database`` through
        :meth:`step_fuse_impl` (the reference's per-frame API: on the row
        path each call pays the enter and exit conversions; streams go
        through :meth:`fuse_many`)."""
        scene_id = self._scene_of(batch)
        frame = self._stack_host_frames([self._frame_from_batch(
            batch, self.config.DATA.input)])
        database.update(scene_id, self.step_fuse_impl(
            database.volumes[scene_id], frame))

    def fuse_training(self, batch, database) -> torch.Tensor:
        """One training frame on the flat path (:meth:`step_train_impl`)
        against ``database``'s gt, the net in train mode: its gradients
        add into ``.grad`` (the caller zeroes them and steps the
        optimizer), its BatchNorm statistics move, and the scene's volume
        integrates the estimate. Returns the loss."""
        scene_id = self._scene_of(batch)
        frame = self._stack_host_frames([self._frame_from_batch(
            batch, self.config.DATA.input)])
        with self._training():
            loss, volume = self.step_train_impl(
                database.volumes[scene_id], database.scenes_gt[scene_id],
                frame)
        database.update(scene_id, volume)
        return loss

    def fuse_many(self, batches, database, chunk: int = 16,
                  max_live_scenes: Optional[int] = None):
        """Stream host batches through chunked ``fuse_sequence_rows``
        calls, buffering frames per scene (interleaved scene orders keep
        whole chunks); each chunk is tail-padded with all-masked no-op
        frames. A scene's slot state is carried across its chunks and
        written back to ``database`` once, when it is evicted (at most
        ``max_live_scenes`` carried at a time, default
        SETTINGS.max_live_row_scenes, else 1) or at the end. On the flat
        path each chunk goes through ``fuse_sequence`` into the database's
        volume."""
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
            if not self.row_path:
                database.update(scene_id, self.fuse_sequence(
                    database.volumes[scene_id], stacked))
                return
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
