"""Online fusion training for the port.

    python -m segfusion_tpu_torch.train_fusion --config configs/fusion/<name>.yaml [--device cpu] [--comment TEXT]

Counterpart of the JAX package's ``train_fusion.py`` (the reference's
paper loop): the training frames stream through chunks of
``accumulation_steps`` frames per scene, each chunk one
``Pipeline.train_sequence_rows`` call over the scene's carried slot state
and its cached gt shadow (a short last chunk is padded with all-masked
frames), then one optimizer update (global-norm clipping, the scheduled
rate). Trajectory resets (hybrid loading) and random resets zero a scene
before the frame. Every ``eval_freq`` frames and at the end of an epoch
the carried states are reconciled into the training Database and
evaluated, the validation split is fused through ``fuse_many``,
filtered and evaluated, and ``model/best.ckpt`` / ``model/last.ckpt``
are written in the JAX package's Flax format (last with the optimizer
state, in optax's layout). Runs on the card (``--device cuda``, the
default) or, where the caller names it, on the CPU; callers that build
the config in Python (the card's machine has no PyYAML) call
:func:`train_fusion`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .config import get_data_config, with_defaults
from .core.database import Database
from .core.pipeline import Pipeline
from .data import PrefetchLoader, get_data
from .device import resolve_device
from .models import seeded_init
from .models.fusionnet import build_fusion_net
from .ops import rowvol
from .utils.checkpoints import load_checkpoint
from .utils.convert import (fusionnet_from_checkpoint, load_flax,
                            segmenter_from_checkpoint, to_flax)
from .utils.optim import get_optimizer
from .utils.schedulers import get_schedule
from .utils.workspace import get_workspace

__all__ = ["train_fusion"]


def _fusion_net(config):
    """FUSION_MODEL.pretrained loaded, else random weights from
    SETTINGS.seed."""
    if config.FUSION_MODEL.get("pretrained"):
        return fusionnet_from_checkpoint(config.FUSION_MODEL.pretrained,
                                         config.FUSION_MODEL)
    return seeded_init(build_fusion_net(config.FUSION_MODEL),
                       torch.Generator().manual_seed(
                           int(config.SETTINGS.seed or 0)))


def _segmenter(config, device):
    if not (config.DATA.semantics
            and config.DATA.semantic_strategy == "predict"):
        return None
    return segmenter_from_checkpoint(config.TESTING.semantic_2d_model_path,
                                     config.SEMANTIC_2D_MODEL,
                                     config.DATA.input, device)


def train_fusion(config, device="cuda", comment: str = ""):
    """Train FusionNet online over the training split of ``config`` (the
    JAX package's schema; missing keys take the port's defaults, filled
    in place). Returns ``(fusion_net, workspace)``."""
    with_defaults(config)
    device = resolve_device(device)
    training = config.TRAINING
    opt_cfg = training.optimization
    if not opt_cfg.get("use_sequence", True):
        raise NotImplementedError(
            "TRAINING.optimization.use_sequence false (the flat scalar "
            "training path) is not ported (ROADMAP Queue 1 #5)")
    seed = int(config.SETTINGS.seed or 0)
    draws = np.random.RandomState(seed)       # random resets

    workspace = get_workspace(config)
    workspace.log(f"comment: {comment}", "train")
    train_cfg = get_data_config(config, "train")
    val_cfg = get_data_config(config, "val")
    train_dataset = get_data(config.DATA.dataset, train_cfg, device=device)
    val_dataset = get_data(config.DATA.dataset, val_cfg, device=device)
    train_loader = PrefetchLoader(train_dataset,
                                  batch_size=training.train_batch_size,
                                  shuffle=training.train_shuffle,
                                  num_workers=config.SETTINGS.num_workers)
    val_loader = PrefetchLoader(val_dataset,
                                batch_size=training.val_batch_size,
                                shuffle=training.val_shuffle,
                                num_workers=config.SETTINGS.num_workers)
    train_database = Database(train_dataset, train_cfg, device=device)
    val_database = Database(val_dataset, val_cfg, device=device)

    pipeline = Pipeline(config, segmenter=_segmenter(config, device),
                        fusion_net=_fusion_net(config), device=device,
                        train=True)
    net = pipeline.fusion_net
    workspace.log(f"Fusion Parameters: "
                  f"{sum(p.numel() for p in net.parameters())}", "train")
    optimizer = get_optimizer(
        training.optimizer, net,
        get_schedule(float(training.optimizer.lr), training.scheduler),
        clipping=bool(opt_cfg.clipping))
    accum = int(opt_cfg.accumulation_steps or 1)

    start_epoch, best_iou = 0, 0.0
    if training.resume:
        ck = load_checkpoint(training.resume)
        load_flax(net, ck["params"], ck["batch_stats"])
        optimizer.load_state_dict_flax(ck["opt_state"])
        start_epoch = int(ck.get("epoch", 0))
        best_iou = float(ck.get("best_iou", 0.0))
        workspace.log(f"resumed from {training.resume} at epoch "
                      f"{start_epoch}", "train")

    n_batches = len(train_loader)
    eval_freq = int(config.SETTINGS.eval_freq)
    log_freq = int(config.SETTINGS.log_freq)

    # per scene: the carried slot state and the packed gt shadow (the
    # canonical <-> slot conversions are paid once per scene and at
    # evaluations, not per chunk)
    rowstate, gt_shadows = {}, {}

    def train_rowstate(scene_id):
        if scene_id not in rowstate:
            vol = train_database.volumes[scene_id]
            layout = rowvol.RowLayout.for_shape(tuple(vol.num.shape))
            rowstate[scene_id] = (layout, pipeline._new_stream(
                layout, pipeline._enter_rows(layout, vol)))
            if scene_id not in gt_shadows:
                gt_shadows[scene_id] = pipeline._gt_shadow(
                    layout, train_database.scenes_gt[scene_id])
        return rowstate[scene_id]

    def reset_flag_for(frame_id: str, i: int) -> bool:
        flag = (frame_id.rsplit("/", 1)[-1] == "0"
                and config.DATA.get("data_load_strategy") == "hybrid")
        if (opt_cfg.reset_strategy
                and draws.random_sample() <= opt_cfg.reset_prob):
            workspace.log(f"Random reset of scene "
                          f"{frame_id.split('/', 1)[0]} at step {i}", "train")
            flag = True
        return flag

    for epoch in range(start_epoch, int(training.n_epochs)):
        workspace.log(f"Training epoch {epoch}/{training.n_epochs}", "train")
        train_database.reset()
        val_database.reset()
        rowstate.clear()
        train_loss = 0.0
        chunk_frames, chunk_resets, chunk_scene = [], [], None

        def flush_chunk():
            """One accumulated chunk through train_sequence_rows, then one
            optimizer update."""
            nonlocal train_loss, chunk_frames, chunk_resets
            if not chunk_frames:
                return
            frames, resets = list(chunk_frames), list(chunk_resets)
            if len(frames) < accum:   # no-op frames: mask all False
                pad = dict(frames[-1], mask=np.zeros_like(frames[-1]["mask"]))
                resets += [False] * (accum - len(frames))
                frames += [pad] * (accum - len(frames))
            layout, stream = train_rowstate(chunk_scene)
            optimizer.zero_grad()
            loss_sum, stream = pipeline.train_sequence_rows(
                layout, stream, gt_shadows[chunk_scene],
                pipeline._stack_host_frames(frames), resets)
            rowstate[chunk_scene] = (layout, stream)
            optimizer.step()
            train_loss += float(loss_sum)
            chunk_frames, chunk_resets = [], []

        for i, batch in enumerate(train_loader):
            if not np.all(np.isfinite(np.asarray(batch["extrinsics"]))):
                continue
            frame_id = batch["frame_id"][0]
            scene_id = frame_id.split("/", 1)[0]
            if chunk_scene is not None and scene_id != chunk_scene:
                flush_chunk()
            chunk_scene = scene_id
            chunk_frames.append(pipeline._frame_from_batch(
                batch, config.DATA.input))
            chunk_resets.append(reset_flag_for(frame_id, i))
            if len(chunk_frames) == accum:
                flush_chunk()

            if (i + 1) % log_freq == 0:
                workspace.add_scalar("Train/loss", train_loss / log_freq,
                                     i + 1 + epoch * n_batches)
                workspace.log(f"step {i + 1}: loss "
                              f"{train_loss / log_freq:.6f}", "train")
                train_loss = 0.0

            if (i + 1) % eval_freq == 0 or i == n_batches - 1:
                flush_chunk()       # apply pending grads before evaluating
                for sid, (layout, stream) in rowstate.items():
                    train_database.update(sid, pipeline._peek_rows(
                        layout, stream.rv))
                step = i + 1 + epoch * n_batches
                train_eval = train_database.evaluate("train", workspace)
                for k in ("mse", "acc", "iou", "mad"):
                    workspace.add_scalar(f"Train/{k}", train_eval.get(k, 0),
                                         step)

                val_database.reset()
                pipeline.fuse_many(val_loader, val_database)
                val_database.filter(value=0.5)
                val_eval = val_database.evaluate("val", workspace)
                for k in ("mse", "acc", "iou", "mad"):
                    workspace.add_scalar(f"Val/{k}", val_eval.get(k, 0), step)

                params, batch_stats = to_flax(net)
                score = (val_eval.get("iou", 0) + val_eval.get("acc", 0)) / 2
                if score >= best_iou:
                    best_iou = score
                    workspace.log(f"Found new best model with score "
                                  f"{best_iou:.4f} at epoch {epoch}", "val")
                    val_database.save_to_workspace(
                        workspace, mode="best_val",
                        save_mode=config.SETTINGS.save_mode)
                    workspace.save_model_state(
                        {"epoch": epoch + 1, "params": params,
                         "batch_stats": batch_stats, "best_iou": best_iou},
                        is_best=True)
                val_database.save_to_workspace(
                    workspace, mode="latest_val",
                    save_mode=config.SETTINGS.save_mode)
                workspace.save_model_state(
                    {"epoch": epoch + 1, "params": params,
                     "batch_stats": batch_stats,
                     "opt_state": optimizer.state_dict_flax(),
                     "best_iou": best_iou}, is_best=False)
    return net, workspace


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--comment", type=str, default="")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to run (default: cuda; cpu runs the "
                             "kernels' plain versions)")
    args = parser.parse_args(argv)
    from .config import load_config
    train_fusion(load_config(args.config), device=args.device,
                 comment=args.comment)


if __name__ == "__main__":
    main()
