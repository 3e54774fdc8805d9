"""AdapNet++ segmentation training for the port.

    python -m segfusion_tpu_torch.train_segmentation --config configs/segmentation/<name>.yaml [--device cpu] [--comment TEXT]

Counterpart of the JAX package's ``train_segmentation.py``: stage 1 on one
modality (DATA.input) or stage 2 on the image and DATA.input, its
encoders and eASPP modules transplanted from stage-1 rgb and tof
checkpoints (SEMANTIC_2D_MODEL.pretrained_rgb / pretrained_tof); an
ImageNet ResNet-50 state dict into the encoder(s) (pretrained_encoder)
and a whole checkpoint (pretrained); random modality masking in stage 2
(TRAINING.optimization.random_mask, drawn from ``RandomState(seed)``:
the JAX trainer draws the same sequence from the global numpy generator
seeded alike); the loss ``1.0 CE(res) + 0.6 CE(aux1) + 0.5 CE(aux2)``
with label 0 ignored (as the JAX trainer, whatever TRAINING.loss names,
and without optimizer.nesterov); the optimizer and schedule of
``utils/optim.py`` / ``utils/schedulers.py``; per epoch a RunningScore
validation and ``model/best.ckpt`` (best mean IoU) / ``model/last.ckpt``
(with the optimizer state in optax's layout), in the JAX package's Flax
format. The net keeps f32 master weights and computes in
SEMANTIC_2D_MODEL.compute_dtype. Runs on the card (``--device cuda``,
the default) or, where the caller names it, on the CPU; callers that
build the config in Python call :func:`train_segmentation`.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np
import torch

from .config import get_data_config, with_defaults
from .data import PrefetchLoader, get_data
from .device import resolve_device
from .models import seeded_init
from .models.adapnet import AdapNet, build_adapnet
from .utils.checkpoints import load_checkpoint, restore_into
from .utils.convert import load_flax, to_flax
from .utils.losses import cross_entropy
from .utils.metrics import RunningScore
from .utils.optim import get_optimizer
from .utils.schedulers import get_schedule
from .utils.torch_import import (convert_resnet50_encoder,
                                 load_torch_checkpoint)
from .utils.workspace import get_workspace

__all__ = ["train_segmentation", "prepare_input_data", "predict",
           "evaluate", "new_adapnet", "load_weights", "LOSS_WEIGHTS"]

LOSS_WEIGHTS = (1.0, 0.6, 0.5)      # res, aux1, aux2 (the reference's)


def prepare_input_data(batch, config, device):
    """A batch dict -> (inputs, labels): "image" scaled to [0, 1] and
    DATA.input (a depth) repeated to 3 channels, NCHW float32 on
    ``device``; the DATA.target_key labels as int64 (B, H, W)."""
    inputs = {"image": torch.as_tensor(
        np.asarray(batch["image"], np.float32), device=device)
        .permute(0, 3, 1, 2) / 255.0}
    in_key = config.DATA.input
    if in_key != "image":
        d = torch.as_tensor(np.asarray(batch[in_key], np.float32),
                            device=device)
        inputs[in_key] = d[:, None].expand(-1, 3, -1, -1)
    target = torch.as_tensor(np.asarray(batch[config.DATA.target_key]),
                             device=device).long()
    return inputs, target


def _modalities(model: AdapNet, inputs, in_key: str):
    if model.stage == 1:
        return (inputs[in_key],)
    return inputs["image"], inputs[in_key]


@torch.no_grad()
def predict(model: AdapNet, inputs, in_key: str) -> torch.Tensor:
    """The per-pixel argmax of ``res`` at inference, (B, H, W)."""
    return model.logits(*_modalities(model, inputs, in_key)).argmax(1)


def evaluate(model: AdapNet, loader, config, device) -> dict:
    """RunningScore's metrics (label 0 ignored) of ``model`` at inference
    over ``loader``."""
    model.eval()
    score = RunningScore(int(config.SEMANTIC_2D_MODEL.n_classes),
                         ignore_index=0)
    for batch in loader:
        inputs, target = prepare_input_data(batch, config, device)
        score.update(target.cpu().numpy(),
                     predict(model, inputs, config.DATA.input).cpu().numpy())
    return score.get_scores()[0]


def new_adapnet(model_cfg, seed: int) -> AdapNet:
    """An AdapNet from the SEMANTIC_2D_MODEL section with random weights
    from ``seed`` (f32; its compute dtype from the section)."""
    return seeded_init(build_adapnet(model_cfg),
                       torch.Generator().manual_seed(seed))


def load_weights(model: AdapNet, path: str):
    """A segmentation checkpoint's params (and batch_stats, where it has
    them) into ``model``: every leaf of the model's, shape-checked."""
    ck = load_checkpoint(path)
    params, stats = to_flax(model)
    load_flax(model, restore_into(params, ck["params"]),
              restore_into(stats, ck.get("batch_stats", stats)))


def _initial_weights(model: AdapNet, model_cfg, workspace):
    """The transplant, the ImageNet import and the checkpoint of
    SEMANTIC_2D_MODEL, in the JAX trainer's order, into ``model``."""
    if (model.stage == 2 and model_cfg.get("pretrained_rgb")
            and model_cfg.get("pretrained_tof")):
        params, stats = to_flax(model)
        rgb = load_checkpoint(model_cfg.pretrained_rgb)["params"]
        tof = load_checkpoint(model_cfg.pretrained_tof)["params"]
        for dst, src, key in (("encoder_mod1", rgb, "encoder_mod1"),
                              ("eASPP_mod1", rgb, "eASPP"),
                              ("encoder_mod2", tof, "encoder_mod1"),
                              ("eASPP_mod2", tof, "eASPP")):
            params[dst] = restore_into(params[dst], src[key])
        load_flax(model, params, stats)
        workspace.log("transplanted stage-1 rgb+tof encoders", "train")
    if model_cfg.get("pretrained_encoder"):
        encoders = (("encoder_mod1",) if model.stage == 1
                    else ("encoder_mod1", "encoder_mod2"))
        n = convert_resnet50_encoder(
            load_torch_checkpoint(model_cfg.pretrained_encoder), model,
            encoders)
        workspace.log(f"imported {n} ImageNet resnet50 arrays into "
                      f"{', '.join(encoders)}", "train")
    if model_cfg.get("pretrained"):
        load_weights(model, model_cfg.pretrained)


def train_segmentation(config, device="cuda", comment: str = ""):
    """Train AdapNet++ over the training split of ``config`` (the JAX
    package's schema; missing keys take the port's defaults, filled in
    place). Returns ``(model, workspace, history)``; ``history`` holds
    per epoch the mean training loss, the training seconds (synchronised
    at the epoch's end), the steps and the validation metrics."""
    with_defaults(config)
    device = resolve_device(device)
    seed = int(config.SETTINGS.seed or 0)
    masks = np.random.RandomState(seed)        # random modality masking
    training = config.TRAINING
    model_cfg = config.SEMANTIC_2D_MODEL
    in_key = config.DATA.input

    workspace = get_workspace(config)
    workspace.log(f"comment: {comment}", "train")
    train_dataset = get_data(config.DATA.dataset,
                             get_data_config(config, "train"), device=device)
    val_dataset = get_data(config.DATA.dataset,
                           get_data_config(config, "val"), device=device)
    train_loader = PrefetchLoader(train_dataset,
                                  batch_size=training.train_batch_size,
                                  shuffle=training.train_shuffle,
                                  num_workers=config.SETTINGS.num_workers,
                                  seed=seed, drop_last=True)
    val_loader = PrefetchLoader(val_dataset,
                                batch_size=training.val_batch_size,
                                shuffle=False,
                                num_workers=config.SETTINGS.num_workers)

    model = new_adapnet(model_cfg, seed)
    _initial_weights(model, model_cfg, workspace)
    model.to(device)
    model.set_dropout_generator(
        torch.Generator(device=device).manual_seed(seed))
    optimizer = get_optimizer(
        training.optimizer, model,
        get_schedule(float(training.optimizer.lr), training.scheduler))
    workspace.log(f"data-parallel over 1 device ({device}); the JAX "
                  "package's mesh of one device", "train")
    workspace.log(f"AdapNet++ stage {model.stage} parameters: "
                  f"{sum(p.numel() for p in model.parameters())}", "train")

    mask_cfg = training.get("optimization") or {}
    best_miou = 0.0
    n_train_batches = max(len(train_loader), 1)
    history: Dict[str, List] = {"train_loss": [], "train_seconds": [],
                                "steps": [], "val": []}

    for epoch in range(int(training.n_epochs)):
        model.train()
        t0 = time.perf_counter()
        loss_sum = torch.zeros((), device=device)
        steps = 0
        for batch in train_loader:
            inputs, target = prepare_input_data(batch, config, device)
            if model.stage == 2 and mask_cfg.get("random_mask"):
                p_mask = float(mask_cfg.get("mask_prob", 0.1))
                if masks.random_sample() <= p_mask:
                    inputs["image"] = torch.zeros_like(inputs["image"])
                elif masks.random_sample() <= p_mask:
                    inputs[in_key] = torch.zeros_like(inputs[in_key])
            optimizer.zero_grad()
            outs = model(*_modalities(model, inputs, in_key))
            loss = sum(lw * cross_entropy(o.permute(0, 2, 3, 1), target,
                                          ignore_index=0)
                       for lw, o in zip(LOSS_WEIGHTS, outs))
            loss.backward()
            optimizer.step()
            loss_sum += loss.detach()
            steps += 1
        train_loss = float(loss_sum) / n_train_batches
        history["train_seconds"].append(time.perf_counter() - t0)
        history["train_loss"].append(train_loss)
        history["steps"].append(steps)
        workspace.log(f"Epoch {epoch} Training Loss {train_loss:.5f}",
                      "train")
        workspace.add_scalar("Train/loss_t", train_loss, epoch)

        metrics = evaluate(model, val_loader, config, device)
        history["val"].append(metrics)
        for k, v in metrics.items():
            workspace.add_scalar(f"Val/{k.replace(' ', '_')}", v, epoch)
        workspace.log(f"Epoch {epoch} Val {metrics}", "val")

        params, batch_stats = to_flax(model)
        if metrics["Mean IoU"] >= best_miou:
            best_miou = metrics["Mean IoU"]
            workspace.log(f"New best mIoU {best_miou:.4f} at epoch {epoch}",
                          "val")
            workspace.save_model_state(
                {"epoch": epoch + 1, "params": params,
                 "batch_stats": batch_stats, "best_miou": best_miou},
                is_best=True)
        workspace.save_model_state(
            {"epoch": epoch + 1, "params": params,
             "batch_stats": batch_stats,
             "opt_state": optimizer.state_dict_flax(),
             "best_miou": best_miou}, is_best=False)
    return model, workspace, history


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--comment", type=str, default="")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to run (default: cuda)")
    args = parser.parse_args(argv)
    from .config import load_config
    train_segmentation(load_config(args.config), device=args.device,
                       comment=args.comment)


if __name__ == "__main__":
    main()
