"""Segmentation-training quality demo for the port.

    python -m segfusion_tpu_torch.seg_quality_demo [--config configs/segmentation/synthetic_tpu_demo.yaml] [--device cpu] [--skip-train]

Counterpart of ``tools/run_seg_quality_demo.py``: train the config
(stage-1 AdapNet++ on rendered synthetic depth) with
:func:`~segfusion_tpu_torch.train_segmentation.train_segmentation`, then
report the validation mIoU on an unseen synthetic scene (a seed past the
training scenes': DATA.seed + n_scenes + 100) for the trained best.ckpt
against a random initialisation (seed 7). ``--skip-train`` takes the
newest best.ckpt under SETTINGS.experiment_path instead.
"""

from __future__ import annotations

import argparse
import copy
import glob
import os

from .config import get_data_config, with_defaults
from .data import PrefetchLoader, get_data
from .device import resolve_device
from .train_segmentation import (evaluate, load_weights, new_adapnet,
                                 train_segmentation)

__all__ = ["seg_quality_demo"]

DEFAULT_CONFIG = "configs/segmentation/synthetic_tpu_demo.yaml"


def seg_quality_demo(config, device="cuda", skip_train: bool = False):
    """(random-init metrics, trained metrics, the checkpoint) on the
    unseen scene; the table printed."""
    with_defaults(config)
    device = resolve_device(device)
    val_cfg = get_data_config(config, "val")
    val_cfg.seed = (int(config.DATA.get("seed", 0))
                    + int(config.DATA.get("n_scenes", 1)) + 100)
    val_cfg.n_scenes = 1
    loader = PrefetchLoader(get_data(config.DATA.dataset, val_cfg,
                                     device=device),
                            batch_size=int(config.TRAINING.val_batch_size),
                            shuffle=False, num_workers=0)

    rand = evaluate(new_adapnet(config.SEMANTIC_2D_MODEL, 7).to(device),
                    loader, config, device)
    print(f"random init: {rand}", flush=True)
    if skip_train:
        found = sorted(glob.glob(os.path.join(
            config.SETTINGS.experiment_path, "*", "model", "best.ckpt")))
        if not found:
            raise FileNotFoundError(f"no best.ckpt under "
                                    f"{config.SETTINGS.experiment_path}")
        ckpt = found[-1]
    else:
        _, ws, _ = train_segmentation(copy.deepcopy(config), device,
                                      comment="seg quality demo")
        ckpt = os.path.join(ws.model_path, "best.ckpt")
    print(f"using checkpoint {ckpt}", flush=True)
    model = new_adapnet(config.SEMANTIC_2D_MODEL, 7)
    load_weights(model, ckpt)
    trained = evaluate(model.to(device), loader, config, device)
    print(f"trained: {trained}", flush=True)

    print("\n| weights | val mIoU (unseen scene) | pixel acc |")
    print("|---|---|---|")
    for label, m in (("random init", rand), ("trained", trained)):
        print(f"| {label} | {m['Mean IoU']:.4f} | {m['Acc']:.4f} |")
    return rand, trained, ckpt


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to run (default: cuda)")
    parser.add_argument("--skip-train", action="store_true",
                        help="reuse the newest best.ckpt under the "
                             "experiment path")
    args = parser.parse_args(argv)
    from .config import load_config
    seg_quality_demo(load_config(args.config), args.device, args.skip_train)


if __name__ == "__main__":
    main()
