"""2D segmentation evaluation for the port.

    python -m segfusion_tpu_torch.test_segmentation --config configs/segmentation/<name>.yaml [--device cpu]

Counterpart of the JAX package's ``test_segmentation.py``: the AdapNet++
of TESTING.semantic_2d_model_path (else SEMANTIC_2D_MODEL.pretrained;
else random weights from seed 0) over the test split, RunningScore's
metrics (label 0 ignored) and per-class IoU logged, ScanNet-benchmark
predictions where TESTING.output_benchmark is set and the dataset writes
them, and for the first TESTING.n_visualizations batches an input | depth
| gt | estimate strip written as ``output/vis/<i>.png`` (the port's own
PNG writer). Runs on the card
(``--device cuda``, the default) or, where the caller names it, on the
CPU; callers that build the config in Python call
:func:`test_segmentation`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .config import get_data_config, with_defaults
from .data import PrefetchLoader, get_data
from .device import resolve_device
from .train_segmentation import (load_weights, new_adapnet, predict,
                                 prepare_input_data)
from .utils.mapping import get_mapping
from .utils.metrics import RunningScore
from .utils.png import write_png
from .utils.workspace import get_workspace

__all__ = ["test_segmentation", "strip"]


def strip(image, depth, gt, est, palette) -> np.ndarray:
    """The input | depth | gt | estimate strip of one frame, (H, 4W, 3)
    uint8: the image stretched to 0..255, the depth over its maximum in
    gray (zeros where the input is the image), the labels coloured by
    ``palette``."""
    img = np.asarray(image, np.float32)
    img = np.clip(img - img.min(), 0, None)
    img = (img / max(img.max(), 1e-6) * 255).astype(np.uint8)
    dep = (np.zeros(img.shape[:2]) if depth is None
           else np.asarray(depth, np.float32))
    dep = (np.clip(dep / max(dep.max(), 1e-6), 0, 1) * 255).astype(np.uint8)
    dep = np.stack([dep] * 3, axis=-1)
    return np.concatenate([img, dep, palette[gt], palette[est]], axis=1)


def test_segmentation(config, device="cuda"):
    """Evaluate the segmenter on the test split of ``config`` (missing
    keys take the port's defaults, filled in place); returns the metrics
    dict."""
    with_defaults(config)
    device = resolve_device(device)
    model_cfg = config.SEMANTIC_2D_MODEL
    in_key = config.DATA.input
    testing = config.TESTING
    workspace = get_workspace(config)
    dataset = get_data(config.DATA.dataset, get_data_config(config, "test"),
                       device=device)
    loader = PrefetchLoader(dataset, batch_size=testing.test_batch_size,
                            shuffle=False,
                            num_workers=config.SETTINGS.num_workers)

    model = new_adapnet(model_cfg, 0)
    ckpt_path = (testing.get("semantic_2d_model_path")
                 or model_cfg.get("pretrained"))
    if ckpt_path:
        load_weights(model, ckpt_path)
        workspace.log(f"loaded {ckpt_path}", "test")
    else:
        workspace.log("WARNING: no segmentation checkpoint given -- "
                      "random weights", "test")
    model.to(device).eval()

    score = RunningScore(int(model_cfg.n_classes), ignore_index=0)
    palette = get_mapping()
    vis_dir = os.path.join(workspace.output_path, "vis")
    os.makedirs(vis_dir, exist_ok=True)
    n_vis = int(testing.n_visualizations)
    for i, batch in enumerate(loader):
        inputs, _ = prepare_input_data(batch, config, device)
        target = np.asarray(batch["semantic_gt"])
        pred = predict(model, inputs, in_key).cpu().numpy()
        score.update(target, pred)
        if testing.output_benchmark and hasattr(dataset, "output_test"):
            dataset.output_test(os.path.join(workspace.output_path,
                                             "benchmark"),
                                batch["frame_id"][0], pred[0])
        if i < n_vis:
            depth = (np.asarray(batch[in_key])[0] if in_key != "image"
                     else None)
            write_png(os.path.join(vis_dir, f"{i:04d}.png"),
                      strip(np.asarray(batch["image"])[0], depth,
                            target[0], pred[0], palette))

    metrics, cls_iou = score.get_scores()
    workspace.log("--- 2D segmentation metrics ---", "test")
    for k, v in metrics.items():
        workspace.log(f"{k}: {v}", "test")
    workspace.log("--- per-class IoU ---", "test")
    for c, v in cls_iou.items():
        workspace.log(f"class {c}: {v}", "test")
    return metrics


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to run (default: cuda)")
    args = parser.parse_args(argv)
    from .config import load_config
    test_segmentation(load_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
