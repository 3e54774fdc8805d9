"""Joint-accuracy quality demo for the port.

    python -m segfusion_tpu_torch.quality_demo [--config configs/fusion/synthetic_tpu_demo_joint.yaml] [--device cpu] [--skip-train]

Counterpart of ``tools/run_quality_demo.py``: train FusionNet online on
the config with :func:`~segfusion_tpu_torch.train_fusion.train_fusion`,
then evaluate the trained best.ckpt and random weights with
:func:`~segfusion_tpu_torch.test_fusion.test_fusion` (outlier and label
median filters, TSDF metrics, mesh F-score, 3-D semantic mIoU) and print
both side by side, then as one JSON line. ``--skip-train`` takes the
newest checkpoint under SETTINGS.experiment_path instead.
"""

from __future__ import annotations

import argparse
import copy
import glob
import json
import os

from .config import with_defaults
from .test_fusion import test_fusion
from .train_fusion import train_fusion

__all__ = ["quality_demo"]

DEFAULT_CONFIG = "configs/fusion/synthetic_tpu_demo_joint.yaml"


def _newest_checkpoint(path: str) -> str:
    for name in ("best.ckpt", "*.ckpt"):
        found = sorted(glob.glob(os.path.join(path, "*", "model", name)))
        if found:
            return found[-1]
    raise FileNotFoundError(f"no checkpoint under {path}")


def quality_demo(config, device="cuda", skip_train: bool = False):
    """(trained metrics, random-weight metrics, the checkpoint)."""
    with_defaults(config)
    if skip_train:
        ckpt = _newest_checkpoint(config.SETTINGS.experiment_path)
    else:
        _, ws = train_fusion(copy.deepcopy(config), device,
                             comment="quality demo")
        ckpt = os.path.join(ws.model_path, "best.ckpt")
    print(f"using checkpoint {ckpt}", flush=True)
    results = {}
    for label, path in (("trained", ckpt), ("random", None)):
        cfg = copy.deepcopy(config)
        cfg.TIMESTAMP = None
        cfg.TESTING.fusion_model_path = path
        results[label] = test_fusion(cfg, device)
    trained, rand = results["trained"], results["random"]
    print("\n=== QUALITY DEMO: trained vs random ===")
    for k in sorted(set(trained) | set(rand)):
        print(f"{k:24s} trained {trained.get(k, float('nan')):>10.4f}   "
              f"random {rand.get(k, float('nan')):>10.4f}")
    print(json.dumps({"trained": trained, "random": rand}))
    return trained, rand, ckpt


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to run (default: cuda)")
    parser.add_argument("--skip-train", action="store_true",
                        help="reuse the newest checkpoint under the "
                             "experiment path")
    args = parser.parse_args(argv)
    from .config import load_config
    quality_demo(load_config(args.config), args.device, args.skip_train)


if __name__ == "__main__":
    main()
