"""The port's quality demos run end to end on the CPU at small sizes:
``seg_quality_demo`` on configs/segmentation/synthetic_small.yaml (1
epoch of 32x32 frames; val mIoU on the unseen scene, random init against
the trained best.ckpt, and ``--skip-train`` finding that checkpoint) and
``quality_demo`` on configs/fusion/synthetic_small.yaml (train_fusion,
then test_fusion on best.ckpt and on random weights). Their numbers at
the demo configurations come from the card (``chip_smoke.py`` phase 13)."""

import math
import os

from segfusion_tpu_torch import quality_demo, seg_quality_demo
from segfusion_tpu_torch.config import load_config
from tests.test_torch_nets import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_seg_quality_demo_runs(tmp_path, capsys):
    cfg = load_config(os.path.join(ROOT, "configs", "segmentation",
                                   "synthetic_small.yaml"))
    cfg.SETTINGS.experiment_path = str(tmp_path)
    rand, trained, ckpt = seg_quality_demo.seg_quality_demo(cfg, "cpu")
    assert os.path.exists(ckpt)
    for m in (rand, trained):
        assert set(m) == {"Acc", "Mean Acc", "FreqW Acc", "Mean IoU"}
        assert 0 <= m["Acc"] <= 1
    assert "| trained |" in capsys.readouterr().out
    again = seg_quality_demo.seg_quality_demo(cfg, "cpu", skip_train=True)
    assert again[2] == ckpt and again[1] == trained


def test_quality_demo_runs(tmp_path, capsys):
    cfg = load_config(os.path.join(ROOT, "configs", "fusion",
                                   "synthetic_small.yaml"))
    cfg.SETTINGS.experiment_path = str(tmp_path)
    trained, rand, ckpt = quality_demo.quality_demo(cfg, "cpu")
    assert os.path.basename(ckpt) == "best.ckpt"
    assert set(trained) == set(rand) and "iou" in trained
    assert all(math.isfinite(v) for v in trained.values())
    assert "QUALITY DEMO" in capsys.readouterr().out
