"""Frame-stream inference, evaluation and mesh export for the port.

    python -m segfusion_tpu_torch.test_fusion --config configs/fusion/<name>.yaml [--device cpu]

Counterpart of the JAX package's ``test_fusion.py``: stream every test
frame through ``Pipeline.fuse_many`` in chunks of TESTING.sequence_chunk
(or, where it is 1 or less, one ``Pipeline.fuse`` a frame), outlier-filter
the volumes,
median-filter the label volumes, log the geometry, mesh F-score and
semantic metrics, and save hdf5 volumes and ply meshes into a timestamped
workspace under SETTINGS.experiment_path. Runs on the card (``--device
cuda``, the default) or, where the caller names it, on the CPU with the
kernels' plain versions (``--device cpu``); asking for CUDA where torch
sees no CUDA device raises.
"""

from __future__ import annotations

import argparse

import numpy as np

from .config import get_data_config, with_defaults
from .core.database import Database
from .core.pipeline import Pipeline
from .data import PrefetchLoader, get_data
from .device import resolve_device
from .utils.convert import (fusionnet_from_checkpoint,
                            segmenter_from_checkpoint)
from .utils.workspace import get_workspace

__all__ = ["test_fusion"]


def test_fusion(config, device="cuda", fusion_net=None, segmenter=None):
    """Fuse, filter, evaluate and save the test split of ``config`` (the
    JAX package's schema; missing keys take the port's defaults, filled in
    place). ``fusion_net`` / ``segmenter``: loaded nets (the segmenter a
    ``models.adapnet.SegmenterAdapter`` on ``device``); where they are
    not given they load from TESTING.fusion_model_path /
    semantic_2d_model_path (Flax checkpoints of either package), and
    without a fusion checkpoint the net has random weights from seed 0.
    Returns the metrics dict."""
    with_defaults(config)
    device = resolve_device(device)
    testing = config.TESTING
    workspace = get_workspace(config)
    test_cfg = get_data_config(config, "test")
    dataset = get_data(config.DATA.dataset, test_cfg, device=device)
    loader = PrefetchLoader(dataset, batch_size=testing.test_batch_size,
                            shuffle=testing.test_shuffle,
                            num_workers=config.SETTINGS.num_workers)
    database = Database(dataset, test_cfg, device=device)

    if (segmenter is None and config.DATA.semantics
            and config.DATA.semantic_strategy == "predict"):
        if not testing.semantic_2d_model_path:
            raise ValueError("semantic_strategy 'predict' needs "
                             "TESTING.semantic_2d_model_path")
        segmenter = segmenter_from_checkpoint(
            testing.semantic_2d_model_path, config.SEMANTIC_2D_MODEL,
            config.DATA.input, device)
        workspace.log(f"loaded segmentation checkpoint "
                      f"{testing.semantic_2d_model_path}", "test")
    if fusion_net is None:
        if testing.fusion_model_path:
            fusion_net = fusionnet_from_checkpoint(testing.fusion_model_path,
                                                   config.FUSION_MODEL)
            workspace.log(f"loaded fusion checkpoint "
                          f"{testing.fusion_model_path}", "test")
        else:
            # the Pipeline draws the weights from seed 0
            workspace.log("WARNING: no fusion checkpoint given -- "
                          "running with random weights", "test")
    pipeline = Pipeline(config, segmenter=segmenter, fusion_net=fusion_net,
                        device=device)

    chunk = int(testing.sequence_chunk or 1)
    if chunk > 1:
        pipeline.fuse_many(loader, database, chunk=chunk)
        workspace.log(f"fused {len(dataset)} frames (chunks of {chunk})",
                      "test")
    else:
        n = 0
        for batch in loader:
            if not np.all(np.isfinite(np.asarray(batch["extrinsics"]))):
                continue
            pipeline.fuse(batch, database)
            n += 1
        workspace.log(f"fused {n} frames", "test")

    database.filter(value=float(testing.outlier_filter_val))
    if config.DATA.semantics:
        database.filter_semantics(5)

    eval_results, _ = database.evaluate("test", workspace)
    workspace.log("--- geometry metrics ---", "test")
    for k, v in eval_results.items():
        workspace.log(f"{k}: {v}", "test")
    fscore_thr = float(testing.fscore_threshold)
    f_agg, _ = database.evaluate_fscore(threshold=fscore_thr,
                                        workspace=workspace)
    workspace.log(f"--- reconstruction F-score (tau={fscore_thr}m) ---",
                  "test")
    for k, v in f_agg.items():
        workspace.log(f"{k}: {v}", "test")
        eval_results[f"mesh_{k}"] = v
    if config.DATA.semantics and config.DATA.semantic_grid:
        sem_results, _ = database.evaluate_semantics("test", workspace)
        workspace.log("--- semantic metrics ---", "test")
        for k, v in sem_results.items():
            workspace.log(f"{k}: {v}", "test")
            eval_results[f"sem_{k}"] = v

    for scene in database.scenes:
        if database.state[scene]:
            database.save(workspace.output_path,
                          save_mode=config.SETTINGS.save_mode,
                          scene_id=scene)
    workspace.log(f"artifacts saved to {workspace.output_path}", "test")
    return eval_results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to run (default: cuda; cpu runs the "
                             "kernels' plain versions)")
    args = parser.parse_args(argv)
    from .config import load_config
    test_fusion(load_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
