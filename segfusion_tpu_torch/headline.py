"""The repo's headline configuration for the port: joint online inference
(AdapNet++ stage 2 + FusionNet v3 at growth factor 6 with the semantic
head, 9 samples per ray, 7 tail samples) into a 448^3 volume at 1 cm from
256x256 frames, frame_block 4, semantics integrated every 8th block, bf16
geo accumulators and bf16 nets -- ``bench.py`` ``build_config`` +
``_headline_setup`` of the JAX package. Weights are random from a seed.
"""

from __future__ import annotations

import torch

from .config import default_config
from .core.pipeline import Pipeline
from .core.volume import init_scene_volume
from .data.synthetic import SyntheticScene
from .models import seeded_init
from .models.adapnet import SegmenterAdapter, build_adapnet
from .ops.raycast import render_depth

__all__ = ["HEADLINE_SHAPE", "headline_config", "build_pipeline",
           "render_frames", "headline_volume"]

HEADLINE_SHAPE = (448, 448, 448)


def headline_config(h: int = 256, w: int = 256):
    cfg = default_config()
    cfg.DATA.update(resx=w, resy=h, init_value=0.1, semantics="class30",
                    semantic_strategy="predict")
    cfg.FUSION_MODEL.update(name="v3", n_points=9, n_tail_points=7,
                            growth_factor=6, use_semantics=True,
                            compute_dtype="bfloat16")
    cfg.SEMANTIC_2D_MODEL.update(n_classes=30, stage=2,
                                 compute_dtype="bfloat16")
    cfg.SETTINGS.update(frame_block=4, sem_integrate_every=8,
                        geo_dtype="bfloat16")
    return cfg


def build_pipeline(cfg, device, seed: int = 0) -> Pipeline:
    """Pipeline with a seeded random AdapNet++ segmenter and FusionNet, in
    the configured compute dtypes, on ``device``."""
    g = torch.Generator().manual_seed(seed)
    dtype = (torch.bfloat16 if cfg.SEMANTIC_2D_MODEL.get("compute_dtype")
             in ("bfloat16", "bf16") else torch.float32)
    adapnet = seeded_init(build_adapnet(cfg.SEMANTIC_2D_MODEL), g)
    seg = SegmenterAdapter(adapnet.to(device, dtype).eval())
    return Pipeline(cfg, segmenter=seg, device=device, generator=g)


def render_frames(n_frames: int, h: int, w: int, device, scene=None):
    """Depth over ``scene`` (default SyntheticScene(seed=0, half=2.2)) from
    ``n_frames`` distinct poses of a circular trajectory, plus a gray
    image derived from depth (``bench.py`` ``render_frames``); a (T, ...)
    frame dict."""
    scene = scene if scene is not None else SyntheticScene(seed=0, half=2.2)
    coarse, _ = scene.grid(0.04, 10.0, pad=2)
    f = 0.5 * w
    intr = torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
                        dtype=torch.float32, device=device)
    poses = torch.as_tensor(scene.camera_poses(n_frames), device=device)
    depth = render_depth(torch.as_tensor(coarse.volume, device=device),
                         poses, intr,
                         torch.as_tensor(coarse.origin, device=device),
                         coarse.resolution, h, w, near=0.05, far=9.0,
                         n_steps=192)
    gray = torch.clamp(1.0 - depth / 9.0, 0, 1) * 255.0
    return {"depth": depth, "depth_input": depth,
            "image": gray[..., None].expand(-1, -1, -1, 3).contiguous(),
            "extrinsics": poses,
            "intrinsics": intr.expand(n_frames, 3, 3).contiguous(),
            "mask": depth > 0}


def headline_volume(device, shape=HEADLINE_SHAPE):
    """An empty room-scale volume: 4.48 m cube around the origin."""
    return init_scene_volume(shape, [-2.24] * 3, 4.48 / shape[0], 0.1,
                             device=device)
