"""Config: attribute-accessible nested dict with the slice's defaults.

Port of ``segfusion_tpu/config.py`` for the sections the inference,
evaluation, fusion-training and segmentation slices read. ``yaml`` is
imported only by :func:`load_config`.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Mapping

__all__ = ["Config", "load_config", "default_config", "with_defaults",
           "get_data_config"]


class Config(dict):
    """Attribute-accessible nested dict (mutable at run time)."""

    def __init__(self, d: Mapping | None = None):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, Mapping) and not isinstance(value, Config):
            value = Config(value)
        super().__setitem__(key, value)

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __deepcopy__(self, memo):
        return Config(copy.deepcopy(dict(self), memo))

    def to_dict(self) -> dict:
        """Plain nested dicts (for a json snapshot of the config)."""
        return {k: v.to_dict() if isinstance(v, Config) else v
                for k, v in self.items()}


_DEFAULTS = {
    "SETTINGS": {
        "seed": 1911,
        "num_workers": 0,
        "experiment_path": "workspace/default",
        "save_mode": "test",
        "eval_freq": 2000,
        "log_freq": 250,
    },
    "FUSION_MODEL": {
        "name": "v3",
        "output_scale": 1.0,
        "n_points": 9,
        "n_tail_points": 7,
        "growth_factor": 6,
        "use_semantics": False,
        "pretrained": None,
    },
    "SEMANTIC_2D_MODEL": {
        "stage": 1,
        "n_classes": 30,
    },
    "TRAINING": {
        "train_batch_size": 1,
        "train_shuffle": False,
        "train_ratio": 1,
        "val_batch_size": 1,
        "val_shuffle": False,
        "val_ratio": 1,
        "n_epochs": 1,
        "resume": None,
        "optimizer": {"name": "rmsprop", "lr": 1.0e-5, "momentum": 0.9,
                      "weight_decay": 0.01, "eps": 1.0e-9},
        "scheduler": {"name": "poly_lr", "max_iter": 50000},
        "loss": {"name": "fusion", "w_l1": 1.0, "w_l2": 10.0, "w_cos": 0.1},
        "optimization": {"reset_strategy": False, "reset_prob": 0.01,
                         "clipping": True, "accumulation_steps": 8,
                         "random_mask": False, "mask_prob": 0.1},
    },
    "TESTING": {
        "test_batch_size": 1,
        "test_shuffle": False,
        "test_ratio": 1,
        "outlier_filter_val": 2,
        "fscore_threshold": 0.05,
        "sequence_chunk": 16,
        "fusion_model_path": None,
        "semantic_2d_model_path": None,
        "n_visualizations": 10,
        "output_benchmark": False,
    },
    "DATA": {
        "dataset": "Synthetic",
        "semantics": None,
        "semantic_strategy": "gt",
        "semantic_grid": False,
        "input": "tof_depth",
        "resx": 256,
        "resy": 256,
        "init_value": 0.1,
        "pad": 2,
        "n_classes": 0,
        "pad_shape_multiple": 1,
    },
}


def _merge_defaults(cfg: Config, defaults: Mapping) -> Config:
    for k, v in defaults.items():
        if k not in cfg or cfg[k] is None:
            cfg[k] = copy.deepcopy(v)
        elif isinstance(v, Mapping) and isinstance(cfg[k], Config):
            _merge_defaults(cfg[k], v)
    return cfg


def _complete(cfg: Config) -> Config:
    """Defaults, then the keys the segmentation CLIs derive: the
    reference's SEMANTIC_MODEL section read as SEMANTIC_2D_MODEL, and
    DATA.target_key (the segmentation target) from DATA.target_seg."""
    if "SEMANTIC_MODEL" in cfg and "SEMANTIC_2D_MODEL" not in cfg:
        cfg["SEMANTIC_2D_MODEL"] = cfg["SEMANTIC_MODEL"]
    _merge_defaults(cfg, _DEFAULTS)
    if not cfg.DATA.get("target_key"):
        cfg.DATA.target_key = cfg.DATA.get("target_seg") or "semantic_gt"
    return cfg


def default_config() -> Config:
    """A config holding only the defaults."""
    return _complete(Config({}))


def with_defaults(cfg: Config) -> Config:
    """Fill the defaults into ``cfg`` where a key is missing or None, and
    the derived keys of :func:`_complete`, in place; returns ``cfg``."""
    return _complete(cfg)


# mode -> (DATA scene-list key, config section, frame-ratio key)
_MODES = {"train": ("train_scene_list", "TRAINING", "train_ratio"),
          "val": ("val_scene_list", "TRAINING", "val_ratio"),
          "test": ("test_scene_list", "TESTING", "test_ratio")}


def get_data_config(config: Config, mode: str) -> Config:
    """The per-mode (train/val/test) view of the DATA section: its scene
    list and frame ratio, and the class count when semantics are on."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    scene_key, section, ratio_key = _MODES[mode]
    data = copy.deepcopy(config.DATA)
    data.mode = mode
    data.scene_list = data.get(scene_key)
    data.frame_ratio = config.get(section, {}).get(ratio_key, 1)
    if config.DATA.get("semantics"):
        data.n_classes = config.SEMANTIC_2D_MODEL.n_classes
    return data


def load_config(path: str) -> Config:
    """Load a YAML config file (the JAX package's schema) with defaults."""
    import yaml

    if not os.path.exists(path):
        raise FileNotFoundError(f"config file not found: {path}")
    with open(path) as f:
        raw: Any = yaml.safe_load(f) or {}
    return _complete(Config(raw))
