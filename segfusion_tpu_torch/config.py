"""Config: attribute-accessible nested dict with the slice's defaults.

Port of ``segfusion_tpu/config.py`` for the sections the inference slice
reads. ``yaml`` is imported only by :func:`load_config`.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Mapping

__all__ = ["Config", "load_config", "default_config"]


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


_DEFAULTS = {
    "SETTINGS": {
        "seed": 1911,
    },
    "FUSION_MODEL": {
        "name": "v3",
        "output_scale": 1.0,
        "n_points": 9,
        "n_tail_points": 7,
        "growth_factor": 6,
        "use_semantics": False,
    },
    "SEMANTIC_2D_MODEL": {
        "stage": 1,
        "n_classes": 30,
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
    },
}


def _merge_defaults(cfg: Config, defaults: Mapping) -> Config:
    for k, v in defaults.items():
        if k not in cfg or cfg[k] is None:
            cfg[k] = copy.deepcopy(v)
        elif isinstance(v, Mapping) and isinstance(cfg[k], Config):
            _merge_defaults(cfg[k], v)
    return cfg


def default_config() -> Config:
    """A config holding only the defaults."""
    return _merge_defaults(Config({}), _DEFAULTS)


def load_config(path: str) -> Config:
    """Load a YAML config file (the JAX package's schema) with defaults."""
    import yaml

    if not os.path.exists(path):
        raise FileNotFoundError(f"config file not found: {path}")
    with open(path) as f:
        raw: Any = yaml.safe_load(f) or {}
    cfg = Config(raw)
    if "SEMANTIC_MODEL" in cfg and "SEMANTIC_2D_MODEL" not in cfg:
        cfg["SEMANTIC_2D_MODEL"] = cfg["SEMANTIC_MODEL"]
    return _merge_defaults(cfg, _DEFAULTS)
