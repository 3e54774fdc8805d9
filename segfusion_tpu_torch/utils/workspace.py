"""Workspace: experiment directories, loggers, TensorBoard, artifact savers.

The port's own copy of ``segfusion_tpu/utils/workspace.py``:
``<experiment_path>/<timestamp>/{model,logs,output}``, file + console
loggers per mode, TensorBoard scalars through tensorboardX where it is
installed, gzip hdf5 volume savers, the ply mesh saver, a json snapshot
of the config and the best / last model checkpoints (``utils/checkpoints``,
the JAX package's Flax msgpack format).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import sys
from typing import Any, Dict, Optional

import numpy as np

from . import hdf5

__all__ = ["Workspace", "get_workspace"]


class Workspace:
    def __init__(self, path: str, enable_tensorboard: bool = True):
        self.workspace_path = path
        self.model_path = os.path.join(path, "model")
        self.log_path = os.path.join(path, "logs")
        self.output_path = os.path.join(path, "output")
        for p in (self.workspace_path, self.model_path, self.log_path,
                  self.output_path):
            os.makedirs(p, exist_ok=True)

        self.writer = _NullWriter()
        if enable_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self.writer = SummaryWriter(self.log_path)

        self._loggers: Dict[str, logging.Logger] = {}

    # -- logging --------------------------------------------------------------

    def get_logger(self, mode: str = "train") -> logging.Logger:
        if mode in self._loggers:
            return self._loggers[mode]
        logger = logging.getLogger(f"segfusion.{id(self)}.{mode}")
        logger.setLevel(logging.INFO)
        logger.propagate = False
        fh = logging.FileHandler(os.path.join(self.log_path, f"{mode}.log"))
        fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(fh)
        logger.addHandler(sh)
        self._loggers[mode] = logger
        return logger

    def log(self, message: str, mode: str = "train"):
        self.get_logger(mode).info(message)

    def add_scalar(self, tag: str, value: float, global_step: int = 0):
        self.writer.add_scalar(tag, value, global_step=global_step)

    # -- artifact savers ------------------------------------------------------

    def save_config(self, config):
        path = os.path.join(self.workspace_path, "config.json")
        with open(path, "w") as f:
            if hasattr(config, "to_dict"):
                json.dump(config.to_dict(), f, indent=2, default=str)
            else:
                json.dump(dict(config), f, indent=2, default=str)

    def _save_h5(self, filename: str, key: str, data):
        with hdf5.File(os.path.join(self.output_path, filename), "w") as f:
            f.create_dataset(key, shape=np.asarray(data).shape,
                             data=np.asarray(data), compression="gzip",
                             compression_opts=9)

    def save_tsdf_data(self, filename, data):
        self._save_h5(filename, "TSDF", data)

    def save_weights_data(self, filename, data):
        self._save_h5(filename, "weights", data)

    def save_semantic_data(self, filename, data):
        self._save_h5(filename, "semantics", data)

    def save_ply_mesh(self, filename, vertices, faces, normals=None,
                      colors=None):
        from .meshio import write_ply
        write_ply(os.path.join(self.output_path, filename), vertices, faces,
                  normals=normals, colors=colors)

    def save_ply_data(self, filename, tsdf_volume, voxel_size: float = 0.01):
        """Mesh a host TSDF volume at its zero level and save it."""
        from .mesh import marching_cubes
        v, f, n = marching_cubes(np.asarray(tsdf_volume, np.float32), 0.0,
                                 spacing=voxel_size)
        self.save_ply_mesh(filename, v, f, normals=n)

    def save_model_state(self, state: Dict[str, Any], is_best: bool = False,
                         name: Optional[str] = None):
        """``model/best.ckpt`` (or ``name``) when ``is_best``, else
        ``model/last.ckpt``."""
        from .checkpoints import save_checkpoint
        fname = name if (is_best and name) else (
            "best.ckpt" if is_best else "last.ckpt")
        save_checkpoint(state, os.path.join(self.model_path, fname))


class _NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def add_image(self, *a, **k):
        pass

    def close(self):
        pass


def get_workspace(config) -> Workspace:
    """Create the ``<experiment_path>/<timestamp>`` workspace and snapshot
    the config."""
    ts = config.get("TIMESTAMP") or datetime.datetime.now().strftime(
        "%y%m%d-%H%M%S")
    config["TIMESTAMP"] = ts
    path = os.path.join(config.SETTINGS.experiment_path, ts)
    ws = Workspace(path)
    ws.save_config(config)
    return ws
