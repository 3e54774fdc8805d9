"""Frame-dict transforms: array conversion and device placement.

Port of ``segfusion_tpu/data/transforms.py``. Frames stay NHWC host numpy
arrays, so ``ToArray`` only normalises dtypes; ``to_device`` moves a
batch's array fields to a torch device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["ToArray", "to_device"]


class ToArray:
    """Normalise a frame dict's fields to numpy arrays with canonical
    dtypes (images float32 NHWC, depths float32, masks bool, labels uint8,
    matrices float32)."""

    _FLOAT_KEYS = ("image", "tof_depth", "depth_gt", "extrinsics",
                   "intrinsics")

    def __call__(self, sample: Dict) -> Dict:
        out = dict(sample)
        for k in self._FLOAT_KEYS:
            if k in out and isinstance(out[k], np.ndarray):
                out[k] = out[k].astype(np.float32)
        if "mask" in out:
            out["mask"] = np.asarray(out["mask"]).astype(bool)
        if "semantic_gt" in out:
            out["semantic_gt"] = np.asarray(out["semantic_gt"]).astype(
                np.uint8)
        return out


def to_device(batch: Dict, device="cuda") -> Dict:
    """The batch dict with every array field (numpy arrays and tensors) a
    tensor on ``device`` (numpy scalars too); other fields (ids, Python
    numbers) as they are."""
    def put(v):
        if isinstance(v, (np.ndarray, np.generic, torch.Tensor)):
            return torch.as_tensor(v, device=device)
        return v

    return {k: put(v) for k, v in batch.items()}
