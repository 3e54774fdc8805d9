"""Port parity for ``segfusion_tpu_torch.data.transforms``: ``ToArray``
equals the JAX package's on the same frame dict (values and dtypes), and
``to_device`` gives torch tensors on the named device with the values of
the JAX package's ``jax.device_put``."""

import numpy as np
import pytest
import torch

from segfusion_tpu.data import transforms as j_transforms
from segfusion_tpu_torch.data.transforms import ToArray, to_device


def frame(seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.uniform(0, 255, (6, 8, 3)),
            "tof_depth": rng.uniform(0, 5, (6, 8)),
            "depth_gt": rng.uniform(0, 5, (6, 8)).astype(np.float16),
            "extrinsics": np.eye(4), "intrinsics": np.eye(3, dtype=np.int64),
            "mask": rng.randint(0, 2, (6, 8)),
            "semantic_gt": rng.randint(0, 30, (6, 8)).astype(np.int32),
            "frame_id": "room/1/3", "item_id": 3, "scale": np.float64(0.5)}


def test_to_array_matches_jax():
    got, want = ToArray()(frame()), j_transforms.ToArray()(frame())
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("converted", [False, True])
def test_to_device_matches_jax(converted):
    """Every array field (numpy scalars too) becomes a tensor on the
    device with the JAX arrays' values; ids and Python numbers stay. The
    tensors keep the fields' dtypes (JAX's ``device_put`` narrows 64-bit
    values to 32 bits while x64 is off, so the values are compared in
    JAX's dtype)."""
    src = ToArray()(frame(1)) if converted else frame(1)
    src["already"] = torch.arange(4)
    want = j_transforms.to_device({k: v for k, v in src.items()
                                   if k != "already"})
    got = to_device(src, "cpu")
    assert got.keys() == src.keys()
    assert torch.equal(got["already"], torch.arange(4))
    for k, w in want.items():
        if hasattr(w, "dtype"):
            assert isinstance(got[k], torch.Tensor), k
            assert got[k].device == torch.device("cpu")
            assert got[k].numpy().dtype == np.asarray(src[k]).dtype, k
            np.testing.assert_array_equal(
                got[k].numpy().astype(np.asarray(w).dtype), np.asarray(w))
        else:
            assert got[k] == w, k
