"""Port parity for the 3-D median filter (K5) and the outlier filter: the
port's plain ``median_filter3d`` and its kernel wrapper on a CPU tensor
against the JAX package's XLA median and its Pallas kernel (interpret
mode, as tests/test_pallas_median.py runs it), on the same numpy volumes.
Integer medians are exact on every backend, so every comparison here is
bit-exact (tolerance 0)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from segfusion_tpu.ops.filters import median_filter3d as j_median
from segfusion_tpu.ops.filters import outlier_filter as j_outlier
from segfusion_tpu.ops.pallas.median3d import median_filter3d_pallas
from segfusion_tpu_torch.ops.filters import median_filter3d, outlier_filter
from segfusion_tpu_torch.ops.kernels import median3d


@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("shape", [(20, 22, 30), (33, 17, 5), (16, 16, 24)])
def test_uint8_median_matches_jax(shape, size):
    """uint8 labels over the full byte range plus a run of few classes (so
    medians tie often): bit-exact to the XLA median and the Pallas kernel;
    the kernel wrapper on a CPU tensor gives the same volume."""
    rng = np.random.RandomState(sum(shape) + size)
    vol = rng.randint(0, 256, shape).astype(np.uint8)
    vol[: shape[0] // 2] = rng.randint(0, 5, vol[: shape[0] // 2].shape)
    want = np.asarray(j_median(jnp.asarray(vol), size=size))
    np.testing.assert_array_equal(
        np.asarray(median_filter3d_pallas(jnp.asarray(vol), size=size,
                                          interpret=True)), want)
    got = median_filter3d(torch.as_tensor(vol), size)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        median3d.median_filter3d(torch.as_tensor(vol), size).numpy(), want)


def test_float_median_matches_jax():
    """A float32 volume against the XLA median: exact (both take the
    sorted middle of the same values)."""
    vol = np.random.RandomState(7).randn(12, 10, 9).astype(np.float32)
    for size in (3, 5):
        np.testing.assert_array_equal(
            median_filter3d(torch.as_tensor(vol), size).numpy(),
            np.asarray(j_median(jnp.asarray(vol), size=size)))


def test_plain_median_slabs(monkeypatch):
    """The x-slab loop (forced to one plane per slab here) changes nothing:
    exact against the unsliced result."""
    vol = torch.as_tensor(
        np.random.RandomState(3).randint(0, 9, (7, 12, 10)).astype(np.uint8))
    whole = median3d.median_filter3d_plain(vol, 5)
    monkeypatch.setattr(median3d, "_SLAB_VALUES", 1)
    torch.testing.assert_close(median3d.median_filter3d_plain(vol, 5), whole,
                               rtol=0, atol=0)


def test_median_rejects_bad_input():
    vol = torch.zeros((4, 4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="odd"):
        median_filter3d(vol, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        median3d.median_filter3d(vol.to("meta"), 5)


def test_cpu_wrapper_counts_no_launch():
    median3d.reset_launch_counts()
    median3d.median_filter3d(torch.zeros((4, 4, 4), dtype=torch.uint8), 3)
    assert median3d.launch_counts() == {"median_filter3d": 0}


def test_outlier_filter_matches_jax():
    """Exact: a threshold compare and a select."""
    rng = np.random.RandomState(5)
    tsdf = rng.uniform(-0.1, 0.1, (8, 9, 10)).astype(np.float32)
    w = rng.uniform(0, 4, (8, 9, 10)).astype(np.float32)
    jt, jw = j_outlier(jnp.asarray(tsdf), jnp.asarray(w), 2.0, 0.1)
    pt, pw = outlier_filter(torch.as_tensor(tsdf), torch.as_tensor(w), 2.0,
                            0.1)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
