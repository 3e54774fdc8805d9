"""Port parity for the flat extraction of ``segfusion_tpu/ops/geometry.py``
(the scalar path's corner math and gathers) against
``segfusion_tpu_torch/ops/geometry.py``, on the CPU at 44x48x44 and
40x40 frames.

Integer outputs (corner indices, linear indices, masks) are exact. The
corner weights are the same f32 products, exact (the factored form's
within 1e-7). Gathered values and weights sum 8 products in another order
than XLA: within 1e-6. The extraction tests' frames use a pose without
rotation, and power-of-two intrinsics, origin and voxel size, so that
each unprojection is exact; the jitted JAX ``extract`` still contracts
the ray sampling's multiply-adds, which moves 0.7% of the samples (12%
of the rays) by one f32 ulp (~4e-6 voxels). Those rays are held to that ulp, the rest to the
bounds above.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from segfusion_tpu.ops import geometry as jg
from segfusion_tpu_torch.ops import geometry as tg
from tests.test_torch_nets import one_torch_thread  # noqa: F401 (a fixture)

SHAPE = (44, 48, 44)
ORIGIN = np.array([-1.125, -1.25, -1.125], np.float32)
RES = 0.0625


def _state(seed=0):
    """Accumulator state with unobserved voxels, a value volume and a
    weight volume."""
    rng = np.random.RandomState(seed)
    w = rng.uniform(0, 4, SHAPE).astype(np.float32)
    w[rng.rand(*SHAPE) < 0.3] = 0.0
    tsdf = rng.uniform(-0.2, 0.2, SHAPE).astype(np.float32)
    return (tsdf * w).astype(np.float32), w, tsdf


def _frame(seed=1, h=40, w=40):
    """A pose inside the volume looking along +z, depths reaching past
    the faces (out-of-bounds corners), a few zero-depth pixels."""
    rng = np.random.RandomState(seed)
    depth = rng.uniform(0.3, 2.4, (h, w)).astype(np.float32)
    depth[rng.rand(h, w) < 0.05] = 0.0
    f = 32.0    # K^-1 = [[1/32, 0, -1/2], ...]: every product exact
    intr = np.array([[f, 0, 16], [0, f, 16], [0, 0, 1]], np.float32)
    extr = np.eye(4, dtype=np.float32)
    extr[:3, 3] = [0.125, -0.0625, -0.625]
    return depth, extr, intr


def _points(n=600, p=9, seed=2):
    """Voxel-space samples over and past the volume, some exactly on
    voxel centres (sign 0: the neighbour is the voxel itself)."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-3, 50, (n, p, 3)).astype(np.float32)
    pts[:20, :, :] = np.floor(pts[:20]) + 0.5
    return pts


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _same_rays(tout, jout):
    """The rays whose samples are bit-identical in both (the others within
    an ulp of a coordinate in [32, 64); 12% of the rays here)."""
    tp, jp = tout.points.numpy(), np.asarray(jout.points)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=2.0 ** -18)
    same = (tp == jp).all(axis=(1, 2))
    assert same.mean() >= 0.8, same.mean()
    return same


def test_interpolation_weights_and_masks_match_jax():
    pts = _points()
    ji, jw = jg.interpolation_weights(jnp.asarray(pts))
    ti, tw = tg.interpolation_weights(_t(pts))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(
        tg.valid_index_mask(ti, SHAPE).numpy(),
        np.asarray(jg.valid_index_mask(ji, SHAPE)))
    jc = jg.clamp_indices(ji, SHAPE)
    tc = tg.clamp_indices(ti, SHAPE)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tg._flatten_index(tc, SHAPE).numpy(),
                                  np.asarray(jg._flatten_index(jc, SHAPE)))


def test_factored_corners_match_jax():
    """Linear indices and masks exact; both forms of the corner math agree
    (the factored path is the unfactored one, regrouped)."""
    pts = _points(seed=3)
    jl, jv, jw = jg.interpolation_corners_factored(jnp.asarray(pts), SHAPE)
    tl, tv, tw = tg.interpolation_corners_factored(_t(pts), SHAPE)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-7)
    ti, _ = tg.interpolation_weights(_t(pts))
    np.testing.assert_array_equal(
        tl.numpy(), tg._flatten_index(tg.clamp_indices(ti, SHAPE),
                                      SHAPE).numpy())


@pytest.mark.parametrize("which", ["explicit", "numw", "packed16"])
def test_gathers_match_jax(which):
    num, w, tsdf = _state()
    pts = _points(seed=4)
    if which == "explicit":
        jout = jg.trilinear_gather(jnp.asarray(pts), jnp.asarray(tsdf),
                                   jnp.asarray(w))
        tout = tg.trilinear_gather(_t(pts), _t(tsdf), _t(w))
    elif which == "numw":
        jout = jg.trilinear_gather_numw(jnp.asarray(pts), jnp.asarray(num),
                                        jnp.asarray(w), 0.1)
        tout = tg.trilinear_gather_numw(_t(pts), _t(num), _t(w), 0.1)
    else:
        jout = jg.trilinear_gather_packed16(jnp.asarray(pts),
                                            jnp.asarray(num),
                                            jnp.asarray(w), 0.1)
        tout = tg.trilinear_gather_packed16(_t(pts), _t(num), _t(w), 0.1)
    for j, t in zip(jout[:2], tout[:2]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-6)
    for j, t in zip(jout[2:], tout[2:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("packed16", [False, True])
def test_extract_numw_matches_jax(packed16):
    num, w, _ = _state(5)
    depth, extr, intr = _frame()
    jout = jg.extract_numw(jnp.asarray(depth), jnp.asarray(extr),
                           jnp.asarray(intr), jnp.asarray(num),
                           jnp.asarray(w), jnp.asarray(ORIGIN), RES,
                           init_value=0.1, n_points=9, packed16=packed16)
    tout = tg.extract_numw(_t(depth), _t(extr), _t(intr), _t(num), _t(w),
                           _t(ORIGIN), RES, init_value=0.1, n_points=9,
                           packed16=packed16)
    assert (tout.indices is None) == packed16 == (tout.lin is not None)
    same = _same_rays(tout, jout)
    for k in ("fusion_values", "fusion_weights"):
        np.testing.assert_allclose(getattr(tout, k).numpy()[same],
                                   np.asarray(getattr(jout, k))[same],
                                   rtol=0, atol=1e-6)
    if packed16:
        np.testing.assert_array_equal(tout.lin.numpy()[same],
                                      np.asarray(jout.lin)[same])
        np.testing.assert_array_equal(tout.valid.numpy()[same],
                                      np.asarray(jout.valid)[same])
        assert 0 < tout.valid.float().mean() < 1      # faces are crossed
    else:
        np.testing.assert_array_equal(tout.indices.numpy()[same],
                                      np.asarray(jout.indices)[same])


def test_extract_matches_jax():
    """The gt extraction: an explicit value volume with fill -0.1 outside."""
    _, w, tsdf = _state(6)
    depth, extr, intr = _frame(7)
    jout = jg.extract(jnp.asarray(depth), jnp.asarray(extr),
                      jnp.asarray(intr), jnp.asarray(tsdf), jnp.asarray(w),
                      jnp.asarray(ORIGIN), RES, n_points=5)
    tout = tg.extract(_t(depth), _t(extr), _t(intr), _t(tsdf), _t(w),
                      _t(ORIGIN), RES, n_points=5)
    np.testing.assert_array_equal(tout.pcl.numpy(), np.asarray(jout.pcl))
    same = _same_rays(tout, jout)
    np.testing.assert_allclose(tout.fusion_values.numpy()[same],
                               np.asarray(jout.fusion_values)[same], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tout.indices.numpy()[same],
                                  np.asarray(jout.indices)[same])
    np.testing.assert_array_equal(tout.depth.numpy(), depth.reshape(-1))
