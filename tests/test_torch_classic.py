"""Port parity for the classic (non-learned) fusion: ``ops/tsdf_fusion.py``,
``core/tsdf_volume.py``, ``ops/distance_transform.py`` and ``ops/tvl1.py``
against the JAX package's, on the inputs of tests/test_classic_fusion.py
(the synthetic room rendered at 96x96, cut to 6 views), test_tsdf_volume_api.py
(a wall plane), test_filters_dt.py and test_tvl1.py, on the CPU.

The fusion is elementwise: both packages project each voxel centre with
the same f32 products, but the jitted JAX kernels may contract them into
fused multiply-adds, so a voxel whose projection lands within an ulp of a
pixel boundary (u or v at .5) or of the truncation band's edge can take
another pixel. Such voxels are counted: at most 0.1% of the grid; every
other voxel agrees within 1e-5 (measured: none flipped on these inputs,
all within 4.8e-7). Counts, votes and labels are compared the same way. The distance transform and TV-L1 are exact up to f32 summation
order (within 1e-4 / 1e-5).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segfusion_tpu.core import tsdf_volume as jtv
from segfusion_tpu.data.synthetic import SyntheticScene
from segfusion_tpu.ops import tsdf_fusion as jtf
from segfusion_tpu.ops import tvl1 as jtvl1
from segfusion_tpu.ops.raycast import render_depth as j_render_depth
from segfusion_tpu_torch.core import tsdf_volume as ttv
from segfusion_tpu_torch.ops import distance_transform as tdt
from segfusion_tpu_torch.ops import tsdf_fusion as ttf
from segfusion_tpu_torch.ops import tvl1 as ttvl1
from tests.test_classic_fusion import make_proj
from tests.test_torch_nets import one_torch_thread  # noqa: F401 (a fixture)

# the JAX package's ops/__init__ binds the function over the module's name
jdt = importlib.import_module("segfusion_tpu.ops.distance_transform")


def _close_except_flips(got, want, atol=1e-5, share=1e-3):
    """All but ``share`` of the elements within ``atol``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    far = np.abs(got - want) > atol
    assert far.mean() <= share, far.mean()


@pytest.fixture(scope="module")
def room():
    """tests/test_classic_fusion.py's scene_setup at 6 views."""
    scene = SyntheticScene(seed=0)
    res, trunc = 0.08, 0.24
    grid, _ = scene.grid(res, trunc, pad=2)
    h = w = 96
    f = 0.5 * w / np.tan(np.radians(90.0) / 2)
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    poses = scene.camera_poses(12)[::2]
    fine, _ = scene.grid(res * 0.5, 10.0, pad=2)
    depths = np.stack([np.asarray(j_render_depth(
        jnp.asarray(fine.volume), jnp.asarray(p), jnp.asarray(k),
        jnp.asarray(fine.origin), fine.resolution, h, w, near=0.05, far=8.0,
        n_steps=400)) for p in poses])
    projs = np.stack([make_proj(k, p) for p in poses])
    return grid, k, poses, depths, projs, trunc


def test_tsdf_from_depth_views_matches_jax(room):
    grid, _, _, depths, projs, trunc = room
    jt, jw = jtf.tsdf_from_depth_views(depths, projs, grid.shape,
                                       grid.origin, grid.resolution, trunc)
    tt, tw = ttf.tsdf_from_depth_views(depths, projs, grid.shape,
                                       grid.origin, grid.resolution, trunc,
                                       device="cpu")
    assert (np.asarray(jw) > 0).mean() > 0.1
    _close_except_flips(tw.numpy(), jw)
    _close_except_flips(tt.numpy(), jt)


def test_fuse_frame_and_multiclass_match_jax(room):
    """One frame at a time, with a per-pixel weight map; the multiclass
    vote with labels (out-of-range ids vote for nothing, as
    ``jax.nn.one_hot``'s)."""
    grid, _, _, depths, projs, trunc = room
    rng = np.random.RandomState(0)
    shape = grid.shape
    t0 = rng.uniform(-0.2, 0.2, shape).astype(np.float32)
    w0 = rng.uniform(0, 2, shape).astype(np.float32)
    wmap = rng.uniform(0.5, 1.5, depths[0].shape).astype(np.float32)
    labels = rng.randint(0, 9, depths[0].shape).astype(np.int32)
    probs0 = rng.uniform(0, 1, shape + (8,)).astype(np.float32)
    origin, res = grid.origin.astype(np.float32), np.float32(grid.resolution)
    jt, jw = jtf.fuse_frame(jnp.asarray(t0), jnp.asarray(w0),
                            jnp.asarray(depths[1]), jnp.asarray(projs[1]),
                            jnp.asarray(origin), res, np.float32(trunc),
                            jnp.asarray(wmap))
    tt, tw = ttf.fuse_frame(torch.as_tensor(t0), torch.as_tensor(w0),
                            torch.as_tensor(depths[1]),
                            torch.as_tensor(projs[1]),
                            torch.as_tensor(origin), torch.tensor(res),
                            torch.tensor(np.float32(trunc)),
                            torch.as_tensor(wmap))
    assert (np.asarray(jw) != w0).mean() > 0.01
    _close_except_flips(tw.numpy(), jw)
    _close_except_flips(tt.numpy(), jt)
    jr = jtf.fuse_frame_multiclass(
        jnp.asarray(t0), jnp.asarray(w0), jnp.asarray(probs0),
        jnp.asarray(depths[2]), jnp.asarray(labels), jnp.asarray(projs[2]),
        jnp.asarray(origin), res, np.float32(trunc))
    tr = ttf.fuse_frame_multiclass(
        torch.as_tensor(t0), torch.as_tensor(w0), torch.as_tensor(probs0),
        torch.as_tensor(depths[2]), torch.as_tensor(labels),
        torch.as_tensor(projs[2]), torch.as_tensor(origin),
        torch.tensor(res), torch.tensor(np.float32(trunc)))
    for a, b in zip(tr, jr):
        _close_except_flips(a.numpy(), b)
    assert (np.asarray(jr[2]) != probs0).any(-1).mean() > 0.01


def _wall():
    """tests/test_tsdf_volume_api.py's wall plane at z = 2."""
    bbox = np.array([[-1.0, 1.0], [-1.0, 1.0], [0.0, 3.0]])
    h = w = 64
    f = 0.6 * w
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    depth = np.full((h, w), 2.0, np.float32)
    depth[:5, :7] = 0.0                        # invalid pixels
    proj = (k @ np.eye(4)[:3]).astype(np.float32)
    return bbox, k, depth, proj, h, w


def test_tsdf_volume_api_matches_jax():
    """TSDFVolume / MulticlassTSDFVolume / Volume through their public
    API: volume, weights, free-space votes, observation mask, label
    probabilities and labels after three fuses (a weight map, a
    sanity_fuse, two label maps), and depth_rendering's round trip."""
    bbox, k, depth, proj, h, w = _wall()
    depth2 = depth * np.float32(1.05)
    wmap = np.linspace(0.5, 1.5, h * w, dtype=np.float32).reshape(h, w)
    labels = np.full((h, w), 3, np.uint8)
    labels[:, : w // 2] = 5
    out = {}
    for name, mod, kw in (("jax", jtv, {}), ("port", ttv, {"device": "cpu"})):
        vol = mod.TSDFVolume(bbox, 0.1, max_distance=0.3, **kw)
        vol.fuse(proj, depth)
        vol.fuse(proj, depth2, weight_map=wmap)
        vol.sanity_fuse(proj, depth)
        mc = mod.MulticlassTSDFVolume(bbox, 0.1, n_classes=8,
                                      max_distance=0.3, **kw)
        mc.fuse(proj, depth, labels)
        mc.fuse(proj, depth2, labels[::-1])
        vis = mod.Volume(bbox, 0.1, **kw)
        vis.fuse(proj, depth, truncation=0.3)
        vis.fuse(proj, depth2, truncation=0.3)
        fine = mod.TSDFVolume(bbox, 0.05, max_distance=0.3, **kw)
        for _ in range(2):
            fine.fuse(proj, depth)
        out[name] = dict(
            volume=vol.volume, weights=vol.weights,
            free_space=vol.free_space, mask=vol.get_mask(),
            mc_volume=mc.volume, probs=mc.label_probs, labels=mc.labels,
            mc_free=mc.free_space, counts=vis.volume,
            rendered=fine.depth_rendering(np.eye(4, dtype=np.float32), k,
                                          (h, w)))
    j, t = out["jax"], out["port"]
    assert t.keys() == j.keys()
    for key in j:
        assert t[key].shape == j[key].shape, key
        assert t[key].dtype == j[key].dtype, key
        _close_except_flips(t[key], j[key])
    assert j["mask"].max() == 3 and j["counts"].max() == 2
    assert set(np.unique(j["labels"][j["mc_volume"] != 0.3])) >= {3, 5}
    c = t["rendered"][h // 4: 3 * h // 4, w // 4: 3 * w // 4]
    assert (c > 0).mean() > 0.9


def test_distance_transform_matches_jax_and_scipy():
    """tests/test_filters_dt.py's occupancy: the squared transform within
    1e-4 of JAX's (f32 sums of integers: exact below 2^24), the root
    within 1e-3 of scipy's exact EDT; a 1-D pass over more than one block
    of candidates."""
    from scipy.ndimage import distance_transform_edt

    occ = np.random.RandomState(2).rand(16, 17, 18) > 0.95
    f = np.where(occ, 0.0, 1e12).astype(np.float32)
    want = np.asarray(jdt.distance_transform(jnp.asarray(f)))
    got = tdt.distance_transform(torch.as_tensor(f)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.sqrt(got), distance_transform_edt(~occ),
                               atol=1e-3)
    row = np.where(np.random.RandomState(3).rand(3, 300) > 0.97, 0.0,
                   1e12).astype(np.float32)
    np.testing.assert_allclose(
        tdt.distance_transform_1d(torch.as_tensor(row), block=128).numpy(),
        np.asarray(jdt.distance_transform_1d(jnp.asarray(row))), atol=1e-4,
        rtol=0)


@pytest.mark.parametrize("truncation", [None, 0.25])
def test_occupancy_to_sdf_matches_jax(truncation):
    occ = np.zeros((16, 16, 16), np.float32)
    occ[6:10, 6:10, 6:10] = 1.0
    occ[2, 12, 3] = 1.0
    want = np.asarray(jdt.occupancy_to_sdf(jnp.asarray(occ), resolution=0.1,
                                           truncation=truncation))
    got = tdt.occupancy_to_sdf(torch.as_tensor(occ), resolution=0.1,
                               truncation=truncation).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert got[8, 8, 8] < 0 < got[0, 0, 0]


@pytest.mark.parametrize("case", ["denoise", "inpaint"])
def test_tvl1_matches_jax(case):
    """tests/test_tvl1.py's two inputs: within 1e-5 of JAX's (the same
    elementwise iteration; 120 / 200 steps of f32 rounding)."""
    if case == "denoise":
        rng = np.random.RandomState(0)
        x, y, z = np.mgrid[:24, :24, :24].astype(np.float32)
        clean = (np.sqrt((x - 12) ** 2 + (y - 12) ** 2 + (z - 12) ** 2)
                 - 8.0) / 8.0
        f = clean + rng.randn(24, 24, 24).astype(np.float32) * 0.1
        w = np.ones_like(clean)
        kw = dict(lam=1.0, n_iters=120)
    else:
        f = np.ones((16, 16, 16), np.float32) * 0.5
        w = np.ones_like(f)
        f[7:9, 7:9, 7:9] = -5.0
        w[7:9, 7:9, 7:9] = 0.0
        kw = dict(lam=5.0, n_iters=200)
    want = np.asarray(jtvl1.tvl1_refine(jnp.asarray(f), jnp.asarray(w), **kw))
    got = ttvl1.tvl1_refine(torch.as_tensor(f), torch.as_tensor(w),
                            **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(got - f).max() > 0.05         # it did refine
