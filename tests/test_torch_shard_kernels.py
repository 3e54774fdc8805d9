"""The port's x-sharded slot kernels (``parallel/shard_kernels.py``) on 4
slabs of an (8, 8, 40) volume: equal to the unsharded wrappers and to the
JAX package's shard_map'd kernels on the 4-device CPU mesh (interpret
mode), bit for bit; the dirty build updates each slab's shadow in place;
an x extent the mesh does not divide raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from segfusion_tpu.parallel import shard_kernels as jsk
from segfusion_tpu_torch.ops import rowvol
from segfusion_tpu_torch.parallel import shard_kernels as sk
from segfusion_tpu_torch.parallel.mesh import Mesh, data_parallel_mesh
from tests.test_shard_kernels import _reachable_geo
from tests.test_torch_nets import one_torch_thread  # noqa: F401 (a fixture)

L = rowvol.RowLayout.for_shape((8, 8, 40))


def _meshes():
    jmesh = JMesh(np.asarray(jax.devices()[:4]), ("x",))
    return jmesh, data_parallel_mesh("x", ["cpu"] * 4)


def _jsharded(x, jmesh):
    return jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P("x", None)))


def _cat(slabs):
    return torch.cat(list(slabs))


def test_sharded_build_shadow():
    jmesh, mesh = _meshes()
    geo = np.array(_reachable_geo(L, np.random.RandomState(0)))
    got = sk.sharded_build_shadow(torch.as_tensor(geo), L, mesh)
    assert len(got) == 4 and got[0].shape == (L.shadow_rows // 4, 128)
    want = rowvol.build_shadow(torch.as_tensor(geo), L)
    assert torch.equal(_cat(got), want)
    jgot = jax.jit(lambda g: jsk.sharded_build_shadow(
        g, L, jmesh, interpret=True))(_jsharded(geo, jmesh))
    np.testing.assert_array_equal(_cat(got).numpy(),
                                  np.asarray(jgot).view(np.int32))
    # slabs given as a list
    slabs = list(torch.as_tensor(geo).chunk(4))
    assert torch.equal(_cat(sk.sharded_build_shadow(slabs, L, mesh)), want)


def test_sharded_build_shadow_dirty():
    jmesh, mesh = _meshes()
    rng = np.random.RandomState(1)
    geo = np.array(_reachable_geo(L, rng))
    _, NJ = rowvol.shadow_tiling(L)
    nt = L.X * NJ
    prev = rng.randint(0, 2 ** 32, (L.shadow_rows, 128), dtype=np.uint32)
    dirty = np.zeros((nt + 1,), np.int32)
    dirty[:nt:2] = 1
    dirty[1:nt:5] = 1
    tprev = torch.as_tensor(prev.view(np.int32).copy())
    slabs = list(tprev.chunk(4))
    got = sk.sharded_build_shadow_dirty(torch.as_tensor(geo), slabs,
                                        torch.as_tensor(dirty), L, mesh)
    assert all(g.data_ptr() == s.data_ptr() for g, s in zip(got, slabs))
    want = rowvol.build_shadow_dirty(
        torch.as_tensor(geo), torch.as_tensor(prev.view(np.int32).copy()),
        torch.as_tensor(dirty), L)
    assert torch.equal(tprev, want)
    jgot = jax.jit(lambda g, p, d: jsk.sharded_build_shadow_dirty(
        g, p, d, L, jmesh, interpret=True))(
            _jsharded(geo, jmesh), _jsharded(prev, jmesh),
            jnp.asarray(dirty))
    np.testing.assert_array_equal(tprev.numpy(),
                                  np.asarray(jgot).view(np.int32))


def test_sharded_reconciles():
    jmesh, mesh = _meshes()
    rng = np.random.RandomState(2)
    geo = rng.randn(L.geo_rows, 128).astype(np.float32)
    key = rng.randint(0, 2 ** 31 - 1, (L.key_rows, 128), dtype=np.int32)
    nums, ws = sk.sharded_reconcile_slot(torch.as_tensor(geo), L, mesh)
    keys = sk.sharded_reconcile_key(torch.as_tensor(key), L, mesh)
    assert nums[0].shape == (2, 8, 40)
    wn, ww, wk = rowvol.volume_from_rows(torch.as_tensor(geo),
                                         torch.as_tensor(key), L)
    assert torch.equal(_cat(nums), wn) and torch.equal(_cat(ws), ww)
    assert torch.equal(_cat(keys), wk)
    jn, jw = jax.jit(lambda g: jsk.sharded_reconcile_slot(
        g, L, jmesh, interpret=True))(_jsharded(geo, jmesh))
    jk = jax.jit(lambda k: jsk.sharded_reconcile_key(
        k, L, jmesh, interpret=True))(_jsharded(key, jmesh))
    np.testing.assert_array_equal(_cat(nums).numpy(), np.asarray(jn))
    np.testing.assert_array_equal(_cat(ws).numpy(), np.asarray(jw))
    np.testing.assert_array_equal(_cat(keys).numpy(), np.asarray(jk))


def test_x_divisibility_guard():
    mesh = Mesh((torch.device("cpu"),) * 4, "x")
    bad = rowvol.RowLayout.for_shape((6, 8, 40))
    with pytest.raises(ValueError, match="not divisible"):
        sk.check_x_divisible(bad, mesh, "x")
    with pytest.raises(ValueError, match="not divisible"):
        sk.sharded_build_shadow(torch.zeros((bad.geo_rows, 128)), bad, mesh)
    assert sk.check_x_divisible(L, mesh, "x") == 4
    with pytest.raises(ValueError, match="axis"):
        sk.check_x_divisible(L, mesh, "scene")
