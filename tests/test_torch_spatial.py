"""The port's spatially sharded fusion (``parallel/spatial.py``): ``step``
and ``fuse_sequence`` over 8 CPU "devices" (x-slabs of one scene) against
the unsharded port pipeline -- bit for bit on the CPU, each scatter keeps
its unsharded order and the net runs once a frame -- and against the JAX
package's ``SpatialShardedFusion`` on the 8-device CPU mesh within the
tolerances of tests/test_spatial_sharding.py (weights 1e-4, num 1e-3,
keys exact); on the row path (the dirty carry on and off) and on the flat
scalar path (both gather precisions). A one-device mesh is the ordinary
step; an x extent the mesh does not divide raises."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segfusion_tpu.core.database import Database as JDatabase
from segfusion_tpu.core.pipeline import Pipeline as JPipeline
from segfusion_tpu.data.synthetic import Synthetic as JSynthetic
from segfusion_tpu.parallel import spatial as jspatial
from segfusion_tpu.parallel.mesh import scene_mesh as jscene_mesh
from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.core.database import Database
from segfusion_tpu_torch.core.pipeline import Pipeline
from segfusion_tpu_torch.core.volume import init_scene_volume
from segfusion_tpu_torch.parallel import shard_kernels as sk
from segfusion_tpu_torch.parallel.mesh import scene_mesh
from segfusion_tpu_torch.parallel.spatial import (SpatialShardedFusion,
                                                  shard_volume_spatial,
                                                  unshard_volume_spatial)
from segfusion_tpu_torch.utils.convert import fusionnet_from_flax
from tests.test_pipeline import _batch, small_config
from tests.test_torch_nets import one_torch_thread  # noqa: F401 (a fixture)

N_FRAMES = 3
CPU8 = ["cpu"] * 8


def _jax_config(**settings):
    cfg = small_config(use_semantics=False, semantics="class8")
    cfg.DATA.semantic_grid = True
    cfg.DATA.pad_shape_multiple = 8       # x divisible by the mesh
    cfg.SETTINGS.update(**settings)
    return cfg


@pytest.fixture(scope="module")
def data():
    cfg = _jax_config()
    jdata = JSynthetic(cfg.DATA)
    jpipe = JPipeline(cfg)
    params, stats = jpipe.init_fusion_params(jax.random.PRNGKey(0), 48, 48)
    frames = [jpipe._frame_from_batch(_batch(jdata, i), cfg.DATA.input)
              for i in range(N_FRAMES)]
    return jdata, params, stats, frames


def _port(cfg, params, stats, jdata):
    pcfg = Config(copy.deepcopy(cfg))
    pipe = Pipeline(pcfg, fusion_net=fusionnet_from_flax(
        params, stats, pcfg.FUSION_MODEL), device="cpu")
    return pipe, Database(jdata, pcfg.DATA, device="cpu")


def _check(v, v_ref, exact):
    assert int((v_ref.weights > 0.05).sum()) > 100
    if exact:
        for a, b in ((v.num, v_ref.num), (v.weights, v_ref.weights),
                     (v.semkey, v_ref.semkey)):
            assert torch.equal(a, torch.as_tensor(np.asarray(b)))
        return
    np.testing.assert_allclose(v.weights.numpy(), np.asarray(v_ref.weights),
                               atol=1e-4)
    np.testing.assert_allclose(v.num.numpy(), np.asarray(v_ref.num),
                               atol=1e-3)
    np.testing.assert_array_equal(v.semkey.numpy(), np.asarray(v_ref.semkey))


@pytest.mark.parametrize("settings", [
    {"dirty_shadow": "on"}, {"dirty_shadow": "off"},
    {"integration": "scalar", "gather_precision": "f16packed"},
    {"integration": "scalar", "gather_precision": "f32"}])
def test_step_and_fuse_sequence_match(data, settings):
    jdata, params, stats, frames = data
    cfg = _jax_config(**settings)
    s = jdata.scenes[0]
    jpipe = JPipeline(cfg)
    jdb = JDatabase(jdata, cfg.DATA)
    jrunner = jspatial.SpatialShardedFusion(
        jpipe, jscene_mesh("x", devices=jax.devices()[:8]))
    jv = jrunner.shard(jdb.volumes[s])
    for f in frames:
        jv = jrunner.step((params, stats), jv, f)
    stream = {k: np.stack([np.asarray(f[k]) for f in frames])
              for k in frames[0]}
    jdb.reset()
    jseq = jrunner.fuse_sequence(
        (params, stats), jrunner.shard(jdb.volumes[s]),
        {k: jnp.asarray(v) for k, v in stream.items()})

    pipe, db = _port(cfg, params, stats, jdata)
    assert pipe.row_path == (settings.get("integration", "rows") == "rows")
    assert db.volumes[s].num.shape[0] % 8 == 0
    runner = SpatialShardedFusion(pipe, scene_mesh("x", CPU8))
    slabs = runner.shard(db.volumes[s])
    assert len(slabs) == 8
    assert slabs[0].num.shape[0] == db.volumes[s].num.shape[0] // 8
    for f in frames:
        slabs = runner.step(slabs, f)
    v = unshard_volume_spatial(slabs)
    # (the flat path updates the slabs in place: views of the Database's
    # volume, as the unsharded flat step updates that volume)
    db.reset()
    seq = unshard_volume_spatial(runner.fuse_sequence(
        runner.shard(db.volumes[s]), stream))

    # the unsharded port: per-frame steps, and one stream
    db.reset()
    v_ref = db.volumes[s]
    for f in frames:
        v_ref = pipe.step_fuse_impl(v_ref, {k: torch.as_tensor(x)[None]
                                            for k, x in f.items()})
    db.reset()
    seq_ref = pipe.fuse_sequence(db.volumes[s], {
        k: torch.as_tensor(x) for k, x in stream.items()})
    _check(v, v_ref, exact=True)
    _check(seq, seq_ref, exact=True)
    _check(v, jv, exact=False)
    _check(seq, jseq, exact=False)


def test_one_device_mesh_is_the_ordinary_step(data):
    jdata, params, stats, frames = data
    cfg = _jax_config(integration="scalar")
    s = jdata.scenes[0]
    pipe, db = _port(cfg, params, stats, jdata)
    runner = SpatialShardedFusion(pipe, scene_mesh("x", ["cpu"]))
    slabs = runner.shard(db.volumes[s])
    for f in frames:
        slabs = runner.step(slabs, f)
    db.reset()
    v_ref = db.volumes[s]
    for f in frames:
        v_ref = pipe.step_fuse_impl(v_ref, {k: torch.as_tensor(x)[None]
                                            for k, x in f.items()})
    _check(slabs[0], v_ref, exact=True)


def test_refusals():
    mesh = scene_mesh("x", CPU8)
    v = init_scene_volume((10, 8, 8), np.zeros(3), 0.1, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        shard_volume_spatial(v, mesh)
    assert sk.check_x_divisible(
        sk.rowvol.RowLayout.for_shape((16, 8, 8)), mesh, "x") == 8
