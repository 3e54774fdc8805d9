"""Port parity for the evaluation Database: construction (gt volumes,
padding), ``filter``, ``filter_semantics`` (K5's plain version on the
CPU), meshing, saving and the three metric families, JAX package vs
``segfusion_tpu_torch``, on the same canonical state made with numpy.

Both Databases stand over a Synthetic dataset with the settings of
configs/fusion/synthetic_semantic.yaml (0.1 m voxels, 48x48 frames,
semantic gt grid, 8 classes): a 44^3 gt grid, Y-padded to 48. The state
is set identically on both sides, so everything is exact (tolerance 0)
except ``evaluate``, whose float sums may associate differently: within
1e-6 relative.
"""

import os
import sys

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segfusion_tpu.config import Config as JConfig, _DEFAULTS, _merge_defaults
from segfusion_tpu.core.database import Database as JDatabase
from segfusion_tpu.core.volume import SceneVolume as JSceneVolume
from segfusion_tpu.data.synthetic import Synthetic as JSynthetic
from segfusion_tpu.ops.integrate import pack_semantic_key as j_pack
from segfusion_tpu.utils.workspace import Workspace
from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.core.database import Database
from segfusion_tpu_torch.core.volume import SceneVolume
from segfusion_tpu_torch.data.synthetic import Synthetic
from segfusion_tpu_torch.utils import hdf5
from segfusion_tpu_torch.utils.workspace import Workspace as PortWorkspace
from test_torch_utils import jax_mcubes_private  # noqa: F401 (a fixture)

# the JAX Database meshes with segfusion_tpu.native.mcubes
pytestmark = pytest.mark.usefixtures("jax_mcubes_private")


def _data_config(**overrides):
    cfg = _merge_defaults(JConfig({}), _DEFAULTS)
    cfg.DATA.update(resx=48, resy=48, semantics="class8", semantic_grid=True,
                    n_classes=8, voxel_resolution=0.1, init_value=0.24,
                    n_frames=10)
    cfg.DATA.update(overrides)
    return cfg.DATA


def test_pad_shape_multiple_matches_jax():
    """DATA.pad_shape_multiple rounds every axis up before the Y-to-8 pad,
    in both packages: the default Synthetic grid (0.05 m, 84^3) pads to
    96^3 with multiple 16, and stays 84x88x84 without."""
    for multiple, want in ((16, (96, 96, 96)), (1, (84, 88, 84))):
        cfg = _data_config(voxel_resolution=0.05, semantic_grid=False,
                           pad_shape_multiple=multiple)
        jdb = JDatabase(JSynthetic(cfg), cfg)
        db = Database(Synthetic(Config(cfg), device="cpu"), Config(cfg),
                  device="cpu")
        s = db.scenes[0]
        assert tuple(jdb.volumes[s].num.shape) == want
        assert tuple(db.volumes[s].num.shape) == want
        assert tuple(db.scenes_gt[s].shape) == want


def _state(db, rng):
    """Canonical num / weights / semkey over the padded grid: the gt TSDF
    plus noise (so the estimate has a surface), weights uniform in [0, 1.5)
    with 30% unobserved (so filter(0.5) drops some), and the gt labels
    with 20% replaced by random ones (so the median changes labels)."""
    s = db.scenes[0]
    gt = db.scenes_gt[s].numpy()
    w = rng.uniform(0, 1.5, gt.shape).astype(np.float32)
    w[rng.uniform(size=gt.shape) < 0.3] = 0.0
    tsdf = gt + rng.normal(0, 0.02, gt.shape).astype(np.float32)
    num = (tsdf * w).astype(np.float32)
    ids = db.ids_gt[s].copy()
    noisy = rng.uniform(size=ids.shape) < 0.2
    ids[noisy] = rng.randint(0, 8, noisy.sum())
    scores = rng.uniform(0, 1, gt.shape).astype(np.float32)
    key = np.where(w > 0, np.asarray(j_pack(jnp.asarray(scores),
                                            jnp.asarray(ids))), 0)
    return num, w, key.astype(np.int32)


@pytest.fixture(scope="module")
def dbs():
    """(jax_db, port_db) with the same state, after filter(0.5) and
    filter_semantics(5) on both."""
    cfg = _data_config()
    jdb = JDatabase(JSynthetic(cfg), cfg)
    db = Database(Synthetic(Config(cfg), device="cpu"), Config(cfg),
                  device="cpu")
    s = db.scenes[0]
    num, w, key = _state(db, np.random.RandomState(0))
    jv = jdb.volumes[s]
    jdb.update(s, JSceneVolume(num=jnp.asarray(num), weights=jnp.asarray(w),
                               semkey=jnp.asarray(key), origin=jv.origin,
                               resolution=jv.resolution,
                               init_value=jv.init_value))
    v = db.volumes[s]
    db.update(s, SceneVolume(num=torch.as_tensor(num),
                             weights=torch.as_tensor(w),
                             semkey=torch.as_tensor(key), origin=v.origin,
                             resolution=v.resolution,
                             init_value=v.init_value))
    for d in (jdb, db):
        d.filter(0.5)
        d.filter_semantics(5)
    return jdb, db


def test_gt_volumes_match_jax(dbs):
    jdb, db = dbs
    assert db.scenes == jdb.scenes and len(db) == len(jdb) == 1
    s = db.scenes[0]
    assert db.grid_shape[s] == jdb.grid_shape[s] == (44, 44, 44)
    assert db.scenes_gt[s].dtype == torch.float32
    np.testing.assert_array_equal(db.scenes_gt[s].numpy(),
                                  np.asarray(jdb.scenes_gt[s]))
    np.testing.assert_array_equal(db.ids_gt[s], jdb.ids_gt[s])
    np.testing.assert_array_equal(db.origin[s], jdb.origin[s])
    assert db.resolution[s] == jdb.resolution[s]
    item, jitem = db[s], jdb[s]
    assert set(item) == set(jitem)
    np.testing.assert_array_equal(item["ids_gt"], jitem["ids_gt"])


def test_filters_match_jax(dbs):
    """filter zeroes (num, w) below the threshold and keeps the keys; the
    median runs on the Y-padded label volume: bit-exact."""
    jdb, db = dbs
    s = db.scenes[0]
    jv, v = jdb.volumes[s], db.volumes[s]
    np.testing.assert_array_equal(v.weights.numpy(), np.asarray(jv.weights))
    np.testing.assert_array_equal(v.num.numpy(), np.asarray(jv.num))
    np.testing.assert_array_equal(v.semkey.numpy(), np.asarray(jv.semkey))
    assert 0 < int((v.weights > 0).sum()) < v.weights.numel() // 2


def test_evaluate_matches_jax(dbs):
    jdb, db = dbs
    want, jper = jdb.evaluate("test")
    got, per = db.evaluate("test")
    assert set(got) == set(want) == {"mse", "mad", "iou", "acc"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=0)
    assert set(per) == set(jper)
    assert db.evaluate("train").keys() == want.keys()


def test_evaluate_semantics_matches_jax(dbs):
    jdb, db = dbs
    want, jcls = jdb.evaluate_semantics("test")
    got, cls = db.evaluate_semantics("test")
    assert got == want and cls == jcls
    assert 0 < got["Mean IoU"] < 1


def test_mesh_matches_jax(dbs):
    """The same marching tetrahedra on the same crop: vertices, faces,
    normals and semantic colours exact."""
    jdb, db = dbs
    s = db.scenes[0]
    got = db.get_mesh(s, semantics=True)
    want = jdb.get_mesh(s, semantics=True)
    assert len(got[0]) > 1000
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_fscore_matches_jax(dbs):
    jdb, db = dbs
    got, per = db.evaluate_fscore(threshold=0.05)
    want, jper = jdb.evaluate_fscore(threshold=0.05)
    assert got == want and per == jper
    assert 0 < got["fscore"] <= 1


def assert_same_hdf5(a, b):
    """The same datasets in dtype, shape, values, compression and chunk
    shape; each file read through the port's reader as h5py reads it."""
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        assert list(fa) == list(fb)
        for k in fa:
            assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape
            assert (fa[k].compression, fa[k].compression_opts,
                    fa[k].chunks) == (fb[k].compression,
                                      fb[k].compression_opts, fb[k].chunks)
            np.testing.assert_array_equal(fb[k][()], fa[k][()])
            for path, d in ((a, fa[k]), (b, fb[k])):
                with hdf5.File(str(path), "r") as f:
                    assert f[k].dtype == d.dtype
                    assert f[k].tobytes() == d[()].tobytes()


def test_save_matches_jax(dbs, tmp_path, monkeypatch):
    """save in "test" mode, the port's with h5py blocked: the hdf5
    datasets equal, the ply files (mesh and semantic mesh) byte-equal."""
    jdb, db = dbs
    s = db.scenes[0]
    jdb.save(str(tmp_path / "jax"), save_mode="test", scene_id=s)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        db.save(str(tmp_path / "port"), save_mode="test", scene_id=s)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert sum(n.endswith(".hf5") for n in names) == 3
    assert sum(n.endswith(".ply") for n in names) == 2
    for n in names:
        a, b = tmp_path / "jax" / n, tmp_path / "port" / n
        if n.endswith(".ply"):
            assert a.read_bytes() == b.read_bytes(), n
            continue
        assert_same_hdf5(a, b)


def test_save_to_workspace_matches_jax(dbs, tmp_path, monkeypatch):
    """The workspace savers (gzip hdf5, ply), each package's own, the
    port's with h5py blocked: the same datasets (gzip 9 at h5py's chunk
    shape), the ply byte-equal."""
    jdb, db = dbs
    outs = []
    for name, d, ws_cls in (("jax", jdb, Workspace),
                            ("port", db, PortWorkspace)):
        ws = ws_cls(str(tmp_path / name), enable_tensorboard=False)
        with monkeypatch.context() as m:
            if name == "port":
                m.setitem(sys.modules, "h5py", None)
            d.save_to_workspace(ws, "val", save_mode="test")
        outs.append(ws.output_path)
    names = sorted(os.listdir(outs[0]))
    assert names == sorted(os.listdir(outs[1])) and len(names) == 4
    for n in names:
        a, b = (os.path.join(o, n) for o in outs)
        if n.endswith(".ply"):
            assert open(a, "rb").read() == open(b, "rb").read()
            continue
        assert_same_hdf5(a, b)


def test_save_ply_mode_writes_mesh_only(dbs, tmp_path):
    _, db = dbs
    s = db.scenes[0]
    db.save(str(tmp_path), save_mode="ply", scene_id=s)
    assert os.listdir(tmp_path) == [f"{s}.ply"]


def test_no_surface():
    """A TSDF without a zero crossing: get_mesh raises ValueError, as the
    JAX package's does; evaluate_fscore skips the scene."""
    cfg = Config(_data_config(semantic_grid=False))
    empty = Database(Synthetic(cfg, device="cpu"), cfg, device="cpu")
    s = empty.scenes[0]
    empty.update(s, empty.volumes[s])       # observed nowhere: tsdf = 0.24
    with pytest.raises(ValueError, match="no isosurface"):
        empty.get_mesh(s)
    assert empty.evaluate_fscore()[1] == {}


def test_scene_without_gt_uses_create_grid():
    """A scene whose gt grid is missing gets the dataset's empty grid over
    the scene (create_grid): the same shapes and origin as JAX's."""
    class NoGt(Synthetic):
        def get_grid(self, scene_id, initial_value, semantic_grid=False):
            raise FileNotFoundError(scene_id)

        def create_grid(self, scene_id, initial_value):
            return Synthetic.get_grid(self, scene_id, initial_value)

    cfg = Config(_data_config())
    db = Database(NoGt(cfg, device="cpu"), cfg, device="cpu")
    jdb = JDatabase(JSynthetic(cfg), cfg)
    s = db.scenes[0]
    assert db.grid_shape[s] == jdb.grid_shape[s]
    np.testing.assert_array_equal(db.origin[s], jdb.origin[s])
    np.testing.assert_array_equal(db.scenes_gt[s].numpy(),
                                  np.asarray(jdb.scenes_gt[s]))
    assert s not in db.ids_gt
    got = Synthetic(cfg, device="cpu").create_grid(s, 0.24)
    want = JSynthetic(cfg).create_grid(s, 0.24)
    assert got[1] is None and want[1] is None
    np.testing.assert_array_equal(got[0].volume, want[0].volume)
