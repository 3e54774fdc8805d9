"""Port parity for the small public functions that the port's modules
first left out: ``Config.get_path`` / ``save_json`` / ``__delattr__`` and
``load_config_from_yaml``; ``Voxelgrid.create`` / ``shape`` /
``world_to_voxel`` / ``voxel_to_world``; ``SceneVolume.shape`` /
``reset``; ``SyntheticScene.sdf`` / ``labels``. Each against the JAX
package's on the same inputs: equal (float results to float32's last
bit, as both compute in the same order)."""

import json
import os

import numpy as np
import pytest
import torch

from segfusion_tpu import config as j_config
from segfusion_tpu.core import volume as j_volume
from segfusion_tpu.data.synthetic import SyntheticScene as JScene
from segfusion_tpu_torch import config
from segfusion_tpu_torch.core import volume
from segfusion_tpu_torch.data.synthetic import SyntheticScene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [os.path.join(ROOT, "configs", *p) for p in (
    ("fusion", "replica_accuracy.yaml"),
    ("segmentation", "scannet_multi.yaml"))]


def common_leaves(got: dict, want: dict, where=()) -> int:
    """Asserts equal values at the leaves both trees hold; their count."""
    n = 0
    for k in set(got) & set(want):
        if isinstance(got[k], dict) and isinstance(want[k], dict):
            n += common_leaves(got[k], want[k], where + (k,))
        else:
            assert got[k] == want[k], where + (k,)
            n += 1
    return n


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_functions_match_jax(tmp_path, path):
    got = config.load_config_from_yaml(path)
    want = j_config.load_config_from_yaml(path)
    for dotted in ("TRAINING.optimizer.lr", "DATA.resx", "DATA.nope",
                   "SETTINGS.seed.deeper", "SEMANTIC_2D_MODEL.n_classes",
                   "TRAINING.optimization.accumulation_steps"):
        assert got.get_path(dotted, "dflt") == want.get_path(dotted, "dflt")
    # save_json: equal values at every leaf both hold (the packages'
    # defaults differ in which keys they add)
    got.save_json(str(tmp_path / "port.json"))
    want.save_json(str(tmp_path / "jax.json"))
    with open(tmp_path / "port.json") as f:
        g = json.load(f)
    with open(tmp_path / "jax.json") as f:
        w = json.load(f)
    assert common_leaves(g, w) > 40
    del got.TESTING.test_ratio
    del want.TESTING.test_ratio
    assert "test_ratio" not in got.TESTING
    with pytest.raises(AttributeError):
        got.TESTING.test_ratio


@pytest.mark.parametrize("res,init", [(0.05, 0.0), (0.03, 0.1)])
def test_voxelgrid_matches_jax(res, init):
    bbox = np.array([[-1.0, 0.52], [0.1, 0.9], [2.0, 2.33]])
    got = volume.Voxelgrid.create(bbox, res, init_value=init)
    want = j_volume.Voxelgrid.create(bbox, res, init_value=init)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.volume, want.volume)
    np.testing.assert_array_equal(got.bbox, want.bbox)
    pts = np.random.RandomState(0).uniform(-1, 2, (20, 3))
    np.testing.assert_array_equal(got.world_to_voxel(pts),
                                  want.world_to_voxel(pts))
    idx = np.random.RandomState(1).randint(0, 30, (20, 3))
    np.testing.assert_array_equal(got.voxel_to_world(idx),
                                  want.voxel_to_world(idx))


def test_scene_volume_shape_and_reset_match_jax():
    shape, origin = (6, 8, 5), np.array([0.5, -1.0, 2.0], np.float32)
    rng = np.random.RandomState(2)
    num = rng.uniform(-1, 1, shape).astype(np.float32)
    w = rng.uniform(0, 3, shape).astype(np.float32)
    key = rng.randint(0, 2 ** 20, shape).astype(np.int32)
    got = volume.SceneVolume(
        torch.as_tensor(num), torch.as_tensor(w), torch.as_tensor(key),
        torch.as_tensor(origin), torch.tensor(0.04), 0.1)
    want = j_volume.SceneVolume(num, w, key, origin, np.float32(0.04), 0.1)
    assert tuple(got.shape) == tuple(want.shape)
    for init in (None, 0.24):
        g, r = got.reset(init), want.reset(init)
        assert g.init_value == r.init_value
        for name in ("num", "weights", "semkey", "origin", "resolution",
                     "tsdf"):
            a, b = getattr(g, name), np.asarray(getattr(r, name))
            assert a.numpy().dtype == b.dtype, name
            np.testing.assert_array_equal(a.numpy(), b)
    assert got.num.abs().sum() > 0       # reset left the original alone


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_scene_sdf_and_labels_match_jax(seed):
    pts = np.random.RandomState(seed).uniform(-2.2, 2.2, (500, 3))
    got, want = SyntheticScene(seed), JScene(seed)
    np.testing.assert_array_equal(got.sdf(pts), want.sdf(pts))
    lab = got.labels(pts)
    assert lab.dtype == np.uint8
    np.testing.assert_array_equal(lab, want.labels(pts))
    assert 0 in lab and 1 in lab
