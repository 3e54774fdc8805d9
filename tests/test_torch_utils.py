"""The port's own host modules and its choice of device.

``segfusion_tpu_torch/utils/{metrics,mapping,meshio,workspace}.py`` are
copies of the JAX package's host modules, trimmed to what the port calls:
on the same seeded inputs they give the same numbers and the same ply
bytes (tolerance 0). ``csrc/mcubes.cpp`` is the JAX package's
``native/mcubes.cpp`` byte for byte.

Every entry point of the port defaults to ``device="cuda"`` and raises
where torch sees no CUDA device; the CPU runs only where it is named.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

from segfusion_tpu.utils import mapping as j_mapping
from segfusion_tpu.utils import meshio as j_meshio
from segfusion_tpu.utils import metrics as j_metrics
from segfusion_tpu.utils import workspace as j_workspace
from segfusion_tpu_torch.utils import mapping, meshio, metrics, workspace
from segfusion_tpu_torch.utils.mesh import MCUBES_SOURCE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_SEM = os.path.join(ROOT, "configs", "fusion", "synthetic_semantic.yaml")


@pytest.fixture(scope="module")
def jax_mcubes_private(tmp_path_factory):
    """The JAX package's marching cubes, loaded from this worker's own
    library. Its default library, ``segfusion_tpu/native/libmcubes.so``,
    is built in place at first use, and a worker that loads it while
    another is still writing it fails ("file too short"). The private one
    lies in the worker's base temp directory, so each worker runs g++ once.
    The native library must load: the numpy fallback meshes differently.
    tests/test_torch_{database,test_fusion}.py import this fixture."""
    from segfusion_tpu.native import mcubes as j_mcubes

    lib_dir = tmp_path_factory.getbasetemp() / "jax_mcubes"
    lib_dir.mkdir(exist_ok=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_mcubes, "_SO", str(lib_dir / "libmcubes.so"))
        mp.setattr(j_mcubes, "_lib", None)
        mp.setattr(j_mcubes, "_build_failed", False)
        assert j_mcubes.native_available()
        yield


def _volumes(seed=0, shape=(20, 24, 16)):
    rng = np.random.RandomState(seed)
    est = rng.normal(0, 0.05, shape).astype(np.float32)
    est[rng.uniform(size=shape) < 0.01] = np.nan
    gt = rng.normal(0, 0.05, shape).astype(np.float32)
    mask = rng.uniform(size=shape) < 0.6
    return est, gt, mask


@pytest.mark.parametrize("masked", [True, False])
def test_evaluation_matches_jax(masked):
    est, gt, mask = _volumes()
    m = mask if masked else None
    assert metrics.evaluation(est, gt, m) == j_metrics.evaluation(est, gt, m)


@pytest.mark.parametrize("n_class", [4, 8])
def test_semantic_evaluation_matches_jax(n_class):
    rng = np.random.RandomState(1)
    est = rng.randint(0, n_class, (16, 16, 16)).astype(np.uint8)
    gt = np.where(rng.uniform(size=est.shape) < 0.7, est,
                  rng.randint(0, n_class, est.shape)).astype(np.uint8)
    mask = rng.uniform(size=est.shape) < 0.5
    got = metrics.semantic_evaluation(est, gt, mask, n_class)
    assert got == j_metrics.semantic_evaluation(est, gt, mask, n_class)
    assert 0 < got[0]["Mean IoU"] < 1


@pytest.mark.parametrize("max_points", [200_000, 500])
def test_fscore_matches_jax(max_points):
    """Also with subsampling (the same seeded draw on both sides)."""
    rng = np.random.RandomState(2)
    gt = rng.uniform(0, 1, (2000, 3)).astype(np.float32)
    est = gt + rng.normal(0, 0.03, gt.shape).astype(np.float32)
    got = metrics.fscore(est, gt, threshold=0.05, max_points=max_points)
    assert got == j_metrics.fscore(est, gt, threshold=0.05,
                                   max_points=max_points)
    assert 0 < got["fscore"] < 1
    assert metrics.fscore(est[:0], gt) == j_metrics.fscore(est[:0], gt)


def test_get_mapping_matches_jax():
    np.testing.assert_array_equal(mapping.get_mapping(),
                                  j_mapping.get_mapping())
    np.testing.assert_array_equal(mapping.get_mapping(41),
                                  j_mapping.get_mapping(41))


@pytest.mark.parametrize("extras", ["plain", "normals", "rgb", "rgba"])
def test_write_ply_bytes_match_jax(tmp_path, extras):
    rng = np.random.RandomState(3)
    verts = rng.randn(50, 3).astype(np.float32)
    faces = rng.randint(0, 50, (30, 3))
    kw = {}
    if extras != "plain":
        kw["normals"] = rng.randn(50, 3).astype(np.float32)
    if extras in ("rgb", "rgba"):
        kw["colors"] = rng.randint(0, 256, (50, 3 if extras == "rgb" else 4))
    meshio.write_ply(str(tmp_path / "port.ply"), verts, faces, **kw)
    j_meshio.write_ply(str(tmp_path / "jax.ply"), verts, faces, **kw)
    assert (tmp_path / "port.ply").read_bytes() == \
        (tmp_path / "jax.ply").read_bytes()


def test_workspace_matches_jax(tmp_path, monkeypatch, jax_mcubes_private):
    """The same directory tree, config snapshot, hdf5 datasets and meshed
    ply; the port's workspace meshes with its own marching cubes and
    writes its hdf5 with h5py blocked."""
    from segfusion_tpu.config import load_config

    tsdf = _volumes(4)[1] * 4
    for name, mod in (("port", workspace), ("jax", j_workspace)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        cfg = load_config(CFG_SEM)
        cfg.SETTINGS.experiment_path = "ws"
        cfg["TIMESTAMP"] = "t0"
        ws = mod.get_workspace(cfg)
        ws.log("hello", "test")
        with monkeypatch.context() as m:
            if name == "port":
                m.setitem(sys.modules, "h5py", None)
            ws.save_tsdf_data("v.tsdf.hf5", tsdf)
        ws.save_ply_data("v.ply", tsdf, voxel_size=0.05)
    port, jax_ = (tmp_path / name / "ws" / "t0" for name in ("port", "jax"))

    def listing(path):
        # tensorboardX names its event file after the second it was opened
        # in; the two workspaces may open theirs in different seconds
        return sorted(re.sub(r"^(events\.out\.tfevents\.)\d+\.", r"\1<s>.", n)
                      for n in os.listdir(path))

    for sub in ("model", "logs", "output"):
        assert listing(port / sub) == listing(jax_ / sub)
    assert (port / "config.json").read_text() == \
        (jax_ / "config.json").read_text()
    assert (port / "output" / "v.ply").read_bytes() == \
        (jax_ / "output" / "v.ply").read_bytes()
    import h5py
    with h5py.File(port / "output" / "v.tsdf.hf5") as a, \
            h5py.File(jax_ / "output" / "v.tsdf.hf5") as b:
        np.testing.assert_array_equal(a["TSDF"][()], b["TSDF"][()])
        assert a["TSDF"].dtype == b["TSDF"].dtype
        assert (a["TSDF"].compression_opts, a["TSDF"].chunks) == \
            (b["TSDF"].compression_opts, b["TSDF"].chunks)


def test_mcubes_source_is_the_jax_packages():
    jax_src = os.path.join(ROOT, "segfusion_tpu", "native", "mcubes.cpp")
    assert MCUBES_SOURCE.read_bytes() == open(jax_src, "rb").read()
    assert "segfusion_tpu_torch" in str(MCUBES_SOURCE)


# -- the device ---------------------------------------------------------------------

def _entry_points():
    """name -> a call of a public entry point with its default device."""
    from segfusion_tpu_torch import test_fusion as entry
    from segfusion_tpu_torch.config import Config, load_config
    from segfusion_tpu_torch.core.database import Database
    from segfusion_tpu_torch.core.pipeline import Pipeline
    from segfusion_tpu_torch.core.volume import init_scene_volume
    from segfusion_tpu_torch.data import Synthetic, get_data
    from segfusion_tpu_torch.probes import (dynamic_gather, pallas_caps,
                                            pallas_caps2, pallas_caps3,
                                            random_access, shadow_debug,
                                            shadow_variants)

    def cfg():
        return Config(load_config(CFG_SEM))

    return {
        "Pipeline": lambda: Pipeline(cfg()),
        "Database": lambda: Database(None, cfg().DATA),
        "test_fusion": lambda: entry.test_fusion(cfg()),
        "test_fusion --config": lambda: entry.main(["--config", CFG_SEM]),
        "get_data": lambda: get_data("Synthetic", cfg().DATA),
        "Synthetic": lambda: Synthetic(cfg().DATA),
        "init_scene_volume": lambda: init_scene_volume((4, 4, 4), [0] * 3,
                                                       0.1),
        **{f"probes.{m.__name__.rsplit('.', 1)[1]}.main": m.main
           for m in (shadow_variants, random_access, dynamic_gather,
                     pallas_caps3, pallas_caps, pallas_caps2, shadow_debug)},
    }


ENTRY_POINTS = ["Pipeline", "Database", "test_fusion", "test_fusion --config",
                "get_data", "Synthetic", "init_scene_volume",
                "probes.shadow_variants.main", "probes.random_access.main",
                "probes.dynamic_gather.main", "probes.pallas_caps3.main",
                "probes.pallas_caps.main", "probes.pallas_caps2.main",
                "probes.shadow_debug.main"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_refuses_cuda_without_a_card(name, monkeypatch,
                                                 tmp_path):
    """The default device is the card; where torch sees none, the entry
    point raises before any work instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    calls = _entry_points()
    assert set(calls) == set(ENTRY_POINTS)
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        calls[name]()
