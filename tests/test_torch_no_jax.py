"""The port runs where there is no JAX: every module of
``segfusion_tpu_torch`` (its ``test_fusion`` entry point included) and
``chip_smoke.py`` import with ``jax``, ``jaxlib``, ``flax``, ``optax``,
``msgpack``, ``yaml``, ``h5py``, ``orbax``, ``tensorstore`` and
``zstandard`` blocked, and with the whole
``segfusion_tpu`` namespace (the JAX package, host modules included)
blocked too: the port keeps its own copies of what it needs (its
checkpoint, HDF5, zstd, OCDBT and zarr codecs included). No source file
of the port, nor ``chip_smoke.py``, imports h5py, orbax, tensorstore or
zstandard anywhere, inside a function either."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "msgpack", "yaml",
               "h5py", "orbax", "tensorstore", "zstandard", "segfusion_tpu"}

    def refused(name):
        return name.split(".")[0] in BLOCKED

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if refused(name):
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import segfusion_tpu_torch
    names = ["chip_smoke"] + [
        m.name for m in pkgutil.walk_packages(
            segfusion_tpu_torch.__path__, "segfusion_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    assert "segfusion_tpu_torch.test_fusion" in names
    assert "segfusion_tpu_torch.probes.random_access" in names
    assert "segfusion_tpu_torch.train_fusion" in names
    assert "segfusion_tpu_torch.utils.checkpoints" in names
    for new in ("models.layers", "train_segmentation", "test_segmentation",
                "seg_quality_demo", "quality_demo", "utils.torch_import",
                "utils.png", "ops.tsdf_fusion", "core.tsdf_volume",
                "ops.distance_transform", "ops.tvl1", "parallel",
                "parallel.mesh", "parallel.scene_parallel",
                "parallel.shard_kernels", "parallel.spatial",
                "parallel.multihost", "parallel.multihost_worker",
                "models.fusionnet_fast", "utils.tracing",
                "utils.torch_convert", "convert_checkpoint",
                "utils.rasterize", "utils.simplify", "utils.meshio",
                "preprocess", "preprocess.common", "preprocess.scale",
                "preprocess.fuse", "preprocess.simplify", "data.replica",
                "data.scannet", "data.transforms", "data.augmentations",
                "utils.mapping", "utils.hdf5", "utils.zstd", "utils.ocdbt",
                "utils.zarr", "utils.fixtures", "setup"):
        assert "segfusion_tpu_torch." + new in names, new
    leaked = sorted(m for m in sys.modules if refused(m))
    assert not leaked, leaked
    print(len(names))
""")


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # chip_smoke + the package's modules (ops, kernels, models, core,
    # utils, probes, the CLIs, parallel, ...)
    assert int(proc.stdout.split()[-1]) >= 75


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result line where
    torch sees no CUDA device (this machine) or where it stands alone."""
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(ROOT,
                                                        "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _imports_of(module: str) -> list:
    """Every import statement in the port's sources and in
    ``chip_smoke.py``, at any depth, that names ``module``."""
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "segfusion_tpu_torch")):
        sources += [os.path.join(base, f) for f in files if f.endswith(".py")]
    assert len(sources) >= 75
    found = []
    for path in sources:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            found += [f"{os.path.relpath(path, ROOT)}:{node.lineno}"
                      for n in names if n.split(".")[0] == module]
    return found


def test_port_sources_never_import_h5py():
    """Every import statement in the port's sources and in
    ``chip_smoke.py``, at any depth: none names h5py."""
    found = _imports_of("h5py")
    assert not found, found


@pytest.mark.parametrize("module", ["orbax", "tensorstore", "zstandard"])
def test_port_sources_never_import_orbax_libraries(module):
    """The orbax checkpoints go through the port's own zstd, OCDBT and
    zarr codecs: no import of orbax, tensorstore or zstandard anywhere in
    the port or ``chip_smoke.py``."""
    found = _imports_of(module)
    assert not found, found
