"""The port's offline mesh preprocessing against the JAX package's:
the native rasterizer and simplifier (``segfusion_tpu_torch/utils/
{rasterize,simplify}.py`` over byte-for-byte copies of the JAX package's
C++ sources) against ``segfusion_tpu/native`` and the plain numpy
versions, the ``fuse`` round trip on a sphere against
``tools/preprocess/fuse.py``, and the three ``python -m`` steps on a
mesh file (tests/test_preprocess.py's checks)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from segfusion_tpu.native import rasterize as j_rasterize
from segfusion_tpu.native import simplify as j_simplify
from segfusion_tpu_torch.preprocess.common import (fibonacci_sphere_views,
                                                   look_at_view, save_mesh)
from segfusion_tpu_torch.preprocess.fuse import erode_depth, fuse_mesh
from segfusion_tpu_torch.utils import rasterize as rz
from segfusion_tpu_torch.utils import simplify as sp
from segfusion_tpu_torch.utils.mesh import marching_cubes
from segfusion_tpu_torch.utils.meshio import read_off
from tests.test_torch_nets import one_torch_thread  # noqa: F401 (a fixture)
from tests.test_torch_utils import jax_mcubes_private  # noqa: F401 (a fixture)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tools", "preprocess"))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sphere_mesh(r=0.4, n=24):
    x, y, z = np.mgrid[:n, :n, :n].astype(np.float32)
    c = (n - 1) / 2
    sdf = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) - r * n
    v, f, _ = marching_cubes(sdf, 0.0, spacing=1.0 / n)
    return (v - 0.5).astype(np.float32), f


def _camera(h=48, w=48, eye=(0.6, 0.5, -1.0)):
    view = look_at_view(np.array(eye, np.float32))
    k = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]],
                 np.float32)
    return view, k


def test_rasterizer_matches_jax_and_plain():
    """Depth: the port's library equals the JAX package's bit for bit
    and the plain version within 1e-3 where both hit; the full render's
    mask and rgb (flat-shaded and with vertex colours) equal JAX's."""
    verts, faces = sphere_mesh()
    view, k = _camera()
    d = rz.rasterize_depth(verts, faces, view, k, 48, 48)
    np.testing.assert_array_equal(
        d, j_rasterize.rasterize_depth(verts, faces, view, k, 48, 48))
    plain, _ = rz.rasterize_plain(verts, faces, view, k, 48, 48)
    hit = (d > 0) & (plain > 0)
    assert hit.mean() > 0.03
    np.testing.assert_allclose(d[hit], plain[hit], atol=1e-3)
    colors = np.random.RandomState(0).uniform(0, 1, verts.shape)
    for col in (None, colors):
        got = rz.rasterize(verts, faces, view, k, 40, 40, colors=col)
        want = j_rasterize.rasterize(verts, faces, view, k, 40, 40,
                                     colors=col)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got[1], got[0] > 0)


def test_rasterizer_refuses_bad_faces():
    verts, faces = sphere_mesh(n=12)
    view, k = _camera()
    with pytest.raises(ValueError, match="face indices"):
        rz.rasterize_depth(verts, faces + len(verts), view, k, 8, 8)


def test_simplifiers_match_jax():
    """QEM decimation equals the JAX package's library; clustering its
    numpy; a mesh at or under the target comes back unchanged."""
    verts, faces = sphere_mesh(r=0.4, n=32)
    sv, sf = sp.simplify_quadric(verts, faces, target_faces=300)
    jv, jf = j_simplify.simplify_quadric(verts, faces, target_faces=300)
    np.testing.assert_array_equal(sv, jv)
    np.testing.assert_array_equal(sf, jf)
    assert 0 < len(sf) <= 300
    cv, cf = sp.simplify_cluster(verts, faces, cluster=0.05)
    jcv, jcf = j_simplify.simplify_cluster(verts, faces, cluster=0.05)
    np.testing.assert_array_equal(cv, jcv)
    np.testing.assert_array_equal(cf, jcf)
    assert len(cv) < len(verts) / 2
    same_v, same_f = sp.simplify_quadric(verts, faces, len(faces))
    np.testing.assert_array_equal(same_f, faces)


def test_failed_build_raises(monkeypatch):
    """No numpy fallback: where the library cannot be built the call
    raises."""
    def fail(source):
        raise RuntimeError(f"g++ failed on {source}")

    verts, faces = sphere_mesh(n=12)
    view, k = _camera()
    monkeypatch.setattr(rz._build, "load_host_library", fail)
    for mod in (rz, sp):
        mod._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            rz.rasterize_depth(verts, faces, view, k, 8, 8)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            sp.simplify_quadric(verts, faces, 10)
    finally:
        for mod in (rz, sp):
            mod._lib.cache_clear()


def test_fuse_round_trip_matches_jax():
    """A sphere through the views, the TSDF fusion and marching cubes at
    tests/test_preprocess.py's size (64^3 from 24 views of 128x128): the
    port's tsdf and weights against
    ``tools/preprocess/fuse.py``'s within 1e-5 on all but 0.1% of the
    voxels (tests/test_torch_classic.py's bound for the fusion), the
    mesh watertight at the sphere's radius (tests/test_preprocess.py's
    checks)."""
    from common import fibonacci_sphere_views as j_views
    from fuse import erode_depth as j_erode, fuse_mesh as j_fuse_mesh
    verts, faces = sphere_mesh(r=0.35)
    tsdf, weights, origin, voxel = fuse_mesh(
        verts, faces, n_views=24, grid_res=64, image_size=128, device="cpu")
    jt, jw, jo, jvox = j_fuse_mesh(verts, faces, n_views=24, grid_res=64,
                                   image_size=128)
    assert voxel == jvox
    np.testing.assert_array_equal(origin, jo)
    assert (np.asarray(jw) > 0).mean() > 0.1
    for got, want in ((tsdf, jt), (weights, jw)):
        far = np.abs(got - np.asarray(want, np.float64)) > 1e-5
        assert far.mean() <= 1e-3, far.mean()
    mv, mf, _ = marching_cubes(tsdf, 0.0, spacing=voxel)
    radii = np.linalg.norm(mv + origin, axis=1)
    assert abs(np.median(radii) - 0.35) < 0.03, np.median(radii)
    edges = np.sort(np.concatenate([mf[:, [0, 1]], mf[:, [1, 2]],
                                    mf[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).mean() > 0.99
    d = np.random.RandomState(0).uniform(0, 2, (7, 5)).astype(np.float32)
    d[d < 0.6] = 0
    np.testing.assert_array_equal(erode_depth(d), j_erode(d))
    np.testing.assert_array_equal(fibonacci_sphere_views(5, 1.2),
                                  j_views(5, 1.2))


def test_fuse_save_sdf_matches_jax(tmp_path, monkeypatch,
                                   jax_mcubes_private):
    """``preprocess.fuse --save_sdf`` with h5py blocked against
    ``tools/preprocess/fuse.py --save_sdf`` on one sphere at the round
    trip's size: the same dataset ``sdf`` (1, 64, 64, 64) f32, gzip at
    h5py's default level and chunk shape, the same ``voxel_size`` and
    ``bbox``; the volumes within the round trip's bound (1e-5 on all but
    0.1% of the voxels); the port's reader reads both files as h5py
    does."""
    import h5py
    import fuse as j_fuse
    from segfusion_tpu_torch.preprocess import fuse as port_fuse
    from segfusion_tpu_torch.utils import hdf5

    v, f = sphere_mesh(r=0.35)
    (tmp_path / "in").mkdir()
    save_mesh(str(tmp_path / "in" / "ball.off"), v, f)
    args = ["--in_dir", str(tmp_path / "in"), "--n_views", "24",
            "--resolution", "64", "--image_size", "128", "--save_sdf"]
    monkeypatch.setattr(sys, "argv", ["fuse.py", *args, "--out_dir",
                                      str(tmp_path / "jax")])
    j_fuse.main()
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        port_fuse.main([*args, "--out_dir", str(tmp_path / "port"),
                        "--device", "cpu"])
    paths = [str(tmp_path / d / "ball_sdf.hdf") for d in ("jax", "port")]
    with h5py.File(paths[0], "r") as fj, h5py.File(paths[1], "r") as fp:
        assert list(fj) == list(fp) == ["sdf"]
        dj, dp = fj["sdf"], fp["sdf"]
        assert (dp.shape, dp.dtype, dp.compression, dp.compression_opts,
                dp.chunks) == (dj.shape, dj.dtype, dj.compression,
                               dj.compression_opts, dj.chunks)
        assert dp.shape == (1, 64, 64, 64)
        assert set(fj.attrs) == set(fp.attrs) == {"voxel_size", "bbox"}
        for k in fj.attrs:
            assert np.asarray(fp.attrs[k]).dtype == \
                np.asarray(fj.attrs[k]).dtype
            np.testing.assert_array_equal(fp.attrs[k], fj.attrs[k])
        got, want = dp[()], dj[()]
    far = np.abs(got - want.astype(np.float64)) > 1e-5
    assert far.mean() <= 1e-3, far.mean()
    for path, arr in zip(paths, (want, got)):
        with hdf5.File(path, "r") as f:
            assert f["sdf"].tobytes() == arr.tobytes()


def test_entry_points(tmp_path):
    """``python -m segfusion_tpu_torch.preprocess.scale``, ``fuse``
    (``--device cpu``, a small grid) and ``simplify`` in turn on one
    mesh: the scaled mesh fits the unit cube, the fused mesh is
    watertight, the simplified one has at most the target's faces."""
    v, f = sphere_mesh(r=0.4, n=24)
    raw = tmp_path / "raw"
    raw.mkdir()
    save_mesh(str(raw / "ball.off"), 3.0 * v + 7.0, f)
    env = dict(os.environ, PYTHONPATH=ROOT)

    def run(step, *args):
        proc = subprocess.run(
            [sys.executable, "-m", f"segfusion_tpu_torch.preprocess.{step}",
             *args], capture_output=True, text=True, timeout=300, env=env,
            cwd=ROOT)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout

    out = tmp_path / "out"
    run("scale", "--in_dir", str(raw), "--out_dir", str(out / "scaled"))
    sv, _ = read_off(str(out / "scaled" / "ball.off"))
    assert np.abs(sv).max() <= 0.5 and (out / "scaled/ball.json").exists()
    run("fuse", "--in_dir", str(out / "scaled"), "--out_dir",
        str(out / "fused"), "--n_views", "24", "--resolution", "64",
        "--image_size", "128", "--device", "cpu")
    mv, mf = read_off(str(out / "fused" / "ball.off"))
    edges = np.sort(np.concatenate([mf[:, [0, 1]], mf[:, [1, 2]],
                                    mf[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert len(mf) > 100 and (counts == 2).mean() > 0.99
    run("simplify", "--in_dir", str(out / "fused"), "--out_dir",
        str(out / "simple"), "--target", "200")
    _, qf = read_off(str(out / "simple" / "ball.off"))
    assert 0 < len(qf) <= 200
