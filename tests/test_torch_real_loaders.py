"""Port parity for the real-data loaders: ``segfusion_tpu_torch.data``'s
Replica and ScanNet against the JAX package's on the same files, on the
CPU. Seeded fixture trees at the datasets' own layouts (pngs and jpgs by
OpenCV, camera txts, sdf hdf5s, intrinsics, the tsv label map, a ply):
every key of every frame dict, the visualisation frames, the gt grids and
the empty grid from a ply must be equal, dtypes included (tolerance 0).
"""

import os
import sys

import numpy as np
import pytest

import cv2
import h5py

from segfusion_tpu.config import Config as JConfig
from segfusion_tpu.data.replica import Replica as JReplica
from segfusion_tpu.data.replica import _fix_extrinsics as j_fix_extrinsics
from segfusion_tpu.data.scannet import ScanNet as JScanNet
from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.core.database import Database
from segfusion_tpu_torch.data import Replica, ScanNet, get_data
from segfusion_tpu_torch.data.replica import raw_camera_matrix
from segfusion_tpu_torch.data.synthetic import SyntheticScene
from segfusion_tpu_torch.utils.meshio import write_ply

# trajectory -> frame count: uneven, so that the hybrid interleave runs
# one trajectory dry before the others
TRAJS = {("room_a", "1"): 5, ("room_a", "2"): 3, ("room_b", "1"): 4}
REPLICA_DIRS = ("left_depth_gt", "left_depth_noise_5.0", "left_rgb",
                "left_camera_matrix", "left_class30")


def random_pose(rng) -> np.ndarray:
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pose = np.eye(4)
    pose[:3, :3] = q * np.sign(np.linalg.det(q))
    pose[:3, 3] = rng.uniform(-2, 2, 3)
    return pose


def write_replica(root: str, res: int = 20, label_channels: int = 1):
    """Random frames at res x res for TRAJS, depths across the mask's
    edges (0, below 5 cm, above 5 m), a raw camera matrix a frame, both
    sdf hdfs of each scene, and the list file."""
    rng = np.random.RandomState(label_channels)
    lines = []
    for (scene, traj), n in TRAJS.items():
        base = os.path.join(root, scene, traj)
        for sub in REPLICA_DIRS:
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        for i in range(n):
            def out(sub, ext=".png"):
                return os.path.join(base, sub, f"{i}{ext}")
            cv2.imwrite(out("left_rgb"),
                        rng.randint(0, 256, (res, res, 3), dtype=np.uint8))
            for sub in ("left_depth_gt", "left_depth_noise_5.0"):
                mm = rng.randint(0, 6000, (res, res)).astype(np.uint16)
                mm[rng.uniform(size=mm.shape) < 0.1] = 0
                mm[0, :3] = (40, 5000, 5001)
                cv2.imwrite(out(sub), mm)
            shape = (res, res) if label_channels == 1 else (res, res, 3)
            cv2.imwrite(out("left_class30"),
                        rng.randint(0, 30, shape).astype(np.uint8))
            np.savetxt(out("left_camera_matrix", ".txt"), random_pose(rng))
        lines.append(" ".join(f"{scene}/{traj}/{d}" for d in REPLICA_DIRS))
    for scene in sorted({s for s, _ in TRAJS}):
        sdf_dir = os.path.join(root, scene, "gt_semantic_sdf")
        os.makedirs(sdf_dir, exist_ok=True)
        grid = rng.uniform(-0.3, 0.3, (2, 12, 14, 10)).astype(np.float32)
        grid[1] = rng.randint(0, 30, grid.shape[1:])
        for name in ("sdf.hdf", "semantic_sdf.hdf"):
            with h5py.File(os.path.join(sdf_dir, name), "w") as f:
                f.create_dataset("sdf", data=grid)
                f.attrs["voxel_size"] = 0.05
                f.attrs["bbox"] = np.array([[0.1, 0.7], [-0.2, 0.5],
                                            [0.3, 0.8]])
    path = os.path.join(root, "list.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def write_scannet(root: str, scenes=("scene0000_00", "scene0001_00"),
                  n_frames: int = 3, hdf: bool = True):
    """Random 640x480 scans: jpg colour, uint16 depth and raw labels (ids
    past the tsv's 1400 too), poses, intrinsics, the tsv, the clean ply,
    and (``hdf``) each scan's sdf hdf; the list file, a ``scans/<scene>``
    line a scan (the loaders take a line's first entry as the scan's
    directory)."""
    rng = np.random.RandomState(3)
    for scene in scenes:
        sdir = os.path.join(root, "scans", scene)
        for sub in ("color", "depth", "label-filt", "pose", "intrinsic"):
            os.makedirs(os.path.join(sdir, sub), exist_ok=True)
        for i in range(n_frames):
            cv2.imwrite(os.path.join(sdir, "color", f"{i}.jpg"),
                        rng.randint(0, 256, (480, 640, 3), dtype=np.uint8))
            mm = rng.randint(0, 4000, (480, 640)).astype(np.uint16)
            mm[0, :2] = (10, 11)
            cv2.imwrite(os.path.join(sdir, "depth", f"{i}.png"), mm)
            cv2.imwrite(os.path.join(sdir, "label-filt", f"{i}.png"),
                        rng.randint(0, 1500, (480, 640)).astype(np.uint16))
            np.savetxt(os.path.join(sdir, "pose", f"{i}.txt"),
                       random_pose(rng))
        k = np.eye(4)
        k[:3, :3] = [[577.9, 0, 319.5], [0, 578.2, 239.5], [0, 0, 1]]
        np.savetxt(os.path.join(sdir, "intrinsic", "intrinsic_depth.txt"), k)
        verts = rng.uniform(-1.0, 1.5, (50, 3)).astype(np.float32)
        write_ply(os.path.join(sdir, scene + "_vh_clean_2.ply"), verts,
                  rng.randint(0, 50, (30, 3)).astype(np.int32))
        if hdf:
            grid = rng.uniform(-0.3, 0.3, (2, 10, 8, 12)).astype(np.float32)
            grid[1] = rng.randint(0, 41, grid.shape[1:])
            with h5py.File(os.path.join(sdir, scene + "_sdf.hdf"), "w") as f:
                f.create_dataset("sdf", data=grid)
                f.attrs["voxel_size"] = 0.04
                f.attrs["bbox"] = np.array([[-1, 0], [0, 1], [0.5, 1.5]])
    with open(os.path.join(root, "scannetv2-labels.combined.tsv"), "w") as f:
        f.write("id\traw_category\tcategory\tnyu40id\n")
        for raw in range(1, 1401, 3):
            f.write(f"{raw}\tcat{raw}\tcat\t{raw % 41}\n")
        f.write("7\tbroken\tcat\tnot-an-id\n")
    path = os.path.join(root, "list.txt")
    with open(path, "w") as f:
        f.write("".join(f"scans/{s}\n" for s in scenes))
    return path


@pytest.fixture(scope="module")
def replica_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("replica"))
    return root, write_replica(root)


@pytest.fixture(scope="module")
def scannet_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scannet"))
    return root, write_scannet(root)


def data_config(root, lst, **kw):
    """(JAX, port) DATA views with the same keys."""
    d = {"root_dir": root, "scene_list": lst, "resx": 16, "resy": 16,
         "pad": 2, "normalize": True, "frame_ratio": 1,
         "input": "tof_depth", "target": "depth_gt", "semantics": "class30",
         "truncation_strategy": "standard",
         "data_load_strategy": "max_depth_diversity",
         "load_scenes_at_once": 1, "init_value": 0.1, "mode": "test"}
    d.update(kw)
    return JConfig(d), Config(d)


def assert_same_frames(want_ds, got_ds):
    assert got_ds.scenes == want_ds.scenes
    assert len(got_ds) == len(want_ds)
    for i in range(len(want_ds)):
        want, got = want_ds[i], got_ds[i]
        assert got.keys() == want.keys()
        for k in want:
            w, g = np.asarray(want[k]), np.asarray(got[k])
            assert g.dtype == w.dtype, (i, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{i} {k}")


@pytest.mark.parametrize("strategy,at_once,ratio,input_key,target,res", [
    ("hybrid", 1, 1, "tof_depth", "depth_gt", 16),
    ("hybrid", 2, 1, "tof_depth", "depth_gt", 16),
    ("hybrid", 2, 2, "depth_gt", "depth_gt", 20),
    ("max_depth_diversity", 1, 1, "tof_depth", "depth_gt", 20),
    ("max_depth_diversity", 2, 2, "depth_gt", "semantic_gt", 16),
])
def test_replica_frames_match_jax(replica_root, strategy, at_once, ratio,
                                  input_key, target, res):
    """Every frame dict, in order, of both orderings (20^2 files read at
    16^2 and at 20^2), frame ratios 1 and 2, either depth input."""
    root, lst = replica_root
    jcfg, cfg = data_config(root, lst, data_load_strategy=strategy,
                            load_scenes_at_once=at_once, frame_ratio=ratio,
                            input=input_key, target=target, resx=res,
                            resy=res)
    want, got = JReplica(jcfg), get_data("Replica", cfg, device="cpu")
    assert isinstance(got, Replica)
    assert_same_frames(want, got)
    for i in range(len(want)):
        fid = want[i]["frame_id"]
        for fn in ("get_input_frame", "get_depth_frame",
                   "get_semantic_frame"):
            w, g = getattr(want, fn)(fid), getattr(got, fn)(fid)
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=f"{fn} {fid}")


def test_replica_three_channel_labels_match_jax(tmp_path):
    """3-channel label pngs: both take OpenCV's channel 0 (blue)."""
    root = str(tmp_path)
    lst = write_replica(root, label_channels=3)
    jcfg, cfg = data_config(root, lst)
    want, got = JReplica(jcfg), Replica(cfg, device="cpu")
    assert_same_frames(want, got)
    raw = cv2.imread(os.path.join(root, "room_a", "1", "left_class30",
                                  "0.png"), -1)
    np.testing.assert_array_equal(
        got[0]["semantic_gt"], cv2.resize(raw, (16, 16),
                                          interpolation=cv2.INTER_NEAREST)
        [..., 0])
    for i in range(len(want)):
        fid = want[i]["frame_id"]
        np.testing.assert_array_equal(got.get_semantic_frame(fid),
                                      want.get_semantic_frame(fid))


def assert_same_grid(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is None:
            continue
        assert g.volume.dtype == w.volume.dtype
        np.testing.assert_array_equal(g.volume, w.volume)
        np.testing.assert_array_equal(g.bbox, w.bbox)
        np.testing.assert_array_equal(g.origin, w.origin)
        assert g.resolution == w.resolution


@pytest.mark.parametrize("strategy", ["standard", "artificial"])
@pytest.mark.parametrize("semantics,semantic_grid", [
    ("class30", True), ("class30", False), (None, False)])
def test_replica_grid_matches_jax(replica_root, monkeypatch, strategy,
                                  semantics, semantic_grid):
    """The JAX package reads the hdf through h5py, the port with h5py
    blocked."""
    root, lst = replica_root
    jcfg, cfg = data_config(root, lst, truncation_strategy=strategy,
                            semantics=semantics)
    for scene in ("room_a", "room_b"):
        want = JReplica(jcfg).get_grid(scene, 0.1, semantic_grid)
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "h5py", None)
            got = Replica(cfg).get_grid(scene, 0.1, semantic_grid)
        assert_same_grid(got, want)


@pytest.mark.parametrize("strategy,res,ratio,semantics,input_key", [
    ("hybrid", (320, 240), 1, "nyu40", "depth_gt"),
    ("max_depth_diversity", (640, 480), 1, None, "depth_gt"),
    ("max_depth_diversity", (320, 240), 2, "nyu40", "tof_depth"),
])
def test_scannet_frames_match_jax(scannet_root, strategy, res, ratio,
                                  semantics, input_key):
    """Every frame dict of two scans: 640x480 files read at 320x240 and
    1:1, intrinsics rescaled, raw labels through the tsv (ids past its
    range clipped), both orderings, frame ratio 2."""
    root, lst = scannet_root
    jcfg, cfg = data_config(root, lst, data_load_strategy=strategy,
                            resx=res[0], resy=res[1], frame_ratio=ratio,
                            semantics=semantics, input=input_key)
    want, got = JScanNet(jcfg), get_data("ScanNet", cfg, device="cpu")
    assert isinstance(got, ScanNet)
    assert_same_frames(want, got)


@pytest.mark.parametrize("strategy", ["standard", "artificial"])
@pytest.mark.parametrize("semantic_grid", [True, False])
def test_scannet_grid_matches_jax(scannet_root, monkeypatch, strategy,
                                  semantic_grid):
    """The JAX package reads the hdf through h5py, the port with h5py
    blocked."""
    root, lst = scannet_root
    jcfg, cfg = data_config(root, lst, truncation_strategy=strategy,
                            semantics="nyu40")
    want = JScanNet(jcfg).get_grid("scene0001_00", 0.1, semantic_grid)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        got = ScanNet(cfg).get_grid("scene0001_00", 0.1, semantic_grid)
    assert_same_grid(got, want)


@pytest.mark.parametrize("pad", [0, 2])
def test_scannet_create_grid_matches_jax(scannet_root, pad):
    """The empty grid over the clean ply's bbox at 1 cm."""
    root, lst = scannet_root
    jcfg, cfg = data_config(root, lst, pad=pad)
    got = ScanNet(cfg).create_grid("scene0000_00", 0.1)
    assert_same_grid(got, JScanNet(jcfg).create_grid("scene0000_00", 0.1))
    assert got[0].resolution == 0.01 and got[1] is None


def test_scannet_output_test_matches_jax(scannet_root, tmp_path):
    """Benchmark-format predictions: the same decoded pixels."""
    root, lst = scannet_root
    jcfg, cfg = data_config(root, lst)
    pred = np.random.RandomState(4).randint(0, 21, (24, 32))
    JScanNet(jcfg).output_test(str(tmp_path / "jax"), "scene0001_00/2", pred)
    ScanNet(cfg).output_test(str(tmp_path / "port"), "scene0001_00/2", pred)
    want = cv2.imread(str(tmp_path / "jax" / "scene0001_00_2.png"), -1)
    got = cv2.imread(str(tmp_path / "port" / "scene0001_00_2.png"), -1)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pred)


@pytest.mark.parametrize("poses", ["synthetic", "random"])
def test_raw_camera_matrix_inverts_fix_extrinsics(poses):
    """The raw Replica camera matrix written for a pose, read back through
    the JAX package's ``_fix_extrinsics``, gives the pose to 1e-6."""
    if poses == "synthetic":
        want = SyntheticScene(seed=1).camera_poses(12)
    else:
        rng = np.random.RandomState(9)
        want = np.stack([random_pose(rng) for _ in range(12)])
    for pose in want:
        np.testing.assert_allclose(j_fix_extrinsics(raw_camera_matrix(pose)),
                                   pose, rtol=0, atol=1e-6)


@pytest.mark.parametrize("h5py_importable", [True, False])
def test_missing_grid_raises_file_not_found(tmp_path, monkeypatch,
                                            h5py_importable):
    """``get_grid`` on a scene without an hdf raises FileNotFoundError
    before it opens anything, so that a raw scan reaches ``create_grid``
    (and the Database builds its empty grid), with h5py or without."""
    rroot, sroot = str(tmp_path / "replica"), str(tmp_path / "scannet")
    lst = write_replica(rroot)
    os.remove(os.path.join(rroot, "room_b", "gt_semantic_sdf",
                           "semantic_sdf.hdf"))
    slst = write_scannet(sroot, scenes=("scene0002_00",), n_frames=1,
                         hdf=False)
    if not h5py_importable:
        monkeypatch.setitem(sys.modules, "h5py", None)
    _, cfg = data_config(rroot, lst)
    with pytest.raises(FileNotFoundError, match="room_b"):
        Replica(cfg).get_grid("room_b", 0.1, True)
    with pytest.raises(FileNotFoundError):
        Replica(cfg).create_grid("room_b", 0.1)

    jcfg, cfg = data_config(sroot, slst, semantics="nyu40", pad=0)
    dataset = ScanNet(cfg)
    with pytest.raises(FileNotFoundError, match="scans_test"):
        dataset.get_grid("scene0002_00", 0.1)
    db = Database(dataset, cfg, device="cpu")
    want = JScanNet(jcfg).create_grid("scene0002_00", 0.1)[0]
    assert db.grid_shape["scene0002_00"] == want.volume.shape
    np.testing.assert_array_equal(db.origin["scene0002_00"], want.origin)
