"""The port's HDF5 codec (``segfusion_tpu_torch/utils/hdf5.py``) against
h5py: files that h5py writes at ``libver`` "earliest" and "latest" read
back exactly (dtype, shape, values, attributes) over every storage the
codec reads; files the codec writes read back through h5py with the
compression asked for; and the structures it does not read refused."""

import numpy as np
import pytest

import h5py
from segfusion_tpu_torch.utils import hdf5

DTYPES = ["u1", "i2", "u2", "i4", "i8", "f4", "f8", ">f4"]
SHAPES = [(5,), (2, 12, 14, 10), (1, 33, 17, 9)]
LIBVERS = ["earliest", "latest"]
ATTRS = {"voxel_size": 0.05, "bbox": np.array([[0.1, 0.7], [-0.2, 0.5],
                                               [0.3, 0.8]]),
         "count": np.int32(7), "levels": np.arange(4, dtype=">u2")}


def data_of(dtype: str, shape, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.normal(0, 100, shape).astype(dt)
    info = np.iinfo(dt)
    return rng.randint(info.min, int(info.max) + 1, shape,
                       dtype=np.int64 if dt.kind == "i" else np.uint64
                       ).astype(dt)


def ragged(shape):
    """Chunks that divide no axis longer than 2 (partial edge chunks)."""
    return tuple(max(1, min(n, n // 2 + 1)) if n > 2 else n for n in shape)


def many(shape):
    """Chunks of 1 on every axis but the last (2): more than 1,024
    chunks on the two larger shapes, so an internal B-tree node under
    "earliest" and a paged fixed array under "latest"."""
    return (1,) * (len(shape) - 1) + (min(2, shape[-1]),)


def compact_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    return dcpl


STORAGES = {
    "contiguous": lambda shape: {},
    "compact": lambda shape: {"dcpl": compact_dcpl()},
    "gzip1": lambda shape: {"compression": "gzip", "compression_opts": 1},
    "gzip4": lambda shape: {"compression": "gzip", "compression_opts": 4},
    "gzip9": lambda shape: {"compression": "gzip", "compression_opts": 9},
    "shuffle_gzip": lambda shape: {"compression": "gzip", "shuffle": True},
    "fletcher32_gzip": lambda shape: {"compression": "gzip",
                                      "fletcher32": True},
    "ragged_chunks": lambda shape: {"chunks": ragged(shape),
                                    "compression": "gzip"},
    "ragged_plain_chunks": lambda shape: {"chunks": ragged(shape)},
    "many_chunks": lambda shape: {"chunks": many(shape),
                                  "compression": "gzip"},
}


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("storage", sorted(STORAGES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_reads_what_h5py_writes(tmp_path, dtype, storage, libver):
    """Every shape of SHAPES in one file, with ATTRS on the root group:
    each dataset equal to h5py's read of it in dtype, shape and bits."""
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver=libver) as f:
        for i, shape in enumerate(SHAPES):
            f.create_dataset(f"d{i}", data=data_of(dtype, shape, i),
                             **STORAGES[storage](shape))
        for k, v in ATTRS.items():
            f.attrs[k] = v
    with h5py.File(path, "r") as f:
        want = {k: f[k][()] for k in f}
        want_attrs = dict(f.attrs)
    with hdf5.File(path, "r") as f:
        assert sorted(f.keys()) == sorted(want)
        for k, w in want.items():
            got = f[k]
            assert got.dtype == w.dtype and got.shape == w.shape, k
            assert got.tobytes() == w.tobytes(), k
        assert set(f.attrs) == set(want_attrs)
        for k, w in want_attrs.items():
            got = f.attrs[k]
            assert np.asarray(got).dtype == np.asarray(w).dtype, k
            assert np.array_equal(got, w), k
            assert np.ndim(got) == np.ndim(w), k


@pytest.mark.parametrize("libver", LIBVERS)
def test_reads_repo_writers_and_continuations(tmp_path, libver):
    """The repo's own h5py calls (a (2, X, Y, Z) gt grid with its
    attributes, a gzip-9 save, the preprocessing's default gzip of shape
    (1, X, Y, Z)), a scalar dataset, an empty one, unwritten and partly
    written ones (the fill value where no chunk was stored), attributes
    added after the datasets (continuation blocks in the root's header)
    and attributes on a dataset's own header."""
    rng = np.random.RandomState(1)
    grid = rng.uniform(-0.3, 0.3, (2, 12, 14, 10)).astype(np.float32)
    path = str(tmp_path / "g.h5")
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("sdf", data=grid)
        f.create_dataset("TSDF", shape=grid.shape, data=grid,
                         compression="gzip", compression_opts=9)
        f.create_dataset("pre", shape=(1,) + grid.shape[1:],
                         data=grid[None, 0], compression="gzip")
        f.create_dataset("scalar", data=np.float64(2.5))
        f.create_dataset("empty", shape=(0, 3), dtype="f4")
        f.create_dataset("unwritten", shape=(3, 4), dtype="i4", fillvalue=7)
        part = f.create_dataset("partial", shape=(10, 10), chunks=(5, 5),
                                dtype="f4", fillvalue=-1.5,
                                compression="gzip")
        part[:5, :5] = 1.0                  # one chunk of four written
        f["sdf"].attrs["own"] = 3
        f.attrs["voxel_size"] = 0.05
        f.attrs["bbox"] = np.array([[0.1, 0.7], [-0.2, 0.5], [0.3, 0.8]])
        for i in range(6):                   # compact even under latest
            f.attrs[f"extra{i}"] = np.arange(i + 40, dtype="f8")
    with hdf5.File(path, "r") as f:
        assert np.array_equal(f["sdf"], grid)
        assert np.array_equal(f["TSDF"], grid)
        assert np.array_equal(f["pre"], grid[None, 0])
        assert f["scalar"].shape == () and f["scalar"] == 2.5
        assert f["empty"].shape == (0, 3)
        assert np.array_equal(f["unwritten"], np.full((3, 4), 7, "i4"))
        want = np.full((10, 10), -1.5, "f4")
        want[:5, :5] = 1.0
        assert np.array_equal(f["partial"], want)
        assert float(f.attrs["voxel_size"]) == 0.05
        assert np.array_equal(f.attrs["extra5"], np.arange(45.0))
        assert "sdf" in f and "/TSDF" in f and "nothing" not in f
        with pytest.raises(KeyError):
            f["nothing"]


@pytest.mark.parametrize("case", [
    ("f4", (3, 40, 50), None, None, None, 1),
    ("i8", (7,), None, None, None, 11),
    ("f8", (), None, None, None, 1),
    ("u1", (2, 31, 17, 9), "gzip", 9, None, 1),
    ("f4", (404, 23, 9), "gzip", None, None, 1),
    ("f4", (4, 5, 6), "gzip", 2, None, 11),
    ("<u2", (40, 50, 60), "gzip", 1, (3, 4, 5), 1),       # 2,184 chunks
    (">f8", (70, 70, 10), "gzip", 6, (1, 1, 10), 1),      # 4,900 chunks
    ("i2", (33, 17), None, None, (4, 4), 1),
])
def test_h5py_reads_what_the_port_writes(tmp_path, case):
    """The port's files read through h5py and through the port: arrays,
    dtypes, shapes, root attributes, gzip and its level, the chunk shape
    (h5py's own rule where none is given); several hundred to thousands
    of chunks (B-trees of two and three levels); 11 datasets fill two
    symbol table nodes."""
    dtype, shape, compression, level, chunks, n_datasets = case
    path = str(tmp_path / "p.h5")
    data = {f"v{i}": data_of(dtype, shape, i) for i in range(n_datasets)}
    with hdf5.File(path, "w") as f:
        for name, arr in data.items():
            f.create_dataset(name, shape=arr.shape, data=arr,
                             compression=compression,
                             compression_opts=level, chunks=chunks)
        for k, v in ATTRS.items():
            f.attrs[k] = v
    with h5py.File(path, "r") as f:
        assert sorted(f) == sorted(data)
        for name, arr in data.items():
            d = f[name]
            assert d.dtype == arr.dtype and d.shape == arr.shape
            assert d[()].tobytes() == arr.tobytes()
            assert d.compression == compression
            if compression:
                assert d.compression_opts == (4 if level is None else level)
                assert d.chunks == (chunks or hdf5.guess_chunk(
                    shape, arr.dtype.itemsize))
                want_chunks = chunks or h5py._hl.filters.guess_chunk(
                    shape, None, arr.dtype.itemsize)
                assert d.chunks == want_chunks
            else:
                assert d.chunks == chunks
        for k, v in ATTRS.items():
            assert np.asarray(f.attrs[k]).dtype == np.asarray(v).dtype
            assert np.array_equal(f.attrs[k], v)
    with hdf5.File(path, "r") as f:
        for name, arr in data.items():
            assert f[name].dtype == arr.dtype
            assert f[name].tobytes() == arr.tobytes()
        assert np.array_equal(f.attrs["bbox"], ATTRS["bbox"])


def test_gzip_bytes_equal_h5py(tmp_path):
    """A gzip dataset at h5py's chunk shape: the port's chunks hold the
    bytes h5py writes (one zlib, edge chunks padded with zeros)."""
    arr = data_of("f4", (37, 29, 21), 3)
    ours, theirs = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    with hdf5.File(ours, "w") as f:
        f.create_dataset("x", data=arr, compression="gzip",
                         compression_opts=9)
    with h5py.File(theirs, "w") as f:
        f.create_dataset("x", data=arr, compression="gzip",
                         compression_opts=9)

    def chunks(path):
        with h5py.File(path, "r") as f:
            d = f["x"].id
            return [d.read_direct_chunk(d.get_chunk_info(i).chunk_offset)[1]
                    for i in range(d.get_num_chunks())]
    assert chunks(ours) == chunks(theirs)


def test_writer_refuses(tmp_path):
    with hdf5.File(str(tmp_path / "r.h5"), "w") as f:
        with pytest.raises(TypeError):
            f.create_dataset("b", data=np.zeros(3, bool))
        with pytest.raises(TypeError):
            f.attrs["name"] = "text"
        with pytest.raises(NotImplementedError):
            f.create_dataset("z", data=np.zeros(3), compression="lzf")
        f.create_dataset("a", data=np.zeros(3))
        with pytest.raises(ValueError):
            f.create_dataset("a", data=np.zeros(3))
    with h5py.File(str(tmp_path / "r.h5"), "r") as f:
        assert list(f) == ["a"]


@pytest.mark.parametrize("what", ["lzf", "string_attribute",
                                  "dense_attributes"])
def test_refuses_what_it_does_not_read(tmp_path, what):
    """An lzf dataset, a string attribute and dense attribute storage
    (a fractal heap: 20 attributes under "latest") each raise
    NotImplementedError naming the structure."""
    path = str(tmp_path / "n.h5")
    with h5py.File(path, "w", libver="latest") as f:
        if what == "lzf":
            f.create_dataset("x", data=np.arange(100.0), compression="lzf")
        elif what == "string_attribute":
            f.attrs["name"] = "room_0"
        else:
            for i in range(20):
                f.attrs[f"a{i}"] = i
    match = {"lzf": "lzf", "string_attribute": "string",
             "dense_attributes": "dense attribute"}[what]
    with hdf5.File(path, "r") as f:
        with pytest.raises(NotImplementedError, match=match):
            if what == "lzf":
                f["x"]
            else:
                f.attrs
