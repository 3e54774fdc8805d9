"""The port's OCDBT store (``segfusion_tpu_torch/utils/ocdbt.py``) against
tensorstore: stores that tensorstore writes under each config it offers
(no compression and zstd, values out of line at a few bytes, nodes small
enough that the B+tree has interior nodes, a version tree of several
levels) read back exactly; stores the port writes list and read exactly
in tensorstore; corrupt manifests and nodes raise."""

import os

import numpy as np
import pytest
import tensorstore as ts

from segfusion_tpu_torch.utils import ocdbt, zstd

CONFIGS = {
    "plain": {"compression": None},
    "zstd": {"compression": {"id": "zstd", "level": 3}},
    "out_of_line": {"compression": None, "max_inline_value_bytes": 4},
    "interior_nodes": {"compression": {"id": "zstd"},
                       "max_decoded_node_bytes": 200,
                       "max_inline_value_bytes": 8},
    "version_tree": {"compression": None, "version_tree_arity_log2": 1},
}


def kvstore(path: str, config=None):
    spec = {"driver": "ocdbt", "base": f"file://{path}/"}
    if config is not None:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


def ts_items(path: str) -> dict:
    kv = kvstore(path)
    return {k: kv.read(k).result().value for k in kv.list().result()}


def items_of(n: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {b"key/%04d" % i: rng.integers(
        0, 256, int(rng.integers(0, 40)), dtype=np.uint8).tobytes()
        for i in range(n)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reads_tensorstore_stores(tmp_path, name):
    path = str(tmp_path / name)
    kv = kvstore(path, CONFIGS[name])
    items = items_of(120)
    items[b"big"] = bytes(range(256)) * 40
    commits = 9 if name == "version_tree" else 2
    keys = sorted(items)
    for c in range(commits):
        txn = ts.Transaction()
        for k in keys[c::commits]:
            kv.with_transaction(txn)[k] = items[k]
        txn.commit_async().result()
    store = ocdbt.open_store(path)
    assert store.keys() == sorted(ts_items(path)) == keys
    for k in keys:
        assert store.read(k) == items[k]
    # generation 1 is the empty tree tensorstore starts from; a commit
    # may take more than one generation
    gens = store.generations()
    assert gens == list(range(1, len(gens) + 1))
    assert len(gens) >= commits + 1 and store.version.generation == gens[-1]
    if name == "interior_nodes":
        assert store.version.height > 0
    if name == "version_tree":         # generations held in version nodes
        assert len(gens) > len(store.versions)


@pytest.mark.parametrize("n, big", [(0, 0), (3, 0), (40, 5_000_000),
                                    (700, 0)])
def test_tensorstore_reads_port_stores(tmp_path, n, big):
    items = items_of(n, seed=n)
    items[b""] = b"the empty key"
    items[b"inline/max"] = bytes(ocdbt.MAX_INLINE_VALUE_BYTES)
    items[b"indirect/min"] = bytes(ocdbt.MAX_INLINE_VALUE_BYTES + 1)
    if big:
        items[b"big"] = np.random.default_rng(1).integers(
            0, 256, big, dtype=np.uint8).tobytes()
    path = str(tmp_path / "store")
    ocdbt.write_store(path, items)
    got = ts_items(path)
    assert sorted(got) == sorted(items)
    for k, v in items.items():
        assert got[k] == v
    store = ocdbt.open_store(path)
    assert store.keys() == sorted(items)
    assert all(store.read(k) == v for k, v in items.items())
    # more keys than a node holds: a root of interior entries
    assert (store.version.height > 0) == (len(items) > ocdbt.NODE_ENTRIES)


def test_empty_store(tmp_path):
    path = str(tmp_path / "empty")
    ocdbt.write_store(path, {})
    assert ts_items(path) == {}
    assert len(ocdbt.open_store(path)) == 0


def test_checksums_and_corruption(tmp_path):
    path = str(tmp_path / "store")
    kv = kvstore(path, {"compression": None})
    kv.write(b"a", b"alpha").result()
    with open(os.path.join(path, "manifest.ocdbt"), "rb") as f:
        manifest = f.read()
    want = int.from_bytes(manifest[-4:], "little")
    assert zstd.crc32c(manifest[:-4]) == zstd.crc32c_plain(
        manifest[:-4]) == want
    bad = bytearray(manifest)
    bad[20] ^= 1
    with open(os.path.join(path, "manifest.ocdbt"), "wb") as f:
        f.write(bytes(bad))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.open_store(path)
    with open(os.path.join(path, "manifest.ocdbt"), "wb") as f:
        f.write(manifest)
    node = os.path.join(path, "d", os.listdir(os.path.join(path, "d"))[0])
    with open(node, "r+b") as f:
        data = bytearray(f.read())
        data[-1] ^= 0xFF
        f.seek(0)
        f.write(bytes(data))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.open_store(path)
    with pytest.raises(FileNotFoundError):
        ocdbt.open_store(str(tmp_path / "nothing"))


@pytest.mark.parametrize("bad_prefix", [b"../", b"/"])
def test_data_file_paths_stay_in_the_store(tmp_path, bad_prefix):
    """A data file table whose path is absolute or climbs out of the
    store's directory raises before any file is opened."""
    path = str(tmp_path / "store")
    ocdbt.write_store(path, {b"k": bytes(2 * ocdbt.MAX_INLINE_VALUE_BYTES)})
    (name,) = os.listdir(os.path.join(path, "d"))
    with open(os.path.join(path, "manifest.ocdbt"), "rb") as f:
        manifest = f.read()
    good = b"d/" + name.encode()
    bad = (bad_prefix + good)[:len(good)]          # same length, same varints
    assert manifest.count(good) == 1
    data = manifest[:-4].replace(good, bad)
    data += zstd.crc32c(data).to_bytes(4, "little")
    with open(os.path.join(path, "manifest.ocdbt"), "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match="leaves the store"):
        ocdbt.open_store(path)
