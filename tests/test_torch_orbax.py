"""The port's orbax checkpoints (``save_checkpoint_orbax`` /
``load_checkpoint_orbax`` in ``segfusion_tpu_torch.utils.checkpoints``,
no orbax, tensorstore or zstandard) against the JAX package's, which
run orbax: checkpoints either package writes load exactly in the other
(numpy, ``jax.Array``, bfloat16, scalar and 0-d leaves, a 4 MiB array,
FusionNet's parameters through ``utils/convert.py``), with and without a
template; the template mismatches that orbax refuses; the committed
fixture against its regeneration; zarr arrays of several chunks."""

import json
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch

from segfusion_tpu.utils import checkpoints as jck
from segfusion_tpu_torch.config import load_config
from segfusion_tpu_torch.models.fusionnet import build_fusion_net
from segfusion_tpu_torch.utils import checkpoints as ck
from segfusion_tpu_torch.utils import fixtures, ocdbt, zarr, zstd
from segfusion_tpu_torch.utils.convert import fusionnet_from_flax, to_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_SMALL = os.path.join(ROOT, "configs", "fusion", "synthetic_small.yaml")
logging.getLogger("absl").setLevel(logging.ERROR)


def bits(x) -> np.ndarray:
    """A leaf's values, bfloat16 as its 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_same(port, ref, path=""):
    """``port`` (the port's load) holds exactly ``ref``'s leaves, each of
    the type the port documents for it."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and sorted(port) == sorted(ref), path
        for k in ref:
            assert_same(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (bool, int, float)):
        assert type(port) is type(ref) and port == ref, path
    else:
        a, b = bits(port), bits(ref)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        assert np.array_equal(a, b), path
        bf16 = (ref.dtype == torch.bfloat16 if isinstance(ref, torch.Tensor)
                else np.asarray(ref).dtype.name == "bfloat16")
        assert isinstance(port, torch.Tensor) == bf16, path


def mixed_state(seed: int = 0):
    rng = np.random.default_rng(seed)
    n = {dt: (rng.standard_normal((3, 5)) * 100).astype(dt)
         for dt in ("f4", "f8", "i4", "i8", "u1", "f2")}
    n["b1"] = rng.random(7) < 0.5
    return {
        "np": n,
        "jax": {"w": jnp.asarray(rng.standard_normal((4, 6)), jnp.float32),
                "bf16": jnp.asarray(rng.standard_normal((5, 3)),
                                    jnp.bfloat16),
                "count": jnp.asarray(17, jnp.int32)},
        "big": rng.standard_normal((1024, 1024)).astype(np.float32),
        "zero_d": np.asarray(2.5, np.float32),
        "epoch": 12, "lr": 3e-4, "flag": False,
        "empty": {},
    }


def test_jax_checkpoints_load_exactly(tmp_path):
    state = mixed_state()
    jck.save_checkpoint_orbax(state, str(tmp_path / "ck"))
    got = ck.load_checkpoint_orbax(str(tmp_path / "ck"))
    assert_same(got, jax.tree_util.tree_map(np.asarray, state))
    assert_same(got, jck.load_checkpoint_orbax(str(tmp_path / "ck")))
    assert got["big"].nbytes == 4 << 20


def port_state(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return {
        "net": {"conv": {"weight": torch.randn(8, 4, 3, 3, generator=g),
                         "bias": torch.randn(8, generator=g)},
                "bf16": torch.randn(6, 5, generator=g).bfloat16(),
                "f64": torch.randn(3, generator=g, dtype=torch.float64)},
        "ints": {"i64": torch.arange(10), "i32": torch.arange(
            4, dtype=torch.int32), "u8": torch.arange(200, dtype=torch.uint8),
            "bool": torch.arange(5) % 2 == 0, "f16": torch.randn(
                4, generator=g).half()},
        "numpy": {"vol": np.random.default_rng(seed).standard_normal(
            (16, 17, 18)).astype(np.float32), "count": np.asarray(
            3, np.int32)},
        "chain": ({}, {"trace": torch.zeros(2, 2)}),
        "epoch": 5, "best_iou": 0.75, "done": True,
    }


def test_port_checkpoints_load_in_jax(tmp_path):
    state = port_state()
    path = str(tmp_path / "ck")
    ck.save_checkpoint_orbax(state, path)
    as_dict = {}
    for keys, leaf in ck._orbax_leaves(state):
        node = as_dict
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = {} if leaf is ck._EMPTY else leaf
    got = ck.load_checkpoint_orbax(path)
    assert_same(got, as_dict)

    def host(tree):
        return jax.tree_util.tree_map(
            lambda x: x if isinstance(x, (bool, int, float))
            else np.asarray(x), tree)
    with jax.enable_x64(True):          # int64 and float64 leaves as such
        ref = jck.load_checkpoint_orbax(path)
        assert_same(got, host(ref))
        # through a template of jax arrays: every leaf again
        template = jax.tree_util.tree_map(
            lambda x: x if isinstance(x, (bool, int, float)) else
            jnp.zeros_like(x), ref)
        assert_same(got, host(jck.load_checkpoint_orbax(path, template)))
    for sub in ("_sharding", "array_metadatas"):
        assert not os.path.exists(os.path.join(path, sub))


def test_port_load_with_a_template(tmp_path):
    state = port_state()
    path = str(tmp_path / "ck")
    ck.save_checkpoint_orbax(state, path)
    got = ck.load_checkpoint_orbax(path, state)
    assert isinstance(got["chain"], tuple) and got["chain"][0] == {}
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(state)):
        assert type(a) is type(b)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.device == b.device
            assert torch.equal(a, b)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert a == b
    # the template's dtype wins, as in orbax
    cast = ck.load_checkpoint_orbax(path, {**state, "net": {
        **state["net"], "bf16": torch.zeros(6, 5), "f64": np.zeros(
            3, np.float32)}})
    assert cast["net"]["bf16"].dtype == torch.float32
    assert torch.equal(cast["net"]["bf16"], state["net"]["bf16"].float())
    assert cast["net"]["f64"].dtype == np.float32
    with jax.enable_x64(True):          # the f64 leaf stored as such
        template = jax.tree_util.tree_map(
            lambda x: x if isinstance(x, (bool, int, float)) else
            jnp.zeros_like(x), jck.load_checkpoint_orbax(path))
        template["net"]["bf16"] = jnp.zeros((6, 5), jnp.float32)
        template["net"]["f64"] = np.zeros(3, np.float32)
        ref = jck.load_checkpoint_orbax(path, template)["net"]
    for k in ("bf16", "f64"):
        assert np.asarray(ref[k]).dtype == np.float32
        assert np.array_equal(bits(cast["net"][k]), np.asarray(ref[k])), k


MISMATCHES = ["shape", "missing_key", "extra_key"]


def mismatched(case: str, tree: dict, zeros):
    t = jax.tree_util.tree_map(zeros, tree)
    if case == "shape":
        t["params"]["w"] = zeros(np.zeros((5, 4), np.float32))
    elif case == "missing_key":                 # the template lacks one
        del t["params"]["b"]
    else:                                       # the template has one more
        t["params"]["extra"] = zeros(np.zeros(2, np.float32))
    return t


@pytest.mark.parametrize("case", MISMATCHES)
def test_template_mismatches_raise(tmp_path, case):
    state = {"params": {"w": np.ones((4, 5), np.float32),
                        "b": np.arange(3, dtype=np.float32)}, "step": 2}
    path = str(tmp_path / "ck")
    jck.save_checkpoint_orbax(state, path)

    def keep_scalars(fn):
        return lambda x: x if isinstance(x, int) else fn(x)
    with pytest.raises(ValueError):
        jck.load_checkpoint_orbax(path, mismatched(
            case, state, keep_scalars(jnp.zeros_like)))
    with pytest.raises(ValueError):
        ck.load_checkpoint_orbax(path, mismatched(
            case, state, keep_scalars(lambda x: torch.zeros(np.shape(x)))))
    with pytest.raises(ValueError):
        ck.load_checkpoint_orbax(path, mismatched(
            case, state, keep_scalars(np.zeros_like)))


def test_fusionnet_params_both_ways(tmp_path):
    """A FusionNet's parameters in Flax layout (``to_flax``, the weight
    carry-over of ``utils/convert.py``, BatchNorm statistics moved off
    their init) cross as orbax checkpoints: the JAX package's into the
    port's module (``fusionnet_from_flax``), the port's back into the
    JAX package, bit for bit."""
    cfg = load_config(CFG_SMALL).FUSION_MODEL
    torch.manual_seed(0)
    net = build_fusion_net(cfg)
    for name, buf in net.named_buffers():
        if buf.is_floating_point():
            buf.copy_(torch.rand_like(buf) + 0.5)
    params, stats = to_flax(net)
    path = str(tmp_path / "jax")
    jck.save_checkpoint_orbax(jax.tree_util.tree_map(jnp.asarray, {
        "params": params, "batch_stats": stats}), path)
    got = ck.load_checkpoint_orbax(path)
    assert_same(got, {"params": params, "batch_stats": stats})
    again = to_flax(fusionnet_from_flax(got["params"], got["batch_stats"],
                                        cfg))
    assert_same(again[0], params)
    assert_same(again[1], stats)
    out = str(tmp_path / "port")
    ck.save_checkpoint_orbax({"params": params, "batch_stats": stats}, out)
    back = jck.load_checkpoint_orbax(out, {"params": params,
                                           "batch_stats": stats})
    assert_same(params, back["params"])
    assert_same(stats, back["batch_stats"])


def write_fixture(path: str):
    """``fixtures.ORBAX_SMALL`` as the JAX package writes it: the state at
    the fixture's seed, its ``JAX_LEAVES`` as jax arrays (bfloat16 for
    ``BF16_LEAVES``)."""
    state = fixtures.orbax_small_state(fixtures.SEED)
    for keys in fixtures.JAX_LEAVES:
        node = state
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = jnp.asarray(
            node[keys[-1]],
            jnp.bfloat16 if keys in fixtures.BF16_LEAVES else None)
    jck.save_checkpoint_orbax(state, path)


def test_fixture_equals_its_regeneration(tmp_path, monkeypatch):
    path = str(tmp_path / "orbax_small")
    write_fixture(path)
    fresh = ck.load_checkpoint_orbax(path)
    kept = ck.load_checkpoint_orbax(fixtures.ORBAX_SMALL)
    assert_same(kept, fresh)
    assert_same(kept, jax.tree_util.tree_map(
        lambda x: x if isinstance(x, (int, float)) else np.asarray(x),
        jck.load_checkpoint_orbax(fixtures.ORBAX_SMALL)))
    seed = fixtures.orbax_small_state()
    head = kept["params"]["head"]["kernel"]
    assert torch.equal(head.float(), torch.from_numpy(
        seed["params"]["head"]["kernel"]))
    assert np.array_equal(kept["labels"], seed["labels"])
    size = sum(os.path.getsize(os.path.join(b, f))
               for b, _, fs in os.walk(fixtures.ORBAX_SMALL) for f in fs)
    assert size < 200_000
    # its chunks are real zstd: Huffman literals, FSE tables, blocks
    seen = {"_block": 0, "_huffman_table": 0, "_fse_description": 0}
    for name in seen:
        fn = getattr(zstd, name)

        def counted(*a, _fn=fn, _name=name):
            seen[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(zstd, name, counted)
    store = ocdbt.open_store(fixtures.ORBAX_SMALL)
    labels = None
    for key in store.keys():
        if key.endswith(b"/.zarray"):
            continue
        frame = store.read(key)
        before = seen["_block"]
        assert bytes(zstd.decompress(frame)) == zstd.decompress_plain(frame)
        if key.startswith(b"labels/"):
            labels = seen["_block"] - before
    assert labels >= 2 and seen["_huffman_table"] >= 3
    assert seen["_fse_description"] >= 6


def test_save_replaces_and_refuses(tmp_path):
    path = str(tmp_path / "ck")
    ck.save_checkpoint_orbax({"a": torch.ones(3)}, path)
    ck.save_checkpoint_orbax({"b": torch.zeros(2)}, path, wait=False)
    assert list(ck.load_checkpoint_orbax(path)) == ["b"]
    assert os.listdir(tmp_path) == ["ck"]
    with pytest.raises(ValueError, match="zero size"):
        ck.save_checkpoint_orbax({"e": np.zeros((0, 3))}, str(tmp_path / "e"))
    with pytest.raises(TypeError):
        ck.save_checkpoint_orbax({"s": "text"}, str(tmp_path / "s"))
    assert os.listdir(tmp_path) == ["ck"]
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    assert meta["use_ocdbt"] and not meta["use_zarr3"]


@pytest.mark.parametrize("sep", [".", "/"])
def test_zarr_chunks_separators_and_fill(tmp_path, sep):
    """tensorstore's zarr driver, chunks of (4, 5) over a (10, 7) array,
    one chunk never written (null fill reads as zeros), in an OCDBT
    store."""
    path = str(tmp_path / "store")
    arr = ts.open({"driver": "zarr", "kvstore": {
        "driver": "ocdbt", "base": f"file://{path}/", "path": "x/"},
        "metadata": {"shape": [10, 7], "chunks": [4, 5], "dtype": "<i4",
                     "dimension_separator": sep, "fill_value": None,
                     "compressor": {"id": "zstd", "level": 3}},
        "create": True}).result()
    data = np.arange(70, dtype=np.int32).reshape(10, 7) + 1
    arr[:8].write(data[:8]).result()
    arr[8:, :5].write(data[8:, :5]).result()        # chunk (2, 1) absent
    store = ocdbt.open_store(path)
    assert f"x/2{sep}1".encode() not in store
    meta = json.loads(store.read(b"x/.zarray"))

    def chunk(key):
        k = f"x/{key}".encode()
        return store.read(k) if k in store else None
    got = zarr.decode(meta, chunk)
    want = data.copy()
    want[8:, 5:] = 0
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["<f4", "<f8", "<i4", "<i8", "|u1", "|b1",
                                   "<f2", "bfloat16"])
def test_zarr_dtypes_round_trip(dtype):
    rng = np.random.default_rng(1)
    dt = zarr.storage_dtype(dtype)
    raw = rng.integers(0, 256, 6 * 7 * dt.itemsize, dtype=np.uint8)
    arr = raw.view(dt).reshape(6, 7) if dt != np.bool_ else (
        raw[:42] % 2 == 0).reshape(6, 7)
    meta, key, chunk = zarr.encode(arr, dtype if dtype == "bfloat16" else
                                   None)
    assert json.loads(meta)["dtype"] == dtype and key == "0.0"
    back = zarr.decode(json.loads(meta), {"0.0": chunk}.get)
    assert back.dtype == dt and back.tobytes() == arr.tobytes()
    zero_d = zarr.encode(arr.reshape(-1)[:1].reshape(()))
    assert zero_d[1] == "0" and json.loads(zero_d[0])["chunks"] == []


def test_port_codecs_run_with_orbax_libraries_blocked(tmp_path,
                                                      monkeypatch):
    for name in ("orbax", "tensorstore", "zstandard", "jax"):
        monkeypatch.setitem(sys.modules, name, None)
    kept = ck.load_checkpoint_orbax(fixtures.ORBAX_SMALL)
    path = str(tmp_path / "ck")
    ck.save_checkpoint_orbax(kept, path)
    assert_same(ck.load_checkpoint_orbax(path), kept)
