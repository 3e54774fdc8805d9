"""Checkpoints in the JAX package's format: Flax msgpack state dicts.

Port of ``segfusion_tpu/utils/checkpoints.py`` without Flax or msgpack:
a small codec in Python and numpy for the subset that
``flax.serialization.msgpack_serialize`` writes and ``msgpack_restore``
reads:

- maps with string keys, strings, ints, floats, bools and nil;
- ext type 1, an ndarray, and ext type 3, a numpy scalar, each a packed
  ``(shape, dtype name, C-order bytes)``;
- arrays over ``MAX_CHUNK_SIZE`` bytes as Flax's
  ``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``.

Integers and lengths take msgpack's shortest encoding and map keys go in
sorted order, as Flax writes them, so the bytes are Flax's own. A dtype
name the codec does not know raises. Checkpoint leaves are written as
numpy arrays (scalars as 0-d arrays), as the JAX package's
``save_checkpoint`` does.

The JAX package's orbax checkpoints (``save_checkpoint_orbax`` /
``load_checkpoint_orbax``, the directory that orbax's
``StandardCheckpointer`` writes from one process) are read and written
here without orbax or tensorstore: ``_METADATA`` and
``_CHECKPOINT_METADATA`` in JSON, every leaf a zarr v2 array
(``utils/zarr.py``) in an OCDBT key-value store (``utils/ocdbt.py``)
whose chunks are zstd frames (``utils/zstd.py``).
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import time
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from . import ocdbt, zarr

__all__ = ["save_checkpoint", "load_checkpoint", "restore_into",
           "remove_parent", "select_child", "separate_pipeline",
           "msgpack_serialize", "msgpack_restore", "save_checkpoint_orbax",
           "load_checkpoint_orbax"]

MAX_CHUNK_SIZE = 2 ** 30          # Flax's: msgpack caps a leaf at 2**31 - 1
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_DTYPES = {np.dtype(t).name: np.dtype(t) for t in (
    np.bool_, np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
    np.uint32, np.uint64, np.float16, np.float32, np.float64)}


# -- msgpack ------------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix_base, fix_max, codes):
    """Length prefix: fix form below fix_max, else the 8/16/32-bit code
    (``codes`` None where the type has no 8-bit form)."""
    if fix_base is not None and n < fix_max:
        out.append(fix_base | n)
    elif codes[0] is not None and n < 2 ** 8:
        out += bytes([codes[0], n])
    elif n < 2 ** 16:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    elif n < 2 ** 32:
        out += bytes([codes[2]]) + struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack object of length {n} is too large")


def _pack_int(out: bytearray, v: int):
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 2 ** 8), (0xCD, ">H", 2 ** 16),
                               (0xCE, ">I", 2 ** 32), (0xCF, ">Q", 2 ** 64)):
            if v < lim:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")
    else:
        for code, fmt, lim in ((0xD0, ">b", 2 ** 7), (0xD1, ">h", 2 ** 15),
                               (0xD2, ">i", 2 ** 31), (0xD3, ">q", 2 ** 63)):
            if v >= -lim:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.name not in _DTYPES:
        raise TypeError(f"dtype {arr.dtype.name!r} is not serialisable")
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(out)


def _pack(out: bytearray, x):
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out += b"\xcb" + struct.pack(">d", x)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(x, (bytes, bytearray)):
        _pack_len(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out += x
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, Mapping):
        _pack_len(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r} is not a string")
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialise {type(x).__name__}")


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ndarray_from(data: bytes) -> np.ndarray:
    shape, name, buf = _unpack(_Reader(data))
    if isinstance(name, bytes):
        name = name.decode()
    if name not in _DTYPES:
        raise TypeError(f"unknown dtype {name!r} in checkpoint")
    return np.frombuffer(bytes(buf), dtype=_DTYPES[name]).reshape(shape)


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from(data)[()]
    raise ValueError(f"unknown msgpack ext type {code}")


def _unpack(r: _Reader):
    b = r.take(1)[0]
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_unpack(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
            0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
    if b in ints:
        return r.unpack(ints[b])
    lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
            0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
            0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext:
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(fixext[b])))
    if b not in lens:
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
    n = r.unpack(lens[b])
    if b in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(n))
    if b in (0xD9, 0xDA, 0xDB):
        return str(r.take(n), "utf-8")
    if b in (0xDC, 0xDD):
        return [_unpack(r) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _map(r, n)
    code = r.unpack(">b")                          # ext 8/16/32
    return _ext(code, bytes(r.take(n)))


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def _chunked(tree):
    """A copy with the keys in sorted order (the order of Flax's pytree
    copy) and arrays over MAX_CHUNK_SIZE bytes in Flax's chunked form
    (whose keys keep Flax's insertion order)."""
    if isinstance(tree, Mapping):
        return {k: _chunked(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        step = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        chunks = [flat[i:i + step] for i in range(0, flat.size, step)]
        return {"__msgpack_chunked_array__": True,
                "shape": {str(i): d for i, d in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def _unchunked(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunked(v) for k, v in tree.items()}
    return tree


def msgpack_serialize(tree) -> bytes:
    """Bytes that ``flax.serialization.msgpack_restore`` reads back."""
    out = bytearray()
    _pack(out, _chunked(tree))
    return bytes(out)


def msgpack_restore(data: bytes):
    """A tree that ``flax.serialization.msgpack_serialize`` wrote."""
    r = _Reader(data)
    tree = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunked(tree)


# -- checkpoints --------------------------------------------------------------

def _to_host(tree):
    """Leaves as numpy arrays (torch tensors copied to the host, scalars
    as 0-d arrays), as the JAX package's ``save_checkpoint`` stores them."""
    if isinstance(tree, Mapping):
        return {str(k): _to_host(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(state: Dict[str, Any], path: str):
    """Write a checkpoint dict (params / batch_stats / opt_state / epoch /
    metrics, nested dicts of arrays) to ``path`` through a temporary file
    and ``os.replace``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = msgpack_serialize(_to_host(state))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def restore_into(template, state_dict):
    """``state_dict``'s values in the structure of ``template``: every
    key of the template must be present and every array the template's
    shape; keys the template lacks are ignored."""
    def walk(t, s, path):
        if isinstance(t, Mapping):
            if not isinstance(s, Mapping):
                raise ValueError(f"{path or '/'}: expected a dict")
            missing = [k for k in t if k not in s]
            if missing:
                raise ValueError(f"{path or '/'}: state lacks {missing}")
            return {k: walk(v, s[k], f"{path}/{k}") for k, v in t.items()}
        if np.shape(t) != np.shape(s):
            raise ValueError(f"{path}: shape {np.shape(s)} where the "
                             f"template has {np.shape(t)}")
        return s
    return walk(template, state_dict, "")


def remove_parent(tree: Mapping, parent: str) -> Dict:
    """Strip a top-level key prefix (``module.``, ``_fusion_network.``):
    lift the child of a nested dict, or cut ``parent.`` from flat keys."""
    if parent in tree:
        return dict(tree[parent])
    pref = parent + "."
    return {(k[len(pref):] if isinstance(k, str) and k.startswith(pref)
             else k): v for k, v in tree.items()}


def select_child(tree: Mapping, child: str) -> Dict:
    """Keep only the subtree under ``child`` (nested or ``child.``-prefixed
    flat keys)."""
    if child in tree:
        return dict(tree[child])
    pref = child + "."
    return {k[len(pref):]: v for k, v in tree.items()
            if isinstance(k, str) and k.startswith(pref)}


def separate_pipeline(pipeline_ckpt_path: str, fusion_out_path: str,
                      key: str = "fusion") -> Dict:
    """Split a pipeline checkpoint into a standalone fusion-network
    checkpoint (params / batch_stats under ``key``, and the epoch)."""
    ckpt = load_checkpoint(pipeline_ckpt_path)
    fusion = {
        "params": ckpt.get("params", {}).get(key, ckpt.get("params")),
        "batch_stats": ckpt.get("batch_stats", {}).get(
            key, ckpt.get("batch_stats", {})),
        "epoch": ckpt.get("epoch", 0),
    }
    save_checkpoint(fusion, fusion_out_path)
    return fusion


# -- orbax checkpoints --------------------------------------------------------

_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
_DICT_KEY = 2                      # orbax's key_type of a dict key
_EMPTY = object()                  # an empty dict or list in the tree


def _orbax_leaves(tree, path: Tuple[str, ...] = ()):
    """(key path, leaf) in key order, lists and tuples as dicts keyed
    "0", "1", ... (``flax.serialization.to_state_dict``); an empty dict
    inside the tree is a leaf of its own, as orbax records it."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, Mapping):
        if not tree and path:
            yield path, _EMPTY
        for k in sorted(tree, key=str):
            yield from _orbax_leaves(tree[k], path + (str(k),))
    else:
        yield path, tree


def _orbax_array(leaf):
    """(value type, array, zarr dtype name or None) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return ("np.ndarray", t.contiguous().view(torch.int16).numpy()
                    .view(np.uint16), zarr.BFLOAT16)
        return "np.ndarray", t.numpy(), None
    if isinstance(leaf, (np.ndarray, np.generic)):
        arr = np.asarray(leaf)
        if arr.dtype.name == zarr.BFLOAT16:            # ml_dtypes' bfloat16
            return "np.ndarray", arr.view(np.uint16), zarr.BFLOAT16
        return "np.ndarray", arr, None
    if isinstance(leaf, (bool, int, float)):
        return "scalar", np.asarray(leaf), None
    raise TypeError(f"cannot save a leaf of type {type(leaf).__name__}")


def save_checkpoint_orbax(state: Dict[str, Any], path: str,
                          wait: bool = True):
    """Write ``state`` (nested dicts of torch tensors, numpy arrays and
    Python scalars) as the directory that orbax's ``StandardCheckpointer``
    writes from one process, replacing a directory already at ``path``
    (orbax's ``force=True``) through a temporary directory and a rename.
    Tensors are copied to the host, bfloat16 as its 16-bit pattern under
    the zarr dtype ``bfloat16``; Python scalars are orbax's ``scalar``
    leaves, the rest ``np.ndarray`` leaves. The write is synchronous:
    ``wait`` is accepted for the JAX signature, and the checkpoint is
    complete on return either way."""
    del wait
    path = os.path.abspath(path)
    init = time.time_ns()
    tmp = f"{path}.orbax-checkpoint-tmp-{init}"
    items: Dict[bytes, bytes] = {}
    tree: Dict[str, Any] = {}
    for keys, leaf in _orbax_leaves(state):
        entry = {"key_metadata": [{"key": k, "key_type": _DICT_KEY}
                                  for k in keys]}
        if leaf is _EMPTY:
            entry["value_metadata"] = {"value_type": "Dict",
                                       "skip_deserialize": True}
        else:
            kind, arr, dtype_name = _orbax_array(leaf)
            if arr.size == 0:
                raise ValueError(f"cannot save arrays with zero size: "
                                 f"{'.'.join(keys)}")
            meta, chunk_key, chunk = zarr.encode(arr, dtype_name)
            name = ".".join(keys)
            items[f"{name}/.zarray".encode()] = meta
            items[f"{name}/{chunk_key}".encode()] = chunk
            entry["value_metadata"] = {"value_type": kind,
                                       "skip_deserialize": False}
        tree[str(keys)] = entry
    os.makedirs(tmp)
    try:
        ocdbt.write_store(tmp, items)
        _write_json(os.path.join(tmp, "_METADATA"), {
            "tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None})
        _write_json(os.path.join(tmp, "_CHECKPOINT_METADATA"), {
            "item_handlers": _HANDLER, "metrics": {},
            "performance_metrics": {}, "init_timestamp_nsecs": init,
            "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}})
        if os.path.lexists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _write_json(path: str, obj):
    with open(path, "w") as f:
        f.write(json.dumps(obj))


def _orbax_leaf(store, keys: List[str], kind: str):
    name = ".".join(keys)
    meta = json.loads(store.read(f"{name}/.zarray".encode()))

    def chunk(key: str):
        k = f"{name}/{key}".encode()
        return store.read(k) if k in store else None

    arr = zarr.decode(meta, chunk)
    if meta["dtype"] == zarr.BFLOAT16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr.item() if kind == "scalar" else arr


def load_checkpoint_orbax(path: str, template=None) -> Dict[str, Any]:
    """Read a checkpoint that orbax's ``StandardCheckpointer`` (or
    :func:`save_checkpoint_orbax`) wrote. Without a template: nested
    dicts of numpy arrays (``np.ndarray`` and ``jax.Array`` leaves),
    CPU ``torch.bfloat16`` tensors (bfloat16 leaves, which numpy lacks)
    and Python scalars (``scalar`` leaves). With a template (nested dicts
    of tensors, arrays and scalars): the template's structure, each leaf
    of the template leaf's type and dtype, a tensor on its device. A key
    that one tree has and the other lacks raises ``ValueError``, as in
    orbax, and so does an array whose shape differs from the template's
    (orbax raises for ``jax.Array`` templates and returns the stored
    shape for numpy ones). ``_sharding`` and ``array_metadatas`` are not
    needed and not read."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    store = ocdbt.open_store(path)
    tree: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        kind = value["value_type"]
        if kind == "Dict":                     # an empty dict
            leaf = {}
        elif value.get("skip_deserialize"):
            continue
        else:
            leaf = _orbax_leaf(store, keys, kind)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    if template is None:
        return tree
    return _into_template(template, tree, "")


def _into_template(t, s, path: str):
    if isinstance(t, (list, tuple)):
        d = _into_template({str(i): v for i, v in enumerate(t)}, s, path)
        return type(t)(d[str(i)] for i in range(len(t)))
    if isinstance(t, Mapping):
        if not isinstance(s, Mapping):
            raise ValueError(f"{path or '/'}: the checkpoint holds a leaf "
                             f"where the template has a dict")
        missing = sorted(set(map(str, t)) - set(s))
        extra = sorted(set(s) - set(map(str, t)))
        if missing or extra:
            raise ValueError(f"{path or '/'}: the template's keys do not "
                             f"match the checkpoint's: the checkpoint lacks "
                             f"{missing}, the template lacks {extra}")
        return {k: _into_template(v, s[str(k)], f"{path}/{k}")
                for k, v in t.items()}
    if isinstance(s, Mapping):
        raise ValueError(f"{path}: the checkpoint holds a dict where the "
                         f"template has a leaf")
    if isinstance(t, torch.Tensor):
        v = s if isinstance(s, torch.Tensor) else torch.from_numpy(
            np.array(s))
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{path}: shape {tuple(v.shape)} where the "
                             f"template has {tuple(t.shape)}")
        return v.to(device=t.device, dtype=t.dtype)
    if isinstance(t, (np.ndarray, np.generic)):
        v = (s.float().numpy() if isinstance(s, torch.Tensor)
             else np.asarray(s))
        if v.shape != np.shape(t):
            raise ValueError(f"{path}: shape {v.shape} where the template "
                             f"has {np.shape(t)}")
        v = v.astype(t.dtype)
        return v if isinstance(t, np.ndarray) else v[()]
    if isinstance(t, (bool, int, float)):
        v = s.float() if isinstance(s, torch.Tensor) else np.asarray(s)
        if tuple(v.shape) != ():
            raise ValueError(f"{path}: shape {tuple(v.shape)} where the "
                             f"template has a scalar")
        return type(t)(v.item())
    raise TypeError(f"{path}: cannot restore into a template leaf of type "
                    f"{type(t).__name__}")
