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
``save_checkpoint`` does. The orbax checkpoints of the JAX
package come with multihost support (ROADMAP Queue 1 #4).
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Mapping

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "restore_into",
           "remove_parent", "select_child", "separate_pipeline",
           "msgpack_serialize", "msgpack_restore"]

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
