"""zarr v2 arrays in a key-value store, as orbax keeps checkpoint leaves.

An array named ``name`` is the JSON metadata ``name/.zarray`` and its
chunks ``name/<i>.<j>...`` (``name/0`` for a 0-d array), each chunk the
C-order (or F-order) bytes of one block of the array, compressed by the
metadata's compressor. orbax writes one chunk per array (``chunks`` is
the shape), compressor ``{"id": "zstd", "level": 1}``, ``fill_value``
null, C order and the dtypes ``<f4 <f8 <i4 <i8 |u1 |b1 <f2`` and
``bfloat16``; the reader also takes several chunks with either
``dimension_separator``, chunks absent because they equalled the fill
value (null fill reads as zeros) and the other little-endian numeric
dtypes. ``bfloat16``, which numpy lacks, travels as its 16-bit pattern
in a ``uint16`` array.
"""

from __future__ import annotations

import json
import math
from typing import Callable, Optional, Tuple

import numpy as np

from . import zstd

__all__ = ["encode", "decode", "storage_dtype", "BFLOAT16"]

BFLOAT16 = "bfloat16"
_ZSTD_LEVEL = 1                              # orbax's compressor


def storage_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a zarr dtype's bytes."""
    if name == BFLOAT16:
        return np.dtype("<u2")
    dt = np.dtype(name)
    if dt.kind not in "biuf" or dt.byteorder == ">":
        raise NotImplementedError(f"zarr: dtype {name!r}")
    return dt


def _zarr_dtype(arr: np.ndarray, name: Optional[str]) -> str:
    if name is not None:
        return name
    dt = arr.dtype
    if dt.kind not in "biuf" or dt.byteorder == ">":
        raise TypeError(f"zarr: cannot store dtype {dt}")
    return dt.str


def encode(arr: np.ndarray, dtype_name: Optional[str] = None
           ) -> Tuple[bytes, str, bytes]:
    """orbax's zarr form of a non-empty ``arr``: (``.zarray`` JSON, the
    chunk's key suffix, the chunk). ``dtype_name`` names the zarr dtype
    where the array only holds its bytes (``bfloat16`` as ``uint16``)."""
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous:
        arr = arr.copy()
    meta = {"chunks": list(arr.shape),
            "compressor": {"id": "zstd", "level": _ZSTD_LEVEL},
            "dimension_separator": ".", "dtype": _zarr_dtype(arr, dtype_name),
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(arr.shape), "zarr_format": 2}
    key = ".".join("0" for _ in arr.shape) or "0"
    return (json.dumps(meta, separators=(",", ":"), sort_keys=True).encode(),
            key, zstd.compress(arr.reshape(-1).view(np.uint8)))


def decode(meta: dict, chunk: Callable[[str], Optional[bytes]]
           ) -> np.ndarray:
    """The array that ``meta`` (a parsed ``.zarray``) describes, its
    chunks read through ``chunk(key suffix)`` (None where absent)."""
    if meta.get("zarr_format") != 2:
        raise NotImplementedError(f"zarr: format {meta.get('zarr_format')}")
    if meta.get("filters"):
        raise NotImplementedError(f"zarr: filters {meta['filters']}")
    if meta.get("order", "C") != "C":
        raise NotImplementedError(f"zarr: order {meta['order']!r}")
    if (meta.get("compressor") or {}).get("id") != "zstd":
        raise NotImplementedError(f"zarr: compressor {meta.get('compressor')}")
    dt = storage_dtype(meta["dtype"])
    shape = tuple(int(d) for d in meta["shape"])
    chunks = tuple(int(c) for c in meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError(f"zarr: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    if meta["dtype"] == BFLOAT16 and fill not in (None, 0, 0.0):
        raise NotImplementedError("zarr: a bfloat16 fill value")
    size = int(np.prod(chunks, dtype=np.int64)) * dt.itemsize

    def block(data) -> np.ndarray:
        return np.frombuffer(zstd.decompress(data, size), dt).reshape(chunks)

    whole = chunk(sep.join("0" for _ in shape) or "0") \
        if chunks == shape else None
    if whole is not None:              # orbax's one chunk, no copy
        return block(whole)
    out = np.full(shape, 0 if fill is None else fill, dt)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        data = chunk(sep.join(str(i) for i in idx) or "0")
        if data is None:
            continue
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block(data)[tuple(slice(0, x.stop - x.start) for x in sl)]
    return out
