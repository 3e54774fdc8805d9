"""HDF5 files read and written with numpy, ``struct`` and ``zlib``.

The project's volumes (the gt semantic sdf grids, the Database's
``.tsdf``/``.weights``/``.semantics`` saves, the preprocessing's
``_sdf.hdf``) are HDF5 files of a few numeric datasets in the root group
with numeric attributes beside them. This module reads and writes that
subset without h5py, with an interface close to h5py's::

    with File(path, "w") as f:
        f.create_dataset("sdf", data=grid, compression="gzip",
                         compression_opts=9)
        f.attrs["voxel_size"] = 0.01
    with File(path, "r") as f:
        grid = f["sdf"]                 # the whole dataset, a numpy array
        voxel = float(f.attrs["voxel_size"])

The reader takes what HDF5 1.8-1.14 write for such files at any
``libver``: superblocks v0-v3; object headers v1 and v2 with their
continuation blocks; a root group held as a symbol table (v1 B-tree of
type 0, symbol table nodes, local heap) or as compact link messages;
scalar and simple dataspaces; little- and big-endian integers of 1/2/4/8
bytes and IEEE floats of 2/4/8 bytes; compact, contiguous and chunked
layouts, the chunks indexed by a v1 B-tree (layout message v3) or by the
single-chunk or fixed-array index (v4, paged or not), partial edge
chunks cropped; the deflate, shuffle and fletcher32 filters (the
checksum is checked); attributes in the object header. Anything else
(dense attribute or link storage, strings, compound, enum or
variable-length types, other filters, the implicit, extensible-array and
v2 B-tree indexes) raises ``NotImplementedError`` naming the structure.

The writer writes superblock v0, a symbol-table root group and v1 object
headers: what HDF5 writes at its default ``libver="earliest"``. A
dataset is contiguous, or chunked with deflate at the given level
(``compression="gzip"``), its chunks compressed on a thread pool and
indexed by a v1 B-tree of as many levels as the chunk count needs; the
chunk shape is h5py's ``guess_chunk`` rule unless one is given.
Attributes go in the root group's object header.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["File", "guess_chunk"]

SIGNATURE = b"\x89HDF\r\n\x1a\n"
_WORKERS = min(16, os.cpu_count() or 1)

# message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0, 1, 2, 3, 4, 5
_LINK, _LAYOUT, _FILTERS, _ATTRIBUTE = 6, 8, 11, 12
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 16, 17, 21

# filters
_DEFLATE, _SHUFFLE, _FLETCHER32 = 1, 2, 3
_FILTER_NAMES = {4: "szip", 5: "nbit", 6: "scaleoffset", 32000: "lzf",
                 32001: "blosc", 32004: "lz4", 32015: "zstd"}

_TYPE_CLASSES = ["fixed-point", "floating-point", "time", "string",
                 "bitfield", "opaque", "compound", "reference", "enum",
                 "variable-length", "array"]

# IEEE float layouts: size -> (sign location, exponent location, exponent
# size, mantissa location, mantissa size, exponent bias)
_IEEE = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127),
         8: (63, 52, 11, 0, 52, 1023)}

# v1 B-tree ranks: K for the group tree (superblock v0's "group internal
# node K"), the symbol table node's K ("group leaf node K") and the chunk
# tree's K (HDF5's default, which a v0 superblock does not store)
_GROUP_K, _LEAF_K, _CHUNK_K = 16, 4, 32


def _batched(fn, items):
    """``fn`` over ``items`` on a thread pool, in a few batches a worker
    (zlib releases the GIL while it deflates or inflates); yields each
    batch's results, the batches in order."""
    if len(items) < 2 or _WORKERS == 1:
        yield [fn(x) for x in items]
        return
    n = min(len(items), 4 * _WORKERS)
    bounds = [round(i * len(items) / n) for i in range(n + 1)]
    with ThreadPoolExecutor(_WORKERS) as pool:
        yield from pool.map(lambda ab: [fn(x) for x in items[ab[0]:ab[1]]],
                            zip(bounds, bounds[1:]))


def _undefined(n: int) -> int:
    return (1 << (8 * n)) - 1


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _Cursor:
    """Little-endian reads from a bytes buffer, addresses and lengths at
    the file's widths."""

    def __init__(self, buf: bytes, pos: int = 0, so: int = 8, sl: int = 8):
        self.buf, self.pos, self.so, self.sl = buf, pos, so, sl

    def u(self, n: int) -> int:
        if self.pos + n > len(self.buf):
            raise ValueError("HDF5: truncated structure")
        v = int.from_bytes(self.buf[self.pos:self.pos + n], "little")
        self.pos += n
        return v

    def addr(self) -> int:
        return self.u(self.so)

    def length(self) -> int:
        return self.u(self.sl)

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("HDF5: truncated structure")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def skip(self, n: int):
        self.pos += n


# -- checksums and filters ----------------------------------------------------

def _fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 of ``data``: sums of big-endian 16-bit words (an
    odd last byte the high byte of a word) folded to 16 bits, where a
    nonzero sum never folds to 0."""
    a = np.frombuffer(data, np.uint8)
    if len(a) % 2:
        a = np.concatenate([a, np.zeros(1, np.uint8)])
    w = (a[0::2].astype(np.int64) << 8) | a[1::2]
    n = len(w)
    s1 = int(w.sum())
    if s1 == 0:
        return 0
    s2, step = 0, 1 << 20
    for lo in range(0, n, step):
        part = w[lo:lo + step]
        weights = (n - np.arange(lo, lo + len(part), dtype=np.int64)) % 65535
        s2 = (s2 + int((weights * part).sum())) % 65535
    return ((s2 or 65535) << 16) | ((s1 - 1) % 65535 + 1)


def _unshuffle(b: bytes, size: int) -> bytes:
    n = len(b) // size
    if size <= 1 or n <= 1:
        return b
    a = np.frombuffer(b, np.uint8)
    body = a[:n * size].reshape(size, n).T.tobytes()
    return body + b[n * size:]


def _unfilter(raw: bytes, filters, mask: int, size: int) -> bytes:
    """The chunk's stored bytes through its pipeline, last filter first,
    towards a chunk of ``size`` bytes; filter i is skipped where bit i of
    ``mask`` is set."""
    for i in reversed(range(len(filters))):
        if mask >> i & 1:
            continue
        fid, values = filters[i]
        if fid == _DEFLATE:
            # an output buffer of the chunk's size from the start: no
            # growth and no final copy while holding the GIL
            raw = zlib.decompress(raw, 15, size + 4)
        elif fid == _SHUFFLE:
            raw = _unshuffle(raw, values[0])
        elif fid == _FLETCHER32:
            body, stored = raw[:-4], int.from_bytes(raw[-4:], "little")
            sum_ = _fletcher32(body)
            # files of HDF5 before 1.6.1 hold it byte-swapped
            swapped = int.from_bytes(sum_.to_bytes(4, "little"), "big")
            if stored not in (sum_, swapped):
                raise ValueError("HDF5: fletcher32 checksum mismatch")
            raw = body
    return raw


# -- the reader's structures ---------------------------------------------------

def _dtype(c: _Cursor) -> np.dtype:
    """A datatype message's numpy dtype (fixed-point or IEEE float)."""
    b0 = c.u(1)
    cls = b0 & 15
    bits = c.take(3)
    size = c.u(4)
    if cls == 0:
        offset, precision = c.u(2), c.u(2)
        if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
            raise NotImplementedError(
                f"HDF5 fixed-point datatype of {size} bytes, bit offset "
                f"{offset}, precision {precision}")
        kind = "i" if bits[0] & 8 else "u"
        order = ">" if bits[0] & 1 else "<"
    elif cls == 1:
        offset, precision = c.u(2), c.u(2)
        layout = (bits[1], c.u(1), c.u(1), c.u(1), c.u(1), c.u(4))
        if (bits[0] & 0x40 or _IEEE.get(size) != layout or offset
                or precision != 8 * size or (bits[0] >> 4) & 3 != 2):
            raise NotImplementedError(
                f"HDF5 floating-point datatype of {size} bytes that is not "
                "an IEEE 754 layout")
        kind = "f"
        order = ">" if bits[0] & 1 else "<"
    else:
        name = _TYPE_CLASSES[cls] if cls < len(_TYPE_CLASSES) else str(cls)
        if cls == 9 and bits[0] & 15 == 1:
            name += " string"
        raise NotImplementedError(f"HDF5 {name} datatype")
    return np.dtype(f"{'|' if size == 1 else order}{kind}{size}")


def _dataspace(c: _Cursor) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(dims, max dims) of a dataspace message; () for a scalar."""
    version, rank, flags = c.u(1), c.u(1), c.u(1)
    if version == 1:
        c.skip(5)
    elif version == 2:
        if c.u(1) == 2:
            raise NotImplementedError("HDF5 null dataspace")
    else:
        raise NotImplementedError(f"HDF5 dataspace message v{version}")
    dims = tuple(c.length() for _ in range(rank))
    maxdims = tuple(c.length() for _ in range(rank)) if flags & 1 else dims
    return dims, maxdims


def _fill(c: _Cursor) -> Optional[bytes]:
    """The fill value's bytes of a fill value message (v1-v3), or None."""
    version = c.u(1)
    if version in (1, 2):
        c.skip(2)
        defined = c.u(1)
        if version == 1 or defined:
            size = c.u(4)
            return c.take(size) if size else None
        return None
    if version == 3:
        flags = c.u(1)
        if flags & 0x20:
            size = c.u(4)
            return c.take(size) if size else None
        return None
    raise NotImplementedError(f"HDF5 fill value message v{version}")


def _pipeline(c: _Cursor):
    """[(filter id, client values)] of a filter pipeline message."""
    version, n = c.u(1), c.u(1)
    if version == 1:
        c.skip(6)
    elif version != 2:
        raise NotImplementedError(f"HDF5 filter pipeline message v{version}")
    filters = []
    for _ in range(n):
        fid = c.u(2)
        name_len = c.u(2) if version == 1 or fid >= 256 else 0
        c.skip(2)                                   # flags
        nvalues = c.u(2)
        c.skip(name_len)     # v1 pads the name to 8 bytes in name_len
        values = [c.u(4) for _ in range(nvalues)]
        if version == 1 and nvalues % 2:
            c.skip(4)
        if fid not in (_DEFLATE, _SHUFFLE, _FLETCHER32):
            raise NotImplementedError(
                f"HDF5 filter {_FILTER_NAMES.get(fid, fid)}")
        filters.append((fid, values))
    return filters


class _Dataset:
    """A dataset's messages, parsed."""

    def __init__(self):
        self.dims = self.maxdims = self.dtype = self.layout = None
        self.filters: list = []
        self.fill: Optional[bytes] = None


class _Reader:
    """The read side of ``File``: the superblock, the root group's links
    and attributes, and whole-dataset reads."""

    def __init__(self, path: str):
        self._fh = open(path, "rb")
        try:
            self._fd = self._fh.fileno()
            self._open()
        except BaseException:
            self._fh.close()
            raise

    def close(self):
        self._fh.close()

    # raw reads ----------------------------------------------------------------

    def read(self, addr: int, n: int) -> bytes:
        out = bytearray(n)
        self._read_into(memoryview(out), addr)
        return bytes(out)

    def _read_into(self, view: memoryview, addr: int):
        view = view.cast("B")
        pos, off = 0, self.base + addr
        while pos < len(view):
            got = os.preadv(self._fd, [view[pos:pos + (1 << 30)]], off + pos)
            if got <= 0:
                raise ValueError("HDF5: file truncated")
            pos += got

    def cursor(self, addr: int, n: int) -> _Cursor:
        return _Cursor(self.read(addr, n), 0, self.so, self.sl)

    # superblock and groups ----------------------------------------------------

    def _open(self):
        size = os.fstat(self._fd).st_size
        start = 0
        while True:
            if start + 8 > size:
                raise ValueError("not an HDF5 file (no superblock signature)")
            if os.pread(self._fd, 8, start) == SIGNATURE:
                break
            start = 512 if start == 0 else 2 * start
        head = os.pread(self._fd, 256, start)
        version = head[8]
        if version in (0, 1):
            self.so, self.sl = head[13], head[14]
            c = _Cursor(head, 24 + (4 if version == 1 else 0), self.so,
                        self.sl)
            self.base = c.addr()
            c.skip(3 * self.so)     # free-space, end-of-file, VFD addresses
            c.skip(self.so)                         # the root's name offset
            root = c.addr()
        elif version in (2, 3):
            self.so, self.sl = head[9], head[10]
            c = _Cursor(head, 12, self.so, self.sl)
            self.base = c.addr()
            c.skip(2 * self.so)               # extension, end of file
            root = c.addr()
        else:
            raise NotImplementedError(f"HDF5 superblock v{version}")
        self.undef = _undefined(self.so)
        self.links, self.root_messages = self._group(root)

    def messages(self, addr: int) -> List[Tuple[int, int, bytes]]:
        """[(type, flags, body)] of the object header at ``addr``, its
        continuation blocks followed."""
        head = self.read(addr, 16)
        out: List[Tuple[int, int, bytes]] = []
        blocks = []
        if head[:4] == b"OHDR":
            flags = head[5]
            pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 3)
            size = int.from_bytes(self.read(addr + pos, width), "little")
            blocks.append((addr + pos + width, size))
            v2, order = True, 2 if flags & 0x04 else 0
        elif head[0] == 1:
            blocks.append((addr + 16, int.from_bytes(head[8:12], "little")))
            v2, order = False, 0
        else:
            raise NotImplementedError(
                f"HDF5 object header v{head[0]} at {addr}")
        while blocks:
            start, size = blocks.pop(0)
            c = _Cursor(self.read(start, size), 0, self.so, self.sl)
            hsize = 4 + order if v2 else 8
            while c.pos + hsize <= len(c.buf):
                if v2:
                    mtype, msize, mflags = c.u(1), c.u(2), c.u(1)
                    c.skip(order)
                else:
                    mtype, msize, mflags = c.u(2), c.u(2), c.u(1)
                    c.skip(3)
                body = c.take(msize)
                if mtype == _CONTINUATION:
                    cc = _Cursor(body, 0, self.so, self.sl)
                    where, length = cc.addr(), cc.length()
                    if v2:
                        if self.read(where, 4) != b"OCHK":
                            raise ValueError("HDF5: bad continuation block")
                        blocks.append((where + 4, length - 8))
                    else:
                        blocks.append((where, length))
                elif mtype != _NIL:
                    out.append((mtype, mflags, body))
        return out

    def _group(self, addr: int):
        """({name: object header address}, the group's messages)."""
        msgs = self.messages(addr)
        links: Dict[str, int] = {}
        for mtype, _, body in msgs:
            c = _Cursor(body, 0, self.so, self.sl)
            if mtype == _SYMBOL_TABLE:
                btree, heap = c.addr(), c.addr()
                links.update(self._symbol_table(btree, heap))
            elif mtype == _LINK_INFO:
                c.skip(1)
                if c.u(1) & 1:
                    c.skip(8)
                if c.addr() != self.undef:
                    raise NotImplementedError(
                        "HDF5 dense link storage (fractal heap)")
            elif mtype == _LINK:
                name, target = self._link(c)
                links[name] = target
        return links, msgs

    def _link(self, c: _Cursor):
        c.skip(1)                                   # version
        flags = c.u(1)
        kind = c.u(1) if flags & 0x08 else 0
        if flags & 0x04:
            c.skip(8)
        if flags & 0x10:
            c.skip(1)
        name = c.take(c.u(1 << (flags & 3))).decode("utf-8")
        if kind != 0:
            raise NotImplementedError(
                f"HDF5 {'soft' if kind == 1 else 'external'} link {name!r}")
        return name, c.addr()

    def _symbol_table(self, btree: int, heap: int) -> Dict[str, int]:
        hc = self.cursor(heap, 8 + 2 * self.sl + self.so)
        if hc.take(4) != b"HEAP":
            raise ValueError("HDF5: bad local heap")
        hc.skip(4)
        heap_size = hc.length()
        hc.skip(self.sl)
        names = self.read(hc.addr(), heap_size)
        links = {}
        for snod in self._btree_children(btree, 0, self.sl):
            c = self.cursor(snod, 8)
            if c.take(4) != b"SNOD":
                raise ValueError("HDF5: bad symbol table node")
            c.skip(2)
            n = c.u(2)
            entry = 2 * self.so + 24
            c = self.cursor(snod + 8, n * entry)
            for _ in range(n):
                off, obj = c.addr(), c.addr()
                c.skip(24)
                links[names[off:names.index(b"\0", off)].decode("utf-8")] = obj
        return links

    def _btree_nodes(self, addr: int, node_type: int, key_size: int):
        """[(keys, children)] of the leaves under the v1 B-tree node at
        ``addr``, left to right."""
        c = self.cursor(addr, 8 + 2 * self.so)
        if c.take(4) != b"TREE" or c.u(1) != node_type:
            raise ValueError("HDF5: bad v1 B-tree node")
        level, n = c.u(1), c.u(2)
        c = self.cursor(addr + 8 + 2 * self.so,
                        n * (key_size + self.so) + key_size)
        keys, children = [], []
        for _ in range(n):
            keys.append(c.take(key_size))
            children.append(c.addr())
        if level == 0:
            return [(keys, children)]
        out = []
        for child in children:
            out += self._btree_nodes(child, node_type, key_size)
        return out

    def _btree_children(self, addr: int, node_type: int, key_size: int):
        return [child for _, children in
                self._btree_nodes(addr, node_type, key_size)
                for child in children]

    # attributes ----------------------------------------------------------------

    def attributes(self, msgs) -> Dict[str, np.ndarray]:
        out = {}
        for mtype, mflags, body in msgs:
            if mtype == _ATTRIBUTE_INFO:
                c = _Cursor(body, 1, self.so, self.sl)
                if c.u(1) & 1:
                    c.skip(2)
                if c.addr() != self.undef:
                    raise NotImplementedError(
                        "HDF5 dense attribute storage (fractal heap)")
            elif mtype == _ATTRIBUTE:
                name, value = self._attribute(body, mflags)
                out[name] = value
        return out

    def _attribute(self, body: bytes, mflags: int):
        c = _Cursor(body, 0, self.so, self.sl)
        version, flags = c.u(1), c.u(1)
        name_size, dt_size, ds_size = c.u(2), c.u(2), c.u(2)
        if version == 3:
            c.skip(1)                               # name encoding
        elif version not in (1, 2):
            raise NotImplementedError(f"HDF5 attribute message v{version}")
        if (version > 1 and flags & 3) or mflags & 2:
            raise NotImplementedError("HDF5 attribute of a shared datatype "
                                      "or dataspace")
        pad = _pad8 if version == 1 else (lambda n: n)
        name = c.take(pad(name_size))[:name_size].split(b"\0")[0].decode()
        start = c.pos
        dtype = _dtype(c)
        c.pos = start + pad(dt_size)
        start = c.pos
        dims, _ = _dataspace(c)
        c.pos = start + pad(ds_size)
        count = math.prod(dims)
        value = np.frombuffer(c.take(count * dtype.itemsize), dtype,
                              count).reshape(dims).copy()
        return name, value[()] if dims == () else value

    # datasets ------------------------------------------------------------------

    def dataset(self, addr: int) -> np.ndarray:
        d = _Dataset()
        for mtype, mflags, body in self.messages(addr):
            if mflags & 2 and mtype in (_DATASPACE, _DATATYPE, _FILL,
                                        _FILTERS):
                raise NotImplementedError(
                    f"HDF5 shared (committed) message of type {mtype}")
            c = _Cursor(body, 0, self.so, self.sl)
            if mtype == _DATASPACE:
                d.dims, d.maxdims = _dataspace(c)
            elif mtype == _DATATYPE:
                d.dtype = _dtype(c)
            elif mtype == _FILL:
                d.fill = _fill(c)
            elif mtype == _FILL_OLD and d.fill is None:
                d.fill = c.take(c.u(4)) or None
            elif mtype == _FILTERS:
                d.filters = _pipeline(c)
            elif mtype == _LAYOUT:
                d.layout = c
        if d.dims is None or d.dtype is None or d.layout is None:
            raise NotImplementedError(
                "HDF5 object that is not a dataset (a group?)")
        return self._data(d)

    def _filled(self, d: _Dataset) -> np.ndarray:
        if d.fill is None or not any(d.fill):
            return np.zeros(d.dims, d.dtype)
        return np.full(d.dims, np.frombuffer(d.fill, d.dtype, 1)[0], d.dtype)

    def _data(self, d: _Dataset) -> np.ndarray:
        c = d.layout
        version, kind = c.u(1), c.u(1)
        if version not in (3, 4):
            raise NotImplementedError(f"HDF5 layout message v{version}")
        nbytes = math.prod(d.dims) * d.dtype.itemsize
        if kind == 0:                               # compact
            size = c.u(2)
            raw = c.take(size)[:nbytes]
            return np.frombuffer(raw, d.dtype).reshape(d.dims).copy()
        if kind == 1:                               # contiguous
            where = c.addr()
            if where == self.undef:
                return self._filled(d)
            out = np.empty(d.dims, d.dtype)
            if nbytes:
                self._read_into(memoryview(out.reshape(-1)).cast("B"), where)
            return out
        if kind != 2:
            raise NotImplementedError(f"HDF5 layout class {kind}")
        if version == 3:
            rank = c.u(1) - 1
            btree = c.addr()
            cdims = tuple(c.u(4) for _ in range(rank))
            chunks = self._btree_chunks(btree, rank)
            partial_unfiltered = False
        else:
            flags, ndims, width = c.u(1), c.u(1), c.u(1)
            cdims = tuple(c.u(width) for _ in range(ndims))[:-1]
            rank = ndims - 1
            chunks = self._indexed_chunks(c, d, cdims, flags)
            partial_unfiltered = bool(flags & 1)
        if rank != len(d.dims):
            raise ValueError("HDF5: chunk rank is not the dataset's")
        return self._assemble(d, cdims, chunks, partial_unfiltered)

    def _btree_chunks(self, addr: int, rank: int):
        """[(chunk offset, address, stored bytes, filter mask)] of a v1
        B-tree chunk index."""
        key_size = 8 + 8 * (rank + 1)
        chunks = []
        if addr == self.undef:
            return chunks
        for keys, children in self._btree_nodes(addr, 1, key_size):
            for key, child in zip(keys, children):
                size, mask = struct.unpack_from("<II", key)
                offset = struct.unpack_from(f"<{rank}Q", key, 8)
                chunks.append((offset, child, size, mask))
        return chunks

    def _indexed_chunks(self, c: _Cursor, d: _Dataset, cdims, flags: int):
        """The chunks of a layout v4 index (single chunk, fixed array)."""
        index = c.u(1)
        grid = [-(-m // k) for m, k in zip(d.maxdims, cdims)]
        raw_bytes = math.prod(cdims) * d.dtype.itemsize
        if index == 1:                              # single chunk
            size, mask = raw_bytes, 0
            if flags & 2:
                size, mask = c.length(), c.u(4)
            where = c.addr()
            if where == self.undef:
                return []
            return [((0,) * len(cdims), where, size, mask)]
        if index == 3:                              # fixed array
            c.skip(1)                               # page bits (header too)
            where = c.addr()
            if where == self.undef:
                return []
            return self._fixed_array(where, grid, cdims, bool(d.filters),
                                     raw_bytes)
        raise NotImplementedError(
            {2: "HDF5 implicit chunk index",
             4: "HDF5 extensible-array chunk index",
             5: "HDF5 v2 B-tree chunk index"}.get(
                 index, f"HDF5 chunk index type {index}"))

    @staticmethod
    def _offset(i: int, grid, cdims):
        scaled = np.unravel_index(i, grid)
        return tuple(int(s) * k for s, k in zip(scaled, cdims))

    def _fixed_array(self, addr: int, grid, cdims, filtered: bool,
                     raw_bytes: int):
        c = self.cursor(addr, 12 + self.sl + self.so)
        if c.take(4) != b"FAHD":
            raise ValueError("HDF5: bad fixed array header")
        c.skip(2)
        esize, page_bits = c.u(1), c.u(1)
        n, block = c.length(), c.addr()
        page = 1 << page_bits
        npages = -(-n // page) if n > page else 0
        prefix = 10 + self.so + (-(-npages // 8) if npages else 0)
        head = self.read(block, prefix)
        if head[:4] != b"FADB":
            raise ValueError("HDF5: bad fixed array data block")
        if npages:
            bitmap = head[6 + self.so:prefix - 4]
            raw = bytearray()
            pos = block + prefix
            for p in range(npages):
                count = min(page, n - p * page)
                if bitmap[p // 8] & (0x80 >> (p % 8)):
                    raw += self.read(pos, count * esize)
                else:
                    raw += b"\xff" * (count * esize)
                pos += count * esize + 4
        else:
            raw = self.read(block + prefix - 4, n * esize)
        c = _Cursor(bytes(raw), 0, self.so, self.sl)
        chunks = []
        for i in range(n):
            where = c.addr()
            size, mask = raw_bytes, 0
            if filtered:
                size = c.u(esize - self.so - 4)
                mask = c.u(4)
            if where != self.undef:
                chunks.append((self._offset(i, grid, cdims), where, size,
                               mask))
        return chunks

    def _assemble(self, d: _Dataset, cdims, chunks, partial_unfiltered):
        whole = math.prod(-(-m // k) for m, k in zip(d.dims, cdims))
        out = self._filled(d) if len(chunks) < whole else np.empty(
            d.dims, d.dtype)
        raw_bytes = math.prod(cdims) * d.dtype.itemsize

        def decode(chunk):
            offset, where, size, mask = chunk
            edge = any(o + k > m for o, k, m in zip(offset, cdims, d.dims))
            raw = self.read(where, size)
            if not (edge and partial_unfiltered):
                raw = _unfilter(raw, d.filters, mask, raw_bytes)
            if len(raw) != raw_bytes:
                raise ValueError(f"HDF5: chunk at {offset} holds {len(raw)} "
                                 f"bytes, not {raw_bytes}")
            return raw

        # chunks past the dims (of a dataset that may grow) hold nothing
        chunks = [ch for ch in chunks
                  if all(o < m for o, m in zip(ch[0], d.dims))]
        # decoded on the pool, placed here batch by batch as they arrive
        placed = iter(chunks)
        for part in _batched(decode, chunks):
            for raw, chunk in zip(part, placed):
                sl = tuple(slice(o, min(o + k, m))
                           for o, k, m in zip(chunk[0], cdims, d.dims))
                block = np.frombuffer(raw, d.dtype).reshape(cdims)
                out[sl] = block[tuple(slice(0, e.stop - e.start)
                                      for e in sl)]
        return out


# -- the writer ----------------------------------------------------------------

CHUNK_BASE, CHUNK_MIN, CHUNK_MAX = 16 * 1024, 8 * 1024, 1024 * 1024


def guess_chunk(shape, typesize: int) -> Tuple[int, ...]:
    """h5py's chunk shape rule: halve the axes in turn until a chunk is
    near a target that grows with the dataset (8 KiB to 1 MiB)."""
    chunks = np.array([x if x != 0 else 1024 for x in shape], dtype="=f8")
    dset_size = np.prod(chunks) * typesize
    target = CHUNK_BASE * (2 ** np.log10(dset_size / (1024.0 * 1024)))
    target = min(max(target, CHUNK_MIN), CHUNK_MAX)
    idx = 0
    while True:
        chunk_bytes = np.prod(chunks) * typesize
        if ((chunk_bytes < target
             or abs(chunk_bytes - target) / target < 0.5)
                and chunk_bytes < CHUNK_MAX):
            break
        if np.prod(chunks) == 1:
            break
        chunks[idx % len(shape)] = np.ceil(chunks[idx % len(shape)] / 2.0)
        idx += 1
    return tuple(int(x) for x in chunks)


def _datatype_message(dtype: np.dtype) -> bytes:
    order = 1 if dtype.byteorder == ">" or (
        dtype.byteorder == "=" and not np.little_endian) else 0
    size = dtype.itemsize
    if dtype.kind in "iu":
        bits = order | (8 if dtype.kind == "i" else 0)
        return (bytes([0x10, bits, 0, 0]) + struct.pack("<I", size)
                + struct.pack("<HH", 0, 8 * size))
    sign, eloc, esize, mloc, msize, bias = _IEEE[size]
    return (bytes([0x11, order | 0x20, sign, 0]) + struct.pack("<I", size)
            + struct.pack("<HHBBBBI", 0, 8 * size, eloc, esize, mloc, msize,
                          bias))


def _dataspace_message(shape) -> bytes:
    return (bytes([1, len(shape), 0, 0, 0, 0, 0, 0])
            + b"".join(struct.pack("<Q", n) for n in shape))


def _check_dtype(dtype: np.dtype):
    if dtype.kind not in "iuf" or (dtype.kind == "f"
                                   and dtype.itemsize not in _IEEE):
        raise TypeError(f"HDF5 writer: numeric dtypes only, not {dtype}")


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body + bytes(_pad8(len(body)) - len(body))
    if len(body) >= 1 << 16:
        raise ValueError(f"HDF5 writer: message of {len(body)} bytes")
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _attribute_message(name: str, value) -> bytes:
    value = np.asarray(value)
    _check_dtype(value.dtype)
    raw_name = name.encode("utf-8") + b"\0"
    dt = _datatype_message(value.dtype)
    ds = _dataspace_message(value.shape)
    body = (struct.pack("<BBHHH", 1, 0, len(raw_name), len(dt), len(ds))
            + raw_name + bytes(_pad8(len(raw_name)) - len(raw_name))
            + dt + bytes(_pad8(len(dt)) - len(dt))
            + ds + bytes(_pad8(len(ds)) - len(ds))
            + np.ascontiguousarray(value).tobytes())
    return _message(_ATTRIBUTE, body)


class _Attributes(dict):
    """A writer's root attributes: numeric values only, checked when set."""

    def __setitem__(self, key, value):
        value = np.asarray(value)
        _check_dtype(value.dtype)
        super().__setitem__(key, value)


class _Writer:
    """The write side of ``File``: raw data and each dataset's header as
    it is created; the root group (heap, symbol table nodes, B-tree, its
    header with the attributes) and the superblock at close."""

    def __init__(self, path: str):
        self._fh = open(path, "wb")
        self._fh.write(bytes(96))                   # the superblock
        self._pos = 96
        self._objects: Dict[str, int] = {}
        self.attrs = _Attributes()

    def _append(self, data) -> int:
        where = self._pos
        self._fh.write(data)
        self._pos += memoryview(data).nbytes
        return where

    def create_dataset(self, name: str, data, shape=None, compression=None,
                       compression_opts=None, chunks=None):
        if "/" in name.strip("/") or not name.strip("/"):
            raise NotImplementedError(
                f"HDF5 writer: datasets in the root group only ({name!r})")
        name = name.strip("/")
        if name in self._objects:
            raise ValueError(f"HDF5 writer: {name!r} exists")
        data = np.asarray(data)
        if shape is not None:
            shape = tuple(shape) if np.ndim(shape) else (int(shape),)
            if math.prod(shape) != data.size:
                raise ValueError(f"HDF5 writer: shape {shape} does not fit "
                                 f"data of shape {data.shape}")
            data = data.reshape(shape)
        _check_dtype(data.dtype)
        messages = [_message(_DATASPACE, _dataspace_message(data.shape)),
                    _message(_DATATYPE, _datatype_message(data.dtype), 1)]
        if compression is None and chunks is None:
            # fill value v2: allocation late, written if set, default
            messages.append(_message(_FILL, bytes([2, 2, 2, 1, 0, 0, 0, 0]),
                                     1))
            if data.size:
                where = self._append(np.ascontiguousarray(data).data)
            else:
                where = _undefined(8)
            messages.append(_message(_LAYOUT, struct.pack(
                "<BBQQ", 3, 1, where, data.nbytes)))
        else:
            if compression not in (None, "gzip"):
                raise NotImplementedError(
                    f"HDF5 writer: compression {compression!r}")
            if data.ndim == 0:
                raise ValueError("HDF5 writer: a scalar cannot be chunked")
            level = 4 if compression_opts is None else int(compression_opts)
            if compression and not 0 <= level <= 9:
                raise ValueError(f"HDF5 writer: gzip level {level}")
            cdims = tuple(chunks) if chunks is not None else guess_chunk(
                data.shape, data.dtype.itemsize)
            btree = self._chunked(data, cdims,
                                  level if compression else None)
            # fill value v2: allocation incremental, written if set
            messages.append(_message(_FILL, bytes([2, 3, 2, 1, 0, 0, 0, 0]),
                                     1))
            messages.append(_message(_LAYOUT, struct.pack(
                f"<BBBQ{len(cdims) + 1}I", 3, 2, len(cdims) + 1, btree,
                *cdims, data.dtype.itemsize)))
            if compression:
                messages.append(_message(_FILTERS, struct.pack(
                    "<BB6xHHHH8sI4x", 1, 1, _DEFLATE, 8, 1, 1, b"deflate",
                    level)))
        self._objects[name] = self._append(_object_header(messages))

    def _chunked(self, data: np.ndarray, cdims, level) -> int:
        """Writes the chunks (deflated at ``level`` unless None) in C
        order and their v1 B-tree; returns the tree's root address."""
        if len(cdims) != data.ndim or any(k < 1 for k in cdims):
            raise ValueError(f"HDF5 writer: chunk shape {cdims} for data of "
                             f"rank {data.ndim}")
        grid = [-(-m // k) for m, k in zip(data.shape, cdims)]
        offsets = [tuple(int(s) * k for s, k in zip(scaled, cdims))
                   for scaled in np.ndindex(*grid)]

        def encode(offset):
            sl = tuple(slice(o, o + k) for o, k in zip(offset, cdims))
            block = data[sl]
            if block.shape != tuple(cdims):
                full = np.zeros(cdims, data.dtype)
                full[tuple(slice(0, s) for s in block.shape)] = block
                block = full
            block = np.ascontiguousarray(block)
            return block.tobytes() if level is None else zlib.compress(
                memoryview(block).cast("B"), level)

        entries = []
        encoded = (raw for part in _batched(encode, offsets) for raw in part)
        for offset, raw in zip(offsets, encoded):
            entries.append((offset, len(raw), self._append(raw)))
        if not entries:
            return _undefined(8)
        return self._chunk_btree(entries, cdims)

    def _chunk_btree(self, entries, cdims) -> int:
        """A v1 B-tree (type 1) over ``[(offset, bytes, address)]``, as
        many levels as 2K children a node needs."""
        rank = len(cdims)

        def key(size, offset):
            return struct.pack(f"<II{rank + 1}Q", size, 0, *offset, 0)

        end = tuple(o + k for o, k in zip(entries[-1][0], cdims))
        # (left key, child address) per entry; the right key of the last
        # entry is one chunk past the last chunk
        level, items = 0, [(key(size, off), addr)
                           for off, size, addr in entries]
        last_key = key(0, end)
        node_size = 24 + 2 * _CHUNK_K * 8 + (2 * _CHUNK_K + 1) * len(last_key)
        while True:
            n_nodes = -(-len(items) // (2 * _CHUNK_K))
            bounds = [round(i * len(items) / n_nodes)
                      for i in range(n_nodes + 1)]
            groups = [items[a:b] for a, b in zip(bounds, bounds[1:])]
            first = self._pos
            addrs = [first + i * node_size for i in range(n_nodes)]
            undef = _undefined(8)
            for i, group in enumerate(groups):
                right = groups[i + 1][0][0] if i + 1 < n_nodes else last_key
                body = (b"TREE" + struct.pack("<BBH", 1, level, len(group))
                        + struct.pack("<QQ", addrs[i - 1] if i else undef,
                                      addrs[i + 1] if i + 1 < n_nodes
                                      else undef)
                        + b"".join(k + struct.pack("<Q", a) for k, a in group)
                        + right)
                self._append(body + bytes(node_size - len(body)))
            if n_nodes == 1:
                return addrs[0]
            items = [(group[0][0], a) for group, a in zip(groups, addrs)]
            level += 1

    def close(self):
        try:
            self._finish()
        finally:
            self._fh.close()

    def _finish(self):
        names = sorted(self._objects, key=lambda s: s.encode("utf-8"))
        per_node = 2 * _LEAF_K
        if len(names) > per_node * 2 * _GROUP_K:
            raise NotImplementedError(
                f"HDF5 writer: {len(names)} datasets in one group")
        # local heap: "" at offset 0, then each name, 8-byte aligned
        heap, offsets = bytearray(8), {}
        for name in names:
            offsets[name] = len(heap)
            raw = name.encode("utf-8") + b"\0"
            heap += raw + bytes(_pad8(len(raw)) - len(raw))
        heap_addr = self._pos
        self._append(b"HEAP" + bytes(4) + struct.pack(
            "<QQQ", len(heap), 1, heap_addr + 32) + bytes(heap))
        # symbol table nodes of 2 * leaf K entries each
        snods = []
        snod_size = 8 + per_node * 40
        for i in range(0, len(names), per_node):
            part = names[i:i + per_node]
            body = b"SNOD" + struct.pack("<BBH", 1, 0, len(part)) + b"".join(
                struct.pack("<QQII16x", offsets[n], self._objects[n], 0, 0)
                for n in part)
            snods.append((offsets[part[-1]],
                          self._append(body + bytes(snod_size - len(body)))))
        undef = _undefined(8)
        body = (b"TREE" + struct.pack("<BBH", 0, 0, len(snods))
                + struct.pack("<QQ", undef, undef) + struct.pack("<Q", 0)
                + b"".join(struct.pack("<QQ", a, k) for k, a in snods))
        btree_size = 24 + 2 * _GROUP_K * 8 + (2 * _GROUP_K + 1) * 8
        btree = self._append(body + bytes(btree_size - len(body)))
        messages = [_message(_SYMBOL_TABLE, struct.pack("<QQ", btree,
                                                        heap_addr))]
        messages += [_attribute_message(k, v) for k, v in self.attrs.items()]
        root = self._append(_object_header(messages))
        superblock = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                      + struct.pack("<HHI", _LEAF_K, _GROUP_K, 0)
                      + struct.pack("<QQQQ", 0, undef, self._pos, undef)
                      + struct.pack("<QQII", 0, root, 1, 0)
                      + struct.pack("<QQ", btree, heap_addr))
        self._fh.seek(0)
        self._fh.write(superblock)


class File:
    """An HDF5 file opened for reading (``"r"``) or writing (``"w"``,
    truncating).

    Reading: ``f[name]`` is the whole dataset ``name`` of the root group
    as a numpy array of the file's dtype (byte order included) and shape;
    ``f.attrs`` the root group's attributes (a numpy scalar for a scalar,
    else an array); ``f.keys()`` the root group's names.

    Writing: ``f.create_dataset(name, data=array, shape=None,
    compression=None | "gzip", compression_opts=level, chunks=None)``
    (``shape`` reshapes ``data``; ``chunks`` defaults to h5py's rule)
    and ``f.attrs[key] = value`` (numeric); the file is complete at
    ``close``.
    """

    def __init__(self, path: str, mode: str = "r"):
        if mode not in ("r", "w"):
            raise ValueError(f"HDF5 File: mode {mode!r} (\"r\" or \"w\")")
        self.mode = mode
        self._reader = self._writer = None
        self._attrs = None
        if mode == "r":
            self._reader = _Reader(path)
        else:
            self._writer = _Writer(path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._reader is not None:
            self._reader.close()
            self._reader = None
        if self._writer is not None:
            writer, self._writer = self._writer, None
            writer.close()

    def _need(self, what):
        obj = self._reader if what == "r" else self._writer
        if obj is None:
            raise ValueError(f"HDF5 File is closed or not opened for "
                             f"{'reading' if what == 'r' else 'writing'}")
        return obj

    @property
    def attrs(self):
        if self.mode == "w":
            return self._need("w").attrs
        if self._attrs is None:
            r = self._need("r")
            self._attrs = r.attributes(r.root_messages)
        return self._attrs

    def keys(self):
        return list(self._need("r").links)

    def __contains__(self, name: str) -> bool:
        return name.strip("/") in self._need("r").links

    def __getitem__(self, name: str) -> np.ndarray:
        r = self._need("r")
        key = name.strip("/")
        if key not in r.links:
            raise KeyError(name)
        return r.dataset(r.links[key])

    def create_dataset(self, name: str, data, shape=None, compression=None,
                       compression_opts=None, chunks=None):
        self._need("w").create_dataset(name, data, shape, compression,
                                       compression_opts, chunks)
