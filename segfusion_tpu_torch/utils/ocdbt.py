"""tensorstore's OCDBT key-value store, read and written without
tensorstore.

An OCDBT store is a directory: ``manifest.ocdbt`` and data files
``d/<hex>``. The manifest holds the store's config and its versions;
each version names the root of a B+tree whose nodes lie in data files,
and each leaf entry holds its value inline or as (data file, offset,
length). Every manifest and node starts with a header (magic,
length, format version, compression: none or one zstd frame) and ends
with the CRC-32C of all the bytes before it. Integers are LEB128
varints unless said otherwise, and each node stores its entries column
by column:

- data file table: count; path prefix lengths shared with the previous
  path; suffix lengths; base path lengths; the suffixes. A path is read
  relative to the base path of the file that holds the table, so the
  nodes that orbax's merge leaves under ``ocdbt.process_<i>/`` resolve
  their own ``d/`` files there;
- B+tree leaf (height 0): count; key prefix lengths; key suffix
  lengths; the suffixes; value lengths; value kinds (a byte, 1:
  indirect); the indirect values' data file ids and offsets; the inline
  values joined;
- B+tree interior node: count; key prefix and suffix lengths; subtree
  common prefix lengths; the suffixes; the children's data file ids,
  offsets and lengths; their key counts, tree bytes and indirect value
  bytes. A child's keys are stored without its entry's subtree common
  prefix;
- manifest: the config (16-byte uuid, manifest kind, max inline value
  bytes, max decoded node bytes, version tree arity log2 as a byte,
  compression method, a zstd level as int32 when it is 1), the data
  file table, the latest versions (generation, root height as a byte,
  the root's file, offset and length, its key count, tree bytes and
  indirect value bytes, the commit time as uint64) and references to
  version tree nodes (generation, file, offset, length, generations,
  commit time, height as a byte). A root that is absent (an empty
  store) has offset and length 2**64 - 1.

:func:`open_store` reads the latest version of a store into a
:class:`Store`; :func:`write_store` writes one manifest with one
version whose B+tree of uncompressed nodes lies in one data file, the
values above orbax's 1,024 bytes in that file too, with orbax's config,
so that tensorstore opens, lists and reads it.
"""

from __future__ import annotations

import os
import posixpath
import struct
import time
import uuid as uuid_mod
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Union

from . import zstd

__all__ = ["Store", "open_store", "write_store", "MANIFEST_MAGIC",
           "NODE_MAGIC", "VERSION_NODE_MAGIC"]

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
VERSION_NODE_MAGIC = 0x0CDB1234
_MISSING = 2 ** 64 - 1
# orbax's config (orbax.checkpoint's ocdbt options)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
# entries a written node holds at most
NODE_ENTRIES = 256


# -- reading ------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def varint(self) -> int:
        v = shift = 0
        data = self.data
        while True:
            if self.pos >= len(data) or shift > 63:
                raise ValueError("ocdbt: truncated or overlong varint")
            b = data[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError("ocdbt: truncated")
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("ocdbt: truncated")
        self.pos += n
        return self.data[self.pos - n:self.pos]


@dataclass(frozen=True)
class _File:
    """A data file: its path from the store's root and the base path its
    own tables' paths are relative to."""
    base: str
    path: str


@dataclass(frozen=True)
class _Ref:
    file: _File
    offset: int
    length: int


def _body(data: bytes, magic: int, what: str) -> bytes:
    """Checks the header and checksum of a manifest or node; returns the
    (decompressed) body."""
    if len(data) < 18:
        raise ValueError(f"ocdbt: {what} of {len(data)} bytes is truncated")
    got, length = struct.unpack_from(">I", data)[0], struct.unpack_from(
        "<Q", data, 4)[0]
    if got != magic:
        raise ValueError(f"ocdbt: {what} has magic 0x{got:08x}, expected "
                         f"0x{magic:08x}")
    if length != len(data):
        raise ValueError(f"ocdbt: {what} says {length} bytes, has "
                         f"{len(data)}")
    want = struct.unpack_from("<I", data, len(data) - 4)[0]
    if zstd.crc32c(memoryview(data)[:-4]) != want:
        raise ValueError(f"ocdbt: {what} fails its CRC-32C")
    r = _Reader(data, 12)
    version = r.varint()
    if version != 0:
        raise ValueError(f"ocdbt: {what} format version {version}")
    comp = r.varint()
    body = data[r.pos:-4]
    if comp == 1:
        return bytes(zstd.decompress(body))
    if comp != 0:
        raise ValueError(f"ocdbt: {what} compression format {comp}")
    return body


def _file_table(r: _Reader, base: str) -> List[_File]:
    n = r.varint()
    if n == 0:
        return []
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError("ocdbt: corrupt data file table")
        path = prev[:prefix[i]] + r.take(suffix[i])
        if base_len[i] > len(path):
            raise ValueError("ocdbt: corrupt data file table")
        full = base + path.decode()
        norm = posixpath.normpath(full)
        if full.startswith("/") or norm == ".." or norm.startswith("../"):
            raise ValueError(f"ocdbt: data file path {full!r} leaves the "
                             f"store's directory")
        files.append(_File(base + path[:base_len[i]].decode(), full))
        prev = path
    return files


def _file_of(files: List[_File], i: int) -> _File:
    if i >= len(files):
        raise ValueError(f"ocdbt: data file id {i} of {len(files)}")
    return files[i]


def _keys(r: _Reader, n: int, interior: bool):
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    common = r.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError("ocdbt: corrupt key prefix")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        keys.append(prev)
    return keys, common


@dataclass
class Config:
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: int
    zstd_level: int = 0


def _config(r: _Reader) -> Config:
    c = Config(r.take(16), r.varint(), r.varint(), r.varint(), r.byte(),
               r.varint())
    if c.compression == 1:
        c.zstd_level = struct.unpack("<i", r.take(4))[0]
    elif c.compression != 0:
        raise ValueError(f"ocdbt: compression method {c.compression}")
    return c


@dataclass
class Version:
    generation: int
    root: Optional[_Ref]
    height: int
    num_keys: int
    commit_time: int


def _versions(r: _Reader, files: List[_File]) -> List[Version]:
    n = r.varint()
    gen = r.varints(n)
    height = [r.byte() for _ in range(n)]
    fid, off, length = r.varints(n), r.varints(n), r.varints(n)
    keys = r.varints(n)
    r.varints(n)                                  # tree bytes
    r.varints(n)                                  # indirect value bytes
    t = [struct.unpack("<Q", r.take(8))[0] for _ in range(n)]
    return [Version(gen[i], None if off[i] == _MISSING else
                    _Ref(_file_of(files, fid[i]), off[i], length[i]),
                    height[i], keys[i], t[i]) for i in range(n)]


def _version_refs(r: _Reader, files: List[_File], with_height: bool,
                  height: int = 0):
    n = r.varint()
    gen = r.varints(n)
    fid, off, length = r.varints(n), r.varints(n), r.varints(n)
    r.varints(n)                                  # generations
    [r.take(8) for _ in range(n)]                 # commit times
    heights = ([r.byte() for _ in range(n)] if with_height
               else [height - 1] * n)
    return [(gen[i], _Ref(_file_of(files, fid[i]), off[i], length[i]),
             heights[i]) for i in range(n)]


class Store:
    """The latest version of an OCDBT store: its keys in order, each
    value read on demand from the node (inline) or its data file."""

    def __init__(self, root: str):
        self.root = root
        self._values: Dict[bytes, Union[bytes, _Ref]] = {}
        self._files: Dict[str, bytes] = {}
        with open(os.path.join(root, "manifest.ocdbt"), "rb") as f:
            data = f.read()
        r = _Reader(_body(data, MANIFEST_MAGIC, "manifest"))
        self.config = _config(r)
        if self.config.manifest_kind != 0:
            raise NotImplementedError("ocdbt: numbered manifests")
        files = _file_table(r, "")
        self.versions = _versions(r, files)
        self._version_nodes = _version_refs(r, files, True)
        if r.pos != len(r.data):
            raise ValueError("ocdbt: bytes after the manifest")
        if not self.versions:
            raise ValueError("ocdbt: manifest holds no version")
        self.version = max(self.versions, key=lambda v: v.generation)
        if self.version.root is not None:
            self._walk(self.version.root, self.version.height, b"")
        if len(self._values) != self.version.num_keys:
            raise ValueError(f"ocdbt: {len(self._values)} keys where the "
                             f"version says {self.version.num_keys}")

    def _read(self, ref: _Ref) -> bytes:
        path = os.path.join(self.root, ref.file.path)
        with open(path, "rb") as f:
            f.seek(ref.offset)
            data = f.read(ref.length)
        if len(data) != ref.length:
            raise ValueError(f"ocdbt: {ref.file.path} is truncated")
        return data

    def _walk(self, ref: _Ref, height: int, prefix: bytes):
        r = _Reader(_body(self._read(ref), NODE_MAGIC, "b-tree node"))
        if r.byte() != height:
            raise ValueError("ocdbt: node height differs from its parent's")
        files = _file_table(r, ref.file.base)
        n = r.varint()
        if n == 0:
            raise ValueError("ocdbt: empty b-tree node")
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            fid, off, length = r.varints(n), r.varints(n), r.varints(n)
            for _ in range(3):                       # the subtree statistics
                r.varints(n)
            for i in range(n):
                if common[i] > len(keys[i]):
                    raise ValueError("ocdbt: corrupt subtree prefix")
                self._walk(_Ref(_file_of(files, fid[i]), off[i], length[i]),
                           height - 1, prefix + keys[i][:common[i]])
        else:
            length = r.varints(n)
            kind = list(r.take(n))
            indirect = [i for i in range(n) if kind[i] == 1]
            if any(k > 1 for k in kind):
                raise ValueError("ocdbt: unknown value kind")
            fid = r.varints(len(indirect))
            off = r.varints(len(indirect))
            for j, i in enumerate(indirect):
                self._values[prefix + keys[i]] = _Ref(
                    _file_of(files, fid[j]), off[j], length[i])
            for i in range(n):
                if kind[i] == 0:
                    self._values[prefix + keys[i]] = r.take(length[i])
        if r.pos != len(r.data):
            raise ValueError("ocdbt: bytes after the b-tree node")

    def generations(self) -> List[int]:
        """Every generation the version tree holds, oldest first."""
        out = [v.generation for v in self.versions]
        stack = list(self._version_nodes)
        while stack:
            _, ref, height = stack.pop()
            r = _Reader(_body(self._read(ref), VERSION_NODE_MAGIC,
                              "version tree node"))
            r.byte()                                # arity log2
            if r.byte() != height:
                raise ValueError("ocdbt: version node height differs")
            files = _file_table(r, ref.file.base)
            if height == 0:
                out += [v.generation for v in _versions(r, files)]
            else:
                stack += _version_refs(r, files, False, height)
        return sorted(out)

    def keys(self) -> List[bytes]:
        return sorted(self._values)

    def __contains__(self, key: bytes) -> bool:
        return key in self._values

    def __len__(self) -> int:
        return len(self._values)

    def read(self, key: bytes) -> bytes:
        """The value of ``key`` (KeyError where the store lacks it)."""
        v = self._values[key]
        return v if isinstance(v, bytes) else self._read(v)


def open_store(root: str) -> Store:
    """The store whose manifest is ``root/manifest.ocdbt``."""
    if not os.path.exists(os.path.join(root, "manifest.ocdbt")):
        raise FileNotFoundError(f"no OCDBT manifest under {root}")
    return Store(root)


# -- writing ------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(vs: Iterable[int]) -> bytes:
    return b"".join(_varint(v) for v in vs)


def _framed(magic: int, body: bytes) -> bytes:
    """Header (uncompressed) + body + CRC-32C."""
    head = struct.pack(">I", magic)
    rest = _varint(0) + _varint(0)
    length = len(head) + 8 + len(rest) + len(body) + 4
    data = head + struct.pack("<Q", length) + rest + body
    return data + struct.pack("<I", zstd.crc32c(data))


def _table_bytes(paths: List[str]) -> bytes:
    if not paths:
        return _varint(0)
    enc = [p.encode() for p in paths]
    prefix = []
    for a, b in zip(enc, enc[1:]):
        k = 0
        while k < min(len(a), len(b)) and a[k] == b[k]:
            k += 1
        prefix.append(k)
    pre = [0] + prefix
    return (_varint(len(enc)) + _varints(prefix)
            + _varints(len(e) - p for e, p in zip(enc, pre))
            + _varints(0 for _ in enc)
            + b"".join(e[p:] for e, p in zip(enc, pre)))


def _key_columns(keys: List[bytes]):
    prefix = []
    for a, b in zip(keys, keys[1:]):
        k = 0
        while k < min(len(a), len(b)) and a[k] == b[k]:
            k += 1
        prefix.append(k)
    pre = [0] + prefix
    return (_varints(prefix), _varints(len(k) - p for k, p in zip(keys, pre)),
            b"".join(k[p:] for k, p in zip(keys, pre)))


def write_store(root: str, items: Dict[bytes, bytes]):
    """Write ``items`` (key -> value, bytes-like) as a new OCDBT store at
    ``root``: ``manifest.ocdbt`` and one data file ``d/<hex>`` that holds
    the values above ``MAX_INLINE_VALUE_BYTES`` and then the nodes."""
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    name = "d/" + uuid_mod.uuid4().hex
    keys = sorted(items)
    with open(os.path.join(root, name), "wb") as f:
        offsets: Dict[bytes, int] = {}
        pos = 0
        for k in keys:
            v = memoryview(items[k]).cast("B")
            if len(v) > MAX_INLINE_VALUE_BYTES:
                offsets[k] = pos
                f.write(v)
                pos += len(v)
        table = _table_bytes([name])
        # leaves: (first key, offset, length, keys, tree bytes, indirect)
        level = []
        for s in range(0, len(keys), NODE_ENTRIES):
            part = keys[s:s + NODE_ENTRIES]
            pre, suf, sb = _key_columns(part)
            lengths = [len(memoryview(items[k]).cast("B")) for k in part]
            kinds = bytes(int(k in offsets) for k in part)
            ind = [k for k in part if k in offsets]
            body = (b"\x00" + table + _varint(len(part)) + pre + suf + sb
                    + _varints(lengths) + kinds + _varints(0 for _ in ind)
                    + _varints(offsets[k] for k in ind)
                    + b"".join(bytes(memoryview(items[k]).cast("B"))
                               for k in part if k not in offsets))
            node = _framed(NODE_MAGIC, body)
            f.write(node)
            level.append((part[0], pos, len(node), len(part), len(node),
                          sum(lengths[i] for i, k in enumerate(part)
                              if k in offsets)))
            pos += len(node)
        height = 0
        while len(level) > 1:
            height += 1
            up = []
            for s in range(0, len(level), NODE_ENTRIES):
                part = level[s:s + NODE_ENTRIES]
                pre, suf, sb = _key_columns([e[0] for e in part])
                body = (bytes([height]) + table + _varint(len(part)) + pre
                        + suf + _varints(0 for _ in part) + sb
                        + _varints(0 for _ in part)
                        + b"".join(_varints(e[i] for e in part)
                                   for i in (1, 2, 3, 4, 5)))
                node = _framed(NODE_MAGIC, body)
                f.write(node)
                up.append((part[0][0], pos, len(node),
                           sum(e[3] for e in part),
                           len(node) + sum(e[4] for e in part),
                           sum(e[5] for e in part)))
                pos += len(node)
            level = up
    config = (uuid_mod.uuid4().bytes + _varint(0)
              + _varint(MAX_INLINE_VALUE_BYTES)
              + _varint(MAX_DECODED_NODE_BYTES)
              + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(1)
              + struct.pack("<i", 0))
    if level:
        _, off, length, nkeys, tree, ind = level[0]
        version = (_varint(1) + _varint(1) + bytes([height]) + _varint(0)
                   + _varint(off) + _varint(length) + _varint(nkeys)
                   + _varint(tree) + _varint(ind))
        files = _table_bytes([name])
    else:                                    # an empty tree: no root
        version = (_varint(1) + _varint(1) + b"\x00" + _varint(0)
                   + _varint(_MISSING) + _varint(_MISSING) + _varint(0)
                   + _varint(0) + _varint(0))
        files = _table_bytes([""])
        os.remove(os.path.join(root, name))
    version += struct.pack("<Q", time.time_ns())
    manifest = _framed(MANIFEST_MAGIC, config + files + version + _varint(0))
    tmp = os.path.join(root, f"manifest.ocdbt.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        f.write(manifest)
    os.replace(tmp, os.path.join(root, "manifest.ocdbt"))
