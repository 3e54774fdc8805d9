"""Zstandard frames (RFC 8878) read and written without a zstd library.

orbax's checkpoints hold every zarr chunk, and tensorstore's OCDBT store
every node and manifest, as zstd frames. The decoder takes all that the
format allows without a dictionary: raw, RLE and compressed blocks;
literals raw, RLE, Huffman-coded (one or four streams) and treeless;
sequences whose three codes each come predefined, as RLE, FSE-compressed
or repeated from the block before; repeat offsets; a window descriptor
or a single segment; a content size given or absent; several frames in
a row and skippable frames between them; the XXH64 content checksum,
checked where a frame carries it. A frame that names a dictionary
raises ``ValueError``, as does any malformed input.

The decoder is C++, ``csrc/zstd.cpp``, built with g++ at first use into
``build/segfusion_tpu_torch/`` (``ops/kernels/_build.py``) and called
through ctypes; the same library computes the CRC-32C that OCDBT's
nodes carry and XXH64. :func:`decompress_plain`, :func:`crc32c_plain`
and :func:`xxh64_plain` are the plain Python versions of the same
functions, which the tests hold the library to.

The encoder, :func:`compress`, writes one frame of raw and RLE blocks
(no entropy coding) with the content size and the checksum: any zstd
decoder reads it.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import List, Optional

import numpy as np

from ..ops.kernels import _build

__all__ = ["compress", "decompress", "decompress_plain", "crc32c",
           "crc32c_plain", "xxh64", "xxh64_plain", "ZSTD_SOURCE",
           "MAGIC"]

ZSTD_SOURCE = _build.CSRC / "zstd.cpp"
MAGIC = 0xFD2FB528
_SKIPPABLE = 0x184D2A50            # ... 0x184D2A5F: the low 4 bits are free
_BLOCK_MAX = 128 * 1024

_ERR_BYTES = 256


@functools.lru_cache(maxsize=None)
def _lib():
    lib, _ = _build.load_host_library(ZSTD_SOURCE)
    lib.zstd_decompress_into.restype = ctypes.c_int64
    lib.zstd_decompress_into.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64]
    lib.zstd_decompress_alloc.restype = ctypes.c_int64
    lib.zstd_decompress_alloc.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_char_p, ctypes.c_int64]
    lib.zstd_free.restype = None
    lib.zstd_free.argtypes = [ctypes.c_void_p]
    lib.crc32c.restype = ctypes.c_uint32
    lib.crc32c.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int64]
    lib.xxh64.restype = ctypes.c_uint64
    lib.xxh64.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64]
    return lib


def _view(data) -> np.ndarray:
    """A uint8 view of a bytes-like object (no copy)."""
    return np.frombuffer(memoryview(data).cast("B"), np.uint8)


def _addr(arr: np.ndarray):
    """The address of a uint8 array's first byte (None when empty)."""
    return arr.__array_interface__["data"][0] if arr.size else None


# -- the library's functions ------------------------------------------------

def decompress(data, size: Optional[int] = None) -> bytearray:
    """Every frame of ``data`` decoded and joined, through the C++ library.
    Where the caller knows the decoded size it passes ``size`` and the
    frames are decoded straight into the result (a different size
    raises)."""
    src = _view(data)
    err = ctypes.create_string_buffer(_ERR_BYTES)
    lib = _lib()
    if size is not None:
        out = bytearray(size)
        n = lib.zstd_decompress_into(_addr(src), src.size,
                                     _addr(np.frombuffer(out, np.uint8)),
                                     size, err, _ERR_BYTES)
        if n < 0:
            raise ValueError(f"zstd: {err.value.decode()}")
        if n != size:
            raise ValueError(f"zstd: {n} bytes decoded where {size} were "
                             f"expected")
        return out
    buf = ctypes.c_void_p()
    n = lib.zstd_decompress_alloc(_addr(src), src.size, ctypes.byref(buf),
                                  err, _ERR_BYTES)
    try:
        if n < 0:
            raise ValueError(f"zstd: {err.value.decode()}")
        out = bytearray(n)
        if n:
            ctypes.memmove(_addr(np.frombuffer(out, np.uint8)), buf, n)
    finally:
        lib.zstd_free(buf)
    return out


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    src = _view(data)
    return int(_lib().crc32c(crc, _addr(src), src.size))


def xxh64(data, seed: int = 0) -> int:
    src = _view(data)
    return int(_lib().xxh64(_addr(src), src.size, seed))


# -- the encoder ------------------------------------------------------------

def _rle_blocks(src: np.ndarray, starts: List[int]) -> List[bool]:
    """Which blocks are one repeated byte (a sample of each first)."""
    out = []
    for s in starts:
        block = src[s:s + _BLOCK_MAX]
        out.append(block.size > 1 and bool((block[:64] == block[0]).all())
                   and bool((block == block[0]).all()))
    return out


def compress(data) -> bytearray:
    """One zstd frame of ``data``: single segment, the content size, raw
    blocks of up to 128 KiB (RLE where a block is one repeated byte) and
    the XXH64 checksum."""
    src = _view(data)
    n = src.size
    # Frame_Header_Descriptor: FCS field size, Single_Segment, checksum
    if n < 256:
        fcs_flag, fcs = 0, struct.pack("<B", n)
    elif n < 65536 + 256:
        fcs_flag, fcs = 1, struct.pack("<H", n - 256)
    elif n < 2 ** 32:
        fcs_flag, fcs = 2, struct.pack("<I", n)
    else:
        fcs_flag, fcs = 3, struct.pack("<Q", n)
    head = struct.pack("<IB", MAGIC, fcs_flag << 6 | 1 << 5 | 1 << 2) + fcs
    starts = list(range(0, n, _BLOCK_MAX)) or [0]
    rle = _rle_blocks(src, starts)
    sizes = [min(_BLOCK_MAX, n - s) for s in starts]
    total = len(head) + sum(3 + (1 if r else k)
                            for r, k in zip(rle, sizes)) + 4
    out = bytearray(total)
    view = np.frombuffer(out, np.uint8)
    view[:len(head)] = np.frombuffer(head, np.uint8)
    pos = len(head)
    for i, (s, k, r) in enumerate(zip(starts, sizes, rle)):
        last = int(i == len(starts) - 1)
        out[pos:pos + 3] = (last | int(r) << 1 | k << 3).to_bytes(3, "little")
        pos += 3
        stored = 1 if r else k
        view[pos:pos + stored] = src[s:s + stored]
        pos += stored
    out[pos:] = struct.pack("<I", xxh64(src) & 0xFFFFFFFF)
    return out


# -- the plain versions -----------------------------------------------------

_CRC32C_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC32C_TABLE.append(_c)


def crc32c_plain(data, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    table = _CRC32C_TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_M64 = (1 << 64) - 1
_P1, _P2 = 11400714785074694791, 14029467366897019727
_P3, _P4 = 1609587929392839161, 9650029242287828579
_P5 = 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64_plain(data, seed: int = 0) -> int:
    b = bytes(data)
    n, i = len(b), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        lanes = struct.unpack_from(f"<{(n // 32) * 4}Q", b)
        for j in range(0, len(lanes), 4):
            v = [_round(v[k], lanes[j + k]) for k in range(4)]
        i = (n // 32) * 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M64
        for k in range(4):
            h = ((h ^ _round(0, v[k])) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, struct.unpack_from("<Q", b, i)[0])
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= struct.unpack_from("<I", b, i)[0] * _P1 & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= b[i] * _P5 & _M64
        h = _rotl(h, 11) * _P1 & _M64
        i += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


# literal length and match length codes: (baseline, extra bits)
_LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
_ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16)]
# the predefined distributions (RFC 8878 3.1.1.3.2.2)
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
                2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1], 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, -1, -1, -1, -1, -1], 5)
_MAX_SYMBOL = {"ll": 35, "of": 31, "ml": 52}
_MAX_LOG = {"ll": 9, "of": 8, "ml": 9}


class _Backward:
    """A backward bit stream: the bytes as one little-endian integer, read
    from the bit under the final byte's highest set bit down to bit 0;
    bits below 0 read as zeros."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ValueError("zstd: bit stream lacks its end marker")
        self.data = bytes(data)
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        top = self.pos
        self.pos = low = top - n
        if low >= 0:
            x = int.from_bytes(self.data[low >> 3:(top + 7) >> 3], "little")
            return (x >> (low & 7)) & ((1 << n) - 1)
        if top <= 0:
            return 0
        x = int.from_bytes(self.data[:(top + 7) >> 3], "little")
        return (x << -low) & ((1 << n) - 1)


def _fse_table(probs, log):
    """Decoding table of a normalised distribution: per state the
    symbol, the bits to read and the baseline of the next state."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    nxt = [0] * len(probs)
    for s, p in enumerate(probs):
        if p == -1:
            symbol[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = p
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, p in enumerate(probs):
        for _ in range(max(p, 0)):
            symbol[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ValueError("zstd: FSE distribution does not fill its table")
    nbits, base = [0] * size, [0] * size
    for u in range(size):
        s = symbol[u]
        n = nxt[s]
        nxt[s] += 1
        nbits[u] = log - (n.bit_length() - 1)
        base[u] = (n << nbits[u]) - size
    return symbol, nbits, base, log


def _fse_description(data: bytes, pos: int, end: int, max_symbol: int,
                     max_log: int):
    """An FSE table description (RFC 8878 4.1.1) at ``data[pos:end]``:
    (table, bytes read)."""
    end = min(end, pos + 512)       # a description takes at most ~230 bytes
    x = int.from_bytes(data[pos:end], "little")
    limit = 8 * (end - pos)
    log = (x & 15) + 5
    if log > max_log:
        raise ValueError(f"zstd: FSE accuracy log {log} above {max_log}")
    bit = 4
    remaining = (1 << log) + 1
    threshold = 1 << log
    nb = log + 1
    probs: List[int] = []
    while remaining > 1:
        if len(probs) > max_symbol:
            raise ValueError("zstd: FSE description has too many symbols")
        mx = 2 * threshold - 1 - remaining
        low = (x >> bit) & (threshold - 1)
        if low < mx:
            count = low
            bit += nb - 1
        else:
            count = (x >> bit) & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            bit += nb
        count -= 1
        remaining -= -count if count < 0 else count
        probs.append(count)
        if count == 0:
            while True:
                rep = (x >> bit) & 3
                bit += 2
                probs += [0] * rep
                if rep != 3:
                    break
        while remaining < threshold:
            nb -= 1
            threshold >>= 1
        if bit > limit:
            raise ValueError("zstd: truncated FSE description")
    if remaining != 1 or len(probs) > max_symbol + 1:
        raise ValueError("zstd: corrupt FSE description")
    return _fse_table(probs, log), (bit + 7) // 8


def _huffman_weights(data: bytes, pos: int, end: int):
    """The Huffman tree description at ``data[pos:]``: (weights of the
    symbols listed, bytes read)."""
    if pos >= end:
        raise ValueError("zstd: truncated Huffman tree description")
    head = data[pos]
    if head >= 128:
        n = head - 127
        size = (n + 1) // 2
        if pos + 1 + size > end:
            raise ValueError("zstd: truncated Huffman weights")
        raw = data[pos + 1:pos + 1 + size]
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return weights[:n], 1 + size
    if pos + 1 + head > end:
        raise ValueError("zstd: truncated Huffman weights")
    (symbol, nbits, base, log), used = _fse_description(
        data, pos + 1, pos + 1 + head, 255, 6)
    bits = _Backward(data[pos + 1 + used:pos + 1 + head])
    s1, s2 = bits.read(log), bits.read(log)
    weights = []
    while True:
        if len(weights) > 254:
            raise ValueError("zstd: too many Huffman weights")
        weights.append(symbol[s1])
        s1 = base[s1] + bits.read(nbits[s1])
        if bits.pos < 0:
            weights.append(symbol[s2])
            break
        weights.append(symbol[s2])
        s2 = base[s2] + bits.read(nbits[s2])
        if bits.pos < 0:
            weights.append(symbol[s1])
            break
    return weights, 1 + head


def _huffman_table(weights):
    """(symbol, bits) per peek of max_bits bits, and max_bits."""
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ValueError("zstd: empty Huffman tree")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise ValueError("zstd: Huffman weights do not complete a tree")
    weights = list(weights) + [rest.bit_length()]
    if max_bits > 11:
        raise ValueError(f"zstd: Huffman code of {max_bits} bits")
    size = 1 << max_bits
    sym = np.zeros(size, np.int64)
    nb = np.zeros(size, np.int64)
    pos = 0
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                n = 1 << (w - 1)
                sym[pos:pos + n] = s
                nb[pos:pos + n] = max_bits + 1 - w
                pos += n
    return sym, nb, max_bits


def _huffman_stream(data: bytes, table, n: int) -> bytes:
    """``n`` symbols of one backward Huffman stream. Every bit position's
    peek is looked up at once; the walk from the top then only follows
    positions."""
    sym, nb, max_bits = table
    if not data or data[-1] == 0:
        raise ValueError("zstd: Huffman stream lacks its end marker")
    top = 8 * (len(data) - 1) + data[-1].bit_length() - 1
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    bits = np.concatenate([np.zeros(max_bits, np.uint8), bits[:top]])
    # peek[p]: the max_bits bits below position p (bit p-1 the highest)
    peek = np.zeros(top + 1, np.int64)
    for k in range(max_bits):
        peek |= bits[max_bits - 1 - k:max_bits - 1 - k + top + 1].astype(
            np.int64) << (max_bits - 1 - k)
    s_at = sym[peek].tolist()
    n_at = nb[peek].tolist()
    out = bytearray(n)
    p = top
    for i in range(n):
        if p < 0:
            raise ValueError("zstd: Huffman stream overrun")
        out[i] = s_at[p]
        p -= n_at[p]
    if p != 0:
        raise ValueError("zstd: Huffman stream not consumed exactly")
    return bytes(out)


class _FrameState:
    def __init__(self):
        self.huffman = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.rep = [1, 4, 8]


def _literals(data: bytes, pos: int, end: int, st: _FrameState):
    """The literals section at ``data[pos:end]``: (literals, new pos)."""
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):                               # raw, RLE
        if fmt in (0, 2):
            size, head = b0 >> 3, 1
        elif fmt == 1:
            size, head = (b0 >> 4) + (data[pos + 1] << 4), 2
        else:
            size = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12)
            head = 3
        pos += head
        if kind == 0:
            if pos + size > end:
                raise ValueError("zstd: truncated raw literals")
            return data[pos:pos + size], pos + size
        if pos >= end:
            raise ValueError("zstd: truncated RLE literals")
        return bytes([data[pos]]) * size, pos + 1
    head, bits = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
    if pos + head > end:
        raise ValueError("zstd: truncated literals header")
    h = int.from_bytes(data[pos:pos + head], "little")
    mask = (1 << bits) - 1
    regen, comp = (h >> 4) & mask, (h >> (4 + bits)) & mask
    streams = 1 if fmt == 0 else 4
    pos += head
    if pos + comp > end:
        raise ValueError("zstd: truncated compressed literals")
    stop = pos + comp
    if kind == 2:
        weights, used = _huffman_weights(data, pos, stop)
        st.huffman = _huffman_table(weights)
        pos += used
    elif st.huffman is None:
        raise ValueError("zstd: treeless literals without a previous tree")
    if streams == 1:
        return _huffman_stream(data[pos:stop], st.huffman, regen), stop
    if pos + 6 > stop:
        raise ValueError("zstd: truncated jump table")
    s1, s2, s3 = struct.unpack_from("<HHH", data, pos)
    pos += 6
    bounds = [pos, pos + s1, pos + s1 + s2, pos + s1 + s2 + s3, stop]
    if bounds[3] > stop:
        raise ValueError("zstd: corrupt jump table")
    q = (regen + 3) // 4
    sizes = [q, q, q, regen - 3 * q]
    if sizes[3] < 0:
        raise ValueError("zstd: corrupt literals size")
    out = b"".join(_huffman_stream(data[bounds[i]:bounds[i + 1]],
                                   st.huffman, sizes[i]) for i in range(4))
    return out, stop


def _seq_table(mode: int, name: str, data: bytes, pos: int, end: int,
               st: _FrameState):
    if mode == 0:
        probs, log = {"ll": _LL_DEFAULT, "of": _OF_DEFAULT,
                      "ml": _ML_DEFAULT}[name]
        table = _fse_table(probs, log)
    elif mode == 1:
        if pos >= end:
            raise ValueError("zstd: truncated RLE sequence code")
        s = data[pos]
        if s > _MAX_SYMBOL[name]:
            raise ValueError(f"zstd: {name} code {s} out of range")
        table = ([s], [0], [0], 0)
        pos += 1
    elif mode == 2:
        table, used = _fse_description(data, pos, end, _MAX_SYMBOL[name],
                                       _MAX_LOG[name])
        pos += used
    else:
        table = st.tables[name]
        if table is None:
            raise ValueError("zstd: repeat mode without a previous table")
    st.tables[name] = table
    return table, pos


def _block(data: bytes, pos: int, end: int, st: _FrameState,
           out: bytearray):
    lits, pos = _literals(data, pos, end, st)
    if pos >= end:
        raise ValueError("zstd: block lacks its sequences section")
    b0 = data[pos]
    if b0 == 0:
        nseq, pos = 0, pos + 1
    elif b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if nseq == 0:
        if pos != end:
            raise ValueError("zstd: bytes after an empty sequences section")
        out += lits
        return
    modes = data[pos]
    if modes & 3:
        raise ValueError("zstd: reserved bits set in the sequence modes")
    pos += 1
    ll, pos = _seq_table(modes >> 6, "ll", data, pos, end, st)
    of, pos = _seq_table((modes >> 4) & 3, "of", data, pos, end, st)
    ml, pos = _seq_table((modes >> 2) & 3, "ml", data, pos, end, st)
    bits = _Backward(data[pos:end])
    read = bits.read
    ll_sym, ll_nb, ll_base, ll_log = ll
    of_sym, of_nb, of_base, of_log = of
    ml_sym, ml_nb, ml_base, ml_log = ml
    s_ll, s_of, s_ml = read(ll_log), read(of_log), read(ml_log)
    rep = st.rep
    lit = 0
    for i in range(nseq):
        ofc = of_sym[s_of]
        if ofc > 31:
            raise ValueError(f"zstd: offset code {ofc}")
        ofv = (1 << ofc) + read(ofc)
        mlb, mln = _ML_CODES[ml_sym[s_ml]]
        mlen = mlb + read(mln)
        llb, lln = _LL_CODES[ll_sym[s_ll]]
        llen = llb + read(lln)
        if ofv > 3:
            offset = ofv - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], offset
        else:
            idx = ofv - 1 + (llen == 0)
            if idx == 0:
                offset = rep[0]
            elif idx == 1:
                offset = rep[1]
                rep[1], rep[0] = rep[0], offset
            else:
                offset = rep[idx] if idx == 2 else rep[0] - 1
                if offset == 0:
                    raise ValueError("zstd: repeat offset of 0")
                rep[2], rep[1], rep[0] = rep[1], rep[0], offset
        if lit + llen > len(lits):
            raise ValueError("zstd: sequence overruns the literals")
        out += lits[lit:lit + llen]
        lit += llen
        if offset > len(out):
            raise ValueError("zstd: match offset before the frame start")
        start = len(out) - offset
        if offset >= mlen:
            out += out[start:start + mlen]
        else:
            chunk = out[start:]
            reps, rem = divmod(mlen, offset)
            out += chunk * reps + chunk[:rem]
        if i != nseq - 1:
            s_ll = ll_base[s_ll] + read(ll_nb[s_ll])
            s_ml = ml_base[s_ml] + read(ml_nb[s_ml])
            s_of = of_base[s_of] + read(of_nb[s_of])
    if bits.pos != 0:
        raise ValueError("zstd: sequence bit stream not consumed exactly")
    out += lits[lit:]


def _frame(data: bytes, pos: int, out: bytearray) -> int:
    """Decode the frame at ``data[pos:]`` (after its magic) onto ``out``;
    returns the position after it."""
    start = len(out)
    if pos >= len(data):
        raise ValueError("zstd: truncated frame header")
    fhd = data[pos]
    pos += 1
    if fhd & 8:
        raise ValueError("zstd: reserved bit set in the frame header")
    single = fhd >> 5 & 1
    if not single:
        pos += 1                                     # window descriptor
    did_size = (0, 1, 2, 4)[fhd & 3]
    did = int.from_bytes(data[pos:pos + did_size], "little")
    pos += did_size
    if did:
        raise ValueError(f"zstd: frame needs dictionary {did}; "
                         "dictionaries are not supported")
    fcs_size = (single, 2, 4, 8)[fhd >> 6]
    content = None
    if fcs_size:
        if pos + fcs_size > len(data):
            raise ValueError("zstd: truncated frame header")
        content = int.from_bytes(data[pos:pos + fcs_size], "little")
        content += 256 if fcs_size == 2 else 0
        pos += fcs_size
    st = _FrameState()
    while True:
        if pos + 3 > len(data):
            raise ValueError("zstd: truncated block header")
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 0:
            if pos + size > len(data):
                raise ValueError("zstd: truncated raw block")
            out += data[pos:pos + size]
            pos += size
        elif kind == 1:
            if pos >= len(data):
                raise ValueError("zstd: truncated RLE block")
            out += bytes([data[pos]]) * size
            pos += 1
        elif kind == 2:
            if pos + size > len(data) or size == 0:
                raise ValueError("zstd: truncated compressed block")
            _block(data, pos, pos + size, st, out)
            pos += size
        else:
            raise ValueError("zstd: reserved block type")
        if last:
            break
    if content is not None and len(out) - start != content:
        raise ValueError(f"zstd: frame decoded to {len(out) - start} bytes, "
                         f"its header says {content}")
    if fhd & 4:
        if pos + 4 > len(data):
            raise ValueError("zstd: truncated checksum")
        want = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        if xxh64_plain(out[start:]) & 0xFFFFFFFF != want:
            raise ValueError("zstd: content checksum mismatch")
    return pos


def decompress_plain(data) -> bytes:
    """Every frame of ``data`` decoded and joined, in Python (the plain
    version of :func:`decompress`)."""
    data = bytes(data)
    out = bytearray()
    pos = 0
    try:
        while pos < len(data):
            pos = _next_frame(data, pos, out)
    except IndexError as e:                 # a length field past the end
        raise ValueError("zstd: truncated or corrupt input") from e
    return bytes(out)


def _next_frame(data: bytes, pos: int, out: bytearray) -> int:
    """Decode the frame or skip the skippable frame at ``data[pos:]``."""
    if pos + 4 > len(data):
        raise ValueError("zstd: truncated frame magic")
    magic = struct.unpack_from("<I", data, pos)[0]
    pos += 4
    if magic & 0xFFFFFFF0 == _SKIPPABLE:
        if pos + 4 > len(data):
            raise ValueError("zstd: truncated skippable frame")
        pos += 4 + struct.unpack_from("<I", data, pos)[0]
        if pos > len(data):
            raise ValueError("zstd: truncated skippable frame")
    elif magic == MAGIC:
        pos = _frame(data, pos, out)
    else:
        raise ValueError(f"zstd: unknown frame magic 0x{magic:08x}")
    return pos
