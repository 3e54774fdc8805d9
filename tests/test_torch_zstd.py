"""The port's zstd codec (``segfusion_tpu_torch/utils/zstd.py``, the C++
decoder ``csrc/zstd.cpp`` and its plain Python version) against the
``zstandard`` module: frames at levels 1, 3, 19 and -5, with and without
checksum and content size, at 0 B, 1 B, 128 KiB +- 1 and 1 MiB of random,
constant, text-like, smooth float32 and patched (a random half, then
that half with every 97th byte set to "A") data decode exactly in both
decoders, over a corpus that takes every block type, literals block
type and sequence table mode; frames the port writes decode exactly in
``zstandard``; several frames, skippable frames, a corrupt checksum, a
dictionary frame and truncated input; CRC-32C and XXH64 against
published values."""

import collections

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from segfusion_tpu_torch.utils import zstd

LEVELS = [1, 3, 19, -5]
KINDS = ["random", "constant", "text", "smooth", "patched"]
SIZES = [0, 1, 128 * 1024 - 1, 128 * 1024 + 1]
WORDS = [b"the", b"fusion", b"voxel", b"depth", b"tsdf", b"net", b"a",
         b"of", b"semantic", b"\n"]


def data_of(kind: str, n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "constant":
        return b"\x5a" * n
    if kind == "text":
        words = [WORDS[i] for i in rng.integers(0, len(WORDS), n // 3 + 1)]
        return b" ".join(words)[:n]
    if kind == "patched":
        half = rng.integers(0, 256, n // 2 + 1, dtype=np.uint8)
        patched = half.copy()
        patched[::97] = ord("A")
        return (half.tobytes() + patched.tobytes())[:n]
    walk = np.cumsum(rng.standard_normal(n // 4 + 1)).astype(np.float32)
    return walk.tobytes()[:n]


def frame(data: bytes, level: int, checksum: bool) -> bytes:
    """A zstandard frame with the checksum and no content size, or the
    content size and no checksum."""
    return zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=not checksum).compress(data)


def block_types(f: bytes):
    """The block types of a single frame, from its block headers."""
    fhd = f[4]
    single = fhd >> 5 & 1
    pos = 5 + (1 - single) + (0, 1, 2, 4)[fhd & 3] + (single, 2, 4,
                                                      8)[fhd >> 6]
    types = []
    while True:
        h = int.from_bytes(f[pos:pos + 3], "little")
        types.append((h >> 1) & 3)
        pos += 3 + (1 if types[-1] == 1 else h >> 3)
        if h & 1:
            return types


def both(f: bytes, size=None):
    got = bytes(zstd.decompress(f, size))
    assert got == zstd.decompress_plain(f)
    return got


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", LEVELS)
def test_decoders_match_zstandard(level, kind):
    for n in SIZES:
        data = data_of(kind, n, seed=n)
        for checksum in (False, True):
            f = frame(data, level, checksum)
            assert zstandard.ZstdDecompressor().decompress(
                f, max_output_size=n + 1) == data
            assert both(f) == data, (n, checksum)
            assert bytes(zstd.decompress(f, n)) == data


def test_corpus_takes_every_kind(monkeypatch):
    """Raw, RLE and compressed blocks; raw, RLE, Huffman and treeless
    literals in one and four streams; each sequence code's predefined,
    RLE, FSE and repeat tables: all met and decoded exactly."""
    seen = collections.Counter()
    literals, seq_table = zstd._literals, zstd._seq_table

    def count_literals(data, pos, end, st):
        kind, fmt = data[pos] & 3, (data[pos] >> 2) & 3
        seen["literals", kind, 0 if kind < 2 else 1 if fmt == 0 else 4] += 1
        return literals(data, pos, end, st)

    def count_table(mode, name, *args):
        seen["table", name, mode] += 1
        return seq_table(mode, name, *args)
    monkeypatch.setattr(zstd, "_literals", count_literals)
    monkeypatch.setattr(zstd, "_seq_table", count_table)
    corpus = [("smooth", 1 << 20, 19), ("patched", 128 * 1024, 19),
              ("constant", 300000, 1), ("random", 5000, 1),
              ("text", 128 * 1024 + 1, 1), ("text", 128 * 1024 + 1, 19)]
    for kind, n, level in corpus:
        data = data_of(kind, n, seed=n)
        f = frame(data, level, False)
        seen.update(("block", t) for t in block_types(f))
        assert both(f) == data
    want = ([("block", t) for t in (0, 1, 2)]
            + [("literals", 0, 0), ("literals", 1, 0)]
            + [("literals", k, s) for k in (2, 3) for s in (1, 4)]
            + [("table", name, mode) for name in ("ll", "of", "ml")
               for mode in range(4)])
    assert not [w for w in want if not seen[w]], seen


@pytest.mark.parametrize("kind", KINDS)
def test_one_mebibyte(kind):
    data = data_of(kind, 1 << 20, seed=7)
    f = frame(data, 3, True)
    assert both(f) == data
    assert bytes(zstd.decompress(f, len(data))) == data


@settings(max_examples=40, deadline=None, database=None)
@given(data=st.binary(max_size=3000), level=st.sampled_from(LEVELS),
       checksum=st.booleans(), repeat=st.integers(1, 4))
def test_random_bytes(data, level, checksum, repeat):
    data = data * repeat                  # repeats give the matcher work
    assert both(frame(data, level, checksum)) == data


@pytest.mark.parametrize("n", [0, 1, 255, 256, 65791, 65792,
                               128 * 1024 - 1, 128 * 1024 + 1, 1 << 20])
@pytest.mark.parametrize("kind", ["random", "constant"])
def test_port_frames_decode_in_zstandard(n, kind):
    data = data_of(kind, n, seed=3)
    f = zstd.compress(data)
    assert zstandard.ZstdDecompressor().decompress(f) == data
    params = zstandard.get_frame_parameters(f)
    assert params.content_size == n and params.has_checksum
    assert both(f) == data


def test_several_frames_and_skippable_frames():
    parts = [data_of(k, 5000 + i, seed=i) for i, k in enumerate(KINDS)]
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little")
    joined = (frame(parts[0], 1, True) + skip + b"hello"
              + frame(parts[1], 19, False) + zstd.compress(parts[2])
              + frame(parts[3], -5, True) + skip + b"world"
              + frame(parts[4], 3, False))
    assert both(joined) == b"".join(parts)


def test_corrupt_checksum_raises():
    data = data_of("text", 20000)
    f = bytearray(frame(data, 3, True))
    f[-1] ^= 1
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(f))
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress_plain(bytes(f))
    f = bytearray(zstd.compress(data))
    f[-2] ^= 0x40
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(f))


def test_dictionary_frame_raises():
    samples = [data_of("text", 300, seed=i) for i in range(200)]
    d = zstandard.train_dictionary(2048, samples)
    f = zstandard.ZstdCompressor(dict_data=d).compress(samples[0])
    assert zstandard.get_frame_parameters(f).dict_id == d.dict_id() != 0
    for fn in (zstd.decompress, zstd.decompress_plain):
        with pytest.raises(ValueError, match="dictionar"):
            fn(f)


def test_truncated_and_garbage_input_raises():
    f = frame(data_of("text", 50000), 3, False)
    for cut in (3, 5, 9, len(f) // 2, len(f) - 1):
        for fn in (zstd.decompress, zstd.decompress_plain):
            with pytest.raises(ValueError):
                fn(f[:cut])
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"not a zstd frame")
    with pytest.raises(ValueError):
        zstd.decompress(f, 10)               # larger than the size given
    # a content size past what the frame's blocks can hold raises before
    # any output is allocated
    big = bytearray(zstd.compress(bytes(70000)))
    assert big[4] >> 6 == 2                  # a 4-byte content size
    big[5:9] = (2 ** 32 - 1).to_bytes(4, "little")
    for fn in (zstd.decompress, zstd.decompress_plain):
        with pytest.raises(ValueError):
            fn(bytes(big))


def test_crc32c_and_xxh64():
    # published check values (RFC 3720 B.4's CRC-32C; xxHash's own tests)
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c_plain(b"123456789") == 0xE3069283
    assert zstd.crc32c(bytes(32)) == 0x8A9136AA
    assert zstd.xxh64(b"") == zstd.xxh64_plain(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"abc") == zstd.xxh64_plain(b"abc") == \
        0x44BC2CF5AD770999
    rng = np.random.default_rng(5)
    for n in list(range(0, 70)) + [1000, 4099]:
        b = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert zstd.crc32c(b) == zstd.crc32c_plain(b)
        assert zstd.crc32c(b[n // 2:], zstd.crc32c(b[:n // 2])) == \
            zstd.crc32c(b)
        assert zstd.xxh64(b, 99) == zstd.xxh64_plain(b, 99)
