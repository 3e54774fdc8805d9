"""Port parity for the 3-D median filter (K5) and the outlier filter: the
port's plain ``median_filter3d`` and its kernel wrapper on a CPU tensor
against the JAX package's XLA median and its Pallas kernel (interpret
mode, as tests/test_pallas_median.py runs it), on the same numpy volumes.
Integer medians are exact on every backend, so every comparison here is
bit-exact (tolerance 0)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from segfusion_tpu.ops.filters import median_filter3d as j_median
from segfusion_tpu.ops.filters import outlier_filter as j_outlier
from segfusion_tpu.ops.pallas.median3d import median_filter3d_pallas
from segfusion_tpu_torch.ops.filters import median_filter3d, outlier_filter
from segfusion_tpu_torch.ops.kernels import median3d


@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("shape", [(20, 22, 30), (33, 17, 5), (16, 16, 24)])
def test_uint8_median_matches_jax(shape, size):
    """uint8 labels over the full byte range plus a run of few classes (so
    medians tie often): bit-exact to the XLA median and the Pallas kernel;
    the kernel wrapper on a CPU tensor gives the same volume."""
    rng = np.random.RandomState(sum(shape) + size)
    vol = rng.randint(0, 256, shape).astype(np.uint8)
    vol[: shape[0] // 2] = rng.randint(0, 5, vol[: shape[0] // 2].shape)
    want = np.asarray(j_median(jnp.asarray(vol), size=size))
    np.testing.assert_array_equal(
        np.asarray(median_filter3d_pallas(jnp.asarray(vol), size=size,
                                          interpret=True)), want)
    got = median_filter3d(torch.as_tensor(vol), size)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        median3d.median_filter3d(torch.as_tensor(vol), size).numpy(), want)


# csrc/median3d.cu's block tile: x-planes, y-rows, z-voxels (16 words)
K5_TX, K5_TY, K5_TZ = 8, 16, 64


def _words(vol, z_start):
    """The packed word of bytes z .. z + 3 (each z clamped into the
    volume) of every (x, y) row, for each z in ``z_start``: (X, Y, n)."""
    zs = np.clip(z_start[:, None] + np.arange(4), 0, vol.shape[2] - 1)
    b = vol[:, :, zs].astype(np.uint32)
    return (b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16
            | b[..., 3] << 24).astype(np.uint32)


def _funnel(lo, hi, shift):
    """__funnelshift_r / __byte_perm of a word pair: the 32 bits of
    hi:lo from bit ``shift`` on."""
    pair = hi.astype(np.uint64) << np.uint64(32) | lo.astype(np.uint64)
    return (pair >> np.uint64(shift) & np.uint64(0xFFFFFFFF)).astype(
        np.uint32)


def _tile_top(vol, r):
    """Per voxel quad (X, Y, Z / 4 words): the highest bit set in the OR
    of the bytes its block stages (rows clamped, z0 - 4 .. z0 + 67), or
    -1 where they are all 0."""
    X, Y, Z = vol.shape
    nw = -(-Z // 4)
    top = np.empty((X, Y, nw), np.int64)
    for x0 in range(0, X, K5_TX):
        for y0 in range(0, Y, K5_TY):
            for z0 in range(0, nw * 4, K5_TZ):
                xs = np.clip(np.arange(x0 - r, x0 + K5_TX + r), 0, X - 1)
                ys = np.clip(np.arange(y0 - r, y0 + K5_TY + r), 0, Y - 1)
                zs = np.clip(np.arange(z0 - 4, z0 + K5_TZ + 4), 0, Z - 1)
                seen = int(np.bitwise_or.reduce(
                    vol[np.ix_(xs, ys, zs)].ravel()))
                top[x0:x0 + K5_TX, y0:y0 + K5_TY,
                    z0 // 4:(z0 + K5_TZ) // 4] = seen.bit_length() - 1
    return top


def k5_model(vol: np.ndarray, size: int) -> np.ndarray:
    """numpy model of the K5 kernel's arithmetic (csrc/median3d.cu): four
    z-voxels per uint32 word; per (dx, dy) column the aligned words w-1,
    w, w+1 packed by byte permutes into the pair (lo, hi) of bytes
    z - R .. z + 7 - R; each dz window a funnel shift of the pair; the
    radix select in its prefix form counted in byte lanes (pass b >= 1 on
    the windows shifted b bits further, as (8 - b)-bit fields whose carry
    flags are held in the lanes for up to 2^b - 1 terms); passes above the
    block tile's OR skipped; the ragged tail of the last word cut at the
    store."""
    r = size // 2
    K, rank = size ** 3, size ** 3 // 2
    X, Y, Z = vol.shape
    nw = -(-Z // 4)
    zq = 4 * np.arange(nw)
    a, b, c = _words(vol, zq - 4), _words(vol, zq), _words(vol, zq + 4)
    lo, hi = _funnel(a, b, 8 * (4 - r)), _funnel(b, c, 8 * (4 - r))
    xs = np.clip(np.arange(X)[:, None] + np.arange(-r, r + 1), 0, X - 1)
    ys = np.clip(np.arange(Y)[:, None] + np.arange(-r, r + 1), 0, Y - 1)
    pairs = [(lo[xs[:, dx]][:, ys[:, dy]], hi[xs[:, dx]][:, ys[:, dy]])
             for dx in range(size) for dy in range(size)]
    top = _tile_top(vol, r)
    ones, high = np.uint32(0x01010101), np.uint32(0x80808080)
    M = np.zeros((X, Y, nw), np.uint32)
    L = np.zeros_like(M)
    for bit in range(7, -1, -1):
        # each dz window shifted `bit` bits further
        windows = [_funnel(clo, chi, 8 * j + bit) for clo, chi in pairs
                   for j in range(size)]
        nz = np.zeros_like(M)
        if bit == 0:
            for v in windows:
                x = v ^ M
                nz += (((x | high) - ones | x) & high) >> np.uint32(7)
        else:
            # (8 - bit)-bit fields; carry flags W held in the byte lanes
            # for up to 2^bit - 1 terms, then moved down into nz
            F = np.uint32((0xFF >> bit) * 0x01010101)
            W = np.uint32((0x100 >> bit) * 0x01010101)
            down = np.uint32(0 if bit == 7 else 8 - bit)
            hold = (1 << bit) - 1
            Mb = (M >> np.uint32(bit)) & F
            flags = np.zeros_like(M)
            for t, v in enumerate(windows):
                f = (v ^ Mb) & F
                flags += f if bit == 7 else (f + F) & W
                if (t + 1) % hold == 0:
                    nz += flags >> down
                    flags[:] = 0
            nz += flags >> down
        below = L + (np.uint32(K) * ones - nz)
        over = ((below | high) - np.uint32(rank + 1) * ones) & high
        take = ((over ^ high) >> np.uint32(7)) * np.uint32(0xFF)
        run = bit <= top
        M = np.where(run, M | (take & (ones << np.uint32(bit))), M)
        L = np.where(run, (L & ~take) | (below & take), L)
    lanes = (M[..., None] >> (np.uint32(8) * np.arange(4, dtype=np.uint32))
             & np.uint32(0xFF)).astype(np.uint8)
    return lanes.reshape(X, Y, nw * 4)[:, :, :Z]


def _median_input(shape, data, seed):
    rng = np.random.RandomState(seed)
    if data == "full-byte":
        return rng.randint(0, 256, shape).astype(np.uint8)
    if data == "few-class":
        return rng.randint(0, 5, shape).astype(np.uint8)
    return np.full(shape, 200, np.uint8)


@pytest.mark.parametrize("data", ["full-byte", "few-class", "all-equal"])
@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("shape", [(20, 22, 30), (33, 17, 5), (16, 16, 24)])
def test_k5_model_matches_jax(shape, size, data):
    """The numpy model of the kernel's packed-byte arithmetic: bit-exact
    to the XLA median and the Pallas kernel (interpret mode), with Z no
    multiple of 4 in two of the shapes and several blocks in x and y."""
    vol = _median_input(shape, data, sum(shape) + size)
    want = np.asarray(j_median(jnp.asarray(vol), size=size))
    np.testing.assert_array_equal(
        np.asarray(median_filter3d_pallas(jnp.asarray(vol), size=size,
                                          interpret=True)), want)
    np.testing.assert_array_equal(k5_model(vol, size), want)


def test_k5_model_skips_passes():
    """The pass skip is what the model runs: few-class blocks (labels
    < 5) start at bit 2, an all-zero volume runs no pass at all."""
    vol = _median_input((20, 22, 30), "few-class", 1)
    assert set(np.unique(_tile_top(vol, 2))) == {2}
    zero = np.zeros((9, 9, 9), np.uint8)
    assert set(np.unique(_tile_top(zero, 1))) == {-1}
    np.testing.assert_array_equal(k5_model(zero, 3), zero)


def test_float_median_matches_jax():
    """A float32 volume against the XLA median: exact (both take the
    sorted middle of the same values)."""
    vol = np.random.RandomState(7).randn(12, 10, 9).astype(np.float32)
    for size in (3, 5):
        np.testing.assert_array_equal(
            median_filter3d(torch.as_tensor(vol), size).numpy(),
            np.asarray(j_median(jnp.asarray(vol), size=size)))


def test_plain_median_slabs(monkeypatch):
    """The x-slab loop (forced to one plane per slab here) changes nothing:
    exact against the unsliced result."""
    vol = torch.as_tensor(
        np.random.RandomState(3).randint(0, 9, (7, 12, 10)).astype(np.uint8))
    whole = median3d.median_filter3d_plain(vol, 5)
    monkeypatch.setattr(median3d, "_SLAB_VALUES", 1)
    torch.testing.assert_close(median3d.median_filter3d_plain(vol, 5), whole,
                               rtol=0, atol=0)


def test_median_rejects_bad_input():
    vol = torch.zeros((4, 4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="odd"):
        median_filter3d(vol, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        median3d.median_filter3d(vol.to("meta"), 5)


def test_cpu_wrapper_counts_no_launch():
    median3d.reset_launch_counts()
    median3d.median_filter3d(torch.zeros((4, 4, 4), dtype=torch.uint8), 3)
    assert median3d.launch_counts() == {"median_filter3d": 0}


def test_outlier_filter_matches_jax():
    """Exact: a threshold compare and a select."""
    rng = np.random.RandomState(5)
    tsdf = rng.uniform(-0.1, 0.1, (8, 9, 10)).astype(np.float32)
    w = rng.uniform(0, 4, (8, 9, 10)).astype(np.float32)
    jt, jw = j_outlier(jnp.asarray(tsdf), jnp.asarray(w), 2.0, 0.1)
    pt, pw = outlier_filter(torch.as_tensor(tsdf), torch.as_tensor(w), 2.0,
                            0.1)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
