"""Probe parity: every probe kernel of ``segfusion_tpu_torch/probes`` (its
plain version, which the wrapper takes for a CPU tensor) against the
Pallas kernel of the ``tools/`` probe it replaces, run in interpret mode on
the CPU, on the same numpy inputs.

How each JAX side runs (nothing in ``tools/`` changes):

- ``dma_only_kernel`` (P1) and ``pallas_caps3``'s ``_win_kernel`` /
  ``_flat_kernel`` (P11) are the tools' kernel functions, wrapped here in
  ``pl.pallas_call(..., interpret=True)`` at small shapes;
- ``probe_dynamic_gather.probe`` (P6), ``probe_pallas_caps.main`` (P8),
  ``probe_pallas_caps2.main`` (P9, P10) and
  ``probe_shadow_debug.roll_semantics`` (P12) run as they are inside
  ``pltpu.force_tpu_interpret_mode()``; a recorder in place of
  ``pl.pallas_call`` keeps each call's inputs and output;
- the kernel bodies of ``probe_random_access.py`` (P2-P5) and
  ``probe_axis1`` of ``probe_dynamic_gather.py`` (P7) sit inside functions
  with their sizes and timing loops built in, so they are copied here
  verbatim (file:line at each) at small sizes, with ``interpret=True``.

Tolerance: bit-exact everywhere except two sums on random f32 data. P4
(scatter-add): the port's CPU plain version adds in index order like the
TPU loop, so it is exact here, but the card's shared-memory atomics add in
no fixed order; the stated bound is |d| <= 1e-5 on bins of at most ~10
standard normal updates (k - 1 roundings of 2^-24 relative each). P5 (box
sum): the port sums the box's x-planes in order, ``jnp.sum`` in its own
order; 8 terms in [0, 1) differ by at most a few ulp: rtol 1e-6, atol 1e-6.
On the probes' own all-ones inputs both are exact.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import probe_dynamic_gather  # noqa: E402
import probe_pallas_caps  # noqa: E402
import probe_pallas_caps2  # noqa: E402
import probe_pallas_caps3  # noqa: E402
import probe_shadow_debug  # noqa: E402
import probe_shadow_variants  # noqa: E402

from segfusion_tpu.ops.pallas import shadow_build as jsb  # noqa: E402
from segfusion_tpu_torch.ops.rowvol import RowLayout  # noqa: E402
from segfusion_tpu_torch.probes import (dynamic_gather, pallas_caps,  # noqa
                                        pallas_caps2, pallas_caps3,
                                        random_access, shadow_debug,
                                        shadow_variants)


def _t(a):
    return torch.as_tensor(np.array(a))


def _record(run):
    """Run ``run()`` in interpret mode with ``pl.pallas_call`` recording
    each call: [(kernel name, [inputs], output)] as numpy."""
    calls, real = [], pl.pallas_call

    def recorder(kernel, *args, **kwargs):
        fn = real(kernel, *args, **kwargs)

        def call(*xs):
            out = fn(*xs)
            calls.append((kernel.__name__, [np.asarray(x) for x in xs],
                          np.asarray(out)))
            return out
        return call

    pl.pallas_call = recorder
    try:
        with pltpu.force_tpu_interpret_mode(), jax.disable_jit():
            run()
    finally:
        pl.pallas_call = real
    return calls


# -- P1 -------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(6, 8, 40), (3, 12, 100)])
def test_dma_only_matches_jax(shape):
    """tools/probe_shadow_variants.py dma_only_kernel (:57) in the call of
    dma_only (:96), interpreted: bit-exact."""
    L = RowLayout.for_shape(shape)
    X, Y, G, GK = L.X, L.Y, L.G, L.GK
    TY = jsb._pick_ty(Y, 56)
    NJ = Y // TY
    geo = np.random.RandomState(0).randn(L.geo_rows, 128).astype(np.float32)
    want = pl.pallas_call(
        functools.partial(probe_shadow_variants.dma_only_kernel, TY=TY, Y=Y,
                          G=G, GK=GK, NJ=NJ, N=X * NJ),
        grid=(X, NJ),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((1, TY * GK, 128), lambda x, j: (x, j, 0)),
        out_shape=jax.ShapeDtypeStruct((X, Y * GK, 128), jnp.uint32),
        scratch_shapes=[pltpu.VMEM((2, (TY + 2) * G, 128), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,))],
        interpret=True)(jnp.asarray(geo))
    got = shadow_variants.dma_only(_t(geo), L)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(want).reshape(L.shadow_rows, 128)
        .view(np.int32))
    assert shadow_variants.dma_only_bytes(L) == 2 * L.shadow_rows * 512


# -- P2-P5: the bodies of tools/probe_random_access.py, copied --------------------

VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)


def _jax_scalar_gather(table, idx):
    n_idx = idx.shape[1]

    # tools/probe_random_access.py:94-98
    def kernel(table_ref, idx_ref, out_ref):
        def body(i, _):
            out_ref[0, i] = table_ref[0, idx_ref[0, i]]
            return 0
        jax.lax.fori_loop(0, n_idx, body, 0)

    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((1, n_idx), jnp.float32),
        in_specs=[VMEM, VMEM], out_specs=VMEM,
        interpret=True)(jnp.asarray(table), jnp.asarray(idx))


def _jax_vector_take(table, idx):
    # tools/probe_random_access.py:128-129
    def kernel(table_ref, idx_ref, out_ref):
        out_ref[:, :] = jnp.take(table_ref[0, :], idx_ref[:, :], axis=0)

    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(idx.shape, jnp.float32),
        in_specs=[VMEM, VMEM], out_specs=VMEM,
        interpret=True)(jnp.asarray(table), jnp.asarray(idx))


def _jax_scalar_rmw(idx, upd, nvox):
    n_idx = idx.shape[1]

    # tools/probe_random_access.py:162-169
    def kernel(idx_ref, upd_ref, out_ref):
        out_ref[:, :] = jnp.zeros_like(out_ref)

        def body(i, _):
            j = idx_ref[0, i]
            out_ref[0, j] = out_ref[0, j] + upd_ref[0, i]
            return 0
        jax.lax.fori_loop(0, n_idx, body, 0)

    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((1, nvox), jnp.float32),
        in_specs=[VMEM, VMEM], out_specs=VMEM,
        interpret=True)(jnp.asarray(idx), jnp.asarray(upd))


def _jax_box_dma(vol, pos, box):
    # tools/probe_random_access.py:200-211
    def kernel(pos_ref, vol_ref, out_ref):
        def inner(scratch, sem):
            x, y, z = pos_ref[0], pos_ref[1], pos_ref[2]
            dma = pltpu.make_async_copy(
                vol_ref.at[pl.ds(x, box), pl.ds(y, box), pl.ds(z, box)],
                scratch, sem)
            dma.start()
            dma.wait()
            out_ref[:, :] = jnp.sum(scratch[:, :, :], axis=0)
        pl.run_scoped(inner,
                      scratch=pltpu.VMEM((box, box, box), jnp.float32),
                      sem=pltpu.SemaphoreType.DMA(()))

    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((box, box), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=VMEM, interpret=True)(jnp.asarray(pos), jnp.asarray(vol))


# table sizes of the gather tests: the tool's, a ragged 1,001 floats (a
# 16-byte tail) and a 32^3 table seen 4 bytes past a 16-byte boundary
GATHER_SIZES = [(512, 0), (4096, 0), (1001, 0), (32 ** 3, 0), (32 ** 3, 1)]


def _table_view(rng, nvox, offset):
    """(numpy table (1, nvox), the same values as a torch view ``offset``
    floats into its storage)."""
    flat = rng.randn(nvox + offset).astype(np.float32)
    return flat[None, offset:], torch.as_tensor(flat)[offset:][None]


@pytest.mark.parametrize("nvox,offset", GATHER_SIZES,
                         ids=[f"{n}{'-misaligned' * o}"
                              for n, o in GATHER_SIZES])
def test_scalar_gather_matches_jax(nvox, offset):
    rng = np.random.RandomState(2)
    table, view = _table_view(rng, nvox, offset)
    idx = rng.randint(0, nvox, (1, 256)).astype(np.int32)
    want = _jax_scalar_gather(table, idx)
    got = random_access.gather_smem(view, _t(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


TAKE_SIZES = [(512, 0), (4096, 0), (64 ** 3, 0), (1001, 0), (32 ** 3, 0),
              (32 ** 3, 1)]


@pytest.mark.parametrize("nvox,offset", TAKE_SIZES,
                         ids=[f"{n}{'-misaligned' * o}"
                              for n, o in TAKE_SIZES])
def test_vector_take_matches_jax(nvox, offset):
    """The tool's three table sizes and the ragged and misaligned ones; on
    the card the 64^3 table is gathered from device memory (take_route)."""
    rng = np.random.RandomState(3)
    table, view = _table_view(rng, nvox, offset)
    idx = rng.randint(0, nvox, (8, 128)).astype(np.int32)
    want = _jax_vector_take(table, idx)
    got = random_access.take(view, _t(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert random_access.take_route(view) == (
        "shared memory" if nvox <= 32 ** 3 else "device memory (L2)")


# gather_smem_kernel's grid and staging split (csrc/probes.cu constants;
# test_gather_model_constants_match_the_kernel holds them to the source)
GATHER_BLOCKS, GATHER_THREADS, GATHER_THREAD_EIGHTHS = 32, 512, 3
_SMEM_BYTES = 232448


def gather_model(phase, n_table, n, vec_idx=True):
    """numpy model of how gather_smem_kernel (csrc/probes.cu) splits its
    work: the grid (at most GATHER_BLOCKS blocks of GATHER_THREADS, one
    16-byte index vector a thread); the table (at byte ``phase`` modulo
    16 in device memory) into a head of thread loads up to its first
    16-byte boundary, a body of 16-byte units whose first part thread 0
    bulk-copies and whose last 3/8 of n_table / 4 units the threads load,
    and a tail of thread loads; and the ``n`` indices over the grid's
    threads, as 16-byte vectors (the first prefetched before the wait)
    and a scalar tail. Returns (the number of blocks; per block, how
    often each table float lands in its shared memory; how often each
    index is gathered; the bulk copy as (device byte offset, shared byte
    offset, bytes) or None; the barrier's expected bytes; the shared
    memory the launch asks for)."""
    need = -(-n // (4 * GATHER_THREADS))
    blocks = max(1, min(need, GATHER_BLOCKS))
    head = min(((16 - phase) & 15) >> 2, n_table)
    units = (n_table - head) >> 2
    tail0 = head + 4 * units
    bulk = units - min(n_table // 4 * GATHER_THREAD_EIGHTHS // 8, units)
    landed = np.zeros((blocks, n_table), np.int64)
    copy = None
    if bulk > 0:
        landed[:, head:head + 4 * bulk] += 1
        copy = (phase + 4 * head, 16 + phase + 4 * head, 16 * bulk)
    for u in range(bulk, units):
        landed[:, head + 4 * u:head + 4 * u + 4] += 1
    for i in range(head + n_table - tail0):
        landed[:, i if i < head else tail0 + i - head] += 1
    seen = np.zeros(n, np.int64)
    nvec = n >> 2 if vec_idx else 0
    stride = blocks * GATHER_THREADS
    for v0 in range(stride):
        for v in range(v0, nvec, stride):
            seen[4 * v:4 * v + 4] += 1
        for i in range(4 * nvec + v0, n, stride):
            seen[i] += 1
    return (blocks, landed, seen, copy, 16 * bulk,
            16 + phase + 4 * n_table)


MODEL_TABLES = [(0, 512), (0, 32 ** 3), (0, 1001), (4, 32 ** 3), (8, 1001),
                (12, 2), (0, random_access.GATHER_SMEM_MAX_BYTES // 4),
                (12, random_access.GATHER_SMEM_MAX_BYTES // 4)]
# (indices, 16-byte aligned): the probe's 65,536 (one vector a thread of
# the full grid), several vectors a thread, a scalar tail, scalars only
# (a misaligned view), fewer indices than one vector
MODEL_INDICES = [(1 << 16, True), (200_003, True), (999, True),
                 (1001, False), (3, True)]


@pytest.mark.parametrize("n,vec", MODEL_INDICES,
                         ids=[f"{n}{'-scalar' * (not v)}"
                              for n, v in MODEL_INDICES])
@pytest.mark.parametrize("phase,n_table", MODEL_TABLES,
                         ids=[f"{n}@{p}" for p, n in MODEL_TABLES])
def test_gather_model_covers_once(phase, n_table, n, vec):
    """Every table float lands in every block's shared memory exactly once,
    the bulk copy is 16-byte aligned at both ends and a multiple of 16
    bytes, the barrier expects exactly its bytes, the shared memory fits,
    and every index is gathered exactly once (16-byte vectors and a
    scalar tail; all scalar where the indices are not 16-byte aligned)."""
    blocks, landed, seen, copy, expect, smem = gather_model(
        phase, n_table, n, vec)
    assert 1 <= blocks <= GATHER_BLOCKS
    assert (landed == 1).all()
    assert (seen == 1).all()
    if copy is None:
        assert expect == 0
    else:
        src, dst, nbytes = copy
        assert src % 16 == 0 and dst % 16 == 0 and nbytes % 16 == 0
        assert nbytes == expect > 0
    assert smem <= random_access.GATHER_SMEM_MAX_BYTES + 16 + 12
    assert smem <= _SMEM_BYTES


def test_gather_model_constants_match_the_kernel():
    """The model's grid and staging split are the kernel's constants, the
    probe's 65,536 indices fill the whole grid with one index vector a
    thread, and the shared route's largest table leaves room for the
    barrier's slot and the phase."""
    src = open(os.path.join(ROOT, "segfusion_tpu_torch", "csrc",
                            "probes.cu")).read()
    for name, value in (("kGatherBlocks", GATHER_BLOCKS),
                        ("kGatherThreads", GATHER_THREADS),
                        ("kGatherThreadEighths", GATHER_THREAD_EIGHTHS),
                        ("kMaxSmem", _SMEM_BYTES)):
        assert f"constexpr int {name} = {value};" in src
    assert gather_model(0, 512, 1 << 16)[0] == GATHER_BLOCKS
    assert GATHER_BLOCKS * GATHER_THREADS * 4 == 1 << 16
    assert gather_model(0, 512, 4 * GATHER_THREADS + 1)[0] == 2
    assert random_access.GATHER_SMEM_MAX_BYTES == _SMEM_BYTES - 32


# gather_global_kernel's threads a block (csrc/probes.cu kThreads, through
# launch_flat; test_global_gather_model_constants_match_the_kernel holds it
# to the source)
FLAT_THREADS = 256


def global_gather_model(table, idx, threads=FLAT_THREADS):
    """numpy model of gather_global_kernel (csrc/probes.cu), P3's
    device-memory route: ceil(n / threads) blocks of ``threads``, thread t
    of block b taking output b threads + t below n, its index, then the
    table entry there; an index outside the table (by the unsigned
    compare) reads 0. Returns (out shaped like idx, how often each output
    is written, the blocks)."""
    tab, flat = table.reshape(-1), idx.reshape(-1)
    n = flat.size
    blocks = -(-n // threads)
    out = np.full(n, np.nan, np.float32)
    writes = np.zeros(n, np.int64)
    b, t = np.meshgrid(np.arange(blocks), np.arange(threads), indexing="ij")
    i = (b * threads + t).ravel()
    i = i[i < n]
    np.add.at(writes, i, 1)
    j = flat[i]
    inside = j.astype(np.uint32) < tab.size
    out[i] = np.where(inside, tab[np.where(inside, j, 0)], np.float32(0))
    return out.reshape(idx.shape), writes.reshape(idx.shape), blocks


@pytest.mark.parametrize("view", ["aligned", "misaligned"])
@pytest.mark.parametrize("n", [1 << 16, 999, 5, 1])
def test_global_gather_model_is_the_take(n, view):
    """Every output written once, on contiguous indices and on a view 4
    bytes past a 16-byte boundary (the kernel takes both the same way); on
    in-range indices into the probe's 64^3 table the result is the tool's
    vector take (interpret mode), and an index outside the table
    (negative, past the end, the int32 extremes) reads 0."""
    rng = np.random.RandomState(n)
    nvox = 64 ** 3
    table = rng.randn(1, nvox).astype(np.float32)
    shift = 1 if view == "misaligned" else 0
    idx = rng.randint(0, nvox, n + shift).astype(np.int32)[shift:][None]
    out, writes, blocks = global_gather_model(table, idx)
    assert (writes == 1).all()
    assert blocks == -(-n // FLAT_THREADS)
    np.testing.assert_array_equal(out, np.asarray(_jax_vector_take(table,
                                                                   idx)))
    bad = idx.copy()
    outside = np.array([-1, nvox, -2 ** 31, 2 ** 31 - 1], np.int32)
    where = rng.choice(n, min(n, outside.size), replace=False)
    bad[0, where] = outside[:where.size]
    out, writes, _ = global_gather_model(table, bad)
    assert (writes == 1).all()
    assert (out[0, where] == 0).all()
    keep = np.setdiff1d(np.arange(n), where)
    np.testing.assert_array_equal(out[0, keep], table[0, bad[0, keep]])


def test_global_gather_model_constants_match_the_kernel():
    """The model's threads a block are launch_flat's, the launcher takes
    launch_flat, and the kernel is one thread an output with the unsigned
    compare the model makes."""
    src = open(os.path.join(ROOT, "segfusion_tpu_torch", "csrc",
                            "probes.cu")).read()
    assert f"constexpr int kThreads = {FLAT_THREADS};" in src
    assert "kernel<<<blocks_for(n), kThreads, 0, s>>>(args..., n);" in src
    launcher = src[src.index('extern "C" int sf_probe_gather_global('):]
    launcher = launcher[:launcher.index("\n}\n")]
    assert "return launch_flat(gather_global_kernel, n, STREAM," in launcher
    kernel = src[src.index("__global__ void gather_global_kernel("):]
    kernel = kernel[:kernel.index("\n}\n")]
    assert "const long long i = tid();" in kernel
    assert ("static_cast<unsigned>(j) < static_cast<unsigned>(n_table)"
            in kernel)


@pytest.mark.parametrize("updates", ["ones", "normal"])
def test_scatter_add_matches_jax(updates):
    """Exact on the probe's all-ones updates; within 1e-5 on standard
    normal ones (the card's atomics add in no fixed order)."""
    rng = np.random.RandomState(4)
    nvox, n = 512, 2048
    idx = rng.randint(0, nvox, (1, n)).astype(np.int32)
    upd = (np.ones((1, n), np.float32) if updates == "ones"
           else rng.randn(1, n).astype(np.float32))
    want = np.asarray(_jax_scalar_rmw(idx, upd, nvox))[0]
    got = random_access.scatter_add(_t(idx), _t(upd), nvox).numpy()
    if updates == "ones":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_scatter_add_limits():
    """The cluster's bins: 16 blocks of 49,856 bins (232,448 B of shared
    memory each, less a 32 KiB stage and 256 B of counts, in multiples of
    4 bins); a tensor on neither the CPU nor a CUDA device is refused
    before any check of the card."""
    assert random_access.scatter_add_max_bins() == 16 * 49856
    idx = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        random_access.scatter_add(idx, torch.ones((1, 4), device="meta"), 8)


@pytest.mark.parametrize("data", ["ones", "uniform"])
def test_box_sum_matches_jax(data):
    """Exact on the probe's all-ones volume; rtol/atol 1e-6 on uniform
    data (jnp.sum's order against the port's x-plane order)."""
    side, box = 16, 8
    vol = (np.ones((side,) * 3, np.float32) if data == "ones" else
           np.random.RandomState(5).rand(side, side, side).astype(np.float32))
    pos = np.array([3, 5, 2], np.int32)
    want = np.asarray(_jax_box_dma(vol, pos, box))
    got = random_access.box_sum(_t(vol), _t(pos), box).numpy()
    if data == "ones":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_box_sum_clamps_the_start():
    """A start past the far face reads the last box in the volume, as
    lax.dynamic_slice clamps."""
    vol = torch.as_tensor(
        np.random.RandomState(6).rand(12, 12, 12).astype(np.float32))
    far = random_access.box_sum(vol, torch.tensor([50, -3, 9],
                                                  dtype=torch.int32), 4)
    torch.testing.assert_close(far, vol[8:12, 0:4, 8:12].sum(0), rtol=1e-6,
                               atol=1e-6)


# box_sum's block and the box side of its TMA and unrolled forms
# (kBoxThreads, kBoxUnrolled in csrc/probes.cu)
BOX_THREADS, BOX_UNROLLED = 32, 64


def box_model(vol, pos, B, aligned=True):
    """numpy model of P5's kernels (csrc/probes.cu): the grid
    (ceil(B / BOX_THREADS), B) of BOX_THREADS threads; block (bz, y),
    thread t sums the column (y, z = bz BOX_THREADS + t), if z < B, over x
    in order from 0 (one f32 rounding per add, as the kernels' adds),
    from the start clamped into the volume. On the TMA route (B of 64,
    SZ % 4 == 0, a 16-byte-aligned volume, a clamped z start that is a
    multiple of 4) the block's thread 0 loads the (B x, 1 y, BOX_THREADS
    z) tile at (x0, y0 + y, z0 + bz BOX_THREADS) and each thread reads its
    column of the tile. Returns (out, how often each (y, z) is summed, the
    route, the TMA tiles' z starts)."""
    SZ = vol.shape[2]
    x0, y0, z0 = (min(max(int(p), 0), s - B)
                  for p, s in zip(pos, vol.shape))
    route = ("x loop" if B != BOX_UNROLLED else
             "tma tile" if SZ % 4 == 0 and aligned and z0 % 4 == 0
             else "unrolled")
    out = np.full((B, B), np.nan, np.float32)
    covered = np.zeros((B, B), np.int64)
    starts = []
    for bz in range(-(-B // BOX_THREADS)):
        z = bz * BOX_THREADS + np.arange(BOX_THREADS)
        z = z[z < B]
        for y in range(B):
            if route == "tma tile":
                zs = z0 + bz * BOX_THREADS
                starts.append(zs)
                tile = vol[x0:x0 + B, y0 + y, zs:zs + BOX_THREADS]
                assert tile.shape == (B, BOX_THREADS)   # inside the volume
                cols = tile[:, z - bz * BOX_THREADS]
            else:
                cols = vol[x0:x0 + B, y0 + y, z0 + z]
            acc = np.zeros(len(z), np.float32)
            for x in range(B):
                acc = acc + cols[x]
            out[y, z] = acc
            covered[y, z] += 1
    return out, covered, route, starts


# (shape, start): starts at z 3 and 2 (a TMA copy there traps: thread
# loads) and 0, inside and past each face, of volumes whose SZ is (68) and
# is not (67) a multiple of 4
BOX_STARTS = [(shape, start) for shape in ((70, 66, 68), (70, 66, 67))
              for start in ((2, 1, 3), (99, 0, 0), (-5, 0, 0), (0, 80, 0),
                            (0, -1, 0), (0, 0, 70), (0, 0, -9), (0, 0, 2))]


@pytest.mark.parametrize("B", [1, 4, 64])
@pytest.mark.parametrize("shape,start", BOX_STARTS,
                         ids=[f"{s[0]}x{s[1]}x{s[2]}@{p}"
                              for s, p in BOX_STARTS])
def test_box_model_covers_once_in_x_order(shape, start, B):
    """Every (y, z) of the box is summed exactly once, in x order from the
    clamped start: the model equals the plain version bit for bit (on
    uniform data, where another order of the adds would differ); every
    TMA tile starts at a 16-byte-aligned z inside the volume."""
    vol = np.random.RandomState(B).rand(*shape).astype(np.float32)
    pos = np.array(start, np.int32)
    out, covered, route, starts = box_model(vol, pos, B)
    assert (covered == 1).all()
    assert route == random_access.box_route(_t(vol), start, B)
    assert all(zs % 4 == 0 and zs + BOX_THREADS <= shape[2]
               for zs in starts)
    assert len(starts) == (2 * 64 if route == "tma tile" else 0)
    np.testing.assert_array_equal(
        out, random_access.box_sum(_t(vol), _t(pos), B).numpy())


def test_box_route_needs_an_aligned_volume():
    """A volume seen 4 bytes past a 16-byte boundary takes the unrolled
    thread loads at B = 64 (the tensor map needs an aligned base), with
    the same result as the TMA route's model."""
    flat = np.random.RandomState(7).rand(70 * 66 * 68 + 1).astype(np.float32)
    view = torch.as_tensor(flat)[1:].reshape(70, 66, 68)
    vol = flat[1:].reshape(70, 66, 68)
    pos = np.array([3, 2, 4], np.int32)
    assert random_access.box_route(view, pos, 64) == "unrolled"
    assert random_access.box_route(_t(vol.copy()), pos, 64) == "tma tile"
    assert random_access.box_route(view, pos, 13) == "x loop"
    unaligned, covered, route, _ = box_model(vol, pos, 64, aligned=False)
    tma, _, _, _ = box_model(vol, pos, 64)
    assert route == "unrolled" and (covered == 1).all()
    np.testing.assert_array_equal(unaligned, tma)
    np.testing.assert_array_equal(
        unaligned, random_access.box_sum(view, _t(pos), 64).numpy())


# -- P6 / P7 ----------------------------------------------------------------------

@pytest.mark.parametrize("S", [8, 64])
def test_dynamic_gather_matches_jax(S):
    """tools/probe_dynamic_gather.py probe(S, inner=2), f32 and u32:
    bit-exact (u32 as int32 bits, the add wrapping)."""
    calls = _record(lambda: (probe_dynamic_gather.probe(S, reps=1, inner=2),
                             probe_dynamic_gather.probe(S, jnp.uint32,
                                                        reps=1, inner=2)))
    dtypes = set()
    for _, (table, idx), want in calls:
        dtypes.add(want.dtype)
        if want.dtype == np.uint32:
            table, want = table.view(np.int32), want.view(np.int32)
        got = dynamic_gather.gather_rows_sum(_t(table), _t(idx), inner=2)
        np.testing.assert_array_equal(got.numpy(), want)
    assert dtypes == {np.dtype(np.float32), np.dtype(np.uint32)}


def test_gather_rows_sum_wraps_like_u32():
    table = np.full((4, 128), 0xC0000000, np.uint32)
    idx = np.zeros((4, 128), np.int32)
    got = dynamic_gather.gather_rows_sum(_t(table.view(np.int32)), _t(idx),
                                         inner=3)
    want = (table.astype(np.uint64) * 3 % 2 ** 32).astype(np.uint32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# P6's constants (kRowsSumVector, kLaneTile, kTileRows in csrc/probes.cu;
# test_rows_sum_and_window_models_constants_match_the_kernel holds them)
ROWS_SUM_VECTOR, LANE_TILE, TILE_ROWS = 8, 32, 8


def rows_sum_model(table, idx, inner):
    """numpy model of P6's two kernels (csrc/probes.cu). The transpose: the
    lane-major scratch lm (C, P), P = ``lane_major_width`` (S + inner - 1,
    at least S, rounded up to 4), lm[j, s] = table[s mod S, j] below
    S + max(inner, 1) - 1 and 0 after, written tile by tile, LANE_TILE
    square. The gather-sum: output (i, j) takes r = idx mod S (the 32-bit
    remainder, plus S where negative) and, at inner == ROWS_SUM_VECTOR,
    reads the 2 or 3 aligned 4-entry vectors over [r, r + 8) of lm[j]
    (the third only where r mod 4 != 0) and picks the entries by r mod 4,
    else reads lm[j, r + k]; the entries are added in order of k from 0
    (one f32 rounding per add, or a wrapping u32 add). ``table`` f32 or
    u32. Returns (out, how often each lm entry is written, the vectors
    each output read)."""
    S, C = table.shape
    P = dynamic_gather.lane_major_width(S, inner)
    n_valid = S + max(inner, 1) - 1
    assert P % 4 == 0 and n_valid <= P < n_valid + 4
    src = np.zeros((P, C), table.dtype)
    src[:n_valid] = table[np.arange(n_valid) % S]
    lm = np.full((C, P), 7, table.dtype)
    written = np.zeros((C, P), np.int64)
    for bx in range(-(-P // LANE_TILE)):
        for by in range(-(-C // LANE_TILE)):
            s = slice(bx * LANE_TILE, (bx + 1) * LANE_TILE)
            j = slice(by * LANE_TILE, (by + 1) * LANE_TILE)
            lm[j, s] = src[s, j].T
            written[j, s] += 1
    r = np.fmod(idx, S)
    r = np.where(r < 0, r + S, r)
    lanes = np.broadcast_to(np.arange(C), idx.shape)
    acc = np.zeros(idx.shape, table.dtype)
    vectors = np.zeros(idx.shape, np.int64)
    if inner == ROWS_SUM_VECTOR:
        m = r & 3
        vectors = np.where(m > 0, 3, 2)
        assert (r - m + 4 * vectors <= P).all()     # inside the row
        words = np.stack([np.where(w < 4 * vectors,
                                   lm[lanes, np.minimum(r - m + w, P - 1)],
                                   0) for w in range(12)], -1)
        for k in range(inner):
            acc = acc + np.take_along_axis(words, (m + k)[..., None],
                                           -1)[..., 0]
    else:
        for k in range(inner):
            acc = acc + lm[lanes, r + k]
    return acc, written, vectors


# (S, inner): inner > S occurs (8 at S 8, 9 at S 8 and 9)
ROWS_SUM_CASES = [(S, inner) for S in (8, 9, 64, 513)
                  for inner in (0, 1, 2, 8, 9)]


@pytest.mark.parametrize("u32", [False, True], ids=["f32", "u32"])
@pytest.mark.parametrize("S,inner", ROWS_SUM_CASES,
                         ids=[f"S{S}-inner{i}" for S, i in ROWS_SUM_CASES])
def test_rows_sum_model_is_the_plain_version(S, inner, u32):
    """The lane-major model reproduces ``gather_rows_sum_plain`` bit for
    bit, on indices that are negative, at least S and at the int32
    extremes; every scratch entry is written once; the probe's 8 terms
    read 2 or 3 vectors an output, inside the row."""
    rng = np.random.RandomState(S * 10 + inner)
    R, C = 21, 40
    idx = rng.randint(-5 * S, 5 * S, (R, C)).astype(np.int32)
    idx.flat[::7] = np.iinfo(np.int32).min
    idx.flat[3::11] = np.iinfo(np.int32).max
    if u32:
        table = rng.randint(0, 2 ** 32, (S, C), dtype=np.uint64) \
            .astype(np.uint32)
        want = dynamic_gather.gather_rows_sum_plain(
            _t(table.view(np.int32)), _t(idx), inner).numpy().view(np.uint32)
    else:
        table = rng.randn(S, C).astype(np.float32)
        want = dynamic_gather.gather_rows_sum_plain(_t(table), _t(idx),
                                                    inner).numpy()
    out, written, vectors = rows_sum_model(table, idx, inner)
    assert (written == 1).all()
    np.testing.assert_array_equal(out, want)
    if inner == ROWS_SUM_VECTOR:
        assert set(np.unique(vectors)) <= {2, 3}
    assert dynamic_gather.rows_sum_route(inner) == (
        "lane-major, 16-byte vectors" if inner == ROWS_SUM_VECTOR
        else "lane-major, loop over k")


@pytest.mark.parametrize("S", [16, 19])
def test_take_lanes_matches_jax(S):
    """probe_axis1 of tools/probe_dynamic_gather.py (:94-97), at (S, 128),
    in-range indices as ``promise_in_bounds`` requires."""

    def kernel(table_ref, idx_ref, out_ref):
        out_ref[:, :] = jnp.take_along_axis(
            table_ref[:, :], idx_ref[:, :], axis=1,
            mode="promise_in_bounds")

    tab = np.random.RandomState(0).rand(S, 128).astype(np.float32)
    idx = np.random.RandomState(1).randint(0, 128, (S, 128)).astype(np.int32)
    want = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((S, 128), jnp.float32),
        in_specs=[VMEM, VMEM], out_specs=VMEM,
        interpret=True)(jnp.asarray(tab), jnp.asarray(idx))
    got = dynamic_gather.take_lanes(_t(tab), _t(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_take_lanes_takes_any_int32_mod_128():
    """The port's lane take on the CPU reads out-of-range int32 indices
    (negative, >= 128, the extremes) modulo 128, as the kernel's
    ``idx & 127`` does."""
    tab = np.random.RandomState(0).randn(4, 128).astype(np.float32)
    idx = np.random.RandomState(1).randint(-2 ** 31, 2 ** 31, (4, 128),
                                           dtype=np.int64).astype(np.int32)
    idx[0, :4] = [-1, 128, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    got = dynamic_gather.take_lanes(_t(tab), _t(idx)).numpy()
    np.testing.assert_array_equal(got, np.take_along_axis(tab, idx & 127, 1))
    np.testing.assert_array_equal(got[0, :4], tab[0, [127, 0, 0, 127]])


# take_lanes128_kernel's block (kTakeWarps in csrc/probes.cu;
# test_roll_and_box_models_constants_match_the_kernel holds it to the source)
TAKE_WARPS = 4


def take_lanes_model(tab, idx):
    """numpy model of take_lanes128_kernel (csrc/probes.cu), the lane take
    of (R, 128) rows: ceil(R / TAKE_WARPS) blocks of min(R, TAKE_WARPS)
    warps, warp w of block b on row b * TAKE_WARPS + w. Lane i loads the
    row's 16-byte table vector i and index vector i and stores the table
    vector into slot i of its warp's 128-float shared row; after
    ``__syncwarp`` each of its four outputs is row[idx & 127] (the int32's
    two's complement). Returns (out, how often each element of out is
    written)."""
    R, C = tab.shape
    assert C == 128 and idx.dtype == np.int32
    threads = min(R, TAKE_WARPS) * 32
    blocks = -(-R // TAKE_WARPS)
    tv, iv = tab.reshape(R, 32, 4), idx.reshape(R, 32, 4)
    out = np.full((R, 32, 4), np.nan, np.float32)
    writes = np.zeros((R, 32, 4), np.int64)
    for b in range(blocks):
        smem = np.full((TAKE_WARPS, 32, 4), np.nan, np.float32)
        for w in range(threads // 32):
            row = b * TAKE_WARPS + w
            if row >= R:    # the whole warp leaves
                continue
            smem[w] = tv[row]       # every lane its slot, then __syncwarp
            out[row] = smem[w].reshape(128)[iv[row] & 127]
            writes[row] += 1
    return out.reshape(R, C), writes.reshape(R, C)


@pytest.mark.parametrize("rows", [1, 3, 8, 19, 128])
def test_take_lanes_model_is_the_floor_mod_take(rows):
    """Indices negative, >= 128 and at the int32 extremes: the model gives
    ``take_along_axis`` at idx mod 128 and the port's plain version, every
    output element written once, the rows of a last, partial block too."""
    rng = np.random.RandomState(rows)
    tab = rng.randn(rows, 128).astype(np.float32)
    idx = rng.randint(-1000, 1000, (rows, 128)).astype(np.int32)
    idx.flat[::5] = np.iinfo(np.int32).min
    idx.flat[2::7] = np.iinfo(np.int32).max
    idx.flat[3::11] = rng.randint(-2 ** 31, 2 ** 31, idx.flat[3::11].size,
                                  dtype=np.int64)
    out, writes = take_lanes_model(tab, idx)
    want = np.take_along_axis(tab, idx % 128, 1)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(
        out, dynamic_gather.take_lanes_plain(_t(tab), _t(idx)).numpy())
    assert (writes == 1).all()


# -- P8 / P9 / P10 / P12 ------------------------------------------------------------

@pytest.fixture(scope="module")
def caps_calls():
    return _record(probe_pallas_caps.main)


@pytest.fixture(scope="module")
def caps2_calls():
    return _record(probe_pallas_caps2.main)


def _check_body(calls, i, wrapper):
    _, (x,), want = calls[i]
    got = wrapper(_t(x))
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


CAPS = [pallas_caps.f16_pack, pallas_caps.lane_swap, pallas_caps.roll64,
        pallas_caps.reshape_slices, pallas_caps.qshift,
        pallas_caps.iota_mask, pallas_caps.f16_unpack]
CAPS2 = [pallas_caps2.store16, pallas_caps2.rolls_sum,
         pallas_caps2.narrow_pad, pallas_caps2.regroup,
         pallas_caps2.offset_copy]


@pytest.mark.parametrize("i", range(len(CAPS)),
                         ids=[f.__name__ for f in CAPS])
def test_caps_bodies_match_jax(caps_calls, i):
    """tools/probe_pallas_caps.py's seven bodies, in the order main runs
    them, on its inputs: bit-exact."""
    assert len(caps_calls) == len(CAPS)
    _check_body(caps_calls, i, CAPS[i])


@pytest.mark.parametrize("i", range(len(CAPS2)),
                         ids=[f.__name__ for f in CAPS2])
def test_caps2_bodies_match_jax(caps2_calls, i):
    """tools/probe_pallas_caps2.py's four bodies and its dynamic-offset
    copy (grid 4 x 8 rows of a (64, 128) input): bit-exact."""
    assert len(caps2_calls) == len(CAPS2)
    _check_body(caps2_calls, i, CAPS2[i])


def test_f16_pack_rounds_to_nearest_even():
    """Halfway cases, overflow and subnormals convert as XLA converts."""
    x = np.array([[1 + 2 ** -11, 1 + 3 * 2 ** -11, 65520.0, 2 ** -25,
                   -2 ** -24 * 1.5, 1e-8, -0.0, 70000.0]], np.float32)
    with np.errstate(over="ignore"):
        h = x.astype(np.float16)
    b = h.view(np.uint16).astype(np.uint32)
    want = ((b << 16) | b).view(np.int32)
    np.testing.assert_array_equal(pallas_caps.f16_pack(_t(x)).numpy(), want)
    back = pallas_caps.f16_unpack(pallas_caps.f16_pack(_t(x)).view(
        torch.float32))
    np.testing.assert_array_equal(back.numpy(), h.astype(np.float32))


def test_roll_direction_matches_jax():
    """tools/probe_shadow_debug.py roll_semantics: out[0] = x[127]."""
    calls = _record(probe_shadow_debug.roll_semantics)
    (_, (x,), want), = calls
    got = shadow_debug.roll1(_t(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0] == 127


# roll128_kernel's block (kRollWarps in csrc/probes.cu;
# test_roll_and_box_models_constants_match_the_kernel holds it to the source)
ROLL_WARPS = 8


def roll_model(x, shift):
    """numpy model of roll128_kernel (csrc/probes.cu), the lane roll of
    (R, 128) rows: ceil(R / ROLL_WARPS) blocks of min(R, ROLL_WARPS) warps,
    one warp per row, lane i holding the row's 16-byte vector i. With
    s = shift mod 128 = 4 q + m, lane i takes the vectors of lanes
    (i - q) mod 32 and (i - q - 1) mod 32 (``__shfl_sync``, every lane of
    the warp active) and keeps the last m elements of the second and the
    first 4 - m of the first. Returns (out, how often each element of out
    is written)."""
    R, C = x.shape
    assert C == 128
    s = shift & 127
    q, m = s >> 2, s & 3
    threads = min(R, ROLL_WARPS) * 32
    blocks = -(-R // ROLL_WARPS)
    vec = x.reshape(R, 32, 4)
    out = np.full((R, 32, 4), np.nan, np.float32)
    writes = np.zeros((R, 32, 4), np.int64)
    lanes = np.arange(32)
    for b in range(blocks):
        for w in range(threads // 32):
            row = b * ROLL_WARPS + w
            if row >= R:    # the whole warp leaves
                continue
            hi = vec[row, (lanes - q) & 31]
            r = hi
            if m:
                lo = vec[row, (lanes - q - 1) & 31]
                r = np.concatenate([lo[:, 4 - m:], hi[:, :4 - m]], axis=1)
            out[row] = r
            writes[row] += 1
    return out.reshape(R, C), writes.reshape(R, C)


@pytest.mark.parametrize("rows", [8, 3, 19])
def test_roll_model_is_jnp_roll_at_every_shift(rows):
    """Every shift 0-127 and past 127 (s mod 4 picking the elements, the
    two source lanes the vectors): np.roll's result, every output element
    written once, including the rows of a last, partial block."""
    x = np.random.RandomState(rows).randn(rows, 128).astype(np.float32)
    for shift in list(range(128)) + [128, 129, 200, 255, 256, 1000003]:
        out, writes = roll_model(x, shift)
        np.testing.assert_array_equal(out, np.roll(x, shift, 1),
                                      err_msg=f"shift {shift}")
        assert (writes == 1).all()


@pytest.mark.parametrize("shift", [-1, -3, -4, -5, -64, -127, -128, -129,
                                   -(2 ** 31)])
def test_roll_model_negative_shifts(shift):
    """Negative shifts: the launcher's ``shift & 127`` is the floor mod."""
    x = np.random.RandomState(1).randn(8, 128).astype(np.float32)
    out, writes = roll_model(x, shift)
    np.testing.assert_array_equal(out, np.roll(x, shift, 1))
    assert (writes == 1).all()


@pytest.mark.parametrize("shape,shift", [((8, 128), 3), ((8, 128), -5),
                                         ((8, 100), 1), ((3, 100), -5),
                                         ((2, 300), 299)])
def test_roll_lanes_matches_jnp_roll(shape, shift):
    """The roll at any shift and width (the plain version on the CPU)
    against jnp.roll, and the route the card takes: the shuffle only for
    16-byte-aligned 128-lane rows."""
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    got = pallas_caps.roll_lanes(_t(x), shift)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.roll(x, shift, 1)))
    flat = torch.as_tensor(np.random.RandomState(3).randn(
        shape[0] * shape[1] + 1).astype(np.float32))
    mis = flat[1:].reshape(shape)
    assert pallas_caps.roll_route(mis) == "lane loop"
    want = "warp shuffle" if shape[1] == 128 else "lane loop"
    assert pallas_caps.roll_route(_t(x)) == want
    np.testing.assert_array_equal(pallas_caps.roll_lanes(mis, shift).numpy(),
                                  np.roll(mis.numpy(), shift, 1))
    with pytest.raises(ValueError, match="not an int32"):
        pallas_caps.roll_lanes(_t(x), 2 ** 31)


# rolls_sum128_kernel's rolls: shift -> (q, m), shift = 4 q + m, in the
# plain version's order (the kernel's roll_vec calls)
ROLLS_SUM_QM = {1: (0, 1), 15: (3, 3), 16: (4, 0), 48: (12, 0)}


def rolls_sum_model(x):
    """numpy model of rolls_sum128_kernel (csrc/probes.cu): the warp
    mapping of ``roll_model`` at shifts 1, 15, 16 and 48 (each its
    ``roll_vec``, s = 4 q + m), summed in that order, one f32 rounding an
    add. Returns (out, how often each element of out is written)."""
    rolls, writes = [], None
    for shift, (q, m) in ROLLS_SUM_QM.items():
        assert shift == 4 * q + m
        r, w = roll_model(x, shift)
        rolls.append(r)
        writes = w
    a, b, c, d = rolls
    return ((a + b) + c) + d, writes


@pytest.mark.parametrize("rows", [1, 3, 16, 19])
def test_rolls_sum_model_is_the_plain_version(rows):
    """Standard normal rows: bit-equal to ``rolls_sum_plain``, every
    output element written once."""
    x = np.random.RandomState(rows).randn(rows, 128).astype(np.float32)
    out, writes = rolls_sum_model(x)
    np.testing.assert_array_equal(
        out, pallas_caps2.rolls_sum_plain(_t(x)).numpy())
    assert (writes == 1).all()


def _jax_narrow(x):
    """tools/probe_pallas_caps2.py k_narrow (:52-56) at any width C >= 16:
    x[:, :16] + roll(x, 16)[:, :16], zero-padded back to C lanes
    (pltpu.roll has jnp.roll's direction: test_roll_direction_matches_jax)."""
    n = x[:, :16] + jnp.roll(x, 16, 1)[:, :16]
    return np.asarray(jnp.pad(n, ((0, 0), (0, x.shape[1] - 16))))


# narrow_pad128_kernel's roll: 16 = 4 q + m
NARROW_QM = (4, 0)


def narrow_pad_model(x):
    """numpy model of narrow_pad128_kernel (csrc/probes.cu): the warp and
    block mapping of ``roll_model``, lane L holding the row's 16-byte
    vector L and taking lane (L - 4) & 31's (the roll by 16, s = 4 q + m
    at NARROW_QM), lanes 0-3 storing their own vector plus that one, lanes
    4-31 zeros. Returns (out, how often each element of out is written)."""
    R, C = x.shape
    q, m = NARROW_QM
    assert C == 128 and 4 * q + m == 16 and m == 0
    threads = min(R, ROLL_WARPS) * 32
    blocks = -(-R // ROLL_WARPS)
    vec = x.reshape(R, 32, 4)
    out = np.full((R, 32, 4), np.nan, np.float32)
    writes = np.zeros((R, 32, 4), np.int64)
    lanes = np.arange(32)
    for b in range(blocks):
        for w in range(threads // 32):
            row = b * ROLL_WARPS + w
            if row >= R:
                continue
            r = vec[row, (lanes - q) & 31]
            out[row] = np.where((lanes < 4)[:, None], vec[row] + r,
                                np.float32(0))
            writes[row] += 1
    return out.reshape(R, C), writes.reshape(R, C)


@pytest.mark.parametrize("rows", [1, 3, 16, 19])
def test_narrow_pad_model_is_the_plain_version(rows):
    """Standard normal rows: bit-equal to ``narrow_pad_plain`` and to the
    tool's k_narrow form in JAX, every output element written once."""
    x = np.random.RandomState(rows).randn(rows, 128).astype(np.float32)
    out, writes = narrow_pad_model(x)
    np.testing.assert_array_equal(
        out, pallas_caps2.narrow_pad_plain(_t(x)).numpy())
    np.testing.assert_array_equal(out, _jax_narrow(x))
    assert (writes == 1).all()


def test_narrow_pad_model_constants_match_the_kernel():
    """The launcher takes the warp form only for 16-byte-aligned 128-lane
    rows, and the kernel rolls by the model's (q, m) and keeps lanes 0-3."""
    src = open(os.path.join(ROOT, "segfusion_tpu_torch", "csrc",
                            "probes.cu")).read()
    routes = src[src.index("int launch_roll_routes("):]
    routes = routes[:routes.index("\n}\n")]
    assert "if (C == 128 && aligned16(x, out)) {" in routes
    assert "warp_rows(rows, kRollWarps)" in routes
    launcher = src[src.index('extern "C" int sf_probe_narrow_pad('):]
    launcher = launcher[:launcher.index("\n}\n")]
    assert ("launch_roll_routes(narrow_pad128_kernel, narrow_pad_kernel, "
            "x, out,") in launcher
    q, m = NARROW_QM
    assert f"const float4 r = roll_vec(v, lane, {q}, {m});" in src
    assert ("out[i] = lane < 4 ? add4(v, r) : make_float4(0.0f, 0.0f, 0.0f, "
            "0.0f);") in src


@pytest.mark.parametrize("form", ["contiguous", "misaligned", "100 lanes"])
def test_warp_routes_need_aligned_128_lanes(form):
    """The lane take, the four-roll sum and the narrow pad take their warp
    forms only for 128 lanes at a 16-byte-aligned address (a view 4 bytes
    past a boundary and 100 lanes loop over the lanes); on the CPU all
    three match JAX there (``jnp.take_along_axis`` at idx mod C, the four
    ``jnp.roll``s, the tool's k_narrow form)."""
    R, C = 16, 100 if form == "100 lanes" else 128
    shift = 1 if form == "misaligned" else 0
    rng = np.random.RandomState(5)
    flat = torch.tensor(rng.randn(R * C + shift).astype(np.float32))
    x = flat[shift:].view(R, C)
    raw = torch.tensor(rng.randint(-2 ** 31, 2 ** 31, R * C + shift,
                                   dtype=np.int64).astype(np.int32))
    idx = raw[shift:].view(R, C)
    aligned = torch.tensor(rng.randint(0, C, (R, C)).astype(np.int32))
    warp = form == "contiguous"
    assert (x.data_ptr() % 16 == 0) == (form != "misaligned")
    assert pallas_caps.roll_route(x) == ("warp shuffle" if warp
                                         else "lane loop")
    assert dynamic_gather.take_lanes_route(x, aligned) == (
        "warp per row" if warp else "lane loop")
    assert dynamic_gather.take_lanes_route(
        torch.zeros((R, C)), idx) == ("warp per row" if warp
                                      else "lane loop")
    xn, ixn = x.numpy(), idx.numpy()
    want = np.asarray(jnp.take_along_axis(jnp.asarray(xn),
                                          jnp.asarray(ixn % C), axis=1))
    np.testing.assert_array_equal(dynamic_gather.take_lanes(x, idx).numpy(),
                                  want)
    want = np.asarray(jnp.roll(xn, 1, 1) + jnp.roll(xn, 15, 1)
                      + jnp.roll(xn, 16, 1) + jnp.roll(xn, 48, 1))
    np.testing.assert_array_equal(pallas_caps2.rolls_sum(x).numpy(), want)
    np.testing.assert_array_equal(pallas_caps2.narrow_pad(x).numpy(),
                                  _jax_narrow(xn))


def test_roll_and_box_models_constants_match_the_kernel():
    """The models' block shapes are the kernels' constants, the launchers
    take the shuffle (and the lane take its warp form) only for
    16-byte-aligned 128-lane rows, the roll reduces the shift with
    ``& 127`` and the four-roll sum calls the roll at the model's (q, m)
    in the model's order, the lane take picks ``idx & 127`` from its
    warp's shared row, the box's TMA and unrolled side is the
    probe's 64, and the TMA tile's box and expected bytes and the start
    that takes thread loads are the model's."""
    src = open(os.path.join(ROOT, "segfusion_tpu_torch", "csrc",
                            "probes.cu")).read()
    for name, value in (("kRollWarps", ROLL_WARPS),
                        ("kTakeWarps", TAKE_WARPS),
                        ("kBoxThreads", BOX_THREADS),
                        ("kBoxUnrolled", BOX_UNROLLED)):
        assert f"constexpr int {name} = {value};" in src
    assert "const cuuint32_t box[3] = {kBoxThreads, 1, kBoxUnrolled};" in src
    assert "float tile[kB * kBoxThreads];" in src
    assert "mbar_expect_tx(b, sizeof(tile));" in src
    assert "if (z0 & 3) {" in src
    assert "if (C == 128 && aligned) {" in src
    assert "const int s = shift & 127;" in src
    # the lane take: a warp's shared row, idx & 127, the same route rule
    assert "__shared__ float4 smem[kTakeWarps][32];" in src
    assert ("out[i] = make_float4(r[k.x & 127], r[k.y & 127], r[k.z & 127],\n"
            "                       r[k.w & 127]);") in src
    assert "if (C == 128 && aligned16(table, idx, out)) {" in src
    # the four-roll sum: roll_vec at the model's (q, m), summed in order
    assert "if (C == 128 && aligned16(x, out)) {" in src
    q_m = [f"roll_vec(v, lane, {q}, {m})" for q, m in ROLLS_SUM_QM.values()]
    assert ("out[i] = add4(add4(add4({}, {}),\n"
            "                     {}),\n"
            "                {});").format(*q_m) in src
    assert "out[i] = roll_vec(x[i], lane, q, m);" in src
    assert ("if (B == kBoxUnrolled && SZ % 4 == 0 &&\n"
            "      reinterpret_cast<uintptr_t>(vol) % 16 == 0) {") in src
    assert random_access.BOX_UNROLLED == BOX_UNROLLED


# -- P11 --------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["strided", "flat"])
def test_window_copies_match_jax(form):
    """tools/probe_pallas_caps3.py _win_kernel (:27) / _flat_kernel (:40)
    in its own calls (:66, :82), at a (40, 28, 128) source with 4 copies:
    bit-exact."""
    RY, G, WY, WG, REPS = 40, 28, 10, 7, 4
    rng = np.random.RandomState(0)
    x3 = rng.rand(RY, G, 128).astype(np.float32)
    offs = np.zeros(2 * REPS, np.int32)
    if form == "strided":
        offs[0::2] = rng.randint(0, RY - WY, REPS)
        offs[1::2] = rng.randint(0, G - WG, REPS)
        kernel = functools.partial(probe_pallas_caps3._win_kernel, R=RY,
                                   WY=WY, WG=WG, REPS=REPS)
        out_rows, scratch, src = WG, (WY, WG, 128), x3
    else:
        offs[0::2] = rng.randint(0, RY * G - WY * WG, REPS)
        kernel = functools.partial(probe_pallas_caps3._flat_kernel,
                                   R=RY * G, WN=WY * WG, REPS=REPS)
        out_rows, scratch, src = WY * WG, (WY * WG, 128), \
            x3.reshape(RY * G, 128)
    want = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(1,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((out_rows, 128), lambda i, s: (0, 0)),
            scratch_shapes=[pltpu.VMEM(scratch, jnp.float32),
                            pltpu.SemaphoreType.DMA]),
        out_shape=jax.ShapeDtypeStruct((out_rows, 128), jnp.float32),
        interpret=True)(jnp.asarray(offs), jnp.asarray(src))
    if form == "strided":
        got = pallas_caps3.window_copy(_t(src), _t(offs), WY, WG)
    else:
        got = pallas_caps3.flat_copy(_t(src), _t(offs), WY * WG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def window_model(src3, offs, wa, wb, out_rows, parts=None):
    """numpy model of window_copy_kernel (csrc/probes.cu) on an (A, B, 128)
    source: the grid (parts, n_win), parts = ``window_parts`` unless given;
    block (p, k) holds window k's rows l in [l0, l1) (l = a wb + b; the
    parts split the wa wb rows as evenly as they go) from the offsets
    clamped into the source. Lane t of warp 0 issues one bulk copy per run
    of rows contiguous in the source: the whole part where wb == B, else
    the part's share of a = l0 // wb + t, + 32, ... Only the last window's
    blocks write their rows below out_rows. Returns (out, how often each
    row of each window lands in a block, the shared memory a block asks
    for, the number of blocks that write the output)."""
    A, B = src3.shape[:2]
    src2 = src3.reshape(A * B, 128)
    n_win = len(offs) // 2
    rows = wa * wb
    parts = parts or pallas_caps3.window_parts(wa, wb)
    q, rem = divmod(rows, parts)
    smem = 16 + -(-rows // parts) * 512
    landed = np.zeros((n_win, rows), np.int64)
    out = np.full((out_rows, 128), np.nan, np.float32)
    writers = 0
    for k in range(n_win):
        oa = min(max(int(offs[2 * k]), 0), A - wa)
        ob = min(max(int(offs[2 * k + 1]), 0), B - wb)
        for p in range(parts):
            l0 = p * q + min(p, rem)
            l1 = l0 + q + (p < rem)
            assert l1 > l0
            runs = [(l0, l1)] if wb == B else []
            for lane in range(32 if wb != B else 0):
                a = l0 // wb + lane
                while a * wb < l1:
                    runs.append((a * wb + max(l0 - a * wb, 0),
                                 a * wb + min(l1 - a * wb, wb)))
                    a += 32
            part = np.full((l1 - l0, 128), np.nan, np.float32)
            copied = 0
            for r0, r1 in runs:
                a, b = divmod(r0, wb)
                assert wb == B or (r1 - 1) // wb == a   # one a a run
                first = (oa + a) * B + ob + b
                part[r0 - l0:r1 - l0] = src2[first:first + r1 - r0]
                landed[k, r0:r1] += 1
                copied += (r1 - r0) * 512
            assert copied == (l1 - l0) * 512   # the barrier's bytes
            if k == n_win - 1 and l0 < out_rows:
                n = min(l1, out_rows) - l0
                out[l0:l0 + n] = part[:n]
                writers += 1
    return out, landed, smem, writers


# (form, source (A, B), window, offsets): windows of 10 and 57 a-rows (not
# divisible by 2 or 4), offsets past each face, a strided window as wide
# as the source (one run), a tiny one, flat windows of 70 and 405 rows
WINDOW_CASES = [
    ("strided", (40, 28), (10, 7), [-5, -3, 99, 30, 30, 21, 3, 2]),
    ("strided", (60, 28), (57, 7), [2, 24, -1, 40, 9, 4]),
    ("strided", (40, 28), (9, 28), [5, 3, -1, 0, 39, 0]),
    ("strided", (40, 28), (3, 5), [2, 24, 7, -9]),
    ("flat", (1120, 1), (70, 1), [-7, 0, 10 ** 6, 0, 1050, 0, 5, 0]),
    ("flat", (1120, 1), (405, 1), [-7, 0, 10 ** 6, 0, 700, 0]),
]


@pytest.mark.parametrize("parts", [1, 2, 4, None],
                         ids=["P1", "P2", "P4", "rule"])
@pytest.mark.parametrize("case", range(len(WINDOW_CASES)),
                         ids=[f"{f}{w}" for f, _, w, _ in WINDOW_CASES])
def test_window_model_copies_each_row_once(case, parts):
    """Every row of every window lands in exactly one block, each run is
    contiguous in the source and the runs fill the barrier's bytes, the
    shared memory fits, and the output is the plain version's (the last
    window, or its first row block for the strided form), written by the
    last window's blocks that hold it."""
    form, (A, B), (wa, wb), offs = WINDOW_CASES[case]
    src3 = np.random.RandomState(case).rand(A, B, 128).astype(np.float32)
    offs = np.array(offs, np.int32)
    out_rows = wb if form == "strided" else wa
    out, landed, smem, writers = window_model(src3, offs, wa, wb, out_rows,
                                              parts)
    assert (landed == 1).all()
    assert smem <= _SMEM_BYTES
    n_parts = parts or pallas_caps3.window_parts(wa, wb)
    q, rem = divmod(wa * wb, n_parts)
    assert writers == sum(p * q + min(p, rem) < out_rows
                          for p in range(n_parts))
    if form == "strided":
        want = pallas_caps3.window_copy_plain(_t(src3), _t(offs), wa, wb)
    else:
        want = pallas_caps3.flat_copy_plain(_t(src3[:, 0]), _t(offs), wa)
    np.testing.assert_array_equal(out, want.numpy())


def test_rows_sum_and_window_models_constants_match_the_kernel():
    """The models' constants are the kernels': P6's vector of 8 terms, its
    tiles, the scratch's padding rule (checked by the launcher) and the
    pick by r mod 4; P11's rows a block, its split of a window's rows and
    the shared memory it asks for; the probe's windows split 8 ways and
    the largest part fits shared memory."""
    src = open(os.path.join(ROOT, "segfusion_tpu_torch", "csrc",
                            "probes.cu")).read()
    for name, value in (("kRowsSumVector", ROWS_SUM_VECTOR),
                        ("kLaneTile", LANE_TILE), ("kTileRows", TILE_ROWS),
                        ("kWindowPartRows", pallas_caps3.WINDOW_PART_ROWS)):
        assert f"constexpr int {name} = {value};" in src
    assert dynamic_gather.ROWS_SUM_VECTOR == ROWS_SUM_VECTOR
    assert "const int n_valid = S + (inner > 0 ? inner : 1) - 1;" in src
    assert "if (P % 4 != 0 || P < n_valid || S < 1 ||" in src
    assert "const int m = r & 3;" in src
    assert "const uint4 c = m ? __ldg(v + 2) : make_uint4(0u, 0u, 0u, 0u);" \
        in src
    assert ("const int l0 = p * q + min(p, rem), l1 = l0 + q + (p < rem);"
            in src)
    assert ("const int parts = (rows + kWindowPartRows - 1) / "
            "kWindowPartRows;") in src
    assert ("16 + static_cast<size_t>(rows + parts - 1) / parts * 512"
            in src)
    assert "for (int a = l0 / WB + t; a * WB < l1; a += 32) {" in src
    assert pallas_caps3.window_parts(58, 7) == 8
    assert 16 + pallas_caps3.WINDOW_PART_ROWS * 512 <= _SMEM_BYTES
    assert dynamic_gather.lane_major_width(32768, 8) == 32776
    assert dynamic_gather.lane_major_width(9, 0) == 12


# -- the probes' entry points on the CPU ------------------------------------------

@pytest.mark.parametrize("module", [
    "shadow_debug", "pallas_caps", "pallas_caps2", "dynamic_gather",
    "pallas_caps3", "random_access"])
def test_probe_main_runs_on_cpu(module, capsys):
    """Each probe's ``main(device="cpu")``: the plain versions, the tool's
    checks, and "not measured" in place of every time."""
    import importlib
    importlib.import_module(f"segfusion_tpu_torch.probes.{module}").main(
        device="cpu")
    out = capsys.readouterr().out
    assert "device: cpu" in out
    assert " ms" not in out and "ns/elem" not in out


def test_shadow_variants_main_runs_on_cpu(capsys):
    shadow_variants.main(device="cpu", shape=(6, 8, 40))
    out = capsys.readouterr().out
    assert "not measured (cpu)" in out and "TY sweep" in out
