// Hopper kernels for the hardware probes (segfusion_tpu_torch/probes/).
//
// Each kernel here replaces one Pallas TPU probe kernel of tools/ and
// computes the same function, so the probes can ask this card the
// questions the TPU probes asked that one: what a copy with the shadow
// build's access pattern costs, how fast a gather from or a scatter-add
// into on-chip memory runs, and what a strided window copy costs against
// the same bytes contiguous. The modules under probes/ hold the wrappers
// (which check device, dtype, shape and contiguity) and a plain PyTorch
// version beside each kernel.
//
// Conventions: every launcher is extern "C", takes raw pointers, sizes and
// a cudaStream_t, launches on that stream without synchronising, and
// returns cudaGetLastError(). Element-wise kernels run one thread per
// output element (256 threads a block); sizes are the wrapper's to check.
// The kernels use no fast-math: sums keep the order of the plain versions,
// so every kernel is bit-exact to its plain version except the two whose
// order the card does not fix (scatter_add: distributed shared-memory
// atomics; noted there).
//
// Per-kernel notes, in the order of the probe modules:
//
// P1 dma_only_kernel <- tools/probe_shadow_variants.py dma_only (:91, body
//    dma_only_kernel :57). out[x, y*GK + gk, :] = bits of
//    geo[(x * YS + y + 1) * G + 2 gk, :] (YS = Y + 2 as in the TPU probe),
//    zero where 2 gk >= G: the shadow build's reads and writes with no
//    arithmetic. Bound: bytes, half the geo rows read and the shadow
//    written once (2.88 GB at 448^3, 0.86 ms at 3.35 TB/s). Design: one
//    thread per 16-byte output vector, neighbouring threads on neighbouring
//    lanes, so each warp reads and writes 512 contiguous bytes; each thread
//    reads only the row it writes.
// P2 gather_smem_kernel <- tools/probe_random_access.py
//    probe_pallas_scalar_gather (:89, body :94). out[i] = table[idx[i]]
//    with the table held on chip (indices outside it read 0). Bound: every
//    block that gathers needs the whole table in its shared memory, so
//    each SM it runs on receives the table (128 KiB at the probe's 32^3);
//    measured on the H100, one SM takes it in at ~90 GB/s (bulk copy and
//    thread loads together; the bulk copy alone ~77 GB/s), so the launch,
//    one round trip for the indices and ~1.4 us of staging are the floor,
//    while the bytes that must move (table, indices, output) take 0.2 us
//    at 3.35 TB/s. Design: kGatherBlocks blocks of kGatherThreads, one
//    16-byte index vector a thread, loaded first so it is in flight while
//    the table lands; thread 0 starts the TMA's 1-D bulk copy of the
//    table's 16-byte-aligned body (cp.async.bulk on an mbarrier expecting
//    its bytes) before the block's first barrier, the block's threads load
//    the body's last 3/8 and the ragged head and tail (a table at any
//    4-byte phase keeps that phase in shared memory) meanwhile, then the
//    gather and 16-byte stores. Measured and dropped (PERF.md): the
//    bulk copy alone (~0.3 us slower) and a thread-block cluster that
//    multicasts each block's slice to all (less L2 traffic, ~2 us more in
//    cluster launch and barriers at every grid).
// P3 gather_smem_kernel / gather_global_kernel <- probe_random_access.py
//    probe_pallas_vector_take (:123, body :128). The same function in the
//    TPU's vector form. A table that fits in shared memory (232,416 B:
//    the opt-in less the barrier's 16-byte slot and 16 for the phase)
//    takes P2's kernel; a larger one (64^3 f32, 1 MiB) is gathered
//    straight from device memory, which the 50 MB L2 holds after the
//    first touch (gather_global_kernel). Bound: the launch (the bytes,
//    1 MiB of table reads at most and 0.5 MiB of indices and output,
//    take 0.23 us at 3.35 TB/s), then two dependent round trips: the
//    index, then the entry; and every 4-byte entry costs a 32-byte L2
//    sector (2 MiB of sectors at 65,536 random indices). Design: the
//    first one, one thread an output (launch_flat: blocks of 256), one
//    index load, then one read-only entry load (LDG.E.CONSTANT). A
//    redesign was measured on the H100 (PERF.md) and dropped, 24 forms
//    in all: 2, 4 or 8 indices a thread (all index loads, then all
//    table loads, then the stores; 16-byte index vectors and stores for
//    4 and 8), 64, 128 or 256 threads a block, L2-only table loads
//    (ld.global.cg). At the 64^3 table 4 a thread read 0.06-0.2 us
//    slower, 8 a thread 0.07-0.5 us, 2 as fast as 1 or slower, L2-only
//    loads never faster by more than 0.004 us; 32-bit index math with
//    an early exit past n read 0.01-0.02 us slower than this form at the
//    probe's 65,536 indices (0.03 us faster at 999). A thread's loads in
//    flight do not pace the kernel: the random sectors do (65,536
//    indices in order, or all one index, take ~0.44 us less), then the
//    two round trips.
// P4 scatter_add_kernel <- probe_random_access.py probe_pallas_scalar_rmw
//    (:157, body :162). out = 0; out[idx[i]] += upd[i], accumulated in
//    on-chip memory as the TPU probe accumulated in VMEM. Bound: bytes
//    (the indices and updates read once, the output written once: 0.65 MB,
//    0.2 us at 65,536 updates into 32 K bins) and, at the probe's size,
//    latency: the launch, the barriers, the atomics. A private copy of
//    all bins per block would be zeroed and scanned whole in every block
//    and need global atomics and a memset to combine. Design: one launch
//    of one thread-block cluster (kCluster blocks) whose distributed
//    shared memory holds the bins once, a slice of ceil(n_out / kCluster)
//    bins per block, zeroed by its owner. Each round, every block reads
//    its next 4,096 updates with coalesced loads and buckets them by owner
//    block in its own shared memory (a local count, a prefix, a place);
//    after a cluster barrier every block pulls its bucket from every
//    block's stage (cluster.map_shared_rank, four loads in flight a
//    thread) and adds it into its slice with local shared-memory atomics;
//    a second barrier frees the stages. Remote atomicAdd into the owner's
//    slice, one per update, was slower. At the end each block writes its
//    slice with 16-byte stores: the output is written once, with no global
//    atomic and no memset. n_out is at most kCluster times what a block
//    holds beside its stage. The order of the float adds is not the TPU
//    loop's and not fixed: exact where every partial sum is exact (the
//    probe's all-ones updates, counts below 2^24), within a stated
//    tolerance on random updates.
// P5 box_sum_tma_kernel / box_sum_kernel <- probe_random_access.py
//    probe_box_dma (:194, body :200). out[y, z] = sum over x < B of
//    vol[x0 + x, y0 + y, z0 + z], the start read from device memory and
//    clamped into the volume as lax.dynamic_slice clamps. Bound: the
//    launch, then two dependent round trips (the start, then the box, which
//    L2 holds between calls: 1 MiB at the probe's 64^3, 0.3 us at 3.35
//    TB/s) and the 63 dependent adds of a column, whose order is the plain
//    version's (x from 0) and so is not split. Design: a block is one warp
//    over 32 neighbouring z of one y row, so the probe's 4,096 columns
//    spread over 128 blocks; every thread loads the start first
//    (read-only broadcast loads). At the probe's B = 64 (kBoxUnrolled),
//    where the volume's rows are whole 16-byte units and the clamped
//    start's z is 16-byte aligned, thread 0 issues the Hopper counterpart
//    of the TPU's box DMA, one 3-D TMA tile load of the block's (64, 1,
//    32) box into shared memory on an mbarrier, and each thread sums its
//    column from there; at any other start, and on other volumes at B =
//    64, each thread unrolls the 64 loads of its column in registers; any
//    other B loops over x. Measured and dropped (PERF.md): the unrolled
//    thread loads at every start (~0.06 us slower than the tile), a (64,
//    1, 36) tile at a z rounded down to 16 bytes (two 128-byte lines a
//    row: slower than the thread loads) and a block per y row (64
//    blocks; ~0.25 us slower).
// P6 lane_major_kernel + gather_rows_sum_kernel <-
//    tools/probe_dynamic_gather.py probe (:25, body :26). out[i, j] = sum
//    over k < inner of table[(idx[i, j] + k) mod S, j], in order of k from
//    0, for f32 and for u32 (a wrapping add). Bound: the indices read, the
//    output written and the table entries touched read once (15 us at S =
//    32,768). What held the first design (one thread per output reading
//    table[(b + k) mod S, j] down a column) was sectors, not bytes: its
//    8 loads lie 512 bytes apart, each its own 32-byte L2 sector, 1.07 GB
//    of L2 traffic for a 16 MiB table (0.25 ms on the H100). Design: two
//    launches. The first writes the table lane-major into a scratch the
//    wrapper allocates, (C, S + inner - 1 rounded up to 4), each lane's
//    row ending with its first inner - 1 entries again so no window wraps
//    (kLaneTile-square tiles through shared memory, coalesced both ways).
//    The second takes one output a thread, lanes along the grid's x and
//    rows along its y (no division; one 32-bit floor mod of the index),
//    and reads the output's inner entries, now side by side in one or two
//    sectors: at the probe's 8 terms (kRowsSumVector) as the 2 or 3
//    aligned 16-byte vectors over them, else one at a time. Measured on
//    the H100 (PERF.md): about a third of the first design's time, the
//    transpose the smaller share; the loop at 8 terms about as fast as
//    the vectors (sectors, not instructions, pace it). Not built: a
//    shared-memory route for tables of at most 454 rows of 128 lanes
//    (none of the probe's sizes but 8 and 64).
// P7 take_lanes128_kernel / take_lanes_kernel <- probe_dynamic_gather.py
//    probe_axis1 (:91, body :94). out[i, j] = table[i, idx[i, j] mod C].
//    Bound: the launch (128 KiB at the probe's (128, 128), 0.05 us at 3.35
//    TB/s), so only what lies between the launch and the store counts. The
//    first design, one thread an element, made two dependent round trips
//    (the index, then the table) and two 64-bit divisions (the row, the
//    floor mod) an element. Design: for 128-lane rows at 16-byte-aligned
//    addresses, one warp a row (kTakeWarps rows a block), each lane loading
//    its table and index vectors together, so one round trip; the table
//    vectors go into the warp's row of shared memory and each output is
//    row[idx & 127], with no division. Measured and dropped (PERF.md):
//    four __shfl_sync of the row's vectors an output in place of the
//    shared row (16 exchanges and the selects: slower at every size) and
//    8 warps a block (slightly slower). Any other width or alignment
//    loops over the lanes as roll_lanes_kernel does, with a 32-bit floor
//    mod.
// P8 f16_pack / lane_swap / roll128 / reshape_slices / qshift /
//    iota_mask / f16_unpack <- tools/probe_pallas_caps.py tryk (:19),
//    bodies :36-91: lane and row permutations and the f16 pack and unpack
//    (round to nearest even, __float2half_rn, as XLA converts). roll64 is
//    P12's lane roll at shift 64.
// P9 store16 / rolls_sum / narrow_pad / regroup <- tools/probe_pallas_caps2.py
//    tryk (:18), bodies :34-66. rolls_sum (k_rolls :42) sums four lane rolls
//    in the plain version's order; bound: the launch (8 KiB at (16, 128)).
//    Its first design took one thread an element, with two 64-bit divisions
//    and four 64-bit floor mods. Design: P12's shuffle roll four times in
//    one pass (rolls_sum128_kernel: a warp a 128-lane row, one load, the
//    four rolls by roll_vec, one store); other widths and alignments take
//    a lane loop with four 32-bit floor mods a thread. narrow_pad (k_narrow
//    :52, x[:, :16] + roll(x, 16)[:, :16], zero-padded back to C) had the
//    same first design (one 64-bit division and one 64-bit floor mod an
//    element) and has the same bound (8 KiB at (16, 128)). Design: the
//    same routes, one roll_vec by 16 (narrow_pad128_kernel: lanes 0-3 add
//    the vectors of lanes 28-31, the others store zeros) and a lane loop
//    with one 32-bit floor mod a thread; 1.18 us at (16, 128) against the
//    first design's 1.66 on the H100 (PERF.md), no other form tried.
// P10 offset_copy_kernel <- probe_pallas_caps2.py main (:30, call :82, body
//    k_dma :73): block k copies rows [k R, k R + R) at its dynamic offset
//    and adds 1. Bound: the launch (16 KiB move in 0.01 us). Design: one
//    16-byte vector a thread, one load and one store, with no other
//    arithmetic where x is 16-byte aligned and R C a multiple of 4 (a
//    template of its own); a misaligned x or a ragged block takes scalar
//    heads and tails. The TPU body's form, a bulk copy of the block's rows
//    into shared memory on an mbarrier, was measured and dropped (~0.14 us
//    slower; PERF.md).
// P11 window_copy_kernel <- tools/probe_pallas_caps3.py main (:51; bodies
//    _win_kernel :27 and _flat_kernel :40): n windows of (WA, WB, 128) f32
//    at dynamic offsets (the contiguous form is WB = 1), each copied
//    on chip; the output is the first out_rows 128-lane rows of the last
//    window's copy. Bound: bytes, the union of the windows read once and
//    the output written (3.4 us at the probe's (58, 7, 128)). The TPU ran
//    one DMA per window, one after another; the first design here copied
//    each window by one block of 1,024 threads, one 16-byte load in flight
//    a thread and 64-bit index math, and windows larger than shared memory
//    through a device-memory scratch. Design: the TMA. Each window splits
//    into blocks of at most kWindowPartRows rows (8 at the probe's 406),
//    so the copies spread over the card; lane 0 of each block reads the
//    window's offsets (the one round trip), clamps them and arms an
//    mbarrier with the part's bytes, and the lanes of warp 0 issue one
//    bulk copy (cp.async.bulk) per run of rows contiguous in src: the
//    whole part where WB == B, else its share of each a. Larger windows
//    take more blocks the same way, so nothing goes through device memory.
//    Only the last window's blocks write the output, 16 bytes a thread.
//    Measured on the H100 (PERF.md): one, two, four, eight and sixteen
//    blocks a probe window; eight is within 0.15 us of the best for both
//    forms, the flat one paced also by its 208 KB output leaving the SMs
//    of the last window's blocks.
// P12 roll128_kernel / roll_lanes_kernel (shift 1) <-
//    tools/probe_shadow_debug.py roll_semantics (:17, call :23):
//    out[:, l] = x[:, (l - s) mod C], jnp.roll's direction, which compiled
//    pltpu.roll has. Bound: the launch (4 KiB at the probe's (8, 128)), so
//    only the instructions before the one load count. Design: for 128-lane
//    rows at 16-byte-aligned addresses, one warp per row and one 16-byte
//    vector a lane: each lane takes the vectors of two lanes by
//    __shfl_sync and keeps elements by s mod 4 (the same in the whole
//    warp), with no division (roll_vec, which P9's rolls_sum and
//    narrow_pad share); any other width or alignment loops over the lanes
//    (one thread a lane, rows along the grid's y).
// What bounds P8-P10 and P12 at the probes' sizes (4-64 KiB) is the launch
// itself; they are there to hold the TPU bodies' semantics, not to be fast.
// noop_kernel, an empty block, measures that launch floor on the card.

#include <cooperative_groups.h>
#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at
                    // run time (box_tensor_map), so nothing links libcuda
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBigThreads = 1024;
// the most dynamic shared memory one block can have on sm_90
constexpr int kMaxSmem = 232448;

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

__device__ __forceinline__ long long tid() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

// the floor mod of an int32 by m > 0 (INT32_MIN included), in 32 bits
__device__ __forceinline__ int floor_mod32(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// 128-lane rows, one warp a row, one 16-byte vector a lane (P7, P8 roll64,
// P9 rolls_sum and narrow_pad, P12): the warps of a block of the roll
// kernels and of the lane take
constexpr int kRollWarps = 8;
constexpr int kTakeWarps = 4;

__device__ __forceinline__ float4 shfl4(float4 v, int lane) {
  return make_float4(__shfl_sync(0xffffffffu, v.x, lane),
                     __shfl_sync(0xffffffffu, v.y, lane),
                     __shfl_sync(0xffffffffu, v.z, lane),
                     __shfl_sync(0xffffffffu, v.w, lane));
}

// Lane ``lane``'s vector of its warp's 128-lane row rolled by s = 4 q + m
// in [0, 128) (out[l] = x[(l - s) mod 128]), every lane active and q, m the
// same in the whole warp: the last m elements of lane (lane - q - 1) mod
// 32's vector v and the first 4 - m of lane (lane - q) mod 32's.
__device__ __forceinline__ float4 roll_vec(float4 v, int lane, int q, int m) {
  const float4 hi = shfl4(v, (lane - q) & 31);
  if (m == 0) return hi;
  const float4 lo = shfl4(v, (lane - q - 1) & 31);
  return m == 1 ? make_float4(lo.w, hi.x, hi.y, hi.z)
         : m == 2 ? make_float4(lo.z, lo.w, hi.x, hi.y)
                  : make_float4(lo.y, lo.z, lo.w, hi.x);
}

// Opt a kernel in to the full dynamic shared memory, once per launcher
// (``done`` is the launcher's own flag), so that a launch captured into a
// CUDA graph makes no attribute call.
template <typename K>
cudaError_t allow_smem(K kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done = err == cudaSuccess;
  return err;
}

// -- P1 -----------------------------------------------------------------------

__global__ void dma_only_kernel(const uint4* __restrict__ geo,
                                uint4* __restrict__ out, int Y, int G, int GK,
                                int YS, long long n_vec) {
  const long long t = tid();
  if (t >= n_vec) return;
  const int v = static_cast<int>(t & 31);   // 32 vectors per 128-lane row
  const long long row = t >> 5;
  const int gk = static_cast<int>(row % GK);
  const long long xy = row / GK;
  const int y = static_cast<int>(xy % Y);
  const long long x = xy / Y;
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (2 * gk < G) val = geo[((x * YS + y + 1) * G + 2 * gk) * 32 + v];
  out[t] = val;
}

// -- TMA bulk copies and mbarriers (P2, P3, P5) ------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// an mbarrier expecting one arrival (the issuing thread's expect_tx),
// made visible to the async proxy (the fence's only scope is the cluster)
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// wait for the completion of the barrier's first phase (parity 0)
__device__ __forceinline__ void mbar_wait0(uint32_t bar) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n\t"
      "@!p bra WAIT;\n}" ::"r"(bar)
      : "memory");
}

// global -> this block's shared memory, `bytes` (a multiple of 16, both
// addresses 16-aligned), completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// -- P2 / P3 ------------------------------------------------------------------

// the grid of the shared-route gather (at most; fewer blocks where the
// indices' 16-byte vectors fill fewer), and the eighths of the table's
// body the block's threads load beside the bulk copy
constexpr int kGatherBlocks = 32;
constexpr int kGatherThreads = 512;
constexpr int kGatherThreadEighths = 3;
// 16-byte table loads a thread keeps in flight in its share of the staging
constexpr int kStageBatch = 4;

// indices outside the table read 0 (the plain version raises there)
__device__ __forceinline__ float take1(const float* tab, int n_table, int j) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(n_table) ? tab[j]
                                                                   : 0.0f;
}

// Dynamic shared memory: a 16-byte slot for the mbarrier, then the table at
// the same phase modulo 16 as in device memory (tab = smem + 16 + phase).
// The table splits into a head of up to 3 floats before its first 16-byte
// boundary, a body of `units` 16-byte units and a tail of up to 3 floats.
// Thread 0 bulk-copies the body's first `bulk` units; the block's threads
// load its last units - bulk (3/8 of n_table / 4) and the head and tail
// themselves while the copy lands. Indices go as 16-byte vectors (vec_idx:
// idx and out 16-aligned), the first one a thread loaded before the wait,
// then a scalar tail of n % 4.
__global__ void __launch_bounds__(kGatherThreads)
gather_smem_kernel(const float* __restrict__ table, int n_table,
                   const int* __restrict__ idx, float* __restrict__ out,
                   long long n, int vec_idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int phase = static_cast<int>(reinterpret_cast<uintptr_t>(table) & 15);
  float* tab = reinterpret_cast<float*>(smem + 16 + phase);
  const int head = min(((16 - phase) & 15) >> 2, n_table);
  const int units = (n_table - head) >> 2;
  const int tail0 = head + 4 * units;
  const int bulk =
      units - min(n_table / 4 * kGatherThreadEighths / 8, units);
  const uint32_t bar = smem_addr(smem);
  const int t = threadIdx.x;
  const long long nvec = vec_idx ? n >> 2 : 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long v0 = tid();
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  float4* out4 = reinterpret_cast<float4*>(out);
  // the first index vector is in flight while the table lands
  const int4 first = v0 < nvec ? idx4[v0] : make_int4(0, 0, 0, 0);
  if (t == 0 && bulk > 0) {
    mbar_init(bar);
    mbar_expect_tx(bar, static_cast<uint32_t>(bulk) * 16);
    bulk_load(smem_addr(tab + head), table + head,
              static_cast<uint32_t>(bulk) * 16, bar);
  }
  // the threads' share of the body (16-byte loads, kStageBatch in flight
  // a thread) and the head and tail, while the bulk copy lands
  const float4* body = reinterpret_cast<const float4*>(table + head);
  float4* tab_body = reinterpret_cast<float4*>(tab + head);
  for (int u = bulk + t; u < units; u += kStageBatch * blockDim.x) {
    float4 r[kStageBatch];
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int w = u + k * blockDim.x;
      if (w < units) r[k] = body[w];
    }
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int w = u + k * blockDim.x;
      if (w < units) tab_body[w] = r[k];
    }
  }
  for (int i = t; i < head + n_table - tail0; i += blockDim.x) {
    const int j = i < head ? i : tail0 + i - head;
    tab[j] = table[j];
  }
  __syncthreads();   // the barrier's init, the threads' own table stores
  if (bulk > 0) mbar_wait0(bar);
  for (long long v = v0; v < nvec; v += stride) {
    const int4 j = v == v0 ? first : idx4[v];
    out4[v] = make_float4(take1(tab, n_table, j.x), take1(tab, n_table, j.y),
                          take1(tab, n_table, j.z), take1(tab, n_table, j.w));
  }
  for (long long i = 4 * nvec + v0; i < n; i += stride)
    out[i] = take1(tab, n_table, idx[i]);
}

__global__ void gather_global_kernel(const float* __restrict__ table,
                                     int n_table, const int* __restrict__ idx,
                                     float* __restrict__ out, long long n) {
  const long long i = tid();
  if (i >= n) return;
  const int j = idx[i];
  out[i] = static_cast<unsigned>(j) < static_cast<unsigned>(n_table)
               ? table[j] : 0.0f;
}

// -- P4 -----------------------------------------------------------------------

// The grid is one cluster of kCluster blocks; block `rank` owns
// bins [rank * slice, (rank + 1) * slice) (slice a multiple of 4) at the
// head of its dynamic shared memory, followed by its stage (one round's
// kPerThread updates a thread, as (bin in the owner's slice, value bits),
// bucketed by owner block), the buckets' counts and starts, and the
// counts and starts of this block's buckets in every stage.
constexpr int kCluster = 16;   // the non-portable maximum: 16 beat 8
constexpr int kPerThread = 4;

__global__ void __launch_bounds__(kBigThreads)
scatter_add_kernel(const int* __restrict__ idx, const float* __restrict__ upd,
                   long long n, float* __restrict__ out, int n_out,
                   int slice) {
  extern __shared__ __align__(16) float bins[];
  int2* stage = reinterpret_cast<int2*>(bins + slice);
  int* count = reinterpret_cast<int*>(stage + blockDim.x * kPerThread);
  int* start = count + kCluster;      // of the own buckets
  int* incoming = start + kCluster;   // of the bucket for this block
  int* from = incoming + kCluster;    // in each block's stage
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int C = kCluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, nt = blockDim.x;
  for (int i = t; i < slice; i += nt) bins[i] = 0.0f;
  const long long chunk = static_cast<long long>(nt) * kPerThread;
  for (long long r0 = 0; r0 < n; r0 += chunk * C) {
    // route: each block takes the next chunk of updates (coalesced
    // loads) and buckets them by owner in its own stage
    if (t < C) count[t] = 0;
    __syncthreads();
    int key[kPerThread], pos[kPerThread];
    float val[kPerThread];
    const long long first = r0 + rank * chunk + t;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const long long i = first + static_cast<long long>(k) * nt;
      int j = i < n ? idx[i] : -1;
      if (static_cast<unsigned>(j) >= static_cast<unsigned>(n_out)) j = -1;
      key[k] = j;
      val[k] = j >= 0 ? upd[i] : 0.0f;
      pos[k] = j >= 0 ? atomicAdd(&count[j / slice], 1) : 0;
    }
    __syncthreads();
    if (t == 0)
      for (int o = 0, sum = 0; o < C; ++o) {
        start[o] = sum;
        sum += count[o];
      }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if (key[k] >= 0) {
        const int o = key[k] / slice;
        stage[start[o] + pos[k]] =
            make_int2(key[k] - o * slice, __float_as_int(val[k]));
      }
    cluster.sync();   // every block's buckets are staged
    // pull: this block's bucket from every stage in the cluster
    // (distributed shared memory), kPerThread loads in flight a thread,
    // each added into the own slice
    if (t < C) {
      incoming[t] = *cluster.map_shared_rank(count + rank, t);
      from[t] = *cluster.map_shared_rank(start + rank, t);
    }
    __syncthreads();
    int total = 0;
    for (int src = 0; src < C; ++src) total += incoming[src];
    for (int q0 = t; q0 < total; q0 += kPerThread * nt) {
      int2 e[kPerThread];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        int q = q0 + k * nt, src = 0;
        e[k].x = -1;
        if (q >= total) continue;
        while (q >= incoming[src]) q -= incoming[src++];
        e[k] = cluster.map_shared_rank(stage, src)[from[src] + q];
      }
#pragma unroll
      for (int k = 0; k < kPerThread; ++k)
        if (e[k].x >= 0) atomicAdd(&bins[e[k].x], __int_as_float(e[k].y));
    }
    cluster.sync();   // every bucket pulled before a stage is reused
  }
  const int base = rank * slice;
  const int count_out = min(slice, n_out - base);
  if (count_out <= 0) return;
  float* dst = out + base;
  const int n_vec =
      reinterpret_cast<uintptr_t>(dst) % 16 == 0 ? count_out / 4 : 0;
  for (int i = t; i < n_vec; i += nt)
    reinterpret_cast<float4*>(dst)[i] =
        reinterpret_cast<const float4*>(bins)[i];
  for (int i = 4 * n_vec + t; i < count_out; i += nt) dst[i] = bins[i];
}

// -- P5 -----------------------------------------------------------------------

// the box side of the TMA and unrolled forms (the probe's), and the
// threads of a block: one warp, over 32 neighbouring z of one y row
constexpr int kBoxUnrolled = 64;
constexpr int kBoxThreads = 32;

// one column's sum over x in order from 0, its kB loads unrolled and all
// in flight before the first add
template <int kB>
__device__ __forceinline__ float column_sum(const float* p, size_t plane) {
  float v[kB];
#pragma unroll
  for (int x = 0; x < kB; ++x) v[x] = __ldg(p + x * plane);
  float acc = 0.0f;
#pragma unroll
  for (int x = 0; x < kB; ++x) acc += v[x];
  return acc;
}

// Block (bz, y) of the grid (ceil(B / kBoxThreads), B) sums the columns
// (y, z), z in [bz kBoxThreads, bz kBoxThreads + kBoxThreads) and < B,
// over x in order from 0: column_sum at B == kB > 0, a loop at any B for
// kB == 0.
template <int kB>
__global__ void __launch_bounds__(kBoxThreads)
box_sum_kernel(const float* __restrict__ vol, int SX, int SY, int SZ,
               const int* __restrict__ pos, int B, float* __restrict__ out) {
  // the start first: the one round trip every address waits on
  const int px = __ldg(pos), py = __ldg(pos + 1), pz = __ldg(pos + 2);
  const int b = kB > 0 ? kB : B;
  const int y = blockIdx.y;
  const int z = blockIdx.x * kBoxThreads + threadIdx.x;
  if (z >= b) return;
  const int x0 = clampi(px, 0, SX - b);
  const int y0 = clampi(py, 0, SY - b);
  const int z0 = clampi(pz, 0, SZ - b);
  const size_t plane = static_cast<size_t>(SY) * SZ;
  const float* p = vol + x0 * plane + static_cast<size_t>(y0 + y) * SZ
                   + z0 + z;
  float acc = 0.0f;
  if constexpr (kB > 0) {
    acc = column_sum<kB>(p, plane);
  } else {
#pragma unroll 8
    for (int x = 0; x < b; ++x) acc += __ldg(p + x * plane);
  }
  out[y * b + z] = acc;
}

// global -> this block's shared memory: the box of ``map`` at (c0, c1, c2)
// (innermost first), completing on `bar`
__device__ __forceinline__ void tensor_load_3d(uint32_t dst,
                                               const CUtensorMap* map, int c0,
                                               int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// B == kBoxUnrolled, with ``map`` the volume as a (SZ, SY, SX) tensor
// (SZ % 4 == 0, 16-byte aligned) and a (kBoxThreads, 1, kBoxUnrolled) box.
// Block (bz, y) of the grid (2, B): where the clamped start's z is 16-byte
// aligned, thread 0 loads the block's tile (x0, y0 + y, z0 + bz
// kBoxThreads) into shared memory, one 128-byte row per x at the probe's
// start, and each thread sums its column from there over x in order; at
// any other z (a TMA copy there traps) every thread sums its column with
// column_sum, the whole grid alike.
__global__ void __launch_bounds__(kBoxThreads)
box_sum_tma_kernel(const __grid_constant__ CUtensorMap map,
                   const float* __restrict__ vol, int SX, int SY, int SZ,
                   const int* __restrict__ pos, float* __restrict__ out) {
  constexpr int kB = kBoxUnrolled;
  __shared__ __align__(128) float tile[kB * kBoxThreads];
  __shared__ __align__(8) uint64_t bar;
  const int px = __ldg(pos), py = __ldg(pos + 1), pz = __ldg(pos + 2);
  const int y = blockIdx.y;
  const int zb = blockIdx.x * kBoxThreads;   // the block's first column
  const int x0 = clampi(px, 0, SX - kB);
  const int y0 = clampi(py, 0, SY - kB);
  const int z0 = clampi(pz, 0, SZ - kB);
  float acc = 0.0f;
  if (z0 & 3) {
    const size_t plane = static_cast<size_t>(SY) * SZ;
    acc = column_sum<kB>(vol + x0 * plane + static_cast<size_t>(y0 + y) * SZ
                             + z0 + zb + threadIdx.x, plane);
  } else {
    const uint32_t b = smem_addr(&bar);
    if (threadIdx.x == 0) {
      mbar_init(b);
      mbar_expect_tx(b, sizeof(tile));
      tensor_load_3d(smem_addr(tile), &map, z0 + zb, y0 + y, x0, b);
    }
    __syncthreads();   // the barrier's init
    mbar_wait0(b);
#pragma unroll
    for (int x = 0; x < kB; ++x) acc += tile[x * kBoxThreads + threadIdx.x];
  }
  out[y * kB + zb + threadIdx.x] = acc;
}

// -- P6 / P7 ------------------------------------------------------------------

// the term count the gather-sum reads as 16-byte vectors (the probe's; any
// other loops), and the block of both P6 kernels: kLaneTile lanes by
// kTileRows rows (the transpose's tiles are kLaneTile square)
constexpr int kRowsSumVector = 8;
constexpr int kLaneTile = 32;
constexpr int kTileRows = 8;

// The lane-major copy: lm[j, s] = table[s mod S, j] for s < S + inner - 1
// (each lane's row ends with its first inner - 1 entries again, so no
// window of inner entries wraps), 0 up to the row's padded length P. A
// block transposes a kLaneTile-square tile through shared memory (one
// column of padding against bank conflicts), reading table rows and
// writing lm rows 128 bytes a warp.
template <typename T>
__global__ void __launch_bounds__(kLaneTile * kTileRows)
lane_major_kernel(const T* __restrict__ table, T* __restrict__ lm, int S,
                  int C, int P, int n_valid) {
  __shared__ T tile[kLaneTile][kLaneTile + 1];
  const int s0 = blockIdx.x * kLaneTile, j0 = blockIdx.y * kLaneTile;
  const int tx = threadIdx.x;
  for (int r = threadIdx.y; r < kLaneTile; r += kTileRows) {
    const int s = s0 + r, j = j0 + tx;
    T v = 0;
    if (s < n_valid && j < C)
      v = table[static_cast<size_t>(s < S ? s : s % S) * C + j];
    tile[r][tx] = v;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < kLaneTile; r += kTileRows) {
    const int j = j0 + r, s = s0 + tx;
    if (j < C && s < P) lm[static_cast<size_t>(j) * P + s] = tile[tx][r];
  }
}

// acc + the entry whose bits are b: an f32 add, or a wrapping u32 add
__device__ __forceinline__ float add_bits(float acc, uint32_t b) {
  return acc + __uint_as_float(b);
}
__device__ __forceinline__ uint32_t add_bits(uint32_t acc, uint32_t b) {
  return acc + b;
}

// out[i, j] = sum over k < inner of lm[j, r + k], r = idx[i, j] mod S (one
// 32-bit floor mod), added in order of k from 0. Thread (x, y) of block
// (bx, by) takes lane j = bx kLaneTile + x and rows i = by kTileRows + y
// in strides of the grid, so idx is read and out written 128 bytes a warp
// with no division. kInner == kRowsSumVector reads the window's entries
// from the 2 or 3 aligned 16-byte vectors over [r, r + 8) (inside the
// row: P is S + 7 rounded up to 4) and picks them by r mod 4; any other
// inner (kInner 0) loops over k.
template <typename T, int kInner>
__global__ void __launch_bounds__(kLaneTile * kTileRows)
gather_rows_sum_kernel(const T* __restrict__ lm, int P,
                       const int* __restrict__ idx, T* __restrict__ out,
                       int S, int C, int R, int inner) {
  const int j = blockIdx.x * kLaneTile + threadIdx.x;
  if (j >= C) return;
  const T* row = lm + static_cast<size_t>(j) * P;
  for (int i = blockIdx.y * kTileRows + threadIdx.y; i < R;
       i += gridDim.y * kTileRows) {
    const size_t e = static_cast<size_t>(i) * C + j;
    int r = __ldg(idx + e) % S;
    if (r < 0) r += S;
    T acc = 0;
    if constexpr (kInner == kRowsSumVector) {
      const int m = r & 3;
      const uint4* v = reinterpret_cast<const uint4*>(row + r - m);
      const uint4 a = __ldg(v), b = __ldg(v + 1);
      const uint4 c = m ? __ldg(v + 2) : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t w[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                              b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
      for (int k = 0; k < kRowsSumVector; ++k)
        acc = add_bits(acc, m == 0 ? w[k] : m == 1 ? w[k + 1]
                            : m == 2 ? w[k + 2] : w[k + 3]);
    } else {
      for (int k = 0; k < inner; ++k) acc = acc + __ldg(row + r + k);
    }
    out[e] = acc;
  }
}

// out[r, l] = table[r, idx[r, l] mod 128] for 128-lane rows: one warp per
// row, kTakeWarps rows a block. Each lane issues its table vector's and its
// index vector's loads together (one round trip), stores the table vector
// into its warp's 512-byte row of shared memory and, after __syncwarp,
// picks its four outputs from that row; idx & 127 is the floor mod by 128
// of every int32 (two's complement), INT32_MIN included.
__global__ void __launch_bounds__(kTakeWarps * 32)
take_lanes128_kernel(const float4* __restrict__ table,
                     const int4* __restrict__ idx, float4* __restrict__ out,
                     int rows) {
  __shared__ float4 smem[kTakeWarps][32];
  const int w = threadIdx.x >> 5;
  const int row = blockIdx.x * kTakeWarps + w;
  if (row >= rows) return;   // the whole warp
  const int lane = threadIdx.x & 31;
  const size_t i = static_cast<size_t>(row) * 32 + lane;
  const float4 v = table[i];
  const int4 k = idx[i];
  smem[w][lane] = v;
  __syncwarp();
  const float* r = reinterpret_cast<const float*>(smem[w]);
  out[i] = make_float4(r[k.x & 127], r[k.y & 127], r[k.z & 127],
                       r[k.w & 127]);
}

// out[r, l] = table[r, idx[r, l] mod C], any C: one thread a lane along the
// grid's x, rows in strides of the grid's y, a 32-bit floor mod
__global__ void take_lanes_kernel(const float* __restrict__ table,
                                  const int* __restrict__ idx,
                                  float* __restrict__ out, int rows, int C) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= C) return;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t row = static_cast<size_t>(r) * C;
    out[row + l] = table[row + floor_mod32(idx[row + l], C)];
  }
}

// -- P8 -----------------------------------------------------------------------

__global__ void f16_pack_kernel(const float* __restrict__ x,
                                uint32_t* __restrict__ out, long long n) {
  const long long e = tid();
  if (e >= n) return;
  const uint32_t b = __half_as_ushort(__float2half_rn(x[e]));
  out[e] = (b << 16) | b;
}

// concat(x[:, 64:], x[:, :64]) along the lanes
__global__ void lane_swap_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int C, long long n) {
  const long long e = tid();
  if (e >= n) return;
  const long long row = e / C;
  const int l = static_cast<int>(e % C);
  out[e] = x[row * C + (l + 64) % C];
}

// out[:, l] = x[:, (l - s) mod 128] with s = 4 q + m in [0, 128): one warp
// per row, one 16-byte vector a lane; lane i writes out[:, 4i, 4i + 4)
// (roll_vec).
__global__ void __launch_bounds__(kRollWarps * 32)
roll128_kernel(const float4* __restrict__ x, float4* __restrict__ out,
               int rows, int q, int m) {
  const int row = blockIdx.x * kRollWarps + (threadIdx.x >> 5);
  if (row >= rows) return;   // the whole warp
  const int lane = threadIdx.x & 31;
  const size_t i = static_cast<size_t>(row) * 32 + lane;
  out[i] = roll_vec(x[i], lane, q, m);
}

// out[r, l] = x[r, (l - s) mod C] with s in [0, C), any C: one thread per
// lane of the grid's x, rows in strides of the grid's y
__global__ void roll_lanes_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int rows, int C,
                                  int s) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= C) return;
  const int src = l >= s ? l - s : l - s + C;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t row = static_cast<size_t>(r) * C;
    out[row + l] = x[row + src];
  }
}

// x (4Q, 512) seen as (Q, 4, 512): w[q, c] = (v[q, 0, c] + v[q, 1, 128 + c])
// + v[q, 3, 384 + c]; out[r, c'] = w[r / 4, c' % 128]
__global__ void reshape_slices_kernel(const float* __restrict__ x,
                                      float* __restrict__ out, long long n) {
  const long long e = tid();
  if (e >= n) return;
  const long long r = e / 512;
  const int c = static_cast<int>(e % 128);
  const float* v = x + (r / 4) * 4 * 512;
  out[e] = (v[c] + v[512 + 128 + c]) + v[3 * 512 + 384 + c];
}

// x (4Q, C) seen as (Q, 4, C), shifted down one q: out[r] = x[r - 4], 0 for
// r < 4
__global__ void qshift_kernel(const float* __restrict__ x,
                              float* __restrict__ out, int C, long long n) {
  const long long e = tid();
  if (e >= n) return;
  out[e] = e < 4LL * C ? 0.0f : x[e - 4LL * C];
}

// where(q == 0, 0, x) over (Q, 4, C): the first four rows zeroed
__global__ void iota_mask_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int C, long long n) {
  const long long e = tid();
  if (e >= n) return;
  out[e] = e < 4LL * C ? 0.0f : x[e];
}

// the high 16 bits of each f32 word read as an f16, widened to f32
__global__ void f16_unpack_kernel(const uint32_t* __restrict__ x,
                                  float* __restrict__ out, long long n) {
  const long long e = tid();
  if (e >= n) return;
  out[e] = __half2float(__ushort_as_half(static_cast<uint16_t>(x[e] >> 16)));
}

// -- P9 -----------------------------------------------------------------------

// out[:, 0:16] = 2 x[:, 0:16]; out[:, 16:32] = 3 x[:, 0:16];
// out[:, 32:] = x[:, 32:]
__global__ void store16_kernel(const float* __restrict__ x,
                               float* __restrict__ out, int C, long long n) {
  const long long e = tid();
  if (e >= n) return;
  const long long row = e / C;
  const int l = static_cast<int>(e % C);
  float v;
  if (l < 16) v = x[row * C + l] * 2.0f;
  else if (l < 32) v = x[row * C + l - 16] * 3.0f;
  else v = x[e];
  out[e] = v;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// ((roll 1 + roll 15) + roll 16) + roll 48 of 128-lane rows, the plain
// version's order: one warp per row as roll128_kernel, one load, the four
// rolls by roll_vec at s = 4 q + m (1 = 4*0 + 1, 15 = 4*3 + 3, 16 = 4*4,
// 48 = 4*12), one store
__global__ void __launch_bounds__(kRollWarps * 32)
rolls_sum128_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                    int rows) {
  const int row = blockIdx.x * kRollWarps + (threadIdx.x >> 5);
  if (row >= rows) return;   // the whole warp
  const int lane = threadIdx.x & 31;
  const size_t i = static_cast<size_t>(row) * 32 + lane;
  const float4 v = x[i];
  out[i] = add4(add4(add4(roll_vec(v, lane, 0, 1), roll_vec(v, lane, 3, 3)),
                     roll_vec(v, lane, 4, 0)),
                roll_vec(v, lane, 12, 0));
}

// the same for any C: one thread a lane along the grid's x, its four
// source lanes by 32-bit floor mods once, rows along the grid's y
__global__ void rolls_sum_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int rows, int C) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= C) return;
  const int a = floor_mod32(l - 1, C), b = floor_mod32(l - 15, C);
  const int c = floor_mod32(l - 16, C), d = floor_mod32(l - 48, C);
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t row = static_cast<size_t>(r) * C;
    const float* v = x + row;
    out[row + l] = ((v[a] + v[b]) + v[c]) + v[d];
  }
}

// out[:, l] = x[:, l] + x[:, (l - 16) mod C] for l < 16, else 0, on
// 128-lane rows: one warp per row as roll128_kernel, one load, the roll by
// 16 (roll_vec at q = 4, m = 0: lane L takes lane (L - 4) & 31's vector,
// so lanes 0-3 get lanes 28-31's), added on lanes 0-3 in the plain
// version's order; lanes 4-31 store zeros
__global__ void __launch_bounds__(kRollWarps * 32)
narrow_pad128_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                     int rows) {
  const int row = blockIdx.x * kRollWarps + (threadIdx.x >> 5);
  if (row >= rows) return;   // the whole warp
  const int lane = threadIdx.x & 31;
  const size_t i = static_cast<size_t>(row) * 32 + lane;
  const float4 v = x[i];
  const float4 r = roll_vec(v, lane, 4, 0);
  out[i] = lane < 4 ? add4(v, r) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// the same for any C >= 16: one thread a lane along the grid's x, its
// source lane by one 32-bit floor mod, rows along the grid's y
__global__ void narrow_pad_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int rows, int C) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= C) return;
  const int src = floor_mod32(l - 16, C);
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t row = static_cast<size_t>(r) * C;
    out[row + l] = l < 16 ? x[row + l] + x[row + src] : 0.0f;
  }
}

// x (A, 2 H, D) -> out (A, H, D): out[a, h, d] = x[a, 2h, d] + 2 x[a, 2h+1, d]
// (x * 2 is exact, so a fused multiply-add gives the same bits)
__global__ void regroup_kernel(const float* __restrict__ x,
                               float* __restrict__ out, int D, long long n) {
  const long long e = tid();
  if (e >= n) return;
  const long long ah = e / D;
  const int d = static_cast<int>(e % D);
  const float* r = x + ah * 2 * D;
  out[e] = r[d] + r[D + d] * 2.0f;
}

// -- P10 ----------------------------------------------------------------------

// Block (k, s) of the grid (n_blocks, S) takes part s of block k's rows,
// elements [k E, (k + 1) E) at the dynamic offset k E, one 16-byte vector
// a thread. kAligned (x and out 16-aligned, E a multiple of 4): nothing
// else. Otherwise, with vec (x and out 16-aligned) the vectors start after
// a head of up to 3 floats to the first 16-byte boundary, and the head
// and the tail of up to 3 floats (every element without vec) are scalar.
template <bool kAligned>
__global__ void offset_copy_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, int block_elems,
                                   int vec) {
  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  if (kAligned) {
    const int nv = block_elems >> 2;
    if (t < nv) {
      const long long i = static_cast<long long>(blockIdx.x) * nv + t;
      float4 a = reinterpret_cast<const float4*>(x)[i];
      a.x += 1.0f;
      a.y += 1.0f;
      a.z += 1.0f;
      a.w += 1.0f;
      reinterpret_cast<float4*>(out)[i] = a;
    }
    return;
  }
  const long long base = static_cast<long long>(blockIdx.x) * block_elems;
  const int stride = gridDim.y * blockDim.x;
  const int head = vec ? min((4 - static_cast<int>(base & 3)) & 3,
                             block_elems) : 0;
  const int nv = vec ? (block_elems - head) >> 2 : 0;
  const float4* x4 = reinterpret_cast<const float4*>(x + base + head);
  float4* o4 = reinterpret_cast<float4*>(out + base + head);
  for (int v = t; v < nv; v += stride) {
    float4 a = x4[v];
    a.x += 1.0f;
    a.y += 1.0f;
    a.z += 1.0f;
    a.w += 1.0f;
    o4[v] = a;
  }
  for (int s = t; s < block_elems - 4 * nv; s += stride) {
    const long long i = base + (s < head ? s : s + 4 * nv);
    out[i] = x[i] + 1.0f;
  }
}

// -- the launch floor ---------------------------------------------------------

// does nothing: its time is what any launch costs
__global__ void noop_kernel() {}

// -- P11 ----------------------------------------------------------------------

// the most 128-lane rows (512 bytes each) one block of the window copy
// holds: a window of WA WB rows splits into ceil(WA WB / kWindowPartRows)
// parts, one block each; and the threads of a block
constexpr int kWindowPartRows = 51;
constexpr int kWindowThreads = 256;

// Block (p, k) of the grid (parts, n_win) copies part p of window k: the
// window's rows l in [l0, l1) (l = a WB + b; the parts split the WA WB
// rows as evenly as they go) from src, viewed as (A, B) rows of 128 lanes,
// at (offs[2k], offs[2k + 1]) clamped into it, into its shared memory by
// the TMA: one bulk copy per run of rows contiguous in src (the part's
// share of each a of WB rows, or the whole part where WB == B), issued by
// the lanes of warp 0 after its lanes read the offsets, all on one
// mbarrier that expects the part's bytes. In the last window's blocks
// every thread waits, then writes the part's rows below out_rows to out,
// 16 bytes a thread; in any other block only thread 0 waits (the block
// must not leave while a copy into its shared memory is in flight).
__global__ void __launch_bounds__(kWindowThreads)
window_copy_kernel(const float4* __restrict__ src, int A, int B,
                   const int* __restrict__ offs, int WA, int WB,
                   float4* __restrict__ out, int out_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* part = reinterpret_cast<float4*>(smem + 16);
  const uint32_t bar = smem_addr(smem);
  const int k = blockIdx.y, p = blockIdx.x, parts = gridDim.x;
  const int rows = WA * WB, q = rows / parts, rem = rows % parts;
  const int l0 = p * q + min(p, rem), l1 = l0 + q + (p < rem);
  const int t = threadIdx.x;
  if (t < 32) {
    const int oa = clampi(__ldg(offs + 2 * k), 0, A - WA);
    const int ob = clampi(__ldg(offs + 2 * k + 1), 0, B - WB);
    if (t == 0) {
      mbar_init(bar);
      mbar_expect_tx(bar, static_cast<uint32_t>(l1 - l0) * 512);
    }
    __syncwarp();
    const float4* win = src + (static_cast<size_t>(oa) * B + ob) * 32;
    if (WB == B) {
      if (t == 0)
        bulk_load(smem_addr(part), win + static_cast<size_t>(l0) * 32,
                  static_cast<uint32_t>(l1 - l0) * 512, bar);
    } else {
      for (int a = l0 / WB + t; a * WB < l1; a += 32) {
        const int b0 = max(l0 - a * WB, 0), b1 = min(l1 - a * WB, WB);
        bulk_load(smem_addr(part + (a * WB + b0 - l0) * 32),
                  win + (static_cast<size_t>(a) * B + b0) * 32,
                  static_cast<uint32_t>(b1 - b0) * 512, bar);
      }
    }
  }
  const bool last = k == static_cast<int>(gridDim.y) - 1;
  if (!last && t != 0) return;
  if (last) __syncthreads();   // the barrier's init
  mbar_wait0(bar);
  if (!last) return;
  const int n = (min(l1, out_rows) - l0) * 32;
  float4* dst = out + static_cast<size_t>(l0) * 32;
  for (int i = t; i < n; i += blockDim.x) dst[i] = part[i];
}

template <typename K, typename... Args>
int launch_flat(K kernel, long long n, cudaStream_t s, Args... args) {
  kernel<<<blocks_for(n), kThreads, 0, s>>>(args..., n);
  return static_cast<int>(cudaGetLastError());
}

// P6's two launches: the transpose into lm (kLaneTile-square tiles), then
// the gather-sum (lanes along the grid's x, rows along its y, at most
// 65,535 row blocks, each thread striding over the rest)
template <typename T>
int launch_rows_sum(const void* table, const int* idx, void* lm, int P,
                    void* out, int S, int C, int R, int inner, int n_valid,
                    cudaStream_t s) {
  const dim3 block(kLaneTile, kTileRows);
  const dim3 tiles((P + kLaneTile - 1) / kLaneTile,
                   (C + kLaneTile - 1) / kLaneTile);
  lane_major_kernel<T><<<tiles, block, 0, s>>>(
      static_cast<const T*>(table), static_cast<T*>(lm), S, C, P, n_valid);
  const int row_blocks = (R + kTileRows - 1) / kTileRows;
  const dim3 grid((C + kLaneTile - 1) / kLaneTile,
                  row_blocks < 65535 ? row_blocks : 65535);
  auto kernel = inner == kRowsSumVector
                    ? gather_rows_sum_kernel<T, kRowsSumVector>
                    : gather_rows_sum_kernel<T, 0>;
  kernel<<<grid, block, 0, s>>>(static_cast<const T*>(lm), P, idx,
                                static_cast<T*>(out), S, C, R, inner);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* a, const void* b,
                      const void* c = nullptr) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15) == 0;
}

struct Shape {
  dim3 grid, block;
};

// one warp a row of 128 lanes, at most ``warps`` rows a block
inline Shape warp_rows(long long rows, int warps) {
  return {dim3(static_cast<unsigned>((rows + warps - 1) / warps)),
          dim3(static_cast<unsigned>(rows < warps ? rows : warps) * 32)};
}

// the lane loops: one thread a lane along the grid's x, at most 65,535 row
// blocks along its y, each striding over the rest
inline Shape lane_loop(int C, long long rows) {
  const int threads = C < kThreads ? (C + 31) / 32 * 32 : kThreads;
  return {dim3((C + threads - 1) / threads,
               static_cast<unsigned>(rows < 65535 ? rows : 65535)),
          dim3(threads)};
}

// P9's rolled bodies on x and out (n / C, C): C == 128 with x and out
// 16-byte aligned takes the warp-shuffle kernel, anything else the lane
// loop
template <typename KWarp, typename KLoop>
int launch_roll_routes(KWarp warp, KLoop loop, const void* x, void* out,
                       int C, long long n, cudaStream_t s) {
  const long long rows = n / C;
  if (rows == 0) return 0;
  if (C == 128 && aligned16(x, out)) {
    const Shape k = warp_rows(rows, kRollWarps);
    warp<<<k.grid, k.block, 0, s>>>(static_cast<const float4*>(x),
                                    static_cast<float4*>(out),
                                    static_cast<int>(rows));
  } else {
    const Shape k = lane_loop(C, rows);
    loop<<<k.grid, k.block, 0, s>>>(static_cast<const float*>(x),
                                    static_cast<float*>(out),
                                    static_cast<int>(rows), C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define STREAM static_cast<cudaStream_t>(stream)

// P1: geo (rows, 128) f32 -> out (X * Y * GK, 128) u32 bits.
extern "C" int sf_probe_dma_only(const void* geo, void* out, int X, int Y,
                                 int G, int GK, int YS, void* stream) {
  const long long n_vec = static_cast<long long>(X) * Y * GK * 32;
  dma_only_kernel<<<blocks_for(n_vec), kThreads, 0, STREAM>>>(
      static_cast<const uint4*>(geo), static_cast<uint4*>(out), Y, G, GK, YS,
      n_vec);
  return static_cast<int>(cudaGetLastError());
}

// P2/P3, table in shared memory (16 + (table % 16) + n_table * 4 <=
// 232,448 B): at most kGatherBlocks blocks of kGatherThreads.
extern "C" int sf_probe_gather_smem(const void* table, int n_table,
                                    const void* idx, void* out, long long n,
                                    void* stream) {
  static bool opted_in = false;
  const cudaError_t err = allow_smem(gather_smem_kernel, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 16 + (reinterpret_cast<uintptr_t>(table) & 15) +
                      static_cast<size_t>(n_table) * 4;
  const int vec_idx = aligned16(idx, out);
  // one index vector a thread, on no more blocks than that fills
  const long long need = (n + 4 * kGatherThreads - 1) / (4 * kGatherThreads);
  const unsigned blocks = static_cast<unsigned>(
      need < 1 ? 1 : (need < kGatherBlocks ? need : kGatherBlocks));
  gather_smem_kernel<<<blocks, kGatherThreads, smem, STREAM>>>(
      static_cast<const float*>(table), n_table, static_cast<const int*>(idx),
      static_cast<float*>(out), n, vec_idx);
  return static_cast<int>(cudaGetLastError());
}

// P3, table in device memory.
extern "C" int sf_probe_gather_global(const void* table, int n_table,
                                      const void* idx, void* out, long long n,
                                      void* stream) {
  return launch_flat(gather_global_kernel, n, STREAM,
                     static_cast<const float*>(table), n_table,
                     static_cast<const int*>(idx), static_cast<float*>(out));
}

// P4: out (n_out,) f32, every bin written (no zeroing needed); one
// cluster of kCluster blocks, each holding ceil(n_out / kCluster) bins
// rounded up to 4, a 32 KiB stage and 256 B of bucket counts, at most
// 232,448 B together.
extern "C" int sf_probe_scatter_add(const void* idx, const void* upd,
                                    long long n, void* out, int n_out,
                                    void* stream) {
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        scatter_add_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          scatter_add_kernel,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int slice = ((n_out + kCluster - 1) / kCluster + 3) / 4 * 4;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster);
  config.blockDim = dim3(kBigThreads);
  config.dynamicSmemBytes = static_cast<size_t>(slice) * 4
                            + kBigThreads * kPerThread * 8 + kCluster * 16;
  config.stream = STREAM;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, scatter_add_kernel, static_cast<const int*>(idx),
      static_cast<const float*>(upd), n, static_cast<float*>(out), n_out,
      slice);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// P5's tensor map: vol (SX, SY, SZ) f32 as a (SZ, SY, SX) tensor with a
// (kBoxThreads, 1, kBoxUnrolled) box, encoded by libcuda's
// cuTensorMapEncodeTiled (its address fetched once through the runtime)
static cudaError_t box_tensor_map(CUtensorMap* map, const void* vol, int SX,
                                  int SY, int SZ) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(SZ),
                              static_cast<cuuint64_t>(SY),
                              static_cast<cuuint64_t>(SX)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(SZ) * 4,
                                 static_cast<cuuint64_t>(SY) * SZ * 4};
  const cuuint32_t box[3] = {kBoxThreads, 1, kBoxUnrolled};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(vol), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// P5: vol (SX, SY, SZ) f32, pos (3,) int32 on the device, out (B, B). B ==
// kBoxUnrolled takes the TMA tile where SZ % 4 == 0 and vol is 16-byte
// aligned (the tensor map's stride and base), else the unrolled thread
// loads; any other B the x loop.
extern "C" int sf_probe_box_sum(const void* vol, int SX, int SY, int SZ,
                                const void* pos, int B, void* out,
                                void* stream) {
  const dim3 grid((B + kBoxThreads - 1) / kBoxThreads, B);
  const float* v = static_cast<const float*>(vol);
  const int* p = static_cast<const int*>(pos);
  float* o = static_cast<float*>(out);
  if (B == kBoxUnrolled && SZ % 4 == 0 &&
      reinterpret_cast<uintptr_t>(vol) % 16 == 0) {
    CUtensorMap map;
    const cudaError_t err = box_tensor_map(&map, vol, SX, SY, SZ);
    if (err != cudaSuccess) return static_cast<int>(err);
    box_sum_tma_kernel<<<grid, kBoxThreads, 0, STREAM>>>(map, v, SX, SY, SZ,
                                                         p, o);
  } else if (B == kBoxUnrolled) {
    box_sum_kernel<kBoxUnrolled><<<grid, kBoxThreads, 0, STREAM>>>(
        v, SX, SY, SZ, p, B, o);
  } else {
    box_sum_kernel<0><<<grid, kBoxThreads, 0, STREAM>>>(v, SX, SY, SZ, p, B,
                                                        o);
  }
  return static_cast<int>(cudaGetLastError());
}

// P6: table (S, C), idx (R, C) int32, out like idx, lm (C, P) the
// lane-major scratch (P a multiple of 4, at least S + max(inner, 1) - 1,
// 16-byte aligned); f32, or u32 bits (is_u32) added with wraparound. Two
// launches: the transpose into lm, then the gather-sum from it.
extern "C" int sf_probe_gather_rows_sum(const void* table, const void* idx,
                                        void* lm, int P, void* out, int S,
                                        int C, int R, int inner, int is_u32,
                                        void* stream) {
  const int n_valid = S + (inner > 0 ? inner : 1) - 1;
  if (P % 4 != 0 || P < n_valid || S < 1 ||
      reinterpret_cast<uintptr_t>(lm) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0 || C == 0) return 0;
  const int* ix = static_cast<const int*>(idx);
  return is_u32 ? launch_rows_sum<uint32_t>(table, ix, lm, P, out, S, C, R,
                                            inner, n_valid, STREAM)
                : launch_rows_sum<float>(table, ix, lm, P, out, S, C, R,
                                         inner, n_valid, STREAM);
}

// P7: table (R, C) f32, idx (R, C) int32, out (R, C); C == 128 with table,
// idx and out 16-byte aligned takes a warp a row, anything else the lane
// loop.
extern "C" int sf_probe_take_lanes(const void* table, const void* idx,
                                   void* out, int C, long long n,
                                   void* stream) {
  if (n == 0) return 0;
  const long long rows = n / C;
  if (C == 128 && aligned16(table, idx, out)) {
    const Shape k = warp_rows(rows, kTakeWarps);
    take_lanes128_kernel<<<k.grid, k.block, 0, STREAM>>>(
        static_cast<const float4*>(table), static_cast<const int4*>(idx),
        static_cast<float4*>(out), static_cast<int>(rows));
  } else {
    const Shape k = lane_loop(C, rows);
    take_lanes_kernel<<<k.grid, k.block, 0, STREAM>>>(
        static_cast<const float*>(table), static_cast<const int*>(idx),
        static_cast<float*>(out), static_cast<int>(rows), C);
  }
  return static_cast<int>(cudaGetLastError());
}

// P8 bodies, on n = R * C elements.
extern "C" int sf_probe_f16_pack(const void* x, void* out, long long n,
                                 void* stream) {
  return launch_flat(f16_pack_kernel, n, STREAM, static_cast<const float*>(x),
                     static_cast<uint32_t*>(out));
}

extern "C" int sf_probe_lane_swap(const void* x, void* out, int C,
                                  long long n, void* stream) {
  return launch_flat(lane_swap_kernel, n, STREAM,
                     static_cast<const float*>(x), static_cast<float*>(out),
                     C);
}

// P8 roll64, P12: x and out (n / C, C); C == 128 with x and out 16-byte
// aligned takes the warp-shuffle kernel, anything else the lane loop.
extern "C" int sf_probe_roll_lanes(const void* x, void* out, int C, int shift,
                                   long long n, void* stream) {
  const long long rows = n / C;
  if (rows == 0) return 0;
  const bool aligned = aligned16(x, out);
  if (C == 128 && aligned) {
    const int s = shift & 127;   // the floor mod, 128 a power of two
    const Shape k = warp_rows(rows, kRollWarps);
    roll128_kernel<<<k.grid, k.block, 0, STREAM>>>(
        static_cast<const float4*>(x), static_cast<float4*>(out),
        static_cast<int>(rows), s >> 2, s & 3);
  } else {
    const int s = ((shift % C) + C) % C;
    const Shape k = lane_loop(C, rows);
    roll_lanes_kernel<<<k.grid, k.block, 0, STREAM>>>(
        static_cast<const float*>(x), static_cast<float*>(out),
        static_cast<int>(rows), C, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sf_probe_reshape_slices(const void* x, void* out, long long n,
                                       void* stream) {
  return launch_flat(reshape_slices_kernel, n, STREAM,
                     static_cast<const float*>(x), static_cast<float*>(out));
}

extern "C" int sf_probe_qshift(const void* x, void* out, int C, long long n,
                               void* stream) {
  return launch_flat(qshift_kernel, n, STREAM, static_cast<const float*>(x),
                     static_cast<float*>(out), C);
}

extern "C" int sf_probe_iota_mask(const void* x, void* out, int C,
                                  long long n, void* stream) {
  return launch_flat(iota_mask_kernel, n, STREAM,
                     static_cast<const float*>(x), static_cast<float*>(out),
                     C);
}

extern "C" int sf_probe_f16_unpack(const void* x, void* out, long long n,
                                   void* stream) {
  return launch_flat(f16_unpack_kernel, n, STREAM,
                     static_cast<const uint32_t*>(x),
                     static_cast<float*>(out));
}

// P9 bodies.
extern "C" int sf_probe_store16(const void* x, void* out, int C, long long n,
                                void* stream) {
  return launch_flat(store16_kernel, n, STREAM, static_cast<const float*>(x),
                     static_cast<float*>(out), C);
}

extern "C" int sf_probe_rolls_sum(const void* x, void* out, int C,
                                  long long n, void* stream) {
  return launch_roll_routes(rolls_sum128_kernel, rolls_sum_kernel, x, out,
                            C, n, STREAM);
}

// C >= 16
extern "C" int sf_probe_narrow_pad(const void* x, void* out, int C,
                                   long long n, void* stream) {
  return launch_roll_routes(narrow_pad128_kernel, narrow_pad_kernel, x, out,
                            C, n, STREAM);
}

extern "C" int sf_probe_regroup(const void* x, void* out, int D, long long n,
                                void* stream) {
  return launch_flat(regroup_kernel, n, STREAM, static_cast<const float*>(x),
                     static_cast<float*>(out), D);
}

// P10: n_blocks blocks of block_elems elements, x and out at least
// n_blocks * block_elems long; one 16-byte vector a thread where x and out
// are 16-aligned, else one element.
extern "C" int sf_probe_offset_copy(const void* x, void* out, int n_blocks,
                                    int block_elems, void* stream) {
  const bool aligned = aligned16(x, out);
  const int vec_units = aligned ? (block_elems + 3) / 4 : block_elems;
  const int threads = vec_units < kThreads
                          ? (vec_units + 31) / 32 * 32 : kThreads;
  const dim3 grid(n_blocks, (vec_units + threads - 1) / threads);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (aligned && block_elems % 4 == 0)
    offset_copy_kernel<true><<<grid, threads, 0, STREAM>>>(xf, of,
                                                           block_elems, 1);
  else
    offset_copy_kernel<false><<<grid, threads, 0, STREAM>>>(
        xf, of, block_elems, aligned);
  return static_cast<int>(cudaGetLastError());
}

// The launch floor: one empty block.
extern "C" int sf_probe_noop(void* stream) {
  noop_kernel<<<1, 32, 0, STREAM>>>();
  return static_cast<int>(cudaGetLastError());
}

// P11: n_win windows of (WA, WB) 128-lane rows of src (A, B, 128) f32,
// 16-byte aligned; out (out_rows, 128), out_rows <= WA WB. Each window
// splits into ceil(WA WB / kWindowPartRows) blocks.
extern "C" int sf_probe_window_copy(const void* src, int A, int B,
                                    const void* offs, int n_win, int WA,
                                    int WB, void* out, int out_rows,
                                    void* stream) {
  static bool opted_in = false;
  const cudaError_t err = allow_smem(window_copy_kernel, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = WA * WB;
  const int parts = (rows + kWindowPartRows - 1) / kWindowPartRows;
  const size_t smem = 16 + static_cast<size_t>(rows + parts - 1) / parts * 512;
  window_copy_kernel<<<dim3(parts, n_win), kWindowThreads, smem, STREAM>>>(
      static_cast<const float4*>(src), A, B, static_cast<const int*>(offs),
      WA, WB, static_cast<float4*>(out), out_rows);
  return static_cast<int>(cudaGetLastError());
}
