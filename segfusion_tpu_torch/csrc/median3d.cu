// Hopper kernel for the 3-D median filter of the label volume
// (segfusion_tpu_torch, Database.filter_semantics).
//
// Replaces the Pallas TPU kernel median_filter3d_pallas
// (segfusion_tpu/ops/pallas/median3d.py:104, body _median_kernel :65,
// radix select _radix_median_axis0 :34). Same result: for every voxel of
// a uint8 (X, Y, Z) volume, the (size^3 / 2)-th smallest (0-indexed) value
// of its size^3 neighbourhood, edge-replicated (index clamping at the
// volume's own faces; no padded copy is made). Exact for every uint8
// volume at sizes 3 and 5.
//
// What bounds it on an H100: integer instructions, not bytes. At 448^3
// the minimum traffic is 90 MB read and 90 MB written (~0.05 ms at
// 3.35 TB/s). A bitwise radix select takes up to 8 passes over the 125
// neighbours of each voxel; one byte at a time that is 1,000 shared-memory
// byte loads and ~1,000 compare-adds per voxel, and the shared loads
// alone would take most of the time.
//
// Design. Four voxels per 32-bit word: a thread owns the 4 z-consecutive
// outputs of one word (z0 a multiple of 4) in each of TX x-planes.
// - Staging: a block of TZW x TY = 16 x 16 threads stages its tile plus
//   halo, (TX + 2R) x (TY + 2R) rows of 4 + 64 + 4 bytes along z, in
//   shared memory with 16-byte loads (byte loads only where a 16-byte
//   chunk crosses a face of the volume or Z is no multiple of 16; every
//   coordinate clamped to the volume). The loads go through registers,
//   not cp.async, so that the block also ORs every staged byte.
// - Each neighbour byte is read from shared memory once per voxel quad:
//   for each (dx, dy) column three aligned words are read once, packed by
//   two byte permutes into the 8 bytes z - R .. z + 7 - R, and kept in
//   registers across the passes (50 words at size 5); each dz window is a
//   funnel shift of that pair. That is 75 shared loads per quad and plane
//   at size 5, ~19 per voxel.
// - Counting in byte lanes (the prefix form of the radix select): with m
//   the running median (bits above b decided, bits b..0 zero) and L the
//   count of neighbours below m, the count below m + 2^b is L plus the
//   neighbours v with v >> b == m >> b. For b >= 1 each dz window is
//   funnel-shifted b bits further and masked to (8 - b)-bit fields, so
//   one LOP3 gives (v >> b) ^ (m >> b) in every byte; adding the field
//   mask sets the field's carry bit iff it is non-zero (no carry leaves
//   the byte), and those carry flags add up in the byte lanes for up to
//   2^b - 1 neighbours before one shift moves them down into the count:
//   about three integer-pipe instructions per packed neighbour word at the
//   high bits, four at b = 1. For b = 0 the whole bytes: x = v ^ M and bit
//   7 of ((x | 0x80808080) - 0x01010101) | x. Counts stay below 128 (at
//   most 125), so the byte-lane sums never carry, and the compare of
//   L + count with the rank is made in the byte lanes too.
// - Passes that cannot change the result are skipped: where bit b lies
//   above the highest set bit of the block's OR, every neighbour is
//   below m + 2^b (m is still 0), the count is size^3 > rank and bit b
//   stays 0. On 30 label classes that removes 3 of the 8 passes.
// - 256 threads at most 128 registers (__launch_bounds__ asks for two
//   blocks per SM), so 16 warps per SM hide the latency.
// The integer pipe is the limit. Moving work onto IMAD (the FMA pipe),
// one or three blocks per SM, 4 x-planes a block or 8 y-rows were tried
// and made it no faster.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TZW = 16;  // threadIdx.x: words along z (64 voxels)
constexpr int TY = 16;   // threadIdx.y
constexpr int TX = 8;    // x-planes per block, a loop in each thread
constexpr int kThreads = TZW * TY;
// tile row: words 3 .. 20 hold z0 - 4 .. z0 + 67 (word j: z0 + 4 (j - 4)),
// so the 16-byte chunks of words 4 .. 19 sit on 16-byte boundaries; a row
// stride of 48 words (16 mod 32) keeps the two y-rows of a warp on
// disjoint banks
constexpr int kRowWords = 48;
constexpr int kFirstWord = 4;

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// bytes z .. z + 3 of a row, each z clamped into [0, Z)
__device__ __forceinline__ uint32_t clamped_word(const uint8_t* row, int z,
                                                 int Z) {
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w |= static_cast<uint32_t>(row[clampi(z + k, Z - 1)]) << (8 * k);
  return w;
}

// The dz window j (bytes j .. j + 3 of the pair lo:hi, j <= 4) shifted
// `shift` bits further.
__device__ __forceinline__ uint32_t window_at(uint32_t lo, uint32_t hi, int j,
                                              int shift) {
  return j == 4 ? hi >> shift : __funnelshift_r(lo, hi, 8 * j + shift);
}

// Per byte lane: how many of the S^3 neighbours differ from the median m
// (packed in M) at bit BIT or above, i.e. have (v ^ m) >= 2^BIT.
template <int S, int BIT>
__device__ __forceinline__ uint32_t count_differing(const uint32_t* lo,
                                                    const uint32_t* hi,
                                                    uint32_t M) {
  uint32_t nz = 0;
  if constexpr (BIT == 0) {
    // whole bytes: bit 7 of ((x | 0x80) - 1) | x says x != 0
#pragma unroll
    for (int k = 0; k < S * S; ++k) {
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const uint32_t x = window_at(lo[k], hi[k], j, 0) ^ M;
        const uint32_t u = (x | 0x80808080u) - 0x01010101u;
        nz += ((u | x) & 0x80808080u) >> 7;
      }
    }
  } else {
    // the bits BIT..7 of each byte as an (8 - BIT)-bit field: the window
    // shifted BIT bits further and masked. A field is non-zero iff adding
    // F sets its carry bit W (no carry leaves the byte); the W flags add
    // up in the byte lanes until (2^BIT - 1) of them could overflow one,
    // then move down into nz (1-bit fields, BIT = 7, are their own flag)
    constexpr uint32_t F = (0xFFu >> BIT) * 0x01010101u;
    constexpr uint32_t W = (0x100u >> BIT) * 0x01010101u;
    constexpr int kHold = (1 << BIT) - 1;
    const uint32_t Mb = (M >> BIT) & F;
    uint32_t flags = 0;
    int held = 0;
#pragma unroll
    for (int k = 0; k < S * S; ++k) {
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const uint32_t f = (window_at(lo[k], hi[k], j, BIT) ^ Mb) & F;
        if constexpr (BIT == 7) {
          flags += f;
        } else {
          flags += (f + F) & W;
        }
        if (++held == kHold) {
          nz += flags >> (BIT == 7 ? 0 : 8 - BIT);
          flags = 0;
          held = 0;
        }
      }
    }
    nz += flags >> (BIT == 7 ? 0 : 8 - BIT);
  }
  return nz;
}

// One pass of the radix select (bit BIT, then the lower bits): with the
// count of neighbours below m + 2^BIT, L plus those sharing m's prefix,
// at most the rank, the lane's median has bit BIT set. Skipped where BIT
// lies above `top`, the highest bit of the block's staged bytes.
template <int S, int BIT>
__device__ __forceinline__ void select_bit(const uint32_t* lo,
                                           const uint32_t* hi, int top,
                                           uint32_t& M, uint32_t& L) {
  constexpr int K = S * S * S, RANK = K / 2;
  if (BIT <= top) {   // uniform over the block
    const uint32_t below =
        L + (K * 0x01010101u - count_differing<S, BIT>(lo, hi, M));
    const uint32_t over =
        ((below | 0x80808080u) - (RANK + 1) * 0x01010101u) & 0x80808080u;
    const uint32_t take = ((over ^ 0x80808080u) >> 7) * 0xFFu;
    M |= take & (0x01010101u << BIT);
    L = (L & ~take) | (below & take);
  }
  if constexpr (BIT > 0) select_bit<S, BIT - 1>(lo, hi, top, M, L);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 2)
median3d_u8_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                   int X, int Y, int Z, int vec_in, int vec_out) {
  constexpr int S = 2 * R + 1;
  constexpr int PX = TX + 2 * R, PY = TY + 2 * R;
  // bytes (4 - R) .. (7 - R) of the pair (a, b): z - R .. z + 3 - R
  constexpr unsigned SEL = R == 2 ? 0x5432u : 0x6543u;
  static_assert(R == 1 || R == 2, "sizes 3 and 5");
  __shared__ __align__(16) uint32_t tile[PX * PY * kRowWords];
  __shared__ uint32_t warp_or[kThreads / 32];

  const int z0 = blockIdx.x * (4 * TZW), y0 = blockIdx.y * TY;
  const int x0 = blockIdx.z * TX;
  const int tid = threadIdx.y * TZW + threadIdx.x;
  uint32_t seen = 0;   // OR of every byte this thread stages

  // the 64 bytes z0 .. z0 + 63 of each row, as four 16-byte chunks
  for (int i = tid; i < PX * PY * 4; i += kThreads) {
    const int row = i >> 2, q = i & 3;
    const int gx = clampi(x0 + row / PY - R, X - 1);
    const int gy = clampi(y0 + row % PY - R, Y - 1);
    const uint8_t* src = in + (static_cast<long long>(gx) * Y + gy) * Z;
    const int zc = z0 + 16 * q;
    uint4 v;
    if (vec_in && zc + 16 <= Z) {
      v = __ldg(reinterpret_cast<const uint4*>(src + zc));
    } else {
      v.x = clamped_word(src, zc, Z);
      v.y = clamped_word(src, zc + 4, Z);
      v.z = clamped_word(src, zc + 8, Z);
      v.w = clamped_word(src, zc + 12, Z);
    }
    seen |= v.x | v.y | v.z | v.w;
    *reinterpret_cast<uint4*>(tile + row * kRowWords + kFirstWord + 4 * q) =
        v;
  }
  // the halo words z0 - 4 .. z0 - 1 and z0 + 64 .. z0 + 67
  for (int i = tid; i < PX * PY * 2; i += kThreads) {
    const int row = i >> 1, side = i & 1;
    const int gx = clampi(x0 + row / PY - R, X - 1);
    const int gy = clampi(y0 + row % PY - R, Y - 1);
    const uint32_t w = clamped_word(
        in + (static_cast<long long>(gx) * Y + gy) * Z,
        side ? z0 + 4 * TZW : z0 - 4, Z);
    seen |= w;
    tile[row * kRowWords + (side ? kFirstWord + TZW : kFirstWord - 1)] = w;
  }
  seen = __reduce_or_sync(0xffffffffu, seen);
  if ((tid & 31) == 0) warp_or[tid >> 5] = seen;
  __syncthreads();

  uint32_t all = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) all |= warp_or[w];
  all = (all | (all >> 8) | (all >> 16) | (all >> 24)) & 0xFFu;
  // highest bit any staged byte sets; -1: every byte is 0
  const int top = all ? 31 - __clz(all) : -1;

  const int zw = threadIdx.x, ty = threadIdx.y;
  const int y = y0 + ty, zb = z0 + 4 * zw;
  if (y >= Y || zb >= Z) return;

#pragma unroll 1
  for (int lx = 0; lx < TX && x0 + lx < X; ++lx) {
    // each (dx, dy) column: the 8 bytes z - R .. z + 7 - R of the quad's
    // neighbourhood as two words, read from shared memory once
    uint32_t lo[S * S], hi[S * S];
#pragma unroll
    for (int dx = 0; dx < S; ++dx)
#pragma unroll
      for (int dy = 0; dy < S; ++dy) {
        const uint32_t* w = tile + ((lx + dx) * PY + ty + dy) * kRowWords
                            + kFirstWord - 1 + zw;
        const uint32_t a = w[0], b = w[1], c = w[2];
        lo[dx * S + dy] = __byte_perm(a, b, SEL);
        hi[dx * S + dy] = __byte_perm(b, c, SEL);
      }

    uint32_t M = 0, L = 0;   // per byte lane: median so far, count below it
    select_bit<S, 7>(lo, hi, top, M, L);

    uint8_t* dst = out + (static_cast<long long>(x0 + lx) * Y + y) * Z + zb;
    if (vec_out && zb + 4 <= Z) {
      *reinterpret_cast<uint32_t*>(dst) = M;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (zb + k < Z) dst[k] = static_cast<uint8_t>(M >> (8 * k));
    }
  }
}

template <int R>
void launch(const uint8_t* in, uint8_t* out, int X, int Y, int Z,
            cudaStream_t stream) {
  const dim3 block(TZW, TY);
  const dim3 grid((Z + 4 * TZW - 1) / (4 * TZW), (Y + TY - 1) / TY,
                  (X + TX - 1) / TX);
  // 16-byte loads need every row start on 16 bytes, word stores on 4
  const int vec_in = Z % 16 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;
  const int vec_out = Z % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  median3d_u8_kernel<R><<<grid, block, 0, stream>>>(in, out, X, Y, Z, vec_in,
                                                    vec_out);
}

}  // namespace

// Median of every edge-replicated size^3 neighbourhood of the contiguous
// uint8 (X, Y, Z) volume `in` into `out` (same shape), on `stream`.
// size is 3 or 5; the wrapper checks shapes and the grid limits
// (ceil(Y / 16) and ceil(X / 8) at most 65535). Returns cudaGetLastError().
extern "C" int sf_median3d_u8(const void* in, void* out, int X, int Y, int Z,
                              int size, void* stream) {
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (size) {
    case 3: launch<1>(src, dst, X, Y, Z, s); break;
    case 5: launch<2>(src, dst, X, Y, Z, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
