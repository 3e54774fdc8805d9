// Hopper kernel for the 3-D median filter of the label volume
// (segfusion_tpu_torch, Database.filter_semantics).
//
// Replaces the Pallas TPU kernel median_filter3d_pallas
// (segfusion_tpu/ops/pallas/median3d.py:104, body _median_kernel :65,
// radix select _radix_median_axis0 :34). Same result: for every voxel of
// a uint8 (X, Y, Z) volume, the (size^3 / 2)-th smallest (0-indexed) value
// of its size^3 neighbourhood, edge-replicated (index clamping at the
// volume's own faces; no padded copy is made).
//
// Design. A block of TZ x TY = 32 x 8 threads owns a TX x TY x TZ output
// tile (TX = 4 x-planes, one output per thread and plane). It stages the
// tile plus its R-voxel halo, (TX + 2R) x (TY + 2R) x (TZ + 2R) bytes, in
// shared memory with loads that run along z (consecutive threads,
// consecutive bytes), clamping each coordinate to the volume. Each thread
// then selects its median by the Pallas kernel's 8-pass bitwise radix
// select: with m = 0, for bit = 7..0, count the neighbours below
// m + 2^bit and keep that candidate while the count is <= the rank. That
// is exact for any integer values in [0, 255], so for every uint8 volume.
// (The Pallas kernel selects with n_bits = 8 too and is exact only in that
// range, though it asserts no more than an integer dtype.)
//
// What bounds it on an H100: per-voxel work, not bytes. At 448^3 the
// minimum traffic is 90 MB read and 90 MB written (~0.05 ms at
// 3.35 TB/s); the staged halo re-reads each byte ~3.4 times, from L2. The
// selection costs 8 x 125 shared-memory byte loads and about 1,000
// compare-adds per voxel (size 5). Packed-byte SIMD compares and windows
// held in registers along z are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TZ = 32;   // threadIdx.x, along z (contiguous in memory)
constexpr int TY = 8;    // threadIdx.y
constexpr int TX = 4;    // x-planes per block, a loop in each thread

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

template <int R>
__global__ void __launch_bounds__(TZ * TY)
median3d_u8_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                   int X, int Y, int Z) {
  constexpr int S = 2 * R + 1;
  constexpr int RANK = S * S * S / 2;
  constexpr int HX = TX + 2 * R, HY = TY + 2 * R, HZ = TZ + 2 * R;
  __shared__ uint8_t tile[HX * HY * HZ];

  const int z0 = blockIdx.x * TZ, y0 = blockIdx.y * TY, x0 = blockIdx.z * TX;
  for (int i = threadIdx.y * TZ + threadIdx.x; i < HX * HY * HZ;
       i += TZ * TY) {
    const int iz = i % HZ, iy = (i / HZ) % HY, ix = i / (HZ * HY);
    const int gx = clampi(x0 + ix - R, X - 1);
    const int gy = clampi(y0 + iy - R, Y - 1);
    const int gz = clampi(z0 + iz - R, Z - 1);
    tile[i] = in[(static_cast<long long>(gx) * Y + gy) * Z + gz];
  }
  __syncthreads();

  const int z = z0 + threadIdx.x, y = y0 + threadIdx.y;
  if (z >= Z || y >= Y) return;
  for (int lx = 0; lx < TX && x0 + lx < X; ++lx) {
    // neighbour (dx, dy, dz) of output (lx, ty, tz) sits at tile index
    // ((lx + dx) * HY + ty + dy) * HZ + tz + dz
    const uint8_t* base = tile + (lx * HY + threadIdx.y) * HZ + threadIdx.x;
    int m = 0;
#pragma unroll 1
    for (int bit = 7; bit >= 0; --bit) {
      const int cand = m + (1 << bit);
      int below = 0;
#pragma unroll
      for (int dx = 0; dx < S; ++dx)
#pragma unroll
        for (int dy = 0; dy < S; ++dy)
#pragma unroll
          for (int dz = 0; dz < S; ++dz)
            below += base[(dx * HY + dy) * HZ + dz] < cand;
      if (below <= RANK) m = cand;
    }
    out[(static_cast<long long>(x0 + lx) * Y + y) * Z + z] =
        static_cast<uint8_t>(m);
  }
}

template <int R>
void launch(const uint8_t* in, uint8_t* out, int X, int Y, int Z,
            cudaStream_t stream) {
  const dim3 block(TZ, TY);
  const dim3 grid((Z + TZ - 1) / TZ, (Y + TY - 1) / TY, (X + TX - 1) / TX);
  median3d_u8_kernel<R><<<grid, block, 0, stream>>>(in, out, X, Y, Z);
}

}  // namespace

// Median of every edge-replicated size^3 neighbourhood of the contiguous
// uint8 (X, Y, Z) volume `in` into `out` (same shape), on `stream`.
// size is 3 or 5; the wrapper checks shapes and the grid limits
// (ceil(Y / 8) and ceil(X / 4) at most 65535). Returns cudaGetLastError().
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
