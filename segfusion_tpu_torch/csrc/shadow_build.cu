// Hopper kernels for the slot-row scene state (segfusion_tpu_torch).
//
// Replaces the Pallas TPU kernels of segfusion_tpu/ops/pallas/shadow_build.py:
//   shadow_build_kernel   <- build_shadow_dirty_pallas (_dirty_kernel) and
//                            build_shadow_pallas (_kernel): one kernel, the
//                            full build passes no dirty flags
//   reconcile_slot_kernel <- reconcile_slot_pallas (_reconcile_kernel)
//   reconcile_key_kernel  <- reconcile_key_pallas (_key_reconcile_kernel)
//
// Layouts (see segfusion_tpu_torch/ops/rowvol.py, identical to the JAX
// package's RowLayout):
//   geo    rows (x, sy = 1 + y, g), x-stride SY, 128 lanes = 8 components
//          x 16 z-slots, lane 16 c + z % 16; components [nA0 nA1 nB0 nB1
//          wA0 wA1 wB0 wB1]; zero pad rows at sy = 0 and sy = Y + 1.
//   key    rows (x, y, gk), 128 lanes = 4 corner components x 32 z-slots.
//   shadow rows (x, y, gk), lane 32 c + s holds pack16(num, w) of voxel
//          (y + c / 2, z = 32 gk + s + c % 2), 0 outside the volume.
// A voxel (y, z) reconciles as
//   (c0[y, z] + c1[y, z-1]) + (c2[y-1, z] + c3[y-1, z-1])
// in exactly this association order: the plain PyTorch versions and the
// JAX package use it, and bit-equality depends on it. Out-of-range z-1
// terms are read as +0.0f and still added (x + 0.0f turns -0.0f into
// +0.0f, as the plain version's zero padding does); the build uses no
// fast-math flags, so the compiler keeps those adds.
//
// What bounds these kernels on an H100: bytes. A full bf16 shadow build at
// 448^3 reads the 1.45 GB geo state and writes the 1.44 GB shadow; the
// reconciles read the geo (or 1.44 GB key) state once and write 0.72 GB
// (0.36 GB) of canonical planes. No arithmetic is heavy (8 adds and a pack
// per word). The design is the simple one: one thread per output word,
// consecutive threads on consecutive lanes (z-slots), so every warp's
// loads and stores are contiguous runs; each input value is re-read by up
// to four threads of neighbouring lanes and rows, which L1/L2 serves. The
// dirty build launches one grid row per (x, y-tile) and returns whole
// blocks of clean tiles at once, so a clean tile costs one flag read per
// block. Shared-memory tiling and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct GeoLayout {
  int X, Y, Z, G, SY;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
// bf16 -> f32 is exact: the bf16 bits are the high half of the f32 word.
__device__ __forceinline__ float to_f32(uint16_t v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

template <typename T>
__device__ __forceinline__ float slot(const T* geo, const GeoLayout& L,
                                      int x, int sy, int z, int comp) {
  if (z < 0) return 0.0f;
  const long long row = (static_cast<long long>(x) * L.SY + sy) * L.G
                        + (z >> 4);
  return to_f32(geo[row * 128 + 16 * comp + (z & 15)]);
}

// Canonical (num, w) of voxel (x, y, z) from its 4 neighbour slots. Slot
// row y_lo = y sits at sy = y + 1 (comps 0/1), slot row y - 1 at sy = y
// (comps 2/3); the pad row sy = 0 makes y = 0 read zeros.
template <typename T>
__device__ __forceinline__ void reconcile(const T* geo, const GeoLayout& L,
                                          int x, int y, int z,
                                          float& num, float& w) {
  num = (slot(geo, L, x, y + 1, z, 0) + slot(geo, L, x, y + 1, z - 1, 1))
      + (slot(geo, L, x, y, z, 2) + slot(geo, L, x, y, z - 1, 3));
  w = (slot(geo, L, x, y + 1, z, 4) + slot(geo, L, x, y + 1, z - 1, 5))
    + (slot(geo, L, x, y, z, 6) + slot(geo, L, x, y, z - 1, 7));
}

// (bf16(num) << 16) | bf16(w), RTNE by the add-half-to-even trick on the
// f32 bits (geometry.pack16_numw).
__device__ __forceinline__ unsigned pack16(float num, float w) {
  const unsigned nb = __float_as_uint(num);
  const unsigned wb = __float_as_uint(w);
  const unsigned nr = (nb + (0x7FFFu + ((nb >> 16) & 1u))) & 0xFFFF0000u;
  const unsigned wr = (wb + (0x7FFFu + ((wb >> 16) & 1u))) >> 16;
  return nr | wr;
}

// Grid: x = words of one tile / blockDim, y = tile index x * NJ + j.
template <typename T>
__global__ void shadow_build_kernel(const T* __restrict__ geo,
                                    unsigned* __restrict__ out,
                                    const int* __restrict__ dirty,
                                    GeoLayout L, int GK, int TY, int NJ) {
  const int tile = blockIdx.y;
  if (dirty != nullptr && dirty[tile] == 0) return;  // clean: keep prev
  const long long per_tile = static_cast<long long>(TY) * GK * 128;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (t >= per_tile) return;
  const int x = tile / NJ;
  const int j = tile - x * NJ;
  const int lane = static_cast<int>(t & 127);
  const long long r = t >> 7;
  const int gk = static_cast<int>(r % GK);
  const int y = j * TY + static_cast<int>(r / GK);
  const int c = lane >> 5;
  const int vy = y + (c >> 1);
  const int vz = 32 * gk + (lane & 31) + (c & 1);
  unsigned word = 0u;
  if (vy < L.Y && vz < L.Z) {
    float num, w;
    reconcile(geo, L, x, vy, vz, num, w);
    word = pack16(num, w);
  }
  out[((static_cast<long long>(x) * L.Y + y) * GK + gk) * 128 + lane] = word;
}

template <typename T>
__global__ void reconcile_slot_kernel(const T* __restrict__ geo,
                                      float* __restrict__ num,
                                      float* __restrict__ w, GeoLayout L) {
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const long long total = static_cast<long long>(L.X) * L.Y * L.Z;
  if (v >= total) return;
  const int z = static_cast<int>(v % L.Z);
  const long long r = v / L.Z;
  const int y = static_cast<int>(r % L.Y);
  const int x = static_cast<int>(r / L.Y);
  float n, ww;
  reconcile(geo, L, x, y, z, n, ww);
  num[v] = n;
  w[v] = ww;
}

// Canonical key = max of comp 0 of slot (y, z), comp 1 of (y, z-1), comp 2
// of (y-1, z), comp 3 of (y-1, z-1); out-of-range neighbours count as 0.
__global__ void reconcile_key_kernel(const int* __restrict__ key,
                                     int* __restrict__ out,
                                     int X, int Y, int Z, int GK) {
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const long long total = static_cast<long long>(X) * Y * Z;
  if (v >= total) return;
  const int z = static_cast<int>(v % Z);
  const long long r = v / Z;
  const int y = static_cast<int>(r % Y);
  const int x = static_cast<int>(r / Y);
  const long long row = (static_cast<long long>(x) * Y + y) * GK;
  const long long row_y1 = row - GK;  // slot row y - 1
  const int zm = z - 1;
  const int k0 = key[(row + (z >> 5)) * 128 + (z & 31)];
  const int k1 = z > 0 ? key[(row + (zm >> 5)) * 128 + 32 + (zm & 31)] : 0;
  const int k2 = y > 0 ? key[(row_y1 + (z >> 5)) * 128 + 64 + (z & 31)] : 0;
  const int k3 = (y > 0 && z > 0)
      ? key[(row_y1 + (zm >> 5)) * 128 + 96 + (zm & 31)] : 0;
  out[v] = max(max(max(k0, k1), k2), k3);
}

constexpr int kThreads = 256;

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

extern "C" int sf_shadow_build(const void* geo, int geo_bf16, void* out,
                               const void* dirty, int X, int Y, int Z, int G,
                               int GK, int SY, int TY, void* stream) {
  const GeoLayout L{X, Y, Z, G, SY};
  const int NJ = Y / TY;
  const dim3 grid(blocks_for(static_cast<long long>(TY) * GK * 128),
                  static_cast<unsigned>(X * NJ));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (geo_bf16) {
    shadow_build_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(geo), static_cast<unsigned*>(out),
        static_cast<const int*>(dirty), L, GK, TY, NJ);
  } else {
    shadow_build_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(geo), static_cast<unsigned*>(out),
        static_cast<const int*>(dirty), L, GK, TY, NJ);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sf_reconcile_slot(const void* geo, int geo_bf16, void* num,
                                 void* w, int X, int Y, int Z, int G, int SY,
                                 void* stream) {
  const GeoLayout L{X, Y, Z, G, SY};
  const unsigned grid = blocks_for(static_cast<long long>(X) * Y * Z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (geo_bf16) {
    reconcile_slot_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(geo), static_cast<float*>(num),
        static_cast<float*>(w), L);
  } else {
    reconcile_slot_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(geo), static_cast<float*>(num),
        static_cast<float*>(w), L);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sf_reconcile_key(const void* key, void* out, int X, int Y,
                                int Z, int GK, void* stream) {
  const unsigned grid = blocks_for(static_cast<long long>(X) * Y * Z);
  reconcile_key_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(key), static_cast<int*>(out), X, Y, Z, GK);
  return static_cast<int>(cudaGetLastError());
}
