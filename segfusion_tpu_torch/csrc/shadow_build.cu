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
// 448^3 reads the 1.451 GB geo state and writes the 1.439 GB shadow (0.86
// ms at 3.35 TB/s; f32 geo 2.902 GB, 1.30 ms); the reconciles read the geo
// (or 1.44 GB key) state once and write 0.72 GB (0.36 GB) of canonical
// planes. No arithmetic is heavy (8 adds and a pack per voxel).
//
// The shadow build. The 128 lanes of a shadow row are one packed canonical
// row P[y][z] = pack16(num, w) at four shifts (P, P(z+1), P(y+1),
// P(y+1, z+1)), and the geo rows a y-tile needs are contiguous for a
// fixed x. So one block builds one (x, y-tile) tile, walking y:
//   - geo rows sy = y0 .. y0 + TY + 1 stream through a ring of kStages
//     shared-memory stages by 16-byte cp.async, two rows ahead of the two
//     being reduced, so each geo value is read from device memory once per
//     tile (the two halo rows add 2 / TY). Only the groups that hold z < Z
//     are copied. Each 128-lane group is padded by 16 elements in shared
//     memory, which puts the two z-groups a warp reads on disjoint banks.
//   - each voxel is reconciled once: P row vy from geo rows vy + 1 and vy
//     into a ring of four P rows (row stride 32 GK + 2, = 2 mod 4, so any
//     two neighbouring rows of the ring start 2 banks apart mod 4 and the
//     four quarters of an output row read disjoint banks); the word at
//     z = 32 GK, the last group's (z + 1) neighbour, is always outside the
//     volume and stays 0.
//   - output row y is written from P rows y and y + 1, 16 bytes a thread,
//     so each warp stores 512 contiguous bytes; it is written one step
//     after its P rows, so one barrier per row orders everything.
// One thread per voxel of a row (32 GK, at most 512): at 448^3 each thread
// copies one 16-byte chunk (bf16), reconciles one voxel and stores one
// 16-byte vector per row. Deeper rings (6, 8 stages), 256-thread blocks and
// streaming stores timed no faster at 448^3; a 3-stage ring was slower.
// A dirty build's block reads its tile's flag and returns if it is clean,
// leaving those words of the shadow untouched; a dirty tile's words are
// all written. The previous design, one thread per output word (8 scalar
// loads each, every voxel reconciled four times), took 2.8321 ms (bf16)
// and 2.7788 ms (f32) for the full build and 1.6276 ms for a half-dirty
// one at 448^3 on an H100 80GB HBM3 at 700 W, limited by its load
// instructions rather than by DRAM.

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

// -- the shadow build ----------------------------------------------------------

constexpr int kStages = 4;          // geo rows in the ring: 2 read, 2 ahead
constexpr int kGroupStride = 144;   // elements per staged 128-lane group
constexpr int kPRows = 4;           // P rows in the ring
constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;    // the opt-in limit of one block

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until the geo rows up to the current step's second row have landed:
// of the groups committed so far, the newest kStages - 3 may still be in
// flight.
__device__ __forceinline__ void cp_async_wait_rows() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 3) : "memory");
}

// Grid: one block per (x, y-tile) tile, tile = x * NJ + j. NGZ = the geo
// groups holding z < Z.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
shadow_build_kernel(const T* __restrict__ geo, uint4* __restrict__ out,
                    const int* __restrict__ dirty, GeoLayout L, int GK,
                    int TY, int NJ, int NGZ) {
  const int tile = blockIdx.x;
  if (dirty != nullptr && dirty[tile] == 0) return;  // clean: keep prev
  const int x = tile / NJ;
  const int y0 = (tile - x * NJ) * TY;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int ZS = 32 * GK;       // z extent of a shadow row
  const int PS = ZS + 2;        // P row stride

  extern __shared__ __align__(16) unsigned char smem[];
  const int stage_elems = NGZ * kGroupStride;
  T* stages = reinterpret_cast<T*>(smem);
  unsigned* P = reinterpret_cast<unsigned*>(
      smem + static_cast<size_t>(kStages) * stage_elems * sizeof(T));
  if (t < kPRows) P[t * PS + ZS] = 0u;

  // geo row sy = y0 + r -> stage r % kStages; one commit group per row,
  // empty past the tile's last row, so the wait count stays uniform
  constexpr int kChunksPerGroup = 128 * sizeof(T) / 16;
  const int n_chunks = NGZ * kChunksPerGroup;
  const size_t row_bytes = static_cast<size_t>(L.G) * 128 * sizeof(T);
  const char* geo_x = reinterpret_cast<const char*>(geo)
                      + static_cast<size_t>(x) * L.SY * row_bytes;
  auto load_row = [&](int r) {
    if (r <= TY + 1) {
      const char* src = geo_x + static_cast<size_t>(y0 + r) * row_bytes;
      char* dst = reinterpret_cast<char*>(stages
                                          + (r % kStages) * stage_elems);
      for (int k = t; k < n_chunks; k += nt) {
        const int g = k / kChunksPerGroup;
        cp_async16(dst + g * kGroupStride * static_cast<int>(sizeof(T))
                       + (k - g * kChunksPerGroup) * 16,
                   src + static_cast<size_t>(k) * 16);
      }
    }
    cp_async_commit();
  };
  for (int r = 0; r < kStages - 1; ++r) load_row(r);

  uint4* out_tile = out + (static_cast<long long>(x) * L.Y + y0) * GK * 32;
  // step r: P row r (voxel row y0 + r, r <= TY), then output row r - 2
  for (int r = 0; r <= TY + 1; ++r) {
    cp_async_wait_rows();
    // geo rows r, r + 1 visible to all; P rows r - 2, r - 1 written; the
    // stage of row r - 1 and P rows before r - 2 no longer read
    __syncthreads();
    load_row(r + kStages - 1);
    if (r <= TY) {
      const int vy = y0 + r;
      const T* a = stages + ((r + 1) % kStages) * stage_elems;  // sy = vy+1
      const T* b = stages + (r % kStages) * stage_elems;        // sy = vy
      unsigned* p = P + (r % kPRows) * PS;
      for (int z = t; z < ZS; z += nt) {
        unsigned word = 0u;
        if (vy < L.Y && z < L.Z) {
          const int i0 = (z >> 4) * kGroupStride + (z & 15);
          const bool zm = z > 0;
          const int i1 = zm ? ((z - 1) >> 4) * kGroupStride + ((z - 1) & 15)
                            : 0;
          const float num = (to_f32(a[i0]) + (zm ? to_f32(a[i1 + 16]) : 0.0f))
                          + (to_f32(b[i0 + 32])
                             + (zm ? to_f32(b[i1 + 48]) : 0.0f));
          const float w = (to_f32(a[i0 + 64])
                           + (zm ? to_f32(a[i1 + 80]) : 0.0f))
                        + (to_f32(b[i0 + 96])
                           + (zm ? to_f32(b[i1 + 112]) : 0.0f));
          word = pack16(num, w);
        }
        p[z] = word;
      }
    }
    if (r >= 2) {
      // output row i: lanes 32 c + 4 s4 .. + 3 of group gk are
      // P[i + c / 2][32 gk + 4 s4 + c % 2 .. + 3]
      const int i = r - 2;
      const unsigned* p0 = P + (i % kPRows) * PS;
      const unsigned* p1 = P + ((i + 1) % kPRows) * PS;
      uint4* o = out_tile + static_cast<long long>(i) * GK * 32;
      for (int q = t; q < GK * 32; q += nt) {
        const int c = (q >> 3) & 3;
        const unsigned* p = (c >> 1) ? p1 : p0;
        const int zb = (q >> 5) * 32 + (q & 7) * 4 + (c & 1);
        o[q] = make_uint4(p[zb], p[zb + 1], p[zb + 2], p[zb + 3]);
      }
    }
  }
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

template <typename T>
cudaError_t launch_shadow(const void* geo, void* out, const void* dirty,
                          const GeoLayout& L, int GK, int TY,
                          cudaStream_t s) {
  static bool opted_in = false;
  const cudaError_t err = allow_smem(shadow_build_kernel<T>, opted_in);
  if (err != cudaSuccess) return err;
  const int NJ = L.Y / TY;
  const int NGZ = (L.Z + 15) / 16;
  // the geo stages, then the P rows (layout as in the kernel)
  const size_t smem =
      static_cast<size_t>(kStages) * NGZ * kGroupStride * sizeof(T)
      + static_cast<size_t>(kPRows) * (32 * GK + 2) * sizeof(unsigned);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const int threads = 32 * GK < kMaxThreads ? 32 * GK : kMaxThreads;
  shadow_build_kernel<T><<<L.X * NJ, threads, smem, s>>>(
      static_cast<const T*>(geo), static_cast<uint4*>(out),
      static_cast<const int*>(dirty), L, GK, TY, NJ, NGZ);
  return cudaGetLastError();
}

// -- the reconciles ------------------------------------------------------------

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
// stream, does not synchronise, and returns a cudaError_t: the launch's
// (cudaGetLastError()), or cudaErrorInvalidValue for a shadow build whose
// z extent needs more shared memory than a block has.

extern "C" int sf_shadow_build(const void* geo, int geo_bf16, void* out,
                               const void* dirty, int X, int Y, int Z, int G,
                               int GK, int SY, int TY, void* stream) {
  const GeoLayout L{X, Y, Z, G, SY};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      geo_bf16 ? launch_shadow<uint16_t>(geo, out, dirty, L, GK, TY, s)
               : launch_shadow<float>(geo, out, dirty, L, GK, TY, s));
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
