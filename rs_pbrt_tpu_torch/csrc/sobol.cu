// K1: Sobol' samples for a block of dimensions, written dims-major.
//
// Replaces rs_pbrt_tpu/ops/pallas_sobol.py:_sobol_kernel (launched by
// _sobol_call, wrapped by sobol_dims).  Output (n_dims, N) f32: row k holds
// dimension dim0 + k of every lane's global index (ops/sobol_kernel.py
// returns its transposed (N, n_dims) view).  Only the low n_bits bits of
// the index are read; the caller passes the index's width (1..52), which
// is log2(spp) + 2 log2(resolution) on the render paths.
//
// What bounds it on the card: per lane 8 bytes of index in and 4 * n_dims
// bytes out (the byte bound), against n_bits * n_dims AND-XORs of
// direction numbers (the operation bound, below the byte bound on every
// render path).  The one-thread-a-lane kernel before this one lost its
// time to stores at a stride of n_dims, a shared-memory load per (bit,
// dim) step, zero index bits it still walked, and a table copy per
// 256-lane block.  What this design does about it:
// - Dims-major output: a warp's store of one dim is 32 consecutive floats,
//   one 128-byte line.
// - Tables: the index is read four bits (a group) at a time.  For each
//   (group, dim) a 16-entry table in shared memory holds the XORs of the
//   group's four direction numbers, so a lane's sample is one table read
//   per group and dim in place of four AND-XOR steps.  A table's 16 words
//   lie in 16 banks, so a warp's read is one shared-memory wavefront
//   whatever values its lanes' groups hold.  A step takes two groups:
//   their reads of a dim are XORed in by one three-input LOP3, and their
//   table pointers move by one add, which cut a group's cost by a third
//   (32- and 52-bit indices, PERF.md).  On the render paths' 19- and
//   22-bit launches the kernel sits at ~2.2 TB/s, which neither fewer
//   groups nor fewer instructions moved.
// - Persistent blocks: as many as fill the SMs at the kernel's occupancy.
//   Each builds its tables once, then walks 256-lane tiles.
// The u32 -> f32 conversion is sobol.cuh's, so the kernel gives the plain
// version's bits.
#include <cuda_runtime.h>

#include <cstdint>

#include "sobol.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;  // accumulators kept in registers at a time
constexpr int kMaxDims = 128;  // ops/sobol_kernel.py MAX_DIMS
constexpr int kGroupBits = 4;  // index bits a table covers
constexpr int kTableWords = 1 << kGroupBits;  // one (group, dim) table
constexpr int kMaxGroups = (RS_SOBOL_MATRIX_SIZE + kGroupBits - 1) / kGroupBits;
constexpr int kMaxSmem = kMaxGroups * kMaxDims * kTableWords * 4;  // the largest tables

struct Args {
  const int64_t* index;
  const uint32_t* mats;  // (1024, 52) direction numbers
  float* out;  // (n_dims, n)
  int n, dim0, n_dims, n_bits;
};

__host__ __device__ constexpr int n_groups(int n_bits) {
  return (n_bits + kGroupBits - 1) / kGroupBits;
}

// The tables in shared memory: table p = g * n_dims + d at
// tab[16 p .. 16 p + 15], entry v the XOR of the direction numbers of the
// bits of v (bit b standing for index bit 4 g + b; bits past n_bits count
// as 0).
__device__ void build_tables(uint32_t* tab, const Args& a) {
  for (int p = threadIdx.x; p < n_groups(a.n_bits) * a.n_dims; p += blockDim.x) {
    const int g = p / a.n_dims, d = p - g * a.n_dims;
    const uint32_t* m = a.mats + (a.dim0 + d) * RS_SOBOL_MATRIX_SIZE + kGroupBits * g;
    uint32_t r[kGroupBits], t[kTableWords];
#pragma unroll
    for (int b = 0; b < kGroupBits; ++b)
      r[b] = kGroupBits * g + b < a.n_bits ? __ldg(m + b) : 0u;
    t[0] = 0u;
#pragma unroll
    for (int v = 1; v < kTableWords; ++v) {
      const int low = v & -v;
      t[v] = t[v ^ low] ^ r[low == 1 ? 0 : low == 2 ? 1 : low == 4 ? 2 : 3];
    }
    uint4* dst = reinterpret_cast<uint4*>(tab + p * kTableWords);
#pragma unroll
    for (int q = 0; q < kTableWords / 4; ++q)
      dst[q] = make_uint4(t[4 * q], t[4 * q + 1], t[4 * q + 2], t[4 * q + 3]);
  }
}

// ND dims of one lane: t holds group 0's tables of the chunk's first dim
// on, gstride words apart from one group's tables to the next's; lo, hi the
// index's words.  Groups 8.. are read from hi; no step of two groups
// straddles the words.
template <int ND>
__device__ __forceinline__ void tables_chunk(const uint32_t* t, int gstride, uint32_t lo,
                                             uint32_t hi, int n_grp, uint32_t (&v)[kChunk]) {
  constexpr int kLoGroups = 32 / kGroupBits;
#pragma unroll
  for (int k = 0; k < ND; ++k) v[k] = 0u;
  uint32_t x = lo;
  int g = 0;
  for (; g + 2 <= n_grp; g += 2) {
    if (g == kLoGroups) x = hi;
    const uint32_t* t0 = t + (x & (kTableWords - 1));
    const uint32_t* t1 = t + gstride + ((x >> kGroupBits) & (kTableWords - 1));
#pragma unroll
    for (int k = 0; k < ND; ++k) v[k] ^= t0[k * kTableWords] ^ t1[k * kTableWords];
    x >>= 2 * kGroupBits;
    t += 2 * gstride;
  }
  if (g < n_grp) {
    if (g == kLoGroups) x = hi;
    const uint32_t* t0 = t + (x & (kTableWords - 1));
#pragma unroll
    for (int k = 0; k < ND; ++k) v[k] ^= t0[k * kTableWords];
  }
}

__global__ void __launch_bounds__(kThreads) sobol_dims_kernel(const Args a) {
  extern __shared__ uint4 smem4[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem4);
  build_tables(tab, a);
  __syncthreads();
  const int n_grp = n_groups(a.n_bits);
  const int gstride = a.n_dims * kTableWords;
  for (long long tile = static_cast<long long>(blockIdx.x) * kThreads; tile < a.n;
       tile += static_cast<long long>(gridDim.x) * kThreads) {
    const int i = static_cast<int>(tile) + threadIdx.x;
    if (i >= a.n) break;
    const uint64_t idx = static_cast<uint64_t>(__ldg(a.index + i));
    const uint32_t lo = static_cast<uint32_t>(idx), hi = static_cast<uint32_t>(idx >> 32);
    for (int d0 = 0; d0 < a.n_dims; d0 += kChunk) {
      uint32_t v[kChunk];
      const int nd = min(kChunk, a.n_dims - d0);
      const uint32_t* t = tab + d0 * kTableWords;
      switch (nd) {
        case 1: tables_chunk<1>(t, gstride, lo, hi, n_grp, v); break;
        case 2: tables_chunk<2>(t, gstride, lo, hi, n_grp, v); break;
        case 3: tables_chunk<3>(t, gstride, lo, hi, n_grp, v); break;
        case 4: tables_chunk<4>(t, gstride, lo, hi, n_grp, v); break;
        case 5: tables_chunk<5>(t, gstride, lo, hi, n_grp, v); break;
        case 6: tables_chunk<6>(t, gstride, lo, hi, n_grp, v); break;
        case 7: tables_chunk<7>(t, gstride, lo, hi, n_grp, v); break;
        default: tables_chunk<8>(t, gstride, lo, hi, n_grp, v); break;
      }
      float* dst = a.out + static_cast<size_t>(d0) * a.n + i;
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (k < nd) dst[static_cast<size_t>(k) * a.n] = rs_u32_to_unit_float(v[k]);
    }
  }
}

}  // namespace

extern "C" int rs_sobol_dims(const void* index, const void* mats, void* out, int n, int dim0,
                             int n_dims, int n_bits, void* stream) {
  if (n_dims < 1 || n_dims > kMaxDims || n_bits < 1 || n_bits > RS_SOBOL_MATRIX_SIZE ||
      dim0 < 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const Args a{static_cast<const int64_t*>(index), static_cast<const uint32_t*>(mats),
               static_cast<float*>(out), n, dim0, n_dims, n_bits};
  const size_t smem = static_cast<size_t>(n_groups(n_bits)) * n_dims * kTableWords * 4;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(sobol_dims_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sobol_dims_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kThreads - 1) / kThreads;
  const int grid = max(1, min(sms * max(per_sm, 1), tiles));
  sobol_dims_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
