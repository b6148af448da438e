// H1: Halton samples for a block of dimensions, written dims-major.
//
// Replaces the JAX package's rs_pbrt_tpu/ops/lowdiscrepancy.py
// halton_sample (:259, one dim a call, scrambled_radical_inverse :183) and
// halton_sample_dyn (:276, the dims clipped to [2, 255]), which
// samplers.get_1d and get_dims stack one dim at a time.  Output (n_dims, N)
// f32: row k holds dimension k of the block for every lane's 32-bit Halton
// index, read as u32 (ops/halton_kernel.py returns the transposed
// (N, n_dims) view).
//
// The host resolves each row's dimension into a code (0 and 1 the film
// dims, else the prime base) and the offset of its permutation in the flat
// table, so the kernel never clips or looks up a prime.  One thread a lane:
// it reads its index once (4 bytes) and writes one float a dim, a warp's
// store of a row one 128-byte line.  Persistent blocks, as many as fill the
// SMs, stage the permutations of the block's bases (a contiguous slice of
// the table, ~3,000 entries for a path's 35 dims) into shared memory once
// and walk 256-lane tiles; a slice past 48 KB is read from global memory.
// Digits divide by the runtime base; the math is halton.cuh's.
#include <cuda_runtime.h>

#include <cstdint>

#include "halton.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDims = 128;  // ops/halton_kernel.py MAX_DIMS
constexpr int kMaxSmemEntries = 24 * 1024;  // u16 entries staged: 48 KB

struct Args {
  const uint32_t* index;
  const uint16_t* perms;  // the flat table
  float* out;  // (n_dims, n)
  int n, n_dims, exp_x, scale_y;
  int lo, hi;  // the slice of the table the block's bases read
  int code[kMaxDims];  // 0, 1: film dims; else the prime base
  int off[kMaxDims];  // the base's permutation at perms[off]
};

template <bool kShared>
__global__ void __launch_bounds__(kThreads) halton_dims_kernel(const Args a) {
  extern __shared__ uint16_t slice[];
  const uint16_t* perms = a.perms;
  int shift = 0;
  if (kShared) {
    for (int j = threadIdx.x; j < a.hi - a.lo; j += blockDim.x) slice[j] = __ldg(a.perms + a.lo + j);
    __syncthreads();
    perms = slice;
    shift = a.lo;
  }
  for (long long tile = static_cast<long long>(blockIdx.x) * kThreads; tile < a.n;
       tile += static_cast<long long>(gridDim.x) * kThreads) {
    const int i = static_cast<int>(tile) + threadIdx.x;
    if (i >= a.n) break;
    const uint32_t index = __ldg(a.index + i);
    float* dst = a.out + i;
    for (int k = 0; k < a.n_dims; ++k) {
      const int code = a.code[k];
      float v;
      if (code == 0)
        v = halton::film_x(index, a.exp_x);
      else if (code == 1)
        v = halton::film_y(index, static_cast<uint32_t>(a.scale_y));
      else
        v = halton::scrambled(index, static_cast<uint32_t>(code), perms + (a.off[k] - shift));
      dst[static_cast<size_t>(k) * a.n] = v;
    }
  }
}

template <bool kShared>
int launch(const Args& a, void* stream) {
  const size_t smem = kShared ? static_cast<size_t>(a.hi - a.lo) * sizeof(uint16_t) : 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, halton_dims_kernel<kShared>,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.n + kThreads - 1) / kThreads;
  const int grid = max(1, min(sms * max(per_sm, 1), tiles));
  halton_dims_kernel<kShared><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// index: n u32 words; codes, offs: n_dims host ints each; lo, hi: the
// slice of perms that the codes from 2 on read (lo == hi, and perms may be
// null, where none does).
extern "C" int rs_halton_dims(const void* index, const void* perms, void* out, int n,
                              const int* codes, const int* offs, int n_dims, int exp_x,
                              int scale_y, int lo, int hi, void* stream) {
  if (n_dims < 1 || n_dims > kMaxDims || n < 0 || exp_x < 0 || exp_x > 31 || scale_y < 1 ||
      lo < 0 || hi < lo)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Args a{static_cast<const uint32_t*>(index), static_cast<const uint16_t*>(perms),
         static_cast<float*>(out), n, n_dims, exp_x, scale_y, lo, hi, {}, {}};
  for (int k = 0; k < n_dims; ++k) {
    if (codes[k] < 0 || (codes[k] >= 2 && (offs[k] < lo || offs[k] + codes[k] > hi)))
      return static_cast<int>(cudaErrorInvalidValue);
    a.code[k] = codes[k];
    a.off[k] = offs[k];
  }
  return hi - lo <= kMaxSmemEntries ? launch<true>(a, stream) : launch<false>(a, stream);
}
