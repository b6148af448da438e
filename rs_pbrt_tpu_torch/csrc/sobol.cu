// K1: Sobol' samples for a block of dimensions, one thread per lane.
//
// Replaces rs_pbrt_tpu/ops/pallas_sobol.py:_sobol_kernel (launched by
// _sobol_call, wrapped by sobol_dims).  Output (N, n_dims) f32 for
// dimensions dim0 .. dim0 + n_dims - 1 of each lane's 52-bit global index.
//
// What bounds it on the card: it reads 8 bytes and writes 4 * n_dims bytes
// per lane, and does n_bits * n_dims XOR-selects in between, so for the
// camera's five dims at 32 bits it sits between the memory bound and the
// integer-issue bound.  The design keeps the direction numbers of the
// block's dims in shared memory (at most n_dims * 52 * 4 bytes), loaded
// once per block, and the accumulators in registers; every index bit is
// extracted once for all dims (rs_sobol_accumulate).  n_bits = 32 skips
// the upper index word when the caller proves the index fits 32 bits.
#include <cuda_runtime.h>

#include <cstdint>

#include "sobol.cuh"

namespace {

constexpr int kChunk = 8;  // accumulators kept in registers at a time

__global__ void sobol_dims_kernel(const int64_t* __restrict__ index,
                                  const uint32_t* __restrict__ mats, float* __restrict__ out,
                                  int n, int dim0, int n_dims, int n_bits) {
  extern __shared__ uint32_t rows[];
  for (int j = threadIdx.x; j < n_dims * RS_SOBOL_MATRIX_SIZE; j += blockDim.x)
    rows[j] = mats[dim0 * RS_SOBOL_MATRIX_SIZE + j];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t idx = static_cast<uint64_t>(index[i]);
  float* dst = out + static_cast<size_t>(i) * n_dims;
  for (int d0 = 0; d0 < n_dims; d0 += kChunk) {
    const int nd = n_dims - d0;
    uint32_t v[kChunk];
    rs_sobol_accumulate<kChunk>(rows + d0 * RS_SOBOL_MATRIX_SIZE, idx, n_bits, nd, v);
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (k < nd) dst[d0 + k] = rs_u32_to_unit_float(v[k]);
  }
}

}  // namespace

extern "C" int rs_sobol_dims(const void* index, const void* mats, void* out, int n, int dim0,
                             int n_dims, int n_bits, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  const size_t smem = static_cast<size_t>(n_dims) * RS_SOBOL_MATRIX_SIZE * sizeof(uint32_t);
  sobol_dims_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(index), static_cast<const uint32_t*>(mats),
      static_cast<float*>(out), n, dim0, n_dims, n_bits);
  return static_cast<int>(cudaGetLastError());
}
