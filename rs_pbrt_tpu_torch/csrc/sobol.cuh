// Sobol' bit-matrix product as a device function, shared by the Sobol'
// kernel (sobol.cu) and the bounce kernel (bounce.cu).
//
// Same math as rs_pbrt_tpu/ops/pallas_sobol.py:_sobol_kernel and
// ops/lowdiscrepancy.py:sobol_sample: the XOR of the direction numbers of
// dimension d selected by the set bits of the global index, times 2^-32,
// clamped below 1.  The conversion is the direct round-to-nearest
// u32 -> f32 one, which matches lowdiscrepancy.sobol_sample bit for bit
// (the TPU kernel splits the word into halves only because Mosaic has no
// u32 -> f32 cast).
#pragma once

#include <cstdint>

#define RS_SOBOL_MATRIX_SIZE 52

__device__ __forceinline__ float rs_u32_to_unit_float(uint32_t v) {
  return fminf(__uint2float_rn(v) * 0x1p-32f, 0x1.fffffep-1f);
}

// Bits outer, dims inner: each index bit is extracted once and applied to
// every accumulator.  rows holds consecutive 52-entry rows of the
// direction-number table, one per dimension (shared memory); only the
// first nd of the ND accumulators are computed.
template <int ND>
__device__ __forceinline__ void rs_sobol_accumulate(const uint32_t* rows, uint64_t index,
                                                    int n_bits, int nd, uint32_t (&v)[ND]) {
#pragma unroll
  for (int k = 0; k < ND; ++k) v[k] = 0u;
  for (int i = 0; i < n_bits; ++i) {
    const uint32_t mask = 0u - static_cast<uint32_t>((index >> i) & 1ull);
#pragma unroll
    for (int k = 0; k < ND; ++k)
      if (k < nd) v[k] ^= rows[k * RS_SOBOL_MATRIX_SIZE + i] & mask;
  }
}
