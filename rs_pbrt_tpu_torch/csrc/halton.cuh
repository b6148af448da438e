// The Halton dims' per-lane math, H1's (halton.cu).
//
// Each function computes the plain version's ops (ops/lowdiscrepancy.py
// halton_samples, the JAX package's halton_sample and halton_sample_dyn)
// in their order for one lane and one dim: 32-bit digit arithmetic that
// wraps as the u32 words there do, and f32 products and quotients that,
// with --fmad=false, each round alone.  The digit loop stops where the
// plain version's fixed loop stops changing anything (the index's digits
// run out), so both give the same bits.  RS_HD marks the functions: device
// and inline unless the includer defines it.
#pragma once

#include <math.h>
#include <stdint.h>

#ifndef RS_HD
#define RS_HD __device__ __forceinline__
#endif

namespace halton {

constexpr float kOneMinusEpsilon = 0x1.fffffep-1f;  // FLOAT_ONE_MINUS_EPSILON
constexpr float kInv2Pow32 = 0x1p-32f;

RS_HD uint32_t reverse_bits(uint32_t v) {
#ifdef __CUDA_ARCH__
  return __brev(v);
#else
  uint32_t r = 0u;
  for (int i = 0; i < 32; ++i) r |= ((v >> i) & 1u) << (31 - i);
  return r;
#endif
}

// A word -> f32 in [0, 1): rounded to nearest, times 2^-32, below 1.
RS_HD float unit_float(uint32_t v) {
  return fminf(static_cast<float>(v) * kInv2Pow32, kOneMinusEpsilon);
}

// Film dim 0: the bit reversal of the index with its exp_x pixel digits
// shifted out (van_der_corput_sample).
RS_HD float film_x(uint32_t index, int exp_x) { return unit_float(reverse_bits(index >> exp_x)); }

// Film dim 1: the unscrambled base-3 radical inverse of index / scale_y
// (radical_inverse(1, .)).
RS_HD float film_y(uint32_t index, uint32_t scale_y) {
  const float inv_base = 1.0f / 3.0f;
  uint32_t a = index / scale_y, rev = 0u;
  float inv_n = 1.0f;
  while (a > 0u) {
    const uint32_t nxt = a / 3u;
    rev = rev * 3u + (a - nxt * 3u);
    inv_n = inv_n * inv_base;
    a = nxt;
  }
  return fminf(static_cast<float>(rev) * inv_n, kOneMinusEpsilon);
}

// Dims from 2 on: the radical inverse of index in `base` with each digit
// permuted by perm (base entries), plus the tail of the infinite string of
// perm[0] digits (scrambled_radical_inverse).
RS_HD float scrambled(uint32_t index, uint32_t base, const uint16_t* perm) {
  const float inv_base = 1.0f / static_cast<float>(base);
  uint32_t a = index, rev = 0u;
  float inv_n = 1.0f;
  while (a > 0u) {
    const uint32_t nxt = a / base;
    rev = rev * base + perm[a - nxt * base];
    inv_n = inv_n * inv_base;
    a = nxt;
  }
  const float tail = inv_base * static_cast<float>(perm[0]) / (1.0f - inv_base);
  return fminf(inv_n * (static_cast<float>(rev) + tail), kOneMinusEpsilon);
}

}  // namespace halton
