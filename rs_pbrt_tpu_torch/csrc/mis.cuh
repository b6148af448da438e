// W1's per-lane math (mis.cu): the MIS weight of one BDPT strategy (s, t).
//
// The plain version's ops (ops/mis_kernel.py mis_weight_plain, the JAX
// package's _mis_weight) in their order for one lane: each ratio product
// (ri * remap0(pdf_rev)) / remap0(pdf_fwd) and each sum two rounded f32
// operations, so with --fmad=false (or -ffp-contract=off on the host) both
// give the same bits.  RS_HD marks the functions: device and inline unless
// the includer defines it.
#pragma once

#include <stdint.h>

#ifndef RS_HD
#define RS_HD __device__ __forceinline__
#endif

namespace mis {

// override slots, ops/mis_kernel.py OVERRIDES' order
enum { kC1 = 0, kC2, kL1, kL2, kL0Fwd, kL0Rev, kFloatSlots };

struct Columns {
  const float* c_fwd;  // (dc, n) camera subpath pdf_fwd, slot-major
  const float* c_rev;  // (dc, n) pdf_rev
  const uint8_t* c_delta;  // (dc, n) bool
  const float* l_fwd;  // (dl, n) light subpath
  const float* l_rev;
  const uint8_t* l_delta;
  // c[t-1].pdf_rev, c[t-2].pdf_rev, l[s-1].pdf_rev, l[s-2].pdf_rev,
  // l[0].pdf_fwd, l[0].pdf_rev: (n,) each, or null where the strategy
  // sets none
  const float* ov[kFloatSlots];
  const uint8_t* ov_l0_delta;  // l[0].delta (n,) or null
  const uint8_t* l0_is_delta;  // the light origin's delta test (n,) or null: false
  long long n;
  int s, t;
};

RS_HD float remap0(float x) { return x > 0.0f ? x : 1.0f; }

RS_HD bool l_delta_at(const Columns& a, int v, long long i) {
  return (v == 0 && a.ov_l0_delta != nullptr) ? a.ov_l0_delta[i] != 0
                                              : a.l_delta[v * a.n + i] != 0;
}

// Lane i's weight: 1 / (1 + sum_ri) over the camera side from t-1 down to
// 1 and the light side from s-1 down to 0 (reference bdpt.rs:2120-2196);
// 1 where s + t == 2.
RS_HD float weight(const Columns& a, long long i) {
  if (a.s + a.t == 2) return 1.0f;
  const long long n = a.n;
  float sum_ri = 0.0f;
  float ri = 1.0f;  // the camera vertex itself is never delta
  for (int v = a.t - 1; v >= 1; --v) {
    float rev;
    if (v == a.t - 1 && a.ov[kC1] != nullptr)
      rev = a.ov[kC1][i];
    else if (v == a.t - 2 && a.ov[kC2] != nullptr)
      rev = a.ov[kC2][i];
    else
      rev = a.c_rev[v * n + i];
    ri = (ri * remap0(rev)) / remap0(a.c_fwd[v * n + i]);
    const bool d1 = a.c_delta[v * n + i] != 0;
    const bool d0 = v - 1 >= 1 && a.c_delta[(v - 1) * n + i] != 0;
    sum_ri = sum_ri + ((!d1 && !d0) ? ri : 0.0f);
  }
  ri = 1.0f;
  for (int v = a.s - 1; v >= 0; --v) {
    float rev;
    if (v == a.s - 1 && a.ov[kL1] != nullptr)
      rev = a.ov[kL1][i];
    else if (v == a.s - 2 && a.ov[kL2] != nullptr)
      rev = a.ov[kL2][i];
    else if (v == 0 && a.ov[kL0Rev] != nullptr)
      rev = a.ov[kL0Rev][i];
    else
      rev = a.l_rev[v * n + i];
    const float fwd = (v == 0 && a.ov[kL0Fwd] != nullptr) ? a.ov[kL0Fwd][i] : a.l_fwd[v * n + i];
    ri = (ri * remap0(rev)) / remap0(fwd);
    const bool prev = v > 0 ? l_delta_at(a, v - 1, i)
                            : (a.l0_is_delta != nullptr && a.l0_is_delta[i] != 0);
    sum_ri = sum_ri + ((!l_delta_at(a, v, i) && !prev) ? ri : 0.0f);
  }
  return 1.0f / (1.0f + sum_ri);
}

}  // namespace mis
