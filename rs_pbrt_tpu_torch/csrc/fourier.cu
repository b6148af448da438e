// F1 and F2: the Fourier BSDF's evaluation and sampling.
//
// Replace two XLA loops of the JAX package's tabulated BSDF
// (rs_pbrt_tpu/ops/fourier_bsdf.py, reference reflection.rs:1480-1750):
// - F1 eval_kernel: fourier_f (:212) and fourier_pdf (:232) at (wo, wi):
//   the Catmull-Rom weights in mu_i and mu_o, the 16 cells' coefficients
//   summed tap by tap in registers, the three channels' cosine series by
//   the double-angle recurrence (the :186 scan), the RGB transform, the
//   eta^2 of transmission, and the pdf's luminance over the 4-row rho.
// - F2 sample_kernel: fourier_sample (:249): the interpolated a0 and cdf
//   rows at mu_o, their inversion in mu by 12 bracketed Newton steps, the
//   luminance coefficients at (mu_i, mu_o), 20 bracketed Newton steps in
//   phi over the 63-term sine/cosine recurrence (the :339 scan in the
//   :358 loop) and the direction wi.  The JAX bsdf_sample reads only wi
//   (bsdf.py:1621): f and pdf at wi are F1's.
// The per-lane math is fourier.cuh's, the plain versions' ops in their
// order (ops/fourier_bsdf.py fourier_eval_plain, fourier_sample_plain).
// Lanes whose `on` is false write zeros, as the JAX `where` gives them.
//
// What bounds it on the card: a lane's series reads 16 cells x 3 channels
// of each order up to the cells' largest (the table, 3.1 MB at 64 nodes,
// stays in the 50 MB L2), ~2 flops a tap, and F2's 20 x 63 recurrence
// steps.  A lane on the lobe reads 25 (F1) or 21 (F2) bytes and writes 16
// or 12; a lane off it reads its flag and writes zeros.  The lobe's lanes
// are few (under 1% on the material grid), so the bytes of the lanes off
// it set the bound.
// What the design does about it: this is the first, simple form, one
// thread a lane; each lane stops its sums at the largest order of its 16
// cells (the dense rows are zero beyond, so the finite sums do not change).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fourier.cuh"

namespace {

constexpr int kThreads = 128;

struct TableArgs {
  const float* mu;
  const float* dense;
  const int* m;
  const float* cdf;
  const float* a0;
  int n_mu;
  const float* eta;
};

__device__ __forceinline__ fou::Table table_of(const TableArgs& a) {
  return fou::Table{a.mu, a.dense, a.m, a.cdf, a.a0, a.n_mu, __ldg(a.eta)};
}

__global__ void eval_kernel(TableArgs ta, const float* __restrict__ wo,
                            const float* __restrict__ wi, const uint8_t* __restrict__ on, int n,
                            float* __restrict__ f, float* __restrict__ pdf) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float fl[3] = {0.0f, 0.0f, 0.0f}, p = 0.0f;
  if (on[i]) {
    const fou::Table T = table_of(ta);
    const float o[3] = {wo[3 * i], wo[3 * i + 1], wo[3 * i + 2]};
    const float w[3] = {wi[3 * i], wi[3 * i + 1], wi[3 * i + 2]};
    fou::eval_lane(T, o, w, fl, &p);
  }
  f[3 * i] = fl[0];
  f[3 * i + 1] = fl[1];
  f[3 * i + 2] = fl[2];
  pdf[i] = p;
}

__global__ void sample_kernel(TableArgs ta, const float* __restrict__ wo,
                              const float* __restrict__ u2, const uint8_t* __restrict__ on, int n,
                              float* __restrict__ wi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float w[3] = {0.0f, 0.0f, 0.0f};
  if (on[i]) {
    const fou::Table T = table_of(ta);
    const float o[3] = {wo[3 * i], wo[3 * i + 1], wo[3 * i + 2]};
    fou::sample_lane(T, o, u2[2 * i], u2[2 * i + 1], w);
  }
  for (int c = 0; c < 3; ++c) wi[3 * i + c] = w[c];
}

TableArgs table_args(const void* mu, const void* dense, const void* m, const void* cdf,
                     const void* a0, int n_mu, const void* eta) {
  return TableArgs{static_cast<const float*>(mu), static_cast<const float*>(dense),
                   static_cast<const int*>(m), static_cast<const float*>(cdf),
                   static_cast<const float*>(a0), n_mu, static_cast<const float*>(eta)};
}

}  // namespace

extern "C" int rs_fourier_eval(const void* mu, const void* dense, const void* m, const void* cdf,
                               const void* a0, int n_mu, const void* eta, const void* wo,
                               const void* wi, const void* on, int n, void* f, void* pdf,
                               void* stream) {
  if (n == 0) return 0;
  eval_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table_args(mu, dense, m, cdf, a0, n_mu, eta), static_cast<const float*>(wo),
      static_cast<const float*>(wi), static_cast<const uint8_t*>(on), n, static_cast<float*>(f),
      static_cast<float*>(pdf));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rs_fourier_sample(const void* mu, const void* dense, const void* m,
                                 const void* cdf, const void* a0, int n_mu, const void* eta,
                                 const void* wo, const void* u2, const void* on, int n, void* wi,
                                 void* stream) {
  if (n == 0) return 0;
  sample_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      table_args(mu, dense, m, cdf, a0, n_mu, eta), static_cast<const float*>(wo),
      static_cast<const float*>(u2), static_cast<const uint8_t*>(on), n, static_cast<float*>(wi));
  return static_cast<int>(cudaGetLastError());
}
