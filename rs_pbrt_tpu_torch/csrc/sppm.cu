// S1: SPPM's photon deposit, gathered from the visible points' side.
//
// Replaces the JAX package's _deposit_events (rs_pbrt_tpu/models/
// integrators/sppm.py:295), an XLA fori_loop of 27 * max_ev steps
// (:363-382), each a row gather, a distance test and a BSDF evaluation
// for every visible point (VP).  Here one thread takes one VP and walks
// the same steps in the same order: the 27 neighbour cells (offsets a, b,
// c in -1, 0, 1, nested), and in each the first max_ev rows of the cell's
// bucket in the event table sorted by cell.  A row is 11 f32: the event's
// point (3), its wi (3), its beta times its reservoir weight w (3), w and
// its cell id (exact in f32).  A row is kept where its cell is the
// neighbour cell (the JAX in_b test; the table is sorted by cell, so the
// first row of another cell, or the table's end, ends the bucket: the
// rows after it would all fail the test) and as near where |p_e - p|^2 <=
// r^2.  Its wi goes into the VP's shading frame, the VP's BSDF gives f,
// and phi += beta_w * f, m += w, in registers, in the plain loop's order,
// so the sums round as its do.
//
// A VP's BSDF is one lobe, Lambert, Oren-Nayar (matte) or hair, or, in a
// scene of the other materials, a general one (kind -1): up to six slots of
// reflecting lobes and the Fourier lobe, evaluated whole per pair by
// bxdf.cuh (with fourier.cuh and the scene's table).  For the one-lobe
// VPs, everything of f that depends on wo alone (Oren-
// Nayar's A, B and wo's angles; the hair lobe's variances' terms, tilts,
// azimuths, Np normalizations and attenuations) comes in per VP, computed
// by the plain functions of ops/bsdf.py; the terms of wi are computed here
// term by term as ops/bsdf.py's oren_nayar_f and hair_f compute them.
// torch's CUDA ops divide by a Python number as a product with its f32
// reciprocal (div_true_kernel_cuda), and the code below does the same
// where the plain version divides by a constant (the hair lobe's Bessel
// series and its last lobe's 1 / (2 pi)).  Built with --fmad=false.
//
// What bounds it on the card: each tested (VP, event) pair reads a 44-byte
// row (from L2 for the most part: the VPs of a cell read the same
// buckets) for ~12 f32 operations, and each near pair adds the BSDF's (~20
// for Lambert, ~60 for Oren-Nayar, ~300 for hair).  One thread a VP, no
// shared memory: the first form.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "bxdf.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowCols = 11;
constexpr int kVpCols = 19;  // p, ss, ts, ns, wo (local), r2, color
constexpr int kCoefs = 44;
constexpr int kLambert = 1;
constexpr int kHair = 10;
constexpr int kGeneral = -1;  // sppm_kernel.GENERAL: the VP's row of bxdf.cuh
constexpr float kInvPi = static_cast<float>(0.31830988618379067154);
constexpr float kPi = static_cast<float>(3.14159265358979323846);
constexpr float kTwoPi = static_cast<float>(6.28318530717958647692);
constexpr float kInvTwoPi = 1.0f / kTwoPi;

// 1 / (4^i (i!)^2) as torch takes it: the denominator in double, rounded
// to f32, its f32 reciprocal
__host__ __device__ constexpr float i0_inv(int i) {
  double f = 1.0, p4 = 1.0;
  for (int k = 2; k <= i; ++k) f *= k;
  for (int k = 0; k < i; ++k) p4 *= 4.0;
  return 1.0f / static_cast<float>(p4 * f * f);
}
__constant__ float kI0Inv[10] = {i0_inv(0), i0_inv(1), i0_inv(2), i0_inv(3), i0_inv(4),
                                 i0_inv(5), i0_inv(6), i0_inv(7), i0_inv(8), i0_inv(9)};
constexpr float kNegLog2Pi = static_cast<float>(-1.8378770664093453);  // -log(2 pi)

// torch.clamp(x, min=c) and clamp(x, lo, hi) keep NaN
__device__ __forceinline__ float clamp_min(float x, float c) { return isnan(x) ? x : fmaxf(x, c); }
__device__ __forceinline__ float clamp11(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, -1.0f), 1.0f);
}

// torch.remainder for f32 (fmod, then the divisor's sign)
__device__ __forceinline__ float remainder(float a, float b) {
  float mod = fmodf(a, b);
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) mod += b;
  return mod;
}

// ---- Oren-Nayar (bsdf.py oren_nayar_f); c: A, B, sin_to, cos_phi(wo),
// sin_phi(wo), |cos wo| ----
__device__ __forceinline__ float oren_nayar(const float* c, float wx, float wy, float wz) {
  const float sin2 = clamp_min(1.0f - wz * wz, 0.0f);
  const float sin_ti = sqrtf(clamp_min(sin2, 1e-24f));
  const float cphi = sin2 == 0.0f ? 1.0f : clamp11(wx / sin_ti);
  const float sphi = sin2 == 0.0f ? 0.0f : clamp11(wy / sin_ti);
  const float cos_diff = cphi * c[3] + sphi * c[4];
  const float sin_to = c[2];
  const float max_cos = (sin_ti > 1e-4f && sin_to > 1e-4f) ? clamp_min(cos_diff, 0.0f) : 0.0f;
  const float aci = fabsf(wz), aco = c[5];
  const float sin_a = aci > aco ? sin_to : sin_ti;
  const float tan_b = aci > aco ? sin_ti / clamp_min(aci, 1e-7f) : sin_to / clamp_min(aco, 1e-7f);
  return kInvPi * (c[0] + c[1] * max_cos * sin_a * tan_b);
}

// ---- the hair lobe (bsdf.py hair_f) ----
__device__ __forceinline__ float hair_i0(float x) {
  float val = 0.0f, x2i = 1.0f;
  for (int i = 0; i < 10; ++i) {
    val = val + x2i * kI0Inv[i];
    x2i = x2i * x * x;
  }
  return val;
}

__device__ __forceinline__ float hair_log_i0(float x) {
  if (x > 12.0f) {
    const float xm = clamp_min(x, 1e-12f);
    return x + 0.5f * ((logf(1.0f / xm) + kNegLog2Pi) + 1.0f / (8.0f * xm));
  }
  return logf(clamp_min(hair_i0(x), 1e-37f));
}

// vt: v, 1 / v, log(1 / (2 v)), sinh(1 / v) 2 v
__device__ __forceinline__ float hair_mp(float cos_ti, float cos_to, float sin_ti, float sin_to,
                                         const float* vt) {
  const float v = vt[0];
  const float a = cos_ti * cos_to / v;
  const float b = sin_ti * sin_to / v;
  if (v <= 0.1f) return expf(hair_log_i0(a) - b - vt[1] + 0.6931f + vt[2]);
  return expf(-b) * hair_i0(a) / vt[3];
}

__device__ __forceinline__ float hair_np(float phi, float s, float off, float norm) {
  float dphi = phi - off;
  dphi = remainder(dphi + kPi, kTwoPi) - kPi;
  const float e = expf(-fabsf(dphi) / s);
  const float logistic = e / (s * ((1.0f + e) * (1.0f + e)));
  return logistic / norm;
}

__device__ __forceinline__ float nan_to_num(float x) {
  if (isnan(x)) return 0.0f;
  if (isinf(x)) return x > 0.0f ? 0.0f : -FLT_MAX;
  return x;
}

// c: the wo terms of ops/sppm_kernel.pack_vps (HAIR_* offsets there)
__device__ __forceinline__ void hair(const float* c, float wx, float wy, float wz, float f[3]) {
  const float sin_ti = wx;
  const float cos_ti = sqrtf(clamp_min(1.0f - sin_ti * sin_ti, 0.0f));
  const float phi = atan2f(wz, wy) - c[24];
  float fs[3] = {0.0f, 0.0f, 0.0f};
  for (int p = 0; p < 3; ++p) {
    const float mp = hair_mp(cos_ti, c[17 + 2 * p], sin_ti, c[16 + 2 * p], c + 4 * p);
    const float w = mp * hair_np(phi, c[25], c[26 + 2 * p], c[27 + 2 * p]);
    for (int k = 0; k < 3; ++k) fs[k] = fs[k] + c[32 + 3 * p + k] * w;
  }
  const float w = hair_mp(cos_ti, c[23], sin_ti, c[22], c + 12) * kInvTwoPi;
  for (int k = 0; k < 3; ++k) fs[k] = fs[k] + c[41 + k] * w;
  const float aci = fabsf(wz);
  for (int k = 0; k < 3; ++k) {
    const float x = aci > 0.0f ? fs[k] / clamp_min(aci, 1e-7f) : fs[k];
    f[k] = nan_to_num(x);
  }
}

__global__ void __launch_bounds__(kThreads)
    deposit_kernel(const float* __restrict__ rows, long long n_ev,
                   const long long* __restrict__ start, const uint8_t* __restrict__ okc,
                   const float* __restrict__ nbf, const float* __restrict__ vps,
                   const int* __restrict__ kind, const float* __restrict__ coef,
                   const float* __restrict__ gen, fou::Table table, const float* fou_eta,
                   int n_vp, int max_ev, float* __restrict__ phi_out,
                   float* __restrict__ m_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_vp) return;
  if (fou_eta != nullptr) table.eta = *fou_eta;
  const fou::Table* fou_table = fou_eta != nullptr ? &table : nullptr;
  const float* v = vps + static_cast<size_t>(i) * kVpCols;
  const float px = v[0], py = v[1], pz = v[2];
  const float r2 = v[15];
  const int kd = kind[i];
  const float* c = coef + static_cast<size_t>(i) * kCoefs;
  float phi0 = 0.0f, phi1 = 0.0f, phi2 = 0.0f, m = 0.0f;
  for (int ci = 0; ci < 27; ++ci) {
    const size_t at = static_cast<size_t>(ci) * n_vp + i;
    if (!okc[at]) continue;
    const long long s0 = start[at];
    const float cell = nbf[at];
    for (int k = 0; k < max_ev; ++k) {
      const long long e = s0 + k;
      if (e >= n_ev) break;
      const float* row = rows + e * kRowCols;
      if (row[10] != cell) break;  // the bucket ends: no later row is in it
      const float dx = row[0] - px, dy = row[1] - py, dz = row[2] - pz;
      if (!(dx * dx + dy * dy + dz * dz <= r2)) continue;
      // wi into the VP's frame (ss, ts, ns)
      const float wx = row[3] * v[3] + row[4] * v[4] + row[5] * v[5];
      const float wy = row[3] * v[6] + row[4] * v[7] + row[5] * v[8];
      const float wz = row[3] * v[9] + row[4] * v[10] + row[5] * v[11];
      float f[3];
      if (kd == kHair) {
        hair(c, wx, wy, wz, f);
      } else if (kd == kGeneral) {
        bxdf::general_f(gen + static_cast<size_t>(i) * bxdf::kGenCols, fou_table,
                        bxdf::V3{v[12], v[13], v[14]}, bxdf::V3{wx, wy, wz}, f);
      } else {
        // Lambert or Oren-Nayar on the reflecting side, plus slot 1's 0
        const float g = kd == kLambert ? kInvPi : oren_nayar(c, wx, wy, wz);
        const bool same = v[14] * wz > 0.0f;
        for (int q = 0; q < 3; ++q) f[q] = (same ? v[16 + q] * g : 0.0f) + 0.0f;
      }
      phi0 = phi0 + row[6] * f[0];
      phi1 = phi1 + row[7] * f[1];
      phi2 = phi2 + row[8] * f[2];
      m = m + row[9];
    }
  }
  phi_out[3 * i] = phi0;
  phi_out[3 * i + 1] = phi1;
  phi_out[3 * i + 2] = phi2;
  m_out[i] = m;
}

}  // namespace

// gen: the general VPs' rows (null without one); mu .. eta: the scene's
// Fourier table (mu and eta null without one)
extern "C" int rs_sppm_deposit(const void* rows, long long n_ev, const void* start,
                               const void* okc, const void* nbf, const void* vps,
                               const void* kind, const void* coef, const void* gen,
                               const void* mu, const void* dense, const void* m_tab,
                               const void* cdf, const void* a0, int n_mu, const void* eta,
                               int n_vp, int max_ev, void* phi_out, void* m_out, void* stream) {
  if (n_vp == 0) return 0;
  const int grid = (n_vp + kThreads - 1) / kThreads;
  const fou::Table table{static_cast<const float*>(mu), static_cast<const float*>(dense),
                         static_cast<const int*>(m_tab), static_cast<const float*>(cdf),
                         static_cast<const float*>(a0), n_mu, 1.0f};
  deposit_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), n_ev, static_cast<const long long*>(start),
      static_cast<const uint8_t*>(okc), static_cast<const float*>(nbf),
      static_cast<const float*>(vps), static_cast<const int*>(kind),
      static_cast<const float*>(coef), static_cast<const float*>(gen), table,
      static_cast<const float*>(eta), n_vp, max_ev, static_cast<float*>(phi_out),
      static_cast<float*>(m_out));
  return static_cast<int>(cudaGetLastError());
}
