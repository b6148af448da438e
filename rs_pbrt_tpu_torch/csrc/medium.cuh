// The grid media's per-lane math, shared by M1 and M2 (medium.cu) and M3
// (medium_grad.cu): the hash RNG of utils/rng.py, a medium's constants and
// ops/medium.py's trilinear grid_density, each in the plain versions' order
// of operations (see medium.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace medium {

constexpr int kSteps = 16;  // volpath.py:41 TRACK_STEPS
constexpr float kOneMinusEps = 0x1.fffffep-1f;  // FLOAT_ONE_MINUS_EPSILON
constexpr float kTwoPowM32 = 0x1p-32f;

// utils/rng.py: the lowbias32 finalizer and the boost-style combine
__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}
__device__ __forceinline__ uint32_t hash_combine(uint32_t a, uint32_t b) {
  return hash_u32(a ^ (b + 0x9E3779B9u + (a << 6) + (a >> 2)));
}
// uniform_float(prefix keys..., k, seed) with the prefix's combine done
__device__ __forceinline__ float uniform(uint32_t prefix, uint32_t k, uint32_t seed) {
  const uint32_t h = hash_u32(hash_combine(hash_combine(prefix, k), seed));
  return fminf(__uint2float_rn(h) * kTwoPowM32, kOneMinusEps);
}

// torch.clamp keeps NaN
__device__ __forceinline__ float clamp_min(float x, float c) { return isnan(x) ? x : fmaxf(x, c); }
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}
// torch.minimum propagates NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}

struct Medium {
  const float* grid;  // this medium's (D, H, W) grid
  float m[16];        // world to the unit medium cube, row-major
  int D, H, W;
  float inv_max;      // 1 / max(mean(sigma_t) max_density, 1e-12)
  float max_d;        // max(max_density, 1e-12)
};

__device__ __forceinline__ Medium load_medium(const float* grid, int D, int H, int W,
                                              const float* w2m, const float* sigma_a,
                                              const float* sigma_s, const float* max_density,
                                              int mid, float sigma_t3[3]) {
  Medium md;
  md.grid = grid + static_cast<long long>(mid) * D * H * W;
  for (int k = 0; k < 16; ++k) md.m[k] = __ldg(w2m + 16 * mid + k);
  md.D = D;
  md.H = H;
  md.W = W;
  for (int c = 0; c < 3; ++c) sigma_t3[c] = __ldg(sigma_a + 3 * mid + c) + __ldg(sigma_s + 3 * mid + c);
  const float sigma_t = (sigma_t3[0] + sigma_t3[1] + sigma_t3[2]) * (1.0f / 3.0f);
  const float max_d = __ldg(max_density + mid);
  md.inv_max = 1.0f / clamp_min(sigma_t * max_d, 1e-12f);
  md.max_d = clamp_min(max_d, 1e-12f);
  return md;
}

// the voxel coordinate clamped to [0, n-1] (NaN reads voxel 0; only points
// inside the cube reach here)
__device__ __forceinline__ int tap(float x, int n) {
  if (isnan(x)) x = 0.0f;
  return static_cast<int>(fminf(fmaxf(x, 0.0f), static_cast<float>(n - 1)));
}

// ops/medium.py grid_density at world point (px, py, pz)
__device__ __forceinline__ float density(const Medium& md, float px, float py, float pz) {
  const float* m = md.m;
  const float w = m[12] * px + m[13] * py + m[14] * pz + m[15];
  const float x = (m[0] * px + m[1] * py + m[2] * pz + m[3]) / w;
  const float y = (m[4] * px + m[5] * py + m[6] * pz + m[7]) / w;
  const float z = (m[8] * px + m[9] * py + m[10] * pz + m[11]) / w;
  if (!(x >= 0.0f && x < 1.0f && y >= 0.0f && y < 1.0f && z >= 0.0f && z < 1.0f)) return 0.0f;
  const float gx = x * static_cast<float>(md.W) - 0.5f;
  const float gy = y * static_cast<float>(md.H) - 0.5f;
  const float gz = z * static_cast<float>(md.D) - 0.5f;
  const float x0 = floorf(gx), y0 = floorf(gy), z0 = floorf(gz);
  const float fx = gx - x0, fy = gy - y0, fz = gz - z0;
  float acc = 0.0f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const int zi = tap(z0 + static_cast<float>(dz), md.D);
    const float wz = dz ? fz : 1.0f - fz;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int yi = tap(y0 + static_cast<float>(dy), md.H);
      const float wy = dy ? fy : 1.0f - fy;
      const float* row = md.grid + (static_cast<long long>(zi) * md.H + yi) * md.W;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int xi = tap(x0 + static_cast<float>(dx), md.W);
        const float wx = dx ? fx : 1.0f - fx;
        acc = acc + (wx * wy) * wz * __ldg(row + xi);
      }
    }
  }
  return acc;
}

}  // namespace medium
