// M1 and M2: delta and ratio tracking through grid media.
//
// Replace two XLA loops of the JAX package's volumetric path integrator
// (rs_pbrt_tpu/models/integrators/volpath.py), run once a bounce each in a
// scene with a density-grid medium:
// - M1 delta_kernel: _delta_track (volpath.py:57, reference grid.rs:209-
//   271), the distance to a real collision on [0, t_max]: up to 16 steps
//   t += -log(1 - u1) / (mean(sigma_t) max_density), each ending the walk
//   past t_max or, with probability density(p) / max_density (u2 below
//   it), at a real collision.  Out: sampled, t = min(t, t_max) and the
//   weight, sigma_s / sigma_t where sampled, else 1.
// - M2 ratio_kernel: _ratio_track_tr (volpath.py:86, grid.rs:155-208), the
//   transmittance of [0, dist]: the same steps, each multiplying Tr by
//   clamp(1 - density(p) / max_density, 0, 1) until one passes dist.
// The density is ops/medium.py's grid_density (volpath.py:48 _density_at,
// rs_pbrt_tpu/ops/medium.py:73): the point into the unit medium cube by
// the medium's world-to-medium matrix, 0 outside it, else the trilinear sum
// of 8 voxels, taken dz, dy, dx, of the grid of the ray's own medium (the
// JAX function computes every grid and selects the ray's, which gives the
// same value).  The uniforms are utils/rng.py's hash of (lane key, bounce,
// 2i, seed) and (.., 2i + 1, ..) for M1, (lane key, salt, 7000 + i, seed)
// for M2, in 32-bit words.
//
// Each thread computes its ray's steps with the plain versions' ops in
// their order (ops/medium_kernel.py delta_track_plain, ratio_track_plain):
// --fmad=false and no fast math, so each product and sum rounds alone, and
// logf is the card's IEEE-accurate log, the one torch's CUDA log calls.
// torch's CUDA kernels divide by a Python number as a product with its f32
// reciprocal (div_true_kernel_cuda), so the mean of sigma_t's three
// channels is their sum times 1.0f / 3.0f here, as the plain version on the
// card computes it.  A walk that ends stops: its later steps change
// nothing in the plain loop either.  Clamps keep NaN, as torch.clamp does.
//
// What bounds it on the card: a live step is ~40 integer operations of
// hash, a log, the 4x3 transform and its divide, and 8 voxel reads with
// their weights (~45 f32 operations); a ray's own data is 37 bytes in and
// 17 (M1) or 4 (M2) out.  Where rays start in one region of a grid (the
// camera rays of a bounce, the shadow rays to one light), neighbouring
// threads read neighbouring voxels, and a 128^3 grid (8 MB) stays in the
// 50 MB L2, so the distinct voxels read once from memory are few and the
// kernel is bound by its operations and by the latency of its dependent
// taps.  What the design does about it: this is the first, simple form.
// One thread a ray, its taps through the read-only cache (__ldg); rays
// that leave the medium or reach their end early free their warp's slot
// for no other work.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "medium.cuh"

namespace {

using namespace medium;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
delta_kernel(const float* __restrict__ grid, int D, int H, int W, const float* __restrict__ w2m,
             const float* __restrict__ sigma_a, const float* __restrict__ sigma_s,
             const float* __restrict__ max_density, const int* __restrict__ mid,
             const uint8_t* __restrict__ in_med, const float* __restrict__ o,
             const float* __restrict__ d, const float* __restrict__ t_max,
             const int* __restrict__ lane_key, int n, uint32_t bounce, uint32_t seed,
             uint8_t* __restrict__ sampled_out, float* __restrict__ t_out,
             float* __restrict__ weight_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = mid[i];
  float sigma_t3[3];
  const Medium md = load_medium(grid, D, H, W, w2m, sigma_a, sigma_s, max_density, k, sigma_t3);
  const float tm = t_max[i];
  float t = 0.0f;
  bool sampled = false;
  if (in_med[i]) {
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const uint32_t prefix = hash_combine(static_cast<uint32_t>(lane_key[i]), bounce);
    for (int s = 0; s < kSteps; ++s) {
      const float u1 = uniform(prefix, 2u * s, seed);
      const float u2 = uniform(prefix, 2u * s + 1u, seed);
      const float t_new = t - logf(clamp_min(1.0f - u1, 1e-12f)) * md.inv_max;
      if (t_new >= tm) break;  // past the segment: t stays
      const float dens = density(md, ox + t_new * dx, oy + t_new * dy, oz + t_new * dz);
      t = t_new;
      if (u2 < dens / md.max_d) {
        sampled = true;
        break;
      }
    }
  }
  sampled_out[i] = sampled;
  t_out[i] = nan_min(t, tm);
  for (int c = 0; c < 3; ++c) {
    weight_out[3 * i + c] =
        sampled ? __ldg(sigma_s + 3 * k + c) / clamp_min(sigma_t3[c], 1e-12f) : 1.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
ratio_kernel(const float* __restrict__ grid, int D, int H, int W, const float* __restrict__ w2m,
             const float* __restrict__ sigma_a, const float* __restrict__ sigma_s,
             const float* __restrict__ max_density, const int* __restrict__ mid,
             const uint8_t* __restrict__ in_med, const float* __restrict__ o,
             const float* __restrict__ d, const float* __restrict__ dist,
             const int* __restrict__ lane_key, int n, uint32_t salt, uint32_t seed,
             float* __restrict__ tr_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float tr = 1.0f;
  if (in_med[i]) {
    float sigma_t3[3];
    const Medium md =
        load_medium(grid, D, H, W, w2m, sigma_a, sigma_s, max_density, mid[i], sigma_t3);
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float seg = dist[i];
    const uint32_t prefix = hash_combine(static_cast<uint32_t>(lane_key[i]), salt);
    float t = 0.0f;
    for (int s = 0; s < kSteps; ++s) {
      const float u1 = uniform(prefix, 7000u + s, seed);
      const float t_new = t - logf(clamp_min(1.0f - u1, 1e-12f)) * md.inv_max;
      if (t_new >= seg) break;
      const float dens = density(md, ox + t_new * dx, oy + t_new * dy, oz + t_new * dz);
      tr = tr * clamp01(1.0f - dens / md.max_d);
      t = t_new;
    }
  }
  tr_out[i] = clamp01(tr);
}

}  // namespace

extern "C" int rs_delta_track(const void* grid, int K, int D, int H, int W, const void* w2m,
                              const void* sigma_a, const void* sigma_s, const void* max_density,
                              const void* mid, const void* in_med, const void* o, const void* d,
                              const void* t_max, const void* lane_key, int n, unsigned bounce,
                              unsigned seed, void* sampled, void* t, void* weight, void* stream) {
  (void)K;
  if (n == 0) return 0;
  delta_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grid), D, H, W, static_cast<const float*>(w2m),
      static_cast<const float*>(sigma_a), static_cast<const float*>(sigma_s),
      static_cast<const float*>(max_density), static_cast<const int*>(mid),
      static_cast<const uint8_t*>(in_med), static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<const float*>(t_max),
      static_cast<const int*>(lane_key), n, bounce, seed, static_cast<uint8_t*>(sampled),
      static_cast<float*>(t), static_cast<float*>(weight));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rs_ratio_track(const void* grid, int K, int D, int H, int W, const void* w2m,
                              const void* sigma_a, const void* sigma_s, const void* max_density,
                              const void* mid, const void* in_med, const void* o, const void* d,
                              const void* dist, const void* lane_key, int n, unsigned salt,
                              unsigned seed, void* tr, void* stream) {
  (void)K;
  if (n == 0) return 0;
  ratio_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grid), D, H, W, static_cast<const float*>(w2m),
      static_cast<const float*>(sigma_a), static_cast<const float*>(sigma_s),
      static_cast<const float*>(max_density), static_cast<const int*>(mid),
      static_cast<const uint8_t*>(in_med), static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<const float*>(dist),
      static_cast<const int*>(lane_key), n, salt, seed, static_cast<float*>(tr));
  return static_cast<int>(cudaGetLastError());
}
