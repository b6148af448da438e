// M3: ratio tracking's vector-Jacobian product in the ray, one thread a
// lane.
//
// The backward of M2 (medium.cu ratio_kernel: the transmittance of the
// segment [0, dist] through a grid medium, the JAX package's
// _ratio_track_tr, rs_pbrt_tpu/models/integrators/volpath.py:86) in the
// ray's o and d.  JAX differentiates its unrolled XLA loop by reverse-mode
// AD; here a lane replays M2's steps (the same 16 keyed draws, (lane key,
// salt, 7000 + i, seed), the same distances, which do not depend on o or
// d, and the same end past dist), keeping each live step's factor
// f_i = clamp(1 - density(p_i) / max_density, 0, 1) at p_i = o + t_i d,
// and then carries Tr's gradient back through the product: step i gets
// g Tr_before_i, and through its clamp (passed where 0 <= 1 - dens/max <=
// 1, as torch.clamp passes it) -g / max_density into the density; the
// trilinear density's gradient in the medium point (each axis's weight
// difference over the 8 taps, times the grid's size along it), back
// through w2m's rows and its homogeneous divide to p_i, and so into o and
// t_i d.  The end test (t_i >= dist) is discrete, so dist gets nothing, as
// in JAX.  Lanes outside a medium (in_med false) give zeros.  Built with
// --fmad=false; the twin (ops/medium_kernel.ratio_track_vjp_plain)
// computes the same replay and sweep term by term in plain PyTorch.
//
// What bounds it on the card: as M2's forward (a live step's hash, log,
// transform and 8 taps), then each live step's 8 taps again and ~60 f32
// operations of its reverse; a ray's own data is 37 bytes and 4 of
// upstream gradient in, 24 out.  What the design does about it: nothing
// yet; this is the first, simple form, one thread a ray, the live steps'
// factors kept in registers between the two sweeps.
#include <cuda_runtime.h>
#include <stdint.h>

#include "medium.cuh"

namespace {

using namespace medium;

constexpr int kThreads = 128;

// g_dens, the gradient at density(md, p), added into g_p (3)
__device__ void density_vjp(const Medium& md, const float p[3], float g_dens, float g_p[3]) {
  const float* m = md.m;
  const float w = m[12] * p[0] + m[13] * p[1] + m[14] * p[2] + m[15];
  float q[3];
  for (int i = 0; i < 3; ++i)
    q[i] = (m[4 * i] * p[0] + m[4 * i + 1] * p[1] + m[4 * i + 2] * p[2] + m[4 * i + 3]) / w;
  if (!(q[0] >= 0.0f && q[0] < 1.0f && q[1] >= 0.0f && q[1] < 1.0f && q[2] >= 0.0f &&
        q[2] < 1.0f))
    return;
  const float gx = q[0] * static_cast<float>(md.W) - 0.5f;
  const float gy = q[1] * static_cast<float>(md.H) - 0.5f;
  const float gz = q[2] * static_cast<float>(md.D) - 0.5f;
  const float x0 = floorf(gx), y0 = floorf(gy), z0 = floorf(gz);
  const float fx = gx - x0, fy = gy - y0, fz = gz - z0;
  float g_fx = 0.0f, g_fy = 0.0f, g_fz = 0.0f;
  for (int dz = 0; dz < 2; ++dz) {
    const int zi = tap(z0 + static_cast<float>(dz), md.D);
    const float wz = dz ? fz : 1.0f - fz;
    for (int dy = 0; dy < 2; ++dy) {
      const int yi = tap(y0 + static_cast<float>(dy), md.H);
      const float wy = dy ? fy : 1.0f - fy;
      const float* row = md.grid + (static_cast<long long>(zi) * md.H + yi) * md.W;
      for (int dx = 0; dx < 2; ++dx) {
        const int xi = tap(x0 + static_cast<float>(dx), md.W);
        const float wx = dx ? fx : 1.0f - fx;
        const float v = __ldg(row + xi);
        g_fx += (dx ? 1.0f : -1.0f) * wy * wz * v;
        g_fy += (dy ? 1.0f : -1.0f) * wx * wz * v;
        g_fz += (dz ? 1.0f : -1.0f) * wx * wy * v;
      }
    }
  }
  // the medium point's gradient, then xform_point's rows and divide
  const float g_q[3] = {g_dens * g_fx * static_cast<float>(md.W),
                        g_dens * g_fy * static_cast<float>(md.H),
                        g_dens * g_fz * static_cast<float>(md.D)};
  float g_w = 0.0f;
  for (int i = 0; i < 3; ++i) g_w -= g_q[i] * q[i] / w;
  for (int k = 0; k < 3; ++k)
    g_p[k] += (g_q[0] * m[k] + g_q[1] * m[4 + k] + g_q[2] * m[8 + k]) / w + g_w * m[12 + k];
}

__global__ void __launch_bounds__(kThreads)
ratio_grad_kernel(const float* __restrict__ grid, int D, int H, int W,
                  const float* __restrict__ w2m, const float* __restrict__ sigma_a,
                  const float* __restrict__ sigma_s, const float* __restrict__ max_density,
                  const int* __restrict__ mid, const uint8_t* __restrict__ in_med,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ dist, const int* __restrict__ lane_key, int n,
                  uint32_t salt, uint32_t seed, const float* __restrict__ g_tr,
                  float* __restrict__ g_o, float* __restrict__ g_d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float go[3] = {0.0f, 0.0f, 0.0f}, gd[3] = {0.0f, 0.0f, 0.0f};
  const float g = g_tr[i];
  if (in_med[i] && g != 0.0f) {
    float sigma_t3[3];
    const Medium md =
        load_medium(grid, D, H, W, w2m, sigma_a, sigma_s, max_density, mid[i], sigma_t3);
    const float oo[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
    const float dd[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
    const float seg = dist[i];
    const uint32_t prefix = hash_combine(static_cast<uint32_t>(lane_key[i]), salt);
    // forward: M2's live steps, their t and factor, and Tr before each
    float ts[kSteps], fs[kSteps], before[kSteps];
    bool pass[kSteps];
    int live = 0;
    float t = 0.0f, tr = 1.0f;
    for (int s = 0; s < kSteps; ++s) {
      const float u1 = uniform(prefix, 7000u + s, seed);
      const float t_new = t - logf(clamp_min(1.0f - u1, 1e-12f)) * md.inv_max;
      if (t_new >= seg) break;
      const float dens = density(md, oo[0] + t_new * dd[0], oo[1] + t_new * dd[1],
                                 oo[2] + t_new * dd[2]);
      const float x = 1.0f - dens / md.max_d;
      ts[live] = t_new;
      fs[live] = clamp01(x);
      pass[live] = x >= 0.0f && x <= 1.0f;
      before[live] = tr;
      tr = tr * fs[live];
      ++live;
      t = t_new;
    }
    // reverse: the final clamp passes Tr in [0, 1], then the product
    float g_acc = (tr >= 0.0f && tr <= 1.0f) ? g : 0.0f;
    for (int s = live - 1; s >= 0; --s) {
      const float g_f = g_acc * before[s];
      g_acc = g_acc * fs[s];
      if (!pass[s] || g_f == 0.0f) continue;
      const float p[3] = {oo[0] + ts[s] * dd[0], oo[1] + ts[s] * dd[1], oo[2] + ts[s] * dd[2]};
      float g_p[3] = {0.0f, 0.0f, 0.0f};
      density_vjp(md, p, -g_f / md.max_d, g_p);
      for (int k = 0; k < 3; ++k) {
        go[k] += g_p[k];
        gd[k] += ts[s] * g_p[k];
      }
    }
  }
  for (int k = 0; k < 3; ++k) {
    g_o[3 * i + k] = go[k];
    g_d[3 * i + k] = gd[k];
  }
}

}  // namespace

// M2's arguments (medium.cu rs_ratio_track) without tr, then g_tr (n,);
// out g_o, g_d (n, 3), every entry written.
extern "C" int rs_ratio_track_grad(const void* grid, int K, int D, int H, int W, const void* w2m,
                                   const void* sigma_a, const void* sigma_s,
                                   const void* max_density, const void* mid, const void* in_med,
                                   const void* o, const void* d, const void* dist,
                                   const void* lane_key, int n, unsigned salt, unsigned seed,
                                   const void* g_tr, void* g_o, void* g_d, void* stream) {
  (void)K;
  if (n == 0) return 0;
  ratio_grad_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grid), D, H, W, static_cast<const float*>(w2m),
      static_cast<const float*>(sigma_a), static_cast<const float*>(sigma_s),
      static_cast<const float*>(max_density), static_cast<const int*>(mid),
      static_cast<const uint8_t*>(in_med), static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<const float*>(dist),
      static_cast<const int*>(lane_key), n, salt, seed, static_cast<const float*>(g_tr),
      static_cast<float*>(g_o), static_cast<float*>(g_d));
  return static_cast<int>(cudaGetLastError());
}
