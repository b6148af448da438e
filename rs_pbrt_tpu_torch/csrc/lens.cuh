// The realistic camera's per-lane ray generation, L1's (lens.cu).
//
// One lane: its film point, the exit-pupil bin of its radius, the point on
// the rear element, the trace from the rear element to the front
// (realistic.rs:266-327), the world-space ray and the cos^4 weight.  The
// ops are the plain version's (ops/lens_kernel.py lens_rays_plain, the JAX
// package's generate_rays realistic branch with trace_from_film_jnp) in
// their order, each f32 op rounded alone (--fmad=false); the element
// constants arrive rounded to f32 as the JAX loop's Python floats round.
// The trace stops at a lane's first failed test: after it the plain
// version's loop leaves o and d as they are.  RS_HD marks the functions:
// device and inline unless the includer defines it.
#pragma once

#include <math.h>

#ifndef RS_HD
#define RS_HD __device__ __forceinline__
#endif

namespace lens {

constexpr int kMaxElements = 32;  // ops/lens_kernel.py MAX_ELEMENTS
constexpr int kBins = 64;  // models/realistic.py N_PUPIL_BINS
constexpr int kElementFloats = 8;
constexpr int kLaneFloats = 12;

// One element's row, rear element first (ops/lens_kernel.element_consts):
// sphere (0: the aperture stop), concave (curv < 0), z (the stop's plane or
// the sphere's centre), curv^2, aperture radius^2, eta_i / eta_t, its square
enum { kSphere = 0, kConcave, kZ, kC2, kAp2, kEr, kEr2 };
// The lane constants (ops/lens_kernel.lane_consts), in this order
enum { kResX = 0, kResY, kXExt, kNegHalfX, kYExt, kNegHalfY, kHalfDiag, kRearZ, kArea0,
       kWScale, kRz2, kSimple };

// torch.clamp(a, min=c) / jnp.maximum(a, c): NaN stays NaN
RS_HD float clamp_min(float a, float c) { return (a >= c || a != a) ? a : c; }
// torch.minimum / torch.maximum: NaN if either is NaN
RS_HD float min_nan(float a, float b) { return (a != a || b != b) ? a + b : (b < a ? b : a); }
RS_HD float max_nan(float a, float b) { return (a != a || b != b) ? a + b : (b > a ? b : a); }

// cl: the lane constants; el: n_el rows of kElementFloats; pupil: kBins
// rows (x0, y0, x1, y1); m: cam_to_world row-major.  Writes o, d and the
// weight (0 where the trace failed).
RS_HD void trace_lane(const float* cl, const float* el, int n_el, const float* pupil,
                      const float* m, float px, float py, float u0, float u1, float* o_out,
                      float* d_out, float* w_out) {
  // the film point: (-p2.x, p2.y, 0) (realistic.rs:206-211)
  const float s0 = px / cl[kResX];
  const float s1 = py / cl[kResY];
  const float p2x = cl[kNegHalfX] + s0 * cl[kXExt];
  const float p2y = cl[kNegHalfY] + s1 * cl[kYExt];
  const float fx = -p2x;
  const float fy = p2y;
  const float r_film = sqrtf(fx * fx + fy * fy);
  const float v = r_film / cl[kHalfDiag] * static_cast<float>(kBins);
  int bin = v >= static_cast<float>(kBins) ? kBins - 1 : static_cast<int>(v);
  bin = bin < 0 ? 0 : (bin > kBins - 1 ? kBins - 1 : bin);
  const float* pb = pupil + 4 * bin;
  const float area = clamp_min((pb[2] - pb[0]) * (pb[3] - pb[1]), 0.0f);
  const float lx = (1.0f - u0) * pb[0] + u0 * pb[2];
  const float ly = (1.0f - u1) * pb[1] + u1 * pb[3];
  const float rf = clamp_min(r_film, 1e-20f);
  const float sin_t = r_film > 0.0f ? fy / rf : 0.0f;
  const float cos_t = r_film > 0.0f ? fx / rf : 1.0f;
  const float prx = cos_t * lx - sin_t * ly;
  const float pry = sin_t * lx + cos_t * ly;
  const float dfx = prx - fx;
  const float dfy = pry - fy;
  const float dfz = cl[kRearZ];
  // the trace, in the flipped frame (z negated)
  float ox = fx, oy = fy, oz = -0.0f;
  float dx = dfx, dy = dfy, dz = -dfz;
  bool ok = true;
  for (int k = 0; k < n_el; ++k) {
    const float* e = el + kElementFloats * k;
    const bool sphere = e[kSphere] != 0.0f;
    float t, nx = 0.0f, ny = 0.0f, nz = 0.0f;
    if (!sphere) {
      if (!(dz < 0.0f)) { ok = false; break; }
      t = (e[kZ] - oz) / (dz == 0.0f ? 1e-12f : dz);
    } else {
      const float ocz = oz - e[kZ];
      const float a = dx * dx + dy * dy + dz * dz;
      const float b = 2.0f * (dx * ox + dy * oy + dz * ocz);
      const float c = (ox * ox + oy * oy + ocz * ocz) - e[kC2];
      const float disc = b * b - 4.0f * a * c;
      if (!(disc >= 0.0f)) { ok = false; break; }
      const float sq = sqrtf(clamp_min(disc, 0.0f));
      const float q = b < 0.0f ? -0.5f * (b - sq) : -0.5f * (b + sq);
      const float t0 = q / (a == 0.0f ? 1e-12f : a);
      const float t1 = c / (q == 0.0f ? 1e-12f : q);
      const bool closer = (dz > 0.0f) != (e[kConcave] != 0.0f);
      t = closer ? min_nan(t0, t1) : max_nan(t0, t1);
      if (!(t >= 0.0f)) { ok = false; break; }
      const float hx = ox + t * dx, hy = oy + t * dy, hz = oz + t * dz;
      const float hz_c = hz - e[kZ];
      const float ln = clamp_min(sqrtf(hx * hx + hy * hy + hz_c * hz_c), 1e-12f);
      nx = hx / ln;
      ny = hy / ln;
      nz = hz_c / ln;
      if (nx * -dx + ny * -dy + nz * -dz < 0.0f) {
        nx = -nx;
        ny = -ny;
        nz = -nz;
      }
    }
    const float hx = ox + t * dx, hy = oy + t * dy, hz = oz + t * dz;
    const float r2 = hx * hx + hy * hy;
    if (!(r2 <= e[kAp2])) { ok = false; break; }
    ox = hx;
    oy = hy;
    oz = hz;
    if (sphere) {
      const float ln = clamp_min(sqrtf(dx * dx + dy * dy + dz * dz), 1e-12f);
      const float wix = -(dx / ln), wiy = -(dy / ln), wiz = -(dz / ln);
      const float cos_i = nx * wix + ny * wiy + nz * wiz;
      const float sin2_t = e[kEr2] * clamp_min(1.0f - cos_i * cos_i, 0.0f);
      if (!(sin2_t < 1.0f)) { ok = false; break; }
      const float ct = sqrtf(clamp_min(1.0f - sin2_t, 0.0f));
      const float g = e[kEr] * cos_i - ct;
      dx = -wix * e[kEr] + nx * g;
      dy = -wiy * e[kEr] + ny * g;
      dz = -wiz * e[kEr] + nz * g;
    }
  }
  oz = oz * -1.0f;
  dz = dz * -1.0f;
  // to world space: utils/transform.py xform_point, xform_vector, then the
  // direction normalized
  const float w = m[12] * ox + m[13] * oy + m[14] * oz + m[15];
  for (int i = 0; i < 3; ++i) {
    o_out[i] = (m[4 * i] * ox + m[4 * i + 1] * oy + m[4 * i + 2] * oz + m[4 * i + 3]) / w;
  }
  float dw[3];
  for (int i = 0; i < 3; ++i) dw[i] = m[4 * i] * dx + m[4 * i + 1] * dy + m[4 * i + 2] * dz;
  const float dl = clamp_min(sqrtf(clamp_min(dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2],
                                             1e-30f)), 1e-20f);
  for (int i = 0; i < 3; ++i) d_out[i] = dw[i] / dl;
  // cos^4 of the film-to-rear direction, times the pupil bin's area
  const float fl = clamp_min(sqrtf(clamp_min(dfx * dfx + dfy * dfy + dfz * dfz, 1e-30f)), 1e-20f);
  const float cos_theta = dfz / fl;
  const float c2 = cos_theta * cos_theta;
  const float cos4 = c2 * c2;
  float wt = cl[kSimple] != 0.0f ? cos4 * area / cl[kArea0]
                                 : cl[kWScale] * cos4 * area / cl[kRz2];
  *w_out = ok ? wt : 0.0f;
}

}  // namespace lens
