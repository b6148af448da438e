// Watertight ray-triangle tests as device functions (reference
// triangle.rs:134-449, with conservative error bounds).
//
// The port of rs_pbrt_tpu/ops/pallas_intersect.py:_ray_constants,
// _watertight_tri and _watertight_tri_any, and of the sweeps over a
// triangle table, written once for every kernel that sweeps triangles: the
// bounce kernel (bounce.cu, K2) and the sweep kernels (intersect.cu, K3-K5).  The arithmetic follows the JAX form term by term,
// including the one-hot permute/shear matrix, so that a build without FMA
// contraction (--fmad=false) gives the plain PyTorch version's bits
// (ops/watertight.py).
#pragma once

namespace rs {

// gamma(n) = n*eps / (1 - n*eps), eps = 2^-24, each rounded to f32
constexpr float kGamma2 = 0x1.000002p-23f;
constexpr float kGamma3 = 0x1.800004p-23f;
constexpr float kGamma5 = 0x1.400006p-22f;

struct RayConst {
  float sx0, sx1, sx2;  // S_x row: onehot(kx) + sx * onehot(kz)
  float sy0, sy1, sy2;  // S_y row: onehot(ky) + sy * onehot(kz)
  float sz0, sz1, sz2;  // S_z row: onehot(kz)
  float cx, cy, cz;     // S applied to the ray origin
  float inv_dz;
};

// Per-ray permute and shear (triangle.rs:154-222), once per ray.
__device__ __forceinline__ RayConst ray_constants(float ox, float oy, float oz, float dx,
                                                  float dy, float dz) {
  const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
  const bool use_x = (adx >= ady) && (adx >= adz);
  const bool use_y = !use_x && (ady >= adz);
  const bool use_z = !(use_x || use_y);
  const float hz0 = use_x ? 1.0f : 0.0f, hz1 = use_y ? 1.0f : 0.0f, hz2 = use_z ? 1.0f : 0.0f;
  const float hx0 = hz2, hx1 = hz0, hx2 = hz1;
  const float hy0 = hz1, hy1 = hz2, hy2 = hz0;
  const float dzp = hz0 * dx + hz1 * dy + hz2 * dz;
  const float dxp = hx0 * dx + hx1 * dy + hx2 * dz;
  const float dyp = hy0 * dx + hy1 * dy + hy2 * dz;
  RayConst r;
  r.inv_dz = 1.0f / dzp;
  const float sx = -dxp * r.inv_dz;
  const float sy = -dyp * r.inv_dz;
  r.sx0 = hx0 + sx * hz0;
  r.sx1 = hx1 + sx * hz1;
  r.sx2 = hx2 + sx * hz2;
  r.sy0 = hy0 + sy * hz0;
  r.sy1 = hy1 + sy * hz1;
  r.sy2 = hy2 + sy * hz2;
  r.sz0 = hz0;
  r.sz1 = hz1;
  r.sz2 = hz2;
  r.cx = r.sx0 * ox + r.sx1 * oy + r.sx2 * oz;
  r.cy = r.sy0 * ox + r.sy1 * oy + r.sy2 * oz;
  r.cz = r.sz0 * ox + r.sz1 * oy + r.sz2 * oz;
  return r;
}

// The shared part of both tests: the edge functions, det, the scaled t and
// its range test, and the error bound on t scaled by |det| (c_eps).
struct EdgeTest {
  float e0, e1, e2, det, t_scaled, c_eps;
  bool reject;  // mixed edge signs, det == 0, or t out of (0, t_lim)
};

__device__ __forceinline__ EdgeTest edge_test(const RayConst& rc, const float* p,
                                              float t_lim) {
  const float x0 = rc.sx0 * p[0] + rc.sx1 * p[1] + rc.sx2 * p[2] - rc.cx;
  const float y0 = rc.sy0 * p[0] + rc.sy1 * p[1] + rc.sy2 * p[2] - rc.cy;
  const float z0 = rc.sz0 * p[0] + rc.sz1 * p[1] + rc.sz2 * p[2] - rc.cz;
  const float x1 = rc.sx0 * p[3] + rc.sx1 * p[4] + rc.sx2 * p[5] - rc.cx;
  const float y1 = rc.sy0 * p[3] + rc.sy1 * p[4] + rc.sy2 * p[5] - rc.cy;
  const float z1 = rc.sz0 * p[3] + rc.sz1 * p[4] + rc.sz2 * p[5] - rc.cz;
  const float x2 = rc.sx0 * p[6] + rc.sx1 * p[7] + rc.sx2 * p[8] - rc.cx;
  const float y2 = rc.sy0 * p[6] + rc.sy1 * p[7] + rc.sy2 * p[8] - rc.cy;
  const float z2 = rc.sz0 * p[6] + rc.sz1 * p[7] + rc.sz2 * p[8] - rc.cz;
  EdgeTest r;
  r.e0 = x1 * y2 - y1 * x2;
  r.e1 = x2 * y0 - y2 * x0;
  r.e2 = x0 * y1 - y0 * x1;
  const bool neg = (r.e0 < 0.0f) || (r.e1 < 0.0f) || (r.e2 < 0.0f);
  const bool pos = (r.e0 > 0.0f) || (r.e1 > 0.0f) || (r.e2 > 0.0f);
  r.det = r.e0 + r.e1 + r.e2;
  const float z0s = rc.inv_dz * z0;
  const float z1s = rc.inv_dz * z1;
  const float z2s = rc.inv_dz * z2;
  r.t_scaled = r.e0 * z0s + r.e1 * z1s + r.e2 * z2s;
  const bool neg_det = r.det < 0.0f;
  const bool miss_range =
      (neg_det && ((r.t_scaled >= 0.0f) || (r.t_scaled < t_lim * r.det))) ||
      (!neg_det && ((r.t_scaled <= 0.0f) || (r.t_scaled > t_lim * r.det)));
  const float max_zt = fmaxf(fmaxf(fabsf(z0s), fabsf(z1s)), fabsf(z2s));
  const float delta_z = kGamma3 * max_zt;
  const float max_xt = fmaxf(fmaxf(fabsf(x0), fabsf(x1)), fabsf(x2));
  const float max_yt = fmaxf(fmaxf(fabsf(y0), fabsf(y1)), fabsf(y2));
  const float delta_x = kGamma5 * (max_xt + max_zt);
  const float delta_y = kGamma5 * (max_yt + max_zt);
  const float delta_e =
      2.0f * (kGamma2 * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt);
  const float max_e = fmaxf(fmaxf(fabsf(r.e0), fabsf(r.e1)), fabsf(r.e2));
  r.c_eps = 3.0f * (kGamma3 * max_e * max_zt + delta_e * max_zt + delta_z * max_e);
  r.reject = (neg && pos) || (r.det == 0.0f) || miss_range;
  return r;
}

// Closest-hit test: true on a hit in (0, t_lim), with t and barycentrics.
// p: the triangle's 9 vertex coordinates (p0, p1, p2).
__device__ __forceinline__ bool watertight_tri(const RayConst& rc, const float* p, float t_lim,
                                               float& t, float& b0, float& b1) {
  const EdgeTest e = edge_test(rc, p, t_lim);
  const float inv_det = 1.0f / (e.det == 0.0f ? 1.0f : e.det);
  b0 = e.e0 * inv_det;
  b1 = e.e1 * inv_det;
  t = e.t_scaled * inv_det;
  const float delta_t = e.c_eps * fabsf(inv_det);
  return !(e.reject || (t <= delta_t));
}

// Occlusion-only test: division free; the t <= delta_t bound is rescaled
// by |det| (t_scaled * sign(det) <= c_eps).
__device__ __forceinline__ bool watertight_tri_any(const RayConst& rc, const float* p,
                                                   float t_lim) {
  const EdgeTest e = edge_test(rc, p, t_lim);
  const float t_signed = e.det < 0.0f ? -e.t_scaled : e.t_scaled;
  return !(e.reject || (t_signed <= e.c_eps));
}

constexpr float kNoHit = 3e38f;  // "no hit yet" distance (ops/watertight.BIG)

// Closest hit over rows 0..n_tri-1 of a table of `cols` floats a row whose
// first 9 are the vertex coordinates: the row index, or -1 with bt =
// kNoHit.  Every thread of a warp reads the same row at the same step, so
// the reads through the read-only cache are broadcasts.
__device__ __forceinline__ int closest_hit(const RayConst& rc, const float* tris, int n_tri,
                                           int cols, float t_lim, float& bt, float& b0,
                                           float& b1) {
  bt = kNoHit;
  b0 = 0.0f;
  b1 = 0.0f;
  int bi = -1;
  for (int t = 0; t < n_tri; ++t) {
    const float* tp = tris + static_cast<size_t>(t) * cols;
    float p[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) p[k] = __ldg(tp + k);
    float tt, tb0, tb1;
    if (watertight_tri(rc, p, t_lim, tt, tb0, tb1) && tt < bt) {
      bt = tt;
      bi = t;
      b0 = tb0;
      b1 = tb1;
    }
  }
  return bi;
}

// Any hit in (0, t_lim) over the same rows, stopping at the first.
__device__ __forceinline__ bool any_hit(const RayConst& rc, const float* tris, int n_tri,
                                        int cols, float t_lim) {
  bool occluded = false;
  for (int t = 0; t < n_tri && !occluded; ++t) {
    const float* tp = tris + static_cast<size_t>(t) * cols;
    float p[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) p[k] = __ldg(tp + k);
    occluded = watertight_tri_any(rc, p, t_lim);
  }
  return occluded;
}

}  // namespace rs
