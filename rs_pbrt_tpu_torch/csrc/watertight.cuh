// Watertight ray-triangle tests as device functions (reference
// triangle.rs:134-449, with conservative error bounds).
//
// The port of rs_pbrt_tpu/ops/pallas_intersect.py:_ray_constants,
// _watertight_tri and _watertight_tri_any, written once for every kernel
// that sweeps triangles: the bounce kernel (bounce.cu, K2) and the sweep
// kernels (intersect.cu, K3-K5).  The arithmetic follows the JAX form term
// by term, including the one-hot permute/shear matrix, so that a build
// without FMA contraction (--fmad=false) gives the plain PyTorch version's
// bits (ops/watertight.py); the sweeps over a shared-memory table also have
// the index-picked form of the same test (SweepRay), for rows whose
// vertices are finite.  Below them, the same test in the expression order
// of the BVH leaf test, rs_pbrt_tpu/ops/bvh.py:_tri_test_soa, for the
// traversal kernels (bvh12.cu, B1 and B2; its plain version is ops/bvh.py).
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

// The sweeps over a table staged in shared memory (K2, K3, K4): 12
// floats a triangle, the 9 vertex coordinates (p0, p1, p2) then 3 more
// (zeros, or K3/K4's finite flag), so a triangle is 3 float4.
constexpr int kVertStride = 12;

// Their triangle tests, in two forms that give the same values for finite
// vertices.  kIdx = false: the one-hot form above, as the plain version
// computes it.  kIdx = true: the permuted and sheared components picked by
// index, x = (p[kx] + sx p[kz]) - cx, y = (p[ky] + sy p[kz]) - cy,
// z = p[kz] - cz: the one-hot sums' other terms are products with a 0
// entry, so the two differ at most in the sign of a zero, which every
// comparison and output treats alike.  It saves 33 of the 54 operations of
// the shear.  With an infinite or NaN vertex, 0 * inf is NaN in the one-hot
// form, so such a row keeps that form.
struct SweepRay {
  RayConst rc;
  int kx, ky, kz;
  float sx, sy;
};

__device__ __forceinline__ SweepRay sweep_ray(float ox, float oy, float oz, float dx, float dy,
                                              float dz) {
  SweepRay r;
  r.rc = ray_constants(ox, oy, oz, dx, dy, dz);
  r.kz = r.rc.sz0 != 0.0f ? 0 : (r.rc.sz1 != 0.0f ? 1 : 2);
  r.kx = r.kz == 2 ? 0 : r.kz + 1;
  r.ky = r.kx == 2 ? 0 : r.kx + 1;
  // the S_x and S_y entries in the kz column: 0 + sx * 1
  r.sx = r.kz == 0 ? r.rc.sx0 : (r.kz == 1 ? r.rc.sx1 : r.rc.sx2);
  r.sy = r.kz == 0 ? r.rc.sy0 : (r.kz == 1 ? r.rc.sy1 : r.rc.sy2);
  return r;
}

// edge_test in two parts, the same expressions in the same order: the
// transformed vertices, edge functions, det, scaled t and the reject test,
// which every triangle needs; then the error bound on t, only for a
// triangle that passes (most do not, often for a whole warp).
struct Edges {
  float x[3], y[3], zs[3];  // zs: z scaled by 1/dz
  float e0, e1, e2, det, t_scaled;
};

template <bool kIdx>
__device__ __forceinline__ bool edges_reject(const SweepRay& r, const float* tri, float t_lim,
                                             Edges& g) {
  float z[3];
  if (kIdx) {
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const float pz = tri[3 * v + r.kz];
      g.x[v] = (tri[3 * v + r.kx] + r.sx * pz) - r.rc.cx;
      g.y[v] = (tri[3 * v + r.ky] + r.sy * pz) - r.rc.cy;
      z[v] = pz - r.rc.cz;
    }
  } else {
    const RayConst& rc = r.rc;
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const float* p = tri + 3 * v;
      g.x[v] = rc.sx0 * p[0] + rc.sx1 * p[1] + rc.sx2 * p[2] - rc.cx;
      g.y[v] = rc.sy0 * p[0] + rc.sy1 * p[1] + rc.sy2 * p[2] - rc.cy;
      z[v] = rc.sz0 * p[0] + rc.sz1 * p[1] + rc.sz2 * p[2] - rc.cz;
    }
  }
  g.e0 = g.x[1] * g.y[2] - g.y[1] * g.x[2];
  g.e1 = g.x[2] * g.y[0] - g.y[2] * g.x[0];
  g.e2 = g.x[0] * g.y[1] - g.y[0] * g.x[1];
  const bool neg = (g.e0 < 0.0f) || (g.e1 < 0.0f) || (g.e2 < 0.0f);
  const bool pos = (g.e0 > 0.0f) || (g.e1 > 0.0f) || (g.e2 > 0.0f);
  g.det = g.e0 + g.e1 + g.e2;
#pragma unroll
  for (int v = 0; v < 3; ++v) g.zs[v] = r.rc.inv_dz * z[v];
  g.t_scaled = g.e0 * g.zs[0] + g.e1 * g.zs[1] + g.e2 * g.zs[2];
  const bool neg_det = g.det < 0.0f;
  const bool miss_range =
      (neg_det && ((g.t_scaled >= 0.0f) || (g.t_scaled < t_lim * g.det))) ||
      (!neg_det && ((g.t_scaled <= 0.0f) || (g.t_scaled > t_lim * g.det)));
  return (neg && pos) || (g.det == 0.0f) || miss_range;
}

// The error bound on t scaled by |det| (EdgeTest::c_eps).  fmaxf drops a
// NaN that jnp.maximum keeps, but a NaN among x, y, zs or e makes t NaN as
// well, and then no test reads the bound: t <= bound is false either way.
__device__ __forceinline__ float edges_c_eps(const Edges& g) {
  const float max_zt = fmaxf(fmaxf(fabsf(g.zs[0]), fabsf(g.zs[1])), fabsf(g.zs[2]));
  const float delta_z = kGamma3 * max_zt;
  const float max_xt = fmaxf(fmaxf(fabsf(g.x[0]), fabsf(g.x[1])), fabsf(g.x[2]));
  const float max_yt = fmaxf(fmaxf(fabsf(g.y[0]), fabsf(g.y[1])), fabsf(g.y[2]));
  const float delta_x = kGamma5 * (max_xt + max_zt);
  const float delta_y = kGamma5 * (max_yt + max_zt);
  const float delta_e =
      2.0f * (kGamma2 * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt);
  const float max_e = fmaxf(fmaxf(fabsf(g.e0), fabsf(g.e1)), fabsf(g.e2));
  return 3.0f * (kGamma3 * max_e * max_zt + delta_e * max_zt + delta_z * max_e);
}

// The BVH leaf test's form (_tri_test_soa): the vertex components are
// picked by index (kx, ky, kz) where the sweeps multiply by the one-hot
// matrix, so its expressions differ and it has its own set-up.
struct ShearRay {
  float o[3];
  int kx, ky, kz;
  float sx, sy, sz;
};

__device__ __forceinline__ float comp(const float* v, int k) {
  return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ float max3(float a, float b, float c) { return fmaxf(fmaxf(a, b), c); }

// o, d: the ray's 3 components each
__device__ __forceinline__ ShearRay shear_ray(const float* o, const float* d) {
  ShearRay r;
  float dv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.o[c] = o[c];
    dv[c] = d[c];
  }
  // kz = argmax |d|, the first on ties (jnp.argmax)
  int kz = 0;
  if (fabsf(dv[1]) > fabsf(dv[kz])) kz = 1;
  if (fabsf(dv[2]) > fabsf(dv[kz])) kz = 2;
  r.kz = kz;
  r.kx = kz + 1 == 3 ? 0 : kz + 1;
  r.ky = r.kx + 1 == 3 ? 0 : r.kx + 1;
  const float inv_dz = 1.0f / comp(dv, kz);
  r.sx = -comp(dv, r.kx) * inv_dz;
  r.sy = -comp(dv, r.ky) * inv_dz;
  r.sz = inv_dz;
  return r;
}

// _tri_test_soa for one triangle, p its 9 vertex coordinates (p0, p1, p2):
// true on a hit in (0, t_max), with t and barycentrics.  jnp.maximum
// propagates NaN where fmaxf does not, so a NaN in the bound's maxima is
// handled as the JAX test handles it.
__device__ __forceinline__ bool watertight_tri_soa(const ShearRay& r, float t_max, const float* p,
                                                   float& t, float& b0, float& b1) {
  float x[3], y[3], z[3];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const float pv[3] = {p[3 * v] - r.o[0], p[3 * v + 1] - r.o[1], p[3 * v + 2] - r.o[2]};
    x[v] = comp(pv, r.kx);
    y[v] = comp(pv, r.ky);
    z[v] = comp(pv, r.kz);
  }
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    x[v] = x[v] + r.sx * z[v];
    y[v] = y[v] + r.sy * z[v];
  }
  const float e0 = x[1] * y[2] - y[1] * x[2];
  const float e1 = x[2] * y[0] - y[2] * x[0];
  const float e2 = x[0] * y[1] - y[0] * x[1];
  const bool neg = (e0 < 0.0f) || (e1 < 0.0f) || (e2 < 0.0f);
  const bool pos = (e0 > 0.0f) || (e1 > 0.0f) || (e2 > 0.0f);
  const float det = e0 + e1 + e2;
  const float z0s = r.sz * z[0];
  const float z1s = r.sz * z[1];
  const float z2s = r.sz * z[2];
  const float t_scaled = e0 * z0s + e1 * z1s + e2 * z2s;
  const bool miss_range = det < 0.0f ? ((t_scaled >= 0.0f) || (t_scaled < t_max * det))
                                     : ((t_scaled <= 0.0f) || (t_scaled > t_max * det));
  const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  b0 = e0 * inv_det;
  b1 = e1 * inv_det;
  t = t_scaled * inv_det;
  const float max_zt = max3(fabsf(z0s), fabsf(z1s), fabsf(z2s));
  const float delta_z = kGamma3 * max_zt;
  const float max_xt = max3(fabsf(x[0]), fabsf(x[1]), fabsf(x[2]));
  const float max_yt = max3(fabsf(y[0]), fabsf(y[1]), fabsf(y[2]));
  const float delta_x = kGamma5 * (max_xt + max_zt);
  const float delta_y = kGamma5 * (max_yt + max_zt);
  const float delta_e = 2.0f * (kGamma2 * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt);
  const float max_e = max3(fabsf(e0), fabsf(e1), fabsf(e2));
  const float delta_t =
      3.0f * (kGamma3 * max_e * max_zt + delta_e * max_zt + delta_z * max_e) * fabsf(inv_det);
  // a NaN in the bound's maxima makes jnp's delta_t NaN, and t <= NaN is
  // false: the JAX test passes such a triangle; fmaxf would drop the NaN
  const bool nan_bound = isnan(z0s) || isnan(z1s) || isnan(z2s) || isnan(x[0]) || isnan(x[1]) ||
                         isnan(x[2]) || isnan(y[0]) || isnan(y[1]) || isnan(y[2]) ||
                         isnan(e0) || isnan(e1) || isnan(e2);
  const bool miss_eps = !nan_bound && (t <= delta_t);
  return !((neg && pos) || (det == 0.0f) || miss_range || miss_eps);
}

}  // namespace rs
