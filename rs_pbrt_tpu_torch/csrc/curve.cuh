// The curve leaf test, shared by the four curve kernels of curves.cu.
//
// The reference's leaf test (src/shapes/curve.rs:215-343) as the JAX
// package's ops/curves.py:curve_seg_test writes it and the port's plain
// version (ops/curves.py:seg_test) computes it, term by term in the same
// order: the ray frame (the segment's chord along +x, coordinate_system's
// axis where the ray and the chord are parallel), the four control points
// in it, the slab rejects, the end tangents' edge functions, the clamped
// closest approach along the chord, the width there (a ribbon's scaled by
// its slerped normal's cosine to the ray), the de Casteljau point and its
// derivative, the width and depth tests, and v from the side of the
// tangent.  Built with --fmad=false and IEEE division and square root, so
// every operation rounds as the plain version's does.  jnp's and torch's
// minimum, maximum and clip propagate NaN where fminf and fmaxf do not:
// the helpers below do so too.
//
// A segment row is 26 f32 (scene/arrays.py CV_*): control points 0-11,
// widths 12-13, u0 u1 14-15, ribbon normals 16-21, the normals' angle 22
// and its 1/sin 23, the type 24 (0 flat, 1 cylinder, 2 ribbon), the
// material 25.
//
// Operations (add, sub, mul, div, sqrt and sin one each; compares,
// min/max, abs, negation and selects none), for the kernels' bounds in
// chip_smoke.py (CURVE_FLOP): make_ray 15 a ray; seg_test 272 a test: the
// frame 44 (the chord's cross product 12, its length 5, ex 18, ey 9), the
// points in it 72, z_max and the half width 2, the rejects 6, the edges 10,
// the chord 5, w 4, u 4, lw 3, the width 4, the ribbon's scale 23, de
// Casteljau 72, the derivative and its length 11, the width test 5, v 6,
// t 1.  The degenerate frame's fallback is not charged.
#pragma once

#include <cuda_runtime.h>

namespace curve {

constexpr int kRowCols = 26;
constexpr int kRibbon = 2;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

// torch.minimum / torch.maximum: NaN when either is NaN
__device__ __forceinline__ float tmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? nan_f() : fminf(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? nan_f() : fmaxf(a, b);
}
// torch.clamp(x, min=c) with a constant c: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float c) { return isnan(x) ? x : fmaxf(x, c); }

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
// vecmath.normalize: a / max(sqrt(max(|a|^2, 1e-30)), 1e-20)
__device__ __forceinline__ V3 normalize(V3 a) {
  const float ln = clamp_min(sqrtf(clamp_min(dot(a, a), 1e-30f)), 1e-20f);
  return {a.x / ln, a.y / ln, a.z / ln};
}
__device__ __forceinline__ float lerp(float t, float a, float b) { return (1.0f - t) * a + t * b; }
__device__ __forceinline__ V3 lerp3(float t, V3 a, V3 b) {
  return {lerp(t, a.x, b.x), lerp(t, a.y, b.y), lerp(t, a.z, b.z)};
}

// per ray: the direction, its unit vector and its length
struct Ray {
  V3 o, d, ez;
  float length;
};

__device__ __forceinline__ Ray make_ray(V3 o, V3 d) {
  Ray r;
  r.o = o;
  r.d = d;
  r.ez = normalize(d);
  r.length = sqrtf(clamp_min(dot(d, d), 1e-30f));
  return r;
}

struct SegHit {
  bool hit;
  float t, u, v, w;  // t is +inf where there is no hit
};

__device__ __forceinline__ SegHit seg_test(const Ray& r, float t_max, const float* row) {
  const V3 cp[4] = {{row[0], row[1], row[2]},
                    {row[3], row[4], row[5]},
                    {row[6], row[7], row[8]},
                    {row[9], row[10], row[11]}};
  const float w0 = row[12], w1 = row[13], u0 = row[14], u1 = row[15];
  const V3 n0 = {row[16], row[17], row[18]}, n1 = {row[19], row[20], row[21]};
  const float norm_angle = row[22], inv_sin_na = row[23], ctype = row[24];

  // the ray frame (curve.rs:385-415)
  const V3 ez = r.ez;
  V3 up = cross(r.d, sub(cp[3], cp[0]));
  if (dot(up, up) < 1e-18f) {  // coordinate_system(ez)'s first axis
    const bool use_a = fabsf(ez.x) > fabsf(ez.y);
    const float inv_a = 1.0f / sqrtf(clamp_min(ez.x * ez.x + ez.z * ez.z, 1e-20f));
    const float inv_b = 1.0f / sqrtf(clamp_min(ez.y * ez.y + ez.z * ez.z, 1e-20f));
    up = use_a ? V3{-ez.z * inv_a, 0.0f, ez.x * inv_a} : V3{0.0f, ez.z * inv_b, -ez.y * inv_b};
  }
  const V3 ex = normalize(cross(up, ez));
  const V3 ey = cross(ez, ex);
  V3 q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const V3 p = sub(cp[i], r.o);
    q[i] = {dot(p, ex), dot(p, ey), dot(p, ez)};
  }
  const float z_max = r.length * t_max;
  const float half_w = 0.5f * tmax(w0, w1);
  const V3 hi = {tmax(tmax(q[0].x, q[1].x), tmax(q[2].x, q[3].x)),
                 tmax(tmax(q[0].y, q[1].y), tmax(q[2].y, q[3].y)),
                 tmax(tmax(q[0].z, q[1].z), tmax(q[2].z, q[3].z))};
  const V3 lo = {tmin(tmin(q[0].x, q[1].x), tmin(q[2].x, q[3].x)),
                 tmin(tmin(q[0].y, q[1].y), tmin(q[2].y, q[3].y)),
                 tmin(tmin(q[0].z, q[1].z), tmin(q[2].z, q[3].z))};
  // conservative slab rejects (curve.rs:425-447)
  bool ok = !((hi.y + half_w < 0.0f) || (lo.y - half_w > 0.0f) || (hi.x + half_w < 0.0f) ||
              (lo.x - half_w > 0.0f) || (hi.z + half_w < 0.0f) || (lo.z - half_w > z_max));
  // the end tangents' edge functions (curve.rs:221-230)
  const float edge0 = (q[1].y - q[0].y) * (-q[0].y) + q[0].x * (q[0].x - q[1].x);
  const float edge1 = (q[2].y - q[3].y) * (-q[3].y) + q[3].x * (q[3].x - q[2].x);
  ok = ok && (edge0 >= 0.0f) && (edge1 >= 0.0f);
  // the closest approach along the chord (curve.rs:232-253)
  const float sdx = q[3].x - q[0].x, sdy = q[3].y - q[0].y;
  const float denom = sdx * sdx + sdy * sdy;
  ok = ok && (denom > 0.0f);
  const float w = ((-q[0].x) * sdx + (-q[0].y) * sdy) / clamp_min(denom, 1e-20f);
  const float u = tmin(tmax(lerp(w, u0, u1), u0), u1);
  const float span = (u1 == u0) ? 1.0f : u1 - u0;
  const float lw = (u - u0) / span;
  float hit_width = lerp(lw, w0, w1);
  // a ribbon's width scaled by its normal's cosine to the ray (curve.rs:256-264)
  const bool straight = norm_angle < 1e-6f;
  const float s0 = straight ? 1.0f - lw : sinf((1.0f - lw) * norm_angle) * inv_sin_na;
  const float s1 = straight ? lw : sinf(lw * norm_angle) * inv_sin_na;
  const V3 n_hit = {s0 * n0.x + s1 * n1.x, s0 * n0.y + s1 * n1.y, s0 * n0.z + s1 * n1.z};
  const float ribbon_scale = fabsf(dot(n_hit, r.d)) / clamp_min(r.length, 1e-20f);
  if (ctype == static_cast<float>(kRibbon)) hit_width = hit_width * ribbon_scale;
  // the curve's point at w, the width and depth tests (curve.rs:266-277)
  const float wc = tmin(tmax(w, 0.0f), 1.0f);
  const V3 a0 = lerp3(wc, q[0], q[1]), a1 = lerp3(wc, q[1], q[2]), a2 = lerp3(wc, q[2], q[3]);
  const V3 b0 = lerp3(wc, a0, a1), b1 = lerp3(wc, a1, a2);
  const V3 pc = lerp3(wc, b0, b1);
  V3 dp = {3.0f * (b1.x - b0.x), 3.0f * (b1.y - b0.y), 3.0f * (b1.z - b0.z)};
  if (dot(dp, dp) < 1e-14f) dp = sub(q[3], q[0]);
  const float dist2 = pc.x * pc.x + pc.y * pc.y;
  ok = ok && (dist2 <= hit_width * hit_width * 0.25f);
  ok = ok && (pc.z >= 0.0f) && (pc.z <= z_max);
  // v from the side of the tangent (curve.rs:279-286)
  const float dist = sqrtf(clamp_min(dist2, 0.0f));
  const float edge_func = dp.x * (-pc.y) + pc.x * dp.y;
  const float ratio = dist / clamp_min(hit_width, 1e-20f);
  const float v = edge_func > 0.0f ? 0.5f + ratio : 0.5f - ratio;
  const float t = pc.z / clamp_min(r.length, 1e-20f);
  ok = ok && (t > 1e-7f);
  return {ok, ok ? t : __int_as_float(0x7f800000), u, v, wc};
}

}  // namespace curve
