// The hit record of a triangle row (scene_intersect._tri_interaction,
// reference triangle.rs:300-420), written once for every kernel that
// builds one: the bounce kernel (bounce.cu, K2) and the fused closest-hit
// kernel (intersect.cu, K5).  The plain PyTorch version is
// ops/record.tri_record; both compute the same expressions in the same
// order, so a build with --fmad=false gives its bits.
#pragma once

namespace rs {

// tri_attr columns (scene/arrays.py TA_*)
constexpr int kTriCols = 32;
constexpr int kTaUv0 = 18, kTaHasN = 24, kTaMat = 25, kTaLight = 26, kTaReverse = 27;
// gamma(7) = 7 eps / (1 - 7 eps), eps = 2^-24, rounded to f32
constexpr float kGamma7 = 0x1.c0000cp-22f;

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 normalize(V3 a, float eps) {
  return scale(a, 1.0f / sqrtf(fmaxf(dot(a, a), eps)));
}
__device__ __forceinline__ V3 load3(const float* p) { return {__ldg(p), __ldg(p + 1), __ldg(p + 2)}; }

// first axis of vecmath.coordinate_system (geometry.rs branch on |x| > |y|)
__device__ __forceinline__ V3 coordinate_system(V3 v) {
  const bool use_a = fabsf(v.x) > fabsf(v.y);
  const float inv_a = 1.0f / sqrtf(fmaxf(v.x * v.x + v.z * v.z, 1e-20f));
  const float inv_b = 1.0f / sqrtf(fmaxf(v.y * v.y + v.z * v.z, 1e-20f));
  return use_a ? V3{-v.z * inv_a, 0.0f, v.x * inv_a} : V3{0.0f, v.z * inv_b, -v.y * inv_b};
}

struct TriRecord {
  V3 p, p_err, ng, ns, dpdu;
  float u, v;
  int mat, light;
};

// The record of the hit at barycentrics (b0, b1) of the triangle `row`
// (N_TRI_ATTR floats).  with_uv: also interpolate uv (K5 writes it, K2
// does not read it).
template <bool with_uv>
__device__ __forceinline__ TriRecord tri_record(const float* row, float b0, float b1) {
  const V3 p0 = load3(row + 0), p1 = load3(row + 3), p2 = load3(row + 6);
  const V3 n0 = load3(row + 9), n1 = load3(row + 12), n2 = load3(row + 15);
  const float uv0x = __ldg(row + kTaUv0), uv0y = __ldg(row + kTaUv0 + 1);
  const float uv1x = __ldg(row + kTaUv0 + 2), uv1y = __ldg(row + kTaUv0 + 3);
  const float uv2x = __ldg(row + kTaUv0 + 4), uv2y = __ldg(row + kTaUv0 + 5);
  const float has_n_f = __ldg(row + kTaHasN), mat_f = __ldg(row + kTaMat);
  const float light_f = __ldg(row + kTaLight), rev_f = __ldg(row + kTaReverse);
  TriRecord r;
  const float b2 = 1.0f - b0 - b1;
  r.p = {b0 * p0.x + b1 * p1.x + b2 * p2.x, b0 * p0.y + b1 * p1.y + b2 * p2.y,
         b0 * p0.z + b1 * p1.z + b2 * p2.z};
  r.p_err = {kGamma7 * (fabsf(b0 * p0.x) + fabsf(b1 * p1.x) + fabsf(b2 * p2.x)),
             kGamma7 * (fabsf(b0 * p0.y) + fabsf(b1 * p1.y) + fabsf(b2 * p2.y)),
             kGamma7 * (fabsf(b0 * p0.z) + fabsf(b1 * p1.z) + fabsf(b2 * p2.z))};
  const V3 e02 = sub(p0, p2), e12 = sub(p1, p2);
  r.ng = normalize(cross(e02, e12), 1e-30f);
  V3 ns = {b0 * n0.x + b1 * n1.x + b2 * n2.x, b0 * n0.y + b1 * n1.y + b2 * n2.y,
           b0 * n0.z + b1 * n1.z + b2 * n2.z};
  const float ns_len = sqrtf(dot(ns, ns));
  const bool has_n = (has_n_f > 0.5f) && (ns_len > 1e-8f);
  const float inv_nsl = 1.0f / fmaxf(ns_len, 1e-8f);
  ns = has_n ? scale(ns, inv_nsl) : r.ng;
  const bool rev = rev_f > 0.5f;
  if (rev) ns = scale(ns, -1.0f);
  if ((has_n && dot(r.ng, ns) < 0.0f) || (!has_n && rev)) r.ng = scale(r.ng, -1.0f);
  r.ns = ns;
  if (with_uv) {
    r.u = b0 * uv0x + b1 * uv1x + b2 * uv2x;
    r.v = b0 * uv0y + b1 * uv1y + b2 * uv2y;
  } else {
    r.u = r.v = 0.0f;
  }
  const float duv02x = uv0x - uv2x, duv02y = uv0y - uv2y;
  const float duv12x = uv1x - uv2x, duv12y = uv1y - uv2y;
  const float det_uv = duv02x * duv12y - duv02y * duv12x;
  const float inv_det_uv =
      fabsf(det_uv) < 1e-12f ? 0.0f : 1.0f / (det_uv == 0.0f ? 1.0f : det_uv);
  r.dpdu = {(duv12y * e02.x - duv02y * e12.x) * inv_det_uv,
            (duv12y * e02.y - duv02y * e12.y) * inv_det_uv,
            (duv12y * e02.z - duv02y * e12.z) * inv_det_uv};
  if (dot(r.dpdu, r.dpdu) < 1e-16f) r.dpdu = coordinate_system(r.ng);
  r.mat = static_cast<int>(mat_f + 0.5f);
  r.light = static_cast<int>(light_f + (light_f < 0.0f ? -0.5f : 0.5f));
  return r;
}

}  // namespace rs
