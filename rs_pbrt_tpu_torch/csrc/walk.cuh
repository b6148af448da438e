// Device helpers of the one-thread-a-ray walks: the instance walk
// (instance.cu, I1/I2), the kd-tree walk (kdtree.cu, D1/D2) and the
// moving-mesh sweep (motion.cu, V1).
//
// Each follows the plain PyTorch version of its walk expression by
// expression, so a build without FMA contraction (--fmad=false) gives its
// bits: jnp.minimum/maximum and torch.minimum/maximum propagate NaN where
// fminf/fmaxf drop it, so the min and max here propagate it too; the 4x4
// transforms sum their terms left to right, as utils/transform.py does.
#pragma once

namespace rs {

constexpr float kSlabEpsW = 0x1.000006p0f;  // 1 + 2 gamma(3), rounded to f32
constexpr int kWalkStack = 64;  // the JAX walks' stacks (pbrt's MAX_TO_DO for the kd-tree)

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

// torch.minimum / torch.maximum: NaN if either is NaN
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? nan_f() : fminf(a, b);
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? nan_f() : fmaxf(a, b);
}

// 1/d with d == 0 taken as 1e-20 (the walks' inv_d)
__device__ __forceinline__ float inv_dir(float d) { return 1.0f / (d == 0.0f ? 1e-20f : d); }

// The JAX _slab of a ray against one box (bmin 3, bmax 3): the hit and
// t_near.  A NaN among the slab distances makes both tn and the test NaN
// and false, as in jnp.
__device__ __forceinline__ bool slab(const float* o, const float* inv_d, float t_max,
                                     const float* box, float& tn) {
  float tf = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t1 = (box[a] - o[a]) * inv_d[a];
    const float t2 = (box[3 + a] - o[a]) * inv_d[a];
    const float lo = jmin(t1, t2), hi = jmax(t1, t2);
    tn = a == 0 ? lo : jmax(tn, lo);
    tf = a == 0 ? hi : jmin(tf, hi);
  }
  tf = tf * kSlabEpsW;
  return (tn <= tf) && (tf > 0.0f) && (tn < t_max);
}

// utils/transform.xform_point of a row-major 4x4 m: the rows' sums left to
// right, the translation, then the homogeneous divide
__device__ __forceinline__ void xform_point(const float* m, const float* p, float* out) {
  const float w = (m[12] * p[0] + m[13] * p[1] + m[14] * p[2]) + m[15];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = ((m[4 * i] * p[0] + m[4 * i + 1] * p[1] + m[4 * i + 2] * p[2]) + m[4 * i + 3]) / w;
}

// utils/transform.xform_vector
__device__ __forceinline__ void xform_vector(const float* m, const float* v, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = m[4 * i] * v[0] + m[4 * i + 1] * v[1] + m[4 * i + 2] * v[2];
}

}  // namespace rs
