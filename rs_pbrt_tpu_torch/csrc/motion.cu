// V1: the moving-mesh sweep, the closest hit (or any hit) over the
// animated triangle meshes at each ray's time.
//
// Replaces the XLA function rs_pbrt_tpu/ops/scene_intersect.py:467
// _anim_hits (with utils/animated.py:55 interpolate and :157
// inverse_affine), which the JAX package runs on every lane of every cast
// in a scene with animated meshes; shadow rays take its .valid (:772).
// For each ray and each group (a mesh and its transform at the shutter's
// two ends, anim_xf's 32 floats), the group's matrix is interpolated at
// the ray's time clipped to [0, 1] (the translation and scale lerped, the
// rotation slerped on the shorter arc, nlerp where cos > 0.9995), inverted
// by cofactors, and the ray carried into the group's object space (its
// direction unnormalized, so object t is world t); then every triangle of
// the group is tested, watertight.cuh's watertight_tri_soa, all against
// the ray's own t_max, and the nearest hit kept, the first triangle among
// equal t (the JAX argmin).  A hit whose t is NaN is not kept.  A ray with
// t_max < 0 or NaN (a dead path) hits nothing.
// - motion_kernel<false> (closest): valid, t (t_max where none), the
//   triangle and group (0 where none), b0, b1.
// - motion_kernel<true> (any): one byte, a hit nearer than t_max; a ray
//   stops testing at its first.
// The interpolation, inverse and transforms are utils/animated.py's and
// utils/transform.py's expressions term by term (sums left to right), and
// the build keeps a*b + c as two roundings (--fmad=false), so the kernel
// gives ops/motion_kernel.anim_hits_plain's bits.
//
// What bounds it on the card: the f32 operations, ~65 a triangle test for
// every ray and every triangle (the transcendental interpolation, ~300
// operations a ray and group, is small beside 1,280 triangles).  The
// triangles are read once a block: a tile of kTile triangles is staged in
// shared memory and every thread of the block tests it, so the sweep reads
// its table from device memory once per block of kThreads rays.
#include <cuda_runtime.h>

#include <cstdint>

#include "walk.cuh"
#include "watertight.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;  // triangles a shared-memory tile

struct Args {
  const float* o;
  const float* d;
  const float* tmax;
  const float* time;  // null: every ray at time 0
  int n;
  const float* xf;  // (G, 32)
  const int* range;  // (G, 2) each group's rows [start, end)
  int groups;
  const float* tris;  // rows of `cols` floats, the vertices in the first 9
  int cols;
  uint8_t* valid_out;  // the closest hit's, or the any hit's occlusion
  float* t_out;
  int* tri_out;
  int* grp_out;
  float* b0_out;
  float* b1_out;
};

__device__ __forceinline__ float dot4(const float* a, const float* b) {
  return ((a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]) + a[3] * b[3];
}

// utils/animated.interpolate at time t of one group's packed ends (T0 3,
// q0 4, S0 9, T1 3, q1 4, S1 9): m (4x4 row-major)
__device__ void interpolate(const float* xf, float t, float* m) {
  t = fminf(fmaxf(t, 0.0f), 1.0f);  // torch.clamp (t is never NaN here)
  const float omt = 1.0f - t;
  const float* q0 = xf + 3;
  float q1[4] = {xf[19], xf[20], xf[21], xf[22]};
  float cos_t = dot4(q0, q1);
  if (cos_t < 0.0f) {
#pragma unroll
    for (int k = 0; k < 4; ++k) q1[k] = -q1[k];
  }
  cos_t = fabsf(cos_t);
  const float theta = acosf(fminf(fmaxf(cos_t, -1.0f), 1.0f));
  const float sin_t = fmaxf(sinf(theta), 1e-6f);
  const bool near = cos_t > 0.9995f;
  const float w0 = near ? omt : sinf(omt * theta) / sin_t;
  const float w1 = near ? t : sinf(t * theta) / sin_t;
  float q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = w0 * q0[k] + w1 * q1[k];
  const float nrm = fmaxf(sqrtf(dot4(q, q)), 1e-12f);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = q[k] / nrm;
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float R[9] = {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - z * w),
                      2.0f * (x * z + y * w),        2.0f * (x * y + z * w),
                      1.0f - 2.0f * (x * x + z * z), 2.0f * (y * z - x * w),
                      2.0f * (x * z - y * w),        2.0f * (y * z + x * w),
                      1.0f - 2.0f * (x * x + y * y)};
  float S[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) S[k] = omt * xf[7 + k] + t * xf[23 + k];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      m[4 * r + c] = R[3 * r] * S[c] + R[3 * r + 1] * S[3 + c] + R[3 * r + 2] * S[6 + c];
    m[4 * r + 3] = omt * xf[r] + t * xf[16 + r];
  }
  m[12] = m[13] = m[14] = 0.0f;
  m[15] = 1.0f;
}

// utils/animated.inverse_affine of m, into mi (4x4 row-major)
__device__ void inverse_affine(const float* m, float* mi) {
  auto a = [&](int i, int j) { return m[4 * i + j]; };
  const float c00 = a(1, 1) * a(2, 2) - a(1, 2) * a(2, 1);
  const float c01 = a(1, 2) * a(2, 0) - a(1, 0) * a(2, 2);
  const float c02 = a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0);
  const float det = a(0, 0) * c00 + a(0, 1) * c01 + a(0, 2) * c02;
  const float inv_det = 1.0f / (fabsf(det) < 1e-20f ? 1.0f : det);
  const float adj[9] = {c00, a(0, 2) * a(2, 1) - a(0, 1) * a(2, 2),
                        a(0, 1) * a(1, 2) - a(0, 2) * a(1, 1),
                        c01, a(0, 0) * a(2, 2) - a(0, 2) * a(2, 0),
                        a(0, 2) * a(1, 0) - a(0, 0) * a(1, 2),
                        c02, a(0, 1) * a(2, 0) - a(0, 0) * a(2, 1),
                        a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0)};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) mi[4 * i + j] = adj[3 * i + j] * inv_det;
    mi[4 * i + 3] = -(mi[4 * i] * a(0, 3) + mi[4 * i + 1] * a(1, 3) + mi[4 * i + 2] * a(2, 3));
  }
  mi[12] = mi[13] = mi[14] = 0.0f;
  mi[15] = 1.0f;
}

template <bool kAny>
__global__ void __launch_bounds__(kThreads) motion_kernel(const Args a) {
  __shared__ float tile[kTile * 9];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < a.n;
  const float tc = in ? a.tmax[i] : -1.0f;
  const bool live = in && tc >= 0.0f;
  const float tl = (in && a.time != nullptr) ? a.time[i] : 0.0f;
  const float inf = __int_as_float(0x7f800000);
  float best_t = inf, best_b0 = 0.0f, best_b1 = 0.0f;
  int best_i = 0, best_g = 0;
  bool found = false;
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 1.0f};
  if (live) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = a.o[3 * i + c];
      d[c] = a.d[3 * i + c];
    }
  }
  for (int g = 0; g < a.groups; ++g) {
    const int start = a.range[2 * g], end = a.range[2 * g + 1];
    rs::ShearRay sr{};
    if (live) {
      float m[16], mi[16], oo[3], od[3];
      interpolate(a.xf + 32 * static_cast<size_t>(g), tl, m);
      inverse_affine(m, mi);
      rs::xform_point(mi, o, oo);
      rs::xform_vector(mi, d, od);
      sr = rs::shear_ray(oo, od);
    }
    for (int base = start; base < end; base += kTile) {
      const int cnt = min(kTile, end - base);
      __syncthreads();  // the previous tile is done with
      for (int k = threadIdx.x; k < cnt * 9; k += kThreads) {
        const int r = k / 9, c = k - 9 * r;
        tile[k] = a.tris[static_cast<size_t>(base + r) * a.cols + c];
      }
      __syncthreads();
      if (!live || (kAny && found)) continue;
      for (int k = 0; k < cnt; ++k) {
        float t, b0, b1;
        if (!rs::watertight_tri_soa(sr, tc, tile + 9 * k, t, b0, b1)) continue;
        if (kAny) {
          if (t < tc) {
            found = true;
            break;
          }
        } else if (t < best_t) {  // a NaN t is not kept
          best_t = t;
          best_i = base + k;
          best_g = g;
          best_b0 = b0;
          best_b1 = b1;
          found = true;
        }
      }
    }
  }
  if (!in) return;
  if (kAny) {
    a.valid_out[i] = found ? 1 : 0;
    return;
  }
  const bool v = found && best_t < tc;
  a.valid_out[i] = v ? 1 : 0;
  a.t_out[i] = v ? best_t : tc;
  a.tri_out[i] = v ? best_i : 0;
  a.grp_out[i] = v ? best_g : 0;
  a.b0_out[i] = v ? best_b0 : 0.0f;
  a.b1_out[i] = v ? best_b1 : 0.0f;
}

template <bool kAny>
int launch(const Args& a, void* stream) {
  if (a.n == 0) return 0;
  const int grid = (a.n + kThreads - 1) / kThreads;
  motion_kernel<kAny><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rs_motion_closest(const void* o, const void* d, const void* tmax,
                                 const void* time, int n, const void* xf, const void* range,
                                 int groups, const void* tris, int cols, void* valid_out,
                                 void* t_out, void* tri_out, void* grp_out, void* b0_out,
                                 void* b1_out, void* stream) {
  Args a{static_cast<const float*>(o), static_cast<const float*>(d),
         static_cast<const float*>(tmax), static_cast<const float*>(time), n,
         static_cast<const float*>(xf), static_cast<const int*>(range), groups,
         static_cast<const float*>(tris), cols, static_cast<uint8_t*>(valid_out),
         static_cast<float*>(t_out), static_cast<int*>(tri_out), static_cast<int*>(grp_out),
         static_cast<float*>(b0_out), static_cast<float*>(b1_out)};
  return launch<false>(a, stream);
}

extern "C" int rs_motion_any(const void* o, const void* d, const void* tmax, const void* time,
                             int n, const void* xf, const void* range, int groups,
                             const void* tris, int cols, void* occ_out, void* stream) {
  Args a{static_cast<const float*>(o), static_cast<const float*>(d),
         static_cast<const float*>(tmax), static_cast<const float*>(time), n,
         static_cast<const float*>(xf), static_cast<const int*>(range), groups,
         static_cast<const float*>(tris), cols, static_cast<uint8_t*>(occ_out),
         nullptr, nullptr, nullptr, nullptr, nullptr};
  return launch<true>(a, stream);
}
