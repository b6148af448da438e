// B1, B2: ordered traversal of the 12-wide BVH, one thread per ray.
//
// Replace the XLA traversal rs_pbrt_tpu/ops/bvh.py:bvh12_intersect_tris
// (-> _bvhw_intersect_tris, with the leaf test _tri_test_soa), which the
// JAX package runs on the TPU for every scene above BRUTE_FORCE_MAX_TRIS
// triangles:
// - B1 closest_kernel: the closest watertight hit, (t, tri, b0, b1); a miss
//   gives tri -1 and t = t_max.
// - B2 any_kernel: the occlusion bit, any hit in (0, t_max); each ray stops
//   at its first hit.
// Rays are o, d (N, 3) and t_max (N,) f32; the tree is csrc/lbvh.cpp's
// 12-wide rows, (M, 128) f32, flag in col 127.  A ray with t_max < 0 (a
// dead path) can hit nothing and returns a miss at once.
//
// The walk is the JAX loop's, step by step (ops/bvh.py tells it in full,
// and bvh12_intersect_plain is its plain version): one row per step, the
// lowest pending bit of the current (base, mask) group first, a pop when
// the group is empty, 12 slab tests masked to the row's child count,
// nearest child first (lowest slot on ties), pushes resume then defer,
// and a leaf update only where the row's nearest hit is strictly nearer.
// The stack is a ring of K = max(2 depth + 4, 8) (base, mask) pairs in
// local memory; a push onto a full ring overwrites its bottom entry, as
// the JAX roll stack drops it, and adds one to a device counter, which the
// caller reads to show that no entry was lost.
//
// What bounds them on the card: per visited row, 512 bytes (12 boxes or 12
// triangles) against 12 slab tests (~13 f32 operations each) or 12
// triangle tests (~65 each); chip_smoke.py counts both from the rows each
// ray visits.  Rows are read as float4 through the read-only cache; the
// upper levels of the tree are shared by every ray and stay in L2/L1.
// What the design does about it, for now a simple kernel that is right:
// each thread walks its own path, so warps diverge (a later PR's work:
// ray sorting or a persistent wavefront).
//
// The leaf test is watertight.cuh's watertight_tri_soa, the expression
// order of JAX's _tri_test_soa (not the sweeps' one-hot shear form),
// built with --fmad=false and IEEE division, so the kernels give the plain
// version's bits.  jnp.minimum/maximum propagate NaN where fminf/fmaxf do
// not: a slab or triangle whose values hold a NaN is never a hit in the
// JAX code, and is excluded here explicitly; the leaf's nearest-hit
// selection follows jnp.min/argmin (a NaN t wins and blocks the update).
#include <cuda_runtime.h>

#include <cstdint>

#include "watertight.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kW = 12;
constexpr int kCols = 128;
constexpr int kBase = 72, kCount = 73, kPrim = 108, kFlag = 127;
constexpr int kMaxStack = 64;  // ops/bvh.py MAX_STACK
constexpr float kSlabEps = 0x1.000006p0f;  // 1 + 2 gamma(3), rounded to f32

struct Ray {
  rs::ShearRay s;  // the leaf test's set-up
  float inv_d[3];  // the slab test's
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* d, int i) {
  const size_t k = 3 * static_cast<size_t>(i);
  Ray r;
  r.s = rs::shear_ray(o + k, d + k);
#pragma unroll
  for (int c = 0; c < 3; ++c) r.inv_d[c] = 1.0f / (d[k + c] == 0.0f ? 1e-20f : d[k + c]);
  return r;
}

template <bool kAny>
__device__ __forceinline__ void traverse(const Ray& r, float t_max, const float* __restrict__ rows,
                                         int K, float& best_t, int& best_tri, float& best_b0,
                                         float& best_b1, int* overflow) {
  best_t = t_max;
  best_tri = -1;
  best_b0 = 0.0f;
  best_b1 = 0.0f;
  if (!(t_max >= 0.0f)) return;  // a dead path: nothing lies in (0, t_max)
  int2 stk[kMaxStack];
  int top = 0, cnt = 0;
  int cur_b = 0, cur_m = 1;  // base 0, mask {bit 0}: the root row
  auto push = [&](int b, int m) {
    top = top + 1 == K ? 0 : top + 1;
    stk[top] = make_int2(b, m);
    if (cnt == K) {
      atomicAdd(overflow, 1);  // the bottom entry was overwritten
    } else {
      ++cnt;
    }
  };
  while (true) {
    if (kAny && best_tri >= 0) break;
    if (cur_m == 0) {
      if (cnt == 0) break;
      const int2 e = stk[top];
      cur_b = e.x;
      cur_m = e.y;
      top = top == 0 ? K - 1 : top - 1;
      --cnt;
    }
    const int low = cur_m & -cur_m;
    const int row_id = cur_b + (__ffs(low) - 1);
    cur_m ^= low;
    const float* row = rows + static_cast<size_t>(row_id) * kCols;
    const float4* row4 = reinterpret_cast<const float4*>(row);
    if (__ldg(row + kFlag) > 0.5f) {
      // leaf: 12 triangle tests, 4 at a time from 9 float4 component reads
      float t_new = __int_as_float(0x7f800000);  // +inf
      int bi = 0;
      bool seen_nan = false, any = false;
      float nb0 = 0.0f, nb1 = 0.0f;
#pragma unroll 1
      for (int g = 0; g < kW / 4; ++g) {
        float4 c[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) c[k] = __ldg(row4 + k * (kW / 4) + g);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p[9];
#pragma unroll
          for (int k = 0; k < 9; ++k) {  // blocks p0x p0y p0z p1x .. p2z
            p[k] = j == 0 ? c[k].x : (j == 1 ? c[k].y : (j == 2 ? c[k].z : c[k].w));
          }
          float tt, tb0, tb1;
          const bool th = rs::watertight_tri_soa(r.s, best_t, p, tt, tb0, tb1);
          any |= th;
          const float v = th ? tt : __int_as_float(0x7f800000);
          // jnp.min propagates NaN and jnp.argmin returns the first NaN
          if (!seen_nan) {
            if (isnan(v)) {
              seen_nan = true;
              t_new = v;
              bi = 4 * g + j;
              nb0 = tb0;
              nb1 = tb1;
            } else if (v < t_new) {
              t_new = v;
              bi = 4 * g + j;
              nb0 = tb0;
              nb1 = tb1;
            }
          }
        }
      }
      if (any && t_new < best_t) {
        best_t = t_new;
        best_tri = __float2int_rn(__ldg(row + kPrim + bi));
        best_b0 = nb0;
        best_b1 = nb1;
      }
    } else {
      // internal: 12 slab tests, 4 at a time from 6 float4 bound reads
      const int count = __float2int_rn(__ldg(row + kCount));
      const int child_base = __float2int_rn(__ldg(row + kBase));
      int hit_bits = 0, near = 0;
      float near_tn = __int_as_float(0x7f800000);
#pragma unroll 1
      for (int g = 0; g < kW / 4; ++g) {
        float4 b[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) b[k] = __ldg(row4 + k * (kW / 4) + g);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = 4 * g + j;
          float tn = 0.0f, tf = 0.0f;
          bool nan = false;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float4 lo = b[a], hi = b[3 + a];
            const float bl = j == 0 ? lo.x : (j == 1 ? lo.y : (j == 2 ? lo.z : lo.w));
            const float bh = j == 0 ? hi.x : (j == 1 ? hi.y : (j == 2 ? hi.z : hi.w));
            const float t1 = (bl - r.s.o[a]) * r.inv_d[a];
            const float t2 = (bh - r.s.o[a]) * r.inv_d[a];
            nan |= isnan(t1) || isnan(t2);
            const float tna = fminf(t1, t2), tfa = fmaxf(t1, t2);
            tn = a == 0 ? tna : fmaxf(tn, tna);
            tf = a == 0 ? tfa : fminf(tf, tfa);
          }
          tf = tf * kSlabEps;
          const bool hit = !nan && (tn <= tf) && (tf > 0.0f) && (tn < best_t) && (s < count);
          if (hit) {
            hit_bits |= 1 << s;
            if (tn < near_tn) {  // jnp.argmin: the first of equal minima
              near_tn = tn;
              near = s;
            }
          }
        }
      }
      if (hit_bits != 0) {
        const int near_bit = 1 << near;
        const int rest = hit_bits & ((1 << kW) - 1) & ~near_bit;
        if (cur_m != 0) push(cur_b, cur_m);  // resume
        if (rest != 0) push(child_base, rest);  // defer
        cur_b = child_base;
        cur_m = near_bit;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    closest_kernel(const float* o, const float* d, const float* tmax, int n,
                   const float* __restrict__ rows, int K, float* t_out, int* tri_out,
                   float* b0_out, float* b1_out, int* overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, i);
  float bt, b0, b1;
  int bi;
  traverse<false>(r, tmax[i], rows, K, bt, bi, b0, b1, overflow);
  t_out[i] = bt;
  tri_out[i] = bi;
  b0_out[i] = b0;
  b1_out[i] = b1;
}

__global__ void __launch_bounds__(kThreads)
    any_kernel(const float* o, const float* d, const float* tmax, int n,
               const float* __restrict__ rows, int K, uint8_t* occ_out, int* overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, i);
  float bt, b0, b1;
  int bi;
  traverse<true>(r, tmax[i], rows, K, bt, bi, b0, b1, overflow);
  occ_out[i] = bi >= 0 ? 1 : 0;
}

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int rs_bvh12_closest(const void* o, const void* d, const void* tmax, int n,
                                const void* rows, int n_rows, int K, void* t_out,
                                void* tri_out, void* b0_out, void* b1_out, void* overflow,
                                void* stream) {
  if (K < 1 || K > kMaxStack || n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  closest_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tmax), n, static_cast<const float*>(rows), K,
      static_cast<float*>(t_out), static_cast<int*>(tri_out), static_cast<float*>(b0_out),
      static_cast<float*>(b1_out), static_cast<int*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rs_bvh12_any(const void* o, const void* d, const void* tmax, int n,
                            const void* rows, int n_rows, int K, void* occ_out, void* overflow,
                            void* stream) {
  if (K < 1 || K > kMaxStack || n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  any_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tmax), n, static_cast<const float*>(rows), K,
      static_cast<uint8_t*>(occ_out), static_cast<int*>(overflow));
  return static_cast<int>(cudaGetLastError());
}
