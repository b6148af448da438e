// C1-C4: ray-curve intersection, through the curves' binary tree or by a
// dense sweep over every segment.
//
// Replace the JAX package's XLA curve intersection (rs_pbrt_tpu/ops/
// curves.py), which it runs on the TPU for every scene with curves:
// - C1 walk_kernel<false>: bvh_intersect_curves (curves.py:409), the
//   closest hit through the binary SAH tree over the segments' boxes, used
//   above BRUTE_FORCE_MAX_CURVES = 1024 segments: (t, seg, w, u, v); a miss
//   gives seg -1 (the wrapper reports 0), t = t_max and w = u = v = 0.
// - C2 walk_kernel<true>: the same with any_hit=True, the occlusion bit.
// - C3 sweep_kernel<false>: intersect_curves_brute (curves.py:387), the
//   least t over every segment, the lowest segment among equal t (argmin);
//   a miss gives t = t_max, seg -1 (the wrapper reports 0) and w, u, v of
//   segment 0's test.
// - C4 sweep_kernel<true>: the sweep's any hit (scene_intersect.py:767).
// Rays are o, d (N, 3) and t_max (N,) f32.  Segments are rows of 26 f32
// (curve.cuh).  The tree is child (S-1, 2) int32 (>= 0 a node, else the
// leaf ~position), box (S-1, 12) f32 (the left child's bmin, bmax, then
// the right's) and prim (S,) int32, the segment row of each leaf position
// (ops/bvh_native.build_binary_native).
//
// The walk is the JAX loop's, ray by ray (ops/curves.py:
// bvh_intersect_curves_plain is its plain version): pop a node, slab-test
// both children against the best t so far (widened by 1 + 2 gamma(3)),
// test a hit leaf child's segment (the left first, the right against the
// left's result), a segment winning only at a strictly smaller t, and push
// the hit internal children, the farther first (the left is the nearer
// where tn_l <= tn_r).  Ties at equal t go to the segment met first, so the
// order is followed exactly.  The stack holds 64 entries, as the JAX walk's
// does: a push onto a full stack overwrites its top entry (the JAX clamp)
// and adds one to a device counter, which the caller reads to show that
// no node was lost.  Rays with t_max < 0 or NaN (dead paths, which can hit
// nothing) return a miss at once.  C2 stops a ray once a segment hits.
//
// What bounds them on the card: C1/C2 per node visited 56 bytes (two
// child refs and two boxes) against two slab tests, and per segment tested
// 104 bytes against ~272 f32 operations (curve.cuh); C3/C4 the table once
// and ~272 operations per (ray, segment) pair, so the sweeps are bound by
// the f32 issue rate.  chip_smoke.py counts both from the plain versions'
// work on the same inputs.
//
// What the design does about it: this is the first, simple form.  One
// thread walks or sweeps one ray; the walk's stack is the thread's own (in
// local memory, 256 bytes).  The sweeps stage the table through shared
// memory in tiles of 256 rows, every thread of a block reading the same
// row at each step (a broadcast); C4's block stops once all its rays are
// occluded.  No fast math, --fmad=false: the results are the plain
// versions' bits.
#include <cuda_runtime.h>

#include <cstdint>

#include "curve.cuh"

namespace {

using curve::Ray;
using curve::SegHit;
using curve::V3;

constexpr int kStack = 64;  // the JAX walk's STACK_DEPTH
constexpr int kThreads = 128;
constexpr int kTile = 256;  // segment rows a sweep stages at once
constexpr int kSweepThreads = 256;
constexpr float kSlabEps = 0x1.000006p0f;  // 1 + 2 gamma(3), rounded to f32

__device__ __forceinline__ V3 load3(const float* p, int i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

// the JAX bvh._slab: (hit, t_near) of the box lo, hi
__device__ __forceinline__ bool slab(V3 o, V3 inv_d, float t_max, const float* lo,
                                     const float* hi, float& t_near) {
  const float ox[3] = {o.x, o.y, o.z}, id[3] = {inv_d.x, inv_d.y, inv_d.z};
  float tn = 0.0f, tf = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t1 = (lo[a] - ox[a]) * id[a];
    const float t2 = (hi[a] - ox[a]) * id[a];
    const float tna = curve::tmin(t1, t2), tfa = curve::tmax(t1, t2);
    tn = a == 0 ? tna : curve::tmax(tn, tna);
    tf = a == 0 ? tfa : curve::tmin(tf, tfa);
  }
  tf = tf * kSlabEps;
  t_near = tn;
  return (tn <= tf) && (tf > 0.0f) && (tn < t_max);
}

template <bool kAny>
__global__ void __launch_bounds__(kThreads)
    walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmax, int n, const int2* __restrict__ child,
                const float* __restrict__ box, const int* __restrict__ prim,
                const float* __restrict__ rows, float* t_out, int* seg_out, float* w_out,
                float* u_out, float* v_out, uint8_t* occ_out, int* clamped) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float tm = tmax[i];
  float bt = tm, bw = 0.0f, bu = 0.0f, bv = 0.0f;
  int bs = -1;
  if (tm >= 0.0f) {
    const Ray r = curve::make_ray(load3(o, i), load3(d, i));
    const V3 inv_d = {1.0f / (r.d.x == 0.0f ? 1e-20f : r.d.x),
                      1.0f / (r.d.y == 0.0f ? 1e-20f : r.d.y),
                      1.0f / (r.d.z == 0.0f ? 1e-20f : r.d.z)};
    int stack[kStack];
    stack[0] = 0;
    int sp = 1;
    while (sp > 0 && !(kAny && bs >= 0)) {
      --sp;
      const int node = stack[sp];
      const int2 c = child[node];
      const float* b = box + 12 * node;
      float tn_l, tn_r;
      const bool hit_l = slab(r.o, inv_d, bt, b, b + 3, tn_l);
      const bool hit_r = slab(r.o, inv_d, bt, b + 6, b + 9, tn_r);
      if (hit_l && c.x < 0) {
        const int s = prim[~c.x];
        const SegHit h = curve::seg_test(r, bt, rows + curve::kRowCols * s);
        if (h.hit && h.t < bt) bt = h.t, bs = s, bw = h.w, bu = h.u, bv = h.v;
      }
      if (hit_r && c.y < 0) {
        const int s = prim[~c.y];
        const SegHit h = curve::seg_test(r, bt, rows + curve::kRowCols * s);
        if (h.hit && h.t < bt) bt = h.t, bs = s, bw = h.w, bu = h.u, bv = h.v;
      }
      const bool push_l = hit_l && c.x >= 0, push_r = hit_r && c.y >= 0;
      const bool near_is_l = tn_l <= tn_r;
      const int first = near_is_l ? c.x : c.y, second = near_is_l ? c.y : c.x;
      const bool push_first = near_is_l ? push_l : push_r;
      const bool push_second = near_is_l ? push_r : push_l;
      if (push_second) {
        if (sp == kStack) atomicAdd(clamped, 1);
        stack[min(sp, kStack - 1)] = second;
        sp = min(sp + 1, kStack);
      }
      if (push_first) {
        if (sp == kStack) atomicAdd(clamped, 1);
        stack[min(sp, kStack - 1)] = first;
        sp = min(sp + 1, kStack);
      }
    }
  }
  if (kAny) {
    occ_out[i] = bs >= 0 ? 1 : 0;
  } else {
    t_out[i] = bt;
    seg_out[i] = bs;
    w_out[i] = bw;
    u_out[i] = bu;
    v_out[i] = bv;
  }
}

template <bool kAny>
__global__ void __launch_bounds__(kSweepThreads)
    sweep_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tmax, int n, const float* __restrict__ rows, int n_segs,
                 float* t_out, int* seg_out, float* w_out, float* u_out, float* v_out,
                 uint8_t* occ_out) {
  __shared__ float tile[kTile * curve::kRowCols];
  const int i = blockIdx.x * kSweepThreads + threadIdx.x;
  const bool in = i < n;
  float tm = 0.0f;
  Ray r;
  if (in) {
    tm = tmax[i];
    r = curve::make_ray(load3(o, i), load3(d, i));
  }
  const float inf = __int_as_float(0x7f800000);
  float bt = inf, bw = 0.0f, bu = 0.0f, bv = 0.0f;
  int bs = 0;
  bool found = false;
  for (int base = 0; base < n_segs; base += kTile) {
    // a barrier before the tile is overwritten; C4 ends the block here once
    // every one of its rays is occluded
    if (kAny) {
      if (!__syncthreads_or(in && !found)) break;
    } else {
      __syncthreads();
    }
    const int rows_here = min(kTile, n_segs - base);
    for (int k = threadIdx.x; k < rows_here * curve::kRowCols; k += kSweepThreads)
      tile[k] = rows[static_cast<size_t>(base) * curve::kRowCols + k];
    __syncthreads();
    if (!in || found) continue;
    for (int j = 0; j < rows_here; ++j) {
      const SegHit h = curve::seg_test(r, tm, tile + curve::kRowCols * j);
      if (kAny) {
        if (h.hit) {
          found = true;
          break;
        }
      } else {
        if (base + j == 0) bw = h.w, bu = h.u, bv = h.v;  // segment 0: argmin's pick on a miss
        if (h.t < bt) bt = h.t, bs = base + j, bw = h.w, bu = h.u, bv = h.v;
      }
    }
  }
  if (!in) return;
  if (kAny) {
    occ_out[i] = found ? 1 : 0;
  } else {
    const bool valid = bt < inf;
    t_out[i] = valid ? bt : tm;
    seg_out[i] = valid ? bs : -1;  // the wrapper reports seg 0 and valid false
    w_out[i] = bw;
    u_out[i] = bu;
    v_out[i] = bv;
  }
}

}  // namespace

extern "C" int rs_curve_walk(const void* o, const void* d, const void* tmax, int n,
                             const void* child, const void* box, const void* prim,
                             const void* rows, int any_hit, void* t_out, void* seg_out,
                             void* w_out, void* u_out, void* v_out, void* occ_out, void* clamped,
                             void* stream) {
  if (n == 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  auto launch = any_hit ? walk_kernel<true> : walk_kernel<false>;
  launch<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d), static_cast<const float*>(tmax),
      n, static_cast<const int2*>(child), static_cast<const float*>(box),
      static_cast<const int*>(prim), static_cast<const float*>(rows), static_cast<float*>(t_out),
      static_cast<int*>(seg_out), static_cast<float*>(w_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<uint8_t*>(occ_out), static_cast<int*>(clamped));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rs_curve_sweep(const void* o, const void* d, const void* tmax, int n,
                              const void* rows, int n_segs, int any_hit, void* t_out,
                              void* seg_out, void* w_out, void* u_out, void* v_out,
                              void* occ_out, void* stream) {
  if (n == 0) return 0;
  if (n_segs < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n + kSweepThreads - 1) / kSweepThreads;
  auto launch = any_hit ? sweep_kernel<true> : sweep_kernel<false>;
  launch<<<grid, kSweepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d), static_cast<const float*>(tmax),
      n, static_cast<const float*>(rows), n_segs, static_cast<float*>(t_out),
      static_cast<int*>(seg_out), static_cast<float*>(w_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<uint8_t*>(occ_out));
  return static_cast<int>(cudaGetLastError());
}
