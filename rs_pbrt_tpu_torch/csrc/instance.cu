// I1, I2: the two-level instance walk (closest hit, any hit).
//
// Replace the XLA loops of rs_pbrt_tpu/ops/instancing.py:256
// instance_intersect (_collect_candidates :131, _inner_traverse :183),
// which the JAX package runs on every lane for a scene with instances
// (scene_intersect.py:453, and its .valid for shadow rays, :768-770):
// - I1 instance_kernel<false>: the closest hit, (t, tri, inst, b0, b1); a
//   miss gives tri -1, inst 0 and t = t_max.
// - I2 instance_kernel<true>: the occlusion byte, any hit in (0, t_max)
//   among the same candidates; a ray stops after the node of its first hit.
// Rays are o, d (N, 3) and t_max (N,) f32; a ray with t_max < 0 or NaN (a
// dead path) hits nothing and returns its miss at once.  The trees are
// ops/instancing.py's: a node's 12 floats (its children's boxes, bmin_l
// bmax_l bmin_r bmax_r) and 2 ints (its children: >= 0 a node, a leaf ~k).
//
// One thread walks one ray, the plain version's loop step for step
// (ops/instancing.py instance_intersect_plain):
// - Phase 1 walks the top tree over the instances' boxes with a 64-entry
//   stack, left child pushed before right, and keeps the 4 nearest boxes
//   by entry distance max(t_near, 0): a box entered replaces the farthest
//   kept one (the first of equal) only when strictly nearer.  The 4 are
//   sorted by distance, stable.
// - Phase 2 carries the ray into each candidate's object space by its
//   world-to-object matrix (the direction unnormalized: object t is world
//   t) and walks its prototype's tree from the prototype's root: both child
//   boxes against the best t so far, a leaf child's triangle tested (left,
//   then right) with watertight.cuh's watertight_tri_soa and kept only
//   strictly nearer, the hit internal children pushed far first.
// The order of candidates decides which of two hits at equal t wins, and
// among boxes entered at equal distance (a shadow ray starting inside
// overlapping boxes enters each at 0) the top tree's order decides which 4
// are kept; both follow the JAX loop.
//
// What bounds it on the card: per ray, 56 bytes a node visited (top and
// inner), 48 of world-to-object a candidate and 36 a triangle tested,
// against ~13 f32 operations a box and ~65 a triangle; chip_smoke.py counts
// both from the plain version's walk on the same rays.  The nodes near the
// roots are shared by every ray and stay in L1/L2; a walk is a chain of
// dependent node fetches, and neighbouring rays walk unequal paths.  This
// first form does nothing about that: one thread a ray, its stack in local
// memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "walk.cuh"
#include "watertight.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kK = 4;  // K_CANDIDATES

struct Args {
  const float* o;
  const float* d;
  const float* tmax;
  int n;
  const float* top_box;
  const int* top_child;
  const int* top_prim;
  const float* in_box;
  const int* in_child;
  const float* w2o;  // (I, 16) row-major
  const int* root;
  const float* tris;  // (PT, 9)
  float* t_out;
  int* tri_out;
  int* inst_out;
  float* b0_out;
  float* b1_out;
  uint8_t* occ_out;
};

__device__ __forceinline__ void push(int* stack, int& sp, int node) {
  stack[sp < rs::kWalkStack - 1 ? sp : rs::kWalkStack - 1] = node;
  sp = sp + 1 < rs::kWalkStack ? sp + 1 : rs::kWalkStack;
}

template <bool kAny>
__global__ void __launch_bounds__(kThreads) instance_kernel(const Args a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const float tm = a.tmax[i];
  float best_t = tm, best_b0 = 0.0f, best_b1 = 0.0f;
  int best_tri = -1, best_inst = -1;
  if (tm >= 0.0f) {
    const float o[3] = {a.o[3 * i], a.o[3 * i + 1], a.o[3 * i + 2]};
    const float d[3] = {a.d[3 * i], a.d[3 * i + 1], a.d[3 * i + 2]};
    const float inv_d[3] = {rs::inv_dir(d[0]), rs::inv_dir(d[1]), rs::inv_dir(d[2])};
    int stack[rs::kWalkStack];

    // phase 1: the 4 nearest instance boxes
    const float inf = __int_as_float(0x7f800000);
    int cand[kK] = {-1, -1, -1, -1};
    float cand_t[kK] = {inf, inf, inf, inf};
    int sp = 1;
    stack[0] = 0;
    while (sp > 0) {
      const int node = stack[--sp];
      const float* box = a.top_box + 12 * static_cast<size_t>(node);
      const int ch[2] = {a.top_child[2 * node], a.top_child[2 * node + 1]};
      float tn[2];
      const bool hit[2] = {rs::slab(o, inv_d, tm, box, tn[0]),
                           rs::slab(o, inv_d, tm, box + 6, tn[1])};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (!(hit[s] && ch[s] < 0)) continue;
        int worst = 0;
#pragma unroll
        for (int k = 1; k < kK; ++k)
          if (cand_t[k] > cand_t[worst]) worst = k;
        const float tn0 = rs::jmax(tn[s], 0.0f);
        if (tn0 < cand_t[worst]) {
          cand[worst] = a.top_prim[~ch[s]];
          cand_t[worst] = tn0;
        }
      }
#pragma unroll
      for (int s = 0; s < 2; ++s)
        if (hit[s] && ch[s] >= 0) push(stack, sp, ch[s]);
    }
    // sorted by distance, equal distances in slot order
#pragma unroll
    for (int k = 1; k < kK; ++k) {
      const float key = cand_t[k];
      const int c = cand[k];
      int j = k - 1;
      while (j >= 0 && cand_t[j] > key) {
        cand_t[j + 1] = cand_t[j];
        cand[j + 1] = cand[j];
        --j;
      }
      cand_t[j + 1] = key;
      cand[j + 1] = c;
    }

    // phase 2: each candidate's prototype tree in its object space
    for (int k = 0; k < kK; ++k) {
      const int inst = cand[k];
      if (inst < 0) continue;
      if (kAny && best_tri >= 0) break;
      const float* m = a.w2o + 16 * static_cast<size_t>(inst);
      float oo[3], od[3];
      rs::xform_point(m, o, oo);
      rs::xform_vector(m, d, od);
      const float inv_od[3] = {rs::inv_dir(od[0]), rs::inv_dir(od[1]), rs::inv_dir(od[2])};
      const rs::ShearRay sr = rs::shear_ray(oo, od);
      float lt = best_t, lb0 = 0.0f, lb1 = 0.0f;
      int ltri = -1;
      sp = 1;
      stack[0] = a.root[inst];
      while (sp > 0) {
        const int node = stack[--sp];
        const float* box = a.in_box + 12 * static_cast<size_t>(node);
        const int ch[2] = {a.in_child[2 * node], a.in_child[2 * node + 1]};
        float tn[2];
        const bool hit[2] = {rs::slab(oo, inv_od, lt, box, tn[0]),
                             rs::slab(oo, inv_od, lt, box + 6, tn[1])};
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if (!(hit[s] && ch[s] < 0)) continue;
          const int prim = ~ch[s];
          const float* tp = a.tris + 9 * static_cast<size_t>(prim);
          float p[9];
#pragma unroll
          for (int c = 0; c < 9; ++c) p[c] = tp[c];
          float t, b0, b1;
          if (rs::watertight_tri_soa(sr, lt, p, t, b0, b1) && t < lt) {
            lt = t;
            ltri = prim;
            lb0 = b0;
            lb1 = b1;
          }
        }
        const bool near_l = tn[0] <= tn[1];
        const int first = near_l ? ch[0] : ch[1], second = near_l ? ch[1] : ch[0];
        if ((near_l ? hit[1] : hit[0]) && second >= 0) push(stack, sp, second);
        if ((near_l ? hit[0] : hit[1]) && first >= 0) push(stack, sp, first);
        if (kAny && ltri >= 0) break;
      }
      if (ltri >= 0 && lt < best_t) {
        best_t = lt;
        best_tri = ltri;
        best_inst = inst;
        best_b0 = lb0;
        best_b1 = lb1;
      }
    }
  }
  if (kAny) {
    a.occ_out[i] = best_tri >= 0 ? 1 : 0;
  } else {
    a.t_out[i] = best_t;
    a.tri_out[i] = best_tri;
    a.inst_out[i] = best_inst < 0 ? 0 : best_inst;
    a.b0_out[i] = best_b0;
    a.b1_out[i] = best_b1;
  }
}

template <bool kAny>
int launch(const Args& a, void* stream) {
  if (a.n == 0) return 0;
  const int grid = (a.n + kThreads - 1) / kThreads;
  instance_kernel<kAny><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* o, const void* d, const void* tmax, int n, const void* top_box,
               const void* top_child, const void* top_prim, const void* in_box,
               const void* in_child, const void* w2o, const void* root, const void* tris) {
  Args a{};
  a.o = static_cast<const float*>(o);
  a.d = static_cast<const float*>(d);
  a.tmax = static_cast<const float*>(tmax);
  a.n = n;
  a.top_box = static_cast<const float*>(top_box);
  a.top_child = static_cast<const int*>(top_child);
  a.top_prim = static_cast<const int*>(top_prim);
  a.in_box = static_cast<const float*>(in_box);
  a.in_child = static_cast<const int*>(in_child);
  a.w2o = static_cast<const float*>(w2o);
  a.root = static_cast<const int*>(root);
  a.tris = static_cast<const float*>(tris);
  return a;
}

}  // namespace

extern "C" int rs_instance_closest(const void* o, const void* d, const void* tmax, int n,
                                   const void* top_box, const void* top_child,
                                   const void* top_prim, const void* in_box, const void* in_child,
                                   const void* w2o, const void* root, const void* tris,
                                   void* t_out, void* tri_out, void* inst_out, void* b0_out,
                                   void* b1_out, void* stream) {
  Args a = make_args(o, d, tmax, n, top_box, top_child, top_prim, in_box, in_child, w2o, root,
                     tris);
  a.t_out = static_cast<float*>(t_out);
  a.tri_out = static_cast<int*>(tri_out);
  a.inst_out = static_cast<int*>(inst_out);
  a.b0_out = static_cast<float*>(b0_out);
  a.b1_out = static_cast<float*>(b1_out);
  return launch<false>(a, stream);
}

extern "C" int rs_instance_any(const void* o, const void* d, const void* tmax, int n,
                               const void* top_box, const void* top_child, const void* top_prim,
                               const void* in_box, const void* in_child, const void* w2o,
                               const void* root, const void* tris, void* occ_out, void* stream) {
  Args a = make_args(o, d, tmax, n, top_box, top_child, top_prim, in_box, in_child, w2o, root,
                     tris);
  a.occ_out = static_cast<uint8_t*>(occ_out);
  return launch<true>(a, stream);
}
