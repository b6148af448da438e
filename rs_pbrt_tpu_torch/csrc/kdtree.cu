// D1, D2: the kd-tree walk (closest hit, any hit).
//
// Replace the XLA loop rs_pbrt_tpu/ops/kdtree.py:174
// kdtree_intersect_tris, which the JAX package runs on every lane of every
// cast through a scene built with Accelerator "kdtree" (any_hit=True for
// shadow rays):
// - D1 kd_kernel<false>: the closest hit, (t, tri, b0, b1); a miss gives
//   tri -1 and t = t_max.
// - D2 kd_kernel<true>: the occlusion byte; a ray stops after the leaf of
//   its first hit.
// Rays are o, d (N, 3) and t_max (N,) f32; a ray with t_max < 0 or NaN (a
// dead path) hits nothing and returns at once.  The tree is ops/kdtree.py's
// build: axis (3 a leaf), split, above (the below child is the next node),
// a leaf's start and count in prim_ids, and the world box.
//
// One thread walks one ray, pbrt's (node, tmin, tmax) stack walk
// (kdtreeaccel.rs:503-730) as the JAX loop and ops/kdtree.py's plain
// version run it, step for step: the ray clipped to the world box (jnp's
// NaN-keeping min and max); a node whose tmin lies past the best hit is
// popped; a leaf's triangles tested in order with watertight.cuh's
// watertight_tri_soa, each kept only strictly nearer; at an interior node
// the near child is the below one where the origin lies below the plane,
// or on it with the direction not pointing above; only the near child is
// visited where the plane lies past tmax or at or behind the origin (this
// test first), only the far one where the plane lies before tmin, else
// both, the far child under the near one.  The stack holds 64 entries
// (pbrt's MAX_TO_DO); a push onto a full stack overwrites its top with the
// far child, as the JAX loop's clamped slot does, and adds one to a device
// counter, which the caller reads to show that no entry was lost.
//
// What bounds it on the card: per ray, 20 bytes a node visited and, a leaf
// triangle tested, 4 bytes of prim id and 36 of vertices, against ~65 f32
// operations a test; chip_smoke.py counts both from the plain walk on the
// same rays.  A walk is a chain of dependent node fetches; the upper nodes
// are shared by every ray and stay in L1/L2.  This first form does nothing
// more: one thread a ray, its stack in local memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "walk.cuh"
#include "watertight.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLeaf = 3;

struct Args {
  const float* o;
  const float* d;
  const float* tmax;
  int n;
  const int* axis;
  const float* split;
  const int* above;
  const int* start;
  const int* count;
  const int* prim_ids;
  int n_prims;
  const float* world;  // bmin 3 then bmax 3
  const float* tris;  // (T, 9)
  float* t_out;
  int* tri_out;
  float* b0_out;
  float* b1_out;
  uint8_t* occ_out;
  int* overflow;
};

template <bool kAny>
__global__ void __launch_bounds__(kThreads) kd_kernel(const Args a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const float tm = a.tmax[i];
  float best_t = tm, best_b0 = 0.0f, best_b1 = 0.0f;
  int best_tri = -1;
  if (tm >= 0.0f) {
    const float o[3] = {a.o[3 * i], a.o[3 * i + 1], a.o[3 * i + 2]};
    const float d[3] = {a.d[3 * i], a.d[3 * i + 1], a.d[3 * i + 2]};
    const float inv_d[3] = {rs::inv_dir(d[0]), rs::inv_dir(d[1]), rs::inv_dir(d[2])};
    const rs::ShearRay sr = rs::shear_ray(o, d);
    // the world-box clip (kdtreeaccel.rs:517)
    float t_near = 0.0f, t_far = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float t1 = (a.world[c] - o[c]) * inv_d[c];
      const float t2 = (a.world[3 + c] - o[c]) * inv_d[c];
      const float lo = rs::jmin(t1, t2), hi = rs::jmax(t1, t2);
      t_near = c == 0 ? lo : rs::jmax(t_near, lo);
      t_far = c == 0 ? hi : rs::jmin(t_far, hi);
    }
    t_near = rs::jmax(t_near, 0.0f);
    int s_node[rs::kWalkStack];
    float s_tmin[rs::kWalkStack], s_tmax[rs::kWalkStack];
    int sp = 0;
    if (t_near <= t_far) {
      s_node[0] = 0;
      s_tmin[0] = t_near;
      s_tmax[0] = rs::jmin(t_far, tm);
      sp = 1;
    }
    while (sp > 0) {
      if (kAny && best_tri >= 0) break;
      const int top = sp - 1;
      const int node = s_node[top];
      const float tmin = s_tmin[top], tmax = s_tmax[top];
      const int axis = a.axis[node];
      if (tmin > best_t) {  // past the nearest hit
        --sp;
        continue;
      }
      if (axis == kLeaf) {
        const int cnt = a.count[node], first = a.start[node];
        for (int k = 0; k < cnt; ++k) {
          const int idx = min(max(first + k, 0), a.n_prims - 1);
          const int prim = a.prim_ids[idx];
          const float* tp = a.tris + 9 * static_cast<size_t>(prim);
          float p[9];
#pragma unroll
          for (int c = 0; c < 9; ++c) p[c] = tp[c];
          float t, b0, b1;
          if (rs::watertight_tri_soa(sr, best_t, p, t, b0, b1) && t < best_t) {
            best_t = t;
            best_tri = prim;
            best_b0 = b0;
            best_b1 = b1;
          }
        }
        --sp;
        continue;
      }
      const float o_ax = o[axis], d_ax = d[axis], inv_ax = inv_d[axis];
      const float split = a.split[node];
      const float t_plane = (split - o_ax) * inv_ax;
      const bool below_first = (o_ax < split) || (o_ax == split && d_ax <= 0.0f);
      const int below = node + 1, above = a.above[node];
      const int first = below_first ? below : above;
      const int second = below_first ? above : below;
      const bool only_first = (t_plane > tmax) || (t_plane <= 0.0f);
      const bool only_second = (t_plane < tmin) && !only_first;
      if (only_first || only_second) {
        s_node[top] = only_second ? second : first;
        s_tmin[top] = only_second ? rs::jmax(t_plane, tmin) : tmin;
        // s_tmax[top] keeps tmax
        continue;
      }
      // both: the far child takes this slot, the near one goes above it
      s_node[top] = second;
      s_tmin[top] = rs::jmax(t_plane, tmin);
      s_tmax[top] = tmax;
      if (sp < rs::kWalkStack) {
        s_node[sp] = first;
        s_tmin[sp] = tmin;
        s_tmax[sp] = rs::jmin(t_plane, tmax);
        ++sp;
      } else {
        atomicAdd(a.overflow, 1);  // the near child is lost
      }
    }
  }
  if (kAny) {
    a.occ_out[i] = best_tri >= 0 ? 1 : 0;
  } else {
    a.t_out[i] = best_t;
    a.tri_out[i] = best_tri;
    a.b0_out[i] = best_b0;
    a.b1_out[i] = best_b1;
  }
}

template <bool kAny>
int launch(const Args& a, void* stream) {
  if (a.n == 0) return 0;
  const int grid = (a.n + kThreads - 1) / kThreads;
  kd_kernel<kAny><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* o, const void* d, const void* tmax, int n, const void* axis,
               const void* split, const void* above, const void* start, const void* count,
               const void* prim_ids, int n_prims, const void* world, const void* tris,
               void* overflow) {
  Args a{};
  a.o = static_cast<const float*>(o);
  a.d = static_cast<const float*>(d);
  a.tmax = static_cast<const float*>(tmax);
  a.n = n;
  a.axis = static_cast<const int*>(axis);
  a.split = static_cast<const float*>(split);
  a.above = static_cast<const int*>(above);
  a.start = static_cast<const int*>(start);
  a.count = static_cast<const int*>(count);
  a.prim_ids = static_cast<const int*>(prim_ids);
  a.n_prims = n_prims;
  a.world = static_cast<const float*>(world);
  a.tris = static_cast<const float*>(tris);
  a.overflow = static_cast<int*>(overflow);
  return a;
}

}  // namespace

extern "C" int rs_kd_closest(const void* o, const void* d, const void* tmax, int n,
                             const void* axis, const void* split, const void* above,
                             const void* start, const void* count, const void* prim_ids,
                             int n_prims, const void* world, const void* tris, void* t_out,
                             void* tri_out, void* b0_out, void* b1_out, void* overflow,
                             void* stream) {
  Args a = make_args(o, d, tmax, n, axis, split, above, start, count, prim_ids, n_prims, world,
                     tris, overflow);
  a.t_out = static_cast<float*>(t_out);
  a.tri_out = static_cast<int*>(tri_out);
  a.b0_out = static_cast<float*>(b0_out);
  a.b1_out = static_cast<float*>(b1_out);
  return launch<false>(a, stream);
}

extern "C" int rs_kd_any(const void* o, const void* d, const void* tmax, int n, const void* axis,
                         const void* split, const void* above, const void* start,
                         const void* count, const void* prim_ids, int n_prims, const void* world,
                         const void* tris, void* occ_out, void* overflow, void* stream) {
  Args a = make_args(o, d, tmax, n, axis, split, above, start, count, prim_ids, n_prims, world,
                     tris, overflow);
  a.occ_out = static_cast<uint8_t*>(occ_out);
  return launch<true>(a, stream);
}
