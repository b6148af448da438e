// B1, B2: ordered traversal of the 12-wide BVH.
//
// Replace the XLA traversal rs_pbrt_tpu/ops/bvh.py:bvh12_intersect_tris
// (-> _bvhw_intersect_tris, with the leaf test _tri_test_soa), which the
// JAX package runs on the TPU for every scene above BRUTE_FORCE_MAX_TRIS
// triangles:
// - B1 closest_kernel: the closest watertight hit, (t, tri, b0, b1); a miss
//   gives tri -1 and t = t_max.  A group of 16 lanes walks one ray.
// - B2 any_kernel: the occlusion bit, any hit in (0, t_max); each ray stops
//   at its first hit.  One thread walks one ray.
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
// The stack is a ring of K = max(2 depth + 4, 8) (base, mask) pairs; a
// push onto a full ring overwrites its bottom entry, as the JAX roll stack
// drops it, and adds one to a device counter, which the caller reads to
// show that no entry was lost.
//
// What bounds them on the card: per visited row, 512 bytes (12 boxes or 12
// triangles) against 12 slab tests (~13 f32 operations each) or 12
// triangle tests (~65 each); chip_smoke.py counts both from the rows each
// ray visits.  The upper levels of the tree are shared by every ray and stay
// in L2/L1.  What limits a walk is the latency of each step's row, which
// the next step's address depends on, and rays of unequal length.
//
// What B1's design does about it (group_walk):
// - One ray per group of 16 lanes.  Lane s < 12 owns child slot s: it reads
//   its slot's 6 bounds or its triangle's 9 coordinates from the row's SoA
//   blocks (cols 12k + s), and every lane reads the flag, the child base and
//   the count, all in one round trip: a group reads its row coalesced, and
//   the 12 slab or triangle tests run at once.  Lanes 12-15 repeat slot 11
//   and take no part in the result.
// - The walk's choices are the JAX loop's: the hit mask is a ballot; the
//   nearest child is the least (tn, slot) and the leaf's nearest hit the
//   least (t, slot), both by a redux min over an order-preserving integer
//   key and a ballot of the lanes that hold it; a NaN t among a leaf's hits
//   blocks its update, as jnp.min's NaN does.
// - Every lane of the group holds the same walk state (current base and
//   mask, stack top and count), computed from the same ballots, so nothing
//   is broadcast but the results of the reductions.  The stack of K entries
//   per ray sits in shared memory (lane 0 writes it); nothing goes to local
//   memory.
// - Persistent groups: as many blocks as fill the SMs at the kernel's
//   occupancy; a group takes its next 16 rays from a global counter when
//   its rays end, so no group waits for a slower neighbour.  The caller
//   gives each launch its own zeroed counter.  Each lane reads
//   one of the 16 t_max and writes a dead ray's miss, and the group walks
//   the live ones, so a dead ray costs its t_max read and its outputs.
// B2 keeps the one-thread-per-ray walk (traverse<true>, a 64-entry stack in
// local memory); group_walk takes kAny for a later port of B2.
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
constexpr int kMaxStack = 64;  // ops/bvh.py MAX_STACK (B2's local stack)
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

constexpr int kGroup = 16;  // B1: lanes that walk one ray
constexpr int kGroupThreads = 128;  // B1: 8 groups a block
constexpr int kRaysPerFetch = kGroup;  // B1: rays a group takes at once, one t_max a lane

// The slot of the least key over the group's 16 lanes, by float < and the
// lowest slot among equal keys (jnp.argmin's first of equal minima), and
// that key; every lane ends with both.  No key may be NaN.  The keys are
// mapped to unsigned ints in the same order (-0 made +0 first, as float <
// does not tell them apart), so one redux instruction finds the least.
__device__ __forceinline__ int group_argmin(unsigned gmask, int shift, float& key) {
  const unsigned b = __float_as_uint(key + 0.0f);  // -0 + 0 = +0
  const unsigned ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  const unsigned least = __reduce_min_sync(gmask, ord);
  const unsigned at = (__ballot_sync(gmask, ord == least) >> shift) & 0xFFFFu;
  const int slot = __ffs(at) - 1;
  key = __shfl_sync(gmask, key, slot, kGroup);
  return slot;
}

// One ray's walk by the group (s: this lane's slot, stk: the group's K
// shared-memory stack entries).  Every lane returns the same result.
template <bool kAny>
__device__ __forceinline__ void group_walk(const Ray& r, float t_max,
                                           const float* __restrict__ rows, int K, int2* stk,
                                           unsigned gmask, int s, float& best_t, int& best_tri,
                                           float& best_b0, float& best_b1, int* overflow) {
  best_t = t_max;
  best_tri = -1;
  best_b0 = 0.0f;
  best_b1 = 0.0f;
  if (!(t_max >= 0.0f)) return;  // a dead path: nothing lies in (0, t_max)
  const float inf = __int_as_float(0x7f800000);
  const int sl = s < kW ? s : kW - 1;
  const int shift = threadIdx.x & 16;  // the group's first lane in its warp
  int top = 0, cnt = 0;
  int cur_b = 0, cur_m = 1;  // base 0, mask {bit 0}: the root row
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
    const float* row = rows + static_cast<size_t>(cur_b + (__ffs(low) - 1)) * kCols;
    cur_m ^= low;
    // one round trip: this slot's 9 column blocks, the flag, base and count
    float v[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = __ldg(row + kW * k + sl);
    const float flag = __ldg(row + kFlag);
    const float base_f = __ldg(row + kBase), count_f = __ldg(row + kCount);
    if (flag > 0.5f) {
      // leaf: slot s's triangle test (blocks p0x p0y p0z p1x .. p2z)
      const float prim_f = __ldg(row + kPrim + sl);
      float tt, tb0, tb1;
      const bool th = rs::watertight_tri_soa(r.s, best_t, v, tt, tb0, tb1) && s < kW;
      const unsigned hits = __ballot_sync(gmask, th);
      const unsigned nans = __ballot_sync(gmask, th && isnan(tt));
      if (hits != 0 && nans == 0) {
        float t_new = th ? tt : inf;
        const int bi = group_argmin(gmask, shift, t_new);
        if (t_new < best_t) {
          best_t = t_new;
          best_tri = __float2int_rn(__shfl_sync(gmask, prim_f, bi, kGroup));
          best_b0 = __shfl_sync(gmask, tb0, bi, kGroup);
          best_b1 = __shfl_sync(gmask, tb1, bi, kGroup);
        }
      }
    } else {
      // internal: slot s's slab test (blocks bmin x y z, bmax x y z)
      float tn = 0.0f, tf = 0.0f;
      bool nan = false;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float t1 = (v[a] - r.s.o[a]) * r.inv_d[a];
        const float t2 = (v[3 + a] - r.s.o[a]) * r.inv_d[a];
        nan |= isnan(t1) || isnan(t2);
        const float tna = fminf(t1, t2), tfa = fmaxf(t1, t2);
        tn = a == 0 ? tna : fmaxf(tn, tna);
        tf = a == 0 ? tfa : fminf(tf, tfa);
      }
      tf = tf * kSlabEps;
      const bool hit = !nan && (tn <= tf) && (tf > 0.0f) && (tn < best_t) &&
                       (s < __float2int_rn(count_f)) && s < kW;
      const int hit_bits = static_cast<int>((__ballot_sync(gmask, hit) >> shift) & 0xFFFFu);
      if (hit_bits != 0) {
        float near_tn = hit ? tn : inf;
        const int near = group_argmin(gmask, shift, near_tn);
        const int child_base = __float2int_rn(base_f);
        const int near_bit = 1 << near;
        const int rest = hit_bits & ~near_bit;
        auto push = [&](int b, int m) {
          top = top + 1 == K ? 0 : top + 1;
          if (s == 0) stk[top] = make_int2(b, m);
          if (cnt == K) {
            if (s == 0) atomicAdd(overflow, 1);  // the bottom entry was overwritten
          } else {
            ++cnt;
          }
        };
        if (cur_m != 0) push(cur_b, cur_m);  // resume
        if (rest != 0) push(child_base, rest);  // defer
        __syncwarp(gmask);  // the group's later pops see lane 0's entries
        cur_b = child_base;
        cur_m = near_bit;
      }
    }
  }
}

__global__ void __launch_bounds__(kGroupThreads)
    closest_kernel(const float* o, const float* d, const float* tmax, int n,
                   const float* __restrict__ rows, int K, float* t_out, int* tri_out,
                   float* b0_out, float* b1_out, int* overflow, int* next_ray) {
  extern __shared__ int2 stacks[];  // K entries a group
  const int s = threadIdx.x & (kGroup - 1);
  const int shift = threadIdx.x & 16;  // the group's first lane in its warp
  const unsigned gmask = 0xFFFFu << shift;
  int2* stk = stacks + (threadIdx.x / kGroup) * K;
  while (true) {
    int first = 0;
    if (s == 0) first = atomicAdd(next_ray, kRaysPerFetch);
    first = __shfl_sync(gmask, first, 0, kGroup);
    if (first >= n) break;
    // each lane reads one ray's t_max and writes the miss of a dead one
    const int mine = first + s;
    const bool in = mine < n;
    const float tm_mine = in ? tmax[mine] : -1.0f;
    const bool live = in && tm_mine >= 0.0f;
    if (in && !live) {  // t_max < 0 or NaN: nothing lies in (0, t_max)
      t_out[mine] = tm_mine;
      tri_out[mine] = -1;
      b0_out[mine] = 0.0f;
      b1_out[mine] = 0.0f;
    }
    unsigned todo = (__ballot_sync(gmask, live) >> shift) & 0xFFFFu;
    while (todo != 0) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int i = first + j;
      const float tm = __shfl_sync(gmask, tm_mine, j, kGroup);
      float bt, b0, b1;
      int bi;
      group_walk<false>(load_ray(o, d, i), tm, rows, K, stk, gmask, s, bt, bi, b0, b1,
                        overflow);
      if (s == 0) t_out[i] = bt;
      if (s == 1) tri_out[i] = bi;
      if (s == 2) b0_out[i] = b0;
      if (s == 3) b1_out[i] = b1;
    }
  }
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
                                void* next_ray, void* stream) {
  if (K < 1 || K > kMaxStack || n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(kGroupThreads / kGroup) * K * sizeof(int2);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, closest_kernel, kGroupThreads,
                                                        smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = kGroupThreads / kGroup;
  const int needed = static_cast<int>(
      (static_cast<long long>(n) + groups * kRaysPerFetch - 1) / (groups * kRaysPerFetch));
  const int grid = max(1, min(sms * max(per_sm, 1), needed));
  closest_kernel<<<grid, kGroupThreads, smem, st>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tmax), n, static_cast<const float*>(rows), K,
      static_cast<float*>(t_out), static_cast<int*>(tri_out), static_cast<float*>(b0_out),
      static_cast<float*>(b1_out), static_cast<int*>(overflow), static_cast<int*>(next_ray));
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
