// B1, B2: ordered traversal of the 12-wide BVH.
//
// Replace the XLA traversal rs_pbrt_tpu/ops/bvh.py:bvh12_intersect_tris
// (-> _bvhw_intersect_tris, with the leaf test _tri_test_soa), which the
// JAX package runs on the TPU for every scene above BRUTE_FORCE_MAX_TRIS
// triangles:
// - B1 walk_kernel<false>: the closest watertight hit, (t, tri, b0, b1); a
//   miss gives tri -1 and t = t_max.
// - B2 walk_kernel<true>: the occlusion bit, any hit in (0, t_max); each
//   ray stops at its first hit.
// A group of 16 lanes walks one ray in both.  Rays are o, d (N, 3) and
// t_max (N,) f32; the tree is csrc/lbvh.cpp's 12-wide rows, (M, 128) f32,
// flag in col 127.  A ray with t_max < 0 or NaN (a dead path) can hit
// nothing and returns a miss at once.
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
// What the design does about it (group_walk):
// - One ray per group of 16 lanes.  Lane s < 12 owns child slot s: it reads
//   its slot's 6 bounds or its triangle's 9 coordinates from the row's SoA
//   blocks (cols 12k + s), and every lane reads the flag, the child base and
//   the count, all in one round trip: a group reads its row coalesced, and
//   the 12 slab or triangle tests run at once.  Lanes 12-15 repeat slot 11
//   and take no part in the result.
// - The walk's choices are the JAX loop's: the hit mask is a ballot; the
//   nearest child is the least (tn, slot) and B1's leaf's nearest hit the
//   least (t, slot), both by a redux min over an order-preserving integer
//   key and a ballot of the lanes that hold it; a NaN t among a leaf's hits
//   blocks its update, as jnp.min's NaN does.  B2's leaf needs no least t:
//   with no NaN among the hits, the nearest hit is strictly nearer than
//   t_max exactly when some hit is, which one more ballot tells.
// - Every lane of the group holds the same walk state (current base and
//   mask, stack top and count), computed from the same ballots, so nothing
//   is broadcast but the results of the reductions.  The stack of K entries
//   per ray sits in shared memory (lane 0 writes it); nothing goes to local
//   memory.  K is bounded by the shared memory a block holds without
//   opting in (48 KB: kMaxStack entries a group).
// - Persistent groups: as many blocks as fill the SMs at the kernel's
//   occupancy; a group takes its next 16 rays from a global counter when
//   its rays end, so no group waits for a slower neighbour.  The caller
//   gives each launch its own zeroed counter.  Each lane reads one of the
//   16 t_max and writes a dead ray's miss, and the group walks the live
//   ones, so a dead ray costs its t_max read and its outputs.
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

constexpr int kW = 12;
constexpr int kCols = 128;
constexpr int kBase = 72, kCount = 73, kPrim = 108, kFlag = 127;
constexpr float kSlabEps = 0x1.000006p0f;  // 1 + 2 gamma(3), rounded to f32
constexpr int kGroup = 16;  // lanes that walk one ray
constexpr int kGroupThreads = 128;  // 8 groups a block
constexpr int kRaysPerFetch = kGroup;  // rays a group takes at once, one t_max a lane
// stack entries a group: a block's K-entry stacks fill at most the 48 KB
// of shared memory a kernel has without opting in (ops/bvh.py MAX_STACK)
constexpr int kMaxStack = 48 * 1024 / ((kGroupThreads / kGroup) * 8);

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
      const float prim_f = kAny ? 0.0f : __ldg(row + kPrim + sl);
      float tt, tb0, tb1;
      const bool th = rs::watertight_tri_soa(r.s, best_t, v, tt, tb0, tb1) && s < kW;
      const unsigned nans = __ballot_sync(gmask, th && isnan(tt));
      if (kAny) {
        // with no NaN among the hits, the nearest one is strictly nearer
        // than best_t exactly when some hit is; the hit's id is not needed
        if (nans == 0 && __ballot_sync(gmask, th && tt < best_t) != 0) best_tri = 0;
      } else if (__ballot_sync(gmask, th) != 0 && nans == 0) {
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

// B1 (kAny false: t, tri, b0, b1 out) and B2 (kAny true: occ out, one byte
// a ray), in persistent groups of 16 lanes.
template <bool kAny>
__global__ void __launch_bounds__(kGroupThreads)
    walk_kernel(const float* o, const float* d, const float* tmax, int n,
                const float* __restrict__ rows, int K, float* t_out, int* tri_out,
                float* b0_out, float* b1_out, uint8_t* occ_out, int* overflow, int* next_ray) {
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
      if (kAny) {
        occ_out[mine] = 0;
      } else {
        t_out[mine] = tm_mine;
        tri_out[mine] = -1;
        b0_out[mine] = 0.0f;
        b1_out[mine] = 0.0f;
      }
    }
    unsigned todo = (__ballot_sync(gmask, live) >> shift) & 0xFFFFu;
    while (todo != 0) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int i = first + j;
      const float tm = __shfl_sync(gmask, tm_mine, j, kGroup);
      float bt, b0, b1;
      int bi;
      group_walk<kAny>(load_ray(o, d, i), tm, rows, K, stk, gmask, s, bt, bi, b0, b1, overflow);
      if (kAny) {
        if (s == 0) occ_out[i] = bi >= 0 ? 1 : 0;
      } else {
        if (s == 0) t_out[i] = bt;
        if (s == 1) tri_out[i] = bi;
        if (s == 2) b0_out[i] = b0;
        if (s == 3) b1_out[i] = b1;
      }
    }
  }
}

// One launch of walk_kernel<kAny>: as many blocks as fill the SMs at its
// occupancy, or as the rays need.
template <bool kAny>
int launch(const void* o, const void* d, const void* tmax, int n, const void* rows, int n_rows,
           int K, void* t_out, void* tri_out, void* b0_out, void* b1_out, void* occ_out,
           void* overflow, void* next_ray, void* stream) {
  if (K < 1 || K > kMaxStack || n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const size_t smem = static_cast<size_t>(kGroupThreads / kGroup) * K * sizeof(int2);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walk_kernel<kAny>,
                                                        kGroupThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = kGroupThreads / kGroup;
  const int needed = static_cast<int>(
      (static_cast<long long>(n) + groups * kRaysPerFetch - 1) / (groups * kRaysPerFetch));
  const int grid = max(1, min(sms * max(per_sm, 1), needed));
  walk_kernel<kAny><<<grid, kGroupThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tmax), n, static_cast<const float*>(rows), K,
      static_cast<float*>(t_out), static_cast<int*>(tri_out), static_cast<float*>(b0_out),
      static_cast<float*>(b1_out), static_cast<uint8_t*>(occ_out), static_cast<int*>(overflow),
      static_cast<int*>(next_ray));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rs_bvh12_closest(const void* o, const void* d, const void* tmax, int n,
                                const void* rows, int n_rows, int K, void* t_out,
                                void* tri_out, void* b0_out, void* b1_out, void* overflow,
                                void* next_ray, void* stream) {
  return launch<false>(o, d, tmax, n, rows, n_rows, K, t_out, tri_out, b0_out, b1_out, nullptr,
                       overflow, next_ray, stream);
}

extern "C" int rs_bvh12_any(const void* o, const void* d, const void* tmax, int n,
                            const void* rows, int n_rows, int K, void* occ_out, void* overflow,
                            void* next_ray, void* stream) {
  return launch<true>(o, d, tmax, n, rows, n_rows, K, nullptr, nullptr, nullptr, nullptr, occ_out,
                      overflow, next_ray, stream);
}
