// K3, K4, K5: dense ray-triangle sweeps.
//
// Replace rs_pbrt_tpu/ops/pallas_intersect.py:
// - K3 closest_kernel: _sweep_kernel (launched by _sweep,
//   pallas_intersect_tris): the closest watertight hit, (t, tri, b0, b1);
//   a miss gives tri -1 and t = t_max.
// - K4 any_kernel: _any_kernel (_sweep_any, pallas_intersect_tris_p): the
//   occlusion bit, any hit in (0, t_max).
// - K5 full_kernel: _full_kernel (_sweep_full, pallas_intersect_tris_full):
//   the closest hit fused with its hit record, 18 f32 rows (t, p, p_err,
//   ng, ns, u, v, dpdu) and 3 int32 rows (prim, mat, light); a miss gives
//   t = t_max, prim -1, mat 0, light -1 and zeros elsewhere.
// Rays are o, d (N, 3) and t_max (N,) f32; the table is (T, cols) f32 with
// the vertex coordinates in its first 9 columns (K5: tri_attr, 32 columns).
// Outputs are rows of N, each written once, coalesced.
//
// What bounds them on the card: at the scenes of the ported paths (4
// triangles for spheres_direct, up to BRUTE_FORCE_MAX_TRIS = 4096), memory
// for small tables: 28 bytes of ray in and 16 (K3), 1 (K4) or 84 (K5) out
// per ray against ~65 f32 operations per triangle test.  From a few dozen
// triangles on, the f32 issue rate of the tests is the limit
// (chip_smoke.py counts both per launch).  The build keeps a*b + c as two
// rounded operations (--fmad=false), so every operation is an instruction
// and the tests are bound by instruction issue before the f32 rate.
//
// What the design of K3 and K4 does about it:
// - The blocks are persistent (as many as the card holds at once).  Each
//   warp stages its 32 rays' o and d (3 floats each, 12-byte strides)
//   through shared memory, so that every load reads whole lines, then
//   takes one ray a lane.
// - The table is swept from shared memory in chunks of 256 rows (K2's
//   layout, 3 float4 a row, one row staged a thread); every thread of a
//   warp reads the same row at the same step, a broadcast.  A table of at
//   most one chunk, as the render paths give (4 rows), is staged once a
//   block, and its warps then take 32 rays after 32 (K4: 64, two a lane)
//   with no barrier.  A larger one is swept by the block's 256 rays
//   together, each chunk staged between two barriers.
// - Where every row of a chunk is finite (a block-wide vote as it is
//   staged), the tests pick the sheared components by index (watertight.cuh's
//   SweepRay, as K2's do); a chunk with an infinite or NaN vertex chooses
//   the form per row, the one-hot form for such a row (a warp-uniform branch).
// - Each test takes the sign test of the edge functions first, and only a
//   row that passes it computes z, det and the scaled t; the error bound on
//   t only a test that passes the reject test (and for K3 only where t
//   would be the nearest).
// - K4 stops a ray at its first occluder, and on a large table a block's
//   256 rays once all are occluded (the vote after each chunk).  K3's row
//   loop is unrolled by 4 (a 4-row table in one pass); K4's is not, which
//   leaves it fewer registers and ran faster on both table sizes.
// - On the small tables the sweeps are bound by latency, not issue: at
//   56-64 registers an SM holds 32 warps.  Each warp issues the loads of
//   its next rays before it sweeps the current ones, and K4 gives a lane
//   two rays, whose tests of a row are independent work (80 registers, 24
//   warps, and faster).  Capping the registers (5 or 6 blocks an SM) made
//   ptxas spill in the row loop and ran slower.
// - The results are the plain PyTorch versions' (ops/intersect_kernel.py):
//   no fast math, --fmad=false, and the index-picked form differs from the
//   one-hot form at most in the sign of a zero.  Camera and specular rays
//   have t_max = FLT_MAX, so t_lim * det is +-inf (NaN when det = 0, which
//   the reject mask covers).
// K5 is the one-thread-a-ray kernel: each thread computes its ray's
// constants and reads the table rows from device memory through the
// read-only cache, every test in the one-hot form (watertight.cuh's
// closest_hit); it reads the winning row once (record.cuh, shared with K2)
// where the TPU kernel swept the whole table with selects, and misses skip
// the record.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "record.cuh"
#include "watertight.cuh"

namespace {

using namespace rs;

constexpr int kThreads = 256;  // K5: rays a block, one a thread
constexpr int kFullRows = 18;  // f32 rows of K5's output

struct Rays {
  const float* o;     // (n, 3)
  const float* d;     // (n, 3)
  const float* tmax;  // (n,)
  int n;
};

__device__ __forceinline__ RayConst load_ray(const Rays& r, int i, float& t_lim) {
  const float* o = r.o + 3 * static_cast<size_t>(i);
  const float* d = r.d + 3 * static_cast<size_t>(i);
  t_lim = r.tmax[i];
  return ray_constants(o[0], o[1], o[2], d[0], d[1], d[2]);
}

// ---- K3, K4: blocks of rays against the table, chunk by chunk ----

constexpr int kSweepThreads = 256;  // a block: 8 warps, one ray a thread at a time
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kChunk = kSweepThreads;  // rows staged at a time, one a thread
constexpr int kFinite = 9;  // a staged row's slot: 1 where its 9 coordinates are finite

// The constants of the index-picked test, sweep_ray's without the one-hot
// matrix, which only a row with a non-finite vertex reads (and rebuilds).
struct IdxRay {
  int kx, ky, kz;
  float sx, sy, cx, cy, cz, inv_dz;
};

// o, d: 3 floats each
__device__ __forceinline__ IdxRay idx_ray(const float* o, const float* d) {
  const SweepRay s = sweep_ray(o[0], o[1], o[2], d[0], d[1], d[2]);
  return {s.kx, s.ky, s.kz, s.sx, s.sy, s.rc.cx, s.rc.cy, s.rc.cz, s.rc.inv_dz};
}

// edges_reject<true> in three steps, so that most rows stop after the
// first: the transformed x, y and the edge functions (pz: each vertex's
// p[kz]); the sign test; then z, det, the scaled t and the range test.  The
// same values and the same reject mask: the least edge function is below 0
// exactly where one of them is (fminf, like the comparisons' OR, passes
// over a NaN), the largest above 0 likewise.
__device__ __forceinline__ void idx_edges(const IdxRay& r, const float* tri, float pz[3],
                                          Edges& g) {
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const float* p = tri + 3 * v;
    pz[v] = p[r.kz];
    g.x[v] = (p[r.kx] + r.sx * pz[v]) - r.cx;
    g.y[v] = (p[r.ky] + r.sy * pz[v]) - r.cy;
  }
  g.e0 = g.x[1] * g.y[2] - g.y[1] * g.x[2];
  g.e1 = g.x[2] * g.y[0] - g.y[2] * g.x[0];
  g.e2 = g.x[0] * g.y[1] - g.y[0] * g.x[1];
}

__device__ __forceinline__ bool mixed_signs(const Edges& g) {
  return fminf(fminf(g.e0, g.e1), g.e2) < 0.0f && fmaxf(fmaxf(g.e0, g.e1), g.e2) > 0.0f;
}

__device__ __forceinline__ bool idx_range_reject(const IdxRay& r, const float pz[3], float t_lim,
                                                 Edges& g) {
  g.det = g.e0 + g.e1 + g.e2;
#pragma unroll
  for (int v = 0; v < 3; ++v) g.zs[v] = r.inv_dz * (pz[v] - r.cz);
  g.t_scaled = g.e0 * g.zs[0] + g.e1 * g.zs[1] + g.e2 * g.zs[2];
  const bool neg_det = g.det < 0.0f;
  const bool miss_range =
      (neg_det && ((g.t_scaled >= 0.0f) || (g.t_scaled < t_lim * g.det))) ||
      (!neg_det && ((g.t_scaled <= 0.0f) || (g.t_scaled > t_lim * g.det)));
  return (g.det == 0.0f) || miss_range;
}

// A warp's 32 rays from `first` (n of them, the last group fewer), as its
// lanes load them: each lane 3 of the 96 floats of o and of d, so that every
// load reads whole lines, and its own t_max.
struct WarpRays {
  float o[3], d[3], t_lim;
  int n;
};

__device__ __forceinline__ void fetch_rays(const Rays& r, int first, WarpRays& w) {
  const int lane = threadIdx.x & 31;
  w.n = min(32, r.n - first);
  const size_t off = 3 * static_cast<size_t>(first);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int j = lane + 32 * k;
    if (j < 3 * w.n) {
      w.o[k] = __ldg(r.o + off + j);
      w.d[k] = __ldg(r.d + off + j);
    }
  }
  if (lane < w.n) w.t_lim = __ldg(r.tmax + first + lane);
}

// Passes the rays through the warp's buffer (o then d, 96 floats each) and
// sets this lane's ray; false where the lane has none.  Every lane of the
// warp calls it.
__device__ __forceinline__ bool warp_ray(const WarpRays& w, float* buf, IdxRay& ray) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // every lane has read the last rays
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int j = lane + 32 * k;
    if (j < 3 * w.n) {
      buf[j] = w.o[k];
      buf[96 + j] = w.d[k];
    }
  }
  __syncwarp();
  if (lane >= w.n) return false;
  ray = idx_ray(buf + 3 * lane, buf + 96 + 3 * lane);
  return true;
}

// Stages rows c0 .. c0 + cn - 1 of the table, one a thread, as kVertStride
// floats: the 9 vertex coordinates, the finite flag, two zeros.  A barrier;
// returns whether every staged row is finite.
__device__ __forceinline__ bool stage_chunk(float4* st, const float* tris, int cols, int c0,
                                            int cn) {
  bool fin = true;
  const int j = threadIdx.x;
  if (j < cn) {
    const float* row = tris + static_cast<size_t>(c0 + j) * cols;
    float p[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      p[k] = __ldg(row + k);
      fin = fin && isfinite(p[k]);
    }
    st[3 * j] = make_float4(p[0], p[1], p[2], p[3]);
    st[3 * j + 1] = make_float4(p[4], p[5], p[6], p[7]);
    st[3 * j + 2] = make_float4(p[8], fin ? 1.0f : 0.0f, 0.0f, 0.0f);
  }
  return __syncthreads_and(fin);
}

// A test of a row with an infinite or NaN vertex: the one-hot form, from the
// ray's o and d (od: o, then d 96 floats on).  Out of line, so that its
// registers do not weigh on the sweeps of finite rows.
struct OneHotHit {
  float t, b0, b1;
  bool hit;  // K3: a hit nearer than the bt given; K4: any hit
};

template <bool kAny>
__device__ __noinline__ OneHotHit one_hot_test(const float* od, const float* tri, float t_lim,
                                               float bt) {
  SweepRay r;
  r.rc = ray_constants(od[0], od[1], od[2], od[96], od[97], od[98]);
  Edges g;
  OneHotHit h = {0.0f, 0.0f, 0.0f, false};
  if (edges_reject<false>(r, tri, t_lim, g)) return h;
  if (kAny) {
    const float t_signed = g.det < 0.0f ? -g.t_scaled : g.t_scaled;
    h.hit = !(t_signed <= edges_c_eps(g));
    return h;
  }
  const float inv_det = 1.0f / (g.det == 0.0f ? 1.0f : g.det);
  h.t = g.t_scaled * inv_det;
  h.hit = h.t < bt && !(h.t <= edges_c_eps(g) * fabsf(inv_det));
  h.b0 = g.e0 * inv_det;
  h.b1 = g.e1 * inv_det;
  return h;
}

// K3's sweep of one ray over staged rows, watertight_tri's test a row: the
// bound only for a test that passes the reject test and would be the
// nearest (the plain sweep's hit & (t < bt)).
struct Closest {
  float bt = kNoHit, b0 = 0.0f, b1 = 0.0f;
  int bi = -1;

  // rows [c0, c0 + cn) staged in st; kPerRow: each row's flag picks its
  // form (the chunk holds a non-finite row), else the index form
  template <bool kPerRow>
  __device__ __forceinline__ void sweep(const IdxRay& r, const float* od, const float* st,
                                        int cn, int c0, float t_lim) {
#pragma unroll 4
    for (int t = 0; t < cn; ++t, st += kVertStride) {
      if (kPerRow && st[kFinite] == 0.0f) {
        const OneHotHit h = one_hot_test<false>(od, st, t_lim, bt);
        if (h.hit) {
          bt = h.t;
          bi = c0 + t;
          b0 = h.b0;
          b1 = h.b1;
        }
        continue;
      }
      Edges g;
      float pz[3];
      idx_edges(r, st, pz, g);
      if (mixed_signs(g)) continue;
      if (idx_range_reject(r, pz, t_lim, g)) continue;
      const float inv_det = 1.0f / (g.det == 0.0f ? 1.0f : g.det);
      const float tt = g.t_scaled * inv_det;
      if (!(tt < bt) || tt <= edges_c_eps(g) * fabsf(inv_det)) continue;
      bt = tt;
      bi = c0 + t;
      b0 = g.e0 * inv_det;
      b1 = g.e1 * inv_det;
    }
  }
  __device__ __forceinline__ bool done() const { return false; }
};

// K4's, watertight_tri_any's test a row (division free: t_scaled * sign(det)
// against the bound scaled by |det|) up to the ray's first occluder
struct Any {
  bool occluded = false;

  template <bool kPerRow>
  __device__ __forceinline__ void sweep(const IdxRay& r, const float* od, const float* st,
                                        int cn, int, float t_lim) {
    if (occluded) return;
#pragma unroll 1
    for (int t = 0; t < cn; ++t, st += kVertStride) {
      if (kPerRow && st[kFinite] == 0.0f) {
        if (!one_hot_test<true>(od, st, t_lim, 0.0f).hit) continue;
        occluded = true;
        return;
      }
      Edges g;
      float pz[3];
      idx_edges(r, st, pz, g);
      if (mixed_signs(g)) continue;
      if (idx_range_reject(r, pz, t_lim, g)) continue;
      const float t_signed = g.det < 0.0f ? -g.t_scaled : g.t_scaled;
      if (t_signed <= edges_c_eps(g)) continue;
      occluded = true;
      return;
    }
  }
  __device__ __forceinline__ bool done() const { return occluded; }
};

// The blocks of K3 and K4, persistent (the grid fills the card's block slots
// once).  kOneChunk, a table of at most kChunk rows, as the render paths
// give: it is staged once, and each warp then takes 32 rays at a time with
// no barrier.  Else the block's 256 rays sweep the table together chunk by
// chunk, each chunk staged between two barriers; the first is a vote, which
// ends K4's tile once each of its rays is occluded.  out(i, state, t_lim)
// writes ray i.
template <class State, bool kOneChunk, class Out>
__device__ __forceinline__ void sweep_block(const Rays& r, const float* tris, int n_tri,
                                            int cols, Out out) {
  __shared__ float4 st[3 * kChunk];
  __shared__ float sray[kSweepWarps][6 * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* s = reinterpret_cast<const float*>(st);
  if constexpr (kOneChunk) {
    const bool all_finite = stage_chunk(st, tris, cols, 0, n_tri);
    const int stride = gridDim.x * kSweepThreads;
    int first = (blockIdx.x * kSweepWarps + warp) * 32;
    WarpRays w;
    if (first < r.n) fetch_rays(r, first, w);
    for (; first < r.n; first += stride) {
      IdxRay ray;
      const bool active = warp_ray(w, sray[warp], ray);
      const float t_lim = w.t_lim;
      // the next rays' loads are in flight while this warp sweeps
      if (first + stride < r.n) fetch_rays(r, first + stride, w);
      if (!active) continue;
      State state;
      const float* od = sray[warp] + 3 * lane;
      if (all_finite)
        state.template sweep<false>(ray, od, s, n_tri, 0, t_lim);
      else
        state.template sweep<true>(ray, od, s, n_tri, 0, t_lim);
      out(first + lane, state, t_lim);
    }
  } else {
    for (int tile = blockIdx.x * kSweepThreads; tile < r.n; tile += gridDim.x * kSweepThreads) {
      WarpRays w;
      fetch_rays(r, tile + warp * 32, w);
      IdxRay ray;
      const bool active = warp_ray(w, sray[warp], ray);
      const float t_lim = w.t_lim;
      const float* od = sray[warp] + 3 * lane;
      State state;
      for (int c0 = 0; c0 < n_tri; c0 += kChunk) {
        // a barrier (every thread is done with the last chunk) and the vote
        if (!__syncthreads_or(active && !state.done())) break;
        const int cn = min(kChunk, n_tri - c0);
        const bool all_finite = stage_chunk(st, tris, cols, c0, cn);
        if (!active) continue;
        if (all_finite)
          state.template sweep<false>(ray, od, s, cn, c0, t_lim);
        else
          state.template sweep<true>(ray, od, s, cn, c0, t_lim);
      }
      if (active) out(tile + warp * 32 + lane, state, t_lim);
    }
  }
}

struct ClosestOut {
  float *t, *b0, *b1;
  int* tri;
  __device__ __forceinline__ void operator()(int i, const Closest& c, float t_lim) const {
    t[i] = c.bi >= 0 ? c.bt : t_lim;
    tri[i] = c.bi;
    b0[i] = c.b0;
    b1[i] = c.b1;
  }
};

struct AnyOut {
  uint8_t* occ;
  __device__ __forceinline__ void operator()(int i, const Any& a, float) const {
    occ[i] = a.occluded ? 1 : 0;
  }
};

// K4 on a table of at most one chunk, two rays a lane: each warp takes 64
// rays at a time, and a row's tests of a lane's two rays are independent
// work that the scheduler interleaves.
__device__ __forceinline__ bool any_rest(const IdxRay& r, const float pz[3], float t_lim,
                                         Edges& g) {
  if (idx_range_reject(r, pz, t_lim, g)) return false;
  const float t_signed = g.det < 0.0f ? -g.t_scaled : g.t_scaled;
  return !(t_signed <= edges_c_eps(g));
}

__device__ __forceinline__ void any_pairs(const Rays& r, const float* tris, int n_tri, int cols,
                                          AnyOut out) {
  __shared__ float4 st[3 * kChunk];
  __shared__ float sray[kSweepWarps][2][6 * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* s = reinterpret_cast<const float*>(st);
  const bool all_finite = stage_chunk(st, tris, cols, 0, n_tri);
  const int stride = gridDim.x * kSweepThreads * 2;
  int first = (blockIdx.x * kSweepWarps + warp) * 64;
  WarpRays w[2];
  if (first < r.n) {
    fetch_rays(r, first, w[0]);
    fetch_rays(r, first + 32, w[1]);
  }
  for (; first < r.n; first += stride) {
    IdxRay ray[2] = {};  // a lane without a ray reads row components 0
    bool active[2], occ[2];
    float t_lim[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      active[k] = warp_ray(w[k], sray[warp][k], ray[k]);
      t_lim[k] = w[k].t_lim;
      occ[k] = !active[k];  // a lane without a ray counts as done
    }
    if (first + stride < r.n) {
      fetch_rays(r, first + stride, w[0]);
      fetch_rays(r, first + stride + 32, w[1]);
    }
    if (all_finite) {
      const float* row = s;
#pragma unroll 1
      for (int t = 0; t < n_tri && !(occ[0] && occ[1]); ++t, row += kVertStride) {
        Edges g[2];
        float pz[2][3];
        bool pass[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) idx_edges(ray[k], row, pz[k], g[k]);
#pragma unroll
        for (int k = 0; k < 2; ++k) pass[k] = !occ[k] && !mixed_signs(g[k]);
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (pass[k]) occ[k] = any_rest(ray[k], pz[k], t_lim[k], g[k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (!active[k]) continue;
        Any a;
        a.template sweep<true>(ray[k], sray[warp][k] + 3 * lane, s, n_tri, 0, t_lim[k]);
        occ[k] = a.occluded;
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (active[k]) out.occ[first + 32 * k + lane] = occ[k] ? 1 : 0;
  }
}

template <bool kOneChunk>
__global__ void __launch_bounds__(kSweepThreads)
    closest_kernel(Rays r, const float* tris, int n_tri, int cols, ClosestOut out) {
  sweep_block<Closest, kOneChunk>(r, tris, n_tri, cols, out);
}

template <bool kOneChunk>
__global__ void __launch_bounds__(kSweepThreads)
    any_kernel(Rays r, const float* tris, int n_tri, int cols, AnyOut out) {
  if constexpr (kOneChunk)
    any_pairs(r, tris, n_tri, cols, out);
  else
    sweep_block<Any, false>(r, tris, n_tri, cols, out);
}

// The persistent grid of K3 and K4: as many blocks as the card holds at
// once, at most one a tile of kSweepThreads rays.
inline cudaError_t sweep_grid(const void* kernel, int n, int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSweepThreads, 0);
  const long long tiles = (static_cast<long long>(n) + kSweepThreads - 1) / kSweepThreads;
  const long long slots = static_cast<long long>(sms) * max(per_sm, 1);
  blocks = static_cast<int>(std::min(tiles, slots));
  return err;
}

// ---- K5: one ray a thread, the table read from device memory ----

__global__ void __launch_bounds__(kThreads)
    full_kernel(Rays r, const float* tris, int n_tri, float* f_out, int* i_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r.n) return;
  float t_lim;
  const RayConst rc = load_ray(r, i, t_lim);
  float bt, b0, b1;
  const int bi = closest_hit(rc, tris, n_tri, kTriCols, t_lim, bt, b0, b1);
  float v[kFullRows];
  int mat = 0, light = -1;
  if (bi >= 0) {
    const TriRecord rec = tri_record<true>(tris + static_cast<size_t>(bi) * kTriCols, b0, b1);
    const float rows[kFullRows] = {bt,         rec.p.x,    rec.p.y,     rec.p.z,    rec.p_err.x,
                                   rec.p_err.y, rec.p_err.z, rec.ng.x,   rec.ng.y,   rec.ng.z,
                                   rec.ns.x,   rec.ns.y,   rec.ns.z,    rec.u,      rec.v,
                                   rec.dpdu.x, rec.dpdu.y, rec.dpdu.z};
#pragma unroll
    for (int k = 0; k < kFullRows; ++k) v[k] = rows[k];
    mat = rec.mat;
    light = rec.light;
  } else {
    v[0] = t_lim;
#pragma unroll
    for (int k = 1; k < kFullRows; ++k) v[k] = 0.0f;
  }
  const size_t N = r.n;
#pragma unroll
  for (int k = 0; k < kFullRows; ++k) f_out[k * N + i] = v[k];
  i_out[i] = bi;
  i_out[N + i] = mat;
  i_out[2 * N + i] = light;
}

inline Rays rays(const void* o, const void* d, const void* tmax, int n) {
  return Rays{static_cast<const float*>(o), static_cast<const float*>(d),
              static_cast<const float*>(tmax), n};
}

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int rs_closest_sweep(const void* o, const void* d, const void* tmax, int n,
                                const void* tris, int n_tri, int cols, void* t_out,
                                void* tri_out, void* b0_out, void* b1_out, void* stream) {
  if (n == 0) return 0;
  auto kernel = n_tri <= kChunk ? closest_kernel<true> : closest_kernel<false>;
  int grid = 0;
  const cudaError_t err = sweep_grid(reinterpret_cast<const void*>(kernel), n, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ClosestOut out{static_cast<float*>(t_out), static_cast<float*>(b0_out),
                       static_cast<float*>(b1_out), static_cast<int*>(tri_out)};
  kernel<<<grid, kSweepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rays(o, d, tmax, n), static_cast<const float*>(tris), n_tri, cols, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rs_any_sweep(const void* o, const void* d, const void* tmax, int n,
                            const void* tris, int n_tri, int cols, void* occ_out,
                            void* stream) {
  if (n == 0) return 0;
  auto kernel = n_tri <= kChunk ? any_kernel<true> : any_kernel<false>;
  int grid = 0;
  const cudaError_t err = sweep_grid(reinterpret_cast<const void*>(kernel), n, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kSweepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rays(o, d, tmax, n), static_cast<const float*>(tris), n_tri, cols,
      AnyOut{static_cast<uint8_t*>(occ_out)});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rs_full_sweep(const void* o, const void* d, const void* tmax, int n,
                             const void* tris, int n_tri, void* f_out, void* i_out,
                             void* stream) {
  if (n == 0) return 0;
  full_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rays(o, d, tmax, n), static_cast<const float*>(tris), n_tri,
      static_cast<float*>(f_out), static_cast<int*>(i_out));
  return static_cast<int>(cudaGetLastError());
}
