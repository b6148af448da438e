// K3, K4, K5: dense ray-triangle sweeps, one thread per ray.
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
// (chip_smoke.py counts both per launch).
//
// What the design does about it, for now simple kernels that are right:
// - The table stays in device memory and is read through the read-only
//   cache.  Every thread of a warp reads the same row at the same step, so
//   each read is a broadcast; the sweep loops exactly n_tri rows (no padded
//   rows, no padded ray lanes: the last block masks its ragged edge).
//   4096 rows x 128 B do not fit the 227 KB of shared memory a block may
//   use, and a 4-row table stays in L1.
// - K5 reads the winning row once (record.cuh, shared with K2) where the TPU
//   kernel swept the whole table with selects; misses skip the record.
// - K4 stops at the first occluder.
// - The tests are watertight.cuh's, shared with K2.  Camera and specular
//   rays have t_max = FLT_MAX, so t_lim * det is +-inf (NaN when det = 0,
//   which the reject mask covers); the build keeps IEEE semantics (no fast
//   math, --fmad=false), so the results are the plain PyTorch versions'
//   (ops/intersect_kernel.py), term by term.
#include <cuda_runtime.h>

#include <cstdint>

#include "record.cuh"
#include "watertight.cuh"

namespace {

using namespace rs;

constexpr int kThreads = 256;
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

__global__ void __launch_bounds__(kThreads)
    closest_kernel(Rays r, const float* tris, int n_tri, int cols, float* t_out, int* tri_out,
                   float* b0_out, float* b1_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r.n) return;
  float t_lim;
  const RayConst rc = load_ray(r, i, t_lim);
  float bt, b0, b1;
  const int bi = closest_hit(rc, tris, n_tri, cols, t_lim, bt, b0, b1);
  t_out[i] = bi >= 0 ? bt : t_lim;
  tri_out[i] = bi;
  b0_out[i] = b0;
  b1_out[i] = b1;
}

__global__ void __launch_bounds__(kThreads)
    any_kernel(Rays r, const float* tris, int n_tri, int cols, uint8_t* occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r.n) return;
  float t_lim;
  const RayConst rc = load_ray(r, i, t_lim);
  occ_out[i] = any_hit(rc, tris, n_tri, cols, t_lim) ? 1 : 0;
}

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
  closest_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rays(o, d, tmax, n), static_cast<const float*>(tris), n_tri, cols,
      static_cast<float*>(t_out), static_cast<int*>(tri_out), static_cast<float*>(b0_out),
      static_cast<float*>(b1_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rs_any_sweep(const void* o, const void* d, const void* tmax, int n,
                            const void* tris, int n_tri, int cols, void* occ_out,
                            void* stream) {
  if (n == 0) return 0;
  any_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rays(o, d, tmax, n), static_cast<const float*>(tris), n_tri, cols,
      static_cast<uint8_t*>(occ_out));
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
