// T1: texture evaluation, one thread a lane.
//
// Replaces the JAX package's XLA texture evaluation
// (rs_pbrt_tpu/ops/texture.py:286 eval_texture, with eval_leaf :229, the
// Perlin noise :74, fbm :102, turbulence :116, the atlas's bilinear and
// trilinear lookups :183, :205), which runs every texture family present
// in the scene on every lane and keeps each lane's own with a chain of
// selects.  Here a lane switches on its texture's type and runs its own
// family alone; a scale, mix, checker or dots lane evaluates its two
// children as leaves.  The per-lane math is texture.cuh's, the plain
// version's ops in their order (ops/texture.py eval_texture).
//
// Lanes: ids (S, N), S rows of textures to evaluate at the same N points,
// so that a shading step's bound slots, a bump map's three evaluations or
// both alpha masks go in one launch; uv (N, 2) and p (N, 3) are shared by
// every row, or (S, N, 2) and (S, N, 3) one set a row; width (N,) shared,
// or none (level 0 without reading the pyramid).  Output (S, N, 3).
//
// What bounds it on the card: a noise lane does 8 lattice corners of three
// chained permutation-table reads an octave, up to 8 octaves (windy 9, a
// marble's fbm and its sine), ~200 flops a noise; an image lane 4 (or 8
// with a footprint) atlas texels of 12 bytes at its own rect.  Divergent
// per-lane branches and gathers: no blocked pass serves it.
// What the design does about it: this is the first, simple form.  The 2 KB
// permutation table is staged in shared memory once a block (every noise
// corner reads it three times); atlas texels and the tables go through the
// read-only cache.
#include <cuda_runtime.h>
#include <stdint.h>

#include "texture.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPerm = 512;

// MARBLE_C, the marble spline's nine control points (textures/marble.rs)
__constant__ float c_marble[27] = {0.58f, 0.58f, 0.6f,  0.58f, 0.58f, 0.6f,  0.58f, 0.58f, 0.6f,
                                   0.5f,  0.5f,  0.5f,  0.6f,  0.59f, 0.58f, 0.58f, 0.58f, 0.6f,
                                   0.58f, 0.58f, 0.6f,  0.2f,  0.2f,  0.33f, 0.58f, 0.58f, 0.6f};

struct Args {
  tex::Tables t;
  const int* ids;
  const float* uv;
  const float* p;
  const float* width;  // null: level 0
  int n, rows, per_row;  // per_row: uv and p hold one set a row
  float* out;
};

__global__ void texture_kernel(Args a) {
  __shared__ int perm[kPerm];
  for (int k = threadIdx.x; k < kPerm; k += blockDim.x) perm[k] = __ldg(a.t.perm + k);
  __syncthreads();
  const long long total = static_cast<long long>(a.rows) * a.n;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long j = i % a.n;  // the lane's point
  const long long q = a.per_row ? i : j;
  tex::Tables T = a.t;
  T.perm = perm;
  T.marble = c_marble;
  const float p[3] = {__ldg(a.p + 3 * q), __ldg(a.p + 3 * q + 1), __ldg(a.p + 3 * q + 2)};
  float out[3];
  tex::eval_texture(T, __ldg(a.ids + i), __ldg(a.uv + 2 * q), __ldg(a.uv + 2 * q + 1), p,
                    a.width != nullptr, a.width ? __ldg(a.width + j) : 0.0f, out);
  a.out[3 * i] = out[0];
  a.out[3 * i + 1] = out[1];
  a.out[3 * i + 2] = out[2];
}

}  // namespace

// tables: type, params, child, w2t, atlas, rect, mip, nlv, perm; n_tex,
// ah, aw, kind_mask; lanes: ids, uv, p, width (or null), n, rows, per_row;
// out; stream
extern "C" int rs_texture_eval(const void* type, const void* params, const void* child,
                               const void* w2t, const void* atlas, const void* rect,
                               const void* mip, const void* nlv, const void* perm, int n_tex,
                               int ah, int aw, int kind_mask, const void* ids, const void* uv,
                               const void* p, const void* width, int n, int rows, int per_row,
                               void* out, void* stream) {
  const long long total = static_cast<long long>(rows) * n;
  if (total == 0) return 0;
  Args a;
  a.t = tex::Tables{static_cast<const int*>(type), static_cast<const float*>(params),
                    static_cast<const int*>(child), static_cast<const float*>(w2t),
                    static_cast<const float*>(atlas), static_cast<const int*>(rect),
                    static_cast<const int*>(mip), static_cast<const int*>(nlv),
                    static_cast<const int*>(perm), nullptr, n_tex, ah, aw, kind_mask};
  a.ids = static_cast<const int*>(ids);
  a.uv = static_cast<const float*>(uv);
  a.p = static_cast<const float*>(p);
  a.width = static_cast<const float*>(width);
  a.n = n;
  a.rows = rows;
  a.per_row = per_row;
  a.out = static_cast<float*>(out);
  const long long blocks = (total + kThreads - 1) / kThreads;
  texture_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
