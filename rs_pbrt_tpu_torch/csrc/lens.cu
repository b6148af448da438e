// L1: the realistic camera's rays, one thread a lane.
//
// Replaces the realistic branch of the JAX package's camera ray generation
// (rs_pbrt_tpu/models/cameras.py:214-264: the film point, the exit-pupil
// bin lookup, the point on the rear element, the cos^4 weight) with its
// element loop (rs_pbrt_tpu/models/realistic.py:231 trace_from_film_jnp,
// unrolled at trace time over the elements), which XLA runs on every lane.
// Here one thread takes a lane through lens.cuh's math: it reads p_film
// and u_lens (16 bytes) and writes o, d (world space) and the weight (28
// bytes).
//
// What bounds it on the card: ~100 f32 operations a lane and ~77 a
// spherical element up to the lane's first failed test (a vignetted lane
// stops early), against 44 bytes of traffic: for a lens of one or two
// elements the bytes, for a many-element lens the operations.
// What the design does about it: the element rows (rear first, their
// branches decided on the host: stop or sphere, eta_t from the next
// element), the lane constants, cam_to_world and the 64 pupil rows are
// launch constants, staged into shared memory once a block: every thread
// walks the same rows in the same order (broadcast reads), and a lane
// reads its pupil row by its film radius.  Loads and
// stores are strided by the lane's 2, 3 or 1 floats, each warp's a few
// cache lines.
#include <cuda_runtime.h>

#include "lens.cuh"

namespace {

constexpr int kThreads = 256;

struct Args {
  const float* p_film;  // (n, 2)
  const float* u_lens;  // (n, 2)
  float* o;  // (n, 3)
  float* d;  // (n, 3)
  float* w;  // (n,)
  int n, n_el;
  float lane[lens::kLaneFloats];
  float m[16];
  float pupil[lens::kBins * 4];
  float el[lens::kMaxElements * lens::kElementFloats];
};

__global__ void __launch_bounds__(kThreads) lens_kernel(const __grid_constant__ Args a) {
  // the tables, staged once a block: every thread reads them, the pupil
  // rows at its own bin
  __shared__ float lane[lens::kLaneFloats], m[16], pupil[lens::kBins * 4],
      el[lens::kMaxElements * lens::kElementFloats];
  for (int k = threadIdx.x; k < lens::kBins * 4; k += blockDim.x) pupil[k] = a.pupil[k];
  for (int k = threadIdx.x; k < a.n_el * lens::kElementFloats; k += blockDim.x) el[k] = a.el[k];
  if (threadIdx.x < lens::kLaneFloats) lane[threadIdx.x] = a.lane[threadIdx.x];
  if (threadIdx.x < 16) m[threadIdx.x] = a.m[threadIdx.x];
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  float o[3], d[3], w;
  lens::trace_lane(lane, el, a.n_el, pupil, m, a.p_film[2 * i], a.p_film[2 * i + 1],
                   a.u_lens[2 * i], a.u_lens[2 * i + 1], o, d, &w);
  for (int c = 0; c < 3; ++c) {
    a.o[3 * i + c] = o[c];
    a.d[3 * i + c] = d[c];
  }
  a.w[i] = w;
}

}  // namespace

// p_film, u_lens: n (x, y) pairs on the card; o, d, w: the outputs.  lane:
// kLaneFloats host floats; m: 16 (cam_to_world, row-major); pupil: kBins x
// 4; el: n_el x kElementFloats, rear element first.
extern "C" int rs_lens_rays(const void* p_film, const void* u_lens, void* o, void* d, void* w,
                            int n, const float* lane, const float* m, const float* pupil,
                            const float* el, int n_el, void* stream) {
  if (n < 0 || n_el < 1 || n_el > lens::kMaxElements)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Args a{};
  a.p_film = static_cast<const float*>(p_film);
  a.u_lens = static_cast<const float*>(u_lens);
  a.o = static_cast<float*>(o);
  a.d = static_cast<float*>(d);
  a.w = static_cast<float*>(w);
  a.n = n;
  a.n_el = n_el;
  for (int k = 0; k < lens::kLaneFloats; ++k) a.lane[k] = lane[k];
  for (int k = 0; k < 16; ++k) a.m[k] = m[k];
  for (int k = 0; k < lens::kBins * 4; ++k) a.pupil[k] = pupil[k];
  for (int k = 0; k < n_el * lens::kElementFloats; ++k) a.el[k] = el[k];
  const int grid = (n + kThreads - 1) / kThreads;
  lens_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
