// R1: the filter splat, one thread a lane.
//
// Replaces the JAX package's film update for filters other than the
// half-pixel box (rs_pbrt_tpu/ops/film.py:117 add_samples), which unrolls
// the F x F footprint (film.py:112) into F^2 filter evaluations over every
// lane and two scatter-adds each.  Here a thread takes a lane: it reads
// p_film and L (20 bytes), counts NaN or infinite L as black, evaluates
// the filter's F factors of each axis once (splat.cuh) and adds w L and w
// of each tap inside the film with a nonzero weight into the film's rgb
// (H, W, 3) and weight (H, W), in place, with atomic adds
// (red.global.add.f32).  Any p_film, as the JAX function takes.
//
// What bounds it on the card: the atomics.  At 256x256 and 64 spp with a
// footprint of 5, every film float takes ~1,600 adds, which the L2
// serializes per address; the bytes (20 a lane, the 1 MB film once) and
// the filter's operations (2F factors and F^2 products a lane) are small
// beside them.  What the design does about it: nothing yet; this is the
// first, simple form.  The adds land in no fixed order, so the film is
// not bit-equal to the plain version's (which on the card sums in no
// fixed order either): chip_smoke.py holds each pixel within a tolerance
// of its summed |terms|.  A later form gathers instead (ROADMAP queue B):
// over the grid layout render_batch always uses, pixel p reads the samples
// of the (F+1)^2 source pixels around it in a fixed order, deterministic
// and without atomics.
#include <cuda_runtime.h>

#include "splat.cuh"

namespace {

constexpr int kThreads = 256;

struct Args {
  const float* p_film;  // (n, 2)
  const float* L;  // (n, 3)
  float* rgb;  // (h, w, 3)
  float* weight;  // (h, w)
  int n, w, h, taps, kind;
  float c[splat::kConsts];
};

__global__ void __launch_bounds__(kThreads) splat_kernel(const __grid_constant__ Args a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const float px = a.p_film[2 * i], py = a.p_film[2 * i + 1];
  float L[3] = {a.L[3 * i], a.L[3 * i + 1], a.L[3 * i + 2]};
  if (!(isfinite(L[0]) && isfinite(L[1]) && isfinite(L[2]))) L[0] = L[1] = L[2] = 0.0f;
  const int x0 = splat::first_tap(px, a.c[splat::kOffX]);
  const int y0 = splat::first_tap(py, a.c[splat::kOffY]);
  float fx[splat::kMaxTaps];
#pragma unroll
  for (int k = 0; k < splat::kMaxTaps; ++k)
    fx[k] = k < a.taps ? splat::factor(a.kind, a.c, 0, splat::tap_offset(x0 + k, px)) : 0.0f;
  for (int k = 0; k < a.taps; ++k) {
    const int y = y0 + k;
    if (y < 0 || y >= a.h) continue;
    const float fy = splat::factor(a.kind, a.c, 1, splat::tap_offset(y, py));
    if (fy == 0.0f) continue;
    float* rgb_row = a.rgb + 3LL * y * a.w;
    float* w_row = a.weight + static_cast<long long>(y) * a.w;
#pragma unroll
    for (int j = 0; j < splat::kMaxTaps; ++j) {
      const int x = x0 + j;
      if (j >= a.taps || x < 0 || x >= a.w) continue;
      const float wt = fx[j] * fy;
      if (wt == 0.0f) continue;
      atomicAdd(rgb_row + 3 * x, wt * L[0]);
      atomicAdd(rgb_row + 3 * x + 1, wt * L[1]);
      atomicAdd(rgb_row + 3 * x + 2, wt * L[2]);
      atomicAdd(w_row + x, wt);
    }
  }
}

}  // namespace

// p_film (n, 2), L (n, 3) on the card; rgb (h, w, 3) and weight (h, w) the
// film, updated in place; taps: the footprint F; kind: the FILTER_* tag;
// c: splat::kConsts host floats.
extern "C" int rs_splat(const void* p_film, const void* L, void* rgb, void* weight, int n, int w,
                        int h, int taps, int kind, const float* c, void* stream) {
  if (n < 0 || w < 1 || h < 1 || taps < 1 || taps > splat::kMaxTaps || kind < splat::kBox ||
      kind > splat::kSinc)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Args a{};
  a.p_film = static_cast<const float*>(p_film);
  a.L = static_cast<const float*>(L);
  a.rgb = static_cast<float*>(rgb);
  a.weight = static_cast<float*>(weight);
  a.n = n;
  a.w = w;
  a.h = h;
  a.taps = taps;
  a.kind = kind;
  for (int k = 0; k < splat::kConsts; ++k) a.c[k] = c[k];
  const int grid = (n + kThreads - 1) / kThreads;
  splat_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
