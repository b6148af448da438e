// R2: the filter splat's vector-Jacobian product in L, one thread a lane.
//
// The backward of R1 (splat.cu) with respect to the samples' radiance.
// JAX differentiates its film update (rs_pbrt_tpu/ops/film.py:117
// add_samples) by transposing each tap's scatter-add into a gather, so
// grad_L[lane] is the sum over the lane's F x F taps inside the film of
// the tap's filter weight times the upstream gradient of the tap's pixel;
// a lane whose L is NaN or infinite (counted as black) gets 0.  The
// weights depend on the samples' raster points only, which carry no
// gradient.  Here a thread takes a lane and gathers its taps in the plain
// twin's order (dy major, dx minor; splat.cuh's factors), so it adds no
// atomics and its output is deterministic and equal to the twin's bit for
// bit.
//
// What bounds it on the card: the gathers.  A lane reads p_film and L (20
// bytes), F^2 pixels' 12-byte gradients (the film's, from L2 after their
// first reads) and writes 12 bytes.  What the design does about it:
// nothing yet; this is the first, simple form.
#include <cuda_runtime.h>

#include "splat.cuh"

namespace {

constexpr int kThreads = 256;

struct Args {
  const float* p_film;  // (n, 2)
  const float* L;  // (n, 3): only its finiteness is read
  const float* g_rgb;  // (h, w, 3)
  float* g_L;  // (n, 3)
  int n, w, h, taps, kind;
  float c[splat::kConsts];
};

__global__ void __launch_bounds__(kThreads) splat_grad_kernel(const __grid_constant__ Args a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  const float L0 = a.L[3 * i], L1 = a.L[3 * i + 1], L2 = a.L[3 * i + 2];
  if (isfinite(L0) && isfinite(L1) && isfinite(L2)) {
    const float px = a.p_film[2 * i], py = a.p_film[2 * i + 1];
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
      const float* row = a.g_rgb + 3LL * y * a.w;
#pragma unroll
      for (int j = 0; j < splat::kMaxTaps; ++j) {
        const int x = x0 + j;
        if (j >= a.taps || x < 0 || x >= a.w) continue;
        const float wt = fx[j] * fy;
        if (wt == 0.0f) continue;
        acc[0] = acc[0] + wt * __ldg(row + 3 * x);
        acc[1] = acc[1] + wt * __ldg(row + 3 * x + 1);
        acc[2] = acc[2] + wt * __ldg(row + 3 * x + 2);
      }
    }
  }
  a.g_L[3 * i] = acc[0];
  a.g_L[3 * i + 1] = acc[1];
  a.g_L[3 * i + 2] = acc[2];
}

}  // namespace

// p_film (n, 2), L (n, 3), g_rgb (h, w, 3) on the card; out g_L (n, 3);
// taps: the footprint F; kind: the FILTER_* tag; c: splat::kConsts host
// floats (ops/splat_kernel.filter_consts).
extern "C" int rs_splat_grad(const void* p_film, const void* L, const void* g_rgb, void* g_L,
                             int n, int w, int h, int taps, int kind, const float* c,
                             void* stream) {
  if (n < 0 || w < 1 || h < 1 || taps < 1 || taps > splat::kMaxTaps || kind < splat::kBox ||
      kind > splat::kSinc)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Args a{};
  a.p_film = static_cast<const float*>(p_film);
  a.L = static_cast<const float*>(L);
  a.g_rgb = static_cast<const float*>(g_rgb);
  a.g_L = static_cast<float*>(g_L);
  a.n = n;
  a.w = w;
  a.h = h;
  a.taps = taps;
  a.kind = kind;
  for (int k = 0; k < splat::kConsts; ++k) a.c[k] = c[k];
  const int grid = (n + kThreads - 1) / kThreads;
  splat_grad_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
