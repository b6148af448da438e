// W1: the MIS weight of one BDPT connection strategy (s, t), one thread a
// lane.
//
// Replaces the JAX package's rs_pbrt_tpu/models/integrators/bdpt.py:465
// _mis_weight (reference bdpt.rs mis_weight :1505), an XLA loop that the
// trace unrolls into two ratio-product chains over the subpath vertices
// per strategy: about ten small tensor ops a vertex in plain PyTorch, some
// 1,100 a BDPT evaluation at depth 5, on every BDPT sample and every MLT
// mutation.  The per-lane math is mis.cuh's: the camera side from t-1 down
// to 1, the light side from s-1 down to 0, ri = (ri * remap0(pdf_rev)) /
// remap0(pdf_fwd) and sum_ri += ri unless the vertex or its neighbour is
// delta, then 1 / (1 + sum_ri); in the JAX order, so under --fmad=false
// the kernel is bit-equal to its plain version (ops/mis_kernel.py).
//
// The subpaths are stored slot-major, (D, n) columns, so slot v of every
// lane is one contiguous row and a warp's reads of a vertex are coalesced.
// The strategy's endpoint overrides (the reference's ScopedAssignment
// temporaries) come as (n,) rows, a null pointer where the strategy sets
// none.  Bound by bytes: a lane reads 9 bytes (pdf_fwd, pdf_rev, delta)
// of each vertex it walks and its overrides, and writes 4; the arithmetic
// is three operations a vertex.  One launch a strategy.
#include <cuda_runtime.h>

#include <cstdint>

#include "mis.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) mis_kernel(const mis::Columns a, float* out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < a.n) out[i] = mis::weight(a, i);
}

}  // namespace

// c_*: (dc, n), l_*: (dl, n) slot-major columns; ov: mis::kFloatSlots
// pointers (null: no override); ov_l0_delta, l0_is_delta may be null.
// t in [1, dc], s in [0, dl].
extern "C" int rs_mis_weight(const void* c_fwd, const void* c_rev, const void* c_delta,
                             const void* l_fwd, const void* l_rev, const void* l_delta,
                             const void* const* ov, const void* ov_l0_delta,
                             const void* l0_is_delta, void* out, long long n, int dc, int dl,
                             int s, int t, void* stream) {
  if (n < 0 || n >= (1LL << 31) * kThreads || t < 1 || t > dc || s < 0 || s > dl)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  mis::Columns a{static_cast<const float*>(c_fwd), static_cast<const float*>(c_rev),
                 static_cast<const uint8_t*>(c_delta), static_cast<const float*>(l_fwd),
                 static_cast<const float*>(l_rev), static_cast<const uint8_t*>(l_delta), {},
                 static_cast<const uint8_t*>(ov_l0_delta),
                 static_cast<const uint8_t*>(l0_is_delta), n, s, t};
  for (int k = 0; k < mis::kFloatSlots; ++k) a.ov[k] = static_cast<const float*>(ov[k]);
  const long long blocks = (n + kThreads - 1) / kThreads;
  mis_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
