// P1, P2: the gather probe, gathers from a table staged in shared memory.
//
// Replace the two Pallas kernels of tools/tpu_probe.py part 3, which run
// on one TPU core with the whole table in VMEM:
// - P1 take_rows_kernel: kern (launched by pl.pallas_call at :117),
//   out[r, c] = tab[r, idx[r, c]];
// - P2 take_loop_kernel: kern_loop (:143), `steps` times acc += gather,
//   then idx = rem(idx * 1103515245 + 12345, C), + C where negative, in
//   int32 arithmetic with wraparound; writes acc.
// tab (R, C) f32, idx (R, C) int32 in [0, C), out (R, C) f32, all
// row-major; a row of C * 4 bytes must fit a block's shared memory (the
// probe's rows are 8 KB of the 227 KB).
//
// Design: element (r, c) gathers from row r only, so the grid is
// ceil(C / kThreads) blocks for each row, one element a thread (the
// probe's 16 x 2048 gives 256 blocks over the card's SMs).  Each block
// stages its row in dynamic shared memory (above 48 KB only after
// cudaFuncSetAttribute), then gathers from there.  The index update is
// computed in uint32 and reinterpreted, since signed overflow is undefined
// in C++; % truncates, as lax.rem does.  Sums are taken in step order, so
// both kernels give their plain versions' bits (ops/gather_probe.py).
//
// What bounds them: P1 the bytes (the table, idx and out once each); P2
// the shared-memory loads, R * C * steps at 32 a clock on each of the
// card's SMs (chip_smoke.py states the clock and SM count it reads).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

// stages row blockIdx.y of tab; returns this thread's column, or -1
__device__ __forceinline__ int stage_row(const float* tab, float* smem, int cols) {
  const float* row = tab + static_cast<size_t>(blockIdx.y) * cols;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) smem[c] = row[c];
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  return c < cols ? c : -1;
}

__device__ __forceinline__ int lcg(int i, int cols) {
  const uint32_t u = static_cast<uint32_t>(i) * 1103515245u + 12345u;
  int v = static_cast<int>(u) % cols;
  return v < 0 ? v + cols : v;
}

__global__ void __launch_bounds__(kThreads)
    take_rows_kernel(const float* tab, const int* idx, int cols, float* out) {
  extern __shared__ float smem[];
  const int c = stage_row(tab, smem, cols);
  if (c < 0) return;
  const size_t e = static_cast<size_t>(blockIdx.y) * cols + c;
  out[e] = smem[idx[e]];
}

__global__ void __launch_bounds__(kThreads)
    take_loop_kernel(const float* tab, const int* idx, int cols, int steps, float* out) {
  extern __shared__ float smem[];
  const int c = stage_row(tab, smem, cols);
  if (c < 0) return;
  const size_t e = static_cast<size_t>(blockIdx.y) * cols + c;
  int cur = idx[e];
  float acc = 0.0f;
  for (int s = 0; s < steps; ++s) {
    const float g = smem[cur];
    cur = lcg(cur, cols);
    acc = acc + g;
  }
  out[e] = acc;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return bytes > 48 * 1024 ? cudaFuncSetAttribute(
                                 kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes))
                           : cudaSuccess;
}

inline dim3 grid(int rows, int cols) { return dim3((cols + kThreads - 1) / kThreads, rows); }

}  // namespace

extern "C" int rs_take_rows(const void* tab, const void* idx, int rows, int cols, void* out,
                            void* stream) {
  const size_t bytes = static_cast<size_t>(cols) * sizeof(float);
  if (rows * cols == 0) return 0;
  const cudaError_t err = allow_smem(take_rows_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  take_rows_kernel<<<grid(rows, cols), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int*>(idx), cols,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rs_take_loop(const void* tab, const void* idx, int rows, int cols, int steps,
                            void* out, void* stream) {
  const size_t bytes = static_cast<size_t>(cols) * sizeof(float);
  if (rows * cols == 0) return 0;
  const cudaError_t err = allow_smem(take_loop_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  take_loop_kernel<<<grid(rows, cols), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int*>(idx), cols, steps,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
