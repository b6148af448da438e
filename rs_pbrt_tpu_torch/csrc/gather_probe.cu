// P1, P2: the gather probe's kernels.
//
// Replace the two Pallas kernels of tools/tpu_probe.py part 3, which run
// on one TPU core with the whole table in VMEM:
// - P1 take_rows_kernel: kern (launched by pl.pallas_call at :117),
//   out[r, c] = tab[r, idx[r, c]];
// - P2 take_loop_kernel: kern_loop (:143), `steps` times acc += gather,
//   then idx = rem(idx * 1103515245 + 12345, C), + C where negative, in
//   int32 arithmetic with wraparound; writes acc.
// tab (R, C) f32, idx (R, C) int32 in [0, C), out (R, C) f32, all
// row-major; P2 stages a row of C * 4 bytes in a block's shared memory
// (at most 227 KB).  Index arithmetic is done in uint32 and reinterpreted,
// since signed overflow is undefined in C++.  Sums are taken in step
// order, so both kernels give their plain versions' bits
// (ops/gather_probe.py).
//
// P1 is one gather an element, 393 KB at the probe's (16, 2048): its time
// is the launch and one trip to memory, not its bytes.  Four elements a
// thread of the flattened array: the indices loaded and the outputs stored
// 16 bytes a thread where both are 16-byte aligned, the values gathered
// straight from the table through the read-only path (the table sits in
// L2); no staging, no barrier; a scalar tail.  (A block that staged its
// row in shared memory first was ~10% slower at the probe's shape.)
//
// P2 is bound by shared-memory loads (R * C * steps): an SM serves one
// wavefront a clock, a warp's 32 lanes where they hit distinct banks, one
// more for each further distinct word in a bank.  The index chain never
// reads the table, so only a step's load and its add wait on each other,
// and the adds stay in step order.
// - C a power of two (kPow2): C divides 2^32, so the update is
//   x -> (a x + b) & (C - 1) in uint32, and j steps fold into one,
//   x -> (A_j x + B_j) & (C - 1) (the host's constants,
//   ops/gather_probe.lcg_jump).  The index is kept as a byte offset (4 B_j,
//   mask 4C - 1); each chunk of kJump steps computes its offsets from the
//   chunk's first, so their loads are in flight together.
//   a is odd, so x -> a x + b is a bijection mod 32: lanes whose start
//   indices lie in distinct banks never meet in a bank, and a warp's loads
//   take, at every step, as many wavefronts as its most frequent start
//   bank (random start indices: 3.5 on average).  An SM pays a step the sum
//   over its warps, so the row's elements are dealt to the row's warps,
//   and these to its blocks, with the row's banks spread evenly (regroup):
//   at the probe's shape the worst block takes 12 wavefronts a step, where
//   warps of random columns take 33 and warps regrouped inside each block
//   22.  Every block ranks the whole row (stable, by column, so all blocks
//   deal alike) while cp.async stages its row of the table.  (At the probe's
//   shape this costs ~0.001 ms of set-up and saves ~0.01 ms of loop.)
// - Other C: the truncating signed remainder by the host's multiplier and
//   shift (ops/gather_probe.rem_magic), ~8 dependent integer operations a
//   step in place of the generic division; each block takes up to
//   kLoopThreads elements of one row in column order.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kMul = 1103515245u, kAdd = 12345u;
constexpr int kRowsThreads = 128;  // P1: 4 elements a thread
constexpr int kLoopThreads = 256;  // P2: a block's elements
constexpr int kWarps = kLoopThreads / 32;
constexpr int kJump = 8;   // P2, kPow2: steps whose loads are in flight together
constexpr int kBanks = 32;
constexpr int kBatch = 8;  // P2, kPow2: index loads in flight together in regroup
// P2, kPow2: regroup's shared memory after the row, besides the row's
// chunk prefixes (C / 2 words): each warp's segment counts (then bases),
// the leftovers' bank prefix, the level count, each slot's column and
// start index
constexpr int kSortWords = kWarps * kBanks + 2 * kBanks + 2 * kLoopThreads;

// j steps of the update in one, j = 1..kJump (entry 0 unused)
struct Jump {
  uint32_t mul[kJump + 1];  // a^j mod 2^32
  uint32_t add[kJump + 1];  // 4 b (1 + a + .. + a^(j-1)) mod 2^32: a byte offset
};

// v / C truncated = ((mulhi(mul, v) + (v & add)) >> shift) + (v < 0)
struct Magic {
  int mul;  // the multiplier M, less 2^32 where M >= 2^31
  int shift;
  int add;  // -1 where M >= 2^31 (the product by M - 2^32 needs v added back), else 0
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the row's cols floats into smem, 16 bytes a copy where the row allows,
// by cp.async, which needs no registers and does not stall the thread;
// __pipeline_wait_prior(0) waits for it
__device__ __forceinline__ void stage_row(const float* row, float* smem, int cols) {
  if ((cols & 3) == 0 && aligned16(row)) {
    for (int c = 4 * threadIdx.x; c < cols; c += 4 * blockDim.x)
      __pipeline_memcpy_async(smem + c, row + c, 16);
  } else {
    for (int c = threadIdx.x; c < cols; c += blockDim.x) __pipeline_memcpy_async(smem + c, row + c, 4);
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(kRowsThreads)
    take_rows_kernel(const float* tab, const int* idx, long long n, int cols, int vec, float* out) {
  const long long e = 4 * (static_cast<long long>(blockIdx.x) * kRowsThreads + threadIdx.x);
  if (e >= n) return;
  int c = static_cast<int>(e % cols);  // element e + k's column; its row starts at e + k - c
  if (vec && e + 4 <= n) {
    const int4 i = __ldg(reinterpret_cast<const int4*>(idx + e));
    const int is[4] = {i.x, i.y, i.z, i.w};
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[k] = __ldg(tab + (e + k - c) + is[k]);
      c = c + 1 == cols ? 0 : c + 1;
    }
    *reinterpret_cast<float4*>(out + e) = make_float4(o[0], o[1], o[2], o[3]);
    return;
  }
  for (long long k = e; k < e + 4 && k < n; ++k) {
    out[k] = __ldg(tab + (k - c) + idx[k]);
    c = c + 1 == cols ? 0 : c + 1;
  }
}

__device__ __forceinline__ float load_at(const float* smem, uint32_t byte_off) {
  return *reinterpret_cast<const float*>(reinterpret_cast<const char*>(smem) + byte_off);
}

// one step of the update for any C: rem(int32(a x + b), C), + C where negative
__device__ __forceinline__ int lcg_rem(int x, int cols, Magic m) {
  const uint32_t v = static_cast<uint32_t>(x) * kMul + kAdd;
  const uint32_t hi = static_cast<uint32_t>(__mulhi(m.mul, static_cast<int>(v))) +
                      (v & static_cast<uint32_t>(m.add));
  const uint32_t q = static_cast<uint32_t>(static_cast<int>(hi) >> m.shift) + (v >> 31);
  const int r = static_cast<int>(v - q * static_cast<uint32_t>(cols));
  return r < 0 ? r + cols : r;
}

// the start indices of this lane's column in chunks k0..k0 + kBatch - 1
// (0 from chunk k_hi on), loaded together
__device__ __forceinline__ void load_batch(const int* idx_row, int k_hi, int k0,
                                           int (&xs)[kBatch]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kBatch; ++i)
    xs[i] = k0 + i < k_hi ? __ldg(idx_row + (k0 + i) * kBanks + lane) : 0;
}

// the warp's ballots of the five bits of each lane's start bank
__device__ __forceinline__ void bank_ballots(int x, unsigned (&bits)[5]) {
#pragma unroll
  for (int i = 0; i < 5; ++i) bits[i] = __ballot_sync(~0u, x & 1 << i);
}

// the warp's lanes whose start bank is `bank`
__device__ __forceinline__ unsigned lanes_in_bank(const unsigned (&bits)[5], int bank) {
  unsigned lanes = ~0u;
#pragma unroll
  for (int i = 0; i < 5; ++i) lanes &= bank >> i & 1 ? bits[i] : ~bits[i];
  return lanes;
}

// The row's elements (cols >= 32, a power of two) dealt to its warps,
// W = cols / 32 of them, of which warp q runs in block q % parts as its
// warp q / parts.  Each element's rank among the row's elements of its
// start bank, by column, decides: the first L ranks of every bank make L
// levels of 32 distinct banks, one warp each; the rest, in (bank, rank)
// order, are dealt round robin over the other W - L warps, which then hold
// at most two of a bank where L = min(least count, 2W - most count).
// Chunk k is the row's columns 32k..32k+31; this block's warp w ranks the
// chunks of segment w, kBatch at a time, and keeps the first batch's start
// indices and ranks within their chunks for the dealing.  Sets this
// thread's column e and start index x0 (thread < the returned count of the
// block's elements).  scratch: cols / 2 + kSortWords words.
__device__ __forceinline__ int regroup(const int* idx_row, int cols, int parts, int part,
                                       float* scratch, int& e, int& x0) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int chunks = cols / kBanks;  // the row's warps, W
  const int per_seg = (chunks + kWarps - 1) / kWarps;
  const int k_lo = min(warp * per_seg, chunks), k_hi = min(k_lo + per_seg, chunks);
  // [chunk][bank]: the bank's count in the segment's chunks before this one
  uint16_t* prefix = reinterpret_cast<uint16_t*>(scratch);
  int* seg = reinterpret_cast<int*>(scratch + cols / 2);  // [warp][bank]: counts, then bases
  int* left_prefix = seg + kWarps * kBanks;
  int* levels = left_prefix + kBanks;
  int* slot_e = levels + kBanks;
  int* slot_x = slot_e + kLoopThreads;
  int first_x[kBatch], first_below[kBatch];
  int running = 0;  // bank `lane`'s count in the segment so far
  for (int k0 = k_lo; k0 < k_hi; k0 += kBatch) {
    int xs[kBatch], below[kBatch];
    load_batch(idx_row, k_hi, k0, xs);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      unsigned bits[5];
      bank_ballots(xs[i], bits);
      below[i] = __popc(lanes_in_bank(bits, xs[i] & (kBanks - 1)) & ((1u << lane) - 1u));
      if (k0 + i < k_hi) prefix[(k0 + i) * kBanks + lane] = static_cast<uint16_t>(running);
      running += k0 + i < k_hi ? __popc(lanes_in_bank(bits, lane)) : 0;
    }
    if (k0 == k_lo) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) first_x[i] = xs[i], first_below[i] = below[i];
    }
  }
  seg[warp * kBanks + lane] = running;
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = seg[w * kBanks + lane];
    base += w < warp ? v : 0;
    total += v;
  }
  __syncthreads();  // every count read before the bases overwrite them
  seg[warp * kBanks + lane] = base;
  if (warp == 0) {
    const int least = __reduce_min_sync(~0u, total), most = __reduce_max_sync(~0u, total);
    const int L = max(0, min(least, 2 * chunks - most));
    const int left = total - L;  // this bank's elements beyond the levels
    int incl = left;
#pragma unroll
    for (int d = 1; d < kBanks; d <<= 1) {
      const int u = __shfl_up_sync(~0u, incl, d);
      if (lane >= d) incl += u;
    }
    left_prefix[lane] = incl - left;
    if (lane == 0) levels[0] = L;
  }
  __syncthreads();
  const int L = levels[0], rest = chunks - L;
  // j / rest as the high word of j * rest_inv: exact for j < 2^16 and
  // rest < 2^11 (the error, below rest * j / 2^32, stays under 1 / rest)
  const uint32_t rest_inv = rest > 1 ? 0xffffffffu / rest + 1u : 0u;
  const int part_shift = __ffs(parts) - 1;  // parts is a power of two
  for (int k0 = k_lo; k0 < k_hi; k0 += kBatch) {
    int xs[kBatch], below[kBatch];
    if (k0 == k_lo) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) xs[i] = first_x[i], below[i] = first_below[i];
    } else {
      load_batch(idx_row, k_hi, k0, xs);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        unsigned bits[5];
        bank_ballots(xs[i], bits);
        below[i] = __popc(lanes_in_bank(bits, xs[i] & (kBanks - 1)) & ((1u << lane) - 1u));
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int k = k0 + i, bank = xs[i] & (kBanks - 1);
      const int rank = seg[warp * kBanks + bank] + prefix[min(k, k_hi - 1) * kBanks + bank] +
                       below[i];
      // a level's element, or the leftover j of the (bank, rank) order
      const uint32_t j = static_cast<uint32_t>(left_prefix[bank] + rank - L);
      const uint32_t jq = rest > 1 ? __umulhi(j, rest_inv) : j;
      const bool level = rank < L;
      const int q = level ? rank : L + static_cast<int>(j - jq * rest);
      const int l = level ? bank : static_cast<int>(jq);
      if (k < k_hi && (q & (parts - 1)) == part) {
        const int slot = (q >> part_shift) * kBanks + l;
        slot_e[slot] = k * kBanks + lane;
        slot_x[slot] = xs[i];
      }
    }
  }
  __syncthreads();
  const int n = (chunks >> part_shift) * kBanks;
  if (t < n) e = slot_e[t], x0 = slot_x[t];
  return n;
}

template <bool kPow2>
__global__ void __launch_bounds__(kLoopThreads)
    take_loop_kernel(const float* tab, const int* idx, int cols, int steps, Jump jump,
                     Magic magic, float* out) {
  extern __shared__ __align__(16) float smem[];
  const int parts = (cols + kLoopThreads - 1) / kLoopThreads;  // blocks of a row
  const int row = blockIdx.x / parts;
  const int part = blockIdx.x - row * parts;
  const float* tab_row = tab + static_cast<size_t>(row) * cols;
  const int* idx_row = idx + static_cast<size_t>(row) * cols;
  const int t = threadIdx.x;
  int n, e = 0, x0 = 0;  // the block's elements; this thread's column, its start index
  stage_row(tab_row, smem, cols);
  if constexpr (kPow2) {
    if (cols >= kBanks) {
      n = regroup(idx_row, cols, parts, part, smem + cols, e, x0);
    } else {
      n = cols, e = t;
      if (t < n) x0 = __ldg(idx_row + t);
    }
  } else {
    n = min(kLoopThreads, cols - part * kLoopThreads), e = part * kLoopThreads + t;
    if (t < n) x0 = __ldg(idx_row + e);
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (t >= n) return;
  float acc = 0.0f;
  if constexpr (kPow2) {
    const uint32_t mask = 4u * static_cast<uint32_t>(cols) - 1u;
    uint32_t off = 4u * static_cast<uint32_t>(x0);
    int s = 0;
    for (; s + kJump <= steps; s += kJump) {
      float g[kJump];
      g[0] = load_at(smem, off);
#pragma unroll
      for (int j = 1; j < kJump; ++j) g[j] = load_at(smem, (jump.mul[j] * off + jump.add[j]) & mask);
#pragma unroll
      for (int j = 0; j < kJump; ++j) acc = acc + g[j];
      off = (jump.mul[kJump] * off + jump.add[kJump]) & mask;
    }
    for (; s < steps; ++s) {
      acc = acc + load_at(smem, off);
      off = (jump.mul[1] * off + jump.add[1]) & mask;
    }
  } else {
    int cur = x0;
    for (int s = 0; s < steps; ++s) {
      const float g = smem[cur];
      cur = lcg_rem(cur, cols, magic);
      acc = acc + g;
    }
  }
  out[static_cast<size_t>(row) * cols + e] = acc;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return bytes > 48 * 1024 ? cudaFuncSetAttribute(
                                 kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes))
                           : cudaSuccess;
}

inline bool aligned16_host(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int rs_take_rows(const void* tab, const void* idx, int rows, int cols, void* out,
                            void* stream) {
  const long long n = static_cast<long long>(rows) * cols;
  if (n == 0) return 0;
  const long long threads = (n + 3) / 4;
  const int vec = aligned16_host(idx) && aligned16_host(out);
  take_rows_kernel<<<static_cast<unsigned>((threads + kRowsThreads - 1) / kRowsThreads),
                     kRowsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int*>(idx), n, cols, vec,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// jump: kJump pairs (A_j, 4 B_j), j = 1..kJump; magic: rem_magic(cols), read
// where cols is not a power of two
extern "C" int rs_take_loop(const void* tab, const void* idx, int rows, int cols, int steps,
                            const uint32_t* jump, int magic_mul, int magic_shift, int magic_add,
                            void* out, void* stream) {
  if (rows * cols == 0) return 0;
  Jump j{};
  for (int k = 1; k <= kJump; ++k) j.mul[k] = jump[2 * (k - 1)], j.add[k] = jump[2 * k - 1];
  const Magic m{magic_mul, magic_shift, magic_add};
  const bool pow2 = (cols & (cols - 1)) == 0;
  const size_t bytes = (pow2 ? cols + cols / 2 + kSortWords : cols) * sizeof(float);
  const unsigned blocks = rows * ((cols + kLoopThreads - 1) / kLoopThreads);
  const auto kernel = pow2 ? take_loop_kernel<true> : take_loop_kernel<false>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kLoopThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int*>(idx), cols, steps, j, m,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
