// G1: the vector-Jacobian product of the closest triangle hit, one thread
// a lane.
//
// The backward of the differentiable closest hit (ops/hit_grad_kernel.py
// TriHitFn), whose forward is the walk a scene already uses (K3, B1 or
// D1).  JAX differentiates its XLA watertight test (rs_pbrt_tpu/ops/
// intersect.py:61-130 intersect_tri) by reverse-mode AD at the hit
// triangle; here a lane runs that test's forward at its own triangle once
// more, then its reverse sweep by hand: t, b0 and b1 as functions of the
// ray's origin o and direction d (through the shear constants sx, sy, sz)
// and of the triangle's vertices.  A lane writes its grad_o and grad_d;
// where the caller asks for the vertices' gradient, it adds its three
// vertices' terms into grad_verts (T, 9) with atomics.  A lane whose tri
// is -1 gives zeros.  Each product and sum rounds alone (--fmad=false), in
// the order of the plain twin (hit_vjp_plain), so the per-lane outputs
// equal it bit for bit.
//
// What bounds it on the card: bytes.  A lane reads 40 bytes (o, d, tri,
// three upstream gradients) and 36 of its triangle's vertices, and writes
// 24; ~150 f32 operations.  With the vertices' gradient, 9 atomic adds a
// lane land on a few rows where many lanes hit one triangle.  What the
// design does about it: nothing yet; this is the first, simple form.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Args {
  const float* o;  // (n, 3)
  const float* d;  // (n, 3)
  const int* tri;  // (n,)
  const float* g_t;  // (n,)
  const float* g_b0;
  const float* g_b1;
  const float* tris;  // (T, cols): the vertices in columns 0..8
  int cols, n_tri;
  long long n;
  float* g_o;  // (n, 3)
  float* g_d;  // (n, 3)
  float* g_verts;  // (T, 9) or null
};

__global__ void __launch_bounds__(kThreads) hit_grad_kernel(const __grid_constant__ Args a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  float go[3] = {0.0f, 0.0f, 0.0f}, gd[3] = {0.0f, 0.0f, 0.0f};
  const int tri = a.tri[i];
  if (tri >= 0 && tri < a.n_tri) {
    const float o[3] = {a.o[3 * i], a.o[3 * i + 1], a.o[3 * i + 2]};
    const float d[3] = {a.d[3 * i], a.d[3 * i + 1], a.d[3 * i + 2]};
    const float g_t = a.g_t[i], g_b0 = a.g_b0[i], g_b1 = a.g_b1[i];
    // the permutation: kz the largest |d| (the first of equals), then x, y
    const float ax = fabsf(d[0]), ay = fabsf(d[1]), az = fabsf(d[2]);
    const int kz = (ax >= ay && ax >= az) ? 0 : (ay >= az ? 1 : 2);
    const int kx = kz == 2 ? 0 : kz + 1;
    const int ky = kx == 2 ? 0 : kx + 1;
    const float sz = 1.0f / d[kz];
    const float sx = -d[kx] * sz;
    const float sy = -d[ky] * sz;
    const float* p = a.tris + static_cast<long long>(tri) * a.cols;
    float q[3][3], x[3], y[3], zs[3];
    for (int v = 0; v < 3; ++v) {
      for (int k = 0; k < 3; ++k) q[v][k] = p[3 * v + k] - o[k];
      x[v] = q[v][kx] + sx * q[v][kz];
      y[v] = q[v][ky] + sy * q[v][kz];
      zs[v] = sz * q[v][kz];
    }
    const float e0 = x[1] * y[2] - y[1] * x[2];
    const float e1 = x[2] * y[0] - y[2] * x[0];
    const float e2 = x[0] * y[1] - y[0] * x[1];
    const float det = e0 + e1 + e2;
    const float ts = e0 * zs[0] + e1 * zs[1] + e2 * zs[2];
    const float inv = 1.0f / (det == 0.0f ? 1.0f : det);
    // b0 = e0 inv, b1 = e1 inv, t = ts inv
    const float g_inv = g_b0 * e0 + g_b1 * e1 + g_t * ts;
    const float g_det = det == 0.0f ? 0.0f : -(g_inv * inv) * inv;
    const float g_ts = g_t * inv;
    const float ge[3] = {g_b0 * inv + g_det + g_ts * zs[0], g_b1 * inv + g_det + g_ts * zs[1],
                         g_det + g_ts * zs[2]};
    const float e[3] = {e0, e1, e2};
    // e0 = x1 y2 - y1 x2, e1 = x2 y0 - y2 x0, e2 = x0 y1 - y0 x1
    const float gx[3] = {ge[2] * y[1] - ge[1] * y[2], ge[0] * y[2] - ge[2] * y[0],
                         ge[1] * y[0] - ge[0] * y[1]};
    const float gy[3] = {ge[1] * x[2] - ge[2] * x[1], ge[2] * x[0] - ge[0] * x[2],
                         ge[0] * x[1] - ge[1] * x[0]};
    float g_sx = 0.0f, g_sy = 0.0f, g_sz = 0.0f;
    for (int v = 0; v < 3; ++v) {
      const float gzs = g_ts * e[v];
      g_sz = g_sz + gzs * q[v][kz];
      g_sx = g_sx + gx[v] * q[v][kz];
      g_sy = g_sy + gy[v] * q[v][kz];
      float gq[3];
      gq[kx] = gx[v];
      gq[ky] = gy[v];
      gq[kz] = (sz * gzs + sx * gx[v]) + sy * gy[v];
      for (int k = 0; k < 3; ++k) go[k] = go[k] - gq[k];
      if (a.g_verts != nullptr)
        for (int k = 0; k < 3; ++k)
          atomicAdd(a.g_verts + 9LL * tri + 3 * v + k, gq[k]);
    }
    // sx = -d[kx] sz, sy = -d[ky] sz, sz = 1 / d[kz]
    gd[kx] = -(g_sx * sz);
    gd[ky] = -(g_sy * sz);
    const float g_sz_all = (g_sz - g_sx * d[kx]) - g_sy * d[ky];
    gd[kz] = -(g_sz_all * sz) * sz;
  }
  for (int k = 0; k < 3; ++k) {
    a.g_o[3 * i + k] = go[k];
    a.g_d[3 * i + k] = gd[k];
  }
}

}  // namespace

// o, d (n, 3), tri (n,) int32, g_t, g_b0, g_b1 (n,), tris (n_tri, cols)
// with the vertices in columns 0..8; out g_o, g_d (n, 3) and, where
// g_verts is not null, (n_tri, 9) zeroed by the caller and added into.
extern "C" int rs_hit_grad(const void* o, const void* d, const void* tri, const void* g_t,
                           const void* g_b0, const void* g_b1, const void* tris, int n_tri,
                           int cols, long long n, void* g_o, void* g_d, void* g_verts,
                           void* stream) {
  if (n < 0 || cols < 9 || n_tri < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Args a{};
  a.o = static_cast<const float*>(o);
  a.d = static_cast<const float*>(d);
  a.tri = static_cast<const int*>(tri);
  a.g_t = static_cast<const float*>(g_t);
  a.g_b0 = static_cast<const float*>(g_b0);
  a.g_b1 = static_cast<const float*>(g_b1);
  a.tris = static_cast<const float*>(tris);
  a.cols = cols;
  a.n_tri = n_tri;
  a.n = n;
  a.g_o = static_cast<float*>(g_o);
  a.g_d = static_cast<float*>(g_d);
  a.g_verts = static_cast<float*>(g_verts);
  const long long grid = (n + kThreads - 1) / kThreads;
  hit_grad_kernel<<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
