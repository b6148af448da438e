// C5: the curve hit's vector-Jacobian product in the ray, one thread a
// lane.
//
// The backward of the closest curve hit (C1 walk_closest and C3
// sweep_closest, curves.cu) in the ray's o and d, at each lane's winning
// segment.  JAX differentiates its XLA leaf test (rs_pbrt_tpu/ops/
// curves.py:240 curve_seg_test) by reverse-mode AD over every (ray,
// segment) pair of its sweep; here a lane re-runs the leaf test's forward
// (curve.cuh's terms) on its own segment and then the reverse sweep by
// hand, from the upstream gradients of t, u, v and w (the clamped local
// parameter) to o and d: t through the de Casteljau point's depth over the
// ray's length; v through the distance to the curve over the hit's width
// (a ribbon's scaled by its normal's cosine to the ray); u, and through it
// the width, through the closest approach along the chord, clipped to the
// segment; every control point's coordinates in the ray frame through the
// frame itself (the chord's cross product with d, normalized), and the
// frame's own fallback (coordinate_system's axis where d and the chord are
// parallel).  The tests (slab rejects, edge functions, width and depth)
// are discrete and give nothing; clips and clamps pass a gradient where
// torch's would (a clamp at its bound passes it, a clip at u0 or u1, 0 or
// 1 stops it).  A lane without a hit (seg < 0) gives zeros.  Built with
// --fmad=false; the twin (ops/curve_kernel.curve_vjp_plain) computes the
// same sweep term by term in plain PyTorch.
//
// What bounds it on the card: ~250 f32 operations of the forward and
// ~300 of the reverse a hit lane, against 24 bytes of ray and 16 of
// upstream gradient in, the segment's 104-byte row and 24 bytes out: the
// arithmetic.  What the design does about it: nothing yet; this is the
// first, simple form, one thread a lane, no shared memory (neighbouring
// lanes read the same few rows through the cache).
#include <cuda_runtime.h>

#include "curve.cuh"

namespace {

using curve::V3;

constexpr int kThreads = 128;

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }

// d|a|/da: 1 where a > 0, -1 where a < 0, 0 at 0 (torch.abs's)
__device__ __forceinline__ float sgn(float a) {
  return a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : 0.0f);
}

// g_a of a / ln, ln = max(sqrt(max(a.a, 1e-30)), 1e-20) (vecmath.normalize),
// given g_out at the unit vector
__device__ V3 normalize_vjp(V3 a, V3 g_out) {
  const float l2 = curve::clamp_min(curve::dot(a, a), 1e-30f);
  const float sq = sqrtf(l2);
  const float ln = curve::clamp_min(sq, 1e-20f);
  V3 g = scale(g_out, 1.0f / ln);
  if (sq >= 1e-20f && curve::dot(a, a) >= 1e-30f) {
    const float g_ln = -curve::dot(g_out, a) / (ln * ln);
    g = add(g, scale(a, g_ln / sq));
  }
  return g;
}

// The leaf test's VJP at one (ray, segment): g_t, g_u, g_v, g_w (the
// outputs t, u, v, w) -> g_o, g_d added into.
__device__ void seg_vjp(V3 o, V3 d, const float* row, float g_t, float g_u, float g_v, float g_w,
                        V3* g_o, V3* g_d) {
  const V3 cp[4] = {{row[0], row[1], row[2]},
                    {row[3], row[4], row[5]},
                    {row[6], row[7], row[8]},
                    {row[9], row[10], row[11]}};
  const float w0 = row[12], w1 = row[13], u0 = row[14], u1 = row[15];
  const V3 n0 = {row[16], row[17], row[18]}, n1 = {row[19], row[20], row[21]};
  const float norm_angle = row[22], inv_sin_na = row[23], ctype = row[24];

  // forward (curve::seg_test's terms)
  const V3 ez = curve::normalize(d);
  const float length = sqrtf(curve::clamp_min(curve::dot(d, d), 1e-30f));
  const V3 chord = curve::sub(cp[3], cp[0]);
  V3 up = curve::cross(d, chord);
  const bool degen = curve::dot(up, up) < 1e-18f;
  const bool use_a = fabsf(ez.x) > fabsf(ez.y);
  const float sa = curve::clamp_min(ez.x * ez.x + ez.z * ez.z, 1e-20f);
  const float sb = curve::clamp_min(ez.y * ez.y + ez.z * ez.z, 1e-20f);
  const float inv_a = 1.0f / sqrtf(sa), inv_b = 1.0f / sqrtf(sb);
  if (degen)
    up = use_a ? V3{-ez.z * inv_a, 0.0f, ez.x * inv_a} : V3{0.0f, ez.z * inv_b, -ez.y * inv_b};
  const V3 cu = curve::cross(up, ez);
  const V3 ex = curve::normalize(cu);
  const V3 ey = curve::cross(ez, ex);
  V3 r[4], q[4];
  for (int i = 0; i < 4; ++i) {
    r[i] = curve::sub(cp[i], o);
    q[i] = {curve::dot(r[i], ex), curve::dot(r[i], ey), curve::dot(r[i], ez)};
  }
  const float sdx = q[3].x - q[0].x, sdy = q[3].y - q[0].y;
  const float denom = sdx * sdx + sdy * sdy;
  const float den_c = curve::clamp_min(denom, 1e-20f);
  const float w = ((-q[0].x) * sdx + (-q[0].y) * sdy) / den_c;
  const float lu = curve::lerp(w, u0, u1);
  const float u = curve::tmin(curve::tmax(lu, u0), u1);
  const float span = (u1 == u0) ? 1.0f : u1 - u0;
  const float lw = (u - u0) / span;
  const float hw0 = curve::lerp(lw, w0, w1);
  const bool straight = norm_angle < 1e-6f;
  const float s0 = straight ? 1.0f - lw : sinf((1.0f - lw) * norm_angle) * inv_sin_na;
  const float s1 = straight ? lw : sinf(lw * norm_angle) * inv_sin_na;
  const V3 n_hit = {s0 * n0.x + s1 * n1.x, s0 * n0.y + s1 * n1.y, s0 * n0.z + s1 * n1.z};
  const float nd = curve::dot(n_hit, d);
  const float len_c = curve::clamp_min(length, 1e-20f);
  const float rs = fabsf(nd) / len_c;
  const bool ribbon = ctype == static_cast<float>(curve::kRibbon);
  const float hw = ribbon ? hw0 * rs : hw0;
  const float wc = curve::tmin(curve::tmax(w, 0.0f), 1.0f);
  const V3 a0 = curve::lerp3(wc, q[0], q[1]), a1 = curve::lerp3(wc, q[1], q[2]),
           a2 = curve::lerp3(wc, q[2], q[3]);
  const V3 b0 = curve::lerp3(wc, a0, a1), b1 = curve::lerp3(wc, a1, a2);
  const V3 pc = curve::lerp3(wc, b0, b1);
  V3 dp = {3.0f * (b1.x - b0.x), 3.0f * (b1.y - b0.y), 3.0f * (b1.z - b0.z)};
  const V3 dpdw = dp;  // the point's derivative in wc
  if (curve::dot(dp, dp) < 1e-14f) dp = curve::sub(q[3], q[0]);
  const float dist2 = pc.x * pc.x + pc.y * pc.y;
  const float dist = sqrtf(curve::clamp_min(dist2, 0.0f));
  const float edge_func = dp.x * (-pc.y) + pc.x * dp.y;
  const float hw_c = curve::clamp_min(hw, 1e-20f);
  const float ratio = dist / hw_c;
  const float t = pc.z / len_c;

  // reverse
  V3 g_pc = {0.0f, 0.0f, g_t / len_c};
  float g_len_c = -g_t * t / len_c;
  const float g_ratio = edge_func > 0.0f ? g_v : -g_v;
  const float g_dist = g_ratio / hw_c;
  float g_hw = hw >= 1e-20f ? -g_ratio * ratio / hw_c : 0.0f;
  const float g_dist2 = dist2 > 0.0f ? g_dist * 0.5f / dist : 0.0f;
  g_pc.x += 2.0f * pc.x * g_dist2;
  g_pc.y += 2.0f * pc.y * g_dist2;
  // pc = the Bernstein sum of q at wc
  float g_wc = g_w + curve::dot(g_pc, dpdw);
  const float iw = 1.0f - wc;
  const float bern[4] = {iw * iw * iw, 3.0f * wc * iw * iw, 3.0f * wc * wc * iw, wc * wc * wc};
  V3 g_q[4];
  for (int i = 0; i < 4; ++i) g_q[i] = scale(g_pc, bern[i]);
  float g_wr = (w > 0.0f && w < 1.0f) ? g_wc : 0.0f;
  // the width: a ribbon's hw0 rs, rs = |n_hit . d| / len_c
  const float g_hw0 = ribbon ? g_hw * rs : g_hw;
  const float g_rs = ribbon ? g_hw * hw0 : 0.0f;
  const float g_nd = g_rs * sgn(nd) / len_c;
  g_len_c += -g_rs * rs / len_c;
  V3 gd = scale(n_hit, g_nd);
  const V3 g_nhit = scale(d, g_nd);
  const float g_s0 = curve::dot(g_nhit, n0), g_s1 = curve::dot(g_nhit, n1);
  float g_lw = g_hw0 * (w1 - w0);
  if (straight) {
    g_lw += g_s1 - g_s0;
  } else {
    g_lw += -g_s0 * cosf((1.0f - lw) * norm_angle) * norm_angle * inv_sin_na +
            g_s1 * cosf(lw * norm_angle) * norm_angle * inv_sin_na;
  }
  const float g_uu = g_u + g_lw / span;
  const float g_lu = (lu > u0 && lu < u1) ? g_uu : 0.0f;
  g_wr += g_lu * (u1 - u0);
  // w = num / den_c
  const float g_num = g_wr / den_c;
  const float g_den = denom >= 1e-20f ? -g_wr * w / den_c : 0.0f;
  const float g_sdx = -q[0].x * g_num + 2.0f * sdx * g_den;
  const float g_sdy = -q[0].y * g_num + 2.0f * sdy * g_den;
  g_q[0].x += -sdx * g_num - g_sdx;
  g_q[0].y += -sdy * g_num - g_sdy;
  g_q[3].x += g_sdx;
  g_q[3].y += g_sdy;
  // q_i = (r_i . ex, r_i . ey, r_i . ez), r_i = cp_i - o
  V3 g_ex = {0.0f, 0.0f, 0.0f}, g_ey = {0.0f, 0.0f, 0.0f}, g_ez = {0.0f, 0.0f, 0.0f};
  V3 go = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < 4; ++i) {
    const V3 g_r = add(add(scale(ex, g_q[i].x), scale(ey, g_q[i].y)), scale(ez, g_q[i].z));
    go = curve::sub(go, g_r);
    g_ex = add(g_ex, scale(r[i], g_q[i].x));
    g_ey = add(g_ey, scale(r[i], g_q[i].y));
    g_ez = add(g_ez, scale(r[i], g_q[i].z));
  }
  // ey = ez x ex
  g_ez = add(g_ez, curve::cross(ex, g_ey));
  g_ex = add(g_ex, curve::cross(g_ey, ez));
  // ex = normalize(cu), cu = up x ez
  const V3 g_cu = normalize_vjp(cu, g_ex);
  const V3 g_up = curve::cross(ez, g_cu);
  g_ez = add(g_ez, curve::cross(g_cu, up));
  if (!degen) {
    gd = add(gd, curve::cross(chord, g_up));  // up = d x chord
  } else if (use_a) {  // up = (-ez.z, 0, ez.x) / sqrt(ez.x^2 + ez.z^2)
    const float g_inv = -g_up.x * ez.z + g_up.z * ez.x;
    const float g_s = ez.x * ez.x + ez.z * ez.z >= 1e-20f
                          ? -0.5f * inv_a * inv_a * inv_a * g_inv : 0.0f;
    g_ez.x += g_up.z * inv_a + 2.0f * ez.x * g_s;
    g_ez.z += -g_up.x * inv_a + 2.0f * ez.z * g_s;
  } else {  // up = (0, ez.z, -ez.y) / sqrt(ez.y^2 + ez.z^2)
    const float g_inv = g_up.y * ez.z - g_up.z * ez.y;
    const float g_s = ez.y * ez.y + ez.z * ez.z >= 1e-20f
                          ? -0.5f * inv_b * inv_b * inv_b * g_inv : 0.0f;
    g_ez.y += -g_up.z * inv_b + 2.0f * ez.y * g_s;
    g_ez.z += g_up.y * inv_b + 2.0f * ez.z * g_s;
  }
  // ez = normalize(d); length = sqrt(max(d . d, 1e-30)), len_c its clamp
  gd = add(gd, normalize_vjp(d, g_ez));
  if (length >= 1e-20f && curve::dot(d, d) >= 1e-30f) gd = add(gd, scale(d, g_len_c / length));
  *g_o = add(*g_o, go);
  *g_d = add(*g_d, gd);
}

struct Args {
  const float* o;  // (n, 3)
  const float* d;
  const int* seg;  // (n,), < 0: no hit
  const float* rows;  // (S, 26)
  const float* g_t;  // (n,) each
  const float* g_u;
  const float* g_v;
  const float* g_w;
  int n, n_rows;
  float* g_o;  // (n, 3)
  float* g_d;
};

__global__ void __launch_bounds__(kThreads) curve_grad_kernel(Args a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  V3 go = {0.0f, 0.0f, 0.0f}, gd = {0.0f, 0.0f, 0.0f};
  const int s = a.seg[i];
  if (s >= 0 && s < a.n_rows) {
    const V3 o = {a.o[3 * i], a.o[3 * i + 1], a.o[3 * i + 2]};
    const V3 d = {a.d[3 * i], a.d[3 * i + 1], a.d[3 * i + 2]};
    seg_vjp(o, d, a.rows + static_cast<long long>(s) * curve::kRowCols, a.g_t[i], a.g_u[i],
            a.g_v[i], a.g_w[i], &go, &gd);
  }
  a.g_o[3 * i] = go.x;
  a.g_o[3 * i + 1] = go.y;
  a.g_o[3 * i + 2] = go.z;
  a.g_d[3 * i] = gd.x;
  a.g_d[3 * i + 1] = gd.y;
  a.g_d[3 * i + 2] = gd.z;
}

}  // namespace

// o, d (n, 3), seg (n,) int32 (the winning segment row, < 0 where the ray
// hit none), rows (n_rows, 26), the upstream gradients of t, u, v, w (n,);
// out g_o, g_d (n, 3), every entry written.
extern "C" int rs_curve_grad(const void* o, const void* d, const void* seg, const void* rows,
                             int n_rows, const void* g_t, const void* g_u, const void* g_v,
                             const void* g_w, int n, void* g_o, void* g_d, void* stream) {
  if (n == 0) return 0;
  Args a{static_cast<const float*>(o),   static_cast<const float*>(d),
         static_cast<const int*>(seg),   static_cast<const float*>(rows),
         static_cast<const float*>(g_t), static_cast<const float*>(g_u),
         static_cast<const float*>(g_v), static_cast<const float*>(g_w),
         n,                              n_rows,
         static_cast<float*>(g_o),       static_cast<float*>(g_d)};
  const int blocks = (n + kThreads - 1) / kThreads;
  curve_grad_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
