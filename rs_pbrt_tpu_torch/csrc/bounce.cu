// K2: one whole path-tracer bounce per launch, one thread per lane.
//
// Replaces rs_pbrt_tpu/ops/pallas_path.py:_bounce_kernel (launched by
// _bounce_call, driven by mega_radiance).  For an all-matte, triangle-only
// scene lit by triangle-range area lights it runs the steps of
// _bounce_kernel in the same order, with the same guards and epsilons:
// closest hit, hit record, emitted light with MIS, the bounce's 7 Sobol'
// dims, light pick by power, area sample of one of the light's triangles,
// shadow any-hit, Lambert NEE, cosine sample, Russian roulette.  The last
// launch of a path only adds emission (emit_only).
//
// Lane state is structure-of-arrays: 13 f32 rows of N (o, d, beta, L,
// prev_pdf; ops/path_kernel.LANE_ROWS) and an int32 alive row; each row is
// read and written once per launch, coalesced.
//
// What bounds it on the card: arithmetic.  Per live lane a bounce runs a
// closest-hit sweep over every triangle (~65 f32 operations per
// ray-triangle test), a shadow sweep up to the first occluder (~60 per
// test) where the light sample can contribute, and ~400 operations of
// shading, against 56 bytes of lane state in and out, so on the first
// bounces the f32 issue rate, not memory, is the limit (chip_smoke.py
// counts both per launch); divergence between lanes that miss, die or
// skip the shadow ray costs issue slots too.
//
// What the design does about it, for now a simple kernel that is right:
// - The triangle table (tri_attr, 32 f32 a row) stays in device memory and
//   is read through the read-only cache.  Every thread of a warp reads the
//   same row at the same step of a sweep, so each read is a broadcast.
//   Shared memory could not hold the largest eligible scene (2048 rows x
//   128 B = 262 KB > 227 KB a block may use); the Cornell box's 32 rows
//   (4 KB) stay in L1.
// - The TPU's select-accumulate loops become direct reads: the hit record
//   is row bi of the table, the light and material rows are indexed by id,
//   the light's triangle is row start+off.  The CDF searches stay as
//   comparison counts (the same index as the TPU's).
// - Dead and missing lanes skip the work; the shadow sweep runs only where
//   its result is used, and stops at the first occluder.
// - The 7 rows of Sobol' direction numbers of this bounce sit in shared
//   memory and go through K1's device function (sobol.cuh).
// - The hit record is record.cuh's, shared with K5 (intersect.cu).
// - Built with --fmad=false and without fast math, so the arithmetic is the
//   plain PyTorch version's (ops/path_kernel.bounce_plain), term by term.
#include <cuda_runtime.h>

#include <cstdint>

#include "record.cuh"
#include "sobol.cuh"
#include "watertight.cuh"

namespace {

using namespace rs;  // V3 and its helpers, the hit record, the table columns

constexpr int kDims = 7;  // Sobol' dims per bounce
// table widths and columns (scene/arrays.py)
constexpr int kMatCols = 37, kLightCols = 22;
constexpr int kLpI = 3, kLpTwoSided = 12, kLpArea = 13, kLaTriStart = 19, kLaTriEnd = 20;
constexpr int kMaKd = 1;  // MA_PARAMS + MP_KD
constexpr float kPi = 0x1.921fb6p+1f;
constexpr float kInvPi = 0x1.45f306p-2f;

__device__ __forceinline__ float next_float_up(float x) {
  if (isinf(x) && x > 0.0f) return x;
  if (x == 0.0f) return __int_as_float(1);
  const int xi = __float_as_int(x);
  return __int_as_float(x >= 0.0f ? xi + 1 : xi - 1);
}

__device__ __forceinline__ float next_float_down(float x) {
  if (isinf(x) && x < 0.0f) return x;
  if (x == 0.0f) return -__int_as_float(1);
  const int xi = __float_as_int(x);
  return __int_as_float(x > 0.0f ? xi - 1 : xi + 1);
}

__device__ __forceinline__ float offset_coord(float p, float off) {
  const float po = p + off;
  return off > 0.0f ? next_float_up(po) : (off < 0.0f ? next_float_down(po) : po);
}

// vecmath.offset_ray_origin (interaction.rs:62-95)
__device__ __forceinline__ V3 offset_ray_origin(V3 p, V3 p_err, V3 n, V3 w) {
  const float d = fabsf(n.x) * p_err.x + fabsf(n.y) * p_err.y + fabsf(n.z) * p_err.z;
  const bool flip = dot(w, n) < 0.0f;
  const float s = flip ? -d : d;
  return {offset_coord(p.x, s * n.x), offset_coord(p.y, s * n.y), offset_coord(p.z, s * n.z)};
}

__device__ __forceinline__ float power_heuristic(float f, float g) {
  const float denom = f * f + g * g;
  return denom > 0.0f ? (f * f) / fmaxf(denom, 1e-30f) : 0.0f;
}

__device__ __forceinline__ void concentric_disk(float u0, float u1, float& dx, float& dy) {
  const float ox = 2.0f * u0 - 1.0f;
  const float oy = 2.0f * u1 - 1.0f;
  if (ox == 0.0f && oy == 0.0f) {
    dx = 0.0f;
    dy = 0.0f;
    return;
  }
  const bool use_x = fabsf(ox) > fabsf(oy);
  const float r = use_x ? ox : oy;
  const float safe_ox = ox == 0.0f ? 1.0f : ox;
  const float safe_oy = oy == 0.0f ? 1.0f : oy;
  const float theta = use_x ? (kPi / 4.0f) * (oy / safe_ox)
                            : (kPi / 2.0f) - (kPi / 4.0f) * (ox / safe_oy);
  dx = r * cosf(theta);
  dy = r * sinf(theta);
}

struct Args {
  const float* lanes_in;
  const int* alive_in;
  const int64_t* index;
  float* lanes_out;
  int* alive_out;
  int n;
  const float* tris;
  int n_tri;
  const float* lattr;
  int n_lights;
  const float* lsel;  // (2, n_lights + 1)
  const float* ltricdf;  // (n_lights, a_cols)
  int a_cols;
  const float* mattr;
  int n_mats;
  const uint32_t* mats;  // (1024, 52) Sobol' direction numbers
  int dim_row;
  int n_bits;
  int first_bounce, rr_active, emit_only;
  float rr_threshold;
};

__global__ void __launch_bounds__(128) bounce_kernel(Args a) {
  __shared__ uint32_t smats[kDims * RS_SOBOL_MATRIX_SIZE];
  if (!a.emit_only)
    for (int j = threadIdx.x; j < kDims * RS_SOBOL_MATRIX_SIZE; j += blockDim.x)
      smats[j] = a.mats[a.dim_row * RS_SOBOL_MATRIX_SIZE + j];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const size_t N = a.n;
  const float* in = a.lanes_in;
  V3 o = {in[0 * N + i], in[1 * N + i], in[2 * N + i]};
  V3 d = {in[3 * N + i], in[4 * N + i], in[5 * N + i]};
  float beta[3] = {in[6 * N + i], in[7 * N + i], in[8 * N + i]};
  float L[3] = {in[9 * N + i], in[10 * N + i], in[11 * N + i]};
  float prev_pdf = in[12 * N + i];
  bool alive = a.alive_in[i] != 0;

  while (alive) {  // runs once; `break` ends the lane's work
    // ---- closest hit ----
    const rs::RayConst rc = rs::ray_constants(o.x, o.y, o.z, d.x, d.y, d.z);
    float bt, b0, b1;
    const int bi = closest_hit(rc, a.tris, a.n_tri, kTriCols, kNoHit, bt, b0, b1);
    if (bi < 0) {  // miss: the path ends, nothing is added
      alive = false;
      break;
    }

    // ---- hit record: row bi (scene_intersect._tri_interaction) ----
    const TriRecord rec = tri_record<false>(a.tris + static_cast<size_t>(bi) * kTriCols, b0, b1);
    const V3 p = rec.p, p_err = rec.p_err, ng = rec.ng, ns = rec.ns, dpdu = rec.dpdu;
    const int mat = rec.mat, light = rec.light;
    const V3 wo = scale(normalize(d, 1e-20f), -1.0f);

    // ---- emitted light at the hit, MIS against the previous bsdf pdf ----
    float le[3] = {0.0f, 0.0f, 0.0f}, area_h = 0.0f, two_h = 0.0f, selpdf_h = 0.0f;
    if (light >= 0 && light < a.n_lights) {
      const float* lr = a.lattr + static_cast<size_t>(light) * kLightCols;
      le[0] = __ldg(lr + kLpI);
      le[1] = __ldg(lr + kLpI + 1);
      le[2] = __ldg(lr + kLpI + 2);
      area_h = __ldg(lr + kLpArea);
      two_h = __ldg(lr + kLpTwoSided);
      selpdf_h = __ldg(a.lsel + (a.n_lights + 1) + light);
    }
    const bool le_on = ((two_h > 0.5f) || (dot(ns, wo) > 0.0f)) && (light >= 0);
    const V3 to_hit = sub(p, o);
    const float d2h = fmaxf(dot(to_hit, to_hit), 1e-12f);
    const float inv_dist_h = 1.0f / sqrtf(d2h);
    const float cos_lh = fabsf(dot(ns, to_hit)) * inv_dist_h;
    float area_pdf = d2h / fmaxf(cos_lh * fmaxf(area_h, 1e-12f), 1e-12f);
    if (cos_lh < 1e-7f) area_pdf = 0.0f;
    const float light_pdf = selpdf_h * area_pdf;
    const float w_bsdf = a.first_bounce ? 1.0f : power_heuristic(prev_pdf, light_pdf);
    const float gain = le_on ? w_bsdf : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) L[k] = L[k] + beta[k] * le[k] * gain;
    if (a.emit_only) break;

    // ---- BSDF frame: ss along dpdu (path._shading_frame_du) ----
    V3 ss = sub(dpdu, scale(ns, dot(ns, dpdu)));
    ss = dot(ss, ss) < 1e-14f ? coordinate_system(ns) : normalize(ss, 1e-20f);
    const V3 ts = cross(ns, ss);
    const V3 wo_l = {dot(wo, ss), dot(wo, ts), dot(wo, ns)};

    // ---- matte lambertian ----
    float kd[3] = {0.0f, 0.0f, 0.0f};
    if (mat >= 0 && mat < a.n_mats) {
      const float* mr = a.mattr + static_cast<size_t>(mat) * kMatCols + kMaKd;
      kd[0] = __ldg(mr);
      kd[1] = __ldg(mr + 1);
      kd[2] = __ldg(mr + 2);
    }
    const bool kd_black = kd[0] == 0.0f && kd[1] == 0.0f && kd[2] == 0.0f;

    // ---- this bounce's 7 Sobol' dims ----
    uint32_t sv[kDims];
    rs_sobol_accumulate<kDims>(smats, static_cast<uint64_t>(a.index[i]), a.n_bits, kDims, sv);
    float dims[kDims];
#pragma unroll
    for (int k = 0; k < kDims; ++k) dims[k] = rs_u32_to_unit_float(sv[k]);

    // ---- NEE: pick a light by power (comparison-count CDF search) ----
    int cnt = 0;
    for (int j = 0; j <= a.n_lights; ++j) cnt += __ldg(a.lsel + j) <= dims[0];
    const int li = min(max(cnt - 1, 0), a.n_lights - 1);
    const float sel_pdf = __ldg(a.lsel + (a.n_lights + 1) + li);

    // area-sample a triangle of that light (lights._area_sample_tri)
    const float ul0 = dims[1], ul1 = dims[2];
    const float* cdf = a.ltricdf + static_cast<size_t>(li) * a.a_cols;
    int cnt_t = 0;
    for (int j = 0; j < a.a_cols; ++j) cnt_t += __ldg(cdf + j) <= ul0;
    const int off = min(max(cnt_t - 1, 0), a.a_cols - 2);
    const float c0 = __ldg(cdf + off), c1 = __ldg(cdf + off + 1);
    const float* lrow = a.lattr + static_cast<size_t>(li) * kLightCols;
    const float larea = __ldg(lrow + kLpArea), ltwo = __ldg(lrow + kLpTwoSided);
    const float lint[3] = {__ldg(lrow + kLpI), __ldg(lrow + kLpI + 1), __ldg(lrow + kLpI + 2)};
    const int start = __float2int_rn(__ldg(lrow + kLaTriStart));
    const int count = __float2int_rn(__ldg(lrow + kLaTriEnd)) - start;
    V3 lp0 = {0, 0, 0}, lp1 = {0, 0, 0}, lp2 = {0, 0, 0};
    V3 ln0 = {0, 0, 0}, ln1 = {0, 0, 0}, ln2 = {0, 0, 0};
    float lhasn = 0.0f, lrev = 0.0f;
    if (off < count) {
      const float* tr = a.tris + static_cast<size_t>(start + off) * kTriCols;
      lp0 = load3(tr + 0);
      lp1 = load3(tr + 3);
      lp2 = load3(tr + 6);
      ln0 = load3(tr + 9);
      ln1 = load3(tr + 12);
      ln2 = load3(tr + 15);
      lhasn = __ldg(tr + kTaHasN);
      lrev = __ldg(tr + kTaReverse);
    }
    const float u_remap = fminf(fmaxf((ul0 - c0) / fmaxf(c1 - c0, 1e-12f), 0.0f), 0.99999988f);
    const float su0 = sqrtf(u_remap);
    const float lb0 = 1.0f - su0;
    const float lb1 = ul1 * su0;
    const float lb2 = 1.0f - lb0 - lb1;
    const V3 p_l = {lb0 * lp0.x + lb1 * lp1.x + lb2 * lp2.x, lb0 * lp0.y + lb1 * lp1.y + lb2 * lp2.y,
                    lb0 * lp0.z + lb1 * lp1.z + lb2 * lp2.z};
    V3 ng_l = normalize(cross(sub(lp1, lp0), sub(lp2, lp0)), 1e-30f);
    const V3 ns_l = {lb0 * ln0.x + lb1 * ln1.x + lb2 * ln2.x, lb0 * ln0.y + lb1 * ln1.y + lb2 * ln2.y,
                     lb0 * ln0.z + lb1 * ln1.z + lb2 * ln2.z};
    if (lhasn > 0.5f && dot(ng_l, ns_l) < 0.0f) ng_l = scale(ng_l, -1.0f);
    if (lrev > 0.5f) ng_l = scale(ng_l, -1.0f);
    const V3 to_a = sub(p_l, p);
    const float d2a = fmaxf(dot(to_a, to_a), 1e-12f);
    const float inv_da = 1.0f / sqrtf(d2a);
    const V3 wi_l3 = scale(to_a, inv_da);
    const float cos_l = dot(ng_l, scale(wi_l3, -1.0f));
    const bool emits_l = (ltwo > 0.5f) || (cos_l > 0.0f);
    const float li_rgb[3] = {emits_l ? lint[0] : 0.0f, emits_l ? lint[1] : 0.0f,
                             emits_l ? lint[2] : 0.0f};
    float ls_pdf = d2a / fmaxf(fabsf(cos_l) * fmaxf(larea, 1e-12f), 1e-12f);
    if (fabsf(cos_l) < 1e-7f) ls_pdf = 0.0f;

    // f * |cos| and the scattering pdf toward the light
    const float wi_lz = dot(wi_l3, ns);
    const bool reflect = dot(wi_l3, ng) * dot(wo, ng) > 0.0f;
    const bool same_h = wi_lz * wo_l.z > 0.0f;
    const float abs_ci = fabsf(wi_lz);
    const float f_w = (reflect && same_h && !kd_black) ? kInvPi * abs_ci : 0.0f;
    const float scat_pdf = (same_h && !kd_black) ? abs_ci * kInvPi : 0.0f;
    const bool contrib_ok = !kd_black && (ls_pdf > 0.0f) &&
                            (li_rgb[0] > 0.0f || li_rgb[1] > 0.0f || li_rgb[2] > 0.0f) &&
                            (f_w > 0.0f);
    if (contrib_ok) {
      // shadow ray, any hit up to just short of the light point
      const V3 p_sh = offset_ray_origin(p, p_err, ng, wi_l3);
      const V3 delta_sh = sub(p_l, p_sh);
      const float dist_sh = sqrtf(dot(delta_sh, delta_sh));
      const V3 sh_d = scale(delta_sh, 1.0f / fmaxf(dist_sh, 1e-12f));
      const float t_lim = dist_sh * 0.999f;
      const rs::RayConst rs_ = rs::ray_constants(p_sh.x, p_sh.y, p_sh.z, sh_d.x, sh_d.y, sh_d.z);
      const bool occluded = any_hit(rs_, a.tris, a.n_tri, kTriCols, t_lim);
      if (!occluded) {
        const float w_light = power_heuristic(ls_pdf, scat_pdf);
        const float inv_pdf = w_light / fmaxf(ls_pdf * sel_pdf, 1e-12f);
        const float nee_gain = f_w * inv_pdf;
#pragma unroll
        for (int k = 0; k < 3; ++k) L[k] = L[k] + beta[k] * kd[k] * li_rgb[k] * nee_gain;
      }
    }

    // ---- BSDF sample: cosine hemisphere ----
    float dxs, dys;
    concentric_disk(dims[3], dims[4], dxs, dys);
    const float z = sqrtf(fmaxf(0.0f, 1.0f - dxs * dxs - dys * dys));
    const float sgn = (wo_l.z == 0.0f ? 1.0f : wo_l.z) > 0.0f ? 1.0f : -1.0f;
    const V3 wi_s = normalize(V3{dxs * sgn, dys * sgn, z * sgn}, 1e-20f);
    const bool same_h_s = wi_s.z * wo_l.z > 0.0f;
    const float pdf_s = (kd_black || !same_h_s) ? 0.0f : fabsf(wi_s.z) * kInvPi;
    if (!(pdf_s > 0.0f) || kd_black) {  // no continuation: the path ends here
      alive = false;
      break;
    }
    const V3 wi_w = {wi_s.x * ss.x + wi_s.y * ts.x + wi_s.z * ns.x,
                     wi_s.x * ss.y + wi_s.y * ts.y + wi_s.z * ns.y,
                     wi_s.x * ss.z + wi_s.y * ts.z + wi_s.z * ns.z};
    const float cos_wi = fabsf(dot(wi_w, ns));
    const float scale_b = kInvPi * cos_wi / fmaxf(pdf_s, 1e-12f);
#pragma unroll
    for (int k = 0; k < 3; ++k) beta[k] = beta[k] * kd[k] * scale_b;
    prev_pdf = pdf_s;
    o = offset_ray_origin(p, p_err, ng, wi_w);
    d = wi_w;

    // ---- Russian roulette (path.rs:253-262) ----
    if (a.rr_active) {
      const float rr_max = fmaxf(fmaxf(beta[0], beta[1]), beta[2]);
      const float q = fmaxf(0.05f, 1.0f - rr_max);
      if (rr_max < a.rr_threshold) {
        if (dims[6] < q) {
          alive = false;
        } else {
          const float inv_keep = 1.0f / fmaxf(1.0f - q, 1e-6f);
#pragma unroll
          for (int k = 0; k < 3; ++k) beta[k] = beta[k] * inv_keep;
        }
      }
    }
    break;
  }

  float* out = a.lanes_out;
  out[0 * N + i] = o.x;
  out[1 * N + i] = o.y;
  out[2 * N + i] = o.z;
  out[3 * N + i] = d.x;
  out[4 * N + i] = d.y;
  out[5 * N + i] = d.z;
  out[6 * N + i] = beta[0];
  out[7 * N + i] = beta[1];
  out[8 * N + i] = beta[2];
  out[9 * N + i] = L[0];
  out[10 * N + i] = L[1];
  out[11 * N + i] = L[2];
  out[12 * N + i] = prev_pdf;
  a.alive_out[i] = alive ? 1 : 0;
}

}  // namespace

extern "C" int rs_bounce(const void* lanes_in, const void* alive_in, const void* index,
                         void* lanes_out, void* alive_out, int n, const void* tris, int n_tri,
                         const void* lattr, int n_lights, const void* lsel, const void* ltricdf,
                         int a_cols, const void* mattr, int n_mats, const void* mats, int dim_row,
                         int n_bits, int first_bounce, int rr_active, int emit_only,
                         float rr_threshold, void* stream) {
  if (n == 0) return 0;
  Args a;
  a.lanes_in = static_cast<const float*>(lanes_in);
  a.alive_in = static_cast<const int*>(alive_in);
  a.index = static_cast<const int64_t*>(index);
  a.lanes_out = static_cast<float*>(lanes_out);
  a.alive_out = static_cast<int*>(alive_out);
  a.n = n;
  a.tris = static_cast<const float*>(tris);
  a.n_tri = n_tri;
  a.lattr = static_cast<const float*>(lattr);
  a.n_lights = n_lights;
  a.lsel = static_cast<const float*>(lsel);
  a.ltricdf = static_cast<const float*>(ltricdf);
  a.a_cols = a_cols;
  a.mattr = static_cast<const float*>(mattr);
  a.n_mats = n_mats;
  a.mats = static_cast<const uint32_t*>(mats);
  a.dim_row = dim_row;
  a.n_bits = n_bits;
  a.first_bounce = first_bounce;
  a.rr_active = rr_active;
  a.emit_only = emit_only;
  a.rr_threshold = rr_threshold;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  bounce_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
