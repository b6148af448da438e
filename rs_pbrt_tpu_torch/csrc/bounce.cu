// K2: one whole path-tracer bounce per launch, over the live lanes only.
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
// prev_pdf; ops/path_kernel.LANE_ROWS) and an int32 alive row, updated in
// place.  A dead lane costs its 4-byte alive read; each live lane's rows are
// read once and written once.
//
// What bounds it on the card: arithmetic, where most lanes are live.  Per
// live lane a bounce runs a closest-hit sweep over every triangle (~65 f32
// operations per ray-triangle test), a shadow sweep up to the first
// occluder (~60 per test) where the light sample can contribute, and ~400
// operations of shading, against 108 bytes of lane state in and out
// (chip_smoke.py counts both per launch).  Once most lanes are dead, the
// alive row of every lane is the least it must read.
//
// What the design does about it:
// - Each block takes a tile of lanes, reads their alive flags and
//   packs the live lane ids into shared memory (ballot and popcount prefix
//   sums).  Its warps then take the packed ids 32 at a time from a shared
//   counter, so they run full of live lanes and none waits for another.  A
//   dead lane idled inside its warp in the one-thread-per-lane kernel,
//   while the warp's live lanes ran the whole sweep.  The tile is 1,024
//   lanes, or fewer where a launch has too few lanes to fill the card's
//   block slots twice.
// - The lanes whose NEE sample can contribute put their shadow ray in
//   their warp's queue in shared memory; whenever it holds 32, the warp
//   runs their any-hit sweeps, one a lane, and adds the NEE term of each
//   unoccluded ray (the rest at the end).  The NEE term is computed before
//   the queue from values the sweep does not change, and L gets it in the
//   same single addition, so the bits are those of the one-pass bounce.
// - The vertices of each triangle row sit in shared memory, 48 bytes a
//   triangle (the TPU kernel's VMEM-resident table), for a table small
//   enough (path_kernel.SHARED_TABLE_MAX_TRIS) that the copy leaves the SM
//   its 6 blocks; a larger table is read from device memory through L1.
//   Where all vertices are finite the sweeps pick the sheared components by
//   index (watertight.cuh's SweepRay).  The hit record reads row bi of the full table
//   from device memory.
// - 128-thread blocks at most 85 registers a thread, so an SM holds 24
//   warps.
// - The light and material rows are indexed by id where the TPU needed
//   select-accumulate loops; the CDF searches stay comparison counts.
// - The 7 rows of Sobol' direction numbers of this bounce sit in shared
//   memory and go through K1's device function (sobol.cuh); the hit record
//   is record.cuh's, shared with K5 (intersect.cu).
// - Each lane's result depends on its own inputs only, not on which thread
//   computes it: built with --fmad=false and without fast math, the
//   arithmetic is the plain PyTorch version's (ops/path_kernel.bounce_plain)
//   term by term, but for the index-picked shear, which differs from it at
//   most in the sign of a zero.
#include <cuda_runtime.h>

#include <cstdint>

#include "record.cuh"
#include "sobol.cuh"
#include "watertight.cuh"

namespace {

using namespace rs;  // V3 and its helpers, the hit record, the table columns

constexpr int kThreads = 128;  // 4 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 6;  // blocks an SM holds: 24 warps, at most 85 registers a thread
constexpr int kTile = 1024;  // the most lanes a block takes
constexpr int kWaves = 2;  // a launch's blocks fill the card's block slots at least this often
constexpr int kPerThread = kTile / kThreads;
static_assert(kPerThread * kWarps == 32, "one warp scans the tile's warp counts");
constexpr int kQueueCap = 64;  // a warp's shadow rays: it sweeps 32 whenever it holds 32
constexpr int kDims = 7;  // Sobol' dims per bounce
// table widths and columns (scene/arrays.py)
constexpr int kMatCols = 37, kLightCols = 22;
constexpr int kLpI = 3, kLpTwoSided = 12, kLpArea = 13, kLaTriStart = 19, kLaTriEnd = 20;
constexpr int kMaKd = 1;  // MA_PARAMS + MP_KD
constexpr float kPi = 0x1.921fb6p+1f;
constexpr float kInvPi = 0x1.45f306p-2f;
// a shadow-ray queue entry: these f32 fields, then its lane id
enum { kQOx, kQOy, kQOz, kQDx, kQDy, kQDz, kQTlim, kQL, kQC = kQL + 3, kQFields = kQC + 3 };
struct WarpQueue {
  float f[kQFields][kQueueCap];
  int lane[kQueueCap];
};

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

// The closest and any hit over the table (watertight.cuh's tests), in the
// triangle order of the plain sweeps (ops/watertight.py).
template <bool kIdx, int kStride>
__device__ __forceinline__ int closest_hit_tab(const SweepRay& r, const float* st, int n_tri,
                                               float& bt, float& b0, float& b1) {
  bt = kNoHit;
  b0 = 0.0f;
  b1 = 0.0f;
  int bi = -1;
  for (int t = 0; t < n_tri; ++t) {
    Edges g;
    if (edges_reject<kIdx>(r, st + kStride * t, kNoHit, g)) continue;
    const float inv_det = 1.0f / (g.det == 0.0f ? 1.0f : g.det);
    const float tt = g.t_scaled * inv_det;
    const float delta_t = edges_c_eps(g) * fabsf(inv_det);
    if (!(tt <= delta_t) && tt < bt) {
      bt = tt;
      bi = t;
      b0 = g.e0 * inv_det;
      b1 = g.e1 * inv_det;
    }
  }
  return bi;
}

template <bool kIdx, int kStride>
__device__ __forceinline__ bool any_hit_tab(const SweepRay& r, const float* st, int n_tri,
                                            float t_lim) {
  bool occluded = false;
  for (int t = 0; t < n_tri && !occluded; ++t) {
    Edges g;
    if (edges_reject<kIdx>(r, st + kStride * t, t_lim, g)) continue;
    const float t_signed = g.det < 0.0f ? -g.t_scaled : g.t_scaled;
    occluded = !(t_signed <= edges_c_eps(g));
  }
  return occluded;
}

struct Args {
  float* lanes;  // (13, n), in place
  int* alive;    // (n,), in place
  const int64_t* index;
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
  int tile;  // lanes a block takes: a multiple of kThreads, at most kTile
  float rr_threshold;
};

// A queued shadow ray: origin, direction and length, with the lane's L
// after emission and the NEE term L gets where the ray is unoccluded.
struct Shadow {
  V3 o, d;
  float t_lim;
  float L[3], c[3];
};

// The bounce of live lane i up to its shadow ray.  Writes the lane's rows
// and alive, except L where it returns true: then the shadow ray in `sh`
// carries L for the sweep's pass.
template <bool kIdx, int kStride>
__device__ __forceinline__ bool shade_lane(const Args& a, const float* st,
                                           const uint32_t* smats, int i, Shadow& sh) {
  const size_t N = a.n;
  float* lanes = a.lanes;
  V3 o = {lanes[0 * N + i], lanes[1 * N + i], lanes[2 * N + i]};
  V3 d = {lanes[3 * N + i], lanes[4 * N + i], lanes[5 * N + i]};
  float beta[3] = {lanes[6 * N + i], lanes[7 * N + i], lanes[8 * N + i]};
  float L[3] = {lanes[9 * N + i], lanes[10 * N + i], lanes[11 * N + i]};
  float prev_pdf = lanes[12 * N + i];
  bool alive = true, queued = false;

  while (true) {  // runs once; `break` ends the lane's work
    // ---- closest hit ----
    float bt, b0, b1;
    const int bi = closest_hit_tab<kIdx, kStride>(sweep_ray(o.x, o.y, o.z, d.x, d.y, d.z), st,
                                                  a.n_tri, bt, b0, b1);
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
      // queue the shadow ray (any hit up to just short of the light point)
      // with L and the NEE term L gets where the ray is unoccluded
      const V3 p_sh = offset_ray_origin(p, p_err, ng, wi_l3);
      const V3 delta_sh = sub(p_l, p_sh);
      const float dist_sh = sqrtf(dot(delta_sh, delta_sh));
      const V3 sh_d = scale(delta_sh, 1.0f / fmaxf(dist_sh, 1e-12f));
      const float w_light = power_heuristic(ls_pdf, scat_pdf);
      const float inv_pdf = w_light / fmaxf(ls_pdf * sel_pdf, 1e-12f);
      const float nee_gain = f_w * inv_pdf;
      sh.o = p_sh;
      sh.d = sh_d;
      sh.t_lim = dist_sh * 0.999f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        sh.L[k] = L[k];
        sh.c[k] = beta[k] * kd[k] * li_rgb[k] * nee_gain;
      }
      queued = true;
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

  lanes[0 * N + i] = o.x;
  lanes[1 * N + i] = o.y;
  lanes[2 * N + i] = o.z;
  lanes[3 * N + i] = d.x;
  lanes[4 * N + i] = d.y;
  lanes[5 * N + i] = d.z;
  lanes[6 * N + i] = beta[0];
  lanes[7 * N + i] = beta[1];
  lanes[8 * N + i] = beta[2];
  if (!queued) {
    lanes[9 * N + i] = L[0];
    lanes[10 * N + i] = L[1];
    lanes[11 * N + i] = L[2];
  }
  lanes[12 * N + i] = prev_pdf;
  a.alive[i] = alive ? 1 : 0;
  return queued;
}

// The sweeps of a warp's last `count` queued shadow rays, one a lane; the L
// rows of the unoccluded get the NEE term.
template <bool kIdx, int kStride>
__device__ __forceinline__ void sweep_shadows(const Args& a, const float* st, const WarpQueue& q,
                                              int first, int count, int lane) {
  if (lane >= count) return;
  const int k = first + lane;
  const SweepRay r = sweep_ray(q.f[kQOx][k], q.f[kQOy][k], q.f[kQOz][k], q.f[kQDx][k],
                               q.f[kQDy][k], q.f[kQDz][k]);
  const bool occluded = any_hit_tab<kIdx, kStride>(r, st, a.n_tri, q.f[kQTlim][k]);
  const size_t N = a.n;
  const int i = q.lane[k];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float l = q.f[kQL + c][k];
    a.lanes[(9 + c) * N + i] = occluded ? l : l + q.f[kQC + c][k];
  }
}

// kShared: the sweeps read the triangles' vertices from the block's copy in
// shared memory; else from the table in device memory (a row of kTriCols
// floats, cached in L1), where that copy would cost the SM its occupancy.
template <bool kIdx, bool kShared>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bounce_kernel(Args a) {
  constexpr int kStride = kShared ? kVertStride : kTriCols;
  // dynamic: with kShared the triangles' vertices (kVertStride floats
  // each), then one shadow queue a warp
  extern __shared__ float4 dyn[];
  __shared__ uint32_t smats[kDims * RS_SOBOL_MATRIX_SIZE];
  __shared__ int ids[kTile];  // the tile's live lane ids, ascending
  __shared__ int offs[32];  // live lanes before each (round, warp) of the tile
  __shared__ int n_live, next;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int base = blockIdx.x * a.tile;
  const int staged = kShared ? (kVertStride / 4) * a.n_tri : 0;  // float4s of vertices
  const float* st = kShared ? reinterpret_cast<const float*>(dyn) : a.tris;
  WarpQueue& q = reinterpret_cast<WarpQueue*>(dyn + staged)[warp];

  // ---- pack the tile's live lanes; stage the tables ----
  bool live[kPerThread];
  int rank[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = base + j * kThreads + tid;
    live[j] = j * kThreads < a.tile && i < a.n && a.alive[i] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, live[j]);
    rank[j] = __popc(m & ((1u << lane) - 1u));
    if (lane == 0) offs[j * kWarps + warp] = __popc(m);
  }
  if (!a.emit_only)
    for (int j = tid; j < kDims * RS_SOBOL_MATRIX_SIZE; j += kThreads)
      smats[j] = a.mats[a.dim_row * RS_SOBOL_MATRIX_SIZE + j];
  for (int j = tid; j < staged; j += kThreads) {
    const float* row = a.tris + static_cast<size_t>(j / 3) * kTriCols + 4 * (j % 3);
    dyn[j] = make_float4(__ldg(row), j % 3 == 2 ? 0.0f : __ldg(row + 1),
                         j % 3 == 2 ? 0.0f : __ldg(row + 2), j % 3 == 2 ? 0.0f : __ldg(row + 3));
  }
  if (tid == 0) next = 0;
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the 32 (round, warp) counts
    const int c = offs[lane];
    int s = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += t;
    }
    offs[lane] = s - c;
    if (lane == 31) n_live = s;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    if (live[j]) ids[offs[j * kWarps + warp] + rank[j]] = base + j * kThreads + tid;
  __syncthreads();

  // ---- each warp takes 32 packed lanes at a time, then sweeps its queued
  // shadow rays 32 at a time; no barrier, so no warp waits for another ----
  int queued = 0;  // the warp's queue length, the same in every lane
  while (true) {
    int first = 0;
    if (lane == 0) first = atomicAdd(&next, 32);
    first = __shfl_sync(0xffffffffu, first, 0);
    if (first >= n_live) break;
    Shadow sh;
    const bool mine = first + lane < n_live &&
                      shade_lane<kIdx, kStride>(a, st, smats, ids[first + lane], sh);
    const unsigned m = __ballot_sync(0xffffffffu, mine);
    if (mine) {
      const int k = queued + __popc(m & ((1u << lane) - 1u));
      q.f[kQOx][k] = sh.o.x;
      q.f[kQOy][k] = sh.o.y;
      q.f[kQOz][k] = sh.o.z;
      q.f[kQDx][k] = sh.d.x;
      q.f[kQDy][k] = sh.d.y;
      q.f[kQDz][k] = sh.d.z;
      q.f[kQTlim][k] = sh.t_lim;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        q.f[kQL + c][k] = sh.L[c];
        q.f[kQC + c][k] = sh.c[c];
      }
      q.lane[k] = ids[first + lane];
    }
    queued += __popc(m);
    __syncwarp();
    if (queued >= 32) {
      queued -= 32;
      sweep_shadows<kIdx, kStride>(a, st, q, queued, 32, lane);
      __syncwarp();  // the entries are read before the next appends reuse them
    }
  }
  sweep_shadows<kIdx, kStride>(a, st, q, 0, queued, lane);
}

}  // namespace

// Shared memory the kernel asks for at launch, beyond its static arrays.
extern "C" size_t rs_bounce_dynamic_smem(int n_tri, int shared_table) {
  return (shared_table ? static_cast<size_t>(n_tri) * kVertStride * sizeof(float) : 0) +
         kWarps * sizeof(WarpQueue);
}

extern "C" int rs_bounce(void* lanes, void* alive, const void* index, int n, const void* tris,
                         int n_tri, const void* lattr, int n_lights, const void* lsel,
                         const void* ltricdf, int a_cols, const void* mattr, int n_mats,
                         const void* mats, int dim_row, int n_bits, int first_bounce,
                         int rr_active, int emit_only, float rr_threshold, int finite_verts,
                         int shared_table, void* stream) {
  if (n == 0) return 0;
  Args a;
  a.lanes = static_cast<float*>(lanes);
  a.alive = static_cast<int*>(alive);
  a.index = static_cast<const int64_t*>(index);
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
  // the index form of the sweeps where every vertex is finite; the vertices
  // in shared memory where the caller asks for it
  void (*kernel)(Args) =
      finite_verts ? (shared_table ? bounce_kernel<true, true> : bounce_kernel<true, false>)
                   : (shared_table ? bounce_kernel<false, true> : bounce_kernel<false, false>);
  const size_t smem = rs_bounce_dynamic_smem(n_tri, shared_table);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the largest tile whose blocks still fill every block slot of the card
  // kWaves times: a launch of few lanes (or a large table's long sweeps)
  // would otherwise leave SMs with fewer warps than they can hold
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.tile = kTile;
  while (a.tile > kThreads &&
         (static_cast<long long>(n) + a.tile - 1) / a.tile < static_cast<long long>(kWaves) * sms * max(per_sm, 1))
    a.tile /= 2;
  const int blocks = static_cast<int>((static_cast<long long>(n) + a.tile - 1) / a.tile);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
