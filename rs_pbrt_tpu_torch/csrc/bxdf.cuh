// The reflecting lobes of ops/bsdf.py for one (wo, wi) pair, for S1's
// visible points whose BSDF is not one Lambert, Oren-Nayar or hair lobe
// (sppm.cu).  The deposit evaluates bsdf_f with reflect true, where the
// transmitting and specular lobes give 0: what is left is each slot's
// reflecting lobe, masked to wo and wi in one hemisphere, and the Fourier
// lobe (fourier.cuh) over the whole sphere, summed slot by slot.
//
// A visible point's row (kGenCols f32, sppm_kernel.pack_general): the six
// slots' tags, their colors, the base (ax, ay, eta, sigma), slots 2 and 3's
// (ax2, ay2, eta2, sigma2), the conductor's eta and k (a Disney lane's k3
// holds its flatness).  Each function computes ops/bsdf.py's ops in their
// order; built with --fmad=false.
#pragma once

#include "fourier.cuh"

namespace bxdf {

constexpr int kGenCols = 38;
constexpr int kKinds = 0, kColors = 6, kBase = 24, kSlot23 = 28, kEta3 = 32, kK3 = 35;
constexpr float kInvPi = 0.318309873342514038f;  // float32(1 / pi)
constexpr float kPi = 3.14159274101257324f;
constexpr float kDegToRad = 0.0174532923847436905f;  // float32(pi / 180)
constexpr float kBlendK = 0.387507706880569458f;  // float32(28) / (float32(23) float32(pi))
enum Lobe {
  kNone = 0, kLambert = 1, kOrenNayar = 2, kMicrofacet = 5, kBlend = 6, kConductor = 7,
  kDisneyDiffuse = 8, kDisneyGloss = 9, kFourier = 11, kClearcoat = 17, kSheen = 18
};

using fou::clamp_min;
using fou::clampf;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 normalize(V3 v) {
  const float l = clamp_min(sqrtf(clamp_min(dot(v, v), 1e-30f)), 1e-20f);
  return V3{v.x / l, v.y / l, v.z / l};
}
__device__ __forceinline__ float sin2(V3 w) { return clamp_min(1.0f - w.z * w.z, 0.0f); }
__device__ __forceinline__ float cos_phi(V3 w) {
  const float s = sqrtf(clamp_min(sin2(w), 1e-24f));
  return sin2(w) == 0.0f ? 1.0f : clampf(w.x / s, -1.0f, 1.0f);
}
__device__ __forceinline__ float sin_phi(V3 w) {
  const float s = sqrtf(clamp_min(sin2(w), 1e-24f));
  return sin2(w) == 0.0f ? 0.0f : clampf(w.y / s, -1.0f, 1.0f);
}
__device__ __forceinline__ float tan2(V3 w) { return sin2(w) / clamp_min(w.z * w.z, 1e-20f); }
__device__ __forceinline__ float pow5(float v) { return (v * v) * (v * v) * v; }
__device__ __forceinline__ float lerp(float t, float a, float b) { return (1.0f - t) * a + t * b; }

__device__ __forceinline__ float tr_d(V3 wh, float ax, float ay) {
  const float t2 = tan2(wh);
  const float c2 = wh.z * wh.z;
  const float c4 = c2 * c2;
  const float cp = cos_phi(wh), sp = sin_phi(wh);
  const float e = (cp * cp / clamp_min(ax * ax, 1e-12f) + sp * sp / clamp_min(ay * ay, 1e-12f)) * t2;
  const float d = 1.0f / (kPi * ax * ay * c4 * ((1.0f + e) * (1.0f + e)));
  return (isfinite(t2) && c4 > 1e-16f) ? d : 0.0f;
}

__device__ __forceinline__ float tr_lambda(V3 w, float ax, float ay) {
  const float abs_tan = sqrtf(clamp_min(tan2(w), 0.0f));
  const float cp = cos_phi(w), sp = sin_phi(w);
  const float alpha = sqrtf(clamp_min(cp * cp * ax * ax + sp * sp * ay * ay, 1e-12f));
  const float at = alpha * abs_tan;
  const float lam = (-1.0f + sqrtf(1.0f + at * at)) / 2.0f;
  return isfinite(abs_tan) ? lam : 0.0f;
}

__device__ __forceinline__ float tr_g(V3 wo, V3 wi, float ax, float ay) {
  return 1.0f / (1.0f + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay));
}

__device__ __forceinline__ float fr_dielectric(float cos_i, float eta) {
  cos_i = clampf(cos_i, -1.0f, 1.0f);
  const bool entering = cos_i > 0.0f;
  const float ei = entering ? 1.0f : eta, et = entering ? eta : 1.0f;
  const float ci = fabsf(cos_i);
  const float sin_t = ei / et * sqrtf(clamp_min(1.0f - ci * ci, 0.0f));
  const float ct = sqrtf(clamp_min(1.0f - sin_t * sin_t, 0.0f));
  const float r_parl = (et * ci - ei * ct) / clamp_min(et * ci + ei * ct, 1e-20f);
  const float r_perp = (ei * ci - et * ct) / clamp_min(ei * ci + et * ct, 1e-20f);
  return sin_t >= 1.0f ? 1.0f : 0.5f * (r_parl * r_parl + r_perp * r_perp);
}

__device__ __forceinline__ float fr_conductor(float cos_i, float eta_t, float k) {
  const float ci = clampf(fabsf(cos_i), -1.0f, 1.0f);
  const float eta = eta_t / 1.0f, etak = k / 1.0f;
  const float cos2 = ci * ci;
  const float s2 = 1.0f - cos2;
  const float eta2 = eta * eta, etak2 = etak * etak;
  const float t0 = eta2 - etak2 - s2;
  const float a2b2 = sqrtf(clamp_min(t0 * t0 + 4.0f * eta2 * etak2, 0.0f));
  const float t1 = a2b2 + cos2;
  const float a = sqrtf(clamp_min(0.5f * (a2b2 + t0), 0.0f));
  const float t2 = 2.0f * a * ci;
  const float rs = (t1 - t2) / clamp_min(t1 + t2, 1e-20f);
  const float t3 = cos2 * a2b2 + s2 * s2;
  const float t4 = t2 * s2;
  const float rp = rs * (t3 - t4) / clamp_min(t3 + t4, 1e-20f);
  return 0.5f * (rp + rs);
}

__device__ __forceinline__ float oren_nayar(float sigma_deg, V3 wo, V3 wi) {
  const float sr = sigma_deg * kDegToRad;
  const float s2 = sr * sr;
  const float a = 1.0f - s2 / (2.0f * (s2 + 0.33f)), b = 0.45f * s2 / (s2 + 0.09f);
  const float sin_ti = sqrtf(clamp_min(sin2(wi), 1e-24f));
  const float sin_to = sqrtf(clamp_min(sin2(wo), 1e-24f));
  const float cos_diff = cos_phi(wi) * cos_phi(wo) + sin_phi(wi) * sin_phi(wo);
  const float max_cos = (sin_ti > 1e-4f && sin_to > 1e-4f) ? clamp_min(cos_diff, 0.0f) : 0.0f;
  const float aci = fabsf(wi.z), aco = fabsf(wo.z);
  const float sin_a = aci > aco ? sin_to : sin_ti;
  const float tan_b = aci > aco ? sin_ti / clamp_min(aci, 1e-7f) : sin_to / clamp_min(aco, 1e-7f);
  return kInvPi * (a + b * max_cos * sin_a * tan_b);
}

// One slot's reflecting lobe (bsdf.py _lobe_f before its hemisphere mask).
__device__ void lobe(int kind, const float* g, int slot, V3 wo, V3 wi, float out[3]) {
  const float* col = g + kColors + 3 * slot;
  const float* prm = g + ((slot == 2 || slot == 3) ? kSlot23 : kBase);
  const float ax = prm[0], ay = prm[1], eta = prm[2], sigma = prm[3];
  out[0] = out[1] = out[2] = 0.0f;
  const float aci = fabsf(wi.z), aco = fabsf(wo.z);
  const V3 wh{wi.x + wo.x, wi.y + wo.y, wi.z + wo.z};
  const bool wh_any = wh.x != 0.0f || wh.y != 0.0f || wh.z != 0.0f;
  const V3 wh_n = normalize(wh);
  const float sgn = wh_n.z > 0.0f ? 1.0f : (wh_n.z < 0.0f ? -1.0f : 0.0f);
  const V3 wh_f{wh_n.x * sgn, wh_n.y * sgn, wh_n.z * sgn};
  const bool wh_ok = wh_any && aci > 0.0f && aco > 0.0f;
  switch (kind) {
    case kLambert:
      for (int c = 0; c < 3; ++c) out[c] = col[c] * kInvPi;
      return;
    case kOrenNayar: {
      const float s = oren_nayar(sigma, wo, wi);
      for (int c = 0; c < 3; ++c) out[c] = col[c] * s;
      return;
    }
    case kMicrofacet:
    case kConductor: {
      const float denom = 4.0f * aci * aco;
      if (!(wh_ok && denom > 0.0f)) return;
      const float s = tr_d(wh_n, ax, ay) * tr_g(wo, wi, ax, ay) / clamp_min(denom, 1e-12f);
      const float cw = dot(wi, wh_f);
      for (int c = 0; c < 3; ++c) {
        const float fr = kind == kMicrofacet ? fr_dielectric(cw, eta)
                                             : fr_conductor(cw, g[kEta3 + c], g[kK3 + c]);
        out[c] = col[c] * s * fr;
      }
      return;
    }
    case kBlend: {
      const float* r0 = g + kColors;
      const float* r1 = g + kColors + 3;
      const float di = 1.0f - pow5(1.0f - 0.5f * aci), dout = 1.0f - pow5(1.0f - 0.5f * aco);
      const float d = tr_d(wh_n, ax, ay);
      const float sw = pow5(1.0f - fabsf(dot(wi, wh_f)));
      const float spec = d / clamp_min(4.0f * fabsf(dot(wi, wh_n)) * fmaxf(aci, aco), 1e-12f);
      for (int c = 0; c < 3; ++c) {
        const float diffuse = kBlendK * r0[c] * (1.0f - r1[c]) * di * dout;
        const float schlick = r1[c] + sw * (1.0f - r1[c]);
        out[c] = diffuse + (wh_ok ? spec * schlick : 0.0f);
      }
      return;
    }
    case kDisneyDiffuse: {
      const float cos_d = fabsf(dot(wi, wh_n));
      const float fl = pow5(1.0f - aci), fv = pow5(1.0f - aco);
      const float rr = 2.0f * sigma * cos_d * cos_d;
      float diffuse = (1.0f - 0.5f * fl) * (1.0f - 0.5f * fv);
      const float retro = rr * (fl + fv + fl * fv * (rr - 1.0f));
      const float fss90 = cos_d * cos_d * sigma;
      const float fss = lerp(fl, 1.0f, fss90) * lerp(fv, 1.0f, fss90);
      const float den = clamp_min(aci + aco, 1e-6f);
      const float ss = 1.25f * (fss * (1.0f / den - 0.5f) + 0.5f);
      diffuse = lerp(g[kK3], diffuse, ss);
      const float s = kInvPi * (diffuse + retro) * (wh_any ? 1.0f : 0.0f);
      for (int c = 0; c < 3; ++c) out[c] = col[c] * s;
      return;
    }
    case kDisneyGloss: {
      const float denom = 4.0f * aci * aco;
      if (!(wh_ok && denom > 0.0f)) return;
      const float sw = pow5(1.0f - fabsf(dot(wi, wh_n)));
      const float s = tr_d(wh_n, ax, ay) * tr_g(wo, wi, ax, ay) / clamp_min(denom, 1e-12f);
      for (int c = 0; c < 3; ++c) out[c] = (col[c] + sw * (1.0f - col[c])) * s;
      return;
    }
    case kClearcoat: {
      if (!wh_any) return;
      const float a2 = clamp_min(sigma * sigma, 1e-6f);
      const float c2 = wh_n.z * wh_n.z;
      const float d = (a2 - 1.0f) / (kPi * logf(a2) * clamp_min(1.0f + (a2 - 1.0f) * c2, 1e-12f));
      const float fr = 0.04f + pow5(1.0f - fabsf(dot(wi, wh_n))) * (1.0f - 0.04f);
      const float gg = 1.0f / (1.0f + tr_lambda(wo, 0.25f, 0.25f) + tr_lambda(wi, 0.25f, 0.25f));
      const float v = col[0] * d * fr * gg / 4.0f;
      out[0] = out[1] = out[2] = v;
      return;
    }
    case kSheen: {
      const float s = pow5(1.0f - fabsf(dot(wi, wh_n))) * (wh_any ? 1.0f : 0.0f);
      for (int c = 0; c < 3; ++c) out[c] = col[c] * s;
      return;
    }
    default:
      return;  // transmitting and specular lobes: 0 with reflect true
  }
}

// bsdf_f(b, wo, wi, reflect=true) of a visible point's general row g.
__device__ void general_f(const float* g, const fou::Table* T, V3 wo, V3 wi, float f[3]) {
  const bool same = wo.z * wi.z > 0.0f;
  f[0] = f[1] = f[2] = 0.0f;
  for (int s = 0; s < 6; ++s) {
    const int kind = static_cast<int>(g[kKinds + s]);
    float v[3] = {0.0f, 0.0f, 0.0f};
    if (kind == kFourier) {
      if (T != nullptr) {
        const float o[3] = {wo.x, wo.y, wo.z}, w[3] = {wi.x, wi.y, wi.z};
        float pdf;
        fou::eval_lane(*T, o, w, v, &pdf);
      }
    } else if (kind != kNone) {
      lobe(kind, g, s, wo, wi, v);
      if (!same) v[0] = v[1] = v[2] = 0.0f;
    }
    for (int c = 0; c < 3; ++c) f[c] = f[c] + v[c];
  }
}

}  // namespace bxdf
