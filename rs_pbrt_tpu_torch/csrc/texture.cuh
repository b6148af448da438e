// The texture evaluation's per-lane math, T1's (texture.cu).
//
// Each function computes the plain version's ops (ops/texture.py) in their
// order for one lane: with --fmad=false and no fast math each product and
// sum rounds alone, and floorf, fmodf, sinf and log2f are the ones torch's
// CUDA ops call.  Clamps keep NaN, as torch.clamp does.  Where the plain
// version evaluates every family of the kind mask and selects, a lane here
// evaluates only its own family: the same arithmetic on the values it
// keeps.  RS_HD marks the functions: device and inline unless the includer
// defines it.
#pragma once

#include <math.h>

#ifndef RS_HD
#define RS_HD __device__ __forceinline__
#endif

namespace tex {

// type tags and parameter columns (ops/texture.py)
constexpr int kConstant = 0, kScale = 1, kMix = 2, kChecker = 3, kDots = 4, kFbm = 5,
              kWrinkled = 6, kMarble = 7, kWindy = 8, kImageMap = 9, kUv = 10;
constexpr int kValue = 0, kSu = 3, kSv = 4, kDu = 5, kDv = 6, kOmega = 7, kOctaves = 8,
              kVariation = 9, kScaleN = 10, kGammaScale = 12, kParams = 16;
constexpr int kMaxOctaves = 8;
constexpr int kMaxLevels = 12;
constexpr float kDotRadius2 = 0.0600249990820884705f;  // DOT_RADIUS2

struct Tables {
  const int* type;  // (X,)
  const float* params;  // (X, 16)
  const int* child;  // (X, 2)
  const float* w2t;  // (X, 4, 4)
  const float* atlas;  // (AH, AW, 3)
  const int* rect;  // (X, 4): y0, h, w, wrap
  const int* mip;  // (X, kMaxLevels, 3)
  const int* nlv;  // (X,)
  const int* perm;  // (512,): shared memory in the kernel
  const float* marble;  // (9, 3) the marble spline's control points
  int n_tex, ah, aw, kind_mask;
};

// OCTAVE_LAMBDA: 1.99^i by repeated double products, rounded to f32
RS_HD float octave_lambda(int i) {
  switch (i) {
    case 0: return 1.0f;
    case 1: return 1.99000000953674316f;
    case 2: return 3.96009993553161621f;
    case 3: return 7.88059902191162109f;
    case 4: return 15.6823921203613281f;
    case 5: return 31.2079601287841797f;
    case 6: return 62.1038398742675781f;
    default: return 123.586639404296875f;
  }
}

RS_HD float clamp_min(float x, float lo) { return x < lo ? lo : x; }
RS_HD float clamp_max(float x, float hi) { return x > hi ? hi : x; }
RS_HD int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }
RS_HD float lerp(float t, float a, float b) { return (1.0f - t) * a + t * b; }
RS_HD bool has(const Tables& T, int t) { return (T.kind_mask >> t) & 1; }

RS_HD float grad(const Tables& T, int x, int y, int z, float dx, float dy, float dz) {
  const int h = T.perm[T.perm[T.perm[x] + y] + z] & 15;
  float u = (h < 8 || h == 12 || h == 13) ? dx : dy;
  float v = (h < 4 || h == 12 || h == 13) ? dy : dz;
  u = (h & 1) ? -u : u;
  v = (h & 2) ? -v : v;
  return u + v;
}

RS_HD float noise_weight(float t) {
  const float t3 = t * t * t;
  const float t4 = t3 * t;
  return 6.0f * t4 * t - 15.0f * t4 + 10.0f * t3;
}

// Perlin noise (texture.rs noise_flt :295)
RS_HD float noise(const Tables& T, float x, float y, float z) {
  const float fx = floorf(x), fy = floorf(y), fz = floorf(z);
  const float dx = x - fx, dy = y - fy, dz = z - fz;
  const int ix = static_cast<int>(static_cast<long long>(fx) & 255);
  const int iy = static_cast<int>(static_cast<long long>(fy) & 255);
  const int iz = static_cast<int>(static_cast<long long>(fz) & 255);
  const float w000 = grad(T, ix, iy, iz, dx, dy, dz);
  const float w100 = grad(T, ix + 1, iy, iz, dx - 1.0f, dy, dz);
  const float w010 = grad(T, ix, iy + 1, iz, dx, dy - 1.0f, dz);
  const float w110 = grad(T, ix + 1, iy + 1, iz, dx - 1.0f, dy - 1.0f, dz);
  const float w001 = grad(T, ix, iy, iz + 1, dx, dy, dz - 1.0f);
  const float w101 = grad(T, ix + 1, iy, iz + 1, dx - 1.0f, dy, dz - 1.0f);
  const float w011 = grad(T, ix, iy + 1, iz + 1, dx, dy - 1.0f, dz - 1.0f);
  const float w111 = grad(T, ix + 1, iy + 1, iz + 1, dx - 1.0f, dy - 1.0f, dz - 1.0f);
  const float wx = noise_weight(dx), wy = noise_weight(dy), wz = noise_weight(dz);
  const float x00 = lerp(wx, w000, w100);
  const float x10 = lerp(wx, w010, w110);
  const float x01 = lerp(wx, w001, w101);
  const float x11 = lerp(wx, w011, w111);
  const float y0 = lerp(wy, x00, x10);
  const float y1 = lerp(wy, x01, x11);
  return lerp(wz, y0, y1);
}

// fbm and turbulence (texture.rs :370, :400): the octaves below `octaves`
// (an inactive octave adds 0, which leaves the sum as it is)
RS_HD float fbm(const Tables& T, const float p[3], float omega, int octaves, bool turb) {
  float total = 0.0f, o = 1.0f;
  for (int i = 0; i < kMaxOctaves && i < octaves; ++i) {
    const float lam = octave_lambda(i);
    float n = noise(T, p[0] * lam, p[1] * lam, p[2] * lam);
    if (turb) n = fabsf(n);
    total = total + o * n;
    o = o * omega;
  }
  return total;
}

RS_HD void marble(const Tables& T, const float p[3], float scale_n, float omega, int octaves,
                  float variation, float out[3]) {
  const float first[3] = {scale_n * p[0], scale_n * p[1], scale_n * p[2]};
  const float t_disp = variation * fbm(T, first, omega, octaves, false);
  const float t = sinf(first[1] + t_disp) * 0.5f + 0.5f;
  const float tt = clamp_max(clamp_min(t, 0.0f), 0.999899983406066895f) * 6.0f;
  const int i = static_cast<int>(tt);
  const float ft = tt - static_cast<float>(i);
  const float s0 = (1.0f - ft) * (1.0f - ft) * (1.0f - ft);
  const float s1 = 3.0f * ft * (1.0f - ft) * (1.0f - ft);
  const float s2 = 3.0f * ft * ft * (1.0f - ft);
  const float s3 = ft * ft * ft;
  const float* c = T.marble + 3 * i;
  for (int k = 0; k < 3; ++k)
    out[k] = 1.5f * (s0 * c[k] + s1 * c[3 + k] + s2 * c[6 + k] + s3 * c[9 + k]);
}

// the atlas at (u, v) in rect (y0, h, w) with wrap mode `wrap`, bilinear
RS_HD void atlas_lookup(const Tables& T, int y0, int hi, int wi, int wrap, float u, float v,
                        float out[3]) {
  const float h = static_cast<float>(hi), w = static_cast<float>(wi);
  const float uu = u * w - 0.5f;
  const float vv = (1.0f - v) * h - 0.5f;
  const float x0 = floorf(uu), y0f = floorf(vv);
  const float fx = uu - x0, fy = vv - y0f;
  const bool black =
      wrap == 2 && (uu < -0.5f || uu > w - 0.5f || vv < -0.5f || vv > h - 0.5f);
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int dy = 0; dy < 2; ++dy) {
    for (int dx = 0; dx < 2; ++dx) {
      float xs = x0 + static_cast<float>(dx), ys = y0f + static_cast<float>(dy);
      if (wrap == 0) {  // torch.remainder: fmod, moved to the divisor's sign
        float mx = fmodf(xs, w), my = fmodf(ys, h);
        if (mx != 0.0f && ((w < 0.0f) != (mx < 0.0f))) mx += w;
        if (my != 0.0f && ((h < 0.0f) != (my < 0.0f))) my += h;
        xs = mx;
        ys = my;
      } else {
        const float cx = clamp_min(xs, 0.0f), cy = clamp_min(ys, 0.0f);
        const float nx = w - 1.0f, ny = h - 1.0f;
        xs = cx > nx ? nx : cx;
        ys = cy > ny ? ny : cy;
      }
      const int col = clampi(static_cast<int>(xs), 0, T.aw - 1);
      const int row = clampi(static_cast<int>(ys) + y0, 0, T.ah - 1);
      const float wgt = (dx ? fx : (1.0f - fx)) * (dy ? fy : (1.0f - fy));
      const float* texel = T.atlas + (static_cast<long long>(row) * T.aw + col) * 3;
      for (int k = 0; k < 3; ++k) acc[k] = acc[k] + wgt * texel[k];
    }
  }
  for (int k = 0; k < 3; ++k) out[k] = black ? 0.0f : acc[k];
}

// the pyramid at footprint width (mipmap.rs:233-270)
RS_HD void trilinear_lookup(const Tables& T, int id, float u, float v, float width,
                            float out[3]) {
  const int nlv_i = T.nlv[id];
  const float nlv = static_cast<float>(nlv_i);
  float level = nlv - 1.0f + log2f(clamp_min(width, 1e-8f));
  const float top = clamp_min(nlv - 1.0f, 0.0f);
  level = clamp_min(level, 0.0f);
  level = level > top ? top : level;
  const int l0 = static_cast<int>(floorf(level));
  const int nl1 = nlv_i - 1 < 0 ? 0 : nlv_i - 1;
  const int l1 = l0 + 1 < nl1 ? l0 + 1 : nl1;
  const float f = level - static_cast<float>(l0);
  const int wrap = T.rect[4 * id + 3];
  const int* m0 = T.mip + (id * kMaxLevels + l0) * 3;
  const int* m1 = T.mip + (id * kMaxLevels + l1) * 3;
  float c0[3], c1[3];
  atlas_lookup(T, m0[0], m0[1], m0[2], wrap, u, v, c0);
  atlas_lookup(T, m1[0], m1[1], m1[2], wrap, u, v, c1);
  for (int k = 0; k < 3; ++k) out[k] = (1.0f - f) * c0[k] + f * c1[k];
}

struct Mapped {
  float u, v, su, sv;
};

RS_HD Mapped mapped_uv(const float* tp, float uv0, float uv1) {
  const float su = tp[kSu] == 0.0f ? 1.0f : tp[kSu];
  const float sv = tp[kSv] == 0.0f ? 1.0f : tp[kSv];
  return Mapped{uv0 * su + tp[kDu], uv1 * sv + tp[kDv], su, sv};
}

// world point p through the row-major (4, 4) m, the homogeneous divide
// last (utils/transform.xform_point's order)
RS_HD void xform_point(const float* m, const float p[3], float out[3]) {
  float r[4];
  for (int i = 0; i < 4; ++i) r[i] = m[4 * i] * p[0] + m[4 * i + 1] * p[1] + m[4 * i + 2] * p[2];
  const float w = r[3] + m[15];
  for (int i = 0; i < 3; ++i) out[i] = (r[i] + m[4 * i + 3]) / w;
}

// the leaf texture id (in range) at the lane's uv and p (eval_leaf)
RS_HD void eval_leaf(const Tables& T, int id, float uv0, float uv1, const float p[3],
                     bool with_width, float width, float out[3]) {
  const float* tp = T.params + kParams * id;
  const int type = T.type[id];
  const Mapped m = mapped_uv(tp, uv0, uv1);
  for (int k = 0; k < 3; ++k) out[k] = tp[kValue + k];
  if ((type == kFbm || type == kWrinkled || type == kMarble || type == kWindy) && has(T, type)) {
    float pt[3];
    xform_point(T.w2t + 16 * id, p, pt);
    const int octs = clampi(static_cast<int>(tp[kOctaves]), 1, kMaxOctaves);
    const float omega = tp[kOmega] == 0.0f ? 0.5f : tp[kOmega];
    if (type == kMarble) {
      const float scale_n = tp[kScaleN] == 0.0f ? 1.0f : tp[kScaleN];
      marble(T, pt, scale_n, omega, octs, tp[kVariation], out);
      return;
    }
    float f;
    if (type == kWindy) {
      const float pw[3] = {0.100000001490116119f * pt[0], 0.100000001490116119f * pt[1],
                           0.100000001490116119f * pt[2]};
      f = fabsf(fbm(T, pw, 0.5f, 3, false)) * fbm(T, pt, 0.5f, 6, false);
    } else {
      f = fbm(T, pt, omega, octs, type == kWrinkled);
    }
    for (int k = 0; k < 3; ++k) out[k] = f * tp[kValue + k];
  } else if (type == kUv && has(T, kUv)) {
    out[0] = m.u - floorf(m.u);
    out[1] = m.v - floorf(m.v);
    out[2] = 0.0f;
  } else if (type == kImageMap && has(T, kImageMap)) {
    float img[3];
    if (with_width) {
      const float a = fabsf(m.su), b = fabsf(m.sv);
      trilinear_lookup(T, id, m.u, m.v, width * (a < b ? b : a), img);
    } else {
      const int* r = T.rect + 4 * id;
      atlas_lookup(T, r[0], r[1], r[2], r[3], m.u, m.v, img);
    }
    for (int k = 0; k < 3; ++k) out[k] = img[k] * tp[kGammaScale];
  }
}

// texture id at the lane (eval_texture); zeros for a negative id
RS_HD void eval_texture(const Tables& T, int id, float uv0, float uv1, const float p[3],
                        bool with_width, float width, float out[3]) {
  if (id < 0) {
    out[0] = out[1] = out[2] = 0.0f;
    return;
  }
  const int tid = id > T.n_tex - 1 ? T.n_tex - 1 : id;
  const int type = T.type[tid];
  if (type != kScale && type != kMix && type != kChecker && type != kDots) {
    eval_leaf(T, tid, uv0, uv1, p, with_width, width, out);
    return;
  }
  const int c1 = clampi(T.child[2 * tid], 0, T.n_tex - 1);
  const int c2 = clampi(T.child[2 * tid + 1], 0, T.n_tex - 1);
  float v1[3], v2[3];
  eval_leaf(T, c1, uv0, uv1, p, with_width, width, v1);
  eval_leaf(T, c2, uv0, uv1, p, with_width, width, v2);
  const float* tp = T.params + kParams * tid;
  if (type == kScale) {
    for (int k = 0; k < 3; ++k) out[k] = v1[k] * v2[k];
    return;
  }
  if (type == kMix) {
    for (int k = 0; k < 3; ++k) out[k] = lerp(tp[kValue], v1[k], v2[k]);
    return;
  }
  const Mapped m = mapped_uv(tp, uv0, uv1);
  bool first;
  if (type == kChecker) {
    const long long s = static_cast<long long>(floorf(m.u)) +
                        static_cast<long long>(floorf(m.v));
    first = s % 2 == 0;
  } else {  // dots (textures/dots.rs)
    const float s_cell = floorf(m.u + 0.5f), t_cell = floorf(m.v + 0.5f);
    const bool has_dot = noise(T, s_cell + 0.5f, t_cell + 0.5f, 0.0f + 0.5f) > 0.0f;
    const float cx = s_cell + 0.349999994039535522f *
                                  noise(T, s_cell + 1.5f, t_cell + 2.79999995231628418f, 0.0f);
    const float cy = t_cell + 0.349999994039535522f *
                                  noise(T, s_cell + 4.5f, t_cell + 9.80000019073486328f, 0.0f);
    first = has_dot && ((m.u - cx) * (m.u - cx) + (m.v - cy) * (m.v - cy) < kDotRadius2);
  }
  for (int k = 0; k < 3; ++k) out[k] = first ? v1[k] : v2[k];
}

}  // namespace tex
