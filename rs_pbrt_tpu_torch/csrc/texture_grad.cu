// T2 and T3: the texture evaluation's vector-Jacobian products, one thread
// a lane.
//
// T2 is the backward of T1 (texture.cu) with respect to the scene's
// tex_params (X, 16) and tex_atlas (AH, AW, 3).  JAX differentiates its XLA
// texture evaluation (rs_pbrt_tpu/ops/texture.py:286 eval_texture) by
// reverse-mode AD; here a lane runs its own texture's forward (texture.cuh)
// and then its reverse sweep by hand, and adds each term into the two
// tables with atomics: the constant's value; the noise families' value,
// omega, and a marble's variation and noise scale (through the Perlin
// noise's gradient in its point); an image map's scale, its bilinear or
// trilinear texels and the uv mapping's scales and offsets (through the
// taps' weights and the MIP level); the uv texture's mapping; a mix's
// amount; and, one level down, each combinator's children (scale, mix,
// checker, dots).  The sums land in no fixed order, so the tables are not
// bit-equal to the twin's (ops/texture_kernel.texture_grad_plain).
//
// T3 is the same reverse sweep in the lane's coordinates: the uv, the
// shading point p and the footprint width (a camera or geometry gradient
// on a textured surface).  The image map's bilinear weights give d/du and
// d/dv (scaled by the mapping's su, sv), its trilinear level d/d width
// through log2 where the level is not clipped; the noise families' Perlin
// gradient goes back through the world-to-texture transform to p (a
// marble's through its sine and noise scale, windy's through both of its
// fbm's); the uv texture passes its gradient to uv; a combinator passes
// its children's.  Terms behind floor and the discrete selects (checker's
// parity, a dot's inside test, the wrap modes) give zero, as in JAX.  One
// thread takes a lane through every row of ids, so a point shared by the
// rows sums its rows' terms without atomics.  Its twin
// (ops/texture_kernel.texture_coord_grad_plain) computes the same sweep
// term by term in plain PyTorch.
//
// What bounds them on the card: the atomics and, for noise lanes, the
// arithmetic: a noise's gradient re-reads its 8 lattice corners (three
// chained permutation reads each) and takes ~120 more operations; an image
// lane adds 12 atomics a tap into the atlas (T2), where neighbouring lanes
// hit the same texels.  What the design does about it: nothing yet; this
// is the first, simple form.  The permutation table sits in shared memory
// as in T1.
#include <cuda_runtime.h>
#include <stdint.h>

#include "texture.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPerm = 512;
constexpr float kLn2 = 0.693147180559945309f;

__constant__ float c_marble[27] = {0.58f, 0.58f, 0.6f,  0.58f, 0.58f, 0.6f,  0.58f, 0.58f, 0.6f,
                                   0.5f,  0.5f,  0.5f,  0.6f,  0.59f, 0.58f, 0.58f, 0.58f, 0.6f,
                                   0.58f, 0.58f, 0.6f,  0.2f,  0.2f,  0.33f, 0.58f, 0.58f, 0.6f};

struct Grads {
  float* params;  // (X, 16), null: not wanted (T3)
  float* atlas;  // (AH, AW, 3), null: not wanted (T3)
};

// a lane's gradients in its coordinates (T3): uv, p and the width
struct Coord {
  float u, v, p[3], width;
};

__device__ void add_param(const Grads& G, int id, int col, float g) {
  if (G.params != nullptr && g != 0.0f) atomicAdd(G.params + tex::kParams * id + col, g);
}

// g_pt, the gradient at xform_point(m, p), carried back to p: the rows of
// m over the homogeneous w, less the divide's term
__device__ void xform_point_vjp(const float* m, const float p[3], const float g_pt[3],
                                float gp[3]) {
  float r[4];
  for (int i = 0; i < 4; ++i) r[i] = m[4 * i] * p[0] + m[4 * i + 1] * p[1] + m[4 * i + 2] * p[2];
  const float w = r[3] + m[15];
  float g_w = 0.0f;
  for (int i = 0; i < 3; ++i) {
    const float out = (r[i] + m[4 * i + 3]) / w;
    g_w = g_w - g_pt[i] * out / w;
  }
  for (int k = 0; k < 3; ++k)
    gp[k] += (g_pt[0] * m[k] + g_pt[1] * m[4 + k] + g_pt[2] * m[8 + k]) / w + g_w * m[12 + k];
}

// d noise_weight / dt: 30 t^4 - 60 t^3 + 30 t^2
__device__ float noise_weight_d(float t) {
  const float t2 = t * t;
  return 30.0f * t2 * t2 - 60.0f * t2 * t + 30.0f * t2;
}

// the gradient of one lattice corner's term u + v in (dx, dy, dz)
__device__ void corner_d(const tex::Tables& T, int x, int y, int z, float gw, float gd[3]) {
  const int h = T.perm[T.perm[T.perm[x] + y] + z] & 15;
  const float su = (h & 1) ? -gw : gw;
  const float sv = (h & 2) ? -gw : gw;
  if (h < 8 || h == 12 || h == 13) gd[0] += su; else gd[1] += su;
  if (h < 4 || h == 12 || h == 13) gd[1] += sv; else gd[2] += sv;
}

// noise at (x, y, z) and g times its gradient there, added into gp
__device__ void noise_vjp(const tex::Tables& T, float x, float y, float z, float g, float gp[3]) {
  const float fx = floorf(x), fy = floorf(y), fz = floorf(z);
  const float dx = x - fx, dy = y - fy, dz = z - fz;
  const int ix = static_cast<int>(static_cast<long long>(fx) & 255);
  const int iy = static_cast<int>(static_cast<long long>(fy) & 255);
  const int iz = static_cast<int>(static_cast<long long>(fz) & 255);
  const float w000 = tex::grad(T, ix, iy, iz, dx, dy, dz);
  const float w100 = tex::grad(T, ix + 1, iy, iz, dx - 1.0f, dy, dz);
  const float w010 = tex::grad(T, ix, iy + 1, iz, dx, dy - 1.0f, dz);
  const float w110 = tex::grad(T, ix + 1, iy + 1, iz, dx - 1.0f, dy - 1.0f, dz);
  const float w001 = tex::grad(T, ix, iy, iz + 1, dx, dy, dz - 1.0f);
  const float w101 = tex::grad(T, ix + 1, iy, iz + 1, dx - 1.0f, dy, dz - 1.0f);
  const float w011 = tex::grad(T, ix, iy + 1, iz + 1, dx, dy - 1.0f, dz - 1.0f);
  const float w111 = tex::grad(T, ix + 1, iy + 1, iz + 1, dx - 1.0f, dy - 1.0f, dz - 1.0f);
  const float wx = tex::noise_weight(dx), wy = tex::noise_weight(dy), wz = tex::noise_weight(dz);
  const float x00 = tex::lerp(wx, w000, w100), x10 = tex::lerp(wx, w010, w110);
  const float x01 = tex::lerp(wx, w001, w101), x11 = tex::lerp(wx, w011, w111);
  const float y0 = tex::lerp(wy, x00, x10), y1 = tex::lerp(wy, x01, x11);
  // lerp(t, a, b) = (1 - t) a + t b
  const float g_wz = g * (y1 - y0);
  const float g_y0 = g * (1.0f - wz), g_y1 = g * wz;
  const float g_wy = g_y0 * (x10 - x00) + g_y1 * (x11 - x01);
  const float g_x00 = g_y0 * (1.0f - wy), g_x10 = g_y0 * wy;
  const float g_x01 = g_y1 * (1.0f - wy), g_x11 = g_y1 * wy;
  const float g_wx = g_x00 * (w100 - w000) + g_x10 * (w110 - w010) + g_x01 * (w101 - w001) +
                     g_x11 * (w111 - w011);
  float gd[3] = {g_wx * noise_weight_d(dx), g_wy * noise_weight_d(dy), g_wz * noise_weight_d(dz)};
  const float a = 1.0f - wx;
  corner_d(T, ix, iy, iz, g_x00 * a, gd);
  corner_d(T, ix + 1, iy, iz, g_x00 * wx, gd);
  corner_d(T, ix, iy + 1, iz, g_x10 * a, gd);
  corner_d(T, ix + 1, iy + 1, iz, g_x10 * wx, gd);
  corner_d(T, ix, iy, iz + 1, g_x01 * a, gd);
  corner_d(T, ix + 1, iy, iz + 1, g_x01 * wx, gd);
  corner_d(T, ix, iy + 1, iz + 1, g_x11 * a, gd);
  corner_d(T, ix + 1, iy + 1, iz + 1, g_x11 * wx, gd);
  for (int k = 0; k < 3; ++k) gp[k] += gd[k];
}

// fbm (turbulence where turb) at p: its value, d/d omega, and g times its
// gradient in p added into gp (null: not wanted)
__device__ float fbm_vjp(const tex::Tables& T, const float p[3], float omega, int octaves,
                         bool turb, float g, float* d_omega, float* gp) {
  float total = 0.0f, o = 1.0f, do_ = 0.0f, dtot = 0.0f;
  for (int i = 0; i < tex::kMaxOctaves && i < octaves; ++i) {
    const float lam = tex::octave_lambda(i);
    const float n0 = tex::noise(T, p[0] * lam, p[1] * lam, p[2] * lam);
    const float n = turb ? fabsf(n0) : n0;
    total = total + o * n;
    dtot = dtot + do_ * n;
    if (gp != nullptr) {
      const float sgn = turb ? (n0 > 0.0f ? 1.0f : (n0 < 0.0f ? -1.0f : 0.0f)) : 1.0f;
      float gq[3] = {0.0f, 0.0f, 0.0f};
      noise_vjp(T, p[0] * lam, p[1] * lam, p[2] * lam, g * o * sgn, gq);
      for (int k = 0; k < 3; ++k) gp[k] += gq[k] * lam;
    }
    do_ = do_ * omega + o;
    o = o * omega;
  }
  if (d_omega != nullptr) *d_omega = dtot;
  return total;
}

// the bilinear fetch's VJP: g_img into the 4 texels; returns (g_u, g_v)
__device__ void atlas_vjp(const tex::Tables& T, const Grads& G, int y0, int hi, int wi,
                          int wrap, float u, float v, const float g[3], float* g_u, float* g_v) {
  const float h = static_cast<float>(hi), w = static_cast<float>(wi);
  const float uu = u * w - 0.5f;
  const float vv = (1.0f - v) * h - 0.5f;
  const float x0 = floorf(uu), y0f = floorf(vv);
  const float fx = uu - x0, fy = vv - y0f;
  const bool black =
      wrap == 2 && (uu < -0.5f || uu > w - 0.5f || vv < -0.5f || vv > h - 0.5f);
  float g_fx = 0.0f, g_fy = 0.0f;
  if (!black) {
    for (int dy = 0; dy < 2; ++dy) {
      for (int dx = 0; dx < 2; ++dx) {
        float xs = x0 + static_cast<float>(dx), ys = y0f + static_cast<float>(dy);
        if (wrap == 0) {
          float mx = fmodf(xs, w), my = fmodf(ys, h);
          if (mx != 0.0f && ((w < 0.0f) != (mx < 0.0f))) mx += w;
          if (my != 0.0f && ((h < 0.0f) != (my < 0.0f))) my += h;
          xs = mx;
          ys = my;
        } else {
          const float cx = tex::clamp_min(xs, 0.0f), cy = tex::clamp_min(ys, 0.0f);
          const float nx = w - 1.0f, ny = h - 1.0f;
          xs = cx > nx ? nx : cx;
          ys = cy > ny ? ny : cy;
        }
        const int col = tex::clampi(static_cast<int>(xs), 0, T.aw - 1);
        const int row = tex::clampi(static_cast<int>(ys) + y0, 0, T.ah - 1);
        const float wx = dx ? fx : (1.0f - fx), wy = dy ? fy : (1.0f - fy);
        const float wgt = wx * wy;
        const long long base = (static_cast<long long>(row) * T.aw + col) * 3;
        const float* texel = T.atlas + base;
        float g_w = 0.0f;
        for (int k = 0; k < 3; ++k) {
          if (G.atlas != nullptr && wgt * g[k] != 0.0f) atomicAdd(G.atlas + base + k, wgt * g[k]);
          g_w = g_w + g[k] * texel[k];
        }
        g_fx = g_fx + (dx ? g_w * wy : -(g_w * wy));
        g_fy = g_fy + (dy ? g_w * wx : -(g_w * wx));
      }
    }
  }
  *g_u = g_fx * w;
  *g_v = -(g_fy * h);
}

// the leaf texture id's VJP at the lane: g (3) into its parameters and
// the atlas (those of G that are not null), and with c into the lane's
// coordinates
__device__ void leaf_vjp(const tex::Tables& T, const Grads& G, int id, float uv0, float uv1,
                         const float p[3], bool with_width, float width, const float g[3],
                         Coord* c) {
  const float* tp = T.params + tex::kParams * id;
  const int type = T.type[id];
  const tex::Mapped m = tex::mapped_uv(tp, uv0, uv1);
  float g_u = 0.0f, g_v = 0.0f, g_su = 0.0f, g_sv = 0.0f;
  if ((type == tex::kFbm || type == tex::kWrinkled || type == tex::kMarble ||
       type == tex::kWindy) && tex::has(T, type)) {
    float pt[3];
    tex::xform_point(T.w2t + 16 * id, p, pt);
    const int octs = tex::clampi(static_cast<int>(tp[tex::kOctaves]), 1, tex::kMaxOctaves);
    const float omega = tp[tex::kOmega] == 0.0f ? 0.5f : tp[tex::kOmega];
    if (type == tex::kMarble) {
      const float scale_n = tp[tex::kScaleN] == 0.0f ? 1.0f : tp[tex::kScaleN];
      const float variation = tp[tex::kVariation];
      const float first[3] = {scale_n * pt[0], scale_n * pt[1], scale_n * pt[2]};
      const float f = tex::fbm(T, first, omega, octs, false);
      const float arg = first[1] + variation * f;
      const float t = sinf(arg) * 0.5f + 0.5f;
      const float tt = tex::clamp_max(tex::clamp_min(t, 0.0f), 0.999899983406066895f) * 6.0f;
      const int i = static_cast<int>(tt);
      const float ft = tt - static_cast<float>(i);
      const float a = 1.0f - ft;
      const float ds[4] = {-3.0f * a * a, 3.0f * a * a - 6.0f * ft * a, 6.0f * ft * a - 3.0f * ft * ft,
                           3.0f * ft * ft};
      const float* cm = T.marble + 3 * i;
      float g_ft = 0.0f;
      for (int k = 0; k < 3; ++k)
        g_ft = g_ft + 1.5f * g[k] * (ds[0] * cm[k] + ds[1] * cm[3 + k] + ds[2] * cm[6 + k] +
                                     ds[3] * cm[9 + k]);
      const bool inside = t > 0.0f && t < 0.999899983406066895f;
      const float g_arg = inside ? g_ft * 6.0f * 0.5f * cosf(arg) : 0.0f;
      add_param(G, id, tex::kVariation, g_arg * f);
      float g_first[3] = {0.0f, g_arg, 0.0f};
      float d_omega = 0.0f;
      fbm_vjp(T, first, omega, octs, false, g_arg * variation, &d_omega, g_first);
      if (tp[tex::kOmega] != 0.0f) add_param(G, id, tex::kOmega, g_arg * variation * d_omega);
      if (tp[tex::kScaleN] != 0.0f)
        add_param(G, id, tex::kScaleN, g_first[0] * pt[0] + g_first[1] * pt[1] + g_first[2] * pt[2]);
      if (c != nullptr) {
        const float g_pt[3] = {g_first[0] * scale_n, g_first[1] * scale_n, g_first[2] * scale_n};
        xform_point_vjp(T.w2t + 16 * id, p, g_pt, c->p);
      }
      return;
    }
    float f;
    const float g_f = g[0] * tp[tex::kValue] + g[1] * tp[tex::kValue + 1] +
                      g[2] * tp[tex::kValue + 2];
    float g_pt[3] = {0.0f, 0.0f, 0.0f};
    if (type == tex::kWindy) {
      const float pw[3] = {0.100000001490116119f * pt[0], 0.100000001490116119f * pt[1],
                           0.100000001490116119f * pt[2]};
      const float a = tex::fbm(T, pw, 0.5f, 3, false);
      const float b = tex::fbm(T, pt, 0.5f, 6, false);
      f = fabsf(a) * b;
      if (c != nullptr) {
        // |a| b: a's sign (0 at 0, as torch.abs) times b, and |a|
        const float sgn = a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : 0.0f);
        float g_pw[3] = {0.0f, 0.0f, 0.0f};
        fbm_vjp(T, pw, 0.5f, 3, false, g_f * b * sgn, nullptr, g_pw);
        fbm_vjp(T, pt, 0.5f, 6, false, g_f * fabsf(a), nullptr, g_pt);
        for (int k = 0; k < 3; ++k) g_pt[k] += 0.100000001490116119f * g_pw[k];
      }
    } else {
      float d_omega = 0.0f;
      f = fbm_vjp(T, pt, omega, octs, type == tex::kWrinkled, c != nullptr ? g_f : 0.0f,
                  &d_omega, c != nullptr ? g_pt : nullptr);
      if (tp[tex::kOmega] != 0.0f) add_param(G, id, tex::kOmega, g_f * d_omega);
    }
    for (int k = 0; k < 3; ++k) add_param(G, id, tex::kValue + k, f * g[k]);
    if (c != nullptr) xform_point_vjp(T.w2t + 16 * id, p, g_pt, c->p);
    return;
  }
  float g_width = 0.0f;
  if (type == tex::kUv && tex::has(T, tex::kUv)) {
    g_u = g[0];
    g_v = g[1];
  } else if (type == tex::kImageMap && tex::has(T, tex::kImageMap)) {
    const float gs = tp[tex::kGammaScale];
    const float gi[3] = {g[0] * gs, g[1] * gs, g[2] * gs};
    float img[3];
    if (with_width) {
      const float a = fabsf(m.su), b = fabsf(m.sv);
      const float smax = a < b ? b : a;
      const float weff = width * smax;
      tex::trilinear_lookup(T, id, m.u, m.v, weff, img);
      // the trilinear lookup's VJP: the two levels' fetches and the level
      const int nlv_i = T.nlv[id];
      const float nlv = static_cast<float>(nlv_i);
      const float raw = nlv - 1.0f + log2f(tex::clamp_min(weff, 1e-8f));
      const float top = tex::clamp_min(nlv - 1.0f, 0.0f);
      float level = tex::clamp_min(raw, 0.0f);
      level = level > top ? top : level;
      const int l0 = static_cast<int>(floorf(level));
      const int nl1 = nlv_i - 1 < 0 ? 0 : nlv_i - 1;
      const int l1 = l0 + 1 < nl1 ? l0 + 1 : nl1;
      const float f = level - static_cast<float>(l0);
      const int wrap = T.rect[4 * id + 3];
      const int* m0 = T.mip + (id * tex::kMaxLevels + l0) * 3;
      const int* m1 = T.mip + (id * tex::kMaxLevels + l1) * 3;
      float c0[3], c1[3];
      tex::atlas_lookup(T, m0[0], m0[1], m0[2], wrap, m.u, m.v, c0);
      tex::atlas_lookup(T, m1[0], m1[1], m1[2], wrap, m.u, m.v, c1);
      const float g0[3] = {gi[0] * (1.0f - f), gi[1] * (1.0f - f), gi[2] * (1.0f - f)};
      const float g1[3] = {gi[0] * f, gi[1] * f, gi[2] * f};
      float gu0, gv0, gu1, gv1;
      atlas_vjp(T, G, m0[0], m0[1], m0[2], wrap, m.u, m.v, g0, &gu0, &gv0);
      atlas_vjp(T, G, m1[0], m1[1], m1[2], wrap, m.u, m.v, g1, &gu1, &gv1);
      g_u = gu0 + gu1;
      g_v = gv0 + gv1;
      const float g_f = gi[0] * (c1[0] - c0[0]) + gi[1] * (c1[1] - c0[1]) + gi[2] * (c1[2] - c0[2]);
      if (raw > 0.0f && raw < top && weff > 1e-8f) {
        // the max's gradient goes to the larger scale, half to each at a
        // tie (as torch.maximum and jnp.maximum split it)
        const float g_weff = g_f / (weff * kLn2);
        const float g_smax = g_weff * width;
        g_width = g_weff * smax;
        const float g_a = a > b ? g_smax : (a == b ? 0.5f * g_smax : 0.0f);
        const float g_b = b > a ? g_smax : (a == b ? 0.5f * g_smax : 0.0f);
        g_su = m.su < 0.0f ? -g_a : g_a;
        g_sv = m.sv < 0.0f ? -g_b : g_b;
      }
    } else {
      const int* r = T.rect + 4 * id;
      tex::atlas_lookup(T, r[0], r[1], r[2], r[3], m.u, m.v, img);
      atlas_vjp(T, G, r[0], r[1], r[2], r[3], m.u, m.v, gi, &g_u, &g_v);
    }
    add_param(G, id, tex::kGammaScale, img[0] * g[0] + img[1] * g[1] + img[2] * g[2]);
  } else {
    for (int k = 0; k < 3; ++k) add_param(G, id, tex::kValue + k, g[k]);
    return;
  }
  // u = uv0 su + du, v = uv1 sv + dv; a scale of 0 reads as 1
  add_param(G, id, tex::kDu, g_u);
  add_param(G, id, tex::kDv, g_v);
  if (tp[tex::kSu] != 0.0f) add_param(G, id, tex::kSu, g_u * uv0 + g_su);
  if (tp[tex::kSv] != 0.0f) add_param(G, id, tex::kSv, g_v * uv1 + g_sv);
  if (c != nullptr) {
    c->u += g_u * m.su;
    c->v += g_v * m.sv;
    c->width += g_width;
  }
}

// eval_texture's VJP at the lane (c: null, or the lane's coordinates'
// gradients, added into)
__device__ void texture_vjp(const tex::Tables& T, const Grads& G, int id, float uv0, float uv1,
                            const float p[3], bool with_width, float width, const float g[3],
                            Coord* c) {
  if (id < 0) return;
  const int tid = id > T.n_tex - 1 ? T.n_tex - 1 : id;
  const int type = T.type[tid];
  if (type != tex::kScale && type != tex::kMix && type != tex::kChecker && type != tex::kDots) {
    leaf_vjp(T, G, tid, uv0, uv1, p, with_width, width, g, c);
    return;
  }
  const int c1 = tex::clampi(T.child[2 * tid], 0, T.n_tex - 1);
  const int c2 = tex::clampi(T.child[2 * tid + 1], 0, T.n_tex - 1);
  float v1[3], v2[3];
  tex::eval_leaf(T, c1, uv0, uv1, p, with_width, width, v1);
  tex::eval_leaf(T, c2, uv0, uv1, p, with_width, width, v2);
  const float* tp = T.params + tex::kParams * tid;
  float g1[3], g2[3];
  if (type == tex::kScale) {
    for (int k = 0; k < 3; ++k) {
      g1[k] = g[k] * v2[k];
      g2[k] = g[k] * v1[k];
    }
  } else if (type == tex::kMix) {
    const float amt = tp[tex::kValue];
    float g_amt = 0.0f;
    for (int k = 0; k < 3; ++k) {
      g1[k] = g[k] * (1.0f - amt);
      g2[k] = g[k] * amt;
      g_amt = g_amt + g[k] * (v2[k] - v1[k]);
    }
    add_param(G, tid, tex::kValue, g_amt);
  } else {
    // the child the lane shows: checker's parity, or inside a dot
    const tex::Mapped m = tex::mapped_uv(tp, uv0, uv1);
    bool first;
    if (type == tex::kChecker) {
      const long long s = static_cast<long long>(floorf(m.u)) +
                          static_cast<long long>(floorf(m.v));
      first = s % 2 == 0;
    } else {
      const float s_cell = floorf(m.u + 0.5f), t_cell = floorf(m.v + 0.5f);
      const bool has_dot = tex::noise(T, s_cell + 0.5f, t_cell + 0.5f, 0.0f + 0.5f) > 0.0f;
      const float cx = s_cell + 0.349999994039535522f *
                                    tex::noise(T, s_cell + 1.5f, t_cell + 2.79999995231628418f, 0.0f);
      const float cy = t_cell + 0.349999994039535522f *
                                    tex::noise(T, s_cell + 4.5f, t_cell + 9.80000019073486328f, 0.0f);
      first = has_dot && ((m.u - cx) * (m.u - cx) + (m.v - cy) * (m.v - cy) < tex::kDotRadius2);
    }
    for (int k = 0; k < 3; ++k) {
      g1[k] = first ? g[k] : 0.0f;
      g2[k] = first ? 0.0f : g[k];
    }
  }
  leaf_vjp(T, G, c1, uv0, uv1, p, with_width, width, g1, c);
  leaf_vjp(T, G, c2, uv0, uv1, p, with_width, width, g2, c);
}

struct Args {
  tex::Tables t;
  const int* ids;
  const float* uv;
  const float* p;
  const float* width;  // null: level 0
  const float* g_out;  // (rows, n, 3)
  int n, rows, per_row;
  Grads g;
};

__global__ void texture_grad_kernel(Args a) {
  __shared__ int perm[kPerm];
  for (int k = threadIdx.x; k < kPerm; k += blockDim.x) perm[k] = __ldg(a.t.perm + k);
  __syncthreads();
  const long long total = static_cast<long long>(a.rows) * a.n;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long j = i % a.n;
  const long long q = a.per_row ? i : j;
  tex::Tables T = a.t;
  T.perm = perm;
  T.marble = c_marble;
  const float g[3] = {a.g_out[3 * i], a.g_out[3 * i + 1], a.g_out[3 * i + 2]};
  if (g[0] == 0.0f && g[1] == 0.0f && g[2] == 0.0f) return;
  const float p[3] = {__ldg(a.p + 3 * q), __ldg(a.p + 3 * q + 1), __ldg(a.p + 3 * q + 2)};
  texture_vjp(T, a.g, __ldg(a.ids + i), __ldg(a.uv + 2 * q), __ldg(a.uv + 2 * q + 1), p,
              a.width != nullptr, a.width ? __ldg(a.width + j) : 0.0f, g, nullptr);
}

struct CoordArgs {
  tex::Tables t;
  const int* ids;
  const float* uv;
  const float* p;
  const float* width;  // null: level 0
  const float* g_out;  // (rows, n, 3)
  int n, rows, per_row;
  float* g_uv;  // (rows, n, 2) where per_row, else (n, 2)
  float* g_p;  // likewise (.., 3)
  float* g_width;  // (n,), null without a width
};

// T3: one thread a lane j, through every row of ids; each output entry
// written once
__global__ void texture_coord_grad_kernel(CoordArgs a) {
  __shared__ int perm[kPerm];
  for (int k = threadIdx.x; k < kPerm; k += blockDim.x) perm[k] = __ldg(a.t.perm + k);
  __syncthreads();
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= a.n) return;
  tex::Tables T = a.t;
  T.perm = perm;
  T.marble = c_marble;
  const Grads none{nullptr, nullptr};
  const bool with_width = a.width != nullptr;
  const float width = with_width ? __ldg(a.width + j) : 0.0f;
  Coord acc{0.0f, 0.0f, {0.0f, 0.0f, 0.0f}, 0.0f};
  for (int s = 0; s < a.rows; ++s) {
    const long long i = static_cast<long long>(s) * a.n + j;
    const long long q = a.per_row ? i : j;
    Coord c{0.0f, 0.0f, {0.0f, 0.0f, 0.0f}, 0.0f};
    const float g[3] = {a.g_out[3 * i], a.g_out[3 * i + 1], a.g_out[3 * i + 2]};
    if (g[0] != 0.0f || g[1] != 0.0f || g[2] != 0.0f) {
      const float p[3] = {__ldg(a.p + 3 * q), __ldg(a.p + 3 * q + 1), __ldg(a.p + 3 * q + 2)};
      texture_vjp(T, none, __ldg(a.ids + i), __ldg(a.uv + 2 * q), __ldg(a.uv + 2 * q + 1), p,
                  with_width, width, g, &c);
    }
    if (a.per_row) {
      a.g_uv[2 * q] = c.u;
      a.g_uv[2 * q + 1] = c.v;
      for (int k = 0; k < 3; ++k) a.g_p[3 * q + k] = c.p[k];
    } else {
      acc.u += c.u;
      acc.v += c.v;
      for (int k = 0; k < 3; ++k) acc.p[k] += c.p[k];
    }
    acc.width += c.width;
  }
  if (!a.per_row) {
    a.g_uv[2 * j] = acc.u;
    a.g_uv[2 * j + 1] = acc.v;
    for (int k = 0; k < 3; ++k) a.g_p[3 * j + k] = acc.p[k];
  }
  if (a.g_width != nullptr) a.g_width[j] = acc.width;
}

}  // namespace

// T1's tables and lanes (texture.cu rs_texture_eval), g_out (rows, n, 3)
// the upstream gradient; out g_params (X, 16) and g_atlas (AH, AW, 3),
// zeroed by the caller and added into.
extern "C" int rs_texture_grad(const void* type, const void* params, const void* child,
                               const void* w2t, const void* atlas, const void* rect,
                               const void* mip, const void* nlv, const void* perm, int n_tex,
                               int ah, int aw, int kind_mask, const void* ids, const void* uv,
                               const void* p, const void* width, int n, int rows, int per_row,
                               const void* g_out, void* g_params, void* g_atlas, void* stream) {
  const long long total = static_cast<long long>(rows) * n;
  if (total == 0) return 0;
  Args a;
  a.t = tex::Tables{static_cast<const int*>(type), static_cast<const float*>(params),
                    static_cast<const int*>(child), static_cast<const float*>(w2t),
                    static_cast<const float*>(atlas), static_cast<const int*>(rect),
                    static_cast<const int*>(mip), static_cast<const int*>(nlv),
                    static_cast<const int*>(perm), nullptr, n_tex, ah, aw, kind_mask};
  a.ids = static_cast<const int*>(ids);
  a.uv = static_cast<const float*>(uv);
  a.p = static_cast<const float*>(p);
  a.width = static_cast<const float*>(width);
  a.g_out = static_cast<const float*>(g_out);
  a.n = n;
  a.rows = rows;
  a.per_row = per_row;
  a.g = Grads{static_cast<float*>(g_params), static_cast<float*>(g_atlas)};
  const long long blocks = (total + kThreads - 1) / kThreads;
  texture_grad_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// T3: T1's tables and lanes, g_out (rows, n, 3) the upstream gradient; out
// g_uv and g_p (uv's and p's shapes) and g_width (n,) (null without a
// width), each entry written.
extern "C" int rs_texture_coord_grad(const void* type, const void* params, const void* child,
                                     const void* w2t, const void* atlas, const void* rect,
                                     const void* mip, const void* nlv, const void* perm,
                                     int n_tex, int ah, int aw, int kind_mask, const void* ids,
                                     const void* uv, const void* p, const void* width, int n,
                                     int rows, int per_row, const void* g_out, void* g_uv,
                                     void* g_p, void* g_width, void* stream) {
  if (n == 0 || rows == 0) return 0;
  CoordArgs a;
  a.t = tex::Tables{static_cast<const int*>(type), static_cast<const float*>(params),
                    static_cast<const int*>(child), static_cast<const float*>(w2t),
                    static_cast<const float*>(atlas), static_cast<const int*>(rect),
                    static_cast<const int*>(mip), static_cast<const int*>(nlv),
                    static_cast<const int*>(perm), nullptr, n_tex, ah, aw, kind_mask};
  a.ids = static_cast<const int*>(ids);
  a.uv = static_cast<const float*>(uv);
  a.p = static_cast<const float*>(p);
  a.width = static_cast<const float*>(width);
  a.g_out = static_cast<const float*>(g_out);
  a.n = n;
  a.rows = rows;
  a.per_row = per_row;
  a.g_uv = static_cast<float*>(g_uv);
  a.g_p = static_cast<float*>(g_p);
  a.g_width = static_cast<float*>(g_width);
  const long long blocks = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  texture_coord_grad_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
