// The Fourier BSDF's per-lane math, shared by F1 and F2 (fourier.cu).
//
// Each function computes the plain versions' ops (ops/fourier_bsdf.py) in
// their order, one lane at a time: with --fmad=false and no fast math each
// product and sum rounds alone and sqrtf, division, sinf and cosf are the
// IEEE-accurate ones torch's CUDA ops call.  Clamps keep NaN, as
// torch.clamp does.  RS_HD marks the functions: device and inline unless
// the includer defines it.
#pragma once

#ifndef RS_HD
#define RS_HD __device__ __forceinline__
#endif

namespace fou {

constexpr int kMCap = 64;  // M_CAP, the orders a channel keeps
constexpr int kRow = 3 * kMCap;  // a cell's dense row: y, r, b
constexpr int kMuSteps = 12;  // NEWTON_MU_STEPS
constexpr int kPhiSteps = 20;  // NEWTON_PHI_STEPS
constexpr float kPi = 3.14159274101257324f;  // pi as float32
constexpr float kTwoPi = 6.28318548202514648f;
constexpr float kHalfPi = 1.57079637050628662f;
constexpr float kThird = 0.333333343267440796f;

struct Table {
  const float* mu;  // (MU,) nodes
  const float* dense;  // (MU*MU, kRow)
  const int* m;  // (MU*MU,) orders
  const float* cdf;  // (MU, MU)
  const float* a0;  // (MU, MU)
  int n_mu;
  float eta;
};

RS_HD float clamp_min(float x, float lo) { return x < lo ? lo : x; }
RS_HD float clamp_max(float x, float hi) { return x > hi ? hi : x; }
RS_HD float clampf(float x, float lo, float hi) { return clamp_max(clamp_min(x, lo), hi); }
RS_HD int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

// _cr_weights: the Catmull-Rom weights of x on the sorted nodes; off is the
// first tap's index (the interval's start - 1); the interval is the count
// of nodes <= x (an upper bound by bisection).
RS_HD bool cr_weights(const float* nodes, int K, float x, int* off, float w[4]) {
  const bool valid = (x >= nodes[0]) && (x <= nodes[K - 1]);
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (nodes[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  const int idx = clampi(lo - 1, 0, K - 2);
  const float x0 = nodes[idx], x1 = nodes[idx + 1];
  const float t = (x - x0) / clamp_min(x1 - x0, 1e-20f);
  const float t2 = t * t;
  const float t3 = t2 * t;
  const float w1b = 2.0f * t3 - 3.0f * t2 + 1.0f;
  const float w2b = -2.0f * t3 + 3.0f * t2;
  const float xm1 = nodes[idx - 1 < 0 ? 0 : idx - 1];
  const float xp2 = nodes[idx + 2 > K - 1 ? K - 1 : idx + 2];
  const float w0_i = (t3 - 2.0f * t2 + t) * (x1 - x0) / clamp_min(x1 - xm1, 1e-20f);
  const float w3_i = (t3 - t2) * (x1 - x0) / clamp_min(xp2 - x0, 1e-20f);
  const bool at_lo = idx == 0, at_hi = idx + 2 >= K;
  const float w0b = t3 - 2.0f * t2 + t;
  const float w3b = t3 - t2;
  w[0] = at_lo ? 0.0f : -w0_i;
  w[1] = w1b - (at_lo ? w0b : 0.0f) - (at_hi ? w3b : w3_i);
  w[2] = w2b + (at_lo ? w0b : w0_i) + (at_hi ? w3b : 0.0f);
  w[3] = at_hi ? 0.0f : w3_i;
  *off = idx - 1;
  return valid;
}

// The 16 cells at (mu_i, mu_o), o-tap major: their rows, their weights
// (wi4[a] wo4[b]) and the largest order among them.
struct Cells {
  int cell[16];
  float w[16];
  int m_max;
};

RS_HD bool cells_at(const Table& T, float mu_i, float mu_o, Cells* c) {
  int off_i, off_o;
  float wi4[4], wo4[4];
  const bool ok_i = cr_weights(T.mu, T.n_mu, mu_i, &off_i, wi4);
  const bool ok_o = cr_weights(T.mu, T.n_mu, mu_o, &off_o, wo4);
  c->m_max = 0;
  for (int b = 0; b < 4; ++b) {
    const int row_o = clampi(off_o + b, 0, T.n_mu - 1);
    for (int a = 0; a < 4; ++a) {
      const int row_i = clampi(off_i + a, 0, T.n_mu - 1);
      const int k = b * 4 + a;
      c->w[k] = wi4[a] * wo4[b];
      c->cell[k] = row_o * T.n_mu + row_i;
      const int m = T.m[c->cell[k]];
      c->m_max = m > c->m_max ? m : c->m_max;
    }
  }
  if (c->m_max > kMCap) c->m_max = kMCap;
  return ok_i && ok_o;
}

// One order's coefficient of channel ch: the 16 taps summed in order.  The
// dense rows are zero beyond a cell's order, so orders at or above m_max
// add nothing to a finite sum and the callers stop there.
RS_HD float coeff(const Table& T, const Cells& c, int ch, int k) {
  float acc = 0.0f;
  for (int j = 0; j < 16; ++j) acc = acc + c.w[j] * T.dense[c.cell[j] * kRow + ch * kMCap + k];
  return acc;
}

RS_HD float cos_d_phi(float ax, float ay, float bx, float by) {
  const float waxy = ax * ax + ay * ay;
  const float wbxy = bx * bx + by * by;
  const float num = ax * bx + ay * by;
  const float den = sqrtf(clamp_min(waxy * wbxy, 1e-20f));
  return (waxy > 0.0f && wbxy > 0.0f) ? clampf(num / den, -1.0f, 1.0f) : 1.0f;
}

// F1's lane: fourier_f (rgb) and fourier_pdf at (wo, wi).
RS_HD void eval_lane(const Table& T, const float wo[3], const float wi[3], float f[3],
                     float* pdf) {
  const float mu_i = -wi[2], mu_o = wo[2];
  const float cos_phi = cos_d_phi(-wi[0], -wi[1], wo[0], wo[1]);
  Cells c;
  if (!cells_at(T, mu_i, mu_o, &c)) {
    f[0] = f[1] = f[2] = 0.0f;
    *pdf = 0.0f;
    return;
  }
  float cos_km1 = cos_phi, cos_k = 1.0f, y = 0.0f, r = 0.0f, bl = 0.0f;
  for (int k = 0; k < c.m_max; ++k) {
    y = y + coeff(T, c, 0, k) * cos_k;
    r = r + coeff(T, c, 1, k) * cos_k;
    bl = bl + coeff(T, c, 2, k) * cos_k;
    const float next = 2.0f * cos_phi * cos_k - cos_km1;
    cos_km1 = cos_k;
    cos_k = next;
  }
  y = clamp_min(y, 0.0f);
  const float g = 1.39829f * y - 0.100913f * bl - 0.297375f * r;
  float scale = mu_i != 0.0f ? 1.0f / clamp_min(fabsf(mu_i), 1e-20f) : 0.0f;
  const float eta = mu_i > 0.0f ? 1.0f / T.eta : T.eta;
  scale = scale * (mu_i * mu_o > 0.0f ? eta * eta : 1.0f);
  f[0] = clamp_min(r * scale, 0.0f);
  f[1] = clamp_min(g * scale, 0.0f);
  f[2] = clamp_min(bl * scale, 0.0f);
  int off_o;
  float wo4[4];
  cr_weights(T.mu, T.n_mu, mu_o, &off_o, wo4);
  float rho = 0.0f;
  for (int b = 0; b < 4; ++b) {
    const int row = clampi(off_o + b, 0, T.n_mu - 1);
    rho = rho + wo4[b] * T.cdf[row * T.n_mu + T.n_mu - 1] * kTwoPi;
  }
  *pdf = rho > 0.0f ? y / clamp_min(rho, 1e-20f) : 0.0f;
}

// The row of a (MU, MU) table at mu_o, spline-interpolated: entry j.
RS_HD float row_at(const Table& T, const float* tab, const int rows[4], const float wo4[4], int j) {
  float out = wo4[0] * tab[rows[0] * T.n_mu + j];
  for (int b = 1; b < 4; ++b) out = out + wo4[b] * tab[rows[b] * T.n_mu + j];
  return out;
}

// F2's lane: the direction wi that fourier_sample draws at (wo, u2).  Its
// pdf and f at wi are F1's (bsdf_sample reads only wi, as in the JAX
// package).
RS_HD void sample_lane(const Table& T, const float wo[3], float u0, float u1, float wi[3]) {
  const int MU = T.n_mu;
  const float mu_o = wo[2];
  int off_o, rows[4];
  float wo4[4];
  cr_weights(T.mu, MU, mu_o, &off_o, wo4);
  for (int b = 0; b < 4; ++b) rows[b] = clampi(off_o + b, 0, MU - 1);
  // invert the interpolated cdf along mu_i: the interval is the count of
  // entries <= u (the rows need not be monotone)
  const float maximum = row_at(T, T.cdf, rows, wo4, MU - 1);
  const float uu = u1 * maximum;
  int cnt = 0;
  for (int j = 0; j < MU; ++j) cnt += row_at(T, T.cdf, rows, wo4, j) <= uu ? 1 : 0;
  const int idx = clampi(cnt - 1, 0, MU - 2);
  auto val = [&](int j) { return row_at(T, T.a0, rows, wo4, clampi(j, 0, MU - 1)); };
  const float f0 = val(idx), f1 = val(idx + 1);
  const float x0 = T.mu[idx], x1 = T.mu[idx + 1];
  const float width = x1 - x0;
  const float u_loc = (uu - row_at(T, T.cdf, rows, wo4, idx)) / clamp_min(width, 1e-20f);
  const float fm1 = val(idx - 1), f2 = val(idx + 2);
  const float xm1 = T.mu[idx - 1 < 0 ? 0 : idx - 1];
  const float xp2 = T.mu[idx + 2 > MU - 1 ? MU - 1 : idx + 2];
  const float d0 = idx > 0 ? width * (f1 - fm1) / clamp_min(x1 - xm1, 1e-20f) : f1 - f0;
  const float d1 = idx + 2 < MU ? width * (f2 - f0) / clamp_min(xp2 - x0, 1e-20f) : f1 - f0;
  const bool sloped = fabsf(f0 - f1) > 1e-20f;
  float t = sloped ? (f0 - sqrtf(clamp_min(f0 * f0 + 2.0f * u_loc * (f1 - f0), 0.0f))) / (f0 - f1)
                   : u_loc / clamp_min(f0, 1e-20f);
  float a_b = 0.0f, b_b = 1.0f, fhat = f0;
  for (int s = 0; s < kMuSteps; ++s) {
    t = (t >= a_b && t <= b_b) ? t : 0.5f * (a_b + b_b);
    const float f_hat =
        t * (f0 + t * (0.5f * d0 + t * (kThird * (-2.0f * d0 - d1) + f1 - f0 +
                                        t * (0.25f * (d0 + d1) + 0.5f * (f0 - f1)))));
    fhat = f0 + t * (d0 + t * (-2.0f * d0 - d1 + 3.0f * (f1 - f0) +
                               t * (d0 + d1 + 2.0f * (f0 - f1))));
    const bool below = f_hat < u_loc;
    a_b = below ? t : a_b;
    b_b = below ? b_b : t;
    t = t - (f_hat - u_loc) / (fabsf(fhat) < 1e-12f ? 1e-12f : fhat);
  }
  const float mu_i = x0 + width * clampf(t, 0.0f, 1.0f);

  // the luminance coefficients at (mu_i, mu_o) and the inversion in phi
  Cells c;
  cells_at(T, mu_i, mu_o, &c);
  float aky[kMCap], rk[kMCap];
  for (int k = 0; k < c.m_max; ++k) aky[k] = coeff(T, c, 0, k);
  const float a0c = c.m_max > 0 ? aky[0] : coeff(T, c, 0, 0);
  for (int k = 1; k < c.m_max; ++k) rk[k] = aky[k] * (1.0f / static_cast<float>(k));
  const float u = u0;
  const bool flip = u >= 0.5f;
  const float u_side = flip ? 1.0f - 2.0f * (u - 0.5f) : 2.0f * u;
  float a_ph = 0.0f, b_ph = kPi, phi = kHalfPi;
  for (int s = 0; s < kPhiSteps; ++s) {
    const float cp = cosf(phi);
    const float sp = sqrtf(clamp_min(1.0f - cp * cp, 0.0f));
    float sin_prev = -sp, sin_cur = 0.0f, cos_prev = cp, cos_cur = 1.0f;
    float cf = a0c * phi, fd = a0c + 0.0f;
    for (int k = 1; k < c.m_max; ++k) {
      const float sin_next = 2.0f * cp * sin_cur - sin_prev;
      const float cos_next = 2.0f * cp * cos_cur - cos_prev;
      cf = cf + rk[k] * sin_next;
      fd = fd + aky[k] * cos_next;
      sin_prev = sin_cur;
      sin_cur = sin_next;
      cos_prev = cos_cur;
      cos_cur = cos_next;
    }
    cf = cf - u_side * a0c * kPi;
    const bool pos = cf > 0.0f;
    b_ph = pos ? phi : b_ph;
    a_ph = pos ? a_ph : phi;
    const float phi_n = phi - cf / (fabsf(fd) < 1e-12f ? 1e-12f : fd);
    phi = (phi_n > a_ph && phi_n < b_ph) ? phi_n : 0.5f * (a_ph + b_ph);
  }
  phi = flip ? kTwoPi - phi : phi;

  // the scattered direction (reflection.rs:1662-1692)
  const float sin2_i = clamp_min(1.0f - mu_i * mu_i, 0.0f);
  const float sin2_o = 1.0f - mu_o * mu_o;
  float norm = sqrtf(sin2_i / clamp_min(sin2_o, 1e-20f));
  norm = sin2_o <= 0.0f ? 0.0f : norm;
  const float sp = sinf(phi), cp = cosf(phi);
  const float w0 = -(norm * (cp * wo[0] - sp * wo[1]));
  const float w1 = -(norm * (sp * wo[0] + cp * wo[1]));
  const float w2 = -mu_i;
  const float len = clamp_min(sqrtf(w0 * w0 + w1 * w1 + w2 * w2), 1e-20f);
  wi[0] = w0 / len;
  wi[1] = w1 / len;
  wi[2] = w2 / len;
}

}  // namespace fou
