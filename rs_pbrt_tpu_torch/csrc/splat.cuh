// The filter splat's per-lane math, R1's (splat.cu).
//
// A lane's F x F taps start at floor(p_film - 0.5 - (width - 0.5)); the
// tap at pixel (px, py) weighs f(px + 0.5 - p.x) * f(py + 0.5 - p.y), the
// filter's two factors (ops/film.py filter_eval, the JAX package's
// ops/film.py:52, whose every kind is such a product: the box and the
// support test as 0/1 factors).  Each factor's ops are the plain version's
// in their order, each f32 op rounded alone (--fmad=false), with the
// host's constants rounded to f32 where the JAX expressions round them.
// A factor is 0 outside its axis's support, so a tap outside the support
// weighs +-0 (adds nothing) where the plain version's weighs +0.  RS_HD
// marks the functions: device and inline unless the includer defines it.
#pragma once

#include <math.h>

#ifndef RS_HD
#define RS_HD __device__ __forceinline__
#endif

namespace splat {

constexpr int kMaxTaps = 16;  // ops/splat_kernel.py MAX_TAPS: footprint at most 16
enum { kBox = 0, kTriangle, kGaussian, kMitchell, kSinc };  // the FILTER_* tags
constexpr int kConsts = 16;
// The filter constants (ops/splat_kernel.filter_consts), in this order
enum { kXw = 0, kYw, kOffX, kOffY, kNegAlpha, kGx, kGy, kMa, kMb, kMc, kMd, kMe, kMf, kMg,
       kSixth, kTau };

RS_HD float max_nan(float a, float b) { return (a != a || b != b) ? a + b : (b > a ? b : a); }

// jnp.maximum(0, v)
RS_HD float relu(float v) { return max_nan(0.0f, v); }

RS_HD float mitchell_1d(const float* c, float v) {
  const float x = fabsf(2.0f * v);
  const float x2 = x * x;
  const float x3 = x * x2;
  const float big = (c[kMa] * x3 + c[kMb] * x2 + c[kMc] * x + c[kMd]) * c[kSixth];
  const float small = (c[kMe] * x3 + c[kMf] * x2 + c[kMg]) * c[kSixth];
  return x > 1.0f ? (x < 2.0f ? big : 0.0f) : small;
}

RS_HD float sinc_s(float v) {
  const float pv = 3.14159265358979323846f * v;
  return v < 1e-5f ? 1.0f : sinf(pv) / pv;
}

RS_HD float sinc_1d(const float* c, float v) {
  const float x = fabsf(v);
  const float lanczos = sinc_s(x) * sinc_s(x / c[kTau]);
  return x > c[kTau] ? 0.0f : lanczos;
}

// The factor of the axis of half-width `width` at offset x, 0 outside the
// support; axis 0 (x) or 1 (y) picks the Gaussian's constant.
RS_HD float factor(int kind, const float* c, int axis, float x) {
  const float width = c[kXw + axis];
  const float ax = fabsf(x);
  switch (kind) {
    case kBox:  // half-open support (film.rs knife-edge note in ops/film.py)
      return (x > -width && x <= width) ? 1.0f : 0.0f;
    case kTriangle:
      return ax <= width ? relu(width - ax) : 0.0f;
    case kGaussian:
      return ax <= width ? relu(expf(c[kNegAlpha] * x * x) - c[kGx + axis]) : 0.0f;
    case kMitchell:
      return ax <= width ? mitchell_1d(c, x / width) : 0.0f;
    default:
      return ax <= width ? sinc_1d(c, x / width) : 0.0f;
  }
}

// The first tap's pixel on one axis: floor((p - 0.5) - (width - 0.5))
RS_HD int first_tap(float p, float off) { return static_cast<int>(floorf((p - 0.5f) - off)); }

// A tap's offset: (px + 0.5) - p
RS_HD float tap_offset(int px, float p) { return (static_cast<float>(px) + 0.5f) - p; }

}  // namespace splat
