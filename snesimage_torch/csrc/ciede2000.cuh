// CIEDE2000 colour difference on the card (Sharma et al. 2005): the
// standard formula of snesimage_tpu/ops/color.py `ciede2000`, step for step
// as snesimage_torch/ops/color.py computes it, so that a kernel and its
// plain twin round alike:
//   - every float32 product, sum and quotient is an explicit round-to-
//     nearest intrinsic, so the compiler fuses nothing the twin does not;
//     the twin's fused multiply-adds (`_fma`, XLA's CPU contractions) are
//     fmaf here;
//   - square roots are IEEE (sqrtf); arctangent, sines, cosines and the
//     exponential are taken in double and rounded once, as the twin does.
// Hue angles are in degrees in [0, 360): atan2 * 180/pi, plus 360 below
// zero (a floor-mod; fmodf would truncate toward zero).
//
// This is not the TPU kernels' algebraic-hue rewrite
// (snesimage_tpu/ops/pallas_dither.py `_ciede2000_planes`, which exists
// because Mosaic lowers no atan2, sin or cos, and differs from the standard
// formula by up to 2e-4): with one formula everywhere, the win masks built
// from a kernel's distance planes agree with the distance cache and the
// accepted palette map, which the torch code computes.
//
// Shared by kernels D (coarse_ciede.cu) and G (dither.cu); kernel F (ROADMAP
// queue B item 6) is to use it too.
#pragma once

#include <cuda_runtime.h>

namespace snes {

namespace ciede {

constexpr float kRad2Deg = 57.2957795130823208768f;  // float32(180 / pi)
constexpr float kDeg2Rad = 0.01745329251994329577f;  // float32(pi / 180)
constexpr float kPow25_7 = 6103515625.0f;            // float32(25 ** 7)
constexpr float kInv25 = 0.04f;                      // float32(1) / 25

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// max * sqrt(1 + (min / max)^2), JAX's hypot formula (not hypotf).
__device__ __forceinline__ float hypot_jax(float x, float y) {
  x = fabsf(x);
  y = fabsf(y);
  const float hi = fmaxf(x, y), lo = fminf(x, y);
  const float r = dvd(lo, hi == 0.0f ? 1.0f : hi);
  return hi == 0.0f ? hi : mul(hi, __fsqrt_rn(__fmaf_rn(r, r, 1.0f)));
}

__device__ __forceinline__ float pow7(float x) {
  const float x2 = mul(x, x);
  return mul(mul(x, x2), mul(x2, x2));
}

__device__ __forceinline__ float hue_deg(float b, float a) {
  const float h = mul(__double2float_rn(atan2((double)b, (double)a)), kRad2Deg);
  return h < 0.0f ? add(h, 360.0f) : h;
}

__device__ __forceinline__ float cos_deg(float deg) {
  return __double2float_rn(cos((double)mul(deg, kDeg2Rad)));
}

}  // namespace ciede

// CIEDE2000 between Lab colours (l1, a1, b1) and (l2, a2, b2).
__device__ __forceinline__ float ciede2000(float l1, float a1, float b1,
                                          float l2, float a2, float b2) {
  using namespace ciede;
  const float cbar = mul(0.5f, add(hypot_jax(a1, b1), hypot_jax(a2, b2)));
  const float cbar7 = pow7(cbar);
  const float g =
      mul(0.5f, sub(1.0f, __fsqrt_rn(dvd(cbar7, add(cbar7, kPow25_7)))));
  const float a1p = mul(add(1.0f, g), a1);
  const float a2p = mul(add(1.0f, g), a2);
  const float c1p = hypot_jax(a1p, b1);
  const float c2p = hypot_jax(a2p, b2);
  const float h1p = hue_deg(b1, a1p);
  const float h2p = hue_deg(b2, a2p);

  const bool prod_zero = mul(c1p, c2p) == 0.0f;
  const float hdiff = sub(h2p, h1p);
  float dhp;
  if (prod_zero) {
    dhp = 0.0f;
  } else if (fabsf(hdiff) <= 180.0f) {
    dhp = hdiff;
  } else {
    dhp = hdiff > 180.0f ? sub(hdiff, 360.0f) : add(hdiff, 360.0f);
  }
  const float dHp =
      mul(mul(2.0f, __fsqrt_rn(mul(c1p, c2p))),
          __double2float_rn(sin((double)mul(mul(dhp, kDeg2Rad), 0.5f))));

  const float lbar = mul(0.5f, add(l1, l2));
  const float cbarp = mul(0.5f, add(c1p, c2p));
  const float hsum = add(h1p, h2p);
  float hbarp;
  if (prod_zero) {
    hbarp = hsum;
  } else if (fabsf(sub(h1p, h2p)) <= 180.0f) {
    hbarp = mul(0.5f, hsum);
  } else {
    hbarp = hsum < 360.0f ? mul(0.5f, add(hsum, 360.0f))
                          : mul(0.5f, sub(hsum, 360.0f));
  }
  float t = __fmaf_rn(-0.17f, cos_deg(sub(hbarp, 30.0f)), 1.0f);
  t = __fmaf_rn(0.24f, cos_deg(mul(2.0f, hbarp)), t);
  t = __fmaf_rn(0.32f, cos_deg(__fmaf_rn(3.0f, hbarp, 6.0f)), t);
  t = __fmaf_rn(-0.20f, cos_deg(__fmaf_rn(4.0f, hbarp, -63.0f)), t);
  const float q = mul(sub(hbarp, 275.0f), kInv25);
  const float dtheta =
      mul(30.0f, __double2float_rn(exp((double)(-mul(q, q)))));
  const float cbarp7 = pow7(cbarp);
  const float rc =
      mul(2.0f, __fsqrt_rn(dvd(cbarp7, add(cbarp7, kPow25_7))));
  const float lm = sub(lbar, 50.0f);
  const float lm50 = mul(lm, lm);
  const float sl =
      add(1.0f, dvd(mul(0.015f, lm50), __fsqrt_rn(add(20.0f, lm50))));
  const float sc = __fmaf_rn(0.045f, cbarp, 1.0f);
  const float sh = __fmaf_rn(mul(0.015f, cbarp), t, 1.0f);
  const float rt = mul(
      -__double2float_rn(sin((double)mul(mul(2.0f, dtheta), kDeg2Rad))), rc);

  const float tl = dvd(sub(l2, l1), sl);
  const float tc = dvd(sub(c2p, c1p), sc);
  const float th = dvd(dHp, sh);
  const float s =
      __fmaf_rn(mul(rt, tc), th, __fmaf_rn(th, th, __fmaf_rn(tl, tl, mul(tc, tc))));
  return __fsqrt_rn(fmaxf(s, 0.0f));
}

}  // namespace snes
