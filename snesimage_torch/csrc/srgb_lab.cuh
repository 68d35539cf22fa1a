// 8-bit sRGB -> CIELAB (D65) on the card, step for step as
// snesimage_torch/ops/color.py `srgb_u8_to_lab` computes it, so that a
// kernel and its plain twin round alike:
//   - the linear value of each channel comes from the exact 256-entry table;
//   - the X and Y rows of the 3x3 matrix are ((m0 v0 + m1 v1) + m2 v2) with
//     every step rounded, the Z row a chain of two fused multiply-adds
//     (`_mat3`: what XLA's CPU code does to the JAX package's dot);
//   - the division by the white point is a product with its float32
//     reciprocal;
//   - the cube root is a double pow with the float32 exponent 1/3, rounded
//     once (`_powf`).
// The constants arrive from Python (snesimage_torch/ops/_kernels.py
// `lab_params`), computed by the functions the twin uses.
#pragma once

#include <cuda_runtime.h>

namespace snes {

// Mirror of snesimage_torch.ops._kernels.LabParams.
struct LabParams {
  float lut[256];        // exact sRGB decode of the 256 codes
  float m[9];            // RGB -> XYZ, row-major
  float inv_white[3];    // float32(1) / white point
  float delta3;          // (6/29)^3
  float third;           // float32(1/3), the pow exponent
  float lin_slope;       // float32(1) / float32(3 (6/29)^2)
  float lin_offset;      // 4/29
};

namespace lab {

__device__ __forceinline__ float f(const LabParams& p, float t) {
  return t > p.delta3
             ? __double2float_rn(pow((double)t, (double)p.third))
             : __fmaf_rn(t, p.lin_slope, p.lin_offset);
}

}  // namespace lab

// `lut` is a copy of p.lut that threads may index freely (shared memory).
__device__ __forceinline__ void srgb_u8_to_lab(const LabParams& p,
                                               const float* lut, int r, int g,
                                               int b, float& out_l,
                                               float& out_a, float& out_b) {
  const float v0 = lut[r], v1 = lut[g], v2 = lut[b];
  const float x = __fadd_rn(
      __fadd_rn(__fmul_rn(p.m[0], v0), __fmul_rn(p.m[1], v1)),
      __fmul_rn(p.m[2], v2));
  const float y = __fadd_rn(
      __fadd_rn(__fmul_rn(p.m[3], v0), __fmul_rn(p.m[4], v1)),
      __fmul_rn(p.m[5], v2));
  const float z =
      __fmaf_rn(p.m[8], v2, __fmaf_rn(p.m[7], v1, __fmul_rn(p.m[6], v0)));
  const float fx = lab::f(p, __fmul_rn(x, p.inv_white[0]));
  const float fy = lab::f(p, __fmul_rn(y, p.inv_white[1]));
  const float fz = lab::f(p, __fmul_rn(z, p.inv_white[2]));
  out_l = __fmaf_rn(116.0f, fy, -16.0f);
  out_a = __fmul_rn(500.0f, __fsub_rn(fx, fy));
  out_b = __fmul_rn(200.0f, __fsub_rn(fy, fz));
}

}  // namespace snes
