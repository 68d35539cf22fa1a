// Device functions shared by the SSIMULACRA2 feature kernels (kernel B,
// multiscale.cu, and kernels C and D, coarse_redmean.cu and coarse_ciede.cu).
//
// Semantics are those of snesimage_tpu/ops/ssimulacra2.py's XLA path:
//   2x2 box means between scales, an odd side's last row or column
//   replicated first (downsample2), so a pyramid need not halve exactly;
//   linear RGB -> positive XYB (cbrtf, like jnp.cbrt);
//   17-tap FIR Gaussian blur with zero padding and no renormalisation at
//   the border (the banded matrices B_h . T . B_w of _blur_matrix);
//   SSIM, artifact and detail-loss maps against the reference planes;
//   raw sums of d and d^4 per (scale, channel): the division by the pixel
//   count and the fourth root stay in torch (finalize_feature_sums).
// Every sum is reduced in a fixed order (no float atomics), so two runs
// give the same bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace snes {

constexpr int kRadius = 8;
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kMaxScales = 6;
// Planes of at most this many pixels (64 x 64) run block-resident in
// shared memory; larger ones take the tiled pass of multiscale.cu.
constexpr int kResidentMaxPixels = 64 * 64;
constexpr int kResidentThreads = 512;

// Host-computed constants, passed by value to every metric kernel.
struct MetricParams {
  float taps[kTaps];
  float opsin[9];  // row-major 3x3 opsin absorbance matrix
  float bias;
  float cbrt_bias;
  float x_scale;
  float x_offset;
  float y_offset;
  float b_offset;
  float ssim_c2;
};

// Reference planes (img1, mu1, s11) of each pyramid scale, each
// (N, 3, h, w) float32 channel-major, plus the scale's size.
struct RefPyramid {
  const float* img1[kMaxScales];
  const float* mu1[kMaxScales];
  const float* s11[kMaxScales];
  int h[kMaxScales];
  int w[kMaxScales];
  // Floats from one image's planes of a scale to the next image's: 3 h w
  // for a pyramid per image, 0 for one pyramid that every image shares.
  long long img_stride[kMaxScales];
};

__device__ __forceinline__ void positive_xyb(const MetricParams& p, float r,
                                             float g, float b, float* out) {
  float lms[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float mixed = p.opsin[3 * i] * r + p.opsin[3 * i + 1] * g +
                  p.opsin[3 * i + 2] * b + p.bias;
    lms[i] = cbrtf(mixed) - p.cbrt_bias;
  }
  float xr = 0.5f * (lms[0] - lms[1]);
  float yr = 0.5f * (lms[0] + lms[1]);
  out[0] = xr * p.x_scale + p.x_offset;
  out[1] = yr + p.y_offset;
  out[2] = (lms[2] - yr) + p.b_offset;
}

// One pixel's contribution to the six raw moments
// [ssim, art, det, ssim^4, art^4, det^4].
__device__ __forceinline__ void accumulate_moments(float x1, float m1, float v1,
                                                   float x2, float mu2,
                                                   float s22, float s12,
                                                   float c2, float acc[6]) {
  float mu_diff = m1 - mu2;
  float num_m = 1.0f - mu_diff * mu_diff;
  float num_s = 2.0f * (s12 - m1 * mu2) + c2;
  float denom_s = (v1 - m1 * m1) + (s22 - mu2 * mu2) + c2;
  float ssim_d = fmaxf(1.0f - (num_m * num_s) / denom_s, 0.0f);
  float d1 = (1.0f + fabsf(x2 - mu2)) / (1.0f + fabsf(x1 - m1)) - 1.0f;
  float art = fmaxf(d1, 0.0f);
  float det = fmaxf(-d1, 0.0f);
  acc[0] += ssim_d;
  acc[1] += art;
  acc[2] += det;
  float s2 = ssim_d * ssim_d, a2 = art * art, e2 = det * det;
  acc[3] += s2 * s2;
  acc[4] += a2 * a2;
  acc[5] += e2 * e2;
}

// Sums acc[6] over the block in a fixed order; the result is valid on
// thread 0. `red` holds 6 floats per warp. Ends with a barrier, so shared
// memory may be reused right after.
__device__ __forceinline__ void block_reduce6(float acc[6], float* red,
                                              float out[6]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) red[warp * 6 + k] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      float s = 0.0f;
      for (int w = 0; w < n_warps; ++w) s += red[w * 6 + k];
      out[k] = s;
    }
  }
  __syncthreads();
}

// Size of a plane's side after one 2x2 mean: an odd side's last row or
// column is replicated first (ops/ssimulacra2.py `downsample2`).
__host__ __device__ constexpr int half_up(int n) { return (n + 1) / 2; }

// The 2x2 mean at (y, x) of the h x w plane `src`, the last row or column
// of an odd side averaged with itself.
__device__ __forceinline__ float ds2_at(const float* src, int h, int w, int y,
                                        int x) {
  const int y0 = 2 * y, x0 = 2 * x;
  const int y1 = min(y0 + 1, h - 1), x1 = min(x0 + 1, w - 1);
  return (src[y0 * w + x0] + src[y0 * w + x1] + src[y1 * w + x0] +
          src[y1 * w + x1]) * 0.25f;
}

}  // namespace snes
