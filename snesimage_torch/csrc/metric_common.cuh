// Device functions shared by the SSIMULACRA2 feature kernels (kernel B,
// multiscale.cu, and kernel C, coarse_redmean.cu).
//
// Semantics are those of snesimage_tpu/ops/ssimulacra2.py's XLA path:
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

// Shared-memory floats `resident_scales` needs for a first plane of
// `pixels` pixels: linear RGB, its 2x2 downsample, XYB, and the three
// horizontally blurred fields.
__host__ __device__ constexpr int resident_smem_floats(int pixels) {
  return 3 * pixels + 3 * (pixels / 4) + 3 * pixels + 3 * pixels;
}

// Runs scales [0, n_scales) of one frame whose first-scale linear RGB
// planes (3 x h x w) sit at the start of `smem`, entirely in shared
// memory, and writes the raw moments of scale s, channel c to
// out[s * 18 + c * 6 + k]. Reference planes of scale s are
// refs.*[first_ref + s] of image `img`. All threads of the block call it.
static __device__ void resident_scales(float* smem, int h, int w, int n_scales,
                                const RefPyramid& refs, int first_ref,
                                int img, const MetricParams& p, float* red,
                                float* out) {
  const int p0 = h * w;
  float* cur = smem;
  float* nxt = smem + 3 * p0;
  float* xyb = nxt + 3 * (p0 / 4);
  float* hb = xyb + 3 * p0;
  for (int s = 0; s < n_scales; ++s) {
    if (s) {
      const int h2 = h / 2, w2 = w / 2;
      for (int i = threadIdx.x; i < 3 * h2 * w2; i += blockDim.x) {
        const int c = i / (h2 * w2), r = i % (h2 * w2);
        const int y = r / w2, x = r % w2;
        const float* src = cur + c * h * w + (2 * y) * w + 2 * x;
        nxt[i] = (src[0] + src[1] + src[w] + src[w + 1]) * 0.25f;
      }
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
      h = h2;
      w = w2;
    }
    const int n_px = h * w;
    for (int i = threadIdx.x; i < n_px; i += blockDim.x) {
      float v[3];
      positive_xyb(p, cur[i], cur[n_px + i], cur[2 * n_px + i], v);
      xyb[i] = v[0];
      xyb[n_px + i] = v[1];
      xyb[2 * n_px + i] = v[2];
    }
    __syncthreads();
    const int rs = first_ref + s;
    for (int c = 0; c < 3; ++c) {
      const size_t plane = ((size_t)img * 3 + c) * n_px;
      const float* x1g = refs.img1[rs] + plane;
      const float* m1g = refs.mu1[rs] + plane;
      const float* v1g = refs.s11[rs] + plane;
      const float* x2 = xyb + c * n_px;
      for (int i = threadIdx.x; i < n_px; i += blockDim.x) {
        const int y = i / w, x = i % w;
        float a = 0.0f, b = 0.0f, cc = 0.0f;
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          const int xx = x + k - kRadius;
          if (xx >= 0 && xx < w) {
            const float v2 = x2[y * w + xx];
            const float v1 = x1g[y * w + xx];
            a += p.taps[k] * v2;
            b += p.taps[k] * (v2 * v2);
            cc += p.taps[k] * (v1 * v2);
          }
        }
        hb[i] = a;
        hb[n_px + i] = b;
        hb[2 * n_px + i] = cc;
      }
      __syncthreads();
      float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int i = threadIdx.x; i < n_px; i += blockDim.x) {
        const int y = i / w, x = i % w;
        float mu2 = 0.0f, s22 = 0.0f, s12 = 0.0f;
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          const int yy = y + k - kRadius;
          if (yy >= 0 && yy < h) {
            mu2 += p.taps[k] * hb[yy * w + x];
            s22 += p.taps[k] * hb[n_px + yy * w + x];
            s12 += p.taps[k] * hb[2 * n_px + yy * w + x];
          }
        }
        accumulate_moments(x1g[i], m1g[i], v1g[i], x2[i], mu2, s22, s12,
                           p.ssim_c2, acc);
      }
      float tot[6];
      block_reduce6(acc, red, tot);
      if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < 6; ++k) out[s * 18 + c * 6 + k] = tot[k];
      }
    }
  }
}

}  // namespace snes
