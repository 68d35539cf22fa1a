// Kernel B: raw SSIMULACRA2 feature sums of several consecutive pyramid
// scales for a batch of candidate frames.
//
// Replaces snesimage_tpu/ops/pallas_metric.py _multiscale_feature_sums_n
// (pallas_call at :275, tile _scales_feature_tile :142-191). The TPU
// kernel keeps a whole frame in VMEM; a 256x256 scale-0 frame (768 KB of
// linear RGB) does not fit in one SM's 227 KB of shared memory, so here
//   - planes larger than 64x64 take a tiled pass: one block per (frame,
//     channel, 32x32 tile) loads its tile plus an 8-pixel halo, converts
//     to XYB, blurs x2, x2^2 and x1*x2 horizontally then vertically in
//     shared memory and writes six partial sums; a second small kernel
//     adds the tiles' partials in a fixed order;
//   - planes of 64x64 and smaller run block-resident (resident_scales in
//     metric_common.cuh, shared with kernel C), one block per frame;
//   - pre_ds and between-scale 2x2 means run as a separate elementwise
//     kernel into scratch the wrapper allocates.
// What bounds it on the card: the blur's 2 x 17 multiply-adds per field
// and pixel (about 1.3e8 FLOP for the eight 128x128 finalists) and, for
// small batches, too few blocks to fill 132 SMs. Every frame's input is
// read once from device memory; reference planes are re-read per channel
// block and stay in L2.
#include "metric_common.cuh"

namespace snes {

constexpr int kTile = 32;
constexpr int kRegion = kTile + 2 * kRadius;  // 48
constexpr int kTiledThreads = 256;

// lin: (M, 3, h, w) linear RGB frames; refs (N, 3, h, w); frame m belongs
// to image m / frames_per_image. partial: (M, 3, n_tiles, 6).
// Grid: (n_tiles, 3, M).
__global__ void __launch_bounds__(kTiledThreads)
tiled_scale_kernel(const float* __restrict__ lin,
                   const float* __restrict__ img1,
                   const float* __restrict__ mu1,
                   const float* __restrict__ s11, float* __restrict__ partial,
                   int frames_per_image, int h, int w, int tiles_x,
                   MetricParams p) {
  __shared__ float sx2[kRegion][kRegion];
  __shared__ float sx1[kRegion][kRegion];
  __shared__ float hb[3][kRegion][kTile];
  __shared__ float red[(kTiledThreads / 32) * 6];

  const int tile = blockIdx.x;
  const int c = blockIdx.y;
  const int m = blockIdx.z;
  const int img = m / frames_per_image;
  const int y0 = (tile / tiles_x) * kTile;
  const int x0 = (tile % tiles_x) * kTile;
  const size_t plane = (size_t)h * w;
  const float* fr = lin + (size_t)m * 3 * plane;
  const size_t ref_off = ((size_t)img * 3 + c) * plane;
  const float* x1g = img1 + ref_off;
  const float* m1g = mu1 + ref_off;
  const float* v1g = s11 + ref_off;

  for (int i = threadIdx.x; i < kRegion * kRegion; i += blockDim.x) {
    const int ry = i / kRegion, rx = i % kRegion;
    const int gy = y0 - kRadius + ry, gx = x0 - kRadius + rx;
    float v2 = 0.0f, v1 = 0.0f;  // zero padding outside the image
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const size_t o = (size_t)gy * w + gx;
      float v[3];
      positive_xyb(p, fr[o], fr[plane + o], fr[2 * plane + o], v);
      v2 = v[c];
      v1 = x1g[o];
    }
    sx2[ry][rx] = v2;
    sx1[ry][rx] = v1;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kRegion * kTile; i += blockDim.x) {
    const int ry = i / kTile, ox = i % kTile;
    float a = 0.0f, b = 0.0f, cc = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const float v2 = sx2[ry][ox + k];
      const float v1 = sx1[ry][ox + k];
      a += p.taps[k] * v2;
      b += p.taps[k] * (v2 * v2);
      cc += p.taps[k] * (v1 * v2);
    }
    hb[0][ry][ox] = a;
    hb[1][ry][ox] = b;
    hb[2][ry][ox] = cc;
  }
  __syncthreads();

  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int oy = i / kTile, ox = i % kTile;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy < h && gx < w) {
      float mu2 = 0.0f, s22 = 0.0f, s12 = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        mu2 += p.taps[k] * hb[0][oy + k][ox];
        s22 += p.taps[k] * hb[1][oy + k][ox];
        s12 += p.taps[k] * hb[2][oy + k][ox];
      }
      const size_t o = (size_t)gy * w + gx;
      accumulate_moments(sx1[oy + kRadius][ox + kRadius], m1g[o], v1g[o],
                         sx2[oy + kRadius][ox + kRadius], mu2, s22, s12,
                         p.ssim_c2, acc);
    }
  }
  float tot[6];
  block_reduce6(acc, red, tot);
  if (threadIdx.x == 0) {
    const int n_tiles = gridDim.x;
    float* dst = partial + (((size_t)m * 3 + c) * n_tiles + tile) * 6;
#pragma unroll
    for (int k = 0; k < 6; ++k) dst[k] = tot[k];
  }
}

// partial (M, 3, n_tiles, 6) -> out[m, slot, c, k] of out (M, n_out, 3, 6),
// adding tiles in index order.
__global__ void reduce_tiles_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int m_total,
                                    int n_tiles, int n_out, int slot) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m_total * 18) return;
  const int m = t / 18, r = t % 18;
  const int c = r / 6, k = r % 6;
  const float* src = partial + ((size_t)m * 3 + c) * n_tiles * 6 + k;
  float s = 0.0f;
  for (int j = 0; j < n_tiles; ++j) s += src[(size_t)j * 6];
  out[((size_t)m * n_out + slot) * 18 + r] = s;
}

// 2x2 box mean: src (P, h, w) planes -> dst (P, h/2, w/2); h, w even.
__global__ void ds2_kernel(const float* __restrict__ src,
                           float* __restrict__ dst, int n_planes, int h,
                           int w) {
  const int h2 = h / 2, w2 = w / 2;
  const size_t total = (size_t)n_planes * h2 * w2;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const size_t pl = i / ((size_t)h2 * w2);
  const int r = (int)(i % ((size_t)h2 * w2));
  const int y = r / w2, x = r % w2;
  const float* s = src + pl * h * w + (size_t)(2 * y) * w + 2 * x;
  dst[i] = (s[0] + s[1] + s[w] + s[w + 1]) * 0.25f;
}

// One block per frame: scales [first_ref, first_ref + n_scales) of frames
// lin (M, 3, h, w) whose first plane fits in shared memory; writes
// out[m, slot + s, c, k] of out (M, n_out, 3, 6).
__global__ void __launch_bounds__(kResidentThreads)
resident_kernel(const float* __restrict__ lin, RefPyramid refs,
                int first_ref, int n_scales, int frames_per_image, int h,
                int w, MetricParams p, float* __restrict__ out, int n_out,
                int slot) {
  extern __shared__ float smem[];
  __shared__ float red[(kResidentThreads / 32) * 6];
  const int m = blockIdx.x;
  const int n_px = h * w;
  const float* src = lin + (size_t)m * 3 * n_px;
  for (int i = threadIdx.x; i < 3 * n_px; i += blockDim.x) smem[i] = src[i];
  __syncthreads();
  resident_scales(smem, h, w, n_scales, refs, first_ref,
                  m / frames_per_image, p, red,
                  out + ((size_t)m * n_out + slot) * 18);
}

}  // namespace snes

using snes::MetricParams;
using snes::RefPyramid;

extern "C" {

int snes_ds2(const void* src, void* dst, int n_planes, int h, int w,
             void* stream) {
  const size_t total = (size_t)n_planes * (h / 2) * (w / 2);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  snes::ds2_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (float*)dst, n_planes, h, w);
  return (int)cudaGetLastError();
}

int snes_tiled_scale(const void* lin, const void* img1, const void* mu1,
                     const void* s11, void* partial, int m_total,
                     int frames_per_image, int h, int w,
                     const MetricParams* params, void* stream) {
  const int tiles_x = (w + snes::kTile - 1) / snes::kTile;
  const int tiles_y = (h + snes::kTile - 1) / snes::kTile;
  dim3 grid(tiles_x * tiles_y, 3, m_total);
  snes::tiled_scale_kernel<<<grid, snes::kTiledThreads, 0,
                             (cudaStream_t)stream>>>(
      (const float*)lin, (const float*)img1, (const float*)mu1,
      (const float*)s11, (float*)partial, frames_per_image, h, w, tiles_x,
      *params);
  return (int)cudaGetLastError();
}

int snes_reduce_tiles(const void* partial, void* out, int m_total,
                      int n_tiles, int n_out, int slot, void* stream) {
  const int threads = 128;
  const int blocks = (m_total * 18 + threads - 1) / threads;
  snes::reduce_tiles_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)partial, (float*)out, m_total, n_tiles, n_out, slot);
  return (int)cudaGetLastError();
}

int snes_resident_scales(const void* lin, const RefPyramid* refs,
                         int first_ref, int n_scales, int m_total,
                         int frames_per_image, int h, int w,
                         const MetricParams* params, void* out, int n_out,
                         int slot, void* stream) {
  const size_t smem = sizeof(float) * snes::resident_smem_floats(h * w);
  cudaError_t err = cudaFuncSetAttribute(
      snes::resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  snes::resident_kernel<<<m_total, snes::kResidentThreads, smem,
                          (cudaStream_t)stream>>>(
      (const float*)lin, *refs, first_ref, n_scales, frames_per_image, h, w,
      *params, (float*)out, n_out, slot);
  return (int)cudaGetLastError();
}

}  // extern "C"
