// Kernel C: fused coarse prescreen, red-mean path. Per (image, candidate):
// the int32 red-mean distance of every pixel to the candidate, the win
// mask d < bva (the caller folds the tie rule and the candidate mask into
// bva), the 4x4 pooled sums of m and m*ML, the exact quarter-resolution
// frame ds4(L) + (c*pool4(m) - pool4(m*ML)) / 16, and the raw SSIMULACRA2
// feature sums of scales 2..5 of that frame.
//
// Replaces snesimage_tpu/ops/pallas_metric.py _coarse_redmean_n
// (pallas_call at :579, body _coarse_kernel_redmean :365-424).
// One block per (image, candidate). The full-resolution target, bva and
// ML planes are shared by every candidate of a visit and stay in L2; each
// thread owns whole 4x4 pooled cells, so the pooled sums need no atomics.
// The quarter-resolution frame (3 x 64 x 64 floats at 256x256) stays in
// shared memory and scales 2..5 run there with kernel B's resident pass.
// What bounds it on the card: one block per candidate under-fills the
// 132 SMs (48 blocks per channel-sweep visit), and each block reads the
// 1.8 MB of shared full-resolution planes from L2.
#include "metric_common.cuh"

namespace snes {

// tg (N, 3, H, W) int32; cand8 (N, B, 3) int32; cand_lin (N, B, 3) f32;
// bva (N, H, W) int32; ml (N, 3, H, W) f32; ds4 (N, 3, H/4, W/4) f32;
// out (N, B, n_scales, 3, 6). Grid: N * B blocks.
__global__ void __launch_bounds__(kResidentThreads)
coarse_redmean_kernel(const int* __restrict__ tg,
                      const int* __restrict__ cand8,
                      const float* __restrict__ cand_lin,
                      const int* __restrict__ bva,
                      const float* __restrict__ ml,
                      const float* __restrict__ ds4, RefPyramid refs,
                      int first_ref, int n_scales, int n_cand, int h, int w,
                      MetricParams p, float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float red[(kResidentThreads / 32) * 6];
  const int m = blockIdx.x;
  const int img = m / n_cand;
  const int cr = cand8[m * 3], cg = cand8[m * 3 + 1], cb = cand8[m * 3 + 2];
  const float lin_c[3] = {cand_lin[m * 3], cand_lin[m * 3 + 1],
                          cand_lin[m * 3 + 2]};
  const size_t plane = (size_t)h * w;
  const int* tr = tg + (size_t)img * 3 * plane;
  const int* tgg = tr + plane;
  const int* tb = tgg + plane;
  const int* bv = bva + (size_t)img * plane;
  const float* ml0 = ml + (size_t)img * 3 * plane;
  const float* ml1 = ml0 + plane;
  const float* ml2 = ml1 + plane;
  const int hq = h / 4, wq = w / 4, n_q = hq * wq;
  const float* ds4i = ds4 + (size_t)img * 3 * n_q;
  const float inv16 = 1.0f / 16.0f;

  for (int cell = threadIdx.x; cell < n_q; cell += blockDim.x) {
    const int cy = cell / wq, cx = cell % wq;
    float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
    for (int dy = 0; dy < 4; ++dy) {
      const size_t row = (size_t)(4 * cy + dy) * w + 4 * cx;
      const int4 r4 = *reinterpret_cast<const int4*>(tr + row);
      const int4 g4 = *reinterpret_cast<const int4*>(tgg + row);
      const int4 b4 = *reinterpret_cast<const int4*>(tb + row);
      const int4 t4 = *reinterpret_cast<const int4*>(bv + row);
      const float4 l0 = *reinterpret_cast<const float4*>(ml0 + row);
      const float4 l1 = *reinterpret_cast<const float4*>(ml1 + row);
      const float4 l2 = *reinterpret_cast<const float4*>(ml2 + row);
      const int rr[4] = {r4.x, r4.y, r4.z, r4.w};
      const int gg[4] = {g4.x, g4.y, g4.z, g4.w};
      const int bb[4] = {b4.x, b4.y, b4.z, b4.w};
      const int th[4] = {t4.x, t4.y, t4.z, t4.w};
      const float a0[4] = {l0.x, l0.y, l0.z, l0.w};
      const float a1[4] = {l1.x, l1.y, l1.z, l1.w};
      const float a2[4] = {l2.x, l2.y, l2.z, l2.w};
#pragma unroll
      for (int dx = 0; dx < 4; ++dx) {
        // 512 * red_mean^2 as an exact int32 (peaks near 3.3e8).
        const int dr = rr[dx] - cr, dg = gg[dx] - cg, db = bb[dx] - cb;
        const int rsum = rr[dx] + cr;
        const int d = (1024 + rsum) * dr * dr + 2048 * dg * dg +
                      (1534 - rsum) * db * db;
        if (d < th[dx]) {
          p0 += 1.0f;
          p1 += a0[dx];
          p2 += a1[dx];
          p3 += a2[dx];
        }
      }
    }
    smem[cell] = (lin_c[0] * p0 - p1) * inv16 + ds4i[cell];
    smem[n_q + cell] = (lin_c[1] * p0 - p2) * inv16 + ds4i[n_q + cell];
    smem[2 * n_q + cell] = (lin_c[2] * p0 - p3) * inv16 + ds4i[2 * n_q + cell];
  }
  __syncthreads();
  resident_scales(smem, hq, wq, n_scales, refs, first_ref, img, p, red,
                  out + (size_t)m * n_scales * 18);
}

}  // namespace snes

extern "C" int snes_coarse_redmean(const void* tg, const void* cand8,
                                   const void* cand_lin, const void* bva,
                                   const void* ml, const void* ds4,
                                   const snes::RefPyramid* refs,
                                   int first_ref, int n_scales, int n_img,
                                   int n_cand, int h, int w,
                                   const snes::MetricParams* params,
                                   void* out, void* stream) {
  const size_t smem =
      sizeof(float) * snes::resident_smem_floats((h / 4) * (w / 4));
  cudaError_t err = cudaFuncSetAttribute(
      snes::coarse_redmean_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  snes::coarse_redmean_kernel<<<n_img * n_cand, snes::kResidentThreads, smem,
                                (cudaStream_t)stream>>>(
      (const int*)tg, (const int*)cand8, (const float*)cand_lin,
      (const int*)bva, (const float*)ml, (const float*)ds4, *refs, first_ref,
      n_scales, n_cand, h, w, *params, (float*)out);
  return (int)cudaGetLastError();
}
