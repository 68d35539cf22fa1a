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
// thread owns whole 4x4 pooled cells (pooled_cell.cuh, shared with kernel
// E), so the pooled sums need no atomics.
// The quarter-resolution frame (3 x 64 x 64 floats at 256x256) stays in
// shared memory and scales 2..5 run there with kernel B's resident pass.
// What bounds it on the card: one block per candidate under-fills the
// 132 SMs (48 blocks per channel-sweep visit), and each block reads the
// 1.8 MB of shared full-resolution planes from L2.
#include "metric_common.cuh"
#include "pooled_cell.cuh"

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
  const float lin_c[3] = {cand_lin[m * 3], cand_lin[m * 3 + 1],
                          cand_lin[m * 3 + 2]};
  const size_t plane = (size_t)h * w;
  const int* tr = tg + (size_t)img * 3 * plane;
  const float* ml0 = ml + (size_t)img * 3 * plane;
  const RedmeanCellOperands cell_in = {
      tr, tr + plane, tr + 2 * plane, bva + (size_t)img * plane,
      ml0, ml0 + plane, ml0 + 2 * plane, w,
      cand8[m * 3], cand8[m * 3 + 1], cand8[m * 3 + 2]};
  const int hq = h / 4, wq = w / 4, n_q = hq * wq;
  const float* ds4i = ds4 + (size_t)img * 3 * n_q;
  const float inv16 = 1.0f / 16.0f;

  for (int cell = threadIdx.x; cell < n_q; cell += blockDim.x) {
    float pooled[4];
    pool_cell_redmean(cell_in, cell / wq, cell % wq, pooled);
    const float p0 = pooled[0], p1 = pooled[1], p2 = pooled[2], p3 = pooled[3];
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
      sizeof(float) * snes::resident_smem_floats(h / 4, w / 4);
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
