// Kernel D: fused coarse prescreen, perceptual (CIEDE2000) path. Per
// (image, candidate): the CIEDE2000 distance d of every pixel's Lab to the
// candidate's Lab (ciede2000.cuh, the standard formula), written out as the
// candidate's distance plane; the float win mask
// (d < bvalm) | (d == bvalm & adj != 0); the 4x4 pooled sums of m and m*ML;
// the exact quarter-resolution frame ds4(L) + (c*pool4(m) - pool4(m*ML))/16;
// and the raw SSIMULACRA2 feature sums of scales 2..5 of that frame.
//
// Replaces snesimage_tpu/ops/pallas_metric.py _coarse_ciede_n (pallas_call
// at :655, body _coarse_kernel_ciede :427-488), with the standard CIEDE2000
// formula in place of the TPU kernel's algebraic-hue rewrite (see
// ciede2000.cuh).
// Layout as kernel C (coarse_redmean.cu): one block per (image, candidate);
// the full-resolution Lab, threshold, tie and ML planes are shared by every
// candidate of a visit and stay in L2; each thread owns whole 4x4 cells
// (pooled_cell.cuh, shared with kernel F), so the pooled sums need no
// atomics, and it stores the cell's distances as one float4 per row. The quarter-resolution frame stays in shared memory
// and scales 2..5 run there with kernel B's resident pass.
// What bounds it on the card: the arithmetic of CIEDE2000 (nine double-
// precision transcendental calls per pixel and candidate) on 48 blocks,
// which fill 48 of 132 SMs; the 12.6 MB of distance planes it writes per
// 48-candidate visit at 256x256 take under 4 us at full memory rate.
#include "metric_common.cuh"
#include "pooled_cell.cuh"

namespace snes {

// tlab (N, 3, H, W) f32; clab (N, B, 3) f32; cand_lin (N, B, 3) f32;
// bvalm (N, H, W) f32; adj (N, H, W) int32; ml (N, 3, H, W) f32;
// ds4 (N, 3, H/4, W/4) f32; out (N, B, n_scales, 3, 6);
// dcand (N, B, H, W) f32. Grid: N * B blocks.
__global__ void __launch_bounds__(kResidentThreads)
coarse_ciede_kernel(const float* __restrict__ tlab,
                    const float* __restrict__ clab,
                    const float* __restrict__ cand_lin,
                    const float* __restrict__ bvalm,
                    const int* __restrict__ adj,
                    const float* __restrict__ ml,
                    const float* __restrict__ ds4, RefPyramid refs,
                    int first_ref, int n_scales, int n_cand, int h, int w,
                    MetricParams p, float* __restrict__ out,
                    float* __restrict__ dcand) {
  extern __shared__ float smem[];
  __shared__ float red[(kResidentThreads / 32) * 6];
  const int m = blockIdx.x;
  const int img = m / n_cand;
  const float lin_c[3] = {cand_lin[m * 3], cand_lin[m * 3 + 1],
                          cand_lin[m * 3 + 2]};
  const size_t plane = (size_t)h * w;
  const float* tl = tlab + (size_t)img * 3 * plane;
  const float* ml0 = ml + (size_t)img * 3 * plane;
  const CiedeCellOperands cell_in = {
      tl, tl + plane, tl + 2 * plane, bvalm + (size_t)img * plane,
      adj + (size_t)img * plane, ml0, ml0 + plane, ml0 + 2 * plane,
      dcand + (size_t)m * plane, w,
      clab[m * 3], clab[m * 3 + 1], clab[m * 3 + 2]};
  const int hq = h / 4, wq = w / 4, n_q = hq * wq;
  const float* ds4i = ds4 + (size_t)img * 3 * n_q;
  const float inv16 = 1.0f / 16.0f;

  for (int cell = threadIdx.x; cell < n_q; cell += blockDim.x) {
    float pooled[4];
    pool_cell_ciede(cell_in, cell / wq, cell % wq, pooled);
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

extern "C" int snes_coarse_ciede(const void* tlab, const void* clab,
                                 const void* cand_lin, const void* bvalm,
                                 const void* adj, const void* ml,
                                 const void* ds4,
                                 const snes::RefPyramid* refs, int first_ref,
                                 int n_scales, int n_img, int n_cand, int h,
                                 int w, const snes::MetricParams* params,
                                 void* out, void* dcand, void* stream) {
  const size_t smem =
      sizeof(float) * snes::resident_smem_floats(h / 4, w / 4);
  cudaError_t err = cudaFuncSetAttribute(
      snes::coarse_ciede_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  snes::coarse_ciede_kernel<<<n_img * n_cand, snes::kResidentThreads, smem,
                              (cudaStream_t)stream>>>(
      (const float*)tlab, (const float*)clab, (const float*)cand_lin,
      (const float*)bvalm, (const int*)adj, (const float*)ml,
      (const float*)ds4, *refs, first_ref, n_scales, n_cand, h, w, *params,
      (float*)out, (float*)dcand);
  return (int)cudaGetLastError();
}
