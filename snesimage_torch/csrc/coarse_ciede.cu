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
// Layout as kernel C (coarse_redmean.cu, coarse_cluster.cuh): one (image,
// candidate) per thread-block cluster of four blocks, which pool the
// candidate's cells together and hand the quarter-resolution frame over:
// three blocks run scale 2, one XYB channel each, while the fourth runs
// scale 3; then the three run scales 4 and 5. The full-resolution Lab,
// threshold, tie and ML planes are shared by every candidate of a visit and
// stay in L2; each pooled cell belongs to one thread (pooled_cell.cuh),
// which stores the cell's distances as one float4 per row, so the pooled
// sums need no atomics.
// What bounds it on the card: the arithmetic of CIEDE2000 (nine double-
// precision transcendental calls per pixel and candidate) in the pooling,
// on 192 blocks of 8 warps, at most two an SM, over every pixel (kernel F
// computes only the tiles of the visited subpalette). The 12.6 MB of
// distance planes it writes per 48-candidate visit at 256x256 take under
// 4 us at full memory rate.
//
// Three-level mode (pre_ds 1, the frames output given), as in kernel C
// (coarse_redmean.cu): the cluster pass starts at scale 3 and the quarter
// frames are written out; the distance planes are written as always.
#include "coarse_cluster.cuh"

namespace snes {

// tlab (N, 3, H, W) f32; clab (N, B, 3) f32; cand_lin (N, B, 3) f32;
// bvalm (N, H, W) f32; adj (N, H, W) int32; ml (N, 3, H, W) f32;
// ds4 (N, 3, H/4, W/4) f32; out (N, B, n_scales, 3, 6);
// dcand (N, B, H, W) f32; with kEighth frames (N, B, 3, H/4, W/4). Grid:
// N * B clusters of kClusterBlocks blocks.
template <bool kEighth>
__global__ void __launch_bounds__(kClusterThreads, 2)
coarse_ciede_kernel(const float* __restrict__ tlab,
                    const float* __restrict__ clab,
                    const float* __restrict__ cand_lin,
                    const float* __restrict__ bvalm,
                    const int* __restrict__ adj,
                    const float* __restrict__ ml,
                    const float* __restrict__ ds4, RefPyramid refs,
                    int first_ref, int n_scales, int n_cand, int h, int w,
                    MetricParams p, float* __restrict__ out,
                    float* __restrict__ dcand, float* __restrict__ frames) {
  const int m = blockIdx.x / kClusterBlocks;
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
  const int hq = h / 4, wq = w / 4;
  coarse_cluster_pass<kEighth>(
      cell_in, lin_c, ds4 + (size_t)img * 3 * hq * wq, hq, wq, refs,
      first_ref, n_scales, img, p, out + (size_t)m * n_scales * 18,
      kEighth ? frames + (size_t)m * 3 * hq * wq : nullptr);
}

}  // namespace snes

// frames: null for scales 2.. (pre_ds 0), else the three-level mode's
// quarter frames (pre_ds 1, scales 3..).
extern "C" int snes_coarse_ciede(const void* tlab, const void* clab,
                                 const void* cand_lin, const void* bvalm,
                                 const void* adj, const void* ml,
                                 const void* ds4,
                                 const snes::RefPyramid* refs, int first_ref,
                                 int n_scales, int n_img, int n_cand, int h,
                                 int w, const snes::MetricParams* params,
                                 void* out, void* dcand, void* frames,
                                 void* stream) {
  const int pre_ds = frames ? 1 : 0;
  auto kernel = frames ? snes::coarse_ciede_kernel<true>
                       : snes::coarse_ciede_kernel<false>;
  return (int)snes::launch_coarse_cluster(
      kernel, n_img * n_cand, snes::coarse_smem_bytes(h, w, pre_ds),
      (cudaStream_t)stream, (const float*)tlab, (const float*)clab,
      (const float*)cand_lin, (const float*)bvalm, (const int*)adj,
      (const float*)ml, (const float*)ds4, *refs, first_ref, n_scales, n_cand,
      h, w, *params, (float*)out, (float*)dcand, (float*)frames);
}

// Clusters of kernel D the card holds at once for h x w frames with
// `pre_ds` 2x2 means before the first scale, or a negative CUDA error.
extern "C" int snes_coarse_ciede_active_clusters(int h, int w, int pre_ds) {
  return snes::coarse_active_clusters(
      pre_ds ? snes::coarse_ciede_kernel<true>
             : snes::coarse_ciede_kernel<false>,
      snes::coarse_smem_bytes(h, w, pre_ds));
}
