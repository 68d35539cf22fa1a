// Kernel C: fused coarse prescreen, red-mean path. Per (image, candidate):
// the int32 red-mean distance of every pixel to the candidate, the win
// mask d < bva (the caller folds the tie rule and the candidate mask into
// bva), the 4x4 pooled sums of m and m*ML, the exact quarter-resolution
// frame ds4(L) + (c*pool4(m) - pool4(m*ML)) / 16, and the raw SSIMULACRA2
// feature sums of scales 2..5 of that frame.
//
// Replaces snesimage_tpu/ops/pallas_metric.py _coarse_redmean_n
// (pallas_call at :579, body _coarse_kernel_redmean :365-424).
// One (image, candidate) per thread-block cluster of four blocks
// (coarse_cluster.cuh): the cluster pools the candidate's cells and hands
// the quarter-resolution frame over through distributed shared memory;
// three blocks run scale 2, one XYB channel each, while the fourth runs
// scale 3; then the three run scales 4 and 5. The full-resolution target,
// bva and ML planes are shared by every candidate of a visit and stay in
// L2; each pooled cell belongs to one thread (pooled_cell.cuh), so the
// pooled sums need no atomics.
// What bounds it on the card: not its arithmetic or its bytes (a few
// microseconds at peak rates) but the latency of each block's chain of
// blurs and barriers with 8 warps an SM, and the pooling's loads of the
// shared planes from L2.
//
// Three-level mode (pre_ds 1, the frames output given): the cluster pass
// starts at scale 3, each of its cells the 2x2 mean of four quarter cells
// (EighthFrame), and every quarter cell is also written to the candidate's
// quarter frame, which the visit's scale-2 stage scores for the survivors
// of the scale-3..5 rank (snesimage_tpu/ops/pallas_metric.py
// `emit_frames`).
#include "coarse_cluster.cuh"

namespace snes {

// tg (N, 3, H, W) int32; cand8 (N, B, 3) int32; cand_lin (N, B, 3) f32;
// bva (N, H, W) int32; ml (N, 3, H, W) f32; ds4 (N, 3, H/4, W/4) f32;
// out (N, B, n_scales, 3, 6); with kEighth frames (N, B, 3, H/4, W/4).
// Grid: N * B clusters of kClusterBlocks blocks.
template <bool kEighth>
__global__ void __launch_bounds__(kClusterThreads, 2)
coarse_redmean_kernel(const int* __restrict__ tg,
                      const int* __restrict__ cand8,
                      const float* __restrict__ cand_lin,
                      const int* __restrict__ bva,
                      const float* __restrict__ ml,
                      const float* __restrict__ ds4, RefPyramid refs,
                      int first_ref, int n_scales, int n_cand, int h, int w,
                      MetricParams p, float* __restrict__ out,
                      float* __restrict__ frames) {
  const int m = blockIdx.x / kClusterBlocks;
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
  const int hq = h / 4, wq = w / 4;
  coarse_cluster_pass<kEighth>(
      cell_in, lin_c, ds4 + (size_t)img * 3 * hq * wq, hq, wq, refs,
      first_ref, n_scales, img, p, out + (size_t)m * n_scales * 18,
      kEighth ? frames + (size_t)m * 3 * hq * wq : nullptr);
}

}  // namespace snes

// frames: null for scales 2.. from the quarter frame (pre_ds 0), else the
// three-level mode's quarter frames (pre_ds 1, scales 3..).
extern "C" int snes_coarse_redmean(const void* tg, const void* cand8,
                                   const void* cand_lin, const void* bva,
                                   const void* ml, const void* ds4,
                                   const snes::RefPyramid* refs,
                                   int first_ref, int n_scales, int n_img,
                                   int n_cand, int h, int w,
                                   const snes::MetricParams* params,
                                   void* out, void* frames, void* stream) {
  const int pre_ds = frames ? 1 : 0;
  auto kernel = frames ? snes::coarse_redmean_kernel<true>
                       : snes::coarse_redmean_kernel<false>;
  return (int)snes::launch_coarse_cluster(
      kernel, n_img * n_cand, snes::coarse_smem_bytes(h, w, pre_ds),
      (cudaStream_t)stream, (const int*)tg, (const int*)cand8,
      (const float*)cand_lin, (const int*)bva, (const float*)ml,
      (const float*)ds4, *refs, first_ref, n_scales, n_cand, h, w, *params,
      (float*)out, (float*)frames);
}

// Clusters of kernel C the card holds at once for h x w frames with
// `pre_ds` 2x2 means before the first scale (0, or 1 in the three-level
// mode), or a negative CUDA error.
extern "C" int snes_coarse_redmean_active_clusters(int h, int w, int pre_ds) {
  return snes::coarse_active_clusters(
      pre_ds ? snes::coarse_redmean_kernel<true>
             : snes::coarse_redmean_kernel<false>,
      snes::coarse_smem_bytes(h, w, pre_ds));
}
