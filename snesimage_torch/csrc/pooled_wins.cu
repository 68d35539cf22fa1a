// Kernels E and F: the pooled win sums of the coarse prescreen, without
// the features. Per (image, candidate): every pixel's distance to the
// candidate, the win mask m, and the 4x4-pooled sums of m, m*ML_r, m*ML_g
// and m*ML_b, from which the caller assembles the exact quarter-resolution
// frame ds4(L) + (c*pool4(m) - pool4(m*ML)) / 16 and scores it with kernel
// B. The visit takes this route where the fused kernels C and D cannot run:
// image sides that are not multiples of 32, whose pyramids do not halve
// exactly.
//   E, red-mean: exact int32 distances, mask d < bva.
//   F, CIEDE2000 (ciede2000.cuh, the standard formula, not the TPU
//      kernel's algebraic-hue rewrite): mask (d < bvalm) | (d == bvalm &
//      adj != 0); the distance planes are written out too, and the visit
//      builds its finalists' masks and the accepted colour's map from them.
//
// Replaces snesimage_tpu/ops/pallas_prescreen.py
// _pooled_wins_redmean_pallas_n (pallas_call at :131, body _kernel_redmean
// :91-121) and _pooled_wins_ciede_pallas_n (pallas_call at :273, body
// _kernel_ciede :233-261). The TPU kernels hold a candidate's whole plane in
// VMEM and pool W on the MXU against a block-diagonal matrix; here a thread
// owns one 4x4 cell (pooled_cell.cuh, the code kernels C and D pool with,
// so the pairs cannot drift apart), reads each of its rows as one 16-byte
// vector per plane and writes its four sums: no atomics, and the same bits
// every run. Grid: (cell chunks, image * candidate), so a 48-candidate
// visit at 256x240 is 720 blocks of 256 threads.
// What bounds them on the card: E the bytes it moves (the seven shared
// full-resolution planes, read once from device memory and again from L2
// by every candidate, and the pooled sums); F the arithmetic of CIEDE2000
// (nine double-precision transcendentals per pixel and candidate) and then
// the distance planes it writes.
#include "pooled_cell.cuh"

namespace snes {

constexpr int kPooledThreads = 256;

// tg (N, 3, H, W) int32; cand8 (N, B, 3) int32; bva (N, H, W) int32;
// ml (N, 3, H, W) f32; out (N, B, 4, H/4, W/4) f32.
__global__ void __launch_bounds__(kPooledThreads)
pooled_wins_redmean_kernel(const int* __restrict__ tg,
                           const int* __restrict__ cand8,
                           const int* __restrict__ bva,
                           const float* __restrict__ ml, int n_cand, int h,
                           int w, float* __restrict__ out) {
  const int wq = w / 4, n_q = (h / 4) * wq;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n_q) return;
  const int m = blockIdx.y;
  const int img = m / n_cand;
  const size_t plane = (size_t)h * w;
  const int* tr = tg + (size_t)img * 3 * plane;
  const float* ml0 = ml + (size_t)img * 3 * plane;
  const RedmeanCellOperands cell_in = {
      tr, tr + plane, tr + 2 * plane, bva + (size_t)img * plane,
      ml0, ml0 + plane, ml0 + 2 * plane, w,
      cand8[m * 3], cand8[m * 3 + 1], cand8[m * 3 + 2]};
  float pooled[4];
  pool_cell_redmean(cell_in, cell / wq, cell % wq, pooled);
  float* dst = out + (size_t)m * 4 * n_q + cell;
#pragma unroll
  for (int k = 0; k < 4; ++k) dst[(size_t)k * n_q] = pooled[k];
}

// tlab (N, 3, H, W) f32; clab (N, B, 3) f32; bvalm (N, H, W) f32;
// adj (N, H, W) int32; ml (N, 3, H, W) f32; out (N, B, 4, H/4, W/4) f32;
// dcand (N, B, H, W) f32.
__global__ void __launch_bounds__(kPooledThreads)
pooled_wins_ciede_kernel(const float* __restrict__ tlab,
                         const float* __restrict__ clab,
                         const float* __restrict__ bvalm,
                         const int* __restrict__ adj,
                         const float* __restrict__ ml, int n_cand, int h,
                         int w, float* __restrict__ out,
                         float* __restrict__ dcand) {
  const int wq = w / 4, n_q = (h / 4) * wq;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n_q) return;
  const int m = blockIdx.y;
  const int img = m / n_cand;
  const size_t plane = (size_t)h * w;
  const float* tl = tlab + (size_t)img * 3 * plane;
  const float* ml0 = ml + (size_t)img * 3 * plane;
  const CiedeCellOperands cell_in = {
      tl, tl + plane, tl + 2 * plane, bvalm + (size_t)img * plane,
      adj + (size_t)img * plane, ml0, ml0 + plane, ml0 + 2 * plane,
      dcand + (size_t)m * plane, w,
      clab[m * 3], clab[m * 3 + 1], clab[m * 3 + 2]};
  float pooled[4];
  pool_cell_ciede(cell_in, cell / wq, cell % wq, pooled);
  float* dst = out + (size_t)m * 4 * n_q + cell;
#pragma unroll
  for (int k = 0; k < 4; ++k) dst[(size_t)k * n_q] = pooled[k];
}

static dim3 pooled_grid(int n_img, int n_cand, int h, int w) {
  const int n_q = (h / 4) * (w / 4);
  return dim3((n_q + kPooledThreads - 1) / kPooledThreads, n_img * n_cand);
}

}  // namespace snes

extern "C" {

int snes_pooled_wins_redmean(const void* tg, const void* cand8,
                             const void* bva, const void* ml, int n_img,
                             int n_cand, int h, int w, void* out,
                             void* stream) {
  snes::pooled_wins_redmean_kernel<<<snes::pooled_grid(n_img, n_cand, h, w),
                                     snes::kPooledThreads, 0,
                                     (cudaStream_t)stream>>>(
      (const int*)tg, (const int*)cand8, (const int*)bva, (const float*)ml,
      n_cand, h, w, (float*)out);
  return (int)cudaGetLastError();
}

int snes_pooled_wins_ciede(const void* tlab, const void* clab,
                           const void* bvalm, const void* adj, const void* ml,
                           int n_img, int n_cand, int h, int w, void* out,
                           void* dcand, void* stream) {
  snes::pooled_wins_ciede_kernel<<<snes::pooled_grid(n_img, n_cand, h, w),
                                   snes::kPooledThreads, 0,
                                   (cudaStream_t)stream>>>(
      (const float*)tlab, (const float*)clab, (const float*)bvalm,
      (const int*)adj, (const float*)ml, n_cand, h, w, (float*)out,
      (float*)dcand);
  return (int)cudaGetLastError();
}

}  // extern "C"
