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
// candidate of a visit and stay in L2; each thread owns whole 4x4 cells, so
// the pooled sums need no atomics, and it stores the cell's distances as
// one float4 per row. The quarter-resolution frame stays in shared memory
// and scales 2..5 run there with kernel B's resident pass.
// What bounds it on the card: the arithmetic of CIEDE2000 (nine double-
// precision transcendental calls per pixel and candidate) on 48 blocks,
// which fill 48 of 132 SMs; the 12.6 MB of distance planes it writes per
// 48-candidate visit at 256x256 take under 4 us at full memory rate.
#include "ciede2000.cuh"
#include "metric_common.cuh"

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
  const float cl = clab[m * 3], ca = clab[m * 3 + 1], cb = clab[m * 3 + 2];
  const float lin_c[3] = {cand_lin[m * 3], cand_lin[m * 3 + 1],
                          cand_lin[m * 3 + 2]};
  const size_t plane = (size_t)h * w;
  const float* tl = tlab + (size_t)img * 3 * plane;
  const float* ta = tl + plane;
  const float* tb = ta + plane;
  const float* bv = bvalm + (size_t)img * plane;
  const int* aj = adj + (size_t)img * plane;
  const float* ml0 = ml + (size_t)img * 3 * plane;
  const float* ml1 = ml0 + plane;
  const float* ml2 = ml1 + plane;
  float* drow = dcand + (size_t)m * plane;
  const int hq = h / 4, wq = w / 4, n_q = hq * wq;
  const float* ds4i = ds4 + (size_t)img * 3 * n_q;
  const float inv16 = 1.0f / 16.0f;

  for (int cell = threadIdx.x; cell < n_q; cell += blockDim.x) {
    const int cy = cell / wq, cx = cell % wq;
    float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
    for (int dy = 0; dy < 4; ++dy) {
      const size_t row = (size_t)(4 * cy + dy) * w + 4 * cx;
      const float4 l4 = *reinterpret_cast<const float4*>(tl + row);
      const float4 a4 = *reinterpret_cast<const float4*>(ta + row);
      const float4 b4 = *reinterpret_cast<const float4*>(tb + row);
      const float4 v4 = *reinterpret_cast<const float4*>(bv + row);
      const int4 j4 = *reinterpret_cast<const int4*>(aj + row);
      const float4 m0 = *reinterpret_cast<const float4*>(ml0 + row);
      const float4 m1 = *reinterpret_cast<const float4*>(ml1 + row);
      const float4 m2 = *reinterpret_cast<const float4*>(ml2 + row);
      const float ll[4] = {l4.x, l4.y, l4.z, l4.w};
      const float aa[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
      const float th[4] = {v4.x, v4.y, v4.z, v4.w};
      const int tie[4] = {j4.x, j4.y, j4.z, j4.w};
      const float q0[4] = {m0.x, m0.y, m0.z, m0.w};
      const float q1[4] = {m1.x, m1.y, m1.z, m1.w};
      const float q2[4] = {m2.x, m2.y, m2.z, m2.w};
      float d[4];
#pragma unroll
      for (int dx = 0; dx < 4; ++dx) {
        // Target first, candidate second, as the torch code orders them.
        d[dx] = ciede2000(ll[dx], aa[dx], bb[dx], cl, ca, cb);
        if (d[dx] < th[dx] || (d[dx] == th[dx] && tie[dx] != 0)) {
          p0 += 1.0f;
          p1 += q0[dx];
          p2 += q1[dx];
          p3 += q2[dx];
        }
      }
      *reinterpret_cast<float4*>(drow + row) =
          make_float4(d[0], d[1], d[2], d[3]);
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

extern "C" int snes_coarse_ciede(const void* tlab, const void* clab,
                                 const void* cand_lin, const void* bvalm,
                                 const void* adj, const void* ml,
                                 const void* ds4,
                                 const snes::RefPyramid* refs, int first_ref,
                                 int n_scales, int n_img, int n_cand, int h,
                                 int w, const snes::MetricParams* params,
                                 void* out, void* dcand, void* stream) {
  const size_t smem =
      sizeof(float) * snes::resident_smem_floats((h / 4) * (w / 4));
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
