// The mask-and-pool step of the fused coarse prescreen kernels C
// (red-mean, coarse_redmean.cu) and D (CIEDE2000, coarse_ciede.cu); kernels
// E and F (pooled_wins.cu) pool in the same order. For one candidate and
// one 4x4 cell of
// the full-resolution image it computes each pixel's distance to the
// candidate, the win mask m, and the cell's four pooled sums
//   p[0] = sum m, p[1..3] = sum m * ML_r, m * ML_g, m * ML_b,
// added row by row, left to right, so that every kernel that pools a cell
// gives the same bits for it. A thread owns whole cells: no atomics. Each
// of a cell's four rows is read as one 16-byte vector per plane, so every
// plane pointer must be 16-byte aligned and W a multiple of 4.
//
// Win rules (snesimage_tpu/core/refine.py `_wins`, src/lib.rs:780-792):
//   red-mean  d < bva on exact int32 distances; the caller folds the tie
//             rule and the candidate mask into bva;
//   CIEDE2000 (d < bvalm) | (d == bvalm & adj != 0) on float32 distances;
//             bvalm is -3e38 where the candidate may not win.
#pragma once

#include <cuda_runtime.h>

#include "ciede2000.cuh"

namespace snes {

// One image's planes for the red-mean rule, and the candidate's 8-bit
// colour. tr, tg, tb, bva: (H, W) int32; ml0..2: (H, W) float32.
struct RedmeanCellOperands {
  const int* tr;
  const int* tg;
  const int* tb;
  const int* bva;
  const float* ml0;
  const float* ml1;
  const float* ml2;
  int w;
  int cr, cg, cb;
};

__device__ __forceinline__ void pool_cell_redmean(
    const RedmeanCellOperands& o, int cy, int cx, float p[4]) {
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
  for (int dy = 0; dy < 4; ++dy) {
    const size_t row = (size_t)(4 * cy + dy) * o.w + 4 * cx;
    const int4 r4 = *reinterpret_cast<const int4*>(o.tr + row);
    const int4 g4 = *reinterpret_cast<const int4*>(o.tg + row);
    const int4 b4 = *reinterpret_cast<const int4*>(o.tb + row);
    const int4 t4 = *reinterpret_cast<const int4*>(o.bva + row);
    const float4 l0 = *reinterpret_cast<const float4*>(o.ml0 + row);
    const float4 l1 = *reinterpret_cast<const float4*>(o.ml1 + row);
    const float4 l2 = *reinterpret_cast<const float4*>(o.ml2 + row);
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
      const int dr = rr[dx] - o.cr, dg = gg[dx] - o.cg, db = bb[dx] - o.cb;
      const int rsum = rr[dx] + o.cr;
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
  p[0] = p0;
  p[1] = p1;
  p[2] = p2;
  p[3] = p3;
}

// One image's planes for the CIEDE2000 rule, the candidate's Lab colour
// and the candidate's distance plane, which the cell's distances are
// written to. tl, ta, tb, bvalm, ml0..2: (H, W) float32; adj: (H, W) int32;
// drow: (H, W) float32.
struct CiedeCellOperands {
  const float* tl;
  const float* ta;
  const float* tb;
  const float* bvalm;
  const int* adj;
  const float* ml0;
  const float* ml1;
  const float* ml2;
  float* drow;
  int w;
  float cl, ca, cb;
};

__device__ __forceinline__ void pool_cell_ciede(const CiedeCellOperands& o,
                                                int cy, int cx, float p[4]) {
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
  for (int dy = 0; dy < 4; ++dy) {
    const size_t row = (size_t)(4 * cy + dy) * o.w + 4 * cx;
    const float4 l4 = *reinterpret_cast<const float4*>(o.tl + row);
    const float4 a4 = *reinterpret_cast<const float4*>(o.ta + row);
    const float4 b4 = *reinterpret_cast<const float4*>(o.tb + row);
    const float4 v4 = *reinterpret_cast<const float4*>(o.bvalm + row);
    const int4 j4 = *reinterpret_cast<const int4*>(o.adj + row);
    const float4 m0 = *reinterpret_cast<const float4*>(o.ml0 + row);
    const float4 m1 = *reinterpret_cast<const float4*>(o.ml1 + row);
    const float4 m2 = *reinterpret_cast<const float4*>(o.ml2 + row);
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
      d[dx] = ciede2000(ll[dx], aa[dx], bb[dx], o.cl, o.ca, o.cb);
      if (d[dx] < th[dx] || (d[dx] == th[dx] && tie[dx] != 0)) {
        p0 += 1.0f;
        p1 += q0[dx];
        p2 += q1[dx];
        p3 += q2[dx];
      }
    }
    *reinterpret_cast<float4*>(o.drow + row) =
        make_float4(d[0], d[1], d[2], d[3]);
  }
  p[0] = p0;
  p[1] = p1;
  p[2] = p2;
  p[3] = p3;
}

}  // namespace snes
