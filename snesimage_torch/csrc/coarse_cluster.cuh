// The cluster pass of the small scales (64 x 64 pixels and fewer), shared
// by kernels B, C and D (multiscale.cu, coarse_redmean.cu, coarse_ciede.cu):
// one frame per thread-block cluster of kClusterBlocks = 4 blocks of 256
// threads on neighbouring SMs, so that a 48-candidate visit spreads 192
// blocks over the card's 132 SMs. C and D give it a candidate's
// quarter-resolution frame from its pooled win mask (PooledFrame), or, in
// their three-level mode, that frame's 2x2 means (EighthFrame, which also
// writes the quarter frame out); kernel B a frame's first small scale as
// nested 2x2 means of the caller's frame.
//
// 1. Assemble the first scale over the whole cluster, one warp of 32
//    consecutive cells at a time. C and D pool each cell's 4x4 pixels with
//    the unchanged pool_cell_redmean / pool_cell_ciede of pooled_cell.cuh
//    (kernels E and F pool in the same order) into the exact quarter-
//    resolution frame, ds4 + (c * p0 - p_k) / 16. A warp's first chunk of
//    cells is fixed; it takes each later one from a counter in rank 0's
//    shared memory, asked for before it works on the chunk in hand, so a
//    block that shares its SM with another block takes fewer cells. The
//    warp converts each cell to positive XYB and stores, through
//    distributed shared memory, XYB channel c into rank c (c = 0, 1, 2) and
//    the linear value into rank 3. One cluster barrier then hands the frame
//    over.
// 2. Scales. Rank c (0..2) runs the first scale (scale 2 of the pyramid in
//    C and D) of XYB channel c. Rank 3 meanwhile takes the frame's 2x2
//    means twice, stores the third scale's linear frame into ranks 0-2 and
//    runs the second scale, all three channels together; ranks 0-2 then
//    run the later scales of their channel. So each block works through
//    about a quarter of the pixels and channels. Each scale is the
//    horizontal 17-tap blur of x2, x2^2 and x1 * x2 in tiles of kHTile
//    outputs a thread, the vertical blur of each field in columns of kVTile
//    outputs a thread (each input loaded once a tile, not once a tap), the
//    SSIM, artifact and detail-loss maps and their raw sums. The reference
//    planes img1 of a scale are staged in shared memory once (every pixel
//    reads them at 17 taps; rank c stages the first scale's before the
//    frame is assembled); mu1 and s11 are read once a pixel from device
//    memory. No plane crosses blocks but the two hand-overs, so there are
//    no halos.
//
// The bits of one 512-thread block a frame: the same XYB and 2x2 means,
// every blurred value adds its taps in one order (a tap outside the plane
// adds fma(t, 0, s) = s), and the moments are summed in one order: 512
// virtual threads, thread v over pixels v, v + 512, ... in turn, a shuffle
// tree in each warp, the 16 warps in order. A block of 256 threads keeps
// two virtual threads' sums a thread. No float atomics: two runs give the
// same bits.
//
// Shared memory at a 64 x 64 first scale: rank c the three blurred fields
// (48 KB) and, 16 KB each, the spare plane the vertical blur writes to, its
// XYB channel and staged img1, and the third scale's linear frame (3 KB);
// rank 3 the linear frame, reused for the second scale's blurred fields
// and spare planes (48 KB), and the second scale's linear frame, XYB and
// img1 planes (12 KB each): 99 KB, so two blocks fit on an SM and every
// cluster of a 48-candidate visit is resident at once. In the three-level
// mode the first scale is 32 x 32 (scale 3 at 256 x 256) and a block takes
// 25 KB.
#pragma once

#include <cooperative_groups.h>

#include <utility>

#include "metric_common.cuh"
#include "pooled_cell.cuh"

namespace snes {

namespace cg = cooperative_groups;

constexpr int kClusterBlocks = 4;
constexpr int kClusterThreads = 256;
constexpr int kVirtualSets = kResidentThreads / kClusterThreads;
constexpr int kHTile = 4;  // horizontal blur outputs a thread
constexpr int kSpan = kHTile + 2 * kRadius;  // the inputs of one tile
constexpr int kVTile = 16;  // vertical blur outputs a thread
constexpr int kVSpan = kVTile + 2 * kRadius;

// Shared-memory floats of one block for an h x w quarter frame: the larger
// of rank c's layout (three blurred fields, the vertical blur's spare
// plane, its XYB channel and img1, the linear frame of scale 4) and rank
// 3's (the linear frame, reused for scale 3's blurred fields and spare
// planes; scale 3's linear frame, three XYB and three img1 planes).
__host__ __device__ constexpr int cluster_smem_floats(int h, int w) {
  const int n1 = half_up(h) * half_up(w);
  const int rank_c =
      6 * h * w + 3 * half_up(half_up(h)) * half_up(half_up(w));
  const int rank3 = 3 * h * w + 9 * n1;
  return rank_c > rank3 ? rank_c : rank3;
}

__device__ __forceinline__ void pool_cell(const RedmeanCellOperands& o,
                                          int cy, int cx, float p[4]) {
  pool_cell_redmean(o, cy, cx, p);
}

__device__ __forceinline__ void pool_cell(const CiedeCellOperands& o, int cy,
                                          int cx, float p[4]) {
  pool_cell_ciede(o, cy, cx, p);
}

// One h x w scale of kCh XYB channels c0.. of image `img`: x2 and x1 hold
// each channel's XYB and staged img1 planes, `hb` takes 3 * kCh blurred
// planes. Writes the raw moments of channel c to out[c * 6 + k]. Reference
// planes mu1, s11 are refs.*[rs]. All threads of the block call it; it
// ends with a barrier.
template <int kCh>
static __device__ __forceinline__ void run_scale(
    float* hb, const float* x2, const float* x1, int h, int w,
    const RefPyramid& refs, int rs, int img, int c0, const MetricParams& p,
    float* red, float* out) {
  const int tid = threadIdx.x;
  const int n_px = h * w;

  // Horizontal blur; a tap outside the row reads 0.
  const int segs = (w + kHTile - 1) / kHTile;
  for (int item = tid; item < kCh * h * segs; item += kClusterThreads) {
    const int ch = item / (h * segs), rest = item - ch * h * segs;
    const int y = rest / segs, x0 = (rest - y * segs) * kHTile;
    const float* r2 = x2 + ch * n_px + y * w;
    const float* r1 = x1 + ch * n_px + y * w;
    float v2[kSpan], v1[kSpan];
    if ((w & 3) == 0) {  // 16-byte loads, wholly inside or outside
#pragma unroll
      for (int j = 0; j < kSpan; j += 4) {
        const int xx = x0 - kRadius + j;
        float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
        if (xx >= 0 && xx < w) {
          a = *reinterpret_cast<const float4*>(r2 + xx);
          b = *reinterpret_cast<const float4*>(r1 + xx);
        }
        v2[j] = a.x, v2[j + 1] = a.y, v2[j + 2] = a.z, v2[j + 3] = a.w;
        v1[j] = b.x, v1[j + 1] = b.y, v1[j + 2] = b.z, v1[j + 3] = b.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kSpan; ++j) {
        const int xx = x0 - kRadius + j;
        const bool in = xx >= 0 && xx < w;
        v2[j] = in ? r2[xx] : 0.0f;
        v1[j] = in ? r1[xx] : 0.0f;
      }
    }
    float* const hbc = hb + ch * 3 * n_px;
#pragma unroll
    for (int o = 0; o < kHTile; ++o) {
      if (x0 + o < w) {
        float a = 0.0f, b = 0.0f, cc = 0.0f;
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          const float u2 = v2[o + k];
          a += p.taps[k] * u2;
          b += p.taps[k] * (u2 * u2);
          cc += p.taps[k] * (v1[o + k] * u2);
        }
        const int i = y * w + x0 + o;
        hbc[i] = a;
        hbc[n_px + i] = b;
        hbc[2 * n_px + i] = cc;
      }
    }
  }
  __syncthreads();

  // Vertical blur, one field at a time, in columns of kVTile outputs from
  // kVSpan inputs (0 outside the plane). Field 0's results go to the spare
  // planes, field f's to field f - 1's blurred planes, which are spent.
  float* const spare = hb + 3 * kCh * n_px;
  const int vsegs = (h + kVTile - 1) / kVTile;
  for (int f = 0; f < 3; ++f) {
    for (int item = tid; item < kCh * vsegs * w; item += kClusterThreads) {
      const int ch = item / (vsegs * w), rest = item - ch * vsegs * w;
      const int seg = rest / w, x = rest - seg * w, y0 = seg * kVTile;
      const float* src = hb + (ch * 3 + f) * n_px + x;
      float* dst =
          (f ? hb + (ch * 3 + f - 1) * n_px : spare + ch * n_px) + x;
      float col[kVSpan];
#pragma unroll
      for (int j = 0; j < kVSpan; ++j) {
        const int yy = y0 - kRadius + j;
        col[j] = yy >= 0 && yy < h ? src[yy * w] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kVTile; ++r) {
        if (y0 + r < h) {
          float v = 0.0f;
#pragma unroll
          for (int k = 0; k < kTaps; ++k) v += p.taps[k] * col[r + k];
          dst[(y0 + r) * w] = v;
        }
      }
    }
    __syncthreads();
  }

  // Moments, pixel i by virtual thread i mod 512.
  float acc[kCh][kVirtualSets][6] = {};
  for (int base = 0; base < n_px; base += kResidentThreads) {
#pragma unroll
    for (int j = 0; j < kVirtualSets; ++j) {
      const int i = base + j * kClusterThreads + tid;
      if (i < n_px) {
#pragma unroll
        for (int ch = 0; ch < kCh; ++ch) {
          const size_t plane =
              img * refs.img_stride[rs] + (size_t)(c0 + ch) * n_px;
          accumulate_moments(x1[ch * n_px + i], refs.mu1[rs][plane + i],
                             refs.s11[rs][plane + i], x2[ch * n_px + i],
                             spare[ch * n_px + i], hb[ch * 3 * n_px + i],
                             hb[(ch * 3 + 1) * n_px + i], p.ssim_c2,
                             acc[ch][j]);
        }
      }
    }
  }

  // block_reduce6 over the 16 virtual warps, for each channel.
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int ch = 0; ch < kCh; ++ch) {
#pragma unroll
    for (int j = 0; j < kVirtualSets; ++j) {
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        float v = acc[ch][j][k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_down_sync(0xffffffffu, v, off);
        }
        if (lane == 0) {
          red[((ch * kVirtualSets + j) * (kClusterThreads / 32) + warp) * 6 +
              k] = v;
        }
      }
    }
  }
  __syncthreads();
  if (tid < kCh * 6) {
    const int ch = tid / 6, k = tid - ch * 6;
    float sum = 0.0f;
    for (int vw = 0; vw < kResidentThreads / 32; ++vw) {
      sum += red[(ch * (kResidentThreads / 32) + vw) * 6 + k];
    }
    out[(c0 + ch) * 6 + k] = sum;
  }
  __syncthreads();
}

// Copies img1 of channels c0 .. c0 + n_ch - 1 of image `img` at reference
// scale rs (n_px pixels a plane) into x1.
static __device__ __forceinline__ void stage_img1(float* x1,
                                                  const RefPyramid& refs,
                                                  int rs, int img, int c0,
                                                  int n_ch, int n_px) {
  const float* src =
      refs.img1[rs] + img * refs.img_stride[rs] + (size_t)c0 * n_px;
  for (int i = threadIdx.x; i < n_ch * n_px; i += kClusterThreads) {
    x1[i] = src[i];
  }
}

// One h x w scale from its linear frame `lin` (3 x h x w): the XYB of
// channels c0 .. c0 + kCh - 1 into x2, their img1 staged into x1, and, if
// `nxt` is given, the frame's 2x2 means into nxt; then run_scale.
template <int kCh>
static __device__ __forceinline__ void scale_from_linear(
    const float* lin, float* nxt, int h, int w, float* hb, float* x2,
    float* x1, const RefPyramid& refs, int rs, int img, int c0,
    const MetricParams& p, float* red, float* out) {
  const int n_px = h * w;
  for (int i = threadIdx.x; i < n_px; i += kClusterThreads) {
    float v[3];
    positive_xyb(p, lin[i], lin[n_px + i], lin[2 * n_px + i], v);
#pragma unroll
    for (int ch = 0; ch < kCh; ++ch) {
      const int c = c0 + ch;
      x2[ch * n_px + i] = c == 0 ? v[0] : (c == 1 ? v[1] : v[2]);
    }
  }
  stage_img1(x1, refs, rs, img, c0, kCh, n_px);
  if (nxt) {
    const int hn = half_up(h), wn = half_up(w), n_next = hn * wn;
    for (int i = threadIdx.x; i < 3 * n_next; i += kClusterThreads) {
      const int ch = i / n_next, r = i - ch * n_next;
      nxt[i] = ds2_at(lin + ch * n_px, h, w, r / wn, r % wn);
    }
  }
  __syncthreads();
  run_scale<kCh>(hb, x2, x1, h, w, refs, rs, img, c0, p, red, out);
}

// The two halves of a cluster barrier: a block arrives when its stores to
// its peers are done and waits before it reads what its peers stored.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The quarter-resolution frame of kernels C and D: cell `cell` of the
// candidate's pooled win mask, ds4 + (c * p0 - p_k) / 16, from its pooling
// operands `cell_in`, its linear colour `lin_c` and the image's
// no-candidate quarter frame `ds4i` (3 x hq x wq).
template <class Cell>
struct PooledFrame {
  Cell cell_in;
  float lin_c[3];
  const float* ds4i;
  int wq;
  int n_q;

  __device__ __forceinline__ void operator()(int cell, float f[3]) const {
    float pooled[4];
    pool_cell(cell_in, cell / wq, cell % wq, pooled);
    const float p0 = pooled[0], p1 = pooled[1], p2 = pooled[2],
                p3 = pooled[3];
    const float inv16 = 1.0f / 16.0f;
    f[0] = (lin_c[0] * p0 - p1) * inv16 + ds4i[cell];
    f[1] = (lin_c[1] * p0 - p2) * inv16 + ds4i[n_q + cell];
    f[2] = (lin_c[2] * p0 - p3) * inv16 + ds4i[2 * n_q + cell];
  }
};

// The 1/8-resolution frame of kernels C and D's three-level mode (pre_ds
// 1): cell `cell` of the (hq/2 x wq/2) frame is the 2x2 mean, in the order
// of ds2_at, of four cells of the quarter-resolution frame `quarter`
// builds. Each quarter cell is written to the candidate's quarter frame
// `frames` (3 x hq x wq) as it is made; it belongs to one 1/8 cell, so it is
// written once, by one thread, with no atomics. hq and wq are even.
template <class Cell>
struct EighthFrame {
  PooledFrame<Cell> quarter;
  float* frames;
  int w8;

  __device__ __forceinline__ void operator()(int cell, float f[3]) const {
    const int y = cell / w8, x = cell - (cell / w8) * w8;
    const int n_q = quarter.n_q;
    float q[4][3];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int qc = (2 * y + (k >> 1)) * quarter.wq + 2 * x + (k & 1);
      quarter(qc, q[k]);
#pragma unroll
      for (int c = 0; c < 3; ++c) frames[c * n_q + qc] = q[k][c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f[c] = (q[0][c] + q[1][c] + q[2][c] + q[3][c]) * 0.25f;
    }
  }
};

// The cluster pass of one frame (kernels B, C and D): `frame(cell, f)`
// gives the linear RGB of cell `cell` of the first scale (hq x wq), which
// the cluster assembles and hands over; then the scales. Writes
// out[s * 18 + c * 6 + k] for scales s < n_scales, whose reference planes
// are refs.*[first_ref + s] of image `img`.
template <class Frame>
static __device__ __forceinline__ void cluster_pass(
    const Frame& frame, int hq, int wq, const RefPyramid& refs,
    int first_ref, int n_scales, int img, const MetricParams& p,
    float* out) {
  extern __shared__ float4 smem_v4[];
  float* const smem = reinterpret_cast<float*>(smem_v4);
  __shared__ float red[3 * (kResidentThreads / 32) * 6];
  __shared__ int next_chunk;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_q = hq * wq;
  constexpr int kWarps = kClusterThreads / 32;
  // Rank c's layout: blurred fields, spare plane, XYB channel, img1.
  float* const xyb_c = smem + 4 * n_q;
  float* const img1_c = xyb_c + n_q;
  // The first chunk of each warp is fixed; the counter hands out the rest.
  if (threadIdx.x == 0) next_chunk = kClusterBlocks * kWarps;
  if (rank < 3) stage_img1(img1_c, refs, first_ref, img, rank, 1, n_q);
  cluster.sync();  // every block has started; rank 0's counter is set

  float* xyb_dst[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    xyb_dst[r] = cluster.map_shared_rank(xyb_c, r);
  }
  float* const lin_dst = cluster.map_shared_rank(smem, 3);
  int* const counter = cluster.map_shared_rank(&next_chunk, 0);
  const int lane = threadIdx.x & 31;
  const int n_chunks = (n_q + 31) / 32;
  int chunk = rank * kWarps + (threadIdx.x >> 5);
  while (chunk < n_chunks) {
    // Ask for the next chunk before assembling this one: the round trip
    // to rank 0 overlaps the cells' loads.
    int next = 0;
    if (lane == 0) next = atomicAdd(counter, 1);
    const int cell = chunk * 32 + lane;
    if (cell < n_q) {
      float f[3];
      frame(cell, f);
      float v[3];
      positive_xyb(p, f[0], f[1], f[2], v);
#pragma unroll
      for (int r = 0; r < 3; ++r) xyb_dst[r][cell] = v[r];
      lin_dst[cell] = f[0];
      lin_dst[n_q + cell] = f[1];
      lin_dst[2 * n_q + cell] = f[2];
    }
    chunk = __shfl_sync(0xffffffffu, next, 0);
  }
  cluster.sync();  // the frame is handed over

  // Rank 3 takes scale 3 of every channel and hands the linear frame of
  // scale 4 to ranks 0-2, which take scale 2 and then scales 4 and 5 of
  // their channel.
  const int h1 = half_up(hq), w1 = half_up(wq), n1 = h1 * w1;
  const int h2 = half_up(h1), w2 = half_up(w1), n2 = h2 * w2;
  float* const lin2 = smem + 6 * n_q;  // rank c: the frame of scale 4
  if (rank == 3) {
    float* const lin1 = smem + 3 * n_q;
    float* const x2 = lin1 + 3 * n1;
    float* const x1 = x2 + 3 * n1;
    if (n_scales > 1) {
      for (int i = threadIdx.x; i < 3 * n1; i += kClusterThreads) {
        const int ch = i / n1, r = i - ch * n1;
        lin1[i] = ds2_at(smem + ch * n_q, hq, wq, r / w1, r % w1);
      }
      __syncthreads();
    }
    if (n_scales > 2) {
      float* dst[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) dst[r] = cluster.map_shared_rank(lin2, r);
      for (int i = threadIdx.x; i < 3 * n2; i += kClusterThreads) {
        const int ch = i / n2, r = i - ch * n2;
        const float v = ds2_at(lin1 + ch * n1, h1, w1, r / w2, r % w2);
#pragma unroll
        for (int k = 0; k < 3; ++k) dst[k][i] = v;
      }
    }
    cluster_arrive();
    if (n_scales > 1) {
      scale_from_linear<3>(lin1, nullptr, h1, w1, smem, x2, x1, refs,
                           first_ref + 1, img, 0, p, red, out + 18);
    }
    cluster_wait();
    return;
  }
  cluster_arrive();
  run_scale<1>(smem, xyb_c, img1_c, hq, wq, refs, first_ref, img, rank, p,
               red, out);
  cluster_wait();  // the frame of scale 4 has arrived
  const float* lin = lin2;
  int h = h2, w = w2;
  for (int s = 2; s < n_scales; ++s) {
    // The next scale's frame alternates between the spare plane and lin2.
    float* const nxt = s + 1 < n_scales
                           ? ((s & 1) ? lin2 : smem + 3 * n_q)
                           : nullptr;
    scale_from_linear<1>(lin, nxt, h, w, smem, xyb_c, img1_c, refs,
                         first_ref + s, img, rank, p, red, out + s * 18);
    lin = nxt;
    h = half_up(h);
    w = half_up(w);
  }
}

// The kernel body of C and D for one (image, candidate) per cluster:
// `cell_in` holds the candidate's pooling operands, `lin_c` its linear
// colour, `ds4i` the image's no-candidate quarter frame (3 x hq x wq).
// Writes out[s * 18 + c * 6 + k]. The first scale is the quarter frame
// (scale 2), or with kEighth its 2x2 means (scale 3), the quarter frame
// then written to `frames` (3 x hq x wq).
template <bool kEighth, class Cell>
static __device__ __forceinline__ void coarse_cluster_pass(
    const Cell& cell_in, const float lin_c[3], const float* __restrict__ ds4i,
    int hq, int wq, const RefPyramid& refs, int first_ref, int n_scales,
    int img, const MetricParams& p, float* out, float* frames) {
  const PooledFrame<Cell> quarter = {cell_in, {lin_c[0], lin_c[1], lin_c[2]},
                                     ds4i, wq, hq * wq};
  if constexpr (kEighth) {
    const EighthFrame<Cell> eighth = {quarter, frames, wq / 2};
    cluster_pass(eighth, hq / 2, wq / 2, refs, first_ref, n_scales, img, p,
                 out);
  } else {
    cluster_pass(quarter, hq, wq, refs, first_ref, n_scales, img, p, out);
  }
}

// Dynamic shared memory of one block of kernel C or D for h x w frames with
// `pre_ds` 2x2 means of the quarter frame before the first scale.
static size_t coarse_smem_bytes(int h, int w, int pre_ds) {
  return sizeof(float) *
         cluster_smem_floats((h / 4) >> pre_ds, (w / 4) >> pre_ds);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory, with the SM's
// whole carveout for shared memory, so that two of its blocks share an SM.
template <class... Params>
static cudaError_t set_cluster_smem(void (*kernel)(Params...), size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The launch configuration of n_items clusters of `blocks` blocks with
// `smem` bytes of dynamic shared memory a block; `attr` must outlive it.
static cudaLaunchConfig_t cluster_config(int n_items, size_t smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr,
                                         int blocks = kClusterBlocks) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_items * blocks);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = blocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launches `kernel` over n_items clusters of `blocks` blocks.
template <class... Params, class... Args>
static cudaError_t launch_cluster(void (*kernel)(Params...), int n_items,
                                  int blocks, size_t smem,
                                  cudaStream_t stream, Args&&... args) {
  cudaError_t err = set_cluster_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(n_items, smem, stream, &attr, blocks);
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

// Launches `kernel` over n_items clusters of kClusterBlocks blocks.
template <class... Params, class... Args>
static cudaError_t launch_coarse_cluster(void (*kernel)(Params...),
                                         int n_items, size_t smem,
                                         cudaStream_t stream,
                                         Args&&... args) {
  return launch_cluster(kernel, n_items, kClusterBlocks, smem, stream,
                        std::forward<Args>(args)...);
}

// How many clusters of `blocks` blocks of `kernel` the card holds at once
// (the occupancy calculator's answer), or a negative CUDA error.
template <class... Params>
static int coarse_active_clusters(void (*kernel)(Params...), size_t smem,
                                  int blocks = kClusterBlocks) {
  cudaError_t err = set_cluster_smem(kernel, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(1, smem, nullptr, &attr, blocks);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace snes
