// Kernel B: raw SSIMULACRA2 feature sums of several consecutive pyramid
// scales for a batch of linear-RGB frames, in one launch a call. The frames
// may belong to N images, frames_per_image each, each scored against its
// image's reference pyramid (refs.img_stride apart, 0 where one pyramid
// serves all: a seed portfolio); a frame's work does not depend on N.
//
// Replaces snesimage_tpu/ops/pallas_metric.py _multiscale_feature_sums_n
// (pallas_call at :275, tile _scales_feature_tile :142-191). The TPU
// kernel keeps a whole frame in VMEM; a 256x256 frame (768 KB of linear
// RGB) does not fit in one SM's 227 KB of shared memory, so a call is a grid
// of thread-block clusters of two kinds:
//   - a tile cluster for each (frame, scale larger than 64x64, 32x32 tile):
//     its blocks load the tile's 48x48 region (an 8-pixel halo, zero outside
//     the plane) together, each pixel converted to XYB once, and hand XYB
//     channel c to block c through distributed shared memory; block c blurs
//     x2, x2^2 and x1*x2 horizontally then vertically, a few outputs a
//     thread from registers, and sums the tile's six moments. The last
//     block of a (frame, scale) to finish, found by an integer ticket after
//     a memory fence, adds the tiles' sums in tile order;
//   - a resident cluster for each frame whose scales of 64x64 and smaller
//     run in shared memory: the cluster pass of kernels C and D
//     (coarse_cluster.cuh), fed with the frame's first small scale.
// Every pixel a block loads is the nested 2x2 mean of the caller's frame
// (pre_ds plus the scale's index levels deep), taken in the loads in
// ds2_at's nesting and order, an odd side's last row or column averaged
// with itself; no plane of means is written out and no block waits for
// another's. A call with no small scale runs clusters of three blocks, one
// a channel, up to four blocks an SM; a call with small scales runs
// clusters of four, two blocks an SM (the cluster pass's shared memory),
// and the fourth block of a tile cluster only helps load. From 16 frames
// on, a call with both kinds launches them apart (ops/cuda_metric.py
// SPLIT_FRAMES), so that its tiles run four blocks an SM.
// A call may carry a per-image gate flag on the card (the rank-1 gate of
// core/refine.py, which decides on the device whether a visit's scale-0
// stage runs): the clusters of an image whose flag is 0 return after reading
// it, before any other load, and write zero sums; an open flag gives the
// bits of a call without one.
// The sums have the bits of a block of 256 threads a (frame, channel,
// tile) (thread t over pixels t, t + 256, ... of the tile, block_reduce6's
// shuffle tree and warps in order, then the tiles in index order) and of a
// 512-thread block for the small scales; every blurred value adds its 17
// taps in one order. No float atomics: two runs give the same bits.
// What bounds it on the card: at the main path's batches (one to eight
// frames, 128-384 blocks) not its arithmetic or bytes but the latency of
// each block's chain of loads, barriers and blurs; the loads of a block's
// region are issued together before the cluster barrier, and the last
// block loads the tiles' sums at once. The caller's frames are read from
// L2 where they fit; at 64 frames of 256x256 (50 MB) they do not all.
#include "coarse_cluster.cuh"

namespace snes {

constexpr int kTile = 32;
constexpr int kRegion = kTile + 2 * kRadius;  // 48
constexpr int kRegionPx = kRegion * kRegion;
// Shared-memory floats of a tile block: its channel's XYB region, img1 of
// the region, the three horizontally blurred fields and their vertical
// blurs.
constexpr int kTileSmemFloats =
    2 * kRegionPx + 3 * kRegion * kTile + 3 * kTile * kTile;
// Outputs a thread of the tile pass's horizontal and vertical blurs (the
// cluster pass has its own kHTile, kVTile).
constexpr int kTileHOut = 2;
constexpr int kTileVOut = 4;
// Pyramid levels a call may reach: pre_ds plus its scales.
constexpr int kMaxLevels = 12;
// Levels up to this deep are unrolled into the loads of the small scales,
// one level less into the tiles' (fewer registers); deeper ones walk their
// source pixels in a loop.
constexpr int kUnrolledDepth = 2;
constexpr int kTileChannels = 3;  // blocks of a tile cluster that blur

// Sizes of the pyramid levels of the caller's frames: level l is the
// frames after l 2x2 means.
struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// One call, laid out by the wrapper (ops/cuda_metric.py).
struct MultiscaleCall {
  const float* frames;  // (M, 3, h[0], w[0]) linear RGB
  float* out;           // (M, n_scales, 3, 6)
  float* partial;       // (M, tiles_total, 3, 6): each tile's sums
  int* tickets;         // (M, n_tiled): tile blocks done; 0 between calls
  // Optional per-image gate, (M / frames_per_image,) int32 on the card:
  // the frames of an image whose flag is 0 get zero sums and no work.
  // nullptr: every frame is scored.
  const int* gate;
  int n_frames;
  // Frame m scores against image m / frames_per_image of the reference
  // pyramid (refs.img_stride: 0 where every image shares one pyramid).
  int frames_per_image;
  int pre_ds;
  int n_scales;
  int n_tiled;           // leading scales larger than kResidentMaxPixels
  int n_resident_items;  // M if scales n_tiled.. run resident, else 0
  int tiles_total;       // tiles of one frame over the tiled scales
  int tiles_x[kMaxScales];
  int tile_start[kMaxScales + 1];  // a frame's first tile of each scale
  Levels lv;
};

// Pixel (y, x) of level D of the plane `src` (level 0, lv.w[0] wide): the
// 2x2 mean of level D - 1 at (2y, 2x), (2y, 2x + 1), (2y + 1, 2x),
// (2y + 1, 2x + 1), an odd side's last row or column taken twice, as ds2_at
// adds them.
template <int D>
__device__ __forceinline__ float level_at(const float* __restrict__ src,
                                          const Levels& lv, int y, int x) {
  if constexpr (D == 0) {
    return __ldg(src + (size_t)y * lv.w[0] + x);
  } else {
    const int y0 = 2 * y, x0 = 2 * x;
    const int y1 = min(y0 + 1, lv.h[D - 1] - 1);
    const int x1 = min(x0 + 1, lv.w[D - 1] - 1);
    return __fmul_rn(level_at<D - 1>(src, lv, y0, x0) +
                         level_at<D - 1>(src, lv, y0, x1) +
                         level_at<D - 1>(src, lv, y1, x0) +
                         level_at<D - 1>(src, lv, y1, x1),
                     0.25f);
  }
}

// level_at at any depth, with few registers: the 4^depth source pixels in
// ds2_at's order, a running sum per level, each finished 2x2 sum times 0.25
// passed up.
__device__ float level_at_deep(const float* __restrict__ src,
                               const Levels& lv, int depth, int y, int x) {
  float acc[kMaxLevels];
  float v = 0.0f;
#pragma unroll 1
  for (int k = 0; k < 1 << (2 * depth); ++k) {
    int yy = y, xx = x;
#pragma unroll 1
    for (int l = depth; l > 0; --l) {  // child (k's digit l) at level l - 1
      const int d = (k >> (2 * (l - 1))) & 3;
      yy = min(2 * yy + (d >> 1), lv.h[l - 1] - 1);
      xx = min(2 * xx + (d & 1), lv.w[l - 1] - 1);
    }
    v = __ldg(src + (size_t)yy * lv.w[0] + xx);
#pragma unroll 1
    for (int l = 1; l <= depth; ++l) {
      const int d = (k >> (2 * (l - 1))) & 3;
      acc[l] = d ? acc[l] + v : v;
      if (d != 3) break;
      v = __fmul_rn(acc[l], 0.25f);
    }
  }
  return v;
}

template <int D>
__device__ __forceinline__ void level_rgb_at(const float* src, size_t plane,
                                             const Levels& lv, int y, int x,
                                             float f[3]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    f[ch] = level_at<D>(src + ch * plane, lv, y, x);
  }
}

// Linear RGB of pixel (y, x) at level `depth` of the frame `src` (three
// planes of `plane` floats): levels up to kUnrolled unrolled into the
// loads, deeper ones walked in a loop.
template <int kUnrolled>
__device__ __forceinline__ void level_rgb(const float* src, size_t plane,
                                          const Levels& lv, int depth, int y,
                                          int x, float f[3]) {
  static_assert(kUnrolled >= 1 && kUnrolled <= kUnrolledDepth,
                "levels 1 and 2 have unrolled forms");
  if (depth == 0) {
    level_rgb_at<0>(src, plane, lv, y, x, f);
  } else if (depth == 1) {
    level_rgb_at<1>(src, plane, lv, y, x, f);
  } else if (kUnrolled >= 2 && depth == 2) {
    level_rgb_at<2>(src, plane, lv, y, x, f);
  } else {
    for (int ch = 0; ch < 3; ++ch) {
      f[ch] = level_at_deep(src + ch * plane, lv, depth, y, x);
    }
  }
}

// The first small scale of a frame for the cluster pass: cell `cell` of
// level `depth`, wq wide.
struct LevelFrame {
  const float* src;
  size_t plane;
  Levels lv;
  int depth;
  int wq;

  __device__ __forceinline__ void operator()(int cell, float f[3]) const {
    level_rgb<2>(src, plane, lv, depth, cell / wq, cell % wq, f);
  }
};

// Tile t of tiled scale s of frame m, by one cluster of kBlocks blocks:
// XYB channel c of the region into block c, which blurs and sums it (a
// fourth block only loads).
template <int kBlocks>
static __device__ __forceinline__ void tile_pass(const MultiscaleCall& a,
                                                 const RefPyramid& refs,
                                                 const MetricParams& p,
                                                 int m, int s, int t) {
  extern __shared__ float4 smem_v4[];
  float(*const sx2)[kRegion] = reinterpret_cast<float(*)[kRegion]>(smem_v4);
  float(*const sx1)[kRegion] = sx2 + kRegion;
  float(*const hb)[kRegion][kTile] =
      reinterpret_cast<float(*)[kRegion][kTile]>(sx1 + kRegion);
  float(*const vb)[kTile][kTile] =
      reinterpret_cast<float(*)[kTile][kTile]>(hb + 3);
  __shared__ float red[(kClusterThreads / 32) * 6];
  __shared__ int last;
  constexpr int kStage = kRegionPx / kClusterThreads;  // 9
  constexpr int kLoads = (kRegionPx + kBlocks * kClusterThreads - 1) /
                         (kBlocks * kClusterThreads);
  constexpr int kPixels = kTile * kTile / kClusterThreads;  // 4
  static_assert(kRegionPx % kClusterThreads == 0, "whole staging rounds");

  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int depth = a.pre_ds + s;
  const int h = a.lv.h[depth], w = a.lv.w[depth];
  const int y0 = (t / a.tiles_x[s]) * kTile;
  const int x0 = (t % a.tiles_x[s]) * kTile;
  const size_t ref_off =
      (m / a.frames_per_image) * refs.img_stride[s] + (size_t)c * h * w;

  // img1 of the region, and this block's share of the region's pixels in
  // XYB, loaded together before the cluster barrier; zero outside the
  // plane.
  if (c < kTileChannels) {
    const float* x1g = refs.img1[s] + ref_off;
    float* const x1s = &sx1[0][0];
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = tid + j * kClusterThreads;
      const int gy = y0 - kRadius + i / kRegion;
      const int gx = x0 - kRadius + i % kRegion;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
      x1s[i] = in ? x1g[(size_t)gy * w + gx] : 0.0f;
    }
  }
  const size_t plane0 = (size_t)a.lv.h[0] * a.lv.w[0];
  const float* src = a.frames + (size_t)m * 3 * plane0;
  float v[kLoads][3];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = (c + j * kBlocks) * kClusterThreads + tid;
    const int gy = y0 - kRadius + i / kRegion;
    const int gx = x0 - kRadius + i % kRegion;
    v[j][0] = v[j][1] = v[j][2] = 0.0f;
    if (i < kRegionPx && gy >= 0 && gy < h && gx >= 0 && gx < w) {
      float f[3];
      level_rgb<1>(src, plane0, a.lv, depth, gy, gx, f);
      positive_xyb(p, f[0], f[1], f[2], v[j]);
    }
  }
  cluster.sync();  // every block has started
  float* dst[kTileChannels];
#pragma unroll
  for (int r = 0; r < kTileChannels; ++r) {
    dst[r] = cluster.map_shared_rank(&sx2[0][0], r);
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = (c + j * kBlocks) * kClusterThreads + tid;
    if (i < kRegionPx) {
#pragma unroll
      for (int r = 0; r < kTileChannels; ++r) dst[r][i] = v[j][r];
    }
  }
  cluster.sync();  // each channel's region has arrived
  if (c >= kTileChannels) return;

  // Horizontal blur of x2, x2^2 and x1 * x2, kTileHOut outputs a thread from
  // their inputs' products formed once; each output adds its taps in order.
  constexpr int kSegs = kTile / kTileHOut;
  for (int item = tid; item < kRegion * kSegs; item += kClusterThreads) {
    const int ry = item / kSegs, ox0 = (item % kSegs) * kTileHOut;
    float v2[kTileHOut + 2 * kRadius], sq[kTileHOut + 2 * kRadius],
        pr[kTileHOut + 2 * kRadius];
#pragma unroll
    for (int j = 0; j < kTileHOut + 2 * kRadius; ++j) {
      const float u2 = sx2[ry][ox0 + j];
      v2[j] = u2;
      sq[j] = u2 * u2;
      pr[j] = sx1[ry][ox0 + j] * u2;
    }
#pragma unroll
    for (int o = 0; o < kTileHOut; ++o) {
      float a0 = 0.0f, b = 0.0f, cc = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        a0 += p.taps[k] * v2[o + k];
        b += p.taps[k] * sq[o + k];
        cc += p.taps[k] * pr[o + k];
      }
      hb[0][ry][ox0 + o] = a0;
      hb[1][ry][ox0 + o] = b;
      hb[2][ry][ox0 + o] = cc;
    }
  }
  __syncthreads();

  // Vertical blur of each field, kTileVOut outputs a thread.
  constexpr int kVSegs = kTile / kTileVOut;
  for (int item = tid; item < 3 * kVSegs * kTile; item += kClusterThreads) {
    const int f = item / (kVSegs * kTile), rest = item % (kVSegs * kTile);
    const int oy0 = (rest / kTile) * kTileVOut, ox = rest % kTile;
    float col[kTileVOut + 2 * kRadius];
#pragma unroll
    for (int j = 0; j < kTileVOut + 2 * kRadius; ++j) {
      col[j] = hb[f][oy0 + j][ox];
    }
#pragma unroll
    for (int r = 0; r < kTileVOut; ++r) {
      float u = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) u += p.taps[k] * col[r + k];
      vb[f][oy0 + r][ox] = u;
    }
  }
  __syncthreads();

  // Moments: thread t over pixels t, t + 256, ... in turn.
  const float* m1g = refs.mu1[s] + ref_off;
  const float* v1g = refs.s11[s] + ref_off;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    const int i = tid + j * kClusterThreads;
    const int oy = i / kTile, ox = i % kTile;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy < h && gx < w) {
      const size_t o = (size_t)gy * w + gx;
      accumulate_moments(sx1[oy + kRadius][ox + kRadius], m1g[o], v1g[o],
                         sx2[oy + kRadius][ox + kRadius], vb[0][oy][ox],
                         vb[1][oy][ox], vb[2][oy][ox], p.ssim_c2, acc);
    }
  }
  float tot[6];
  block_reduce6(acc, red, tot);

  // The tile's sums, then a ticket: the last of the scale's blocks adds
  // every tile's sums in tile order, after loading them all at once.
  const int n_tiles = a.tile_start[s + 1] - a.tile_start[s];
  const size_t first = (size_t)m * a.tiles_total + a.tile_start[s];
  int* const ticket = a.tickets + m * a.n_tiled + s;
  if (tid == 0) {
    float* const sums = a.partial + (first + t) * 18 + c * 6;
#pragma unroll
    for (int k = 0; k < 6; ++k) sums[k] = tot[k];
    __threadfence();
    last = atomicAdd(ticket, 1) == kTileChannels * n_tiles - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* const staged = &sx2[0][0];
  constexpr int kChunk = kTileSmemFloats / 18;  // tiles staged at once
  float total = 0.0f;
  for (int j0 = 0; j0 < n_tiles; j0 += kChunk) {
    const int n = min(kChunk, n_tiles - j0) * 18;
    for (int i = tid; i < n; i += kClusterThreads) {
      staged[i] = __ldcg(a.partial + (first + j0) * 18 + i);
    }
    __syncthreads();
    if (tid < 18) {
      for (int i = tid; i < n; i += 18) total += staged[i];
    }
    __syncthreads();
  }
  if (tid < 18) a.out[((size_t)m * a.n_scales + s) * 18 + tid] = total;
  if (tid == 0) *ticket = 0;  // ready for the next call
}

// Scales n_tiled.. of frame m on the cluster pass of kernels C and D.
static __device__ __forceinline__ void resident_pass(const MultiscaleCall& a,
                                                     const RefPyramid& refs,
                                                     const MetricParams& p,
                                                     int m) {
  const int depth = a.pre_ds + a.n_tiled;
  const size_t plane0 = (size_t)a.lv.h[0] * a.lv.w[0];
  const int hq = a.lv.h[depth], wq = a.lv.w[depth];
  const LevelFrame frame = {a.frames + (size_t)m * 3 * plane0, plane0, a.lv,
                            depth, wq};
  cluster_pass(frame, hq, wq, refs, a.n_tiled, a.n_scales - a.n_tiled,
               m / a.frames_per_image, p,
               a.out + ((size_t)m * a.n_scales + a.n_tiled) * 18);
}

// Whether frame m's image has a closed gate: then its cluster returns
// before any other load, every block of the cluster alike (they share m),
// and the first block of the item writes zero sums for scales
// [s0, s0 + n) (a resident item's small scales, or a tile's scale from its
// first tile). A closed image's tickets stay 0.
static __device__ __forceinline__ bool closed(const MultiscaleCall& a, int m,
                                              bool first, int s0, int n) {
  if (a.gate == nullptr || a.gate[m / a.frames_per_image] != 0) return false;
  if (first) {
    float* const out = a.out + ((size_t)m * a.n_scales + s0) * 18;
    for (int i = threadIdx.x; i < n * 18; i += blockDim.x) out[i] = 0.0f;
  }
  return true;
}

// Grid: the resident clusters (one a frame, if the call has small scales)
// first, then the tile clusters frame by frame, scale by scale, tile by
// tile. kResident: the call has small scales, so its clusters have
// kClusterBlocks blocks and the shared memory of the cluster pass.
template <bool kResident>
__global__ void __launch_bounds__(kClusterThreads, kResident ? 2 : 4)
multiscale_kernel(MultiscaleCall a, RefPyramid refs, MetricParams p) {
  constexpr int kBlocks = kResident ? kClusterBlocks : kTileChannels;
  const int q = blockIdx.x / kBlocks;
  const bool first = blockIdx.x % kBlocks == 0;
  if constexpr (kResident) {
    if (q < a.n_resident_items) {
      if (closed(a, q, first, a.n_tiled, a.n_scales - a.n_tiled)) return;
      resident_pass(a, refs, p, q);
      return;
    }
  }
  const int j = q - a.n_resident_items;
  const int m = j / a.tiles_total, r = j - m * a.tiles_total;
  int s = 0;
  while (r >= a.tile_start[s + 1]) ++s;
  if (closed(a, m, first && r == a.tile_start[s], s, 1)) return;
  tile_pass<kBlocks>(a, refs, p, m, s, r - a.tile_start[s]);
}

// Dynamic shared memory of a call's launch.
static size_t call_smem(const MultiscaleCall& a) {
  int floats = a.tiles_total ? kTileSmemFloats : 0;
  if (a.n_resident_items) {
    const int d = a.pre_ds + a.n_tiled;
    const int res = cluster_smem_floats(a.lv.h[d], a.lv.w[d]);
    floats = res > floats ? res : floats;
  }
  return sizeof(float) * (size_t)floats;
}

}  // namespace snes

extern "C" {

int snes_multiscale(const snes::MultiscaleCall* call,
                    const snes::RefPyramid* refs,
                    const snes::MetricParams* params, void* stream) {
  const snes::MultiscaleCall& a = *call;
  const int n_items = a.n_resident_items + a.n_frames * a.tiles_total;
  const size_t smem = snes::call_smem(a);
  if (a.n_resident_items) {
    return (int)snes::launch_cluster(
        snes::multiscale_kernel<true>, n_items, snes::kClusterBlocks, smem,
        (cudaStream_t)stream, a, *refs, *params);
  }
  return (int)snes::launch_cluster(
      snes::multiscale_kernel<false>, n_items, snes::kTileChannels, smem,
      (cudaStream_t)stream, a, *refs, *params);
}

// Clusters of kernel B the card holds at once for `call`, or a negative
// CUDA error.
int snes_multiscale_active_clusters(const snes::MultiscaleCall* call) {
  const size_t smem = snes::call_smem(*call);
  if (call->n_resident_items) {
    return snes::coarse_active_clusters(snes::multiscale_kernel<true>, smem);
  }
  return snes::coarse_active_clusters(snes::multiscale_kernel<false>, smem,
                                      snes::kTileChannels);
}

}  // extern "C"
