// Kernels E and F: the pooled win sums of the coarse prescreen, without
// the features. Per (image, candidate): every pixel's distance to the
// candidate, the win mask m, and the 4x4-pooled sums of m, m*ML_r, m*ML_g
// and m*ML_b, from which the caller assembles the exact quarter-resolution
// frame ds4(L) + (c*pool4(m) - pool4(m*ML)) / 16 and scores it with kernel
// B. The visit takes this route where the fused kernels C and D cannot run:
// image sides that are not multiples of 32.
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
// VMEM and pool W on the MXU against a block-diagonal matrix.
//
// A visit of slot (p, i) can change only the pixels of subpalette p: off
// its 8x8 tiles the win rule's operands forbid every win, so the pooled
// sums there are 0 and no caller reads the distances. Given the tile map
// and p, the kernels compute only those tiles (on average 1/C of the
// image) and write 0 sums and +inf distances elsewhere; without them,
// every tile. Work is split by 8x8 tile, one launch a call, on a fixed
// grid of resident blocks of 256 threads, without the host knowing how
// many tiles p has:
//   1. every block lists the tiles of p in order in shared memory (one
//      16-byte load of four entries a thread, a warp scan), kSegment tiles
//      at a time, and counts them; from the count one warp picks the
//      candidates of a (tile, chunk) item (`chunk_size`) so that the last
//      block ends first: for F, whose distances are dear, a few candidates
//      per group; for E, most of them;
//   2. the blocks take the items in turn (item j to block j mod grid). A
//      block loads the tile's operands once for all candidates of the
//      chunk: each of its four 64-thread groups holds one pixel a thread
//      in registers, the ML planes and the candidates go to shared memory.
//      A group computes one candidate's 64 distances at a time and leaves
//      the win bits of each 4-row half of the tile (one warp's ballot) in
//      shared memory; then one thread per (candidate, sum, cell row) adds
//      each of the row's two cells' sixteen values row by row, left to
//      right, as pooled_cell.cuh does for kernels C and D, so the sums
//      keep their bits;
//   3. the blocks stride over the outputs off the tiles of p, a thread per
//      position whose tile it looks up once: 16-byte stores of +inf
//      distances, 8-byte stores of 0 sums (a tile's row of two cells).
//      Odd blocks do this before their items, even ones after, so that an
//      SM's stores overlap its arithmetic.
// No atomics; every output is written by one thread in a fixed order, so
// the bits do not depend on the split and repeat on every run.
// What bounds them on the card: E the bytes of the pooled sums it writes
// (the whole grid of cells for every candidate), though its serial phases
// (list, load, distances, pool, store) take longer than that; F the
// arithmetic of CIEDE2000 on the tiles of p (nine double-precision
// transcendentals a pixel and candidate, at the card's FP64 rate) and then
// its distance planes.
#include <cuda_runtime.h>

#include <math_constants.h>

#include "ciede2000.cuh"

namespace snes {

constexpr int kPooledThreads = 256;
constexpr int kGroups = kPooledThreads / 64;  // candidates in flight a block
constexpr int kMaxChunk = 64;                 // candidates of one item
constexpr int kSegment = 4096;                // tiles listed at once
constexpr int kMaxBlocksPerSm = 4;

struct PooledArgs {
  const void* target;  // (N, 3, H, W) int32 8-bit RGB (E) / f32 Lab (F)
  const void* cand;    // (N, B, 3) int32 8-bit RGB (E) / f32 Lab (F)
  const void* thr;     // (N, H, W) int32 bva (E) / f32 bvalm (F)
  const int* adj;      // (N, H, W) int32 (F only)
  const float* ml;     // (N, 3, H, W) f32
  const int* tiles;    // (N, H/8, W/8) int32 tile map, or null: every tile
  float* out;          // (N, B, 4, H/4, W/4) f32
  float* dcand;        // (N, B, H, W) f32 (F only)
  int n_img, n_cand, h, w, p;
};

// Lists the tiles t in [seg, seg_end) with tiles[t] == p, in order, into
// s_list (as t - seg); returns how many (the same value in every thread).
// A thread takes four consecutive entries in one 16-byte load (where the
// map is 16-byte aligned), so a segment of up to 4 * kPooledThreads tiles
// costs one load latency, a warp scan and two barriers.
__device__ int list_tiles(const int* __restrict__ tiles, int p, int seg,
                          int seg_end, int* s_list, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = (reinterpret_cast<size_t>(tiles) & 15) == 0;
  int n = 0;
  for (int base = seg; base < seg_end; base += 4 * kPooledThreads) {
    const int t0 = base + 4 * threadIdx.x;
    int v[4];
    if (vec && t0 + 3 < seg_end) {
      const int4 q = *reinterpret_cast<const int4*>(tiles + t0);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = t0 + u < seg_end ? tiles[t0 + u] : 0;
    }
    bool hit[4];
    int mine = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      hit[u] = t0 + u < seg_end && v[u] == p;
      mine += hit[u];
    }
    int incl = mine;  // inclusive scan over the warp's lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int at = n + incl - mine;
#pragma unroll
    for (int w = 0; w < kPooledThreads / 32; ++w) {
      at += w < warp ? s_warp[w] : 0;
      n += s_warp[w];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (hit[u]) s_list[at++] = t0 + u - seg;
    __syncthreads();  // s_warp is written again
  }
  return n;
}

// One item: tile `tile` (image-major over the N tile maps) and candidates
// c0 .. c0 + nc - 1.
template <bool kCiede>
__device__ void pool_tile(const PooledArgs& a, int tile, int c0, int nc,
                          float (*s_ml)[64], unsigned (*s_wins)[2],
                          int* s_cand) {
  const int tiles_x = (a.w + 7) / 8;
  const int per_img = ((a.h + 7) / 8) * tiles_x;
  const int img = tile / per_img, ty = (tile % per_img) / tiles_x,
            tx = (tile % per_img) % tiles_x;
  const int q = threadIdx.x & 63, group = threadIdx.x >> 6;
  const int y = 8 * ty + (q >> 3), x = 8 * tx + (q & 7);
  const bool valid = y < a.h && x < a.w;
  const size_t plane = (size_t)a.h * a.w;
  const size_t px = (size_t)y * a.w + x;
  if (group == 0) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      s_ml[ch][q] = valid ? a.ml[((size_t)img * 3 + ch) * plane + px] : 0.0f;
  }
  // The chunk's candidates (3 values each, int32 or float32 bits).
  if (threadIdx.x < 3 * nc)
    s_cand[threadIdx.x] = static_cast<const int*>(
        a.cand)[((size_t)img * a.n_cand + c0) * 3 + threadIdx.x];
  // This pixel's operands, kept for every candidate of the item.
  float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f, fthr = 0.0f;
  int i0 = 0, i1 = 0, i2 = 0, ithr = 0, tie = 0;
  if (valid) {
    const size_t at = (size_t)img * 3 * plane + px;
    if constexpr (kCiede) {
      const float* tl = static_cast<const float*>(a.target);
      t0 = tl[at];
      t1 = tl[at + plane];
      t2 = tl[at + 2 * plane];
      fthr = static_cast<const float*>(a.thr)[img * plane + px];
      tie = a.adj[img * plane + px];
    } else {
      const int* tg = static_cast<const int*>(a.target);
      i0 = tg[at];
      i1 = tg[at + plane];
      i2 = tg[at + 2 * plane];
      ithr = static_cast<const int*>(a.thr)[img * plane + px];
    }
  }
  __syncthreads();
  for (int j = group; j < nc; j += kGroups) {
    const int* c = s_cand + 3 * j;
    bool win = false;
    if (valid) {
      if constexpr (kCiede) {
        const size_t m = (size_t)img * a.n_cand + c0 + j;
        // Target first, candidate second, as the torch code orders them.
        const float d =
            ciede2000(t0, t1, t2, __int_as_float(c[0]), __int_as_float(c[1]),
                      __int_as_float(c[2]));
        a.dcand[m * plane + px] = d;
        win = d < fthr || (d == fthr && tie != 0);
      } else {
        // 512 * red_mean^2 as an exact int32 (peaks near 3.3e8).
        const int dr = i0 - c[0], dg = i1 - c[1], db = i2 - c[2];
        const int rsum = i0 + c[0];
        const int d = (1024 + rsum) * dr * dr + 2048 * dg * dg +
                      (1534 - rsum) * db * db;
        win = d < ithr;
      }
    }
    // Lane dy * 8 + dx of warp half holds pixel (4 * half + dy, dx).
    const unsigned bits = __ballot_sync(0xffffffffu, win);
    if ((threadIdx.x & 31) == 0) s_wins[j][q >> 5] = bits;
  }
  __syncthreads();
  // One thread a (candidate, sum, cell row of the tile): both cells of the
  // row, each added row by row, left to right, stored as one float2 where
  // the row has both and W/4 is even (8-byte aligned).
  const int wq = a.w / 4, n_q = (a.h / 4) * wq;
  for (int s = threadIdx.x; s < nc * 8; s += kPooledThreads) {
    const int j = s >> 3, k = (s >> 1) & 3, cy = s & 1;
    const int oy = 2 * ty + cy, ox = 2 * tx;
    if (4 * oy >= a.h) continue;
    const unsigned bits = s_wins[j][cy];
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int dy = 0; dy < 4; ++dy) {
#pragma unroll
      for (int cx = 0; cx < 2; ++cx) {
#pragma unroll
        for (int dx = 0; dx < 4; ++dx) {
          const int col = 4 * cx + dx;
          if ((bits >> (8 * dy + col)) & 1u)
            sum[cx] += k == 0 ? 1.0f : s_ml[k - 1][8 * (4 * cy + dy) + col];
        }
      }
    }
    const size_t m = (size_t)img * a.n_cand + c0 + j;
    float* dst = a.out + (m * 4 + k) * n_q + (size_t)oy * wq + ox;
    if (4 * ox + 4 < a.w && (wq & 1) == 0) {
      *reinterpret_cast<float2*>(dst) = make_float2(sum[0], sum[1]);
    } else {
      dst[0] = sum[0];
      if (4 * ox + 4 < a.w) dst[1] = sum[1];
    }
  }
  __syncthreads();  // s_ml and s_wins are written again
}

// Stage 3: 0 sums and +inf distances off the tiles of p (tile map given;
// H and W are multiples of 8 then). A thread takes one position of a
// plane, looks its tile up once and stores it for every reps-th candidate
// (reps: the threads there are for each position, at least 1).
template <bool kCiede>
__device__ void fill_off_tiles(const PooledArgs& a) {
  const int tiles_x = a.w / 8, tiles_y = a.h / 8, w4 = a.w / 4;
  const int threads = gridDim.x * kPooledThreads;
  const int g = blockIdx.x * kPooledThreads + threadIdx.x;
  if constexpr (kCiede) {
    // Positions: one float4 of a distance row, (image, y, x / 4).
    const int per_img = a.h * w4, n_pos = a.n_img * per_img;
    const int reps = max(1, threads / n_pos);
    float4* dst = reinterpret_cast<float4*>(a.dcand);
    const float4 inf = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                                   CUDART_INF_F);
    for (int i = g; i < reps * n_pos; i += threads) {
      const int pos = i % n_pos, img = pos / per_img, at = pos % per_img;
      if (a.tiles[(img * tiles_y + at / w4 / 8) * tiles_x + at % w4 / 2] ==
          a.p)
        continue;
      for (int b = i / n_pos; b < a.n_cand; b += reps)
        dst[((size_t)img * a.n_cand + b) * per_img + at] = inf;
    }
  }
  // Positions: one tile's row of two cells, (image, cell row, tile column),
  // stored for each candidate and each of the four sums.
  const int per_img = (a.h / 4) * tiles_x, n_pos = a.n_img * per_img;
  const int reps = max(1, threads / n_pos);
  float2* dst = reinterpret_cast<float2*>(a.out);
  for (int i = g; i < reps * n_pos; i += threads) {
    const int pos = i % n_pos, img = pos / per_img, at = pos % per_img;
    if (a.tiles[(img * tiles_y + at / tiles_x / 2) * tiles_x + at % tiles_x] ==
        a.p)
      continue;
    for (int bk = i / n_pos; bk < 4 * a.n_cand; bk += reps)
      dst[((size_t)img * a.n_cand * 4 + bk) * per_img + at] =
          make_float2(0.0f, 0.0f);
  }
}

// Candidates an item: the multiple of kGroups (at most kMaxChunk) that
// makes the last block finish first, counting for each of its items one
// unit of fixed cost (loads, barriers, pooling) and, for each candidate a
// group computes, kDistanceCost units: a CIEDE2000 costs about two items'
// overhead, a red-mean distance next to nothing. Called by the 32 lanes of
// one warp, lane l costing kGroups * (l + 1) candidates; ties go to the
// smaller chunk.
template <bool kCiede>
__device__ int chunk_size(int count, int n_cand, int grid) {
  constexpr float kDistanceCost = kCiede ? 2.0f : 0.05f;
  const int lane = threadIdx.x & 31;
  const int most = min(kMaxChunk, (n_cand + kGroups - 1) / kGroups * kGroups);
  const int per = kGroups * (lane + 1);
  float cost = 3.0e38f;
  if (per <= most) {
    const int items = count * ((n_cand + per - 1) / per);
    cost = (float)((items + grid - 1) / grid) *
           (1.0f + kDistanceCost * (float)(per / kGroups));
  }
  int best = lane;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const float other = __shfl_down_sync(0xffffffffu, cost, d);
    const int other_lane = __shfl_down_sync(0xffffffffu, best, d);
    if (other < cost || (other == cost && other_lane < best)) {
      cost = other;
      best = other_lane;
    }
  }
  return kGroups * (__shfl_sync(0xffffffffu, best, 0) + 1);
}

template <bool kCiede>
__device__ __forceinline__ void pooled_wins(const PooledArgs& a) {
  __shared__ int s_list[kSegment];
  __shared__ int s_warp[kPooledThreads / 32];
  __shared__ float s_ml[3][64];
  __shared__ unsigned s_wins[kMaxChunk][2];
  __shared__ int s_cand[3 * kMaxChunk];
  __shared__ int s_per;

  const bool restricted = a.tiles != nullptr;
  // Odd blocks store first and compute after, even ones the other way
  // round, so that an SM's stores overlap its arithmetic.
  const bool fill_first = blockIdx.x & 1;
  if (restricted && fill_first)
    fill_off_tiles<kCiede>(a);
  const int n_tiles = a.n_img * ((a.h + 7) / 8) * ((a.w + 7) / 8);
  // The tiles of p: listed for the first segment, counted for all.
  int count = n_tiles, listed0 = min(n_tiles, kSegment);
  if (restricted) {
    count = listed0 = list_tiles(a.tiles, a.p, 0, listed0, s_list, s_warp);
    for (int base = kSegment; base < n_tiles; base += kPooledThreads) {
      const int t = base + threadIdx.x;
      count += __syncthreads_count(t < n_tiles && a.tiles[t] == a.p);
    }
  }
  if (count > 0) {
    if (threadIdx.x < 32) {
      const int per = chunk_size<kCiede>(count, a.n_cand, gridDim.x);
      if (threadIdx.x == 0) s_per = per;
    }
    __syncthreads();
    const int per = s_per;
    const int n_chunks = (a.n_cand + per - 1) / per;
    const int grid = gridDim.x;
    int first = 0;  // items before this segment
    for (int seg = 0; seg < n_tiles; seg += kSegment) {
      const int seg_end = min(n_tiles, seg + kSegment);
      int listed = seg_end - seg;
      if (restricted)
        listed = seg == 0 ? listed0
                          : list_tiles(a.tiles, a.p, seg, seg_end, s_list,
                                       s_warp);
      const int last = first + listed * n_chunks;
      for (int item = first + (((int)blockIdx.x - first) % grid + grid) % grid;
           item < last; item += grid) {
        const int k = (item - first) / n_chunks;
        const int c0 = (item - first) % n_chunks * per;
        const int tile = seg + (restricted ? s_list[k] : k);
        pool_tile<kCiede>(a, tile, c0, min(per, a.n_cand - c0), s_ml, s_wins,
                          s_cand);
      }
      first = last;
      __syncthreads();  // s_list is written again
    }
  }
  if (restricted && !fill_first)
    fill_off_tiles<kCiede>(a);
}

__global__ void __launch_bounds__(kPooledThreads, 2)
pooled_wins_redmean_kernel(PooledArgs a) {
  pooled_wins<false>(a);
}

__global__ void __launch_bounds__(kPooledThreads, 2)
pooled_wins_ciede_kernel(PooledArgs a) {
  pooled_wins<true>(a);
}

// Blocks of a launch: resident ones only (at most kMaxBlocksPerSm an SM),
// and no more than the off-tile stores give a thread each.
template <bool kCiede>
static int pooled_grid(const PooledArgs& a, void (*kernel)(PooledArgs)) {
  static int resident[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) dev = 63;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kPooledThreads, 0);
    resident[dev] = max(1, sms * min(max(per_sm, 1), kMaxBlocksPerSm));
  }
  const long long quads =
      (long long)a.n_img * a.n_cand * a.h * (a.w / 4) / kPooledThreads;
  return (int)max(1LL, min((long long)resident[dev], quads));
}

template <bool kCiede>
static int launch_pooled(const PooledArgs& a, void* stream) {
  void (*kernel)(PooledArgs) =
      kCiede ? pooled_wins_ciede_kernel : pooled_wins_redmean_kernel;
  kernel<<<pooled_grid<kCiede>(a, kernel), kPooledThreads, 0,
           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace snes

extern "C" {

// tiles: (N, H/8, W/8) int32 and subpalette p, or null for every tile.
int snes_pooled_wins_redmean(const void* tg, const void* cand8,
                             const void* bva, const void* ml,
                             const void* tiles, int p, int n_img, int n_cand,
                             int h, int w, void* out, void* stream) {
  const snes::PooledArgs a = {tg, cand8, bva, nullptr, (const float*)ml,
                              (const int*)tiles, (float*)out, nullptr,
                              n_img, n_cand, h, w, p};
  return snes::launch_pooled<false>(a, stream);
}

int snes_pooled_wins_ciede(const void* tlab, const void* clab,
                           const void* bvalm, const void* adj, const void* ml,
                           const void* tiles, int p, int n_img, int n_cand,
                           int h, int w, void* out, void* dcand,
                           void* stream) {
  const snes::PooledArgs a = {tlab, clab, bvalm, (const int*)adj,
                              (const float*)ml, (const int*)tiles,
                              (float*)out, (float*)dcand, n_img, n_cand, h,
                              w, p};
  return snes::launch_pooled<true>(a, stream);
}

}  // extern "C"
