// Kernel G: Floyd-Steinberg wavefront remap of B candidate colours of one
// palette slot. For each (image, candidate) the whole error-diffusion remap
// of the image, with entry i of subpalette p replaced by the candidate's
// colour; output (N, B, H, W) int32 palette maps. A negative p replaces
// nothing (the full remap of the current palette).
//
// Replaces snesimage_tpu/ops/pallas_dither.py _dither_remap_batched
// (pallas_call at :566, body _make_kernel :296-480). Its semantic target is
// the XLA scan snesimage_tpu/ops/dither.py remap_dithered, which
// snesimage_torch/ops/dither.py repeats in torch: this kernel takes that
// twin's float32 operations in the twin's order, each an explicit
// round-to-nearest intrinsic. Error diffusion is chaotic: a product fused
// into a sum changes the last bit of a diffused error, one pixel flips, and
// the rest of the map follows. Never let nvcc contract this file's products.
//
// What is not carried over from the TPU kernel: the skewed, chunk-padded,
// lane-major copies of the image (a thread reads rgb[y, x] directly), the
// C-way compare-select rebuild of a pixel's subpalette (an indexed load from
// shared memory), the float32 red-mean (exact int32 here, as the scan's),
// and the polynomial sRGB decode, exp/log cube root and algebraic-hue
// CIEDE2000 (srgb_lab.cuh and ciede2000.cuh, the standard formulas).
//
// The wavefront: pixel (x, y) depends on (x-1, y), (x+1, y-1), (x, y-1) and
// (x-1, y-1), so row y may handle pixel x = c - 2y at step c; the image
// takes W + 2H - 2 steps, and row y is busy at steps [2y, 2y + W - 1] only.
//
// Row slots. R = min(H, ceil(W/2)) slots; rows y, y + R, y + 2R, ... share
// slot y mod R, one after another: row y + R starts at step 2y + 2R >=
// 2y + W, so every slot works at every step of its life. A slot keeps its
// row's error window (columns x, x + 1, x + 2, three channels) and hands
// the three contributions to the row below (SW, S, SE) to the next slot,
// which adds them one step later. Near the end of a row (x >= W - 2) the
// row above has passed it, and what arrives from the previous slot belongs
// to the slot's next row: it goes to a second window, which becomes the
// window when the row ends. Slot 0 receives from slot R - 1; on row 0
// nothing is taken from above.
//
// Lanes per slot. Each slot has L lanes of one warp (L divides 32); lane k
// evaluates entries k, k + L, ... and the group reduces its (distance,
// entry) pairs by shuffle: the smaller distance wins, a tie goes to the
// smaller entry. That is the serial strict-< scan with the first index
// winning (src/lib.rs:780-792), as distances are finite and not negative.
// Every lane of a group then holds the winner and computes the same error
// window from the same inputs in the same order, so no broadcast sits on
// the dependent chain; the leader writes the map. The hand-down goes by
// __shfl_up_sync by L lanes inside a warp and through a double buffer in
// shared memory across warps (and from slot R - 1 to slot 0), with one
// barrier a step. With a cluster of two blocks per candidate, the slots are
// split between the blocks, the boundary hand-downs go through distributed
// shared memory and the barrier is the cluster's.
//
// The block's entry table is its own copy with slot (p, i) overwritten, so
// the candidate override costs nothing per pixel; the entries arrive as
// 5-bit colours and are expanded here. Each slot's pixels are loaded
// kAhead steps before they are needed, off the dependent chain.
//
// What bounds it on the card: nothing a roofline names. The function is a
// chain of W + 2H - 2 dependent steps (766 at 256x256), each a distance
// search over S entries, a reduction over L lanes, a neighbour exchange and
// a barrier. The bytes (the image once, 12.6 MB of maps per 48-candidate
// visit) and the arithmetic are small beside that.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "ciede2000.cuh"
#include "srgb_lab.cuh"

namespace cg = cooperative_groups;

namespace snes {

// Mirror of snesimage_torch.ops._kernels.DitherParams.
struct DitherParams {
  float wgt[4];  // damped [E, SW, S, SE] weights
  LabParams lab;
};

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
// The most threads a block of any variant has (R <= 512 row slots at L = 1).
constexpr int kMaxThreads = 512;

struct Pixel {
  int r, g, b, live, sub;
};

// rgb (H, W, 3) int32, alpha (H, W) int32, tiles (H/8, W/8) int32.
__device__ __forceinline__ Pixel load_pixel(const int* rgb, const int* alpha,
                                            const int* tiles, int h, int w,
                                            int y, int x) {
  Pixel px = {0, 0, 0, 0, 0};
  if (y < h && x >= 0 && x < w) {
    const size_t at = (size_t)y * w + x;
    px.r = rgb[at * 3];
    px.g = rgb[at * 3 + 1];
    px.b = rgb[at * 3 + 2];
    px.live = alpha[at] > 0;
    px.sub = tiles[(y >> 3) * (w >> 3) + (x >> 3)];
  }
  return px;
}

// clamp to [0, 255], round half away from zero: floor(x + 0.5).
__device__ __forceinline__ int quantize(float t) {
  return (int)floorf(__fadd_rn(fminf(fmaxf(t, 0.0f), 255.0f), 0.5f));
}

__device__ __forceinline__ int expand5(int c) {
  c = min(max(c, 0), 31);
  return c * 8 + c / 4;
}

// Above every distance: the start of a lane's search.
template <typename D>
__device__ __forceinline__ D no_dist();
template <>
__device__ __forceinline__ int no_dist<int>() { return INT_MAX; }
template <>
__device__ __forceinline__ float no_dist<float>() {
  return __int_as_float(0x7f800000);  // +inf
}

// (distance, entry) as one integer whose order is the lexicographic one,
// for the reduction over a slot's lanes: distances are not negative, so
// their bits order as unsigned integers (a -0 distance is first folded
// into +0, which it equals). A lane without entries holds the largest
// distance and entry S, which every real entry beats.
__device__ __forceinline__ unsigned long long search_key(int d, int s) {
  return ((unsigned long long)(unsigned)d << 32) | (unsigned)s;
}
__device__ __forceinline__ unsigned long long search_key(float d, int s) {
  return ((unsigned long long)__float_as_uint(__fadd_rn(d, 0.0f)) << 32) |
         (unsigned)s;
}

}  // namespace

// rgb (N, H, W, 3) i32; alpha (N, H, W) i32; tiles (N, H/8, W/8) i32;
// entries5 (N, C, S, 3) i32 5-bit entries; cand5 (N, B, 3) i32 5-bit
// candidates; out (N, B, H, W) i32. Grid: N * B * kCluster blocks, each of
// at least slots_per_block * kLanes threads (a multiple of 32); slots
// (kCluster * slots_per_block >= n_slots = R) are numbered block by block.
template <bool kPerceptual, int kLanes, int kCluster>
__global__ void __launch_bounds__(kMaxThreads)
dither_remap_kernel(const int* __restrict__ rgb,
                    const int* __restrict__ alpha,
                    const int* __restrict__ tiles,
                    const int* __restrict__ entries5,
                    const int* __restrict__ cand5, int n_cand, int h, int w,
                    int c_sub, int s_ent, int p, int i_slot, int n_slots,
                    int slots_per_block, DitherParams prm,
                    int* __restrict__ out) {
  static_assert(32 % kLanes == 0, "L divides the warp");
  // Distances: exact int32 red-mean, or CIEDE2000.
  using Dist = std::conditional_t<kPerceptual, float, int>;
  extern __shared__ __align__(16) unsigned char raw[];
  const int n_ent = c_sub * s_ent;
  const int n_warps = blockDim.x >> 5;
  // One 16-byte vector per entry: a lane reads an entry in one load.
  int4* table = reinterpret_cast<int4*>(raw);                  // 8-bit RGB
  float4* lab = reinterpret_cast<float4*>(table + n_ent);      // its Lab
  float* lut = reinterpret_cast<float*>(lab + n_ent);          // 256
  float* hand = lut + 256;              // [2][n_warps][9]: a warp's last slot
  float* tail = hand + 2 * n_warps * 9;  // [2][9]: the block's last slot

  int part = 0;  // the block's rank in its cluster
  if constexpr (kCluster > 1) part = (int)cg::this_cluster().block_rank();
  const int m = blockIdx.x / kCluster;  // (image, candidate)
  const int img = m / n_cand;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int k = tid % kLanes;   // lane within the slot's group
  const int sl = tid / kLanes;  // slot within the block
  const int slot = part * slots_per_block + sl;
  const int last_sl =
      min(slots_per_block, n_slots - part * slots_per_block) - 1;
  const unsigned group =
      kLanes == 32 ? kFullMask
                   : ((1u << kLanes) - 1u) << (lane & ~(kLanes - 1));
  const size_t plane = (size_t)h * w;
  rgb += (size_t)img * plane * 3;
  alpha += (size_t)img * plane;
  tiles += (size_t)img * (h >> 3) * (w >> 3);
  entries5 += (size_t)img * n_ent * 3;
  int* omap = out + (size_t)m * plane;

  for (int t = tid; t < 256; t += blockDim.x) {
    lut[t] = prm.lab.lut[t];
  }
  for (int t = tid; t < 2 * n_warps * 9 + 18; t += blockDim.x) {
    hand[t] = 0.0f;  // and tail
  }
  __syncthreads();
  // The block's own entry table: slot (p, i) holds the candidate.
  for (int e = tid; e < n_ent; e += blockDim.x) {
    const bool over = p >= 0 && e == p * s_ent + i_slot;
    const int* src = over ? cand5 + (size_t)m * 3 : entries5 + e * 3;
    const int r = expand5(src[0]), g = expand5(src[1]), b = expand5(src[2]);
    table[e] = make_int4(r, g, b, 0);
    if (kPerceptual) {
      float4 el = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      srgb_u8_to_lab(prm.lab, lut, r, g, b, el.x, el.y, el.z);
      lab[e] = el;
    }
  }
  if constexpr (kCluster > 1) {
    cg::this_cluster().sync();  // every block of the cluster has started
  } else {
    __syncthreads();
  }

  // The slot's current row; slots past the last (padding) are never busy.
  int y = sl <= last_sl ? slot : h;
  // win[col][ch]: accumulated error of columns x, x + 1, x + 2 of the row;
  // nxt: the same for the slot's next row, filled while x >= W - 2.
  float win[3][3] = {};
  float nxt[3][3] = {};
  const int n_steps = w + 2 * h - 2;
  // ahead[j]: the pixel of the step c with c % kAhead == j, loaded kAhead
  // steps before its use. The step loop is unrolled kAhead times, so each
  // ring entry stays in its own registers and no move waits on a load.
  // Where is the slot at step c + d? On its row while x + d < W, else on
  // its next row.
  constexpr int kAhead = kPerceptual ? 1 : 4;
  Pixel ahead[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const int yy = j - 2 * y >= w ? y + n_slots : y;
    ahead[j] = load_pixel(rgb, alpha, tiles, h, w, yy, j - 2 * yy);
  }

  // Steps past the last (to fill the unrolled loop) find every slot idle.
  for (int c0 = 0; c0 < n_steps; c0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int c = c0 + j;
      const int x = c - 2 * y;
      const bool valid = y < h && x >= 0;  // x < W: rows switch at x = W - 1
      const Pixel px = ahead[j];
      {
        const int yy = x + kAhead >= w ? y + n_slots : y;
        ahead[j] =
            load_pixel(rgb, alpha, tiles, h, w, yy, c + kAhead - 2 * yy);
      }

      float perr[3] = {0.0f, 0.0f, 0.0f};
      if (valid) {
        int best = 0;
        if (px.live) {
          const float t0 = __fadd_rn((float)px.r, win[0][0]);
          const float t1 = __fadd_rn((float)px.g, win[0][1]);
          const float t2 = __fadd_rn((float)px.b, win[0][2]);
          const int qr = quantize(t0), qg = quantize(t1), qb = quantize(t2);
          const int4* ent = table + px.sub * s_ent;
          // The lane's own entries in order, strict <: its first minimum.
          Dist best_d = no_dist<Dist>();
          best = s_ent;
          if constexpr (kPerceptual) {
            float tl, ta, tb;
            srgb_u8_to_lab(prm.lab, lut, qr, qg, qb, tl, ta, tb);
            const float4* el = lab + px.sub * s_ent;
            for (int s = k; s < s_ent; s += kLanes) {
              // Entry first, target second, as the torch code orders them.
              const float4 e = el[s];
              const float d = ciede2000(e.x, e.y, e.z, tl, ta, tb);
              if (d < best_d) {
                best_d = d;
                best = s;
              }
            }
          } else {
            for (int s = k; s < s_ent; s += kLanes) {
              const int4 e = ent[s];
              const int dr = e.x - qr, dg = e.y - qg, db = e.z - qb;
              const int rsum = e.x + qr;
              const int d = (1024 + rsum) * dr * dr + 2048 * dg * dg +
                            (1534 - rsum) * db * db;
              if (d < best_d) {
                best_d = d;
                best = s;
              }
            }
          }
          if constexpr (kLanes > 1) {
            unsigned long long key = search_key(best_d, best);
#pragma unroll
            for (int off = kLanes / 2; off > 0; off >>= 1) {
              const unsigned long long other = __shfl_xor_sync(group, key, off);
              key = other < key ? other : key;
            }
            best = (int)(unsigned)key;
          }
          const int4 chosen = ent[best];
          perr[0] = __fsub_rn(t0, (float)chosen.x);
          perr[1] = __fsub_rn(t1, (float)chosen.y);
          perr[2] = __fsub_rn(t2, (float)chosen.z);
        } else {
          // A transparent pixel passes its accumulated error on unchanged.
          perr[0] = win[0][0];
          perr[1] = win[0][1];
          perr[2] = win[0][2];
        }
        if (k == 0) omap[(size_t)y * w + x] = best;
      }

      // E and SE are masked at x + 1 = W, SW at x = 0; each mask multiplies
      // last, as in the twin.
      const float m_e = valid && x + 1 < w ? 1.0f : 0.0f;
      const float m_sw = valid && x > 0 ? 1.0f : 0.0f;
      const float m_s = valid ? 1.0f : 0.0f;
      const int buf = c & 1;
      float down[9], from_up[9];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        down[ch] = __fmul_rn(__fmul_rn(perr[ch], prm.wgt[1]), m_sw);
        down[3 + ch] = __fmul_rn(__fmul_rn(perr[ch], prm.wgt[2]), m_s);
        down[6 + ch] = __fmul_rn(__fmul_rn(perr[ch], prm.wgt[3]), m_e);
      }
#pragma unroll
      for (int v = 0; v < 9; ++v) {
        from_up[v] = __shfl_up_sync(kFullMask, down[v], kLanes);
      }
      if (k == 0 && lane >= 32 - kLanes) {  // the warp's last slot
#pragma unroll
        for (int v = 0; v < 9; ++v) {
          hand[(buf * n_warps + warp) * 9 + v] = down[v];
        }
      }
      if (k == 0 && sl == last_sl) {  // the block's last slot
#pragma unroll
        for (int v = 0; v < 9; ++v) tail[buf * 9 + v] = down[v];
      }
      if constexpr (kCluster > 1) {
        cg::this_cluster().sync();
      } else {
        __syncthreads();
      }
      if (lane < kLanes) {  // the warp's first slot
        const float* theirs = tail + buf * 9;
        if (warp > 0) {
          theirs = hand + (buf * n_warps + warp - 1) * 9;
        } else if constexpr (kCluster > 1) {
          theirs = cg::this_cluster().map_shared_rank(
                       tail, (part + kCluster - 1) % kCluster) + buf * 9;
        }
#pragma unroll
        for (int v = 0; v < 9; ++v) from_up[v] = theirs[v];
      }
      // What arrives belongs to this row while the row above has pixels
      // left for it (x <= W - 3, and never on row 0), else to the next row.
      const bool into_next = x >= w - 2;
      const bool into_this = !into_next && y > 0;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float east = __fmul_rn(__fmul_rn(perr[ch], prm.wgt[0]), m_e);
        const float add1 = __fadd_rn(east, into_this ? from_up[ch] : 0.0f);
        win[0][ch] = __fadd_rn(win[1][ch], add1);
        win[1][ch] = __fadd_rn(win[2][ch], into_this ? from_up[3 + ch] : 0.0f);
        win[2][ch] = into_this ? from_up[6 + ch] : 0.0f;
        nxt[0][ch] = __fadd_rn(nxt[1][ch], into_next ? from_up[ch] : 0.0f);
        nxt[1][ch] = __fadd_rn(nxt[2][ch], into_next ? from_up[3 + ch] : 0.0f);
        nxt[2][ch] = into_next ? from_up[6 + ch] : 0.0f;
      }
      if (x == w - 1) {  // the row ends: the slot's next row takes over
        y += n_slots;
#pragma unroll
        for (int col = 0; col < 3; ++col) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            win[col][ch] = nxt[col][ch];
            nxt[col][ch] = 0.0f;
          }
        }
      }
    }
  }
  if constexpr (kCluster > 1) {
    cg::this_cluster().sync();  // no block leaves while its tail is read
  }
}

template <bool kPerceptual, int kLanes, int kCluster>
cudaError_t launch_dither(int n_blocks, int n_slots, size_t smem,
                          cudaStream_t stream, const int* rgb,
                          const int* alpha, const int* tiles,
                          const int* entries5, const int* cand5, int n_cand,
                          int h, int w, int c_sub, int s_ent, int p,
                          int i_slot, const DitherParams& prm, int* out) {
  const int per_block = (n_slots + kCluster - 1) / kCluster;
  const int threads = (per_block * kLanes + 31) / 32 * 32;
  if (threads > kMaxThreads) return cudaErrorInvalidConfiguration;
  auto kernel = dither_remap_kernel<kPerceptual, kLanes, kCluster>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks * kCluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (kCluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(&cfg, kernel, rgb, alpha, tiles, entries5, cand5,
                            n_cand, h, w, c_sub, s_ent, p, i_slot, n_slots,
                            per_block, prm, out);
}

}  // namespace snes

// rgb (N, H, W, 3), alpha (N, H, W), tiles (N, H/8, W/8), entries5
// (N, C, S, 3) and cand5 (N, B, 3) 5-bit colours, all int32; out
// (N, B, H, W) int32. `lanes` and `cluster` pick a built variant, the ones
// ops/cuda_dither.py `variant` can choose: red-mean L = 1; perceptual L = 8
// over a cluster of two blocks, then L = 2 and L = 1 in one block where more
// row slots leave those no room.
extern "C" int snes_dither_remap(const void* rgb, const void* alpha,
                                 const void* tiles, const void* entries5,
                                 const void* cand5, int n_img, int n_cand,
                                 int h, int w, int c_sub, int s_ent, int p,
                                 int i_slot, int perceptual, int lanes,
                                 int cluster,
                                 const snes::DitherParams* params, void* out,
                                 void* stream) {
  if (h < 1 || w < 1 || h % 8 || w % 8) return (int)cudaErrorInvalidValue;
  const int n_slots = h < (w + 1) / 2 ? h : (w + 1) / 2;
  const int per_block = (n_slots + cluster - 1) / cluster;
  const int threads = (per_block * lanes + 31) / 32 * 32;
  const size_t smem = (sizeof(int4) + sizeof(float4)) * c_sub * s_ent +
                      sizeof(float) * (256 + 2 * (threads / 32) * 9 + 18);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  const int blocks = n_img * n_cand;
  const auto* e5 = (const int*)entries5;
  const auto* c5 = (const int*)cand5;
  const auto* im = (const int*)rgb;
  const auto* al = (const int*)alpha;
  const auto* tl = (const int*)tiles;
  auto* o = (int*)out;
  const auto& prm = *params;
#define SNES_DITHER(PERC, L, CL)                                            \
  if (perceptual == PERC && lanes == L && cluster == CL) {                  \
    return (int)snes::launch_dither<PERC, L, CL>(                           \
        blocks, n_slots, smem, st, im, al, tl, e5, c5, n_cand, h, w, c_sub, \
        s_ent, p, i_slot, prm, o);                                          \
  }
  SNES_DITHER(0, 1, 1)
  SNES_DITHER(1, 8, 2)
  SNES_DITHER(1, 2, 1)
  SNES_DITHER(1, 1, 1)
#undef SNES_DITHER
  return (int)cudaErrorInvalidValue;
}
