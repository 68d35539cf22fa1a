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
// Layout: one block per (image, candidate), one thread per image row. At
// step c the thread of row y handles pixel x = c - 2y when 0 <= x < W:
// every pixel it depends on, (x-1, y), (x+1, y-1), (x, y-1), (x-1, y-1),
// was handled at an earlier step. A thread keeps its row's error window
// (columns x, x+1, x+2, three channels) in nine registers and hands the
// three contributions to the row below (SW, S, SE) to the next thread: by
// __shfl_up_sync inside a warp, through shared memory from lane 31 to lane
// 0 of the next warp, with one __syncthreads() per step on a double buffer.
// The block's entry table is its own copy with slot (p, i) overwritten, so
// the candidate override costs nothing per pixel. The pixel of step c + 1 is
// loaded during step c, off the dependent chain.
//
// What bounds it on the card: nothing a roofline names. The function is a
// chain of W + 2H - 2 dependent steps (766 at 256x256), each a distance
// search over S entries, a neighbour exchange and a block barrier, and
// B = 48 blocks fill 48 of 132 SMs. The bytes (the image once, 12.6 MB of
// maps per 48-candidate visit) and the arithmetic are small beside that.
#include <cuda_runtime.h>

#include "ciede2000.cuh"
#include "srgb_lab.cuh"

namespace snes {

// Mirror of snesimage_torch.ops._kernels.DitherParams.
struct DitherParams {
  float wgt[4];  // damped [E, SW, S, SE] weights
  LabParams lab;
};

namespace {

constexpr int kMaxRows = 256;  // one thread per image row
constexpr unsigned kFullMask = 0xffffffffu;

struct Pixel {
  int r, g, b, live, sub;
};

// rgb (H, W, 3) int32, alpha (H, W) int32, tiles (H/8, W/8) int32.
__device__ __forceinline__ Pixel load_pixel(const int* rgb, const int* alpha,
                                            const int* tiles, int w, int y,
                                            int x, bool valid) {
  Pixel px = {0, 0, 0, 0, 0};
  if (valid) {
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

}  // namespace

// rgb (N, H, W, 3) i32; alpha (N, H, W) i32; tiles (N, H/8, W/8) i32;
// entries8 (N, C, S, 3) i32 8-bit entries; cand8 (N, B, 3) i32 8-bit
// candidates; out (N, B, H, W) i32. Grid: N * B blocks of >= H threads, at
// most kMaxRows (the bound leaves the CIEDE2000 path its registers).
template <bool kPerceptual>
__global__ void __launch_bounds__(kMaxRows)
dither_remap_kernel(const int* __restrict__ rgb,
                    const int* __restrict__ alpha,
                    const int* __restrict__ tiles,
                    const int* __restrict__ entries8,
                    const int* __restrict__ cand8, int n_cand, int h, int w,
                    int c_sub, int s_ent, int p, int i_slot, DitherParams prm,
                    int* __restrict__ out) {
  extern __shared__ unsigned char raw[];
  const int n_ent = c_sub * s_ent;
  int* table = reinterpret_cast<int*>(raw);                 // n_ent * 3
  float* lab = reinterpret_cast<float*>(table + n_ent * 3);  // n_ent * 3
  float* lut = lab + n_ent * 3;                              // 256
  float* hand = lut + 256;  // 2 buffers * warps * 9

  const int m = blockIdx.x;
  const int img = m / n_cand;
  const int y = threadIdx.x;
  const int lane = y & 31, warp = y >> 5, n_warps = blockDim.x >> 5;
  const size_t plane = (size_t)h * w;
  rgb += (size_t)img * plane * 3;
  alpha += (size_t)img * plane;
  tiles += (size_t)img * (h >> 3) * (w >> 3);
  entries8 += (size_t)img * n_ent * 3;
  int* omap = out + (size_t)m * plane;

  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    lut[t] = prm.lab.lut[t];
  }
  for (int t = threadIdx.x; t < 2 * n_warps * 9; t += blockDim.x) {
    hand[t] = 0.0f;
  }
  __syncthreads();
  // The block's own entry table: slot (p, i) holds the candidate.
  for (int e = threadIdx.x; e < n_ent; e += blockDim.x) {
    const bool slot = p >= 0 && e == p * s_ent + i_slot;
    const int* src = slot ? cand8 + (size_t)m * 3 : entries8 + e * 3;
    const int r = src[0], g = src[1], b = src[2];
    table[e * 3] = r;
    table[e * 3 + 1] = g;
    table[e * 3 + 2] = b;
    if (kPerceptual) {
      srgb_u8_to_lab(prm.lab, lut, r, g, b, lab[e * 3], lab[e * 3 + 1],
                     lab[e * 3 + 2]);
    }
  }
  __syncthreads();

  const bool row = y < h;
  // win[col][ch]: accumulated error of columns x, x + 1, x + 2 of this row.
  float win[3][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  const int n_steps = w + 2 * h - 2;
  Pixel next = load_pixel(rgb, alpha, tiles, w, y, -2 * y, row && y == 0);

  for (int c = 0; c < n_steps; ++c) {
    const int x = c - 2 * y;
    const bool valid = row && x >= 0 && x < w;
    const Pixel px = next;
    next = load_pixel(rgb, alpha, tiles, w, y, x + 1,
                      row && x + 1 >= 0 && x + 1 < w);

    float perr[3] = {0.0f, 0.0f, 0.0f};
    if (valid) {
      int best = 0;
      if (px.live) {
        const float t0 = __fadd_rn((float)px.r, win[0][0]);
        const float t1 = __fadd_rn((float)px.g, win[0][1]);
        const float t2 = __fadd_rn((float)px.b, win[0][2]);
        const int qr = quantize(t0), qg = quantize(t1), qb = quantize(t2);
        const int* ent = table + px.sub * s_ent * 3;
        if (kPerceptual) {
          float tl, ta, tb;
          srgb_u8_to_lab(prm.lab, lut, qr, qg, qb, tl, ta, tb);
          const float* el = lab + px.sub * s_ent * 3;
          float best_d = 0.0f;
          for (int s = 0; s < s_ent; ++s) {
            // Entry first, target second, as the torch code orders them.
            const float d = ciede2000(el[s * 3], el[s * 3 + 1], el[s * 3 + 2],
                                      tl, ta, tb);
            if (s == 0 || d < best_d) {  // strict <: the first index wins
              best_d = d;
              best = s;
            }
          }
        } else {
          int best_d = 0;
          for (int s = 0; s < s_ent; ++s) {
            const int er = ent[s * 3];
            const int dr = er - qr, dg = ent[s * 3 + 1] - qg,
                      db = ent[s * 3 + 2] - qb;
            const int rsum = er + qr;
            const int d = (1024 + rsum) * dr * dr + 2048 * dg * dg +
                          (1534 - rsum) * db * db;
            if (s == 0 || d < best_d) {
              best_d = d;
              best = s;
            }
          }
        }
        perr[0] = __fsub_rn(t0, (float)ent[best * 3]);
        perr[1] = __fsub_rn(t1, (float)ent[best * 3 + 1]);
        perr[2] = __fsub_rn(t2, (float)ent[best * 3 + 2]);
      } else {
        // A transparent pixel passes its accumulated error on unchanged.
        perr[0] = win[0][0];
        perr[1] = win[0][1];
        perr[2] = win[0][2];
      }
      omap[(size_t)y * w + x] = best;
    }

    // E and SE are masked at x + 1 = W, SW at x = 0; each mask multiplies
    // last, as in the twin.
    const float m_e = valid && x + 1 < w ? 1.0f : 0.0f;
    const float m_sw = valid && x > 0 ? 1.0f : 0.0f;
    const float m_s = valid ? 1.0f : 0.0f;
    float* mine = hand + ((c & 1) * n_warps + warp) * 9;
    float from_up[9];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float sw = __fmul_rn(__fmul_rn(perr[ch], prm.wgt[1]), m_sw);
      const float so = __fmul_rn(__fmul_rn(perr[ch], prm.wgt[2]), m_s);
      const float se = __fmul_rn(__fmul_rn(perr[ch], prm.wgt[3]), m_e);
      from_up[ch] = __shfl_up_sync(kFullMask, sw, 1);
      from_up[3 + ch] = __shfl_up_sync(kFullMask, so, 1);
      from_up[6 + ch] = __shfl_up_sync(kFullMask, se, 1);
      if (lane == 31) {
        mine[ch] = sw;
        mine[3 + ch] = so;
        mine[6 + ch] = se;
      }
    }
    __syncthreads();
    if (lane == 0) {
      const float* theirs = hand + ((c & 1) * n_warps + warp - 1) * 9;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        from_up[k] = warp > 0 ? theirs[k] : 0.0f;
      }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float east = __fmul_rn(__fmul_rn(perr[ch], prm.wgt[0]), m_e);
      const float add1 = __fadd_rn(east, from_up[ch]);
      win[0][ch] = __fadd_rn(win[1][ch], add1);
      win[1][ch] = __fadd_rn(win[2][ch], from_up[3 + ch]);
      win[2][ch] = from_up[6 + ch];
    }
  }
}

template <bool kPerceptual>
cudaError_t launch_dither(int blocks, int threads, size_t smem,
                          cudaStream_t stream, const int* rgb,
                          const int* alpha, const int* tiles,
                          const int* entries8, const int* cand8, int n_cand,
                          int h, int w, int c_sub, int s_ent, int p,
                          int i_slot, const DitherParams& prm, int* out) {
  dither_remap_kernel<kPerceptual><<<blocks, threads, smem, stream>>>(
      rgb, alpha, tiles, entries8, cand8, n_cand, h, w, c_sub, s_ent, p,
      i_slot, prm, out);
  return cudaGetLastError();
}

}  // namespace snes

extern "C" int snes_dither_remap(const void* rgb, const void* alpha,
                                 const void* tiles, const void* entries8,
                                 const void* cand8, int n_img, int n_cand,
                                 int h, int w, int c_sub, int s_ent, int p,
                                 int i_slot, int perceptual,
                                 const snes::DitherParams* params, void* out,
                                 void* stream) {
  if (h < 1 || h > snes::kMaxRows || h % 8 || w % 8) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = (h + 31) / 32 * 32;
  const size_t smem = sizeof(int) * c_sub * s_ent * 3 +
                      sizeof(float) * (c_sub * s_ent * 3 + 256 +
                                       2 * (threads / 32) * 9);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  auto launch = perceptual ? snes::launch_dither<true>
                           : snes::launch_dither<false>;
  return (int)launch(n_img * n_cand, threads, smem, (cudaStream_t)stream,
                     (const int*)rgb, (const int*)alpha, (const int*)tiles,
                     (const int*)entries8, (const int*)cand8, n_cand, h, w,
                     c_sub, s_ent, p, i_slot, *params, (int*)out);
}
