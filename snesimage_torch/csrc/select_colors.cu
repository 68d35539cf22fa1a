// Kernel A: colour planes selected from a small linear entry table by pixel
// key, and 0 where the key is outside [0, K) (the sentinel K marks
// transparent pixels). Three entry points share the per-block table in
// shared memory:
//
//   snes_select_colors   out[n, ch, px] = table[n, ch, key[n, px]], key and
//                        table given: the direct counterpart of the TPU
//                        kernel;
//   snes_select_colors_prologue
//                        the undithered visit's prologue: from the distance
//                        cache d_all (S, H, W) it finds each pixel's best
//                        entry with and without slot i (first minimum), and
//                        writes in one launch the no-candidate frame lnc
//                        and palette map, the win-rule operands of kernels
//                        C to F (bva, or bvalm and adj), the masked frame
//                        ml and the mask of subpalette p;
//   snes_select_colors_render
//                        the dithered visit's render: the (B, H, W) palette
//                        maps of kernel G to (B, 3, H, W) linear frames,
//                        map b with candidate b in slot (p, i).
//
// The two fused entries build the (3, C*S) table themselves from the 5-bit
// palette: the 5->8 bit expansion, then the exact 256-entry sRGB decode
// table on the card (snesimage_torch/ops/color.py `_linear_lut`, the table
// `srgb_u8_to_linear` gathers from). Every output is a comparison, a copy or
// an integer add, so each equals its plain twin (ops/cuda_prescreen.py) bit
// for bit.
//
// Replaces snesimage_tpu/ops/pallas_prescreen.py _select_colors_pallas_n
// (pallas_call at :386, body _select_kernel :373-381). The TPU kernel
// unrolls a compare-select over the K table entries because per-pixel
// gathers were slow there; on the card a gather from a table staged in
// shared memory is direct. One thread per pixel (four in the render, whose
// blocks each build a candidate's table); the table (3 x K <= 720 floats) is
// loaded or built once per block. All three are bound by device memory: the
// key or map planes or the S distance planes read once, coalesced along
// pixels, and the planes written once. The fused entries exist because the
// twenty-odd small torch operations they replace cost more host time per
// visit than the card spends on the whole visit's prologue.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kRenderPixels = 4;  // pixels per thread of the render
constexpr float kBig = 3.0e38f;  // the float cache's exclusion value

__device__ __forceinline__ int expand5(int c) {
  c = min(max(c, 0), 31);
  return c * 8 + c / 4;
}

// tbl[ch * k + e] = linear colour of entry e (palette5 is (k, 3) 5-bit,
// lut the 256 decoded codes); entry `slot` (if >= 0) takes the 5-bit colour
// `over` instead.
__device__ __forceinline__ void build_table(float* tbl, const int* palette5,
                                            int k, int slot, const int* over,
                                            const float* lut) {
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    const int* src = e == slot ? over : palette5 + e * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      tbl[ch * k + e] = __ldg(lut + expand5(src[ch]));
    }
  }
}

__global__ void select_colors_kernel(const int* __restrict__ key,
                                     const float* __restrict__ table,
                                     float* __restrict__ out, int n_px,
                                     int k) {
  extern __shared__ float tbl[];
  const int img = blockIdx.y;
  for (int i = threadIdx.x; i < 3 * k; i += blockDim.x) {
    tbl[i] = table[(size_t)img * 3 * k + i];
  }
  __syncthreads();
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  if (px >= n_px) return;
  const int kk = key[(size_t)img * n_px + px];
  const bool valid = kk >= 0 && kk < k;
  float* dst = out + (size_t)img * 3 * n_px + px;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    dst[(size_t)ch * n_px] = valid ? tbl[ch * k + kk] : 0.0f;
  }
}

template <typename D>
struct Rule;

// Red-mean: one int32 threshold with the tie rule and the mask folded in.
template <>
struct Rule<int> {
  static constexpr int kBigValue = INT_MAX;
  __device__ static void write(int* thr, int* /*adj*/, int px, bool mask,
                               int best, bool adj) {
    thr[px] = mask ? (best == INT_MAX ? best : best + (int)adj) : INT_MIN;
  }
};

// Perceptual: the best distance, -3e38 off the mask, and the tie flag.
template <>
struct Rule<float> {
  static constexpr float kBigValue = kBig;
  __device__ static void write(float* thr, int* adj_out, int px, bool mask,
                               float best, bool adj) {
    thr[px] = mask ? best : -kBig;
    adj_out[px] = (int)adj;
  }
};

// d_all (S, H*W); tiles (H/8, W/8); alpha (H*W); palette5 (C*S, 3).
// Outputs (H*W) planes best_val, best_idx, base_idx, affected (bool),
// map_nc, thr (and adj), and (3, H*W) planes lnc and ml.
template <typename D>
__global__ void __launch_bounds__(kThreads) prologue_kernel(
    const D* __restrict__ d_all, const int* __restrict__ tiles,
    const int* __restrict__ alpha, const int* __restrict__ palette5, int h,
    int w, int c_sub, int s_ent, int p, int i_slot,
    const float* __restrict__ lut, D* __restrict__ best_val,
    int* __restrict__ best_idx, int* __restrict__ base_idx,
    unsigned char* __restrict__ affected_out, int* __restrict__ map_nc,
    float* __restrict__ lnc, D* __restrict__ thr, int* __restrict__ adj,
    float* __restrict__ ml) {
  extern __shared__ float tbl[];
  const int k = c_sub * s_ent;
  build_table(tbl, palette5, k, -1, nullptr, lut);
  __syncthreads();
  const int n_px = h * w;
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  if (px >= n_px) return;
  const int y = px / w, x = px - y * w;
  const int sub = tiles[(y >> 3) * (w >> 3) + (x >> 3)];
  // First minima: over all entries (base), and with slot i excluded (its
  // distance replaced by the largest value, as the twin's torch.where).
  const D d0 = d_all[px];
  D base_v = d0, best_v = i_slot == 0 ? Rule<D>::kBigValue : d0;
  int base_i = 0, best_i = 0;
  for (int s = 1; s < s_ent; ++s) {
    const D d = d_all[(size_t)s * n_px + px];
    if (d < base_v) {
      base_v = d;
      base_i = s;
    }
    const D dm = s == i_slot ? Rule<D>::kBigValue : d;
    if (dm < best_v) {
      best_v = dm;
      best_i = s;
    }
  }
  best_val[px] = best_v;
  best_idx[px] = best_i;
  base_idx[px] = base_i;
  // Affected pixels take their best other entry, the rest their best
  // entry, transparent pixels the sentinel (colour 0, entry 0).
  const bool affected = sub == p;
  const bool opaque = alpha[px] > 0;
  const int idx_nc = affected ? best_i : base_i;
  affected_out[px] = affected;
  map_nc[px] = opaque ? idx_nc : 0;
  const int key = opaque ? sub * s_ent + idx_nc : k;
  const bool valid = key >= 0 && key < k;
  const bool mask = affected && opaque;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float v = valid ? tbl[ch * k + key] : 0.0f;
    lnc[(size_t)ch * n_px + px] = v;
    ml[(size_t)ch * n_px + px] = mask ? v : 0.0f;
  }
  Rule<D>::write(thr, adj, px, mask, best_v, i_slot < best_i);
}

// maps (B, H*W) entry indices; cand5 (B, 3) 5-bit candidates; out
// (B, 3, H*W). Grid (pixel blocks of kThreads * kRenderPixels, B): block
// (., b) builds candidate b's table, entry p * S + i replaced by the
// candidate.
__global__ void __launch_bounds__(kThreads) render_kernel(
    const int* __restrict__ maps, const int* __restrict__ tiles,
    const int* __restrict__ alpha, const int* __restrict__ palette5,
    const int* __restrict__ cand5, int h, int w, int c_sub, int s_ent, int p,
    int i_slot, const float* __restrict__ lut, float* __restrict__ out) {
  extern __shared__ float tbl[];
  const int k = c_sub * s_ent;
  const int b = blockIdx.y;
  build_table(tbl, palette5, k, p * s_ent + i_slot, cand5 + (size_t)b * 3,
              lut);
  __syncthreads();
  const int n_px = h * w;
#pragma unroll
  for (int j = 0; j < kRenderPixels; ++j) {
    const int px =
        (blockIdx.x * kRenderPixels + j) * blockDim.x + threadIdx.x;
    if (px >= n_px) return;
    const int y = px / w, x = px - y * w;
    const int sub = tiles[(y >> 3) * (w >> 3) + (x >> 3)];
    const int key =
        alpha[px] > 0 ? sub * s_ent + maps[(size_t)b * n_px + px] : k;
    const bool valid = key >= 0 && key < k;
    float* dst = out + (size_t)b * 3 * n_px + px;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      dst[(size_t)ch * n_px] = valid ? tbl[ch * k + key] : 0.0f;
    }
  }
}

dim3 pixel_grid(int n_px, int n, int per_thread = 1) {
  const int per_block = kThreads * per_thread;
  return dim3((n_px + per_block - 1) / per_block, n);
}

}  // namespace

// key (N, H*W) int32, table (N, 3, K) f32, out (N, 3, H*W) f32.
extern "C" int snes_select_colors(const void* key, const void* table,
                                  void* out, int n_img, int n_px, int k,
                                  void* stream) {
  select_colors_kernel<<<pixel_grid(n_px, n_img), kThreads,
                         sizeof(float) * 3 * k, (cudaStream_t)stream>>>(
      (const int*)key, (const float*)table, (float*)out, n_px, k);
  return (int)cudaGetLastError();
}

// d_all (S, H, W) int32 (perceptual = 0) or f32 (perceptual = 1); tiles
// (H/8, W/8), alpha (H, W), palette5 (C, S, 3) int32; lut (256) f32, the
// decoded sRGB codes. Outputs: best_val and
// thr of d_all's type, best_idx, base_idx, map_nc (and adj, perceptual
// only) int32, affected bool, all (H, W); lnc and ml (3, H, W) f32.
extern "C" int snes_select_colors_prologue(
    const void* d_all, const void* tiles, const void* alpha,
    const void* palette5, int h, int w, int c_sub, int s_ent, int p,
    int i_slot, int perceptual, const void* lut, void* best_val,
    void* best_idx, void* base_idx, void* affected, void* map_nc, void* lnc,
    void* thr, void* adj, void* ml, void* stream) {
  const dim3 grid = pixel_grid(h * w, 1);
  const size_t smem = sizeof(float) * 3 * c_sub * s_ent;
  if (perceptual) {
    prologue_kernel<float><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)d_all, (const int*)tiles, (const int*)alpha,
        (const int*)palette5, h, w, c_sub, s_ent, p, i_slot,
        (const float*)lut, (float*)best_val, (int*)best_idx, (int*)base_idx,
        (unsigned char*)affected, (int*)map_nc, (float*)lnc, (float*)thr,
        (int*)adj, (float*)ml);
  } else {
    prologue_kernel<int><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const int*)d_all, (const int*)tiles, (const int*)alpha,
        (const int*)palette5, h, w, c_sub, s_ent, p, i_slot,
        (const float*)lut, (int*)best_val, (int*)best_idx, (int*)base_idx,
        (unsigned char*)affected, (int*)map_nc, (float*)lnc, (int*)thr,
        nullptr, (float*)ml);
  }
  return (int)cudaGetLastError();
}

// maps (B, H, W), tiles (H/8, W/8), alpha (H, W), palette5 (C, S, 3), cand5
// (B, 3) int32; lut (256) f32; out (B, 3, H, W) f32.
extern "C" int snes_select_colors_render(
    const void* maps, const void* tiles, const void* alpha,
    const void* palette5, const void* cand5, int n_cand, int h, int w,
    int c_sub, int s_ent, int p, int i_slot, const void* lut, void* out,
    void* stream) {
  render_kernel<<<pixel_grid(h * w, n_cand, kRenderPixels), kThreads,
                  sizeof(float) * 3 * c_sub * s_ent, (cudaStream_t)stream>>>(
      (const int*)maps, (const int*)tiles, (const int*)alpha,
      (const int*)palette5, (const int*)cand5, h, w, c_sub, s_ent, p, i_slot,
      (const float*)lut, (float*)out);
  return (int)cudaGetLastError();
}
