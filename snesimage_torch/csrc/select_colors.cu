// Kernel A: out[n, ch, y, x] = table[n, ch, key[n, y, x]], and 0 where the
// key is outside [0, K) (the sentinel K marks transparent pixels).
//
// Replaces snesimage_tpu/ops/pallas_prescreen.py _select_colors_pallas_n
// (pallas_call at :386, body _select_kernel :373-381). The TPU kernel
// unrolls a compare-select over the K table entries because per-pixel
// gathers were slow there; on the card a gather from a table staged in
// shared memory is direct. One thread per pixel; the table (3 x K <= 720
// floats) is loaded once per block. Bound by device memory: 4 bytes read
// and 12 written per pixel.
#include <cuda_runtime.h>

namespace {

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

}  // namespace

// key (N, H*W) int32, table (N, 3, K) f32, out (N, 3, H*W) f32.
extern "C" int snes_select_colors(const void* key, const void* table,
                                  void* out, int n_img, int n_px, int k,
                                  void* stream) {
  const int threads = 256;
  dim3 grid((n_px + threads - 1) / threads, n_img);
  select_colors_kernel<<<grid, threads, sizeof(float) * 3 * k,
                         (cudaStream_t)stream>>>(
      (const int*)key, (const float*)table, (float*)out, n_px, k);
  return (int)cudaGetLastError();
}
