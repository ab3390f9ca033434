// Fused activation quantize + LUT-GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lut_gemm.py::fused_lut_gemm_kernel_call
// (body _fused_kernel). Computes the UNSCALED product
//
//   Y[m, n] = sum_k aBook[bucketize(x[m, k], s[m])] * wBook[wIdx[k, n]]
//
// where bucketize counts the activation decision boundaries b_i that x passes:
// float32 inputs compare x / s >= b_i (IEEE division, the searchsorted form),
// bfloat16 inputs compare x >= s * b_i (the fused mul form). Weight indices are
// nibble-packed (W <= 4: packed[k, i] = idx[k, 2i] | idx[k, 2i+1] << 4) or one
// per byte (W5-W8). The caller multiplies by s[m] * wScale[n].
//
// What bounds it on the H100: at the serving shapes (72 token rows, K = 2048 or
// 8192) the product is compute-bound on the float32 CUDA cores (67 TFLOP/s):
// mlp/wi does 4.83 GFLOP against 21.8 MB of traffic. The design keeps every
// byte of traffic at its minimum -- raw activations and packed indices are read
// once per tile, indices and dequantized values exist only in shared memory --
// and accumulates in IEEE float32 FMAs (no TF32, no bf16 tensor cores), so the
// result matches the plain float32 version to summation order. This is the
// parity route: a tensor-core tier is a separate, later route.
//
// Tiling, weight tiers and masking: lut_gemm_tile.cuh.

#include <cuda_bf16.h>

#include "lut_gemm_tile.cuh"

namespace {

using lut_tile::THREADS;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename XT, bool MUL_FORM, bool BYTE>
__global__ void __launch_bounds__(THREADS)
fused_lut_gemm_kernel(const XT* __restrict__ x, const float* __restrict__ scale,
                      const uint8_t* __restrict__ w, const float* __restrict__ bounds,
                      int n_bounds, const float* __restrict__ a_book,
                      const float* __restrict__ w_book, int n_w,
                      float* __restrict__ y, int M, int N, int K) {
  __shared__ float s_bounds[16];
  __shared__ float s_abook[16];
  __shared__ float s_wbook[256];

  const int tid = threadIdx.x;
  if (tid < n_bounds) s_bounds[tid] = bounds[tid];
  if (tid <= n_bounds) s_abook[tid] = a_book[tid];
  for (int i = tid; i < n_w; i += THREADS) s_wbook[i] = w_book[i];

  // bucketize one activation and look up its centroid
  auto a_at = [&](int row, int col) {
    const float xv = to_float(x[(size_t)row * K + col]);
    const float s = scale[row];
    int idx = 0;
    if (MUL_FORM) {
      for (int i = 0; i < n_bounds; ++i) idx += (xv >= s * s_bounds[i]) ? 1 : 0;
    } else {
      const float xn = xv / s;
      for (int i = 0; i < n_bounds; ++i) idx += (xn >= s_bounds[i]) ? 1 : 0;
    }
    return s_abook[idx];
  };
  lut_tile::tiles<BYTE>(a_at, w, s_wbook, y, M, N, K);
}

template <typename XT, bool MUL_FORM, bool BYTE>
void launch(const void* x, const void* scale, const void* w, const void* bounds,
            int n_bounds, const void* a_book, const void* w_book, int n_w, void* y,
            int M, int N, int K, cudaStream_t stream) {
  fused_lut_gemm_kernel<XT, MUL_FORM, BYTE><<<lut_tile::grid(M, N), THREADS, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const float*>(scale),
      static_cast<const uint8_t*>(w), static_cast<const float*>(bounds), n_bounds,
      static_cast<const float*>(a_book), static_cast<const float*>(w_book), n_w,
      static_cast<float*>(y), M, N, K);
}

template <typename XT>
void dispatch_forms(int mul_form, int byte_packed, const void* x, const void* scale,
                    const void* w, const void* bounds, int n_bounds, const void* a_book,
                    const void* w_book, int n_w, void* y, int M, int N, int K,
                    cudaStream_t stream) {
  if (mul_form) {
    if (byte_packed)
      launch<XT, true, true>(x, scale, w, bounds, n_bounds, a_book, w_book, n_w, y, M, N, K, stream);
    else
      launch<XT, true, false>(x, scale, w, bounds, n_bounds, a_book, w_book, n_w, y, M, N, K, stream);
  } else {
    if (byte_packed)
      launch<XT, false, true>(x, scale, w, bounds, n_bounds, a_book, w_book, n_w, y, M, N, K, stream);
    else
      launch<XT, false, false>(x, scale, w, bounds, n_bounds, a_book, w_book, n_w, y, M, N, K, stream);
  }
}

}  // namespace

// x: (M, K) float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1); scale: (M,) float32;
// w: (K, N/2) uint8 nibbles or (K, N) uint8 bytes; bounds: (n_bounds,) float32
// with n_bounds <= 15; a_book: (n_bounds + 1,) float32; w_book: (n_w,) float32
// with n_w <= 256; y: (M, N) float32. Returns cudaGetLastError().
extern "C" int fused_lut_gemm(const void* x, int x_bf16, const void* scale, const void* w,
                              int byte_packed, const void* bounds, int n_bounds,
                              int mul_form, const void* a_book, const void* w_book,
                              int n_w, void* y, int M, int N, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > 0 && N > 0) {
    if (x_bf16)
      dispatch_forms<__nv_bfloat16>(mul_form, byte_packed, x, scale, w, bounds, n_bounds,
                                    a_book, w_book, n_w, y, M, N, K, st);
    else
      dispatch_forms<float>(mul_form, byte_packed, x, scale, w, bounds, n_bounds, a_book,
                            w_book, n_w, y, M, N, K, st);
  }
  return static_cast<int>(cudaGetLastError());
}
