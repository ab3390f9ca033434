// Index LUT-GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lut_gemm.py::lut_gemm_kernel_call
// (body _index_kernel). Computes the UNSCALED product over precomputed
// activation codebook indices
//
//   Y[m, n] = sum_k aBook[aIdx[m, k]] * wBook[wIdx[k, n]]
//
// with aIdx (M, K) int32 in [0, n_a), n_a <= 256, and the weight indices
// nibble-packed (W <= 4) or one per byte (W5-W8). The caller multiplies by
// sA[m] * sW[n].
//
// What bounds it on the H100: at the serving shapes (72 token rows, K = 2048
// or 8192) the float32 product on the CUDA cores (67 TFLOP/s), as for the
// fused kernel; the int32 indices are 4 bytes per activation against 2 or 4
// for raw activations, which does not move the bound. The design is the fused
// kernel's tile loop (lut_gemm_tile.cuh) with a shared-memory codebook lookup
// in place of the in-tile bucketize, so on the same indices the two kernels
// add the same products in the same order: bucketize + this kernel equals
// the fused kernel bit for bit.

#include "lut_gemm_tile.cuh"

namespace {

using lut_tile::THREADS;

template <bool BYTE>
__global__ void __launch_bounds__(THREADS)
lut_gemm_kernel(const int* __restrict__ a_idx, const uint8_t* __restrict__ w,
                const float* __restrict__ a_book, int n_a, const float* __restrict__ w_book,
                int n_w, float* __restrict__ y, int M, int N, int K) {
  __shared__ float s_abook[256];
  __shared__ float s_wbook[256];

  for (int i = threadIdx.x; i < n_a; i += THREADS) s_abook[i] = a_book[i];
  for (int i = threadIdx.x; i < n_w; i += THREADS) s_wbook[i] = w_book[i];

  auto a_at = [&](int row, int col) { return s_abook[a_idx[(size_t)row * K + col]]; };
  lut_tile::tiles<BYTE>(a_at, w, s_wbook, y, M, N, K);
}

}  // namespace

// a_idx: (M, K) int32 in [0, n_a); w: (K, N/2) uint8 nibbles or (K, N) uint8
// bytes; a_book: (n_a,) float32, n_a <= 256; w_book: (n_w,) float32,
// n_w <= 256; y: (M, N) float32. Returns cudaGetLastError().
extern "C" int lut_gemm(const void* a_idx, const void* w, int byte_packed, const void* a_book,
                        int n_a, const void* w_book, int n_w, void* y, int M, int N, int K,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > 0 && N > 0) {
    const dim3 grid = lut_tile::grid(M, N);
    if (byte_packed)
      lut_gemm_kernel<true><<<grid, THREADS, 0, st>>>(
          static_cast<const int*>(a_idx), static_cast<const uint8_t*>(w),
          static_cast<const float*>(a_book), n_a, static_cast<const float*>(w_book), n_w,
          static_cast<float*>(y), M, N, K);
    else
      lut_gemm_kernel<false><<<grid, THREADS, 0, st>>>(
          static_cast<const int*>(a_idx), static_cast<const uint8_t*>(w),
          static_cast<const float*>(a_book), n_a, static_cast<const float*>(w_book), n_w,
          static_cast<float*>(y), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
