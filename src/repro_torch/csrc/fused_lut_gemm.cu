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
// Tiling: a 256-thread block owns a 32 x 64 output tile and walks K in steps of
// 32. Each step stages the bucketized + looked-up activation tile and the
// dequantized weight tile in shared memory; each thread accumulates 2 x 4
// outputs in registers. Ragged M, N and K are masked to zero (K = 11008 works).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;

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
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  if (tid < n_bounds) s_bounds[tid] = bounds[tid];
  if (tid <= n_bounds) s_abook[tid] = a_book[tid];
  for (int i = tid; i < n_w; i += THREADS) s_wbook[i] = w_book[i];

  const int tx = tid % 16;  // output columns tx + 16 * j
  const int ty = tid / 16;  // output rows ty + 16 * i
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();

  const int half_n = N / 2;
  for (int k0 = 0; k0 < K; k0 += BK) {
    // activation tile: bucketize, look up the centroid, store transposed
#pragma unroll
    for (int q = 0; q < (BM * BK) / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int r = e / BK, kk = e % BK;
      const int row = m0 + r, col = k0 + kk;
      float a = 0.f;
      if (row < M && col < K) {
        const float xv = to_float(x[(size_t)row * K + col]);
        const float s = scale[row];
        int idx = 0;
        if (MUL_FORM) {
          for (int i = 0; i < n_bounds; ++i) idx += (xv >= s * s_bounds[i]) ? 1 : 0;
        } else {
          const float xn = xv / s;
          for (int i = 0; i < n_bounds; ++i) idx += (xn >= s_bounds[i]) ? 1 : 0;
        }
        a = s_abook[idx];
      }
      As[kk][r] = a;
    }
    // weight tile: unpack indices, look up the centroid
    if (BYTE) {
#pragma unroll
      for (int q = 0; q < (BK * BN) / THREADS; ++q) {
        const int e = tid + q * THREADS;
        const int kk = e / BN, c = e % BN;
        const int k = k0 + kk, n = n0 + c;
        Bs[kk][c] = (k < K && n < N) ? s_wbook[w[(size_t)k * N + n]] : 0.f;
      }
    } else {
#pragma unroll
      for (int q = 0; q < (BK * BN / 2) / THREADS; ++q) {
        const int e = tid + q * THREADS;
        const int kk = e / (BN / 2), cb = e % (BN / 2);
        const int k = k0 + kk, n = n0 + 2 * cb;
        float lo = 0.f, hi = 0.f;
        if (k < K && n < N) {
          const uint8_t byte = w[(size_t)k * half_n + n / 2];
          lo = s_wbook[byte & 0xF];
          hi = s_wbook[byte >> 4];
        }
        Bs[kk][2 * cb] = lo;
        Bs[kk][2 * cb + 1] = hi;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float a0 = As[kk][ty];
      const float a1 = As[kk][ty + 16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = Bs[kk][tx + 16 * j];
        acc[0][j] = fmaf(a0, b, acc[0][j]);
        acc[1][j] = fmaf(a1, b, acc[1][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) y[(size_t)row * N + col] = acc[i][j];
    }
  }
}

template <typename XT, bool MUL_FORM, bool BYTE>
void launch(const void* x, const void* scale, const void* w, const void* bounds,
            int n_bounds, const void* a_book, const void* w_book, int n_w, void* y,
            int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_lut_gemm_kernel<XT, MUL_FORM, BYTE><<<grid, THREADS, 0, stream>>>(
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
