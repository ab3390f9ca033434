// The tile loop shared by the LUT-GEMM kernels (fused_lut_gemm.cu,
// lut_gemm.cu). Both compute the UNSCALED product
//
//   Y[m, n] = sum_k A[m, k] * wBook[wIdx[k, n]]
//
// and differ only in where A[m, k] -- an activation centroid -- comes from:
// the fused kernel bucketizes raw activations in the tile, the index kernel
// looks up precomputed indices. The caller passes that step in as a_at(row,
// col), called only for row < M and col < K.
//
// Tiling: a THREADS-thread block owns a BM x BN output tile and walks K in
// steps of BK. Each step stages the activation centroids (transposed) and
// the weight tile dequantized through the codebook in shared memory; each
// thread accumulates 2 x 4 outputs in registers with IEEE float32 FMAs (no
// TF32). Weight indices are nibble-packed (W <= 4: packed[k, i] = idx[k, 2i] |
// idx[k, 2i+1] << 4, the low nibble is the even column) or one per byte
// (W5-W8, a 256-entry codebook looked up in shared memory). Ragged M, N and
// K are masked to zero, so a padded K column adds exact zeros.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lut_tile {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;

// s_wbook: the weight codebook in shared memory, written by the caller
// before this call (the loop starts with a barrier).
template <bool BYTE, typename AFn>
__device__ __forceinline__ void tiles(AFn a_at, const uint8_t* __restrict__ w,
                                      const float* s_wbook, float* __restrict__ y, int M,
                                      int N, int K) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
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
    // activation tile: the caller's centroid for each (row, col), transposed
#pragma unroll
    for (int q = 0; q < (BM * BK) / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int r = e / BK, kk = e % BK;
      const int row = m0 + r, col = k0 + kk;
      As[kk][r] = (row < M && col < K) ? a_at(row, col) : 0.f;
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

inline dim3 grid(int M, int N) { return dim3((N + BN - 1) / BN, (M + BM - 1) / BM); }

}  // namespace lut_tile
