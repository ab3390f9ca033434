// Block-wide selection of the k best entries of one row held in shared
// memory, shared by the Orizuru kernels (topk_outlier.cu,
// streaming_quantize_outlier.cu).
//
// Every round each thread scans its strided share of the row for the best
// not-yet-taken (value, index) pair, a warp shuffle reduction and one
// cross-warp pass pick the winner, and a shared byte flag retires it. Flags
// rather than overwriting values keep rows that hold real +-inf or duplicate
// values exact. Ties go to the lowest channel, the order lax.top_k gives: the
// k largest come out descending, the k smallest ascending. The row never
// touches device memory again while the 2k dependent rounds run.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace topk {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <bool LARGEST>
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  if (LARGEST) return v > bv || (v == bv && i < bi);
  return v < bv || (v == bv && i < bi);
}

// Selects k entries of row[0, n) into out_v / out_i (channel -1 if the row
// ran out). `taken` (n flags) must be zero on entry; red_v / red_i hold WARPS
// entries each. Call with all THREADS threads of the block.
template <bool LARGEST>
__device__ void select_k(const float* row, uint8_t* taken, int n, int k,
                         float* out_v, int* out_i, float* red_v, int* red_i) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int r = 0; r < k; ++r) {
    float bv = LARGEST ? -INFINITY : INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < n; i += THREADS) {
      if (taken[i]) continue;
      const float v = row[i];
      if (better<LARGEST>(v, i, bv, bi)) { bv = v; bi = i; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better<LARGEST>(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < WARPS; ++w)
        if (better<LARGEST>(red_v[w], red_i[w], bv, bi)) { bv = red_v[w]; bi = red_i[w]; }
      out_v[r] = bv;
      out_i[r] = bi == INT_MAX ? -1 : bi;
      if (bi != INT_MAX) taken[bi] = 1;
    }
    __syncthreads();
  }
}

// Both sides of one row: the k largest, then the k smallest. `taken` must be
// zero on entry and is left dirty.
__device__ __forceinline__ void dual_topk(const float* row, uint8_t* taken, int n, int k,
                                          float* hi_v, int* hi_i, float* lo_v, int* lo_i) {
  __shared__ float red_v[WARPS];
  __shared__ int red_i[WARPS];
  select_k<true>(row, taken, n, k, hi_v, hi_i, red_v, red_i);
  for (int i = threadIdx.x; i < n; i += THREADS) taken[i] = 0;
  __syncthreads();
  select_k<false>(row, taken, n, k, lo_v, lo_i, red_v, red_i);
}

}  // namespace topk
