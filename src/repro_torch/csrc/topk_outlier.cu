// Orizuru dual top-k outlier detection for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/topk_outlier.py::topk_outlier_kernel_call
// (body _kernel -> _dual_topk / _pop_topk). For each row of x (M, N) float32 it
// returns the k largest values in descending order and the k smallest in
// ascending order, with their channels. Ties go to the lowest channel, the
// order lax.top_k gives; odd N needs no padding here.
//
// What bounds it on the H100: the data is tiny (72 x 8192 floats = 2.4 MB at
// the serving shapes, under a microsecond of HBM time); the bound is latency --
// 2k dependent selection rounds per row, each a block-wide reduction. The
// design gives each row one block with the row in shared memory, so the rounds
// never touch device memory again: every round each thread scans its strided
// share of the row for the best not-yet-taken (value, index) pair, a warp
// shuffle reduction and one cross-warp pass pick the winner, and a shared
// byte flag retires it. Flags rather than overwriting values keep rows that
// hold real +-inf or duplicate values exact. The TPU's shared-pairwise
// tournament is not carried over: the contract, not the tree, is the port.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <bool LARGEST>
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  if (LARGEST) return v > bv || (v == bv && i < bi);
  return v < bv || (v == bv && i < bi);
}

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

__global__ void __launch_bounds__(THREADS)
topk_outlier_kernel(const float* __restrict__ x, int n, int k, float* __restrict__ hi_v,
                    int* __restrict__ hi_i, float* __restrict__ lo_v, int* __restrict__ lo_i) {
  extern __shared__ unsigned char smem[];
  float* row = reinterpret_cast<float*>(smem);
  uint8_t* taken = smem + (size_t)n * sizeof(float);
  __shared__ float red_v[WARPS];
  __shared__ int red_i[WARPS];

  const size_t m = blockIdx.x;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    row[i] = x[m * n + i];
    taken[i] = 0;
  }
  __syncthreads();
  select_k<true>(row, taken, n, k, hi_v + m * k, hi_i + m * k, red_v, red_i);
  for (int i = threadIdx.x; i < n; i += THREADS) taken[i] = 0;
  __syncthreads();
  select_k<false>(row, taken, n, k, lo_v + m * k, lo_i + m * k, red_v, red_i);
}

}  // namespace

// x: (M, N) float32 row-major; outputs (M, k): hi values descending + channels,
// lo values ascending + channels. 1 <= k <= N. Returns cudaGetLastError().
extern "C" int topk_outlier(const void* x, int M, int N, int k, void* hi_v, void* hi_i,
                            void* lo_v, void* lo_i, void* stream) {
  const size_t smem = (size_t)N * (sizeof(float) + 1);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(topk_outlier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  if (M > 0) {
    topk_outlier_kernel<<<M, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), N, k, static_cast<float*>(hi_v),
        static_cast<int*>(hi_i), static_cast<float*>(lo_v), static_cast<int*>(lo_i));
  }
  return static_cast<int>(cudaGetLastError());
}
