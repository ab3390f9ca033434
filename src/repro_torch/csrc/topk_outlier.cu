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
// never touch device memory again (topk_select.cuh). The TPU's shared-pairwise
// tournament is not carried over: the contract, not the tree, is the port.

#include "topk_select.cuh"

namespace {

using topk::THREADS;

__global__ void __launch_bounds__(THREADS)
topk_outlier_kernel(const float* __restrict__ x, int n, int k, float* __restrict__ hi_v,
                    int* __restrict__ hi_i, float* __restrict__ lo_v, int* __restrict__ lo_i) {
  extern __shared__ unsigned char smem[];
  float* row = reinterpret_cast<float*>(smem);
  uint8_t* taken = smem + (size_t)n * sizeof(float);

  const size_t m = blockIdx.x;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    row[i] = x[m * n + i];
    taken[i] = 0;
  }
  __syncthreads();
  topk::dual_topk(row, taken, n, k, hi_v + m * k, hi_i + m * k, lo_v + m * k, lo_i + m * k);
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
