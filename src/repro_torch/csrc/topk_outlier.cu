// Orizuru dual top-k outlier detection for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/topk_outlier.py::topk_outlier_kernel_call
// (body _kernel -> _dual_topk / _pop_topk). For each row of x (M, N) float32 it
// returns the k largest values in descending order and the k smallest in
// ascending order, with their channels, in the order of the plain version
// (kernels/topk_outlier.py::topk_outlier_plain): ties to the lowest channel,
// -0.0 equal to +0.0, NaN above +inf on the hi side and last on the lo side.
// Odd N needs no padding here.
//
// What bounds it on the H100: the data is tiny (72 x 8192 floats = 2.4 MB at
// the serving shapes, under a microsecond of HBM time); the bound is latency
// -- the row's load and the selection's chain of block barriers. The design
// gives each row one block: the row is read once into shared memory as order
// keys, and a radix select (topk_select.cuh) finds both sides in at most four
// passes of three barriers each, however large k is. The TPU's
// shared-pairwise tournament is not carried over: the contract, not the
// tree, is the port.

#include "topk_select.cuh"

namespace {

using topk::THREADS;

__global__ void __launch_bounds__(THREADS)
topk_outlier_kernel(const float* __restrict__ x, int n, int k, bool vec,
                    float* __restrict__ hi_v, int* __restrict__ hi_i, float* __restrict__ lo_v,
                    int* __restrict__ lo_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t m = blockIdx.x;
  topk::select_row(x + m * n, n, k, vec, smem, topk::NoSink{}, hi_v + m * k, hi_i + m * k,
                   lo_v + m * k, lo_i + m * k);
}

}  // namespace

// x: (M, N) float32 row-major, N <= 65535; outputs (M, k): hi values
// descending + channels, lo values ascending + channels. 1 <= k <= N, and
// topk::smem_bytes(N, k) must fit in a block. Returns cudaGetLastError().
extern "C" int topk_outlier(const void* x, int M, int N, int k, void* hi_v, void* hi_i,
                            void* lo_v, void* lo_i, void* stream) {
  static size_t granted = 0;
  const size_t smem = topk::smem_bytes(N, k);
  topk::allow_smem(topk_outlier_kernel, smem, granted);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (M > 0) {
    topk_outlier_kernel<<<M, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), N, k, vec, static_cast<float*>(hi_v),
        static_cast<int*>(hi_i), static_cast<float*>(lo_v), static_cast<int*>(lo_i));
  }
  return static_cast<int>(cudaGetLastError());
}
