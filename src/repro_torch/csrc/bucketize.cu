// Activation clustering (the paper's Clustering Unit) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bucketize.py::bucketize_kernel_call
// (body _kernel):
//
//   idx[e] = sum_i [x[e] >= b_i]     over (M, K) float32, int32 out,
//
// the rank searchsorted(b, x, side="right") computes, for sorted boundaries
// b (n_bounds <= 255, up to A8 codebooks). A NaN passes no boundary (0).
//
// What bounds it on the H100: bytes -- 4 in and 4 out per value, and at most
// 2^a - 1 compares each, far under the ridge. The design is one grid-stride
// pass: every thread reads its values once with neighbouring threads on
// neighbouring addresses, compares against the boundaries held in shared
// memory and writes the index; the boundary count is a loop bound, so one
// kernel serves every codebook size. The caller sees no padding.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BOUNDS = 255;

__global__ void __launch_bounds__(THREADS)
bucketize_kernel(const float* __restrict__ x, const float* __restrict__ bounds,
                 int n_bounds, int* __restrict__ idx, size_t n) {
  __shared__ float s_bounds[MAX_BOUNDS];
  for (int i = threadIdx.x; i < n_bounds; i += THREADS) s_bounds[i] = bounds[i];
  __syncthreads();
  const size_t stride = (size_t)gridDim.x * THREADS;
  for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < n; e += stride) {
    const float v = x[e];
    int c = 0;
    for (int i = 0; i < n_bounds; ++i) c += (v >= s_bounds[i]) ? 1 : 0;
    idx[e] = c;
  }
}

}  // namespace

// x: n float32 values; bounds: (n_bounds,) float32 sorted, n_bounds <= 255;
// idx: n int32. Returns cudaGetLastError().
extern "C" int bucketize(const void* x, const void* bounds, int n_bounds, void* idx, long long n,
                         void* stream) {
  if (n > 0) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    const int grid = static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
    bucketize_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(bounds), n_bounds,
        static_cast<int*>(idx), static_cast<size_t>(n));
  }
  return static_cast<int>(cudaGetLastError());
}
