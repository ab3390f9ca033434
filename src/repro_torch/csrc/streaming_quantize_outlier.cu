// Streaming activation quantize + Orizuru detection for Hopper (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/topk_outlier.py::streaming_quantize_outlier_kernel_call (body
// _streaming_kernel). One read of each row of x (M, N) float32 gives
//
//   idx[m, n] = sum_i [x[m, n] / s[m] >= b_i]      float32 origin (IEEE division)
//   idx[m, n] = sum_i [x[m, n] >= s[m] * b_i]      bfloat16 origin (mul form)
//
// -- the two compare forms of quantize_activation, so the indices are
// bit-identical to it for the input dtype -- and the dual top-k of the raw
// values: the k largest descending and the k smallest ascending, with their
// channels, ties to the lowest channel as lax.top_k orders them. The scale
// comes in from the caller (token_scale), as for the fused LUT-GEMM.
//
// What bounds it on the H100: the bytes are few (72 x 8192 floats in, the
// same count of int32 indices out: 4.7 MB, 1.4 us of HBM time); the selection
// is latency-bound like topk_outlier.cu -- 2k dependent block-wide rounds per
// row. The design gives each row one block: the row is read once into shared
// memory, bucketized on the way in (<= 15 compares per value against
// boundaries in shared memory), and the selection rounds of topk_select.cuh
// run on the shared copy. Odd N needs no padding lane here.

#include "topk_select.cuh"

namespace {

using topk::THREADS;

template <bool MUL_FORM>
__global__ void __launch_bounds__(THREADS)
streaming_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bounds, int n_bounds, int n, int k,
                 int* __restrict__ idx, float* __restrict__ hi_v, int* __restrict__ hi_i,
                 float* __restrict__ lo_v, int* __restrict__ lo_i) {
  extern __shared__ unsigned char smem[];
  float* row = reinterpret_cast<float*>(smem);
  uint8_t* taken = smem + (size_t)n * sizeof(float);
  __shared__ float s_bounds[16];

  const size_t m = blockIdx.x;
  if (threadIdx.x < n_bounds) s_bounds[threadIdx.x] = bounds[threadIdx.x];
  __syncthreads();
  const float s = scale[m];
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float v = x[m * n + i];
    row[i] = v;
    taken[i] = 0;
    int c = 0;
    if (MUL_FORM) {
      for (int j = 0; j < n_bounds; ++j) c += (v >= s * s_bounds[j]) ? 1 : 0;
    } else {
      const float vn = v / s;
      for (int j = 0; j < n_bounds; ++j) c += (vn >= s_bounds[j]) ? 1 : 0;
    }
    idx[m * n + i] = c;
  }
  __syncthreads();
  topk::dual_topk(row, taken, n, k, hi_v + m * k, hi_i + m * k, lo_v + m * k, lo_i + m * k);
}

template <bool MUL_FORM>
void launch(const void* x, const void* scale, const void* bounds, int n_bounds, int M, int N,
            int k, void* idx, void* hi_v, void* hi_i, void* lo_v, void* lo_i,
            cudaStream_t stream) {
  const size_t smem = (size_t)N * (sizeof(float) + 1);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(streaming_kernel<MUL_FORM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  }
  streaming_kernel<MUL_FORM><<<M, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bounds), n_bounds, N, k, static_cast<int*>(idx),
      static_cast<float*>(hi_v), static_cast<int*>(hi_i), static_cast<float*>(lo_v),
      static_cast<int*>(lo_i));
}

}  // namespace

// x: (M, N) float32 row-major; scale: (M,) float32; bounds: (n_bounds,) float32
// with n_bounds <= 15; idx: (M, N) int32; hi/lo outputs (M, k), 1 <= k <= N.
// mul_form = 1 selects the x >= s * b_i compare. Returns cudaGetLastError().
extern "C" int streaming_quantize_outlier(const void* x, const void* scale, const void* bounds,
                                          int n_bounds, int mul_form, int M, int N, int k,
                                          void* idx, void* hi_v, void* hi_i, void* lo_v,
                                          void* lo_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > 0) {
    if (mul_form)
      launch<true>(x, scale, bounds, n_bounds, M, N, k, idx, hi_v, hi_i, lo_v, lo_i, st);
    else
      launch<false>(x, scale, bounds, n_bounds, M, N, k, idx, hi_v, hi_i, lo_v, lo_i, st);
  }
  return static_cast<int>(cudaGetLastError());
}
