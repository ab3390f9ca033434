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
// bit-identical to it for the input dtype (a NaN passes no boundary: 0) --
// and the dual top-k of the raw values in the order of topk_outlier.cu: the k
// largest descending and the k smallest ascending, with their channels. The
// scale comes in from the caller (token_scale), as for the fused LUT-GEMM.
//
// What bounds it on the H100: the bytes are few (72 x 8192 floats in, the
// same count of int32 indices out: 4.7 MB, 1.4 us of HBM time); the selection
// is latency-bound like topk_outlier.cu. The design gives each row one block:
// the row is read once, 16 bytes a thread where N % 4 == 0, bucketized on the
// way in (15 compares per value against thresholds held in registers) with
// the indices stored as coalesced 16-byte writes, and kept in shared memory as
// order keys for the radix select of topk_select.cuh. Odd N needs no padding.

#include "topk_select.cuh"

namespace {

using topk::THREADS;
constexpr int MAX_BOUNDS = 15;  // a_bits <= 4

// The A4 index of each value as the row is loaded, written to idx (one row).
// prepare() -- run while the row's first loads are in flight -- puts the
// thresholds in registers: s * b_j (mul form, the same float product the
// compare would form) or b_j, padded with NaN, which no value reaches.
template <bool MUL_FORM>
struct Indices {
  const float* bounds;
  int n_bounds;
  const float* scale;  // this row's
  int* idx;
  float s, th[MAX_BOUNDS];

  __device__ __forceinline__ void prepare() {
    s = *scale;
#pragma unroll
    for (int j = 0; j < MAX_BOUNDS; ++j)
      th[j] = j < n_bounds ? (MUL_FORM ? s * bounds[j] : bounds[j]) : __int_as_float(0x7fc00000);
  }
  __device__ __forceinline__ int of(float v) const {
    const float u = MUL_FORM ? v : v / s;
    int c = 0;
#pragma unroll
    for (int j = 0; j < MAX_BOUNDS; ++j) c += (u >= th[j]) ? 1 : 0;
    return c;
  }
  __device__ __forceinline__ void operator()(int q, float4 v) const {
    reinterpret_cast<int4*>(idx)[q] = make_int4(of(v.x), of(v.y), of(v.z), of(v.w));
  }
  __device__ __forceinline__ void operator()(int c, float v) const { idx[c] = of(v); }
};

template <bool MUL_FORM>
__global__ void __launch_bounds__(THREADS)
streaming_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bounds, int n_bounds, int n, int k, bool vec,
                 int* __restrict__ idx, float* __restrict__ hi_v, int* __restrict__ hi_i,
                 float* __restrict__ lo_v, int* __restrict__ lo_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t m = blockIdx.x;
  topk::select_row(x + m * n, n, k, vec, smem,
                   Indices<MUL_FORM>{bounds, n_bounds, scale + m, idx + m * n}, hi_v + m * k,
                   hi_i + m * k, lo_v + m * k, lo_i + m * k);
}

template <bool MUL_FORM>
void launch(const void* x, const void* scale, const void* bounds, int n_bounds, int M, int N,
            int k, void* idx, void* hi_v, void* hi_i, void* lo_v, void* lo_i,
            cudaStream_t stream) {
  static size_t granted = 0;
  const size_t smem = topk::smem_bytes(N, k);
  topk::allow_smem(streaming_kernel<MUL_FORM>, smem, granted);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  streaming_kernel<MUL_FORM><<<M, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bounds), n_bounds, N, k, vec,
      static_cast<int*>(idx), static_cast<float*>(hi_v), static_cast<int*>(hi_i),
      static_cast<float*>(lo_v), static_cast<int*>(lo_i));
}

}  // namespace

// x: (M, N) float32 row-major, N <= 65535; scale: (M,) float32; bounds:
// (n_bounds,) float32 with n_bounds <= 15; idx: (M, N) int32; hi/lo outputs
// (M, k), 1 <= k <= N, and topk::smem_bytes(N, k) must fit in a block.
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
