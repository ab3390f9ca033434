// Paged attention over a float KV pool (bfloat16 or float32 pages) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attn.py::paged_attn_kernel_call,
// float-page variant (bodies _kernel_bf16 + _flash_update). A query segment
// q (B, S, KV, G, hd) attends through an int32 block table to K/V blocks
// stored as (n_blocks, bs, KV, hd) pages in their own dtype, which the TPU
// kernel also takes as bfloat16 or float32 and widens to float32. The masks,
// the softcap, the clamped table entries and the online softmax are the int4
// kernel's (paged_attn_common.cuh); only the tile load differs: each page row
// of one head is read in its dtype and widened to float32 in shared memory.
//
// What bounds it on the H100: decode attention moves bytes -- 2 * hd bytes of
// bfloat16 (4 * hd of float32) per key and head for K and V each, against
// hd/2 + 4 for the int4 pool -- and does 4 * G * S * hd FLOPs per key, far
// under the ridge. Each needed block is read once per (row b, KV head), and
// the G query heads of a group share the staged tile.

#include <cuda_bf16.h>

#include "paged_attn_common.cuh"

namespace {

using paged_attn::THREADS;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// One pool block of one KV head, widened from the page dtype T.
template <typename T>
struct FloatPages {
  const T* k;
  const T* v;
  int KV, hd;

  __device__ __forceinline__ void tile(float* Ks, int ks_stride, float* Vs, int bid, int h,
                                       int bs) const {
    for (int e = threadIdx.x; e < bs * hd; e += THREADS) {
      const int t = e / hd, d = e % hd;
      const size_t off = (((size_t)bid * bs + t) * KV + h) * hd + d;
      Ks[t * ks_stride + d] = to_float(k[off]);
      Vs[t * hd + d] = to_float(v[off]);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attn_float_kernel(const float* __restrict__ q, const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages, const int* __restrict__ tables,
                        const int* __restrict__ ctx_lens, const int* __restrict__ q_pos,
                        float* __restrict__ out, int S, int KV, int G, int hd, int n_blocks,
                        int bs, int max_blk, float softcap, int window, float sm_scale) {
  extern __shared__ float smem[];
  const FloatPages<T> pages{k_pages, v_pages, KV, hd};
  paged_attn::attend(pages, smem, q, tables, ctx_lens, q_pos, out, S, KV, G, hd, n_blocks,
                     bs, max_blk, softcap, window, sm_scale);
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* tables,
           const void* ctx_lens, const void* q_pos, void* out, int B, int S, int KV, int G,
           int hd, int n_blocks, int bs, int max_blk, float softcap, int window,
           float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * paged_attn::body_floats(bs, hd);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(paged_attn_float_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  }
  if (B > 0 && KV > 0) {
    dim3 grid(B, KV);
    paged_attn_float_kernel<T><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const T*>(k_pages),
        static_cast<const T*>(v_pages), static_cast<const int*>(tables),
        static_cast<const int*>(ctx_lens), static_cast<const int*>(q_pos),
        static_cast<float*>(out), S, KV, G, hd, n_blocks, bs, max_blk, softcap, window,
        sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, S, KV, G, hd) float32; k_pages / v_pages: (n_blocks, bs, KV, hd)
// bfloat16 (pages_bf16 = 1) or float32 (pages_bf16 = 0); tables: (B, max_blk)
// int32; ctx_lens: (B,) int32; q_pos: (B, S) int32. hd <= 256.
// Returns cudaGetLastError().
extern "C" int paged_attn_bf16(const void* q, const void* k_pages, const void* v_pages,
                               int pages_bf16, const void* tables, const void* ctx_lens,
                               const void* q_pos, void* out, int B, int S, int KV, int G,
                               int hd, int n_blocks, int bs, int max_blk, float softcap,
                               int window, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pages_bf16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tables, ctx_lens, q_pos, out, B, S, KV,
                                 G, hd, n_blocks, bs, max_blk, softcap, window, sm_scale, st);
  return launch<float>(q, k_pages, v_pages, tables, ctx_lens, q_pos, out, B, S, KV, G, hd,
                       n_blocks, bs, max_blk, softcap, window, sm_scale, st);
}
