// Paged attention over an int4 K-Means KV pool for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attn.py::paged_attn_kernel_call,
// int4 variant (bodies _kernel_quant + _deq_block + _flash_update). A query
// segment q (B, S, KV, G, hd) attends through an int32 block table to K/V
// blocks stored as packed nibbles (n_blocks, bs, KV, hd/2) with one float32
// scale per (token, head) and one 16-entry codebook. Keys at kpos >= ctx[b] or
// kpos > q_pos[b, s], and with window > 0 at kpos <= q_pos - window, are masked
// to -FLT_MAX (finfo(float32).min, so no NaN appears); an optional softcap
// applies tanh; the softmax runs online in float32. Table entries < 0 are
// clamped for the load, and their keys are masked by the rules above.
//
// What bounds it on the H100: decode attention moves bytes -- hd/2 index
// bytes plus a 4-byte scale per key and head, 4.5x fewer than bf16 pages --
// and does 4 * G * S * hd FLOPs per key, far under the ridge. The design reads
// each needed block once per (row b, KV head) and dequantizes the K and V
// tiles into shared memory only (the dense cache never exists in device
// memory); the tile walk and the online softmax are paged_attn_common.cuh's.

#include "paged_attn_common.cuh"

namespace {

using paged_attn::THREADS;

// Dequantizes one pool block of one KV head through the codebook held in
// shared memory: value = book[nibble] * scale, low nibble first.
struct Int4Pages {
  const uint8_t* k_idx;
  const float* k_scale;
  const uint8_t* v_idx;
  const float* v_scale;
  const float* sbook;  // (16,) in shared memory
  int KV, hd;

  __device__ __forceinline__ void tile(float* Ks, int ks_stride, float* Vs, int bid, int h,
                                       int bs) const {
    const int half = hd / 2;
    for (int e = threadIdx.x; e < bs * half; e += THREADS) {
      const int t = e / half, c = e % half;
      const size_t tok = ((size_t)bid * bs + t) * KV + h;
      const uint8_t kb = k_idx[tok * half + c];
      const uint8_t vb = v_idx[tok * half + c];
      const float ksc = k_scale[tok], vsc = v_scale[tok];
      Ks[t * ks_stride + 2 * c] = sbook[kb & 0xF] * ksc;
      Ks[t * ks_stride + 2 * c + 1] = sbook[kb >> 4] * ksc;
      Vs[t * hd + 2 * c] = sbook[vb & 0xF] * vsc;
      Vs[t * hd + 2 * c + 1] = sbook[vb >> 4] * vsc;
    }
  }
};

__global__ void __launch_bounds__(THREADS)
paged_attn_int4_kernel(const float* __restrict__ q, const uint8_t* __restrict__ k_idx,
                       const float* __restrict__ k_scale, const uint8_t* __restrict__ v_idx,
                       const float* __restrict__ v_scale, const float* __restrict__ book,
                       const int* __restrict__ tables, const int* __restrict__ ctx_lens,
                       const int* __restrict__ q_pos, float* __restrict__ out, int S,
                       int KV, int G, int hd, int n_blocks, int bs, int max_blk,
                       float softcap, int window, float sm_scale) {
  extern __shared__ float smem[];
  float* sbook = smem + paged_attn::body_floats(bs, hd);  // (16,)
  if (threadIdx.x < 16) sbook[threadIdx.x] = book[threadIdx.x];
  const Int4Pages pages{k_idx, k_scale, v_idx, v_scale, sbook, KV, hd};
  paged_attn::attend(pages, smem, q, tables, ctx_lens, q_pos, out, S, KV, G, hd, n_blocks,
                     bs, max_blk, softcap, window, sm_scale);
}

}  // namespace

// q, out: (B, S, KV, G, hd) float32; k_idx / v_idx: (n_blocks, bs, KV, hd/2) uint8;
// k_scale / v_scale: (n_blocks, bs, KV, 1) float32; book: (16,) float32;
// tables: (B, max_blk) int32; ctx_lens: (B,) int32; q_pos: (B, S) int32.
// hd must be even and <= 256. Returns cudaGetLastError().
extern "C" int paged_attn_int4(const void* q, const void* k_idx, const void* k_scale,
                               const void* v_idx, const void* v_scale, const void* book,
                               const void* tables, const void* ctx_lens, const void* q_pos,
                               void* out, int B, int S, int KV, int G, int hd, int n_blocks,
                               int bs, int max_blk, float softcap, int window,
                               float sm_scale, void* stream) {
  const size_t smem = sizeof(float) * (paged_attn::body_floats(bs, hd) + 16);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(paged_attn_int4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  if (B > 0 && KV > 0) {
    dim3 grid(B, KV);
    paged_attn_int4_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const uint8_t*>(k_idx),
        static_cast<const float*>(k_scale), static_cast<const uint8_t*>(v_idx),
        static_cast<const float*>(v_scale), static_cast<const float*>(book),
        static_cast<const int*>(tables), static_cast<const int*>(ctx_lens),
        static_cast<const int*>(q_pos), static_cast<float*>(out), S, KV, G, hd, n_blocks,
        bs, max_blk, softcap, window, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
