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
// each needed block once per (row b, KV head): one block of 128 threads walks
// row b's table up to ctx[b] (no block past the context is read), dequantizes
// the K and V tiles into shared memory only (the dense cache never exists in
// device memory), and lets each warp carry one of the G * S query rows of the
// head through the online softmax in registers, so all G heads of a group
// share one dequantized tile. Rows with no valid key (padding, q_pos < 0)
// come out finite but meaningless (zeros, or the mean of the values read);
// callers discard them, as with the TPU kernel.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_HD = 256;
constexpr int PER_LANE = MAX_HD / 32;

__global__ void __launch_bounds__(THREADS)
paged_attn_int4_kernel(const float* __restrict__ q, const uint8_t* __restrict__ k_idx,
                       const float* __restrict__ k_scale, const uint8_t* __restrict__ v_idx,
                       const float* __restrict__ v_scale, const float* __restrict__ book,
                       const int* __restrict__ tables, const int* __restrict__ ctx_lens,
                       const int* __restrict__ q_pos, float* __restrict__ out, int S,
                       int KV, int G, int hd, int n_blocks, int bs, int max_blk,
                       float softcap, int window, float sm_scale) {
  extern __shared__ float smem[];
  const int ks_stride = hd + 1;  // padded: lanes read different keys' rows
  float* Ks = smem;                          // (bs, hd + 1)
  float* Vs = Ks + bs * ks_stride;           // (bs, hd)
  float* qs = Vs + bs * hd;                  // (WARPS, hd)
  float* ps = qs + WARPS * hd;               // (WARPS, bs)
  float* sbook = ps + WARPS * bs;            // (16,)

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int half = hd / 2;
  if (tid < 16) sbook[tid] = book[tid];

  const int ctx = ctx_lens[b];
  int n_iter = ctx > 0 ? (ctx + bs - 1) / bs : 0;
  if (n_iter > max_blk) n_iter = max_blk;
  const int rows = S * G;

  for (int rg = 0; rg < rows; rg += WARPS) {
    const int r = rg + warp;
    const bool active = r < rows;
    const int s_i = active ? r / G : 0;
    const int g = active ? r % G : 0;
    const int qpos = active ? q_pos[(size_t)b * S + s_i] : -1;
    const size_t qoff = ((((size_t)b * S + s_i) * KV + h) * G + g) * hd;
    if (active)
      for (int d = lane; d < hd; d += 32) qs[warp * hd + d] = q[qoff + d];
    float m = -FLT_MAX, l = 0.f;
    float acc[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) acc[i] = 0.f;

    for (int j = 0; j < n_iter; ++j) {
      __syncthreads();  // previous tile fully consumed (and sbook / qs written)
      int bid = tables[(size_t)b * max_blk + j];
      bid = bid < 0 ? 0 : (bid >= n_blocks ? n_blocks - 1 : bid);
      for (int e = tid; e < bs * half; e += THREADS) {
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
      __syncthreads();
      if (!active) continue;
      float mb = -FLT_MAX;
      for (int t = lane; t < bs; t += 32) {
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qs[warp * hd + d], Ks[t * ks_stride + d], dot);
        float sc = dot * sm_scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        const int kpos = j * bs + t;
        bool valid = kpos < ctx && kpos <= qpos;
        if (window > 0) valid = valid && kpos > qpos - window;
        sc = valid ? sc : -FLT_MAX;
        ps[warp * bs + t] = sc;
        mb = fmaxf(mb, sc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      const float m_new = fmaxf(m, mb);
      __syncwarp();
      float psum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float p = expf(ps[warp * bs + t] - m_new);
        ps[warp * bs + t] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = expf(m - m_new);
      l = l * alpha + psum;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) {
          float a = acc[i] * alpha;
          for (int t = 0; t < bs; ++t) a = fmaf(ps[warp * bs + t], Vs[t * hd + d], a);
          acc[i] = a;
        }
      }
      m = m_new;
    }
    if (active) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) out[qoff + d] = acc[i] * inv;
      }
    }
    __syncthreads();  // qs reuse by the next row group
  }
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
  const size_t smem =
      sizeof(float) * ((size_t)bs * (hd + 1) + (size_t)bs * hd + WARPS * hd + WARPS * bs + 16);
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
