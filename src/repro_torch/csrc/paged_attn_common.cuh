// The online-softmax body shared by the paged-attention kernels
// (paged_attn_int4.cu, paged_attn_bf16.cu). They differ only in how one pool
// block of one KV head becomes a float32 K tile and V tile in shared memory;
// the caller passes that step in as a `Pages` object with
//
//   __device__ void tile(float* Ks, int ks_stride, float* Vs, int bid, int h,
//                        int bs) const;
//
// which fills Ks (bs, ks_stride) and Vs (bs, hd) for pool block `bid`, head h.
//
// One block of THREADS threads owns one (row b, KV head h). It walks row b's
// table up to ctx[b] (no block past the context is read), has the Pages
// object stage each K/V tile in shared memory, and lets each warp carry one of
// the G * S query rows of the head through the online softmax in registers,
// so all G heads of a group share one staged tile. Keys at kpos >= ctx[b] or
// kpos > q_pos[b, s], and with window > 0 at kpos <= q_pos - window, are
// masked to -FLT_MAX (finfo(float32).min, so no NaN appears); an optional
// softcap applies tanh. Table entries < 0 are clamped for the load, and their
// keys are masked by the rules above. Rows with no valid key (padding,
// q_pos < 0) come out finite but meaningless (zeros, or the mean of the values
// read); callers discard them, as with the TPU kernel.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace paged_attn {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_HD = 256;
constexpr int PER_LANE = MAX_HD / 32;

// Floats of shared memory the body uses: Ks (bs, hd + 1), Vs (bs, hd),
// qs (WARPS, hd), ps (WARPS, bs). A Pages object's own scratch goes after it.
__host__ __device__ inline size_t body_floats(int bs, int hd) {
  return (size_t)bs * (hd + 1) + (size_t)bs * hd + WARPS * hd + WARPS * bs;
}

template <typename Pages>
__device__ __forceinline__ void attend(const Pages& pages, float* smem,
                                       const float* __restrict__ q,
                                       const int* __restrict__ tables,
                                       const int* __restrict__ ctx_lens,
                                       const int* __restrict__ q_pos, float* __restrict__ out,
                                       int S, int KV, int G, int hd, int n_blocks, int bs,
                                       int max_blk, float softcap, int window, float sm_scale) {
  const int ks_stride = hd + 1;  // padded: lanes read different keys' rows
  float* Ks = smem;                          // (bs, hd + 1)
  float* Vs = Ks + bs * ks_stride;           // (bs, hd)
  float* qs = Vs + bs * hd;                  // (WARPS, hd)
  float* ps = qs + WARPS * hd;               // (WARPS, bs)

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

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
      __syncthreads();  // previous tile fully consumed (and the caller's scratch / qs written)
      int bid = tables[(size_t)b * max_blk + j];
      bid = bid < 0 ? 0 : (bid >= n_blocks ? n_blocks - 1 : bid);
      pages.tile(Ks, ks_stride, Vs, bid, h, bs);
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

}  // namespace paged_attn
