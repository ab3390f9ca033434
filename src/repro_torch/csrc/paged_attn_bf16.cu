// Paged attention over a float KV pool (bfloat16 or float32 pages) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attn.py::paged_attn_kernel_call,
// float-page variant (bodies _kernel_bf16 + _flash_update). A query segment
// q (B, S, KV, G, hd) attends through an int32 block table to K/V blocks
// stored as (n_blocks, bs, KV, hd) pages in their own dtype, which the TPU
// kernel also takes as bfloat16 or float32 and widens to float32. The split
// context, the page ring, the masks, the softcap and the online softmax are
// the int4 kernel's (paged_attn_common.cuh); only the row format differs:
// rows are staged in their dtype and widened in registers, 16 bytes at a time.
//
// What bounds it on the H100: decode attention moves bytes -- 2 * hd bytes of
// bfloat16 (4 * hd of float32) per key and head for K and V each, against
// hd/2 + 4 for the int4 pool -- and does 4 * G * S * hd FLOPs per key, far
// under the ridge. Each needed page is read once per (row b, KV head), by
// cp.async into a ring that keeps the next pages in flight while one is
// scored, and every query row of the head consumes each staged row once.

#include <cuda_bf16.h>

#include "paged_attn_common.cuh"

namespace {

// One pool row of one head in dtype T, widened to float32 in registers.
template <typename T>
struct FloatPages {
  static constexpr bool SCALED = false;
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int EXTRA = 0;
  const uint8_t* k;
  const uint8_t* v;

  __device__ __forceinline__ void init(uint8_t*) {}

  template <int N>
  __device__ __forceinline__ void widen(const uint8_t* row, int d0, float (&out)[N]) const {
    if constexpr (sizeof(T) == 4) {
      const float* p = reinterpret_cast<const float*>(row) + d0;
      if constexpr (N == 4) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
      } else {
        static_assert(N == 2, "float32 chunks of 2 or 4");
        const float2 x = *reinterpret_cast<const float2*>(p);
        out[0] = x.x, out[1] = x.y;
      }
    } else {
      // bfloat16: the upper half of a float32; element 2i in the low half of word i
      const uint8_t* p = row + 2 * d0;
      uint32_t w[N / 2];
      if constexpr (N == 8) {
        const uint4 x = *reinterpret_cast<const uint4*>(p);
        w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
      } else if constexpr (N == 4) {
        const uint2 x = *reinterpret_cast<const uint2*>(p);
        w[0] = x.x, w[1] = x.y;
      } else {
        static_assert(N == 2, "bfloat16 chunks of 2, 4 or 8");
        w[0] = *reinterpret_cast<const uint32_t*>(p);
      }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        out[2 * i] = __uint_as_float(w[i] << 16);
        out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
  __device__ __forceinline__ void scales(float*, float*, int, size_t) const {}
};

}  // namespace

// q, out: (B, S, KV, G, hd) float32; k_pages / v_pages: (n_blocks, bs, KV, hd)
// bfloat16 (pages_bf16 = 1) or float32 (pages_bf16 = 0); tables: (B, max_blk)
// int32; ctx_lens: (B,) int32; q_pos: (B, S) int32. hd <= 256. The context
// runs in `splits` splits of `pages_per_split` pages; with splits > 1, ws holds
// B * KV * splits * S * G * (hd + 2) floats and tickets B * KV zeroed int32
// (left zeroed). Returns a cudaError_t.
extern "C" int paged_attn_bf16(const void* q, const void* k_pages, const void* v_pages,
                               int pages_bf16, const void* tables, const void* ctx_lens,
                               const void* q_pos, void* out, int B, int S, int KV, int G,
                               int hd, int n_blocks, int bs, int max_blk, float softcap,
                               int window, float sm_scale, int pages_per_split, int splits,
                               void* ws, void* tickets, void* stream) {
  paged_attn::Args a{};
  a.q = static_cast<const float*>(q);
  a.tables = static_cast<const int*>(tables);
  a.ctx_lens = static_cast<const int*>(ctx_lens);
  a.q_pos = static_cast<const int*>(q_pos);
  a.out = static_cast<float*>(out);
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<int*>(tickets);
  a.S = S, a.KV = KV, a.G = G, a.hd = hd, a.n_blocks = n_blocks, a.bs = bs;
  a.max_blk = max_blk, a.pps = pages_per_split, a.splits = splits;
  a.softcap = softcap, a.window = window, a.sm_scale = sm_scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const uint8_t*>(k_pages);
  const auto* v = static_cast<const uint8_t*>(v_pages);
  if (pages_bf16) {
    a.row_bytes = hd * 2;
    return paged_attn::launch(FloatPages<__nv_bfloat16>{k, v}, a, B, st);
  }
  a.row_bytes = hd * 4;
  return paged_attn::launch(FloatPages<float>{k, v}, a, B, st);
}
