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
// and does 4 * G * S * hd FLOPs per key, far under the ridge. The design
// (paged_attn_common.cuh) splits the context over blocks, stages the packed
// rows and the scales by cp.async into a ring, and dequantizes in registers
// only, through the codebook in shared memory: a score is scale_k * (q . book
// [idx]) and a value weight p * scale_v, so each scale is read once per token
// and head, and the dense cache never exists in device memory.

#include "paged_attn_common.cuh"

namespace {

// One packed row of one head: value = book[nibble] * scale, low nibble first.
struct Int4Pages {
  static constexpr bool SCALED = true;
  static constexpr int VEC = 32;  // nibbles in 16 bytes
  static constexpr int EXTRA = 16 * sizeof(float);
  const uint8_t* k;
  const uint8_t* v;
  const float* k_scale;
  const float* v_scale;
  const float* book;   // (16,) in device memory
  const float* sbook;  // (16,) in shared memory, after init

  __device__ __forceinline__ void init(uint8_t* smem) {
    float* s = reinterpret_cast<float*>(smem);
    if (threadIdx.x < 16) s[threadIdx.x] = book[threadIdx.x];
    sbook = s;  // read after the body's first barrier
  }

  template <int N>
  __device__ __forceinline__ void widen(const uint8_t* row, int d0, float (&out)[N]) const {
    const uint8_t* p = row + d0 / 2;
    uint32_t w;
    if constexpr (N == 8)
      w = *reinterpret_cast<const uint32_t*>(p);
    else if constexpr (N == 4)
      w = *reinterpret_cast<const uint16_t*>(p);
    else {
      static_assert(N == 2, "int4 chunks of 2, 4 or 8");
      w = *p;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = sbook[(w >> (4 * i)) & 0xF];
  }

  __device__ __forceinline__ void scales(float* ks, float* vs, int slot, size_t tok) const {
    paged_attn::cp_async4(ks + slot, k_scale + tok);
    paged_attn::cp_async4(vs + slot, v_scale + tok);
  }
};

}  // namespace

// q, out: (B, S, KV, G, hd) float32; k_idx / v_idx: (n_blocks, bs, KV, hd/2) uint8;
// k_scale / v_scale: (n_blocks, bs, KV, 1) float32; book: (16,) float32;
// tables: (B, max_blk) int32; ctx_lens: (B,) int32; q_pos: (B, S) int32.
// hd must be even and <= 256. The context runs in `splits` splits of
// `pages_per_split` pages; with splits > 1, ws holds B * KV * splits * S * G *
// (hd + 2) floats and tickets B * KV zeroed int32 (left zeroed). Returns a
// cudaError_t.
extern "C" int paged_attn_int4(const void* q, const void* k_idx, const void* k_scale,
                               const void* v_idx, const void* v_scale, const void* book,
                               const void* tables, const void* ctx_lens, const void* q_pos,
                               void* out, int B, int S, int KV, int G, int hd, int n_blocks,
                               int bs, int max_blk, float softcap, int window,
                               float sm_scale, int pages_per_split, int splits, void* ws,
                               void* tickets, void* stream) {
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
  a.row_bytes = hd / 2;
  const Int4Pages pages{static_cast<const uint8_t*>(k_idx), static_cast<const uint8_t*>(v_idx),
                        static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                        static_cast<const float*>(book), nullptr};
  return paged_attn::launch(pages, a, B, static_cast<cudaStream_t>(stream));
}
