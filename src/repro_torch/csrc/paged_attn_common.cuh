// The paged-attention body shared by paged_attn_int4.cu and paged_attn_bf16.cu.
// They differ only in how a staged key row becomes float32: the caller passes
// a `Pages` object with
//
//   const uint8_t* k, * v;           // the K and V pools, as bytes
//   static constexpr bool SCALED;    // one float32 scale per (token, head)
//   static constexpr int VEC;        // elements in 16 bytes of a row
//   template <int N> void widen(const uint8_t* row, int d0, float (&out)[N]) const;
//   void scales(float* ks, float* vs, int slot, size_t tok) const;  // SCALED only
//
// `widen` reads dims [d0, d0 + N) of a row in shared memory (N <= VEC, the
// chunk aligned to its size); `scales` copies the two scales of one token.
//
// Grid (splits, KV, B): one block of THREADS threads owns one split -- a run of
// whole pages of row b's table -- of one KV head h, and every query row of the
// head (S * G rows, R at a time). Design:
//
// 1. Split context. The host picks the pages per split from shapes only
//    (kernels/paged_attn.py::split_plan); each block reads ctx[b] itself, and
//    a split past the context returns at once. Each live split leaves its
//    partial (m, l, acc) per query row in a workspace; the last live block of
//    (b, h) -- an atomic ticket, reset by that block -- merges them in split
//    order, so two launches give equal bits. A row's one live split writes the
//    output itself.
// 2. An async page ring. STAGES slots of T keys (K rows, V rows and, for int4,
//    the scales) are filled by cp.async (16 bytes where the rows allow it,
//    .cg), STAGES - 1 ahead of the slot being scored; the block walks only the
//    pages that hold a key some row of the group may see.
// 3. Every query row consumes each staged tile once. Warp w owns keys
//    [w * TW, (w + 1) * TW) of a slot and runs its own online softmax over
//    them; the four warps' states merge in warp order at the end. Scores: LPK
//    lanes share a key, each holding DQ dims of all R query rows' q in
//    registers, so each K element read from shared memory serves R rows; the
//    R dot products are reduced over the LPK lanes by a halving butterfly
//    that leaves one row per lane. Values: LPV lanes share a key, each with
//    DPV dims of all R rows' accumulators in registers.
// 4. Float32 SIMT products: 4 * G * S * hd operations per key lie far under
//    the card's ridge, and bf16 products would break the float32 tolerance.
//
// Masks are the TPU kernel's: a key at kpos is valid iff kpos < ctx[b],
// kpos <= q_pos[b, s] and, with window > 0, kpos > q_pos - window; scores
// pass through tanh softcap first. Invalid scores are -FLT_MAX
// (finfo(float32).min) and weigh exactly 0, so no NaN appears: a split with
// no valid key for a row leaves m = -FLT_MAX, l = 0, acc = 0, whose merge
// weight exp(m - M) is 0 beside a split with a valid key, and a row with no
// valid key at all (padding, q_pos < 0, ctx = 0) comes out 0 -- meaningless,
// as with the TPU kernel, and discarded by callers. Table entries are clamped
// to [0, n_blocks) for the load.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace paged_attn {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 3;  // cp.async ring depth
constexpr unsigned FULL = 0xffffffffu;

// What a launch needs besides the pools.
struct Args {
  const float* q;      // (B, S, KV, G, hd)
  const int* tables;   // (B, max_blk)
  const int* ctx_lens; // (B,)
  const int* q_pos;    // (B, S)
  float* out;          // (B, S, KV, G, hd)
  float* ws;           // partials when splits > 1: (m, l) (parts,), then acc (parts, hd)
  int* tickets;        // (B * KV) zeroed counters when splits > 1
  int S, KV, G, hd, n_blocks, bs, max_blk;
  int pps;             // pages per split
  int splits;
  float softcap;
  int window;
  float sm_scale;
  int row_bytes;       // one head's K (or V) row of one token in the pool
  int krow;            // its stride in shared memory: row_bytes rounded up to 16
  int cu;              // bytes per copy: 16, 8, 4 (cp.async) or 1 (plain loads)
  int cpr_shift;       // log2 of the copies per row, -1 unless a power of two
  int bs_shift;        // log2(bs), -1 unless a power of two
};

// Lane geometry of a (head-dim class HD, rows per pass R) instantiation.
template <int HD, int R>
struct Geom {
  static constexpr int DQ = R <= 4 ? 8 : 4;         // dims per lane, scores
  static constexpr int LPK = HD / DQ;               // lanes per key, scores
  static constexpr int KPQ = 32 / LPK;              // keys per warp pass, scores
  static constexpr int DPV = 32 / R < 8 ? 32 / R : 8;  // dims per lane, values
  static constexpr int LPV = HD / DPV;              // lanes per key, values
  static constexpr int KPV = 32 / LPV;              // keys per warp pass, values
  static constexpr int T = HD <= 64 ? 64 : 32;      // keys per ring slot
  static constexpr int TW = T / WARPS;              // keys per warp per slot
  static_assert(LPK <= 32 && LPV <= 32 && R <= LPK && R % 4 == 0, "lane geometry");
  static_assert(TW % KPQ == 0 && TW % KPV == 0 && TW <= 32, "slot geometry");
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Bytes of the region after the tables: the ring, which the merges reuse
// once the walk is done (the block merge: per warp R m, l and acc rows; the
// split merge: per row M, 1 / L and a weight per split).
__host__ __device__ inline size_t ring_bytes(int HD, int R, int T, int krow, bool scaled,
                                             int rows, int splits) {
  size_t ring = (size_t)STAGES * (2 * (size_t)T * krow + (scaled ? 8 * (size_t)T : 0));
  const size_t merge = (size_t)WARPS * R * (HD + 2) * 4;
  const size_t final_merge = (size_t)rows * (2 + splits) * 4;
  if (merge > ring) ring = merge;
  if (final_merge > ring) ring = final_merge;
  return align16(ring);
}

// Dynamic shared memory of an instantiation: [extra | tables | ring | p |
// alpha | merge weights, M, L].
__host__ __device__ inline size_t smem_bytes(int HD, int R, int T, int krow, bool scaled,
                                             int pps, int rows, int splits, size_t extra) {
  return align16(extra) + align16((size_t)pps * 4) +
         ring_bytes(HD, R, T, krow, scaled, rows, splits) +
         (size_t)(T * R + WARPS * R + WARPS * R + 2 * R) * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
// One chunk of `cu` bytes; cu = 1 is a plain load and store (rows whose size
// allows no 4-byte copy), visible after the barrier before the slot is read.
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const uint8_t* src, int cu) {
  if (cu == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  else if (cu == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  else if (cu == 4)
    cp_async4(dst, src);
  else
    *dst = *src;
}

// The R partial dot products of the LPK lanes sharing a key, reduced so that
// each lane ends with one row's full sum: log2(R) halving steps at offsets
// LPK/2, LPK/4, ... (the lane with the offset bit set keeps the upper half of
// the rows it holds and sends the lower half), then plain adds over the
// offsets left. Which row a lane ends with: Halve::row.
template <int R, int N, int O>
struct Halve {
  static __device__ __forceinline__ void run(float (&v)[R], int lane) {
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = up ? v[i] : v[i + N / 2];
      const float keep = up ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, O);
    }
    Halve<R, N / 2, O / 2>::run(v, lane);
  }
  static __device__ __forceinline__ int row(int lane) {
    return ((lane & O) ? N / 2 : 0) + Halve<R, N / 2, O / 2>::row(lane);
  }
};
template <int R, int O>
struct Halve<R, 1, O> {
  static __device__ __forceinline__ void run(float (&v)[R], int) {
#pragma unroll
    for (int o = O; o >= 1; o /= 2) v[0] += __shfl_xor_sync(FULL, v[0], o);
  }
  static __device__ __forceinline__ int row(int) { return 0; }
};

// Issues the copies of keys [key0, key0 + nk) of the split (table entries in
// s_tab from its first page p0) into one ring slot.
template <class Pages, int T>
__device__ __forceinline__ void stage(const Pages& pages, const Args& a, uint8_t* slot,
                                      const int* s_tab, int p0, int key0, int nk, int h) {
  const int cpr = a.row_bytes / a.cu;  // chunks per row
  const int total = nk * cpr;
  auto issue = [&](int key, int c, int page, int off) {
    const size_t src = (((size_t)s_tab[page - p0] * a.bs + off) * a.KV + h) * a.row_bytes +
                       (size_t)c * a.cu;
    uint8_t* dst = slot + key * a.krow + c * a.cu;
    copy_chunk(dst, pages.k + src, a.cu);
    copy_chunk(dst + T * a.krow, pages.v + src, a.cu);
  };
  if (a.cpr_shift >= 0 && a.bs_shift >= 0) {
    for (int e = threadIdx.x; e < total; e += THREADS) {
      const int key = e >> a.cpr_shift, kg = key0 + key;
      issue(key, e & (cpr - 1), kg >> a.bs_shift, kg & (a.bs - 1));
    }
  } else {
    int e = threadIdx.x;
    int key = e / cpr, c = e % cpr;
    const int dk = THREADS / cpr, dc = THREADS % cpr;
    int page = (key0 + key) / a.bs, off = (key0 + key) % a.bs;
    for (; e < total; e += THREADS) {
      issue(key, c, page, off);
      c += dc;
      key += dk;
      off += dk;
      if (c >= cpr) {
        c -= cpr;
        ++key;
        ++off;
      }
      while (off >= a.bs) {
        off -= a.bs;
        ++page;
      }
    }
  }
  if constexpr (Pages::SCALED) {
    float* ks = reinterpret_cast<float*>(slot + 2 * T * a.krow);
    for (int i = threadIdx.x; i < nk; i += THREADS) {
      const int kg = key0 + i;
      const int page = a.bs_shift >= 0 ? kg >> a.bs_shift : kg / a.bs;
      const int off = kg - page * a.bs;
      pages.scales(ks, ks + T, i, ((size_t)s_tab[page - p0] * a.bs + off) * a.KV + h);
    }
  }
}

// q of rows [rg, rg + R) (0 past the last row and past hd) at this lane's
// score dims: chunk c holds dims (c * LPK + lq) * VQ + [0, VQ).
template <int R, int DQ, int VQ, int LPK>
__device__ __forceinline__ void load_q(const Args& a, float (&qr)[R][DQ], int b, int h, int rg,
                                       int rows, int lq) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = rg + r;
    const bool live = row < rows;
    const float* src =
        a.q + (live ? ((((size_t)b * a.S + row / a.G) * a.KV + h) * a.G + row % a.G) * a.hd : 0);
#pragma unroll
    for (int c = 0; c < DQ / VQ; ++c) {
      const int d0 = (c * LPK + lq) * VQ;
      if (VQ % 4 == 0 && a.hd % 4 == 0 && live && d0 + VQ <= a.hd) {
#pragma unroll
        for (int i = 0; i < VQ; i += 4) {
          const float4 x = *reinterpret_cast<const float4*>(src + d0 + i);
          qr[r][c * VQ + i] = x.x, qr[r][c * VQ + i + 1] = x.y;
          qr[r][c * VQ + i + 2] = x.z, qr[r][c * VQ + i + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < VQ; ++i)
          qr[r][c * VQ + i] = live && d0 + i < a.hd ? src[d0 + i] : 0.f;
      }
    }
  }
}

template <class Pages, int HD, int R>
__device__ __forceinline__ void attend(const Pages& pages, const Args& a, uint8_t* smem) {
  using Gm = Geom<HD, R>;
  constexpr int DQ = Gm::DQ, LPK = Gm::LPK, KPQ = Gm::KPQ, DPV = Gm::DPV, LPV = Gm::LPV,
                KPV = Gm::KPV, T = Gm::T, TW = Gm::TW;
  constexpr int VQ = DQ < Pages::VEC ? DQ : Pages::VEC;  // elements per score chunk
  constexpr int VV = DPV < Pages::VEC ? DPV : Pages::VEC;
  constexpr int NPQ = TW / KPQ, NPV = TW / KPV;
  using Rows = Halve<R, R, LPK / 2>;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rows = a.S * a.G;
  const int p0 = split * a.pps;

  // this lane's place: scores (key group kq, dims lq, row r_lane), values (js, lv)
  const int lq = lane % LPK, kq = lane / LPK;
  const int r_lane = Rows::row(lane);
  const bool dup = (lane & (LPK / R - 1)) != 0;  // holds another lane's row and key
  const int js = lane / LPV, lv = lane % LPV;

  // every load the block starts with goes out at once: ctx, the split's
  // table entries, the first row group's q_pos and q
  int* s_tab = reinterpret_cast<int*>(smem);
  uint8_t* ring = smem + align16((size_t)a.pps * 4);
  const int n_tab = min(a.pps, a.max_blk - p0);
  const int tab0 = tid < n_tab ? a.tables[(size_t)b * a.max_blk + p0 + tid] : 0;
  const int ctx = a.ctx_lens[b];
  int qp = r_lane < rows ? a.q_pos[(size_t)b * a.S + r_lane / a.G] : -1;
  float qr[R][DQ];
  load_q<R, DQ, VQ, LPK>(a, qr, b, h, 0, rows, lq);

  int n_pages = ctx > 0 ? (ctx + a.bs - 1) / a.bs : 0;
  if (n_pages > a.max_blk) n_pages = a.max_blk;
  const int n_live = n_pages > 0 ? (n_pages + a.pps - 1) / a.pps : 1;
  if (split >= n_live) return;  // past the context: no partial, no ticket
  const int key_end = min(ctx, min(p0 + a.pps, n_pages) * a.bs);  // keys [p0 bs, key_end)

  const int slot_bytes = 2 * T * a.krow + (Pages::SCALED ? 8 * T : 0);
  const size_t rbytes = ring_bytes(HD, R, T, a.krow, Pages::SCALED, rows, a.splits);
  float* s_p = reinterpret_cast<float*>(ring + rbytes);  // (WARPS, TW, R)
  float* s_alpha = s_p + T * R;                          // (WARPS, R)
  float* s_wt = s_alpha + WARPS * R;                     // (WARPS, R) merge weights
  float* s_M = s_wt + WARPS * R;                         // (R,)
  float* s_L = s_M + R;                                  // (R,)
  float* s_m = reinterpret_cast<float*>(ring);           // after the walk
  float* s_l = s_m + WARPS * R;
  float* s_acc = s_l + WARPS * R;                        // (WARPS, R, HD)

  if (tid < n_tab) s_tab[tid] = tab0 < 0 ? 0 : (tab0 >= a.n_blocks ? a.n_blocks - 1 : tab0);
  for (int j = tid + THREADS; j < n_tab; j += THREADS) {
    const int bid = a.tables[(size_t)b * a.max_blk + p0 + j];
    s_tab[j] = bid < 0 ? 0 : (bid >= a.n_blocks ? a.n_blocks - 1 : bid);
  }
  // zero the ring: rows past a slot's keys and the pad of each row then
  // hold finite values, which the branch-free loops below multiply by 0
  for (int i = tid; i < STAGES * slot_bytes / 16; i += THREADS)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);

  for (int rg = 0; rg < rows; rg += R) {
    // the keys row r_lane may see in this split: [lo, hi)
    int lo = 0, hi = 0;
    if (qp >= 0) {
      hi = min(min(ctx, qp + 1), key_end);
      lo = max(a.window > 0 ? qp - a.window + 1 : 0, p0 * a.bs);
    }
    // the walk: whole pages covering every row's keys (each row is in some lane)
    int wlo = hi > lo ? lo : INT_MAX, whi = hi > lo ? hi : INT_MIN;
#pragma unroll
    for (int o = 16; o >= 1; o /= 2) {
      wlo = min(wlo, __shfl_xor_sync(FULL, wlo, o));
      whi = max(whi, __shfl_xor_sync(FULL, whi, o));
    }
    const int k0 = whi > wlo ? wlo / a.bs * a.bs : 0;
    const int k1 = whi > wlo ? (whi + a.bs - 1) / a.bs * a.bs : 0;
    const int n_slots = (k1 - k0 + T - 1) / T;
    __syncthreads();  // the tables and the zeroed ring (first group); the merge (later)
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < n_slots)
        stage<Pages, T>(pages, a, ring + st * slot_bytes, s_tab, p0, k0 + st * T,
                        min(T, k1 - k0 - st * T), h);
      cp_async_commit();
    }

    float m = -FLT_MAX, l = 0.f;
    float acc[R][DPV];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < DPV; ++j) acc[r][j] = 0.f;

    for (int st = 0; st < n_slots; ++st) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // slot st landed; slot st - 1 is free for slot st + STAGES - 1
      {
        const int nx = st + STAGES - 1;
        if (nx < n_slots)
          stage<Pages, T>(pages, a, ring + (nx % STAGES) * slot_bytes, s_tab, p0,
                          k0 + nx * T, min(T, k1 - k0 - nx * T), h);
        cp_async_commit();
      }
      const uint8_t* sK = ring + (st % STAGES) * slot_bytes;
      const uint8_t* sV = sK + T * a.krow;
      const float* sks = reinterpret_cast<const float*>(sK + 2 * T * a.krow);
      const int skey0 = k0 + st * T;

      // scores of this warp's keys: lane (kq, lq) -> row r_lane of key kq per pass
      float s[NPQ];
      unsigned ok = 0;
#pragma unroll
      for (int pq = 0; pq < NPQ; ++pq) {
        const int kk = warp * TW + pq * KPQ + kq;
        float part[R];
#pragma unroll
        for (int r = 0; r < R; ++r) part[r] = 0.f;
#pragma unroll
        for (int c = 0; c < DQ / VQ; ++c) {
          const int d0 = (c * LPK + lq) * VQ;
          float kv[VQ];  // past hd: other finite dims, times q = 0
          pages.template widen<VQ>(sK + kk * a.krow, d0 < a.hd ? d0 : 0, kv);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int i = 0; i < VQ; ++i) part[r] = fmaf(qr[r][c * VQ + i], kv[i], part[r]);
        }
        Rows::run(part, lane);
        float sc = part[0];
        if constexpr (Pages::SCALED) sc *= sks[kk];
        sc *= a.sm_scale;
        if (a.softcap > 0.f) sc = a.softcap * tanhf(sc / a.softcap);
        const int kpos = skey0 + kk;
        const bool valid = kpos >= lo && kpos < hi;  // hi <= k1: never an unstaged key
        ok |= valid ? 1u << pq : 0u;
        s[pq] = valid ? sc : -FLT_MAX;
      }
      // online softmax of row r_lane over this warp's keys of the slot
      float mx = -FLT_MAX;
#pragma unroll
      for (int pq = 0; pq < NPQ; ++pq) mx = fmaxf(mx, s[pq]);
#pragma unroll
      for (int o = LPK; o < 32; o *= 2) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int pq = 0; pq < NPQ; ++pq) {
        const float p = (ok >> pq) & 1u ? expf(s[pq] - m_new) : 0.f;
        psum += p;
        const int kw = pq * KPQ + kq;
        float pv = p;
        if constexpr (Pages::SCALED) pv *= sks[T + warp * TW + kw];  // the V scale
        if (!dup) s_p[(warp * TW + kw) * R + r_lane] = pv;
      }
#pragma unroll
      for (int o = LPK; o < 32; o *= 2) psum += __shfl_xor_sync(FULL, psum, o);
      l = l * alpha + psum;
      m = m_new;
      if (!dup && kq == 0) s_alpha[warp * R + r_lane] = alpha;
      __syncwarp();

      // values: lane (js, lv) accumulates dims of all R rows over keys js + KPV i
      // (keys past the slot's have p = 0 and finite rows)
#pragma unroll
      for (int r = 0; r < R; r += 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(s_alpha + warp * R + r);
        const float al[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DPV; ++j) acc[r + i][j] *= al[i];
      }
#pragma unroll
      for (int pv = 0; pv < NPV; ++pv) {
        const int kw = pv * KPV + js;
        const int kk = warp * TW + kw;
        float pr[R];
#pragma unroll
        for (int r = 0; r < R; r += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(s_p + (warp * TW + kw) * R + r);
          pr[r] = p4.x, pr[r + 1] = p4.y, pr[r + 2] = p4.z, pr[r + 3] = p4.w;
        }
#pragma unroll
        for (int c = 0; c < DPV / VV; ++c) {
          const int d0 = (c * LPV + lv) * VV;
          float vv[VV];  // past hd: other dims, never written out
          pages.template widen<VV>(sV + kk * a.krow, d0 < a.hd ? d0 : 0, vv);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int i = 0; i < VV; ++i)
              acc[r][c * VV + i] = fmaf(pr[r], vv[i], acc[r][c * VV + i]);
        }
      }
      __syncwarp();
    }
    cp_async_wait<0>();

    // the warp's value partials summed over its key groups, then the four
    // warps merged in warp order
#pragma unroll
    for (int o = LPV; o < 32; o *= 2)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < DPV; ++j) acc[r][j] += __shfl_xor_sync(FULL, acc[r][j], o);
    __syncthreads();  // every warp is done with the ring
    if (js == 0)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < DPV / VV; ++c)
#pragma unroll
          for (int i = 0; i < VV; ++i)
            s_acc[(warp * R + r) * HD + (c * LPV + lv) * VV + i] = acc[r][c * VV + i];
    if (!dup && kq == 0) {
      s_m[warp * R + r_lane] = m;
      s_l[warp * R + r_lane] = l;
    }
    __syncthreads();
    if (tid < R) {
      float M = -FLT_MAX, L = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) M = fmaxf(M, s_m[w * R + tid]);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float wt = expf(s_m[w * R + tid] - M);
        s_wt[w * R + tid] = wt;
        L = fmaf(wt, s_l[w * R + tid], L);
      }
      s_M[tid] = M;
      s_L[tid] = L;
    }
    __syncthreads();
    const size_t part0 = (((size_t)b * a.KV + h) * a.splits + split) * rows;
    const size_t n_parts = (size_t)gridDim.z * a.KV * a.splits * rows;
    for (int e = tid; e < R * a.hd; e += THREADS) {
      const int r = e / a.hd, d = e - r * a.hd, row = rg + r;
      if (row >= rows) break;
      float A = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) A = fmaf(s_wt[w * R + r], s_acc[(w * R + r) * HD + d], A);
      if (n_live == 1) {
        const size_t o =
            ((((size_t)b * a.S + row / a.G) * a.KV + h) * a.G + row % a.G) * a.hd + d;
        a.out[o] = A / fmaxf(s_L[r], 1e-30f);
      } else {
        a.ws[2 * n_parts + (part0 + row) * a.hd + d] = A;
        if (d == 0) reinterpret_cast<float2*>(a.ws)[part0 + row] = make_float2(s_M[r], s_L[r]);
      }
    }
    if (rg + R < rows) {  // the next group: its q_pos and q, and the ring zeroed again
      qp = rg + R + r_lane < rows ? a.q_pos[(size_t)b * a.S + (rg + R + r_lane) / a.G] : -1;
      load_q<R, DQ, VQ, LPK>(a, qr, b, h, rg + R, rows, lq);
      __syncthreads();  // the merge scratch is read (as bf16, -FLT_MAX would hold a NaN)
      for (int i = tid; i < STAGES * slot_bytes / 16; i += THREADS)
        reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
    }
  }
  if (n_live == 1) return;

  // split merge: the last live block of (b, h) combines the partials in split order
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.tickets + (size_t)b * a.KV + h, 1) == n_live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const size_t n_parts = (size_t)gridDim.z * a.KV * a.splits * rows;
  const size_t part_b = ((size_t)b * a.KV + h) * a.splits * rows;
  const float2* ml = reinterpret_cast<const float2*>(a.ws);
  const float* ws_acc = a.ws + 2 * n_parts;
  float* f_M = reinterpret_cast<float*>(ring);  // (rows,)
  float* f_iL = f_M + rows;                     // (rows,)
  float* f_w = f_iL + rows;                     // (n_live, rows)
  constexpr int U = 8;                          // loads in flight per thread
  for (int row = tid; row < rows; row += THREADS) {
    float M = -FLT_MAX;
    for (int s0 = 0; s0 < n_live; s0 += U) {
      float mv[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        mv[u] = s0 + u < n_live ? __ldcg(ml + part_b + (size_t)(s0 + u) * rows + row).x
                                : -FLT_MAX;
#pragma unroll
      for (int u = 0; u < U; ++u) M = fmaxf(M, mv[u]);
    }
    float L = 0.f;
    for (int sp = 0; sp < n_live; ++sp) {
      const float2 v = __ldcg(ml + part_b + (size_t)sp * rows + row);
      const float wt = expf(v.x - M);
      f_w[sp * rows + row] = wt;
      L = fmaf(wt, v.y, L);
    }
    f_M[row] = M;
    f_iL[row] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int e = tid; e < rows * a.hd; e += THREADS) {
    const int row = e / a.hd, d = e - row * a.hd;
    float A = 0.f;
    for (int s0 = 0; s0 < n_live; s0 += U) {
      float av[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        av[u] = s0 + u < n_live ? __ldcg(ws_acc + (part_b + (size_t)(s0 + u) * rows + row) * a.hd + d)
                                : 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (s0 + u < n_live) A = fmaf(f_w[(s0 + u) * rows + row], av[u], A);
    }
    const size_t o = ((((size_t)b * a.S + row / a.G) * a.KV + h) * a.G + row % a.G) * a.hd + d;
    a.out[o] = A * f_iL[row];
  }
  if (tid == 0) a.tickets[(size_t)b * a.KV + h] = 0;
}

// The kernel: `Pages::init` may claim `Pages::EXTRA` bytes at the front of
// shared memory (the int4 codebook) before the body runs. Four blocks of
// R = 4 rows (at most 128 registers) or three of R = 16 (168) share an SM:
// on an H100 both ran faster than fewer blocks with more registers.
template <class Pages, int HD, int R>
__global__ void __launch_bounds__(THREADS, R == 16 ? 3 : 4) kernel(Pages pages, Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  Pages p = pages;
  p.init(smem);
  attend<Pages, HD, R>(p, a, smem + align16(Pages::EXTRA));
}

template <class Pages, int HD, int R>
int launch_t(const Pages& pages, const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(HD, R, Geom<HD, R>::T, a.krow, Pages::SCALED, a.pps,
                                 a.S * a.G, a.splits, Pages::EXTRA);
  cudaError_t err = cudaFuncSetAttribute(kernel<Pages, HD, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.splits, a.KV, B);
  kernel<Pages, HD, R><<<grid, THREADS, smem, stream>>>(pages, a);
  return static_cast<int>(cudaGetLastError());
}

__host__ inline int log2_exact(int n) {
  int s = 0;
  while ((1 << s) < n) ++s;
  return n > 0 && (1 << s) == n ? s : -1;
}

// Picks the instantiation: head-dim class HD >= hd, and R = 16 query rows per
// pass for hd <= 64 with more than 4 rows (S > 1 segments), else 4 (the rest
// loop over row groups). Fills the copy geometry: cp.async wants the pools
// aligned to the copy (torch allocations are), else plain loads.
template <class Pages>
int launch(Pages pages, Args a, int B, cudaStream_t stream) {
  if (B <= 0 || a.KV <= 0) return static_cast<int>(cudaGetLastError());
  a.krow = static_cast<int>(align16(a.row_bytes));
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(pages.k) | reinterpret_cast<uintptr_t>(pages.v);
  a.cu = 1;
  for (int cu = 16; cu >= 4; cu /= 2)
    if (a.row_bytes % cu == 0 && addr % cu == 0) {
      a.cu = cu;
      break;
    }
  a.cpr_shift = log2_exact(a.row_bytes / a.cu);
  a.bs_shift = log2_exact(a.bs);
  const int rows = a.S * a.G;
  if (a.hd <= 32) return launch_t<Pages, 32, 4>(pages, a, B, stream);
  if (a.hd <= 64)
    return rows > 4 ? launch_t<Pages, 64, 16>(pages, a, B, stream)
                    : launch_t<Pages, 64, 4>(pages, a, B, stream);
  if (a.hd <= 128) return launch_t<Pages, 128, 4>(pages, a, B, stream);
  return launch_t<Pages, 256, 4>(pages, a, B, stream);
}

}  // namespace paged_attn
