// Block-wide radix selection of the k largest and the k smallest entries of
// one row, shared by the Orizuru kernels (topk_outlier.cu,
// streaming_quantize_outlier.cu). One block of THREADS threads per row.
//
// Order. Each value becomes a 32-bit unsigned key that is monotone in the
// order of the plain version (a stable torch.sort): the usual sign flip, with
// -0.0 mapped onto +0.0 (the two tie, and the lower channel comes first) and
// every NaN, of either sign and any payload, onto 0xFFFFFFFF (above +inf on
// the hi side, last on the lo side). hi is the k largest keys, descending; lo
// the k smallest, ascending; among equal keys the lowest channel comes first.
// The outputs carry x's own bits (a -0.0 stays -0.0).
//
// Layout. Thread t owns the channels [t * per, (t + 1) * per), per =
// ceil(n / THREADS), so a scan of per-thread counts ranks ties in channel
// order. The keys live in shared memory transposed: entry j of thread t at
// j * stride + t, with stride = THREADS + max(1, 32 / per), so the passes read
// without bank conflicts and the row's coalesced load writes with few.
//
// Selection. At most four 8-bit radix passes, most significant digit first,
// narrow one key prefix per side. The first pass is joint -- both groups are
// the whole row -- and is counted as the row is loaded (BATCH loads in flight
// per thread); later passes count one histogram per side over the entries
// still in that side's group. Counts are plain shared-memory atomics: on
// Gaussian activations the first digit (sign and top exponent bits) puts most
// of the row into a handful of bins, yet on the H100 the contention costs
// less than aggregating within a warp (__match_any_sync) or per-warp
// histograms did, even on all-equal rows. A 256-bin scan (one bin per thread
// of the first BINS, both sides packed into one 32-bit word) picks the digit
// that holds rank k; a side stops once its chosen bin holds exactly the count
// it still needs, or once the bin is one exact key: where every key of the
// row is a short_key (bfloat16-origin values and small integers, without NaN),
// that is so after the pass over bits 16-23, so a tie at the k-th place costs
// two passes, not four. A pass costs at most three block barriers whatever k
// is; the set-up and its barrier hide behind the row's first loads.
//
// Gather and order. A side takes every entry beyond its final prefix and its
// group: all of it -- then "beyond or in" is one compare of the key -- or,
// when the passes ended on one exact key with more ties than needed, the
// lowest-channel ties (a block scan of per-thread tie counts). Selected
// entries go to a shared list per side (a ballot and one atomic per warp) as
// 64-bit composites, (key, ~channel) on the hi side and (~key, ~channel) on
// the lo side, so that on both sides the larger composite comes first; an
// entry's output slot is the count of larger composites on its side: k
// compares per entry, one thread each (a few warps at the serving k,
// quadratic in k near n).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace topk {

constexpr int THREADS = 512;  // kernels/topk_outlier.py::THREADS mirrors it
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 256;  // one radix bin per thread of the first BINS in the scan
constexpr int BATCH = 4;   // row loads in flight per thread
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS % 32 == 0 && THREADS >= BINS, "a bin per thread in the scan");

__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t b = __float_as_uint(v);
  if ((b & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;  // NaN
  if (b == 0x80000000u) b = 0u;                              // -0.0 ties with +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Where a row's keys live in shared memory (see the layout note above).
struct Layout {
  int per;         // channels per thread, ceil(n / THREADS)
  int stride;      // words between a thread's consecutive entries
  uint32_t magic;  // floor(2^31 / per) + 1: c / per == umulhi(2c, magic) for c < 2^16
};

__host__ __device__ inline Layout layout(int n) {
  const int per = (n + THREADS - 1) / THREADS;
  return {per, THREADS + (per >= 32 ? 1 : 32 / per), (1u << 31) / (uint32_t)per + 1u};
}

__host__ __device__ inline size_t keys_bytes(Layout l) {
  return ((size_t)l.per * l.stride * 4 + 7) / 8 * 8;
}

// Dynamic shared memory of one row's block: the keys, then two lists of k
// composites (kernels/topk_outlier.py::smem_bytes mirrors it).
__host__ __device__ inline size_t smem_bytes(int n, int k) {
  return keys_bytes(layout(n)) + (size_t)2 * k * sizeof(uint64_t);
}

// Lets `kernel` take `bytes` of dynamic shared memory beside its static part;
// `granted` remembers the largest size already set for it.
template <class Kernel>
inline void allow_smem(Kernel kernel, size_t bytes, size_t& granted) {
  if (bytes > granted) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    granted = bytes;
  }
}

__device__ __forceinline__ int slot(Layout l, int c) {
  const int q = (int)__umulhi(2u * (uint32_t)c, l.magic);
  return (c - q * l.per) * l.stride + q;
}

// One side's group: the keys with (key & mask) == prefix.
struct Side {
  uint32_t prefix, mask;
  int need;  // entries still to take from the group
  int all;   // the group holds exactly `need`: take all of it
};

// The side after a pass chose `bin` (the digit at `shift`, already shifted)
// holding `count` of the group, `need` of them still to take. `exact`: the
// bin is one key, whose low 16 bits follow its sign (below).
__device__ __forceinline__ Side narrow(const Side& v, uint32_t bin, int shift, int need,
                                       int count, bool exact) {
  if (exact) {
    const uint32_t key = v.prefix | bin;
    return Side{key | ((key & 0x80000000u) ? 0u : 0xffffu), FULL, need, count == need};
  }
  return Side{v.prefix | bin, v.mask | (0xffu << shift), need, count == need};
}

// Whether a key's low 16 bits are those its sign implies: 0 for a value >= 0,
// 0xFFFF for a negative one -- true of every bfloat16-origin value but NaN.
// Where all keys of a row pass, two keys that agree on their top 16 bits are
// equal, so the pass over bits 16-23 ends on one exact key.
__device__ __forceinline__ bool short_key(uint32_t key) {
  return (key & 0xffffu) == ((key & 0x80000000u) ? 0u : 0xffffu);
}

// The block's static shared memory.
struct Scratch {
  int hist[2][BINS];
  uint32_t warp_tot[WARPS];
  int wide;  // some key's low 16 bits differ from those its sign implies (load_row)
  Side side[2];
  int fill[2];
};

struct NoSink {
  __device__ __forceinline__ void prepare() {}
  __device__ __forceinline__ void operator()(int, float4) const {}
  __device__ __forceinline__ void operator()(int, float) const {}
};

// Inclusive scan of v over the threads of the first NW warps; *total gets
// their sum. All threads call it (one barrier); the others get no result they
// may use. The caller puts a barrier between two calls.
template <int NW>
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* warp_tot, uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31 && warp < NW) warp_tot[warp] = v;
  __syncthreads();
  uint32_t before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const uint32_t s = warp_tot[w];
    before += w < warp ? s : 0u;
    sum += s;
  }
  *total = sum;
  return v + before;
}

// Appends v to list for the lanes with `sel`: one atomic per warp.
__device__ __forceinline__ void append(uint64_t* list, int* fill, bool sel, uint64_t v) {
  const unsigned b = __ballot_sync(FULL, sel);
  if (b == 0) return;
  const int lane = threadIdx.x & 31, leader = __ffs(b) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(fill, __popc(b));
  base = __shfl_sync(FULL, base, leader);
  if (sel) list[base + __popc(b & ((1u << lane) - 1u))] = v;
}

// Reads row[0, n) once -- 16 bytes a thread where `vec` (n % 4 == 0 and an
// aligned row), one value otherwise, neighbouring threads on neighbouring
// addresses, BATCH loads in flight -- stores each value's key, counts its
// first digit into hist and hands the values to `sink`: sink(q, float4) for
// channels 4q..4q+3, sink(c, float) for channel c. While the first loads are
// in flight it runs sink.prepare() and init() and then a block barrier, so
// that set-up and barrier hide behind the loads' latency. *wide is set where
// some key is not a short_key.
template <class Sink, class Init>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int n, bool vec, Layout l,
                                         uint32_t* keys, int* hist, int* wide, Sink& sink,
                                         const Init& init) {
  const int tid = threadIdx.x;
  bool short_keys = true;
  if (vec) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const int n4 = n / 4;
    for (int q0 = 0; q0 < n4; q0 += BATCH * THREADS) {
      float4 v[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int q = q0 + b * THREADS + tid;
        v[b] = q < n4 ? row4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (q0 == 0) {
        sink.prepare();
        init();
        __syncthreads();
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int q = q0 + b * THREADS + tid;
        const bool valid = q < n4;
        const float e[4] = {v[b].x, v[b].y, v[b].z, v[b].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t key = order_key(e[i]);
          if (valid) {
            keys[slot(l, 4 * q + i)] = key;
            atomicAdd(&hist[key >> 24], 1);
            short_keys &= short_key(key);
          }
        }
        if (valid) sink(q, v[b]);
      }
    }
  } else {
    for (int c0 = 0; c0 < n; c0 += BATCH * THREADS) {
      float v[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int c = c0 + b * THREADS + tid;
        v[b] = c < n ? row[c] : 0.f;
      }
      if (c0 == 0) {
        sink.prepare();
        init();
        __syncthreads();
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int c = c0 + b * THREADS + tid;
        const bool valid = c < n;
        const uint32_t key = order_key(v[b]);
        if (valid) {
          keys[slot(l, c)] = key;
          sink(c, v[b]);
          atomicAdd(&hist[key >> 24], 1);
          short_keys &= short_key(key);
        }
      }
    }
  }
  if (!__all_sync(FULL, short_keys) && (tid & 31) == 0) *wide = 1;
}

// The dual top-k of one row of n <= 65535 entries: hi_v / hi_i get the k
// largest (descending), lo_v / lo_i the k smallest (ascending). smem is the
// block's dynamic shared memory (smem_bytes(n, k), 16-byte aligned); sink
// sees every value as it is loaded (load_row). Call with all THREADS threads
// of the block.
template <class Sink>
__device__ void select_row(const float* __restrict__ row, int n, int k, bool vec,
                           unsigned char* smem, Sink sink, float* __restrict__ hi_v,
                           int* __restrict__ hi_i, float* __restrict__ lo_v,
                           int* __restrict__ lo_i) {
  __shared__ Scratch s;
  const Layout l = layout(n);
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);
  uint64_t* lists = reinterpret_cast<uint64_t*>(smem + keys_bytes(l));
  const int tid = threadIdx.x, first = tid * l.per;

  load_row(row, n, vec, l, keys, s.hist[0], &s.wide, sink, [&] {
    for (int b = tid; b < 2 * BINS; b += THREADS) s.hist[b / BINS][b % BINS] = 0;
    if (tid < 2) {
      s.side[tid] = Side{0u, 0u, k, 0};
      s.fill[tid] = 0;
    }
    if (tid == 0) s.wide = 0;
  });
  __syncthreads();

  // A side is done once it takes its whole group, or its group is one exact
  // key (mask FULL): then only the ties remain to rank.
  auto searching = [](const Side& v) { return !v.all && v.mask != FULL; };
  for (int shift = 24; shift >= 0; shift -= 8) {
    const Side h = s.side[0], o = s.side[1];
    if (!searching(h) && !searching(o)) break;
    const bool joint = shift == 24;  // both groups are the whole row, counted by load_row
    if (!joint) {
#pragma unroll 4
      for (int j = 0; j < l.per; ++j) {
        const bool valid = first + j < n;
        const uint32_t key = valid ? keys[j * l.stride + tid] : 0u;
        const uint32_t d = (key >> shift) & 0xffu;
        const bool in_h = valid && searching(h) && (key & h.mask) == h.prefix;
        const bool in_o = valid && searching(o) && (key & o.mask) == o.prefix;
        if (in_h) atomicAdd(&s.hist[0][d], 1);
        if (in_o) atomicAdd(&s.hist[1][d], 1);
      }
      __syncthreads();
    }
    int c_h = 0, c_o = 0;
    if (tid < BINS) {
      c_h = s.hist[0][tid];
      c_o = joint ? c_h : s.hist[1][tid];
      s.hist[0][tid] = 0;
      s.hist[1][tid] = 0;
    }
    uint32_t total;
    const uint32_t incl =
        block_scan<BINS / 32>(((uint32_t)c_h << 16) | (uint32_t)c_o, s.warp_tot, &total);
    if (tid < BINS) {
      const int above = (int)(total >> 16) - (int)(incl >> 16);  // hi: entries in higher bins
      const int below = (int)(incl & 0xffffu) - c_o;             // lo: entries in lower bins
      const uint32_t bin = (uint32_t)tid << shift;
      const bool exact = shift == 16 && !s.wide;
      if (searching(h) && above < h.need && above + c_h >= h.need)
        s.side[0] = narrow(h, bin, shift, h.need - above, c_h, exact);
      if (searching(o) && below < o.need && below + c_o >= o.need)
        s.side[1] = narrow(o, bin, shift, o.need - below, c_o, exact);
    }
    __syncthreads();
  }

  // A side that is not `all` ended on one exact key (mask 0xFFFFFFFF): rank
  // its ties in channel order.
  const Side h = s.side[0], o = s.side[1];
  int tie_h = 0, tie_o = 0;
  if (!h.all || !o.all) {
    uint32_t mine = 0;
    for (int j = 0; j < l.per && first + j < n; ++j) {
      const uint32_t key = keys[j * l.stride + tid];
      mine += ((uint32_t)(key == h.prefix) << 16) | (uint32_t)(key == o.prefix);
    }
    uint32_t total;
    const uint32_t before = block_scan<WARPS>(mine, s.warp_tot, &total) - mine;
    tie_h = (int)(before >> 16);
    tie_o = (int)(before & 0xffffu);
  }
  // Every entry beyond the group, and the group's entries that are taken.
  // Where a side takes its whole group, "beyond or in" is one compare.
#pragma unroll 4
  for (int j = 0; j < l.per; ++j) {
    const int c = first + j;
    const bool valid = c < n;
    const uint32_t key = valid ? keys[j * l.stride + tid] : 0u;
    const bool tie_hk = key == h.prefix, tie_ok = key == o.prefix;
    const bool sel_h = valid && (h.all ? key >= h.prefix
                                       : key > h.prefix || (tie_hk && tie_h < h.need));
    const bool sel_o = valid && (o.all ? key <= (o.prefix | ~o.mask)
                                       : key < o.prefix || (tie_ok && tie_o < o.need));
    tie_h += valid && tie_hk;
    tie_o += valid && tie_ok;
    if (__any_sync(FULL, sel_h || sel_o)) {
      append(lists, &s.fill[0], sel_h, ((uint64_t)key << 32) | ~(uint32_t)c);
      append(lists + k, &s.fill[1], sel_o, ((uint64_t)~key << 32) | ~(uint32_t)c);
    }
  }
  __syncthreads();

  // Output slot of an entry = the larger composites on its side.
  for (int i = tid; i < 2 * k; i += THREADS) {
    const int side = i >= k;
    const uint64_t* list = lists + side * k;
    const uint64_t e = list[i - side * k];
    int r = 0;
    for (int j = 0; j < k; ++j) r += list[j] > e ? 1 : 0;
    const int c = (int)~(uint32_t)e;
    (side ? lo_v : hi_v)[r] = row[c];
    (side ? lo_i : hi_i)[r] = c;
  }
}

}  // namespace topk
