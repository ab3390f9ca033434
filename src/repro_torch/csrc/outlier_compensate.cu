// Sparse outlier compensation for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the compensation to jnp
// (repro/core/outlier.py::compensate_gather and compensate_scatter), and the
// port had copied it -- a zero-filled dense (M, K) residual matrix with an
// accumulating index_put_, the whole K x N weight dequantized to float32, and
// a float32 GEMM whose left operand is 99 % zeros. This kernel does only the
// work the outliers need, adding in place into the main branch's output:
//
//   y[m, n] += w_scale[n] * sum_t r[m, t] * w_book[idx[ch[m, t], n]]
//   r[m, t]  = (v[m, t] - a_book[bucket(v[m, t], s[m])] * s[m]) * mask[m, t]
//
// with bucket() the compare form of the activation's dtype, as
// outlier_residuals_direct and the fused LUT-GEMM count it: sum_i [v >= s b_i]
// (bfloat16 origin, mul form) or sum_i [v / s >= b_i] (float32 origin, IEEE
// division). Every product and sum is float32 and rounded on its own (no
// contraction into an FMA), in the order of the plain version
// (kernels/outlier_compensate.py::outlier_compensate_plain): the slots of a
// row in turn, then one multiply by the channel scale and one add into y. So
// the kernel equals it bit for bit, but for the sign of a zero: a slot whose
// residual is exactly 0 (a masked slot, a channel outside a row-parallel
// window) is skipped. Duplicate channels (a channel in both the top and the
// bottom set) add twice, as the dense routes add them.
//
// What bounds it on the H100: not FLOPs. A danube step needs ~5 G multiply-adds
// of outlier residuals into weight rows, but each is an index unpack, a
// codebook lookup and an add; the bytes are the read and write of y (8 bytes an
// output) and the packed weight rows of the outlier channels, which L2 mostly
// serves (a projection's packed weight is at most 17.7 MB). The design:
//
// * One warp a (row, column split): the lanes take consecutive chunks of a
//   packed weight row, so a warp reads whole 128-byte lines, and the splits
//   are as many as keep every split within 32 chunks. The grid runs over
//   (row, split) pairs, 8 warps a block. The chunk adapts to the shape: 16
//   bytes (32 nibble or 16 byte columns a lane) where the rows and splits give
//   a wave of 16 warps an SM, else 8 or 4 bytes, for more and shorter warps
//   (a 304 x 640 projection has 304 warps at 16 bytes, 912 at 4).
// * Residuals in the warp: 32 slots at a time, one a lane (the bucket's
//   compares against the boundaries), broadcast by shuffles. Nothing of the
//   dense (M, K) matrix or a float weight exists.
// * The lookup from shared memory, free of bank conflicts: nibble weights
//   (<= 16 centroids) through a table of the 16 products r * w_book[j] per
//   slot, built by the slot's lane, so an output costs a shift, a mask, a
//   load and an add; byte weights (256 centroids) through one copy of the
//   codebook per lane (entry j of lane l in bank l), times r.
// * Four packed rows in flight per lane before their sums (eight for chunks
//   under 16 bytes); the sums in registers, one read-modify-write of y per
//   output at the end.
//
// TMA and wgmma have nothing to do: no tile is reused and there is no dense
// product. Rows not a multiple of 4 bytes (or a weight off 4-byte alignment)
// take 1-byte chunks, and y or the scales off 16-byte alignment scalar stores.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SLOTS = 32;  // outlier slots a warp takes at a time: one a lane
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMS = 132;  // streaming multiprocessors of an H100 SXM
constexpr long long WAVE = SMS * 16;  // warps that keep 16 resident on every SM

// VEC bytes of one packed row as 32-bit words (VEC = 1: the byte in word 0)
template <int VEC>
__device__ __forceinline__ void load_chunk(const uint8_t* p,
                                           uint32_t (&w)[VEC >= 4 ? VEC / 4 : 1]) {
  if constexpr (VEC == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (VEC == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else if constexpr (VEC == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    w[0] = __ldg(p);
  }
}

template <bool BYTE, int VEC>
__global__ void __launch_bounds__(THREADS)
outlier_compensate_kernel(float* __restrict__ y, const float* __restrict__ values,
                          const int* __restrict__ channels, const float* __restrict__ mask,
                          const float* __restrict__ scale, const float* __restrict__ bounds,
                          int n_bounds, const float* __restrict__ a_book, int mul_form,
                          const uint8_t* __restrict__ packed, int row_bytes,
                          const float* __restrict__ w_book, int n_w,
                          const float* __restrict__ w_scale, int M, int N, int T, int splits,
                          int per_split, int n_chunks, bool vec_y) {
  constexpr int WORDS = VEC >= 4 ? VEC / 4 : 1;
  constexpr int INFLIGHT = VEC >= 16 ? 4 : 8;  // packed rows a lane loads before summing them
  constexpr int PER = BYTE ? (VEC >= 4 ? 4 : 1) : (VEC >= 4 ? 8 : 2);  // columns a word holds
  constexpr int COLS = WORDS * PER;
  // byte weights: the codebook once per lane; nibble weights: 16 products a slot
  __shared__ __align__(16) float s_book[BYTE ? 256 * 32 : 1];
  __shared__ __align__(16) float s_tab[BYTE ? 1 : WARPS * SLOTS * 16];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if constexpr (BYTE) {
    for (int i = threadIdx.x; i < 256 * 32; i += THREADS)
      s_book[i] = (i >> 5) < n_w ? __ldg(w_book + (i >> 5)) : 0.f;
    __syncthreads();
  }
  const long long task = (long long)blockIdx.x * WARPS + warp;
  if (task >= (long long)M * splits) return;  // whole warps leave together
  const int m = static_cast<int>(task / splits);
  const int chunk = static_cast<int>(task % splits) * per_split + lane;
  const bool mine = lane < per_split && chunk < n_chunks;

  float book16[16];  // nibble weights: the centroids, zero past n_w
  if constexpr (!BYTE) {
#pragma unroll
    for (int j = 0; j < 16; ++j) book16[j] = j < n_w ? __ldg(w_book + j) : 0.f;
  }
  const float s = __ldg(scale + m);
  const size_t slot0 = (size_t)m * T;
  const uint8_t* col = packed + (size_t)chunk * VEC;
  float* tabs = s_tab + warp * SLOTS * 16;
  float acc[COLS];
#pragma unroll
  for (int i = 0; i < COLS; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < T; t0 += SLOTS) {
    // this lane's slot: its residual and channel
    float r = 0.f;
    int ch = 0;
    if (t0 + lane < T) {
      const float v = __ldg(values + slot0 + t0 + lane);
      int b = 0;
      if (mul_form) {
        for (int i = 0; i < n_bounds; ++i) b += v >= __fmul_rn(s, __ldg(bounds + i)) ? 1 : 0;
      } else {
        const float u = __fdiv_rn(v, s);
        for (int i = 0; i < n_bounds; ++i) b += u >= __ldg(bounds + i) ? 1 : 0;
      }
      const float deq = __fmul_rn(__ldg(a_book + b), s);
      r = __fmul_rn(__fsub_rn(v, deq), __ldg(mask + slot0 + t0 + lane));
      ch = __ldg(channels + slot0 + t0 + lane);
    }
    if constexpr (!BYTE) {
      float4* tab = reinterpret_cast<float4*>(tabs + lane * 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tab[j] = make_float4(__fmul_rn(r, book16[4 * j]), __fmul_rn(r, book16[4 * j + 1]),
                             __fmul_rn(r, book16[4 * j + 2]), __fmul_rn(r, book16[4 * j + 3]));
      __syncwarp();
    }
    const int nt = min(SLOTS, T - t0);
    for (int q0 = 0; q0 < nt; q0 += INFLIGHT) {
      uint32_t w[INFLIGHT][WORDS];
      float rq[INFLIGHT];
      bool live[INFLIGHT];
#pragma unroll
      for (int u = 0; u < INFLIGHT; ++u) {
        const int q = q0 + u;
        rq[u] = __shfl_sync(FULL, r, q & 31);
        const int cq = __shfl_sync(FULL, ch, q & 31);
        live[u] = q < nt && rq[u] != 0.f;  // the same on every lane
#pragma unroll
        for (int i = 0; i < WORDS; ++i) w[u][i] = 0u;
        if (live[u] && mine) load_chunk<VEC>(col + (size_t)cq * row_bytes, w[u]);
      }
#pragma unroll
      for (int u = 0; u < INFLIGHT; ++u) {
        if (!live[u] || !mine) continue;
        if constexpr (BYTE) {
#pragma unroll
          for (int i = 0; i < WORDS; ++i)
#pragma unroll
            for (int j = 0; j < PER; ++j) {
              const float c = s_book[((w[u][i] >> (8 * j)) & 255u) * 32 + lane];
              acc[i * PER + j] = __fadd_rn(acc[i * PER + j], __fmul_rn(rq[u], c));
            }
        } else {
          const float* tab = tabs + (q0 + u) * 16;
#pragma unroll
          for (int i = 0; i < WORDS; ++i)
#pragma unroll
            for (int j = 0; j < PER; ++j)
              acc[i * PER + j] = __fadd_rn(acc[i * PER + j], tab[(w[u][i] >> (4 * j)) & 15u]);
        }
      }
    }
    if constexpr (!BYTE) __syncwarp();  // every lane done with the tables before the next
  }
  if (!mine) return;

  const int c0 = chunk * COLS;
  float* yr = y + (size_t)m * N + c0;
  if constexpr (COLS % 4 == 0) {
    if (vec_y) {
#pragma unroll
      for (int i = 0; i < COLS / 4; ++i) {
        float4 yv = reinterpret_cast<float4*>(yr)[i];
        const float4 sv = __ldg(reinterpret_cast<const float4*>(w_scale + c0) + i);
        yv.x = __fadd_rn(yv.x, __fmul_rn(acc[4 * i], sv.x));
        yv.y = __fadd_rn(yv.y, __fmul_rn(acc[4 * i + 1], sv.y));
        yv.z = __fadd_rn(yv.z, __fmul_rn(acc[4 * i + 2], sv.z));
        yv.w = __fadd_rn(yv.w, __fmul_rn(acc[4 * i + 3], sv.w));
        reinterpret_cast<float4*>(yr)[i] = yv;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < COLS; ++i)
    yr[i] = __fadd_rn(yr[i], __fmul_rn(acc[i], __ldg(w_scale + c0 + i)));
}

// (row, split) warps for chunks of VEC bytes: splits of at most 32 chunks
long long tasks_of(int M, int row_bytes, int vec) {
  const int n_chunks = row_bytes / vec;
  return (long long)M * ((n_chunks + 31) / 32);
}

template <bool BYTE, int VEC>
void launch(float* y, const float* values, const int* channels, const float* mask,
            const float* scale, const float* bounds, int n_bounds, const float* a_book,
            int mul_form, const uint8_t* packed, int row_bytes, const float* w_book, int n_w,
            const float* w_scale, int M, int N, int T, cudaStream_t stream) {
  const int n_chunks = row_bytes / VEC;
  const int splits = (n_chunks + 31) / 32;
  const int per_split = (n_chunks + splits - 1) / splits;
  const long long tasks = (long long)M * splits;
  const int grid = static_cast<int>((tasks + WARPS - 1) / WARPS);
  const auto at = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec_y = N % 4 == 0 && at(y) && at(w_scale);
  outlier_compensate_kernel<BYTE, VEC><<<grid, THREADS, 0, stream>>>(
      y, values, channels, mask, scale, bounds, n_bounds, a_book, mul_form, packed, row_bytes,
      w_book, n_w, w_scale, M, N, T, splits, per_split, n_chunks, vec_y);
}

template <bool BYTE>
void launch_vec(float* y, const float* values, const int* channels, const float* mask,
                const float* scale, const float* bounds, int n_bounds, const float* a_book,
                int mul_form, const uint8_t* packed, int row_bytes, const float* w_book,
                int n_w, const float* w_scale, int M, int N, int T, cudaStream_t stream) {
  // the widest chunk whose (row, split) warps fill a wave, else the
  // narrowest of 16, 8 and 4 bytes the rows allow, else single bytes
  constexpr int widths[] = {16, 8, 4};
  int vec = 1;
  for (int v : widths) {
    if (row_bytes % v != 0 || reinterpret_cast<uintptr_t>(packed) % v != 0) continue;
    vec = v;
    if (tasks_of(M, row_bytes, v) >= WAVE) break;
  }
  if (vec == 16)
    launch<BYTE, 16>(y, values, channels, mask, scale, bounds, n_bounds, a_book, mul_form,
                     packed, row_bytes, w_book, n_w, w_scale, M, N, T, stream);
  else if (vec == 8)
    launch<BYTE, 8>(y, values, channels, mask, scale, bounds, n_bounds, a_book, mul_form,
                    packed, row_bytes, w_book, n_w, w_scale, M, N, T, stream);
  else if (vec == 4)
    launch<BYTE, 4>(y, values, channels, mask, scale, bounds, n_bounds, a_book, mul_form,
                    packed, row_bytes, w_book, n_w, w_scale, M, N, T, stream);
  else
    launch<BYTE, 1>(y, values, channels, mask, scale, bounds, n_bounds, a_book, mul_form,
                    packed, row_bytes, w_book, n_w, w_scale, M, N, T, stream);
}

}  // namespace

// y: (M, N) float32, updated in place; values, mask: (M, T) float32; channels:
// (M, T) int32 in [0, K); scale: (M,) float32; bounds: (n_bounds,) sorted,
// a_book: (n_bounds + 1,) float32; packed: (K, N / 2) nibble pairs (low nibble
// first, n_w <= 16) or (K, N) bytes (byte_packed, n_w <= 256) uint8; w_book:
// (n_w,), w_scale: (N,) float32. Returns cudaGetLastError().
extern "C" int outlier_compensate(void* y, const void* values, const void* channels,
                                  const void* mask, const void* scale, const void* bounds,
                                  int n_bounds, const void* a_book, int mul_form,
                                  const void* packed, int byte_packed, const void* w_book,
                                  int n_w, const void* w_scale, int M, int N, int T,
                                  void* stream) {
  if (M > 0 && N > 0 && T > 0) {
    auto* yf = static_cast<float*>(y);
    const auto* v = static_cast<const float*>(values);
    const auto* c = static_cast<const int*>(channels);
    const auto* mk = static_cast<const float*>(mask);
    const auto* s = static_cast<const float*>(scale);
    const auto* b = static_cast<const float*>(bounds);
    const auto* ab = static_cast<const float*>(a_book);
    const auto* p = static_cast<const uint8_t*>(packed);
    const auto* wb = static_cast<const float*>(w_book);
    const auto* ws = static_cast<const float*>(w_scale);
    auto st = static_cast<cudaStream_t>(stream);
    if (byte_packed)
      launch_vec<true>(yf, v, c, mk, s, b, n_bounds, ab, mul_form, p, N, wb, n_w, ws, M, N, T, st);
    else
      launch_vec<false>(yf, v, c, mk, s, b, n_bounds, ab, mul_form, p, N / 2, wb, n_w, ws, M, N,
                        T, st);
  }
  return static_cast<int>(cudaGetLastError());
}
