// Fused activation quantize + LUT-GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lut_gemm.py::fused_lut_gemm_kernel_call
// (body _fused_kernel). Computes the UNSCALED product
//
//   Y[m, n] = sum_k aBook[bucketize(x[m, k], s[m])] * wBook[wIdx[k, n]]
//
// where bucketize counts the activation decision boundaries b_i that x passes:
// float32 inputs compare x / s >= b_i (IEEE division, the searchsorted form),
// bfloat16 inputs compare x >= s * b_i (the fused mul form); a NaN passes
// none. Weight indices are nibble-packed (W <= 4: packed[k, i] = idx[k, 2i] |
// idx[k, 2i+1] << 4) or one per byte (W5-W8). The caller multiplies by
// s[m] * wScale[n].
//
// What bounds it on the H100: the float32-accurate product on the TF32 tensor
// cores, 3 x 2MNK operations at 495 TFLOP/s (mlp/wi at 72 token rows: 29 us),
// over the bytes (21.8 MB, 6.5 us). The tile loop (lut_gemm_tile.cuh) reads
// and decodes each weight byte once per call, splits K to fill the card,
// stages weights and raw activations through a cp.async ring and multiplies
// in 3xTF32. This file adds the activation source: each block bucketizes a
// stage's activations once, for all rows of its row tile, into the MMA
// operand, as the sum of 15 compares against thresholds held in registers
// (the products s * b_i per row for the mul form, computed once per row
// tile): independent compares, no search chained through shared memory, and
// exact for any order of the boundaries.

#include <cuda_bf16.h>

#include "lut_gemm_tile.cuh"

namespace {

constexpr int NB = 16;      // boundary slots: up to 15 boundaries, NaN-padded
constexpr int SB_ROW = 20;  // floats per row of the per-row thresholds (bank spread)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename XT, int TM>
struct FusedSource {
  using Raw = XT;
  const XT* raw;
  const float* scale;
  const float* bounds;
  const float* a_book;
  int nb, mul;
  float* s_bounds;  // [NB] the boundaries (division form)
  float2* s_abook;  // [NB] (hi, lo) of the centroids
  float* s_sb;      // [TM][SB_ROW] s * b_i of each row (mul form)
  float* s_scale;   // [TM] (division form)

  __device__ void block_setup() {
    const int t = threadIdx.x;
    if (t < NB) {
      s_bounds[t] = t < nb ? bounds[t] : __int_as_float(0x7fffffff);
      s_abook[t] = lut_tile::split3(t <= nb ? a_book[t] : 0.f);
    }
  }

  __device__ void tile_setup(int m0, int rows) {
    const int r = threadIdx.x;
    if (r >= rows) return;
    const float s = scale[m0 + r];
    s_scale[r] = s;
    if (mul)
      for (int i = 0; i < NB; ++i)
        s_sb[r * SB_ROW + i] = i < nb ? s * bounds[i] : __int_as_float(0x7fffffff);
  }

  // the centroids (hi, lo) of two activations of tile row r: each index is
  // the sum of 15 compares against thresholds held in registers (a NaN
  // threshold or activation passes none)
  __device__ __forceinline__ void operands(XT v0, XT v1, int r, float2& o0, float2& o1) const {
    float x0 = to_float(v0), x1 = to_float(v1);
    const float* t = s_bounds;
    if (mul) {
      t = s_sb + r * SB_ROW;
    } else {
      const float sc = s_scale[r];
      x0 = __fdiv_rn(x0, sc);
      x1 = __fdiv_rn(x1, sc);
    }
    float b[NB];
#pragma unroll
    for (int q = 0; q < NB / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(t)[q];
      b[4 * q] = v.x, b[4 * q + 1] = v.y, b[4 * q + 2] = v.z, b[4 * q + 3] = v.w;
    }
    int c0 = 0, c1 = 0;
#pragma unroll
    for (int i = 0; i < NB - 1; ++i) {
      c0 += (x0 >= b[i]) ? 1 : 0;
      c1 += (x1 >= b[i]) ? 1 : 0;
    }
    o0 = s_abook[c0];
    o1 = s_abook[c1];
  }
};

template <int TM, int BN, bool BYTE, typename XT>
__global__ void __launch_bounds__(lut_tile::Tile<TM, BN, BYTE, XT>::THREADS,
                                  lut_tile::Tile<TM, BN, BYTE, XT>::MIN_BLOCKS)
fused_lut_gemm_kernel(const XT* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bounds, int n_bounds, int mul_form,
                      const float* __restrict__ a_book, lut_tile::Args a) {
  __shared__ __align__(16) float s_bounds[NB];
  __shared__ float2 s_abook[NB];
  __shared__ __align__(16) float s_sb[TM * SB_ROW];
  __shared__ float s_scale[TM];
  FusedSource<XT, TM> src{x,        scale, bounds, a_book,  n_bounds, mul_form,
                          s_bounds, s_abook, s_sb,  s_scale};
  lut_tile::run<lut_tile::Tile<TM, BN, BYTE, XT>>(src, a);
}

template <bool BYTE, typename XT>
int dispatch(int tile_m, int tile_n, const void* x, const void* scale, const void* bounds,
             int n_bounds, int mul_form, const void* a_book, const lut_tile::Args& a,
             cudaStream_t st) {
  return lut_tile::with_tile(tile_m, tile_n, [&](auto tm, auto bn) {
    constexpr int TM = decltype(tm)::value, BN = decltype(bn)::value;
    return lut_tile::launch<lut_tile::Tile<TM, BN, BYTE, XT>>(
        fused_lut_gemm_kernel<TM, BN, BYTE, XT>, a, st, static_cast<const XT*>(x),
        static_cast<const float*>(scale), static_cast<const float*>(bounds), n_bounds,
        mul_form, static_cast<const float*>(a_book));
  });
}

}  // namespace

// x: (M, K) float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1); scale: (M,) float32;
// w: (K, N/2) uint8 nibbles or (K, N) uint8 bytes; bounds: (n_bounds,) float32
// with n_bounds <= 15; a_book: (n_bounds + 1,) float32; w_book: (n_w,) float32
// with n_w <= 256; y: (M, N) float32. Tile: (tile_m, tile_n) one of
// lut_tile::with_tile's, k_split K rows per split (a multiple of 32); with
// more than one split, ws holds (splits, M, N) float32 and tickets
// ceil(N / tile_n) zeroed int32 (left zeroed). Returns cudaGetLastError().
extern "C" int fused_lut_gemm(const void* x, int x_bf16, const void* scale, const void* w,
                              int byte_packed, const void* bounds, int n_bounds,
                              int mul_form, const void* a_book, const void* w_book,
                              int n_w, void* y, int M, int N, int K, int tile_m, int tile_n,
                              int k_split, void* ws, void* tickets, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (k_split <= 0 || k_split % lut_tile::BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t x_size = x_bf16 ? 2 : 4;
  const size_t w_row = byte_packed ? (size_t)N : (size_t)N / 2;
  lut_tile::Args a{static_cast<const uint8_t*>(w),
                   static_cast<const float*>(w_book),
                   n_w,
                   static_cast<float*>(y),
                   static_cast<float*>(ws),
                   static_cast<int*>(tickets),
                   M,
                   N,
                   K,
                   k_split,
                   w_row % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0,
                   (K * x_size) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0};
  if (x_bf16) {
    return byte_packed ? dispatch<true, __nv_bfloat16>(tile_m, tile_n, x, scale, bounds,
                                                        n_bounds, mul_form, a_book, a, st)
                       : dispatch<false, __nv_bfloat16>(tile_m, tile_n, x, scale, bounds,
                                                         n_bounds, mul_form, a_book, a, st);
  }
  return byte_packed ? dispatch<true, float>(tile_m, tile_n, x, scale, bounds, n_bounds,
                                             mul_form, a_book, a, st)
                     : dispatch<false, float>(tile_m, tile_n, x, scale, bounds, n_bounds,
                                              mul_form, a_book, a, st);
}
