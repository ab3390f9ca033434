// Index LUT-GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lut_gemm.py::lut_gemm_kernel_call
// (body _index_kernel). Computes the UNSCALED product over precomputed
// activation codebook indices
//
//   Y[m, n] = sum_k aBook[aIdx[m, k]] * wBook[wIdx[k, n]]
//
// with aIdx (M, K) int32 in [0, n_a), n_a <= 256, and the weight indices
// nibble-packed (W <= 4) or one per byte (W5-W8). The caller multiplies by
// sA[m] * sW[n].
//
// What bounds it on the H100: the float32-accurate product on the TF32 tensor
// cores (3 x 2MNK operations at 495 TFLOP/s), as for the fused kernel; the
// int32 indices are 4 bytes per activation against 2 or 4 for raw
// activations, which does not move the bound. The design is the fused
// kernel's tile loop (lut_gemm_tile.cuh: weights read once per call,
// split-K, a cp.async ring, 3xTF32 on wgmma) with a shared-memory lookup of
// the split activation codebook in place of the bucketize, so on the same
// indices and tiles the two kernels add the same products in the same
// order: bucketize + this kernel equals the fused kernel bit for bit.

#include "lut_gemm_tile.cuh"

namespace {

struct IndexSource {
  using Raw = int;
  const int* raw;
  const float* a_book;
  int n_a;
  float2* s_abook;  // [256] (hi, lo)

  __device__ void block_setup() {
    for (int i = threadIdx.x; i < 256; i += blockDim.x)
      s_abook[i] = lut_tile::split3(i < n_a ? a_book[i] : 0.f);
  }
  __device__ void tile_setup(int, int) {}
  __device__ __forceinline__ void operands(int v0, int v1, int, float2& o0, float2& o1) const {
    o0 = s_abook[v0 & 255];
    o1 = s_abook[v1 & 255];
  }
};

template <int TM, int BN, bool BYTE>
__global__ void __launch_bounds__(lut_tile::Tile<TM, BN, BYTE, int>::THREADS,
                                  lut_tile::Tile<TM, BN, BYTE, int>::MIN_BLOCKS)
lut_gemm_kernel(const int* __restrict__ a_idx, const float* __restrict__ a_book, int n_a,
                lut_tile::Args a) {
  __shared__ float2 s_abook[256];
  IndexSource src{a_idx, a_book, n_a, s_abook};
  lut_tile::run<lut_tile::Tile<TM, BN, BYTE, int>>(src, a);
}

template <bool BYTE>
int dispatch(int tile_m, int tile_n, const void* a_idx, const void* a_book, int n_a,
             const lut_tile::Args& a, cudaStream_t st) {
  return lut_tile::with_tile(tile_m, tile_n, [&](auto tm, auto bn) {
    constexpr int TM = decltype(tm)::value, BN = decltype(bn)::value;
    return lut_tile::launch<lut_tile::Tile<TM, BN, BYTE, int>>(
        lut_gemm_kernel<TM, BN, BYTE>, a, st, static_cast<const int*>(a_idx),
        static_cast<const float*>(a_book), n_a);
  });
}

}  // namespace

// a_idx: (M, K) int32 in [0, n_a); w: (K, N/2) uint8 nibbles or (K, N) uint8
// bytes; a_book: (n_a,) float32, n_a <= 256; w_book: (n_w,) float32,
// n_w <= 256; y: (M, N) float32. Tile, k_split, ws and tickets as for
// fused_lut_gemm. Returns cudaGetLastError().
extern "C" int lut_gemm(const void* a_idx, const void* w, int byte_packed, const void* a_book,
                        int n_a, const void* w_book, int n_w, void* y, int M, int N, int K,
                        int tile_m, int tile_n, int k_split, void* ws, void* tickets,
                        void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (k_split <= 0 || k_split % lut_tile::BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
                   (K * sizeof(int)) % 16 == 0 && reinterpret_cast<uintptr_t>(a_idx) % 16 == 0};
  return byte_packed ? dispatch<true>(tile_m, tile_n, a_idx, a_book, n_a, a, st)
                     : dispatch<false>(tile_m, tile_n, a_idx, a_book, n_a, a, st);
}
