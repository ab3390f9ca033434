// The tile loop shared by the LUT-GEMM kernels (fused_lut_gemm.cu,
// lut_gemm.cu). Both compute the UNSCALED product
//
//   Y[m, n] = sum_k A[m, k] * wBook[wIdx[k, n]]
//
// and differ only in where A[m, k] -- an activation centroid -- comes from:
// the fused kernel bucketizes raw activations, the index kernel looks up
// int32 indices. The caller passes that step in as an activation source
// (`Src`, below).
//
// What bounds it on the H100: the float32-accurate product. On the CUDA cores
// (67 TFLOP/s) it is already slower than a bf16 tensor-core product on
// dequantized weights, so it runs on the TF32 tensor cores as 3xTF32, three
// products per term: 3 x 2MNK operations at 495 TFLOP/s (mlp/wi at 72 token
// rows: 29 us) over 21.8 MB of traffic (6.5 us at 3.35 TB/s).
//
// The design:
//
// 1. Weights are the MMA's row operand and tokens its column operand ("swap A
//    and B"): a block owns a strip of BN output columns and ALL M token rows,
//    walked in row tiles of TM = 8, 72 or 80 (the warpgroup MMA's N; a packed
//    serving step of 72 rows is one tile), so each weight byte is read and
//    decoded once per call. A warpgroup owns 64 columns, a warp 16 of them.
// 2. Split-K: the grid is (strips, splits), each block walks a chunk of K.
//    With more than one split, each block writes its partial tile to a
//    workspace and takes a ticket; the last block of a strip to arrive sums
//    the partials in split order (fixed order, no float atomics: the same
//    bits on every call) and resets the ticket for the next launch.
// 3. A ring of STAGES shared-memory stages, filled by cp.async (16 bytes a
//    thread) with the packed weight bytes and the raw activations of BK rows
//    of K, runs STAGES - 1 stages ahead of the arithmetic; one barrier a stage.
// 4. 3xTF32 (CUTLASS's OpMultiplyAddFastF32 recipe) on wgmma.m64nNk8: every
//    codebook entry c is split once per block into hi = tf32_rna(c) and lo =
//    tf32_rna(c - hi), |c - hi - lo| <= 2^-22 |c|, and each term is
//    accumulated in float32 as lo*hi + hi*lo + hi*hi. The weight fragment
//    (A) comes from registers, decoded through the codebook; the token
//    operand (B) is read by the tensor cores from shared memory through a
//    descriptor. On codebooks with at most 11 significant bits
//    (exact_sum_inputs' 1/8 grid) lo = 0 and every product is exact.
// 5. The token operand of stage s + 1 (hi and lo matrices, K-major) is built
//    before stage s is multiplied, once per block for all rows of the tile,
//    into one of two shared-memory buffers: the bucketize (fused) or index
//    lookup (index kernel) runs once per (row, k) per strip.
//
// Weight indices are nibble-packed (W <= 4: packed[k, i] = idx[k, 2i] |
// idx[k, 2i+1] << 4, the low nibble is the even column) or one per byte
// (W5-W8). MMA row r of a warp's 16 maps to column 2 (r % 8) + r / 8, so one
// 8-bit (nibble) or 16-bit (byte) load gives a thread its two columns. The
// split codebook is held as separate hi and lo tables so that each lookup
// lands in its fragment register; the byte tier's 256 entries are held in
// one copy per lane so lookups never share a bank, the nibble tier's 16 fill
// 16 banks once. Activation rows past M and K columns past the split's end
// enter as exact zeros.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace lut_tile {

constexpr int BK = 32;     // K rows per pipeline stage (block_k is a multiple)
constexpr int STAGES = 4;  // cp.async ring depth

// What a launch needs besides the activation source.
struct Args {
  const uint8_t* w;  // (K, N) bytes or (K, N / 2) nibble pairs
  const float* w_book;
  int n_w;
  float* y;        // (M, N)
  float* ws;       // (splits, M, N) partial tiles when gridDim.y > 1
  int* tickets;    // one zeroed counter per strip when gridDim.y > 1
  int M, N, K;
  int kc;          // K rows per split, a multiple of BK
  int w_vec;       // weight rows allow 16-byte copies (aligned)
  int x_vec;       // activation rows allow 16-byte copies (aligned)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; the bytes past src_bytes (0..16) are zero-filled
// and not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// (hi, lo) TF32 parts of c: c - hi is exact in float32.
__device__ __forceinline__ float2 split3(float c) {
  const uint32_t hi = tf32_rna(c);
  return make_float2(__uint_as_float(hi), __uint_as_float(tf32_rna(c - __uint_as_float(hi))));
}

// m64nNk8 TF32 warpgroup MMA, d += a * b: a (64 x 8) from registers, b
// (8 x N, K-major) from shared memory through a descriptor; asynchronous
// until wgmma_wait.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ static __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}"
        ", {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<72> {
  __device__ static __forceinline__ void mma(float (&d)[36], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35}"
        ", {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<80> {
  __device__ static __forceinline__ void mma(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}"
        ", {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of this thread visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accumulator accesses across wgmma
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of an 8 x N tf32 operand, K-major without swizzle: core
// matrices of 8 rows x 16 bytes, the two K halves LBO = 128 bytes apart, the
// 8-row groups along N SBO = 256 bytes apart.
__device__ __forceinline__ uint64_t operand_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// Shared-memory plan of one tile configuration. Raw is the activation
// source's element type (float, bfloat16 or int32 indices).
template <int TM_, int BN_, bool BYTE_, typename Raw>
struct Tile {
  static constexpr int TM = TM_, BN = BN_;  // token rows (the MMA's N), columns
  static constexpr bool BYTE = BYTE_;
  static constexpr int GROUPS = BN / 64;     // warpgroups, 64 columns each
  static constexpr int WARPS = 4 * GROUPS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NJ = TM / 8;          // 8-token groups of a row tile
  static constexpr int W_BYTES = BYTE ? BN : BN / 2;   // a strip's bytes of one K row
  // padded rows: a warp's fragment loads (4 K rows x 8 lanes) do not share banks
  static constexpr int W_ROW = W_BYTES + 16;
  static constexpr int W_STAGE = BK * W_ROW;
  static constexpr int X_ROW = BK * (int)sizeof(Raw) + 16;
  static constexpr int X_STAGE = TM * X_ROW;
  // operand of a stage: hi then lo, each BK / 8 matrices of 8 x TM (K-major)
  static constexpr int B_MAT = NJ * 256;
  static constexpr int B_BYTES = 2 * (BK / 8) * B_MAT;
  // byte tier: the codebook in one copy per lane (lookups never share a bank)
  static constexpr int COPIES = 32;
  static constexpr int WTAB = BYTE ? 256 * COPIES : 16;  // entries of the hi and lo tables
  static constexpr int OFF_X = STAGES * W_STAGE;
  static constexpr int OFF_B = OFF_X + STAGES * X_STAGE;
  static constexpr int OFF_WTAB = OFF_B + 2 * B_BYTES;  // two operand buffers
  static constexpr int SMEM = OFF_WTAB + 2 * WTAB * 4;
  // two blocks an SM where shared memory allows, registers capped at 128 a
  // thread; one 512-thread block has the same cap
  static constexpr int MIN_BLOCKS = THREADS <= 256 && SMEM <= 100 * 1024 ? 2 : 1;
  static_assert(BN == 128 || BN == 256, "BN must be 128 or 256");
  static_assert(TM == 8 || TM == 72 || TM == 80, "TM must be a Wgmma shape");
  static_assert(SMEM <= 212 * 1024, "shared memory plan too large");
};

// Two consecutive outputs of one row, col even.
__device__ __forceinline__ void store2(float* dst, const Args& a, int row, int col, float v0,
                                       float v1) {
  if (row >= a.M) return;
  float* p = dst + (size_t)row * a.N + col;
  if ((a.N & 1) == 0 && col + 1 < a.N) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (col < a.N) p[0] = v0;
    if (col + 1 < a.N) p[1] = v1;
  }
}

// Element copies of `rows` rows of WIDTH elements starting at column col0 of
// a (*, ld) array into rows of ROW bytes, zero past (n_rows, ld): the path for
// rows that are not 16-byte aligned, kept out of line.
template <int WIDTH, int ROW, int THREADS, typename E>
__device__ __noinline__ void copy_rows(E* dst, const E* src, int rows, int row0, int n_rows,
                                       int ld, int col0) {
  for (int c = threadIdx.x; c < rows * WIDTH; c += THREADS) {
    const int r = c / WIDTH, i = c % WIDTH;
    const int gr = row0 + r, col = col0 + i;
    reinterpret_cast<E*>(reinterpret_cast<uint8_t*>(dst) + r * ROW)[i] =
        (gr < n_rows && col < ld) ? src[(size_t)gr * ld + col] : E{};
  }
}

// The whole block. Src provides:
//   using Raw;  const Raw* raw;                   (M, K) row-major
//   void block_setup();                           tables; read after a barrier
//   void tile_setup(int m0, int rows);            per-row data of a row tile
//   void operands(Raw v0, Raw v1, int r, float2& o0, float2& o1) const;
//                                                 (hi, lo) of the centroids of
//                                                 two activations of tile row r
// All of Src's shared state is written before the barrier that precedes its
// first read.
template <class T, class Src>
__device__ __forceinline__ void run(Src& src, const Args& a) {
  using Raw = typename Src::Raw;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_w = smem;
  uint8_t* s_x = smem + T::OFF_X;
  uint8_t* s_b = smem + T::OFF_B;
  float* s_whi = reinterpret_cast<float*>(smem + T::OFF_WTAB);
  float* s_wlo = s_whi + T::WTAB;
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // this warp's 16 columns of its warpgroup's 64: MMA row gid + 8 h is
  // column wcol + 2 gid + h
  const int wcol = 16 * warp;
  const int n0 = blockIdx.x * T::BN;
  const int split = blockIdx.y, splits = gridDim.y;
  const int kb = split * a.kc;
  const int ke = min(a.K, kb + a.kc);
  const int n_stages = ke > kb ? (ke - kb + BK - 1) / BK : 0;
  const int w_row_bytes = T::BYTE ? a.N : a.N / 2;
  const int strip_byte0 = T::BYTE ? n0 : n0 / 2;
  const size_t x_row_bytes = (size_t)a.K * sizeof(Raw);
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(src.raw);

  // the weight codebook, split for 3xTF32 (byte tier: COPIES copies)
  for (int e = tid; e < T::WTAB; e += T::THREADS) {
    const int i = T::BYTE ? e / T::COPIES : e;
    const float2 h = split3(i < a.n_w ? a.w_book[i] : 0.f);
    s_whi[e] = h.x;
    s_wlo[e] = h.y;
  }
  src.block_setup();

  // stage s of the current row tile into ring slot s % STAGES: 16-byte
  // asynchronous copies, or element copies where rows are not 16-byte aligned
  auto load = [&](int s, int m0, int rows) {
    const int slot = s % STAGES;
    const int k0 = kb + s * BK;
    uint8_t* dw = s_w + slot * T::W_STAGE;
    uint8_t* dx = s_x + slot * T::X_STAGE;
    constexpr int CW = T::W_BYTES / 16;
    constexpr int CX = BK * (int)sizeof(Raw) / 16;
    if (a.w_vec) {
      for (int c = tid; c < BK * CW; c += T::THREADS) {
        const int kk = c / CW, q = c % CW;
        const int k = k0 + kk, col = strip_byte0 + q * 16;
        const int nbytes = k < a.K ? max(0, min(16, w_row_bytes - col)) : 0;
        const uint8_t* p = nbytes > 0 ? a.w + (size_t)k * w_row_bytes + col : a.w;
        cp_async16(dw + kk * T::W_ROW + q * 16, p, nbytes);
      }
    } else {
      copy_rows<T::W_BYTES, T::W_ROW, T::THREADS>(dw, a.w, BK, k0, a.K, w_row_bytes, strip_byte0);
    }
    if (a.x_vec) {
      const long long off0 = (long long)k0 * sizeof(Raw);
      for (int c = tid; c < rows * CX; c += T::THREADS) {
        const int r = c / CX, q = c % CX;
        const long long off = off0 + q * 16;
        const int nbytes = (int)max(0LL, min(16LL, (long long)x_row_bytes - off));
        const uint8_t* p = nbytes > 0 ? xb + (size_t)(m0 + r) * x_row_bytes + off : xb;
        cp_async16(dx + r * T::X_ROW + q * 16, p, nbytes);
      }
    } else {
      copy_rows<BK, T::X_ROW, T::THREADS>(reinterpret_cast<Raw*>(dx), src.raw + (size_t)m0 * a.K,
                                          rows, 0, rows, a.K, k0);
    }
  };

  // the activation operand of stage s into buffer s & 1: for each k8 step t
  // a hi and a lo matrix of 8 x TM, K-major in core matrices (token group j,
  // K half, token row, 4 k); unit (t, j) writes token 8 j + gid at k = 8 t +
  // tig (first half) and 8 t + tig + 4 (second half)
  auto build_operand = [&](int s, int rows) {
    const uint8_t* dx = s_x + (s % STAGES) * T::X_STAGE;
    float* hi = reinterpret_cast<float*>(s_b + (s & 1) * T::B_BYTES);
    float* lo = hi + (BK / 8) * T::B_MAT / 4;
    const int k0 = kb + s * BK;
#pragma unroll 1
    for (int u = warp; u < (BK / 8) * T::NJ; u += T::WARPS) {
      const int t = u / T::NJ, j = u - t * T::NJ;
      const int r = 8 * j + gid, kk = 8 * t + tig;
      float2 v0 = make_float2(0.f, 0.f), v1 = v0;
      if (r < rows) {
        const Raw* row = reinterpret_cast<const Raw*>(dx + r * T::X_ROW);
        src.operands(row[kk], row[kk + 4], r, v0, v1);
        if (k0 + kk >= ke) v0 = make_float2(0.f, 0.f);
        if (k0 + kk + 4 >= ke) v1 = make_float2(0.f, 0.f);
      }
      const int o = (t * T::B_MAT + j * 256 + gid * 16) / 4 + tig;
      hi[o] = v0.x;
      lo[o] = v0.y;
      hi[o + 32] = v1.x;
      lo[o + 32] = v1.y;
    }
    fence_async_shared();
  };

  const float* whi = s_whi + (T::BYTE ? lane % T::COPIES : 0);
  const float* wlo = s_wlo + (T::BYTE ? lane % T::COPIES : 0);
  constexpr int WSTRIDE = T::BYTE ? T::COPIES : 1;

  float acc[T::TM / 2];
  __syncthreads();  // codebook tables
  for (int m0 = 0; m0 < a.M; m0 += T::TM) {
    const int rows = min(T::TM, a.M - m0);
    src.tile_setup(m0, rows);
#pragma unroll
    for (int i = 0; i < T::TM / 2; ++i) acc[i] = 0.f;

#pragma unroll 1
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_stages) load(s, m0, rows);
      cp_async_commit();
    }
    if (n_stages > 0) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage 0 and the per-row tables
      build_operand(0, rows);
    }
    // iteration s builds the operand of stage s + 1, then multiplies stage
    // s; STAGES - 2 further stages are in flight
    for (int s = 0; s < n_stages; ++s) {
      cp_async_wait<STAGES - 3>();
      // operand s is built; stage s + 1 landed; slot (s - 1) % STAGES and
      // operand buffer (s + 1) & 1 (stage s - 1's, its MMAs waited for) are
      // free
      __syncthreads();
      if (s + STAGES - 1 < n_stages) load(s + STAGES - 1, m0, rows);
      cp_async_commit();
      if (s + 1 < n_stages) build_operand(s + 1, rows);

      // 3xTF32 on the warpgroup MMA: per k8 step t the warp's A fragment
      // (its 16 columns x 8 k) from the codebook tables, then lo*hi, hi*lo,
      // hi*hi against the stage's operand; the next step's fragment is
      // decoded while these run
      const uint32_t b_base = smem_u32(s_b + (s & 1) * T::B_BYTES);
      const uint8_t* dw = s_w + (s % STAGES) * T::W_STAGE;
      uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
      for (int t = 0; t < BK / 8; ++t) {
        // K rows 8t + tig (a0, a1) and 8t + tig + 4 (a2, a3)
        const uint8_t* r0 = dw + (8 * t + tig) * T::W_ROW;
        const uint8_t* r1 = r0 + 4 * T::W_ROW;
        int e[4];
        if constexpr (T::BYTE) {
          const uint32_t p0 = *reinterpret_cast<const uint16_t*>(r0 + wcol + 2 * gid);
          const uint32_t p1 = *reinterpret_cast<const uint16_t*>(r1 + wcol + 2 * gid);
          e[0] = p0 & 0xFF, e[1] = p0 >> 8, e[2] = p1 & 0xFF, e[3] = p1 >> 8;
        } else {
          const uint32_t p0 = r0[wcol / 2 + gid], p1 = r1[wcol / 2 + gid];
          e[0] = p0 & 0xF, e[1] = p0 >> 4, e[2] = p1 & 0xF, e[3] = p1 >> 4;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ah[t][c] = __float_as_uint(whi[e[c] * WSTRIDE]);
          al[t][c] = __float_as_uint(wlo[e[c] * WSTRIDE]);
        }
        const uint64_t d_hi = operand_desc(b_base + t * T::B_MAT);
        const uint64_t d_lo = operand_desc(b_base + (BK / 8 + t) * T::B_MAT);
        wgmma_fence();
        Wgmma<T::TM>::mma(acc, al[t], d_hi);
        Wgmma<T::TM>::mma(acc, ah[t], d_lo);
        Wgmma<T::TM>::mma(acc, ah[t], d_hi);
        wgmma_commit();
      }
      wgmma_wait<0>();
    }
    fence_operands(acc);

    // D fragment of token group j: d[4j], d[4j + 1] at MMA row gid, tokens
    // 8j + 2 tig, 8j + 2 tig + 1; d[4j + 2], d[4j + 3] at row gid + 8
    float* dst = splits == 1 ? a.y : a.ws + (size_t)split * a.M * a.N;
    const int col = n0 + wcol + 2 * gid;
#pragma unroll
    for (int j = 0; j < T::NJ; ++j) {
      const int row = m0 + 8 * j + 2 * tig;
      store2(dst, a, row, col, acc[4 * j], acc[4 * j + 2]);
      store2(dst, a, row + 1, col, acc[4 * j + 1], acc[4 * j + 3]);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring and the per-row tables are free for the next tile
  }

  if (splits == 1) return;
  // split-K: the last block of the strip sums the partials in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.tickets + blockIdx.x, 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int width = min(T::BN, a.N - n0);
  const size_t plane = (size_t)a.M * a.N;
  // loads in groups of four ahead of their adds: the same order of sums
  if ((a.N & 3) == 0) {
    const int w4 = width / 4;
    for (int e = tid; e < a.M * w4; e += T::THREADS) {
      const float4* src4 =
          reinterpret_cast<const float4*>(a.ws + (size_t)(e / w4) * a.N + n0) + e % w4;
      float4 v = __ldcg(src4);
      for (int p0 = 1; p0 < splits; p0 += 4) {
        float4 q[4];
#pragma unroll
        for (int d = 0; d < 4; ++d)
          if (p0 + d < splits) q[d] = __ldcg(src4 + (p0 + d) * (plane / 4));
#pragma unroll
        for (int d = 0; d < 4; ++d)
          if (p0 + d < splits) {
            v.x += q[d].x;
            v.y += q[d].y;
            v.z += q[d].z;
            v.w += q[d].w;
          }
      }
      *reinterpret_cast<float4*>(a.y + (size_t)(e / w4) * a.N + n0 + 4 * (e % w4)) = v;
    }
  } else {
    for (int e = tid; e < a.M * width; e += T::THREADS) {
      const size_t o = (size_t)(e / width) * a.N + n0 + e % width;
      float v = __ldcg(a.ws + o);
      for (int p = 1; p < splits; ++p) v += __ldcg(a.ws + p * plane + o);
      a.y[o] = v;
    }
  }
  if (tid == 0) a.tickets[blockIdx.x] = 0;
}

// Launches kernel K (instantiated on Tile T) after raising its dynamic
// shared-memory limit; returns cudaGetLastError().
template <class T, typename Kernel, typename... KArgs>
int launch(Kernel kernel, const Args& a, cudaStream_t stream, KArgs... kargs) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = a.K > 0 ? (a.K + a.kc - 1) / a.kc : 1;
  const dim3 grid((a.N + T::BN - 1) / T::BN, splits);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(kargs..., a);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
using Int = std::integral_constant<int, V>;

// Calls f(Int<TM>, Int<BN>) for the tile configurations the kernels
// instantiate (the Python wrapper's TILES lists the same).
template <class F>
int with_tile(int tm, int bn, F&& f) {
  if (bn == 256) {
    if (tm == 8) return f(Int<8>{}, Int<256>{});
    if (tm == 72) return f(Int<72>{}, Int<256>{});
    if (tm == 80) return f(Int<80>{}, Int<256>{});
  } else if (bn == 128) {
    if (tm == 8) return f(Int<8>{}, Int<128>{});
    if (tm == 72) return f(Int<72>{}, Int<128>{});
    if (tm == 80) return f(Int<80>{}, Int<128>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace lut_tile
