// Activation clustering (the paper's Clustering Unit) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bucketize.py::bucketize_kernel_call
// (body _kernel):
//
//   idx[e] = sum_i [x[e] >= b_i]     over n float32 values, int32 out,
//
// the rank searchsorted(b, x, side="right") computes, for sorted boundaries
// b (1 <= n_bounds <= 255, up to A8 codebooks). A NaN passes no boundary (0);
// a value equal to a boundary counts it, a duplicate boundary counts twice.
//
// What bounds it on the H100: bytes -- 4 in and 4 out per value; the
// compares stay under the ridge once each value costs a few instructions.
// So the design is about bytes in flight and instructions per value:
//
// * 16-byte access. Each thread issues U float4 loads (U = 1, 2 or 4, from
//   the size), all before any compare, and writes int4 stores; neighbouring
//   threads take neighbouring vectors, so a warp reads and writes whole
//   128-byte lines. A scalar head runs up to x's first 128-byte line and a
//   scalar tail past the last whole vector; their values are loaded with the
//   first vectors, and the first round's loads are in flight before the
//   boundaries are read. The vector body needs x and idx at the same offset
//   modulo 16 bytes, and its stores fill whole lines where the offsets agree
//   modulo 128 (the wrapper allocates idx so); otherwise every value takes
//   the scalar path.
// * 128-thread blocks: at 72 token rows (36,864 vectors) the blocks spread
//   over the 132 SMs more evenly than 256-thread blocks do.
// * A grid from numel: enough blocks for every value's vectors, capped at
//   the blocks that fit on the card at once (the occupancy calculator), with
//   a grid-stride loop past that so each block sets its boundaries up once.
// * Two bodies by boundary count. Up to 15 (A4 and below): the boundaries
//   sit in registers, padded to 15 with +inf, read once per thread (one
//   address across the warp), and an unrolled compare-sum counts them.
//   16 to 255: the boundaries, padded to 255 with +inf, are laid out in
//   shared memory as an implicit search tree in breadth-first (Eytzinger)
//   order, and 8 branch-free steps `i = 2 i + [x >= t[i]]` descend it; the
//   leaf reached, i - 256, is the rank. A level's nodes are contiguous, so
//   the first six levels read distinct banks (a sorted array read at
//   midpoints puts every level's addresses in one bank).
// * The clamp. +inf padding alone lets x = +inf count the padding; both
//   bodies return min(rank, n_bounds). A NaN fails every compare: 0.
//
// TMA and wgmma have nothing to do in a pass of 8 bytes per value with no
// tile reuse and no products.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int REG_BOUNDS = 15;  // the compare-sum body: A4 and below
constexpr int TREE = 255;       // nodes of the search tree: A8

struct CompareSum {
  float b[REG_BOUNDS];
  int nb;
  __device__ void init(const float* __restrict__ bounds, int n_bounds, float*) {
    nb = n_bounds;
#pragma unroll
    for (int i = 0; i < REG_BOUNDS; ++i) b[i] = i < n_bounds ? __ldg(bounds + i) : CUDART_INF_F;
  }
  __device__ __forceinline__ int rank(float v) const {
    int c = 0;
#pragma unroll
    for (int i = 0; i < REG_BOUNDS; ++i) c += v >= b[i] ? 1 : 0;
    return min(c, nb);
  }
};

struct TreeSearch {
  const float* t;
  int nb;
  // node i (1-based, level l = floor(log2 i)) holds sorted position
  // (2 (i - 2^l) + 1) 2^(7 - l) - 1: the in-order rank of a complete tree
  __device__ void init(const float* __restrict__ bounds, int n_bounds, float* s) {
    for (int node = threadIdx.x + 1; node <= TREE; node += THREADS) {
      const int level = 31 - __clz(node);
      const int pos = ((2 * (node - (1 << level)) + 1) << (7 - level)) - 1;
      s[node] = pos < n_bounds ? bounds[pos] : CUDART_INF_F;
    }
    __syncthreads();
    t = s;
    nb = n_bounds;
  }
  __device__ __forceinline__ int rank(float v) const {
    int i = 1;
#pragma unroll
    for (int l = 0; l < 8; ++l) i = 2 * i + (v >= t[i] ? 1 : 0);
    return min(i - 256, nb);
  }
};

template <class Body, int U>
__global__ void __launch_bounds__(THREADS)
bucketize_kernel(const float* __restrict__ x, const float* __restrict__ bounds, int n_bounds,
                 int* __restrict__ idx, long long n) {
  __shared__ float s_tree[TREE + 1];
  const long long gid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const bool vec = ((xa ^ reinterpret_cast<uintptr_t>(idx)) & 15) == 0;
  // a scalar head up to x's first 128-byte line, whole vectors, a scalar tail
  const long long head = min(n, (long long)(((128 - (xa & 127)) & 127) >> 2));
  const long long n4 = (n - head) >> 2;
  const long long tail = head + 4 * n4;
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x + head);
  int4* __restrict__ i4 = reinterpret_cast<int4*>(idx + head);
  const long long step = (long long)gridDim.x * THREADS * U;
  long long base = (long long)blockIdx.x * THREADS * U + threadIdx.x;

  // every load of the first round in flight before the boundaries are read
  // (and, for the tree, before its barrier): this thread's vectors, and one
  // value each of the head (up to 31: threads 0-30) and the tail (up to 3)
  float4 v[U];
  float hv = 0.f, tv = 0.f;
  if (vec) {
#pragma unroll
    for (int j = 0; j < U; ++j)
      if (base + j * THREADS < n4) v[j] = __ldg(x4 + base + j * THREADS);
    if (gid < head) hv = __ldg(x + gid);
    if (tail + gid < n) tv = __ldg(x + tail + gid);
  }
  Body body;
  body.init(bounds, n_bounds, s_tree);
  if (!vec) {  // x and idx at other offsets modulo 16 bytes: every value scalar
    for (long long e = gid; e < n; e += (long long)gridDim.x * THREADS)
      idx[e] = body.rank(__ldg(x + e));
    return;
  }
  if (gid < head) idx[gid] = body.rank(hv);
  if (tail + gid < n) idx[tail + gid] = body.rank(tv);
  while (base < n4) {
#pragma unroll
    for (int j = 0; j < U; ++j)
      if (base + j * THREADS < n4)
        i4[base + j * THREADS] = make_int4(body.rank(v[j].x), body.rank(v[j].y),
                                           body.rank(v[j].z), body.rank(v[j].w));
    base += step;
#pragma unroll
    for (int j = 0; j < U; ++j)
      if (base + j * THREADS < n4) v[j] = __ldg(x4 + base + j * THREADS);
  }
}

// blocks of one instantiation that fit on the card at once (cached)
template <class Body, int U>
int wave_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bucketize_kernel<Body, U>, THREADS, 0);
    blocks = (sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

template <class Body, int U>
void launch(const float* x, const float* bounds, int n_bounds, int* idx, long long n,
            cudaStream_t stream) {
  const long long per_block = (long long)THREADS * U * 4;
  const long long want = (n + per_block - 1) / per_block;
  const long long cap = wave_blocks<Body, U>();
  const int grid = static_cast<int>(want < cap ? want : cap);
  bucketize_kernel<Body, U><<<grid, THREADS, 0, stream>>>(x, bounds, n_bounds, idx, n);
}

template <class Body>
void launch_body(const float* x, const float* bounds, int n_bounds, int* idx, long long n,
                 cudaStream_t stream) {
  // vectors per thread: 1 until the values fill the card's resident threads
  // twice over (the grid is all latency then), 4 from four times
  const long long resident = (long long)wave_blocks<Body, 1>() * THREADS;
  const long long n4 = n / 4;
  if (n4 >= 4 * resident)
    launch<Body, 4>(x, bounds, n_bounds, idx, n, stream);
  else if (n4 >= 2 * resident)
    launch<Body, 2>(x, bounds, n_bounds, idx, n, stream);
  else
    launch<Body, 1>(x, bounds, n_bounds, idx, n, stream);
}

}  // namespace

// x: n float32 values; bounds: (n_bounds,) float32 sorted, 1 <= n_bounds <= 255;
// idx: n int32 (vectorised where idx and x share their offset modulo 16 bytes).
// Returns cudaGetLastError().
extern "C" int bucketize(const void* x, const void* bounds, int n_bounds, void* idx, long long n,
                         void* stream) {
  if (n > 0) {
    const auto* xf = static_cast<const float*>(x);
    const auto* bf = static_cast<const float*>(bounds);
    auto* out = static_cast<int*>(idx);
    auto s = static_cast<cudaStream_t>(stream);
    if (n_bounds <= REG_BOUNDS)
      launch_body<CompareSum>(xf, bf, n_bounds, out, n, s);
    else
      launch_body<TreeSearch>(xf, bf, n_bounds, out, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}
