// Block-sparse matrix product out = x @ w, skipping the (bk, bn) tiles of w
// whose mask entry is 0. CUDA C++ for Hopper (sm_90a), plain C interface
// loaded with ctypes.
//
// Replaces the Pallas TPU kernel block_sparse_matmul of
// repro/kernels/block_sparse_matmul.py:45 (body _bsmm_kernel): x (M, K) and
// w (K, N), both float32 or both bfloat16, mask (K/bk, N/bn); the products
// are accumulated in float32 and cast to x's type once, at the end.
//
// The TPU kernel walks a sequential (M/bm, N/bn, K/bk) grid with K innermost
// and keeps the f32 sum in VMEM scratch across the K steps. Here one thread
// block owns one 128 x 128 output tile for the whole product, walks K in
// chunks of 16 itself, and keeps its sum in registers (an 8 x 8 micro-tile
// per thread, 256 threads). For each chunk the block reads the mask entries
// that the chunk x tile rectangle covers, the same in every thread, and:
//   - skips the chunk (no load of x or w, no arithmetic) when all are 0;
//   - stages x and w in shared memory as float32 when all are live;
//   - stages them with every dead element of w set to 0 when the rectangle
//     straddles live and dead tiles (blocks smaller than the output tile, or
//     not aligned with it); for finite inputs this gives the same sum as
//     skipping: each such product is +-0.
// With the default 128 x 128 blocks every chunk lies in one mask tile, so a
// chunk is either skipped or fully live.
//
// Arithmetic: plain float32 fused multiply-add on the CUDA cores for both
// types (bfloat16 is widened exactly on the way into shared memory), never
// TF32: the reference's product is full float32. The epilogue rounds once
// (__float2bfloat16_rn for bfloat16) and stores. Rows, columns and depths
// that do not fill a tile are masked at their ragged edges: out-of-range
// elements are staged as 0 and never stored, so every shape the reference
// takes is taken (its blocks clamp to small dimensions).
//
// What bounds it: for a full H100 at these shapes (x 1024 rows, K and N in
// the thousands) the live products, 2 M bk bn flops per live tile, over the
// tensor cores' bf16 rate; this kernel does not use the tensor cores and
// runs far from that bound. wgmma, TMA and a pipelined shared-memory ring are
// the way to it.
// Build without --use_fast_math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 128;
constexpr int kTileN = 128;
constexpr int kChunk = 16;            // K per shared-memory stage
constexpr int kThreads = 256;         // 16 x 16 threads, 8 x 8 outputs each
constexpr int kMicro = 8;
constexpr int kPad = 4;               // keeps float4 rows 16-byte aligned

struct F32 {
  using Storage = float;
  static __device__ __forceinline__ float load(Storage x) { return x; }
  static __device__ __forceinline__ Storage store(float x) { return x; }
};

struct BF16 {
  using Storage = unsigned short;
  static __device__ __forceinline__ float load(Storage x) {
    return __bfloat162float(__ushort_as_bfloat16(x));
  }
  static __device__ __forceinline__ Storage store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

// 0: every covered mask entry is 0; 1: all are live; 2: some of each.
__device__ __forceinline__ int chunk_state(const unsigned char* __restrict__ mask,
                                           int tiles_c, int k0, int k_end,
                                           int n0, int n_end, int bk, int bn) {
  const int r0 = k0 / bk, r1 = (k_end - 1) / bk;
  const int c0 = n0 / bn, c1 = (n_end - 1) / bn;
  int live = 0, total = 0;
  for (int r = r0; r <= r1; ++r)
    for (int c = c0; c <= c1; ++c) {
      live += mask[(long long)r * tiles_c + c] != 0;
      ++total;
    }
  return live == 0 ? 0 : (live == total ? 1 : 2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_sparse_matmul_kernel(const typename T::Storage* __restrict__ x,
                           const typename T::Storage* __restrict__ w,
                           const unsigned char* __restrict__ mask,
                           typename T::Storage* __restrict__ out, int M, int N,
                           int K, int bk, int bn) {
  // xs holds the x chunk transposed (k-major), ws the w chunk as it lies
  __shared__ __align__(16) float xs[kChunk][kTileM + kPad];
  __shared__ __align__(16) float ws[kChunk][kTileN + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  const int n_end = min(n0 + kTileN, N);
  const int tiles_c = N / bn;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int k_end = min(k0 + kChunk, K);
    // the same value in every thread of the block: no divergence, and the
    // __syncthreads below are reached by all or by none
    const int state = chunk_state(mask, tiles_c, k0, k_end, n0, n_end, bk, bn);
    if (state == 0) continue;

    // x chunk: kTileM rows x kChunk depths, consecutive threads along k
#pragma unroll
    for (int i = 0; i < kTileM * kChunk / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kChunk, kk = idx % kChunk;
      const int gm = m0 + r, gk = k0 + kk;
      float v = 0.0f;
      if (gm < M && gk < k_end) v = T::load(x[(long long)gm * K + gk]);
      xs[kk][r] = v;
    }
    // w chunk: kChunk depths x kTileN columns, consecutive threads along n
#pragma unroll
    for (int i = 0; i < kChunk * kTileN / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int kk = idx / kTileN, c = idx % kTileN;
      const int gk = k0 + kk, gn = n0 + c;
      float v = 0.0f;
      if (gk < k_end && gn < n_end &&
          (state == 1 || mask[(long long)(gk / bk) * tiles_c + gn / bn] != 0))
        v = T::load(w[(long long)gk * N + gn]);
      ws[kk][c] = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[kMicro], b[kMicro];
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * kMicro]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[kk][ty * kMicro + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * kMicro]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][tx * kMicro + 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: one rounding to the output type, ragged edges masked
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int gm = m0 + ty * kMicro + i;
    if (gm >= M) break;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int gn = n0 + tx * kMicro + j;
      if (gn < N) out[(long long)gm * N + gn] = T::store(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* mask, void* out, int M,
           int N, int K, int bk, int bn, cudaStream_t stream) {
  using S = typename T::Storage;
  const dim3 grid((unsigned)((N + kTileN - 1) / kTileN),
                  (unsigned)((M + kTileM - 1) / kTileM));
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  block_sparse_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const S*>(x), static_cast<const S*>(w),
      static_cast<const unsigned char*>(mask), static_cast<S*>(out), M, N, K,
      bk, bn);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out all of it). mask is
// (K/bk, N/bn) bytes, nonzero = live. Returns the cudaError_t of the launch
// (0 on success). The caller checks M, N, K >= 1, K % bk == 0, N % bn == 0
// and that every pointer is a contiguous row-major array.
extern "C" int block_sparse_matmul_launch(const void* x, const void* w,
                                          const void* mask, void* out, int M,
                                          int N, int K, int bk, int bn,
                                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || bk < 1 || bn < 1 || K % bk || N % bn)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<F32>(x, w, mask, out, M, N, K, bk, bn, s);
  if (dtype == 1) return launch<BF16>(x, w, mask, out, M, N, K, bk, bn, s);
  return (int)cudaErrorInvalidValue;
}
