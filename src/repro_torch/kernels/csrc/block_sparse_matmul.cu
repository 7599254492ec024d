// Block-sparse matrix product out = x @ w, skipping the (bk, bn) tiles of w
// whose mask entry is 0. CUDA C++ for Hopper (sm_90a), plain C interface
// loaded with ctypes.
//
// Replaces the Pallas TPU kernel block_sparse_matmul of
// src/repro/kernels/block_sparse_matmul.py:45 (body _bsmm_kernel, :25):
// x (M, K) and w (K, N), both float32 or both bfloat16, mask (K/bk, N/bn);
// the products are accumulated in float32 and cast to x's type once, at
// the end. The TPU kernel walks a sequential (M/bm, N/bn, K/bk) grid with
// K innermost, keeps the sum in VMEM scratch and skips a dead tile's step
// with pl.when: the pruning ratio rho becomes skipped matrix-unit work.
//
// What bounds it on this card: operations. At x of 1024 rows and K, N in
// the thousands the live tiles' 2 M bk bn flops over the bf16 tensor-core
// rate (989 TFLOP/s) take longer than reading x and the live tiles of w
// once and writing the output over 3.35 TB/s. Only wgmma reaches that rate.
//
// Two paths, chosen by one shape rule before launch (pick_path below, the
// same rule as kernel_path in kernels/block_sparse_matmul.py); a launch
// that fails returns its error, it never gives way to the other path.
//
// wgmma (bfloat16, bk a multiple of 64, bn a multiple of 128, x and w on
// 16 bytes, at most 4096 mask rows):
//   - persistent: one block per SM walks output tiles of 128 x 128 (two
//     consumer warpgroups of 64 rows) or, where a shape gives fewer such
//     tiles than the card has SMs (wk and wv: 64 tiles for 132 SMs),
//     64 x 128 (one consumer warpgroup), so the card is filled; the blocks
//     running together walk down M over the same column of w, which keeps
//     that column in L2;
//   - a tile's N-extent lies inside one mask column, so every K step of 64
//     is wholly live or wholly dead for it. The producer warp reads the
//     tile's mask column with warp ballots, compacts the live k tiles into
//     shared memory and hands the consumers the count of live steps;
//   - one thread of the producer warp issues TMA copies (128-byte swizzle,
//     64 bf16 a box row) of x (K-major, the A operand) and of w (N-major:
//     wgmma reads B through its transpose bit, so w needs no transposed
//     copy) for the live k tiles only, into a ring of 5 shared-memory
//     stages guarded by full/empty mbarriers. A dead tile costs neither a
//     copy nor a bubble, and the ring runs on across tiles, so a tile's
//     loads overlap the previous tile's epilogue;
//   - the consumers run wgmma.mma_async m64n128k16 bf16 -> f32 on each
//     stage and add the tensor cores' partial sum to a float32 sum in
//     registers every 2 K steps (kPromote below), which keeps the result
//     within one bf16 ulp of the plain version as often as the SIMT path;
//   - rows past M (M < 64 as when bm clamps, or a ragged last tile) come in
//     as TMA zero fill and are never stored. A tile with no live step
//     stores zeros: a fully masked product is exact zeros. The epilogue
//     rounds once (__float2bfloat16_rn) and stores from registers.
//   It reaches about half of the bf16 rate on live work, and
//   tools/bsmm_variants.py (variants of this file timed on the card) shows
//   what does not hold it there: copying half the bytes, reading w
//   K-major, or never handing over changes the time by a few per cent;
//   3 stages instead of 5 cost a third more. The likely limit is the
//   m64n128 wgmma itself, whose A and B are both read from shared memory
//   for every 64 x 128 x 16 product; a wider one (n256) would span two
//   mask columns and need 128 more registers a thread for the hand-over.
//
// simt (float32, and bf16 shapes the rule turns away): one block of 256
// threads owns a 128 x 128 output tile, walks K in chunks of 16 staged in
// shared memory as float32 and sums with float32 FMA on the CUDA cores,
// 8 x 8 outputs a thread. float32 stays here because the reference's
// product is full float32 and wgmma offers only TF32 for it. Chunks whose
// mask entries are all 0 are skipped; a chunk that straddles live and dead
// tiles (blocks smaller than or misaligned with the tile) stages the dead
// elements of w as 0, which for finite inputs gives the same sum; ragged
// edges are staged as 0 and not stored, so every shape the reference
// takes is taken.
//
// Build without --use_fast_math.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- simt --

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
int launch_simt(const void* x, const void* w, const void* mask, void* out,
                int M, int N, int K, int bk, int bn, cudaStream_t stream) {
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

// --------------------------------------------------------------- wgmma --

constexpr int kKStep = 64;            // K per stage: one 128-byte box row
constexpr int kWTileN = 128;          // output tile N: one m64n128 wgmma
constexpr int kMaxMaskRows = 4096;    // live-list entries a block can hold
// K steps summed by the tensor cores before their partial sum is added to
// the float32 sum. The tensor
// cores' own float32 sum is less exact than round-to-nearest adds: left
// whole over K = 4096 it ends more than one bf16 ulp from the plain
// version on ~1.2e-4 of the elements (as bf16 cuBLAS does), handed over
// every 2 steps on ~2e-5.
constexpr int kPromote = 2;
constexpr int kABytesPerWG = 64 * kKStep * 2;         // 8 KB: 64 rows of x
constexpr int kBBoxBytes = kKStep * 64 * 2;           // 8 KB: 64 x 64 of w
constexpr int kBBytes = 2 * kBBoxBytes;               // 16 KB: 64 x 128

template <int NWG>
struct Cfg {
  static constexpr int kBM = 64 * NWG;
  static constexpr int kStages = NWG == 2 ? 5 : 4;
  static constexpr int kABytes = NWG * kABytesPerWG;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kThreads = 128 * NWG + 32;     // + one producer warp
  // the ring, 1 KB of slack to align it to the 128-byte swizzle's 1 KB
  // atom, then the producer's live list (uint16 per mask row)
  static constexpr int kSmemFixed = kStages * kStageBytes + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// returns once the barrier's current phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (64 x 128 f32, 64 registers a thread) = A (64 x 16, K-major) *
// B (16 x 128, N-major: transpose bit set) + (accumulate ? d : 0), A and
// B bf16 in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// One K step (64) of a warpgroup's 64 x 128 tile once its stage has
// landed: part = A B + (accumulate ? part : 0), 4 wgmma of k16, committed
// as one group. A: 64 rows of 128 bytes, 8-row groups 1 KB apart, k16 =
// 32 bytes along the swizzled row. B: 16 rows of w (k) x 128 columns, rows
// 128 bytes apart (8-row groups 1 KB), the two 64-column boxes 8 KB apart;
// k16 = 16 rows = 2 KB.
__device__ __forceinline__ void mma_step(float* part, uint32_t full,
                                         uint32_t phase, uint32_t a,
                                         uint32_t b, int accumulate) {
  mbar_wait(full, phase);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKStep / 16; ++kk)
    wgmma_m64n128k16(part, smem_desc(a + kk * 32, 16, 1024),
                     smem_desc(b + kk * 2048, kBBoxBytes, 1024),
                     kk > 0 || accumulate);
  wgmma_commit();
}

// Persistent: grid min(tiles, SMs); block b takes output tiles b, b +
// gridDim.x, ... in order, tile t = (t % tiles_m, t / tiles_m) in (M, N)
// tile units, so the blocks running together share a column of w in L2.
// Block: NWG consumer warpgroups, then one producer warp. x_map: x as
// (K, M) innermost first, box (64, kBM); w_map: w as (N, K), box (64, 64);
// both bf16 with 128-byte swizzle.
template <int NWG>
__global__ void __launch_bounds__(Cfg<NWG>::kThreads, 1)
block_sparse_matmul_wgmma(__grid_constant__ const CUtensorMap x_map,
                          __grid_constant__ const CUtensorMap w_map,
                          const unsigned char* __restrict__ mask,
                          __nv_bfloat16* __restrict__ out, int M, int N,
                          int K, int bk, int bn) {
  using C = Cfg<NWG>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[C::kStages];
  __shared__ __align__(8) uint64_t empty_bar[C::kStages];
  // the live K steps of a tile, producer -> consumers, two tiles in flight
  __shared__ __align__(8) uint64_t steps_full[2];
  __shared__ __align__(8) uint64_t steps_empty[2];
  __shared__ int steps[2];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;       // swizzle atom aligned
  unsigned short* live = reinterpret_cast<unsigned short*>(
      smem_raw + (ring - raw) + C::kStages * C::kStageBytes);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_m = (M + C::kBM - 1) / C::kBM;
  const int tiles = tiles_m * (N / kWTileN);
  const int tiles_c = N / bn, rows = K / bk;
  const int steps_per_row = bk / kKStep;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), NWG);
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(smem_u32(&steps_full[j]), 1);
      mbar_init(smem_u32(&steps_empty[j]), NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // producer warp: per tile, compact the live rows of its mask column
    // (ballots over the column, in order), publish the step count, then
    // one thread keeps TMA copies of the live K steps in flight
    int s = 0, j = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
      const int m0 = (t % tiles_m) * C::kBM;
      const int n0 = (t / tiles_m) * kWTileN;
      const int col = n0 / bn;
      int count = 0;
      for (int base = 0; base < rows; base += 32) {
        const int r = base + lane;
        const bool on = r < rows && mask[(long long)r * tiles_c + col] != 0;
        const unsigned bits = __ballot_sync(0xffffffffu, on);
        if (on) live[count + __popc(bits & ((1u << lane) - 1u))] =
            (unsigned short)r;
        count += __popc(bits);
      }
      __syncwarp();
      if (lane == 0) {
        const int n_steps = count * steps_per_row;
        mbar_wait(smem_u32(&steps_empty[j & 1]), ((j >> 1) & 1) ^ 1u);
        steps[j & 1] = n_steps;
        mbar_arrive(smem_u32(&steps_full[j & 1]));
        for (int i = 0; i < n_steps; ++i) {
          const int k = live[i / steps_per_row] * bk +
                        (i % steps_per_row) * kKStep;
          mbar_wait(smem_u32(&empty_bar[s]), phase ^ 1u);
          const uint32_t bar = smem_u32(&full_bar[s]);
          const uint32_t a = ring + s * C::kStageBytes;
          const uint32_t b = a + C::kABytes;
          mbar_expect_tx(bar, C::kStageBytes);
          tma_load_2d(a, &x_map, k, m0, bar);
          tma_load_2d(b, &w_map, n0, k, bar);
          tma_load_2d(b + kBBoxBytes, &w_map, n0 + 64, k, bar);
          if (++s == C::kStages) { s = 0; phase ^= 1u; }
        }
      }
      __syncwarp();
    }
    return;
  }

  // consumers: warpgroup g computes rows m0 + 64 g .. + 63 of each tile
  const int g = warp / 4;
  const bool leader = threadIdx.x % 128 == 0;
  float d[64], part[64];
  int s = 0, j = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
    const int m0 = (t % tiles_m) * C::kBM;
    const int n0 = (t / tiles_m) * kWTileN;
    mbar_wait(smem_u32(&steps_full[j & 1]), (j >> 1) & 1);
    const int n_steps = steps[j & 1];
    mbar_arrive(smem_u32(&steps_empty[j & 1]));

#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.0f;
    int pending = -1;             // a stage read by an unfinished group
    for (int i = 0; i < n_steps; ++i) {
      mma_step(part, smem_u32(&full_bar[s]), phase,
               ring + s * C::kStageBytes + g * kABytesPerWG,
               ring + s * C::kStageBytes + C::kABytes, i % kPromote != 0);
      if ((i + 1) % kPromote == 0 || i + 1 == n_steps) {
        // the partial sum is complete: hand back its stages and add it to
        // the float32 sum with round-to-nearest adds
        wgmma_wait<0>();
        if (leader) {
          if (pending >= 0) mbar_arrive(smem_u32(&empty_bar[pending]));
          mbar_arrive(smem_u32(&empty_bar[s]));
        }
        pending = -1;
#pragma unroll
        for (int q = 0; q < 64; ++q) d[q] += part[q];
      } else {
        // the previous group is done: hand its stage back (with a
        // hand-over every 2 steps that was done there already); this one
        // stays in flight while the next stage is waited for
        wgmma_wait<1>();
        if (leader && pending >= 0) mbar_arrive(smem_u32(&empty_bar[pending]));
        pending = s;
      }
      if (++s == C::kStages) { s = 0; phase ^= 1u; }
    }
    // (the last step always hands over: every stage is back, d complete)

    // epilogue, while the producer fills the ring for the next tile:
    // accumulator fragment -> bf16, rows past M not stored. Register
    // 4 c + 2 h + e of a thread holds row 16 w + lane / 4 + 8 h, column
    // 8 c + 2 (lane % 4) + e of the warpgroup's 64 x 128 tile. A tile with
    // no live step stores zeros.
    const int wr = (warp % 4) * 16 + lane / 4;
    const int cc = n0 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + g * 64 + wr + 8 * h;
      if (gm < M) {
        __nv_bfloat16* row = out + (long long)gm * N + cc;
#pragma unroll
        for (int c = 0; c < 16; ++c)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * c) =
              __floats2bfloat162_rn(d[4 * c + 2 * h], d[4 * c + 2 * h + 1]);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime: no -lcuda
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 row-major (rows, cols) array as a 2-D tensor map, box (64,
// box_rows)
int encode_2d(CUtensorMap* map, const void* ptr, long long rows,
              long long cols, int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64u, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1u, 1u};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);   // zero fill
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

template <int NWG>
int launch_wgmma(const void* x, const void* w, const void* mask, void* out,
                 int M, int N, int K, int bk, int bn, int sms,
                 cudaStream_t stream) {
  using C = Cfg<NWG>;
  CUtensorMap x_map, w_map;
  int err = encode_2d(&x_map, x, M, K, C::kBM);
  if (err == 0) err = encode_2d(&w_map, w, K, N, kKStep);
  if (err) return err;
  const int smem = C::kSmemFixed + (K / bk) * 2;
  static int smem_set = 0;            // the attribute is per function
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        block_sparse_matmul_wgmma<NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const long long tiles = (long long)((M + C::kBM - 1) / C::kBM) * (N / kWTileN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  block_sparse_matmul_wgmma<NWG><<<grid, C::kThreads, smem, stream>>>(
      x_map, w_map, static_cast<const unsigned char*>(mask),
      static_cast<__nv_bfloat16*>(out), M, N, K, bk, bn);
  return (int)cudaGetLastError();
}

// 1 = wgmma, 0 = simt: the rule of kernel_path in block_sparse_matmul.py
// (K % bk == 0 and N % bn == 0 then make the rows of x and w multiples of
// 16 bytes, TMA's stride unit)
int pick_path(const void* x, const void* w, int K, int bk, int bn,
              int dtype) {
  if (dtype != 1) return 0;                           // f32: full float32
  if (bk % kKStep || bn % kWTileN) return 0;          // K step, tile N
  if (K / bk > kMaxMaskRows) return 0;                // the live list
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return 0;                                         // TMA base address
  return 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out all of it). mask is
// (K/bk, N/bn) bytes, nonzero = live. Writes the path taken to *path
// (1 = wgmma, 0 = simt) and returns the cudaError_t of the launch (0 on
// success). The caller checks M, N, K >= 1, K % bk == 0, N % bn == 0 and
// that every pointer is a contiguous row-major array.
extern "C" int block_sparse_matmul_launch(const void* x, const void* w,
                                          const void* mask, void* out, int M,
                                          int N, int K, int bk, int bn,
                                          int dtype, void* stream,
                                          int* path) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || bk < 1 || bn < 1 || K % bk || N % bn ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  *path = pick_path(x, w, K, bk, bn, dtype);
  if (*path == 1) {
    // 128-row tiles unless they leave SMs idle that 64-row tiles would fill
    const int sms = sm_count();
    if (sms < 1) return (int)cudaErrorInvalidDevice;
    const long long tiles = (long long)((M + 127) / 128) * (N / kWTileN);
    if (tiles < sms)
      return launch_wgmma<1>(x, w, mask, out, M, N, K, bk, bn, sms, s);
    return launch_wgmma<2>(x, w, mask, out, M, N, K, bk, bn, sms, s);
  }
  if (dtype == 0) return launch_simt<F32>(x, w, mask, out, M, N, K, bk, bn, s);
  return launch_simt<BF16>(x, w, mask, out, M, N, K, bk, bn, s);
}
