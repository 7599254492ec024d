// Block-structured pruning kernels (tile L2 norms and tile masking), CUDA C++
// for Hopper (sm_90a), plain C interface loaded with ctypes.
//
// Replace the Pallas TPU kernels of repro/kernels/block_prune.py:
//   block_norms       (_norms_kernel): w (M, N) f32/bf16 -> (M/bm, N/bn) f32,
//                     the L2 norm of every (bm, bn) tile;
//   apply_block_mask  (_mask_kernel):  out[c] = w[c or shared] * mask[c, tile],
//                     for C clients at once, out in w's type.
// The TPU kernels walk a sequential grid, one (bm, bn) tile per step, with the
// tile in VMEM. Here both are plain streaming kernels; (bm, bn) are run-time.
//
// What bounds them: memory. block_norms reads every element once and writes
// 4 bytes per tile (2 bytes an element in bf16); apply_block_mask reads w
// once and writes C outputs (shared weights), or reads and writes C matrices
// (stacked gradients). Both load 16 bytes a thread along the contiguous N
// axis where rows and tiles allow it (a 32-wide bf16 tile row is 64 bytes:
// four lanes), with a scalar variant for the rest.
//
// block_norms gives each tile to one warp (the 819,200 tiles of 32 x 32 on
// the datacenter step are too small for a CTA each: a CTA runs 8 tiles), sums
// the squares in registers, reduces with warp shuffles and writes
// __fsqrt_rn of the sum. The sum is taken in double: the square of a float
// or a bfloat16 value is exact in double, so the result rounded once to float
// depends on the summation order only at ~1e-16 relative, and the plain
// version (kernels/ref.py, the same float64 accumulation in another order)
// agrees bit for bit in practice.
//
// apply_block_mask multiplies by the mask entry as a value of w's type
// (0 or 1), not a select, so -x * 0 is -0 as in the reference's
// w * mask.astype(w.dtype). A client stride of 0 means one shared w: each
// thread then loads its 16 bytes once and writes them to all C outputs.
// Build without --use_fast_math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// V elements of storage type S moved as one unit: 16 bytes, or one element.
template <typename S, int V>
struct Pack {
  S e[V];
};

template <typename S, int V>
__device__ __forceinline__ Pack<S, V> load_pack(const S* p) {
  Pack<S, V> out;
  if constexpr (V == 1) {
    out.e[0] = *p;
  } else {
    static_assert(sizeof(S) * V == 16, "vector packs are 16 bytes");
    union { uint4 u; Pack<S, V> pk; } in;
    in.u = *reinterpret_cast<const uint4*>(p);
    out = in.pk;
  }
  return out;
}

template <typename S, int V>
__device__ __forceinline__ void store_pack(S* p, const Pack<S, V>& v) {
  if constexpr (V == 1) {
    *p = v.e[0];
  } else {
    union { uint4 u; Pack<S, V> pk; } o;
    o.pk = v;
    *reinterpret_cast<uint4*>(p) = o.u;
  }
}

// One warp per tile; warps stride over the (M/bm) x (N/bn) tiles row-major.
template <typename T, int V>
__global__ void block_norms_kernel(const typename T::Storage* __restrict__ w,
                                   float* __restrict__ out, int N, int bm,
                                   int bn, int tiles_c, long long n_tiles) {
  using S = typename T::Storage;
  const int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const int per_row = bn / V;                  // packs per tile row
  const int per_tile = bm * per_row;
  for (long long t = first; t < n_tiles; t += n_warps) {
    const long long ti = t / tiles_c;
    const long long tj = t - ti * tiles_c;
    const S* base = w + ti * bm * (long long)N + tj * bn;
    double acc = 0.0;
    for (int v = lane; v < per_tile; v += 32) {
      const int r = v / per_row;
      const int c = v - r * per_row;
      const Pack<S, V> p = load_pack<S, V>(base + (long long)r * N + c * V);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const double x = (double)T::load(p.e[j]);
        acc = fma(x, x, acc);                  // x * x is exact in double
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[t] = __fsqrt_rn(__double2float_rn(acc));
  }
}

// Threads stride over the packs of one (M, N) matrix; each pack lies inside
// one tile (bn % V == 0) and is written to all C outputs.
template <typename T, int V>
__global__ void apply_block_mask_kernel(
    const typename T::Storage* __restrict__ w,
    const unsigned char* __restrict__ mask, typename T::Storage* __restrict__ out,
    int C, long long w_client_stride, int M, int N, int bm, int bn,
    int tiles_c) {
  using S = typename T::Storage;
  const unsigned per_row = (unsigned)(N / V);
  const unsigned per_tile_col = (unsigned)(bn / V);
  const unsigned long long n_packs = (unsigned long long)M * per_row;
  const long long mn = (long long)M * N;
  const long long tiles = (long long)(M / bm) * tiles_c;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_packs; i += (unsigned long long)gridDim.x * blockDim.x) {
    const unsigned v = (unsigned)i;            // n_packs < 2^32 (checked)
    const unsigned r = v / per_row;
    const unsigned cp = v - r * per_row;
    const long long tile = (long long)(r / (unsigned)bm) * tiles_c + cp / per_tile_col;
    const long long off = (long long)r * N + (long long)cp * V;
    if (w_client_stride == 0) {
      const Pack<S, V> x = load_pack<S, V>(w + off);
      for (int c = 0; c < C; ++c) {
        const float m = mask[c * tiles + tile] ? 1.0f : 0.0f;
        Pack<S, V> y;
#pragma unroll
        for (int j = 0; j < V; ++j) y.e[j] = T::store(__fmul_rn(T::load(x.e[j]), m));
        store_pack<S, V>(out + c * mn + off, y);
      }
    } else {
      for (int c = 0; c < C; ++c) {
        const Pack<S, V> x = load_pack<S, V>(w + c * w_client_stride + off);
        const float m = mask[c * tiles + tile] ? 1.0f : 0.0f;
        Pack<S, V> y;
#pragma unroll
        for (int j = 0; j < V; ++j) y.e[j] = T::store(__fmul_rn(T::load(x.e[j]), m));
        store_pack<S, V>(out + c * mn + off, y);
      }
    }
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;    // grid-stride beyond this

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int norms(const void* w, void* out, int M, int N, int bm, int bn,
          cudaStream_t stream) {
  using S = typename T::Storage;
  constexpr int V = 16 / sizeof(S);
  const int tiles_c = N / bn;
  const long long n_tiles = (long long)(M / bm) * tiles_c;
  long long blocks = (n_tiles + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const S* wp = static_cast<const S*>(w);
  float* op = static_cast<float*>(out);
  if (bn % V == 0 && N % V == 0 && aligned16(w))
    block_norms_kernel<T, V><<<(unsigned)blocks, kThreads, 0, stream>>>(
        wp, op, N, bm, bn, tiles_c, n_tiles);
  else
    block_norms_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        wp, op, N, bm, bn, tiles_c, n_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int mask_apply(const void* w, const void* mask, void* out, int C,
               long long w_client_stride, int M, int N, int bm, int bn,
               cudaStream_t stream) {
  using S = typename T::Storage;
  constexpr int V = 16 / sizeof(S);
  const int tiles_c = N / bn;
  const S* wp = static_cast<const S*>(w);
  const unsigned char* mp = static_cast<const unsigned char*>(mask);
  S* op = static_cast<S*>(out);
  const bool vec = bn % V == 0 && N % V == 0 && aligned16(w) && aligned16(out);
  const long long packs = (long long)M * (vec ? N / V : N);
  if (packs >= (1LL << 32)) return (int)cudaErrorInvalidValue;
  long long blocks = (packs + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (vec)
    apply_block_mask_kernel<T, V><<<(unsigned)blocks, kThreads, 0, stream>>>(
        wp, mp, op, C, w_client_stride, M, N, bm, bn, tiles_c);
  else
    apply_block_mask_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        wp, mp, op, C, w_client_stride, M, N, bm, bn, tiles_c);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its launch
// (0 on success). The caller checks M % bm == 0, N % bn == 0, C >= 1 and that
// mask is (C, M/bm, N/bn) bytes of 0 or 1.
extern "C" int block_norms_launch(const void* w, void* out, int M, int N,
                                  int bm, int bn, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return norms<F32>(w, out, M, N, bm, bn, s);
  if (dtype == 1) return norms<BF16>(w, out, M, N, bm, bn, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int apply_block_mask_launch(const void* w, const void* mask,
                                       void* out, int C,
                                       long long w_client_stride, int M,
                                       int N, int bm, int bn, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mask_apply<F32>(w, mask, out, C, w_client_stride, M, N, bm, bn, s);
  if (dtype == 1)
    return mask_apply<BF16>(w, mask, out, C, w_client_stride, M, N, bm, bn, s);
  return (int)cudaErrorInvalidValue;
}
