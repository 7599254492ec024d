// Fused stochastic quantize-dequantize for a client batch (paper Eq. 16-17),
// CUDA C++ for Hopper (sm_90a), plain C interface loaded with ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/stochastic_quant.py
// (stochastic_quant_dyn, body _quant_kernel_dyn). One launch covers every
// client of one parameter leaf: g (C, L) and rand (C, L) row-major, one
// [lo, hi, n_levels] row per client in rng (C, 3); out (C, L) in g's type.
//
// What bounds it: memory. Per element it reads g and rand and writes out,
// about ten float operations: 12 bytes in f32, 8 bytes in bf16 (2 + 4 + 2).
// The design therefore only streams: blockIdx.y is the client, blockIdx.x
// strides over the row, and each thread moves 16 bytes of g (and of out)
// per step where the row is 16-byte aligned, with a scalar loop for the
// tail and for unaligned rows. The per-client range and level count are
// computed outside (a min/max pre-pass in the wrapper); fusing it, and
// drawing the uniforms in-kernel, is later work.
//
// Exactness: the plain PyTorch version (kernels/ref.py) runs each op
// separately, so here the only multiply-add, lo + level * scale, is written
// with __fmul_rn/__fadd_rn (nvcc would otherwise contract it into an FMA and
// differ by an ulp), and the divisions use __fdiv_rn. Build without
// --use_fast_math. The sign test is g >= 0 (so -0.0 maps to +mag), and the
// level is clipped to [0, n_levels] after adding the stochastic step.

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

__device__ __forceinline__ float quant_one(float g, float r, float lo,
                                           float scale, float n) {
  float t = __fdiv_rn(__fsub_rn(fabsf(g), lo), scale);
  float t_floor = floorf(t);
  float up = (r < __fsub_rn(t, t_floor)) ? 1.0f : 0.0f;
  float level = fminf(fmaxf(__fadd_rn(t_floor, up), 0.0f), n);
  float mag = __fadd_rn(lo, __fmul_rn(level, scale));
  return (g >= 0.0f) ? mag : -mag;
}

template <typename T>
__global__ void stochastic_quant_kernel(const typename T::Storage* __restrict__ g,
                                        const float* __restrict__ rand,
                                        const float* __restrict__ rng,
                                        typename T::Storage* __restrict__ out,
                                        long long L) {
  using S = typename T::Storage;
  constexpr int V = 16 / sizeof(S);           // elements per 16-byte vector
  const long long c = blockIdx.y;
  const float lo = rng[3 * c];
  const float hi = rng[3 * c + 1];
  const float n = rng[3 * c + 2];
  float scale = __fdiv_rn(__fsub_rn(hi, lo), n);
  scale = (scale > 0.0f) ? scale : 1.0f;

  const S* g_row = g + c * L;
  const float* r_row = rand + c * L;
  S* o_row = out + c * L;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;

  long long n_vec = 0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(g_row) |
                         reinterpret_cast<uintptr_t>(r_row) |
                         reinterpret_cast<uintptr_t>(o_row);
  if ((addr & 15) == 0) {
    n_vec = L / V;
    for (long long v = first; v < n_vec; v += stride) {
      union { uint4 u; S e[V]; } gin, gout;
      gin.u = reinterpret_cast<const uint4*>(g_row)[v];
      float r[V];
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        const float4 f = reinterpret_cast<const float4*>(r_row)[v * (V / 4) + k];
        r[4 * k] = f.x; r[4 * k + 1] = f.y; r[4 * k + 2] = f.z; r[4 * k + 3] = f.w;
      }
#pragma unroll
      for (int j = 0; j < V; ++j)
        gout.e[j] = T::store(quant_one(T::load(gin.e[j]), r[j], lo, scale, n));
      reinterpret_cast<uint4*>(o_row)[v] = gout.u;
    }
  }
  for (long long i = n_vec * V + first; i < L; i += stride)
    o_row[i] = T::store(quant_one(T::load(g_row[i]), r_row[i], lo, scale, n));
}

template <typename T>
int launch(const void* g, const void* rand, const void* rng, void* out,
           long long C, long long L, cudaStream_t stream) {
  using S = typename T::Storage;
  constexpr int threads = 256;
  constexpr int V = 16 / sizeof(S);
  long long blocks = (L / V + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 1024) blocks = 1024;            // grid-stride beyond this
  dim3 grid((unsigned)blocks, (unsigned)C);
  stochastic_quant_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const S*>(g), static_cast<const float*>(rand),
      static_cast<const float*>(rng), static_cast<S*>(out), L);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 on success); the caller checks C in [1, 65535] and L >= 1.
extern "C" int stochastic_quant_launch(const void* g, const void* rand,
                                       const void* rng, void* out,
                                       long long C, long long L, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<F32>(g, rand, rng, out, C, L, s);
  if (dtype == 1) return launch<BF16>(g, rand, rng, out, C, L, s);
  return (int)cudaErrorInvalidValue;
}
