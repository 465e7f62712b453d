// Symmetric per-tensor int8 quantization of an f32 or bf16 tensor in two
// passes: what int8_conv does to a float input before kernel K5.
//
// No TPU kernel stands behind it: the JAX package's ops/quant.py::
// quantize_per_tensor is plain jnp that XLA fuses into two passes of its own.
// In PyTorch ops the same function is seven elementwise and reduction kernels
// over the tensor (float, abs, amax, clamp, divide, round, clamp, cast), so
// the port writes the two passes by hand:
//   absmax_kernel    amax = max |x| over the tensor (a max is exact in any
//                    order): 16-byte loads, a shuffle and shared-memory
//                    reduction per block, one atomicMax per block on the bits
//                    of the non-negative float (which order as integers) into
//                    a word the caller zeroed;
//   quantize_kernel  s = max(amax, 1e-8) / 127, q = clip(rint(x / s), -127,
//                    127): x read once, 16 values to a 16-byte store of s8.
//                    Both divisions are true divisions (__fdiv_rn), as the
//                    plain version's, and rint rounds ties to even. Block 0
//                    also writes s and, given the weights' per-channel
//                    scales, the conv's dequantizing factors s * s_w[k] (one
//                    rounding each, as the plain version's product), so no
//                    further launch stands between it and the conv.
//
// What bounds them on the H100: bytes. The first pass reads x, the second
// reads it again (from the L2 where it fits) and writes a quarter or a half
// of its size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;  // elements a thread takes at a time: one 16-byte store of s8

__device__ __forceinline__ void load16(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 a = *reinterpret_cast<const float4*>(p + 4 * i);
    v[4 * i] = a.x; v[4 * i + 1] = a.y; v[4 * i + 2] = a.z; v[4 * i + 3] = a.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + 8 * i);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // a word holds two bf16, the first in its low half
      v[8 * i + 2 * e] = __uint_as_float(w[e] << 16);
      v[8 * i + 2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ int quant1(float x, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
}

// *amax_bits = max(*amax_bits, bits of max |x[0 .. n)|); x 16-byte aligned
template <typename T>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, long long n, unsigned* __restrict__ amax_bits) {
  const long long groups = n / kGroup;
  float m = 0.f;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < groups; i += (long long)gridDim.x * kThreads) {
    float v[kGroup];
    load16(x + i * kGroup, v);
#pragma unroll
    for (int e = 0; e < kGroup; ++e) m = fmaxf(m, fabsf(v[e]));
  }
  if (blockIdx.x == 0 && groups * kGroup + threadIdx.x < n) m = fmaxf(m, fabsf(load1(x + groups * kGroup + threadIdx.x)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(amax_bits, __float_as_uint(m));
  }
}

// q[0 .. n) from x and the finished *amax_bits; block 0 writes *s_x and, if
// s_w is given, factors[k] = s_x * s_w[k] for k < K
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, long long n, const unsigned* __restrict__ amax_bits,
                int8_t* __restrict__ q, float* __restrict__ s_x, const float* __restrict__ s_w,
                float* __restrict__ factors, int K) {
  const float s = __fdiv_rn(fmaxf(__uint_as_float(*amax_bits), 1e-8f), 127.0f);
  const long long groups = n / kGroup;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < groups; i += (long long)gridDim.x * kThreads) {
    float v[kGroup];
    load16(x + i * kGroup, v);
    unsigned words[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      unsigned r = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) r |= ((unsigned)quant1(v[4 * g + e], s) & 0xffu) << (8 * e);
      words[g] = r;
    }
    *reinterpret_cast<uint4*>(q + i * kGroup) = make_uint4(words[0], words[1], words[2], words[3]);
  }
  if (blockIdx.x == 0) {
    const long long tail = groups * kGroup + threadIdx.x;
    if (tail < n) q[tail] = (int8_t)quant1(load1(x + tail), s);
    if (threadIdx.x == 0) *s_x = s;
    if (s_w != nullptr)
      for (int k = threadIdx.x; k < K; k += kThreads) factors[k] = __fmul_rn(s, s_w[k]);
  }
}

template <typename T>
int launch(const void* x, long long n, void* amax_bits, void* q, void* s_x, const void* s_w, void* factors, int K,
           int blocks, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  unsigned* ab = static_cast<unsigned*>(amax_bits);
  absmax_kernel<T><<<blocks, kThreads, 0, stream>>>(xp, n, ab);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  quantize_kernel<T><<<blocks, kThreads, 0, stream>>>(xp, n, ab, static_cast<int8_t*>(q), static_cast<float*>(s_x),
                                                       static_cast<const float*>(s_w),
                                                       static_cast<float*>(factors), K);
  return (int)cudaGetLastError();
}

}  // namespace

// x: n values, f32 (dtype 0) or bf16 (dtype 1), 16-byte aligned; amax_bits: one
// 32-bit word that the caller zeroed; q: n s8, 16-byte aligned; s_x: one f32.
// s_w (K,) f32 or null; with it, factors (K,) f32 receives s_x * s_w. Returns
// a cudaError_t code (0 = launched).
extern "C" int gdc_quantize_per_tensor(const void* x, long long n, void* amax_bits, void* q, void* s_x,
                                       const void* s_w, void* factors, int K, int dtype, void* stream) {
  if (n < 1 || amax_bits == nullptr || (s_w != nullptr && (factors == nullptr || K < 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // enough blocks to fill the card a few times over, each thread 16 values a turn
  const long long want = (n / kGroup + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 1 ? 1 : (want > 132 * 16 ? 132 * 16 : want));
  if (dtype == 0) return launch<float>(x, n, amax_bits, q, s_x, s_w, factors, K, blocks, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, n, amax_bits, q, s_x, s_w, factors, K, blocks, st);
  return (int)cudaErrorInvalidValue;
}
