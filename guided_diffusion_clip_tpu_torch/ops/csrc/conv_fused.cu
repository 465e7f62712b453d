// Fused 3x3 stride-1 SAME convolution of a bf16/f32 input: kernel K6.
//
// Replaces guided_diffusion_clip_tpu/ops/pallas_conv.py::fused_conv3x3
// (_kernel). Two modes, one function each way:
//   quantized: the activations are quantized inside the kernel, one scale per
//     (image, band of bh output rows): s = max(amax, 1e-8) / 127 with amax
//     taken over the input rows [i*bh - 1, (i+2)*bh - 1) clipped to the image
//     (the two row blocks the TPU kernel holds for band i, not only the rows
//     the band's taps touch), q = clip(rint(x * (1/s)), -127, 127). An output
//     row is fed by inputs quantized with the scale of the band that PRODUCES
//     it, so an input row next to a band edge carries two scales. Weights come
//     in as s8 with one scale per output channel. s32 sums (exact), then
//       out = acc * (s_x * s_w[k]) + bias[k]
//     with the product in the parentheses first, unfused, as the reference.
//   bf16: x and w rounded to bf16, f32 sums on the FMA pipes, + bias.
// x is NHWC (B, H, W, C), out NHWC (B, H, W, K) in x's type; C % 128 == 0,
// K % 128 == 0, H % bh == 0.
//
// The TPU kernel's layout (flat shifted rows, W + 8 padding, three
// column-shifted copies in scratch) serves its matrix unit's alignment and is
// not carried over: this is K5's implicit GEMM (conv_s8.cu), M = B*H*W output
// pixels by N = K channels, with a quantizing gather in front.
//
// What bounds it on the H100: operations. At 256 px, 256 -> 256, batch 8 it
// does 3.1e11 multiply-adds over ~1 GB of traffic. The quantized mode runs
// them on the integer pipes (__dp4a), the bf16 mode on the f32 FMA pipes;
// neither uses the tensor cores yet (mma.sync / wgmma is later work).
//
// What the design does about it:
//   * a first small kernel reads each band's window once and writes its scale
//     (one block per (image, band), 16-byte loads, a max is exact in any
//     order); x is read twice in all, as on the TPU;
//   * the conv kernel's gather loads 16 channels of one input pixel per
//     thread, keeps them in registers while the current tile is multiplied
//     (the loads stay in flight), and quantizes them with its output pixel's
//     band scale on the way into shared memory: no quantized tensor ever
//     reaches device memory;
//   * a 128 x 128 tile per block of 256 threads, 8 x 8 outputs per thread,
//     two shared-memory buffers, one barrier per reduction step (32 s8 or 16
//     bf16 channels of one tap); each thread's 8 channels are two groups of 4
//     that lie 64 apart, so the 16-byte shared-memory reads of a quarter warp
//     fall in distinct banks;
//   * the epilogue dequantizes in registers and stores 4 channels at a time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // output pixels per block
constexpr int kBN = 128;  // output channels per block
constexpr int kThreads = 256;
constexpr int kPad = 4;   // words of padding per shared-memory row

// 8 consecutive channels as f32
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void unpack8(const uint4 u, float* v) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a word holds two bf16, the first in its low half
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  unpack8(*reinterpret_cast<const uint4*>(p), v);
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// clip(rint(v * inv), -127, 127) of 4 values, packed low byte first
__device__ __forceinline__ int quant4(const float* v, float inv) {
  unsigned r = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float t = fminf(fmaxf(rintf(__fmul_rn(v[e], inv)), -127.f), 127.f);
    r |= ((unsigned)(int)t & 0xffu) << (8 * e);
  }
  return (int)r;
}

// scales[b * nbands + i] = max(amax, 1e-8) / 127 over rows [i*bh - 1, (i+2)*bh - 1)
// of image b, clipped to [0, H). rowlen = W * C (a multiple of 8).
template <typename T>
__global__ void __launch_bounds__(kThreads)
band_scale_kernel(const T* __restrict__ x, float* __restrict__ scales, int H, long long rowlen,
                  int bh, int nbands) {
  const int b = blockIdx.x / nbands;
  const int i = blockIdx.x - b * nbands;
  const int lo = max(i * bh - 1, 0);
  const int hi = min((i + 2) * bh - 1, H);
  const T* p = x + ((long long)b * H + lo) * rowlen;
  const long long n8 = (long long)(hi - lo) * rowlen / 8;
  float m = 0.f;
  for (long long j = threadIdx.x; j < n8; j += kThreads) {
    float v[8];
    load8(p + j * 8, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    scales[blockIdx.x] = __fdiv_rn(fmaxf(m, 1e-8f), 127.0f);
  }
}

// The output pixel a thread gathers for, and where its taps start.
struct Pixel {
  bool ok;
  int b, oy, ox;
};
__device__ __forceinline__ Pixel pixel_of(int m, int M, int H, int W) {
  Pixel p{m < M, 0, 0, 0};
  if (p.ok) {
    p.b = m / (H * W);
    const int rem = m - p.b * (H * W);
    p.oy = rem / W;
    p.ox = rem - p.oy * W;
  }
  return p;
}

// quantized mode: s8 tiles, __dp4a, 32 channels of one tap per step
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_fused_s8_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scales, const float* __restrict__ s_w,
                     const float* __restrict__ bias, T* __restrict__ out, int H, int W, int C, int K,
                     int bh, int nbands, int M) {
  constexpr int kWords = 8;  // 32 bytes of reduction per step
  __shared__ __align__(16) int As[2][kWords][kBM + kPad];
  __shared__ __align__(16) int Bs[2][kWords][kBN + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channels tx*4 .. +4 and 64 + tx*4 .. +4
  const int ty = tid / 16;  // pixels ty*8 .. +8
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int KR = 9 * C;

  // this thread's gather: pixel row ar of the tile, channels ah*16 .. +16 of each step
  const int ar = tid >> 1;
  const int ah = tid & 1;
  const Pixel px = pixel_of(m0 + ar, M, H, W);
  const T* ximg = x + (long long)px.b * H * W * C;
  const float inv = px.ok ? __fdiv_rn(1.0f, scales[px.b * nbands + px.oy / bh]) : 0.f;

  auto load_a = [&](int kt, float* raw) {
    const int r0 = kt * 32 + ah * 16;
    const int tap = r0 / C;
    const int c = r0 - tap * C;
    const int ky = tap / 3;
    const int iy = px.oy - 1 + ky;
    const int ix = px.ox - 1 + (tap - ky * 3);
    if (px.ok && iy >= 0 && iy < H && ix >= 0 && ix < W) {
      const T* p = ximg + ((long long)iy * W + ix) * C + c;
      load8(p, raw);
      load8(p + 8, raw + 8);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) raw[e] = 0.f;
    }
  };
  // B: 128 rows x 32 bytes = 256 16-byte vectors, one per thread
  auto load_b = [&](int kt) -> int4 {
    return *reinterpret_cast<const int4*>(w + (long long)(n0 + (tid >> 1)) * KR + kt * 32 + (tid & 1) * 16);
  };
  auto store_tiles = [&](int buf, const float* raw, int4 vb) {
#pragma unroll
    for (int g = 0; g < 4; ++g) As[buf][ah * 4 + g][ar] = quant4(raw + 4 * g, inv);
    const int h = tid & 1, row = tid >> 1;
    Bs[buf][h * 4 + 0][row] = vb.x;
    Bs[buf][h * 4 + 1][row] = vb.y;
    Bs[buf][h * 4 + 2][row] = vb.z;
    Bs[buf][h * 4 + 3][row] = vb.w;
  };

  int acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  const int nk = KR / 32;
  float raw[16];
  load_a(0, raw);
  int4 rb = load_b(0);
  store_tiles(0, raw, rb);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_a(kt + 1, raw);
      rb = load_b(kt + 1);
    }
#pragma unroll
    for (int kw = 0; kw < kWords; ++kw) {
      const int4 a0 = *reinterpret_cast<const int4*>(&As[buf][kw][ty * 8]);
      const int4 a1 = *reinterpret_cast<const int4*>(&As[buf][kw][ty * 8 + 4]);
      const int4 b0 = *reinterpret_cast<const int4*>(&Bs[buf][kw][tx * 4]);
      const int4 b1 = *reinterpret_cast<const int4*>(&Bs[buf][kw][64 + tx * 4]);
      const int a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const int b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < nk) store_tiles(buf ^ 1, raw, rb);
    __syncthreads();
  }

  // epilogue: acc * (s_x * s_w[k]) + bias[k]
  float sw[8], bs[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
    sw[j] = s_w[n];
    bs[j] = bias != nullptr ? bias[n] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= M) continue;
    const int b = m / (H * W);
    const int oy = (m - b * (H * W)) / W;
    const float sx = scales[b * nbands + oy / bh];
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = __fmul_rn((float)acc[i][j], __fmul_rn(sx, sw[j]));
      if (bias != nullptr) v[j] = __fadd_rn(v[j], bs[j]);
    }
    T* o = out + (long long)m * K + n0;
    store4(o + tx * 4, v);
    store4(o + 64 + tx * 4, v + 4);
  }
}

// bf16 mode: operands rounded to bf16, f32 sums, 16 channels of one tap per step
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_fused_bf16_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ out, int H, int W, int C,
                       int K, int M) {
  constexpr int kStep = 16;
  __shared__ __align__(16) float As[2][kStep][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kStep][kBN + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int KR = 9 * C;

  // this thread's loads: row ar of either tile, elements ah*8 .. +8 of each step
  // (a warp shares ah, so its shared-memory stores fall in 32 distinct banks)
  const int ar = tid & 127;
  const int ah = tid >> 7;
  const Pixel px = pixel_of(m0 + ar, M, H, W);
  const T* ximg = x + (long long)px.b * H * W * C;
  const __nv_bfloat16* wrow = w + (long long)(n0 + ar) * KR + ah * 8;

  auto load_a = [&](int kt, float* raw) {
    const int r0 = kt * kStep + ah * 8;
    const int tap = r0 / C;
    const int c = r0 - tap * C;
    const int ky = tap / 3;
    const int iy = px.oy - 1 + ky;
    const int ix = px.ox - 1 + (tap - ky * 3);
    if (px.ok && iy >= 0 && iy < H && ix >= 0 && ix < W) {
      load8(ximg + ((long long)iy * W + ix) * C + c, raw);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) raw[e] = 0.f;
    }
  };
  auto store_tiles = [&](int buf, const float* raw, uint4 vb) {
    float wf[8];
    unpack8(vb, wf);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      As[buf][ah * 8 + e][ar] = round_bf16(raw[e]);  // the identity on a bf16 input
      Bs[buf][ah * 8 + e][ar] = wf[e];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = KR / kStep;
  float raw[8];
  load_a(0, raw);
  uint4 rb = *reinterpret_cast<const uint4*>(wrow);
  store_tiles(0, raw, rb);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_a(kt + 1, raw);
      rb = *reinterpret_cast<const uint4*>(wrow + (kt + 1) * kStep);
    }
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < nk) store_tiles(buf ^ 1, raw, rb);
    __syncthreads();
  }

  float bs[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    bs[j] = bias != nullptr ? bias[n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4)] : 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= M) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = acc[i][j] + bs[j];
    T* o = out + (long long)m * K + n0;
    store4(o + tx * 4, v);
    store4(o + 64 + tx * 4, v + 4);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* scales, const void* s_w, const void* bias, void* out,
           int B, int H, int W, int C, int K, int bh, int quantized, cudaStream_t stream) {
  const int M = B * H * W;
  const dim3 grid((M + kBM - 1) / kBM, K / kBN);
  const T* xp = static_cast<const T*>(x);
  const float* bp = static_cast<const float*>(bias);
  T* op = static_cast<T*>(out);
  if (!quantized) {
    conv_fused_bf16_kernel<T><<<grid, kThreads, 0, stream>>>(
        xp, static_cast<const __nv_bfloat16*>(w), bp, op, H, W, C, K, M);
    return (int)cudaGetLastError();
  }
  const int nbands = H / bh;
  float* sc = static_cast<float*>(scales);
  band_scale_kernel<T><<<B * nbands, kThreads, 0, stream>>>(xp, sc, H, (long long)W * C, bh, nbands);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  conv_fused_s8_kernel<T><<<grid, kThreads, 0, stream>>>(
      xp, static_cast<const int8_t*>(w), sc, static_cast<const float*>(s_w), bp, op, H, W, C, K, bh,
      nbands, M);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, C) f32 (dtype 0) or bf16 (dtype 1), 16-byte aligned; out:
// (B, H, W, K) of the same type. quantized != 0: w (K, 9*C) s8 rows in
// (ky, kx, c) order, s_w (K,) f32, scales (B * H / bh,) f32 scratch that the
// call fills with the band scales. quantized == 0: w (K, 9*C) bf16 rows, s_w
// and scales unused. bias: (K,) f32 or null. Returns a cudaError_t code
// (0 = launched).
extern "C" int gdc_conv_fused(const void* x, const void* w, void* scales, const void* s_w,
                              const void* bias, void* out, int B, int H, int W, int C, int K, int bh,
                              int quantized, int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 128 || C % 128 || K < 128 || K % 128 || bh < 1 || H % bh)
    return (int)cudaErrorInvalidValue;
  if (quantized && (scales == nullptr || s_w == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, scales, s_w, bias, out, B, H, W, C, K, bh, quantized, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, scales, s_w, bias, out, B, H, W, C, K, bh, quantized, st);
  return (int)cudaErrorInvalidValue;
}
