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
//   bf16: x and w rounded to bf16, f32 sums, + bias.
// x is NHWC (B, H, W, C), out NHWC (B, H, W, K) in x's type; C % 128 == 0,
// K % 128 == 0, H % bh == 0.
//
// The TPU kernel's layout (flat shifted rows, W + 8 padding, three
// column-shifted copies in scratch) serves its matrix unit's alignment and is
// not carried over: this is K5's implicit GEMM (conv_s8_mma.cu), M = B*H*W
// output pixels by N = K channels, with a quantizing gather in front, on the
// mainloop the two share (conv_mma.cuh).
//
// What bounds it on the H100: operations. At 256 px, 256 -> 256, batch 8 it
// does 3.1e11 multiply-adds over ~1 GB of traffic. Both modes run them on the
// tensor cores, emitted by hand from mma.cuh: the quantized mode as
// mma.sync.m16n8k32 (s8, s32 sums), the bf16 mode as m16n8k16 (f32 sums).
//
// What the design does about it:
//   * a first small kernel reads each band's window once and writes its scale
//     (one block per (image, band), 16-byte loads, a max is exact in any
//     order); x is read twice in all, as on the TPU;
//   * the activations cannot come by cp.async: they are quantized (or rounded
//     to bf16) on the way in, with the scale of the band that produces the
//     output row. A thread loads 16 (bf16 mode: 8) channels of one tap of
//     each of its two pixels into registers, one stage ahead, so the loads
//     are in flight while the stage before is multiplied, then quantizes them
//     and stores 16 bytes into the ring in the layout ldmatrix reads: no
//     quantized tensor ever reaches device memory. The weights come by
//     cp.async, kStages - 1 stages ahead;
//   * a 128 x 128 tile per block of 8 warps, the ring, the fragments and the
//     staged, 16-byte epilogue stores of conv_mma.cuh; blockIdx.x runs over
//     the channel tiles first, so blocks that gather the same pixels run
//     together.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "conv_mma.cuh"

namespace {

using namespace gdc;
using namespace gdc::conv;

constexpr int kBM = 128;       // output pixels per block
constexpr int kThreads = 256;  // 8 warps, each 64 x 32
constexpr int kRPP = rows_per_pass<kThreads>();

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

// The conv itself. QUANT: s8 tiles, s32 sums, 64 channels of one tap a stage;
// else bf16 tiles, f32 sums, 32 channels of one tap a stage. w: (K, 9*C) rows
// of s8 or bf16.
template <typename T, bool QUANT>
__global__ void __launch_bounds__(kThreads, 1)
conv_fused_mma_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w, const float* __restrict__ scales,
                      const float* __restrict__ s_w, const float* __restrict__ bias, T* __restrict__ out, int H,
                      int W, int C, int K, int bh, int nbands, int M, int n_tiles) {
  using Acc = std::conditional_t<QUANT, int, float>;
  constexpr int EPC = QUANT ? 16 : 8;  // channels in a 16-byte chunk of the A tile
  constexpr int AR = kBM / kRPP;
  extern __shared__ __align__(16) uint8_t smem[];
  const unsigned ring = smem_u32(smem);
  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const long long row_bytes = 9LL * C * (QUANT ? 1 : 2);
  const int nk = (int)(row_bytes / kBK);

  // this thread's gather: chunk j of the pixel rows r and r + kRPP of the tile
  const int j = tid % kCPR, r = tid / kCPR;
  const T* abase[AR];
  unsigned amask[AR];
  float inv[AR];
#pragma unroll
  for (int i = 0; i < AR; ++i) {
    const int m = m0 + r + i * kRPP;
    abase[i] = x;
    amask[i] = 0u;
    inv[i] = 0.f;
    if (m < M) {
      const int b = m / (H * W);
      const int rem = m - b * (H * W);
      const int oy = rem / W, ox = rem - oy * W;
      abase[i] = x + (((long long)b * H + oy - 1) * W + ox - 1) * C;  // read only where the mask says so
      amask[i] = tap_mask(oy - 1, ox - 1, H, W, 3);
      if (QUANT) inv[i] = __fdiv_rn(1.0f, scales[b * nbands + oy / bh]);
    }
  }
  TapWalker tw;
  tw.init(j * EPC, C, 3, W);
  int kb = j * 16;
  const unsigned my_chunk = r * kPitch + j * 16;

  float raw[AR][EPC];
  auto gather = [&]() {
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      if (tw.inside(amask[i])) {
#pragma unroll
        for (int e = 0; e < EPC; e += 8) load8(abase[i] + tw.off + e, raw[i] + e);
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e) raw[i][e] = 0.f;
      }
    }
    tw.advance(kCPR * EPC, C, 3, W);
  };
  auto store_a = [&](int slot) {
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      unsigned words[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (QUANT)
          words[g] = (unsigned)quant4(raw[i] + 4 * g, inv[i]);
        else
          words[g] = pack_bf16x2(raw[i][2 * g], raw[i][2 * g + 1]);  // the identity on a bf16 input
      }
      *reinterpret_cast<uint4*>(smem + slot * stage_bytes<kBM>() + my_chunk + i * kRPP * kPitch) =
          make_uint4(words[0], words[1], words[2], words[3]);
    }
  };
  auto load_b = [&](int slot) {
    load_b_chunks<kThreads>(ring + slot * stage_bytes<kBM>() + kBM * kPitch + my_chunk, w, row_bytes, n0, r, kb, K);
    kb += kBK;
  };

  WarpTile<kBM, kThreads, Acc> tile;
  tile.init();

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_b(s);
    cp_async_commit();
  }
  gather();
  store_a(0);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt's weights have landed
    __syncthreads();               // for every thread, its activations are stored, stage kt - 1 is read by all
    if (kt + kStages - 1 < nk) load_b((kt + kStages - 1) % kStages);
    cp_async_commit();
    const bool more = kt + 1 < nk;
    if (more) gather();  // in flight while this stage multiplies
    tile.consume(ring + (kt % kStages) * stage_bytes<kBM>());
    if (more) store_a((kt + 1) % kStages);
  }

  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the sums in it
  tile.stage_out(smem);
  __syncthreads();
  const bool has_bias = bias != nullptr;
  if constexpr (QUANT) {
    // acc * (s_x * s_w[k]) + bias[k], s_x the scale of the output row's band
    store_tile<kBM, kThreads, int>(
        smem, out, s_w, bias, m0, n0, M, K,
        [&](int m) {
          const int b = m / (H * W);
          return scales[b * nbands + (m - b * (H * W)) / W / bh];
        },
        [&](int acc, float sx, float sw, float bs) {
          const float v = __fmul_rn((float)acc, __fmul_rn(sx, sw));
          return has_bias ? __fadd_rn(v, bs) : v;
        });
  } else {
    store_tile<kBM, kThreads, float>(
        smem, out, s_w, bias, m0, n0, M, K, [](int) { return 0.f; },
        [&](float acc, float, float, float bs) { return has_bias ? __fadd_rn(acc, bs) : acc; });
  }
}

template <typename T, bool QUANT>
int launch_conv(const T* x, const void* w, const float* scales, const float* s_w, const float* bias, T* out, int B,
                int H, int W, int C, int K, int bh, cudaStream_t stream) {
  const int M = B * H * W;
  const int n_tiles = K / kBN;
  const long long blocks = (long long)((M + kBM - 1) / kBM) * n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = conv_fused_mma_kernel<T, QUANT>;
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<kBM>());
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<(unsigned)blocks, kThreads, smem_bytes<kBM>(), stream>>>(
      x, static_cast<const uint8_t*>(w), scales, s_w, bias, out, H, W, C, K, bh, H / bh, M, n_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, void* scales, const void* s_w, const void* bias, void* out,
           int B, int H, int W, int C, int K, int bh, int quantized, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const float* bp = static_cast<const float*>(bias);
  T* op = static_cast<T*>(out);
  if (!quantized) return launch_conv<T, false>(xp, w, nullptr, nullptr, bp, op, B, H, W, C, K, bh, stream);
  const int nbands = H / bh;
  float* sc = static_cast<float*>(scales);
  band_scale_kernel<T><<<B * nbands, kThreads, 0, stream>>>(xp, sc, H, (long long)W * C, bh, nbands);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return launch_conv<T, true>(xp, w, sc, static_cast<const float*>(s_w), bp, op, B, H, W, C, K, bh, stream);
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
