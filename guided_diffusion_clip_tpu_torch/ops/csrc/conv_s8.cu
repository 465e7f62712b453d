// s8 x s8 -> s32 convolution with a dequantizing epilogue: kernel K5 on the
// integer pipes, on no model's path. Layers with C % 16 == 0 and K > 16 run
// conv_s8_mma.cu on the tensor cores, the stems and heads conv_s8_thin.cu;
// this kernel is the yardstick both are held to, bit for bit, on every shape
// (ops/quant.py::conv_s8_dp4a), and runs what neither takes.
//
// Replaces guided_diffusion_clip_tpu/ops/pallas_conv.py::fused_conv3x3_s8
// (_kernel_s8) and, generalised, the s8 convolutions that the JAX package's
// ops/quant.py leaves to XLA on the TPU (conv_prequant, int8_conv): PyTorch
// has no int8 convolution on CUDA. It computes
//   out[b, oy, ox, k] = acc * s_w[k] * s_img[b] + bias[k],
//   acc = sum over (ky, kx, c) of q[b, oy*stride - pad + ky, ox*stride - pad + kx, c]
//                                 * w[k, ky, kx, c]   (exact in s32),
// with zero padding, any H, W, C, K, square kernels (3x3 and 1x1 on the
// path), stride 1 or 2; s_img and bias may be null. q is NHWC s8 (the
// quantizing GroupNorm K4 writes it so), out NHWC f32 or bf16. The epilogue
// multiplies and adds unfused (__fmul_rn/__fadd_rn), in the reference's
// order. The accumulation is exact: |acc| <= kh*kw*C * 127^2 < 2^31 for
// C <= 14,000 at 3x3.
//
// What bounds it on the H100: an implicit GEMM, M = B*Ho*Wo output pixels,
// N = K output channels, reduction kh*kw*C bytes. At the UNet's shapes it is
// compute-bound. This kernel runs on the integer pipes (__dp4a: four s8
// products and an s32 add per instruction), at about a sixth of the rate
// that conv_s8_mma.cu reads from the tensor cores.
//
// What the design does about it:
//   * a 128 (pixels) x BN (channels) tile per block of 256 threads, 8 x TN
//     outputs per thread in registers, so each shared-memory word read feeds
//     8 or TN dp4a; BN = 128 for wide layers, 16 for the 6-channel head;
//   * the reduction moves 32 bytes at a time: for C % 32 == 0 a 32-byte
//     chunk lies inside one tap, so each thread fetches 16 contiguous
//     channels of one pixel with one 16-byte load (zeros where the tap falls
//     in the padding); any other C (the 3-channel stem) gathers byte by byte;
//   * the weights are (K, KRp) rows, each output channel's taps in (ky, kx,
//     c) order padded to a multiple of 32 bytes with zeros, loaded 16 bytes
//     a thread;
//   * shared memory holds the tiles as 32-bit words, reduction-major and
//     padded by 4 words per row (no bank conflicts on the stores), two
//     buffers: the next tile's global loads are in flight while the current
//     one is multiplied, one barrier per 32 bytes of reduction.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output pixels per block
constexpr int kBKW = 8;       // reduction words (32 bytes) per tile
constexpr int kThreads = 256;
constexpr int kTM = 8;        // pixels per thread (16 thread rows)

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int BN, bool VECA, typename OutT>
__global__ void __launch_bounds__(kThreads)
conv_s8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ w,
               const float* __restrict__ s_img, const float* __restrict__ s_w,
               const float* __restrict__ bias, OutT* __restrict__ out, int H, int W, int C, int K,
               int ks, int stride, int pad, int Ho, int Wo, int M, int KR, int KRp) {
  constexpr int TN = BN / 16;
  __shared__ __align__(16) int As[2][kBKW][kBM + 4];
  __shared__ __align__(16) int Bs[2][kBKW][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channel group: channels tx*TN .. +TN
  const int ty = tid / 16;  // pixel group: pixels ty*8 .. +8
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;

  // this thread's A load: pixel row ar of the tile, bytes ah*16 .. +16 of each chunk
  const int ar = tid >> 1;
  const int ah = tid & 1;
  const int am = m0 + ar;
  const bool am_ok = am < M;
  int ab = 0, aiy0 = 0, aix0 = 0;
  if (am_ok) {
    ab = am / (Ho * Wo);
    const int rem = am - ab * (Ho * Wo);
    const int oy = rem / Wo;
    aiy0 = oy * stride - pad;
    aix0 = (rem - oy * Wo) * stride - pad;
  }
  const int8_t* qimg = q + (long long)ab * H * W * C;

  auto load_a = [&](int kt) -> int4 {
    int4 v = make_int4(0, 0, 0, 0);
    if (!am_ok) return v;
    const int r0 = kt * 32 + ah * 16;
    if constexpr (VECA) {
      const int tap = r0 / C;
      const int c = r0 - tap * C;
      const int ky = tap / ks;
      const int iy = aiy0 + ky;
      const int ix = aix0 + (tap - ky * ks);
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = *reinterpret_cast<const int4*>(qimg + ((long long)iy * W + ix) * C + c);
    } else {
      unsigned bytes[4] = {0u, 0u, 0u, 0u};
#pragma unroll 4
      for (int e = 0; e < 16; ++e) {
        const int r = r0 + e;
        if (r < KR) {
          const int tap = r / C;
          const int c = r - tap * C;
          const int ky = tap / ks;
          const int iy = aiy0 + ky;
          const int ix = aix0 + (tap - ky * ks);
          if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
            const unsigned byte = (uint8_t)qimg[((long long)iy * W + ix) * C + c];
            bytes[e >> 2] |= byte << (8 * (e & 3));
          }
        }
      }
      v = make_int4((int)bytes[0], (int)bytes[1], (int)bytes[2], (int)bytes[3]);
    }
    return v;
  };

  // B loads: BN rows x 32 bytes = 2*BN 16-byte vectors over the block
  constexpr int kBLoads = (2 * BN + kThreads - 1) / kThreads;
  auto load_b = [&](int kt, int4* regs) {
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int idx = tid + i * kThreads;
      regs[i] = make_int4(0, 0, 0, 0);
      if (idx < 2 * BN) {
        const int n = n0 + (idx >> 1);
        if (n < K)
          regs[i] = *reinterpret_cast<const int4*>(w + (long long)n * KRp + kt * 32 + (idx & 1) * 16);
      }
    }
  };
  auto store_tiles = [&](int buf, int4 va, const int4* vb) {
    As[buf][ah * 4 + 0][ar] = va.x;
    As[buf][ah * 4 + 1][ar] = va.y;
    As[buf][ah * 4 + 2][ar] = va.z;
    As[buf][ah * 4 + 3][ar] = va.w;
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < 2 * BN) {
        const int h = idx & 1, row = idx >> 1;
        Bs[buf][h * 4 + 0][row] = vb[i].x;
        Bs[buf][h * 4 + 1][row] = vb[i].y;
        Bs[buf][h * 4 + 2][row] = vb[i].z;
        Bs[buf][h * 4 + 3][row] = vb[i].w;
      }
    }
  };

  int acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  const int nk = KRp / 32;
  int4 ra = load_a(0);
  int4 rb[kBLoads];
  load_b(0, rb);
  store_tiles(0, ra, rb);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      ra = load_a(kt + 1);
      load_b(kt + 1, rb);
    }
#pragma unroll
    for (int kw = 0; kw < kBKW; ++kw) {
      int a[kTM], b[TN];
      const int4 a0 = *reinterpret_cast<const int4*>(&As[buf][kw][ty * kTM]);
      const int4 a1 = *reinterpret_cast<const int4*>(&As[buf][kw][ty * kTM + 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      if constexpr (TN % 4 == 0) {
#pragma unroll
        for (int j = 0; j < TN; j += 4) {
          const int4 bv = *reinterpret_cast<const int4*>(&Bs[buf][kw][tx * TN + j]);
          b[j] = bv.x; b[j + 1] = bv.y; b[j + 2] = bv.z; b[j + 3] = bv.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[buf][kw][tx * TN + j];
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < nk) store_tiles(buf ^ 1, ra, rb);
    __syncthreads();
  }

  // epilogue: acc * s_w[k] * s_img[b] + bias[k], rounded as the reference
  float sw[TN], bs[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tx * TN + j;
    sw[j] = n < K ? s_w[n] : 0.f;
    bs[j] = (n < K && bias != nullptr) ? bias[n] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    if (m >= M) continue;
    const float si = s_img != nullptr ? s_img[m / (Ho * Wo)] : 1.f;
    OutT* o = out + (long long)m * K;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < K) {
        float v = __fmul_rn((float)acc[i][j], sw[j]);
        if (s_img != nullptr) v = __fmul_rn(v, si);
        if (bias != nullptr) v = __fadd_rn(v, bs[j]);
        store_out(o + n, v);
      }
    }
  }
}

template <int BN, typename OutT>
int launch(const int8_t* q, const int8_t* w, const float* s_img, const float* s_w,
           const float* bias, void* out, int B, int H, int W, int C, int K, int ks, int stride,
           int pad, int Ho, int Wo, int KRp, cudaStream_t stream) {
  const int M = B * Ho * Wo;
  const int KR = ks * ks * C;
  const dim3 grid((M + kBM - 1) / kBM, (K + BN - 1) / BN);
  OutT* o = static_cast<OutT*>(out);
  if (C % 32 == 0)
    conv_s8_kernel<BN, true, OutT><<<grid, kThreads, 0, stream>>>(
        q, w, s_img, s_w, bias, o, H, W, C, K, ks, stride, pad, Ho, Wo, M, KR, KRp);
  else
    conv_s8_kernel<BN, false, OutT><<<grid, kThreads, 0, stream>>>(
        q, w, s_img, s_w, bias, o, H, W, C, K, ks, stride, pad, Ho, Wo, M, KR, KRp);
  return (int)cudaGetLastError();
}

template <typename OutT>
int dispatch_bn(const int8_t* q, const int8_t* w, const float* s_img, const float* s_w,
                const float* bias, void* out, int B, int H, int W, int C, int K, int ks,
                int stride, int pad, int Ho, int Wo, int KRp, cudaStream_t stream) {
  if (K <= 16)
    return launch<16, OutT>(q, w, s_img, s_w, bias, out, B, H, W, C, K, ks, stride, pad, Ho, Wo,
                            KRp, stream);
  return launch<128, OutT>(q, w, s_img, s_w, bias, out, B, H, W, C, K, ks, stride, pad, Ho, Wo,
                           KRp, stream);
}

}  // namespace

// q: (B, H, W, C) s8, 16-byte aligned; w: (K, KRp) s8, KRp a multiple of 32
// >= ks*ks*C, each row's taps in (ky, kx, c) order, zero-padded; s_img: (B,)
// f32 or null; s_w: (K,) f32; bias: (K,) f32 or null; out: (B, Ho, Wo, K) in
// out_dtype (0 = float32, 1 = bfloat16). Returns a cudaError_t code (0 =
// launched).
extern "C" int gdc_conv_s8(const void* q, const void* w, const void* s_img, const void* s_w,
                           const void* bias, void* out, int B, int H, int W, int C, int K, int ks,
                           int stride, int pad, int Ho, int Wo, int KRp, int out_dtype,
                           void* stream) {
  if (KRp % 32 || KRp < ks * ks * C || B < 1 || K < 1 || C < 1 || stride < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* si = static_cast<const float*>(s_img);
  const float* sw = static_cast<const float*>(s_w);
  const float* bp = static_cast<const float*>(bias);
  if (out_dtype == 0)
    return dispatch_bn<float>(qp, wp, si, sw, bp, out, B, H, W, C, K, ks, stride, pad, Ho, Wo, KRp,
                              st);
  if (out_dtype == 1)
    return dispatch_bn<__nv_bfloat16>(qp, wp, si, sw, bp, out, B, H, W, C, K, ks, stride, pad, Ho,
                                      Wo, KRp, st);
  return (int)cudaErrorInvalidValue;
}
