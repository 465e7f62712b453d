// s8 x s8 -> s32 convolution on the tensor cores: kernel K5 for every layer
// with C % 16 == 0 and K > 16 (conv_s8.cu keeps the 3-channel stems and the
// 6-channel head on __dp4a).
//
// Replaces guided_diffusion_clip_tpu/ops/pallas_conv.py::fused_conv3x3_s8
// (_kernel_s8) and the s8 convolutions that the JAX package's ops/quant.py
// leaves to XLA on the TPU. The function is conv_s8.cu's, bit for bit:
//   out[b, oy, ox, k] = acc * s_w[k] * s_img[b] + bias[k]
// with acc the exact s32 sum over (ky, kx, c), zero padding, square kernels
// (ks * ks <= 25), any stride, and the epilogue's unfused order.
//
// What bounds it on the H100: operations. The products run as
// mma.sync.m16n8k32 (s8, s32 sums), emitted by hand from mma.cuh, whose measured
// ceiling on this card is what mma_probe.cu reads; the mainloop, its ring and
// its epilogue staging are conv_mma.cuh's. What this file adds:
//   * the feed: both operands by cp.async, 16 bytes a copy straight to shared
//     memory, zero-filled where a tap falls in the padding, past M, past K or
//     past the end of the reduction: no register, no transpose. The
//     activations come through the L1 (.ca): the three taps of a kernel row
//     read almost the same pixels, one after the other;
//   * blockIdx.x runs over the channel tiles first, so the blocks that share
//     an A tile run together and find it in the L2;
//   * small layers (8 and 16 px: too few pixels to fill 132 SMs with 128-row
//     tiles) take 64-row tiles and, where that is still too few blocks, a
//     split of the reduction over blockIdx.y. Partial sums are s32 and are
//     added with atomicAdd into zeroed scratch: integer addition commutes, so
//     the sums are the same bits in any order. The epilogue then runs in a
//     second small kernel, not in the last block to arrive: that would need a
//     counter per tile, a fence and a re-read of the tile through the L2 by
//     one block, for layers whose whole output is a few megabytes.
//     Which tile and split a shape gets is decided in Python
//     (ops/quant.py::pick_tile), where the CPU tests can hold it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_mma.cuh"

namespace {

using namespace gdc;
using namespace gdc::conv;

constexpr int kThreads = 128;  // 4 warps, each (BM / 2) x 64; two blocks fit an SM
constexpr int kRPP = rows_per_pass<kThreads>();

template <int BM, typename OutT, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 2)
conv_s8_mma_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ w, const float* __restrict__ s_img,
                   const float* __restrict__ s_w, const float* __restrict__ bias, OutT* __restrict__ out,
                   int* __restrict__ scratch, int H, int W, int C, int K, int ks, int stride, int pad, int Ho,
                   int Wo, int M, int KRp, int n_tiles, int stages_per_split) {
  extern __shared__ __align__(16) uint8_t smem[];
  const unsigned ring = smem_u32(smem);
  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int s_begin = blockIdx.y * stages_per_split;
  const int nk = min((KRp + kBK - 1) / kBK, s_begin + stages_per_split) - s_begin;

  // this thread's copies: chunk j of the rows r + i * kRPP of both tiles
  constexpr int AR = BM / kRPP;
  const int j = tid % kCPR, r = tid / kCPR;
  const int8_t* abase[AR];
  unsigned amask[AR];
#pragma unroll
  for (int i = 0; i < AR; ++i) {
    const int m = m0 + r + i * kRPP;
    abase[i] = q;
    amask[i] = 0u;
    if (m < M) {
      const int b = m / (Ho * Wo);
      const int rem = m - b * (Ho * Wo);
      const int oy = rem / Wo;
      const int iy0 = oy * stride - pad, ix0 = (rem - oy * Wo) * stride - pad;
      abase[i] = q + (((long long)b * H + iy0) * W + ix0) * C;  // read only where the mask says so
      amask[i] = tap_mask(iy0, ix0, H, W, ks);
    }
  }
  TapWalker tw;
  tw.init(s_begin * kBK + j * 16, C, ks, W);
  int kb = s_begin * kBK + j * 16;
  const unsigned my_chunk = r * kPitch + j * 16;

  auto load_stage = [&](int slot) {
    const unsigned dst = ring + slot * stage_bytes<BM>() + my_chunk;
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      const bool v = tw.inside(amask[i]);
      cp_async_16_ca(dst + i * kRPP * kPitch, v ? abase[i] + tw.off : q, v);
    }
    load_b_chunks<kThreads>(dst + BM * kPitch, reinterpret_cast<const uint8_t*>(w), KRp, n0, r, kb, K);
    tw.advance(kBK, C, ks, W);
    kb += kBK;
  };

  WarpTile<BM, kThreads, int> tile;
  tile.init();

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed
    __syncthreads();               // for every thread, and stage kt - 1 is read by all
    if (kt + kStages - 1 < nk) load_stage((kt + kStages - 1) % kStages);
    cp_async_commit();
    tile.consume(ring + (kt % kStages) * stage_bytes<BM>());
  }

  if constexpr (SPLIT) {
    // partial sums: s32 atomics commute, any order gives the same bits
    const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < WarpTile<BM, kThreads, int>::MT; ++i)
#pragma unroll
      for (int jn = 0; jn < WarpTile<BM, kThreads, int>::NT; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + tile.wm + i * 16 + g + (e >> 1) * 8;
          const int n = n0 + tile.wn + jn * 8 + t4 * 2 + (e & 1);
          if (m < M && n < K) atomicAdd(scratch + (long long)m * K + n, tile.acc[i][jn][e]);
        }
  } else {
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: stage the sums in it
    tile.stage_out(smem);
    __syncthreads();
    const int HoWo = Ho * Wo;
    const bool per_image = s_img != nullptr, has_bias = bias != nullptr;
    store_tile<BM, kThreads, int>(
        smem, out, s_w, bias, m0, n0, M, K,
        [&](int m) { return per_image ? s_img[m / HoWo] : 1.f; },
        [&](int acc, float si, float sw, float bs) {
          float v = __fmul_rn((float)acc, sw);
          if (per_image) v = __fmul_rn(v, si);
          if (has_bias) v = __fadd_rn(v, bs);
          return v;
        });
  }
}

// the epilogue over the summed scratch of a split launch
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
conv_s8_finish_kernel(const int* __restrict__ scratch, const float* __restrict__ s_img,
                      const float* __restrict__ s_w, const float* __restrict__ bias, OutT* __restrict__ out,
                      long long total, int K, int HoWo) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const long long m = idx / K;
  const int n = (int)(idx - m * K);
  float v = __fmul_rn((float)scratch[idx], s_w[n]);
  if (s_img != nullptr) v = __fmul_rn(v, s_img[m / HoWo]);
  if (bias != nullptr) v = __fadd_rn(v, bias[n]);
  store_one(out + idx, v);
}

template <int BM, typename OutT, bool SPLIT>
int launch(const int8_t* q, const int8_t* w, const float* s_img, const float* s_w, const float* bias, void* out,
           int* scratch, int B, int H, int W, int C, int K, int ks, int stride, int pad, int Ho, int Wo, int KRp,
           int split, cudaStream_t stream) {
  const int M = B * Ho * Wo;
  const int n_tiles = (K + kBN - 1) / kBN;
  const long long blocks = (long long)((M + BM - 1) / BM) * n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int stages = (KRp + kBK - 1) / kBK;
  const int per_split = (stages + split - 1) / split;
  auto kernel = conv_s8_mma_kernel<BM, OutT, SPLIT>;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<BM>());
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<dim3((unsigned)blocks, split), kThreads, smem_bytes<BM>(), stream>>>(
      q, w, s_img, s_w, bias, static_cast<OutT*>(out), scratch, H, W, C, K, ks, stride, pad, Ho, Wo, M, KRp,
      n_tiles, per_split);
  rc = cudaGetLastError();
  if (rc != cudaSuccess || !SPLIT) return (int)rc;
  const long long total = (long long)M * K;
  conv_s8_finish_kernel<OutT><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      scratch, s_img, s_w, bias, static_cast<OutT*>(out), total, K, Ho * Wo);
  return (int)cudaGetLastError();
}

template <typename OutT, typename... Args>
int dispatch(int bm, int split, Args... args) {
  if (bm == 128) return split > 1 ? launch<128, OutT, true>(args...) : launch<128, OutT, false>(args...);
  return split > 1 ? launch<64, OutT, true>(args...) : launch<64, OutT, false>(args...);
}

}  // namespace

// As gdc_conv_s8 (conv_s8.cu), for C % 16 == 0 and ks * ks <= 25: q (B, H, W,
// C) s8 and w (K, KRp) s8 rows, both 16-byte aligned, KRp a multiple of 32 >=
// ks*ks*C; out (B, Ho, Wo, K) in out_dtype (0 = float32, 1 = bfloat16). bm:
// rows of a block's tile, 128 or 64; split >= 1: slices of the reduction, each
// a whole number of 64-byte stages and none of them empty; with split > 1
// scratch is (B*Ho*Wo, K) s32, zeroed by the caller. Returns a cudaError_t
// code (0 = launched).
extern "C" int gdc_conv_s8_mma(const void* q, const void* w, const void* s_img, const void* s_w,
                               const void* bias, void* out, void* scratch, int B, int H, int W, int C, int K,
                               int ks, int stride, int pad, int Ho, int Wo, int KRp, int out_dtype, int bm,
                               int split, void* stream) {
  if (KRp % 32 || KRp < ks * ks * C || B < 1 || K < 1 || C < 16 || C % 16 || stride < 1 || ks < 1 || ks * ks > 25 ||
      (bm != 128 && bm != 64) || split < 1 || split > (KRp + kBK - 1) / kBK || (split > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* si = static_cast<const float*>(s_img);
  const float* sw = static_cast<const float*>(s_w);
  const float* bp = static_cast<const float*>(bias);
  int* sc = static_cast<int*>(scratch);
  if (out_dtype == 0)
    return dispatch<float>(bm, split, qp, wp, si, sw, bp, out, sc, B, H, W, C, K, ks, stride, pad, Ho, Wo, KRp,
                           split, st);
  if (out_dtype == 1)
    return dispatch<__nv_bfloat16>(bm, split, qp, wp, si, sw, bp, out, sc, B, H, W, C, K, ks, stride, pad, Ho, Wo,
                                   KRp, split, st);
  return (int)cudaErrorInvalidValue;
}
