// s8 x s8 -> s32 convolution for the thin layers of K5 on the tensor cores:
// the stems (few channels in, many out: 3 -> 256, 3 -> 128, 3 -> 64, the SR
// models' 6 -> 64) and the heads (many channels in, at most 8 out: 256 -> 6,
// 64 -> 6, the quality proxies' 3-out heads and their classifier's 1x1).
// conv_s8_mma.cu takes every layer with C % 16 == 0 and K > 16; which layer
// runs which kernel is decided in Python (ops/quant.py::uses_thin_kernel).
// conv_s8.cu (__dp4a), which ran these layers before, stays only as the
// yardstick both tensor-core kernels are held to, bit for bit.
//
// Replaces, on the TPU's side, XLA's s8 convolution, to which the JAX
// package's ops/quant.py sends these shapes (_conv_s8, _conv_prequant_impl):
// guided_diffusion_clip_tpu/ops/pallas_conv.py::fused_conv3x3_s8 (_kernel_s8)
// takes only C and K that are multiples of 128. The function is conv_s8.cu's:
//   out[b, oy, ox, k] = acc * s_w[k] (* s_img[b]) (+ bias[k]),
// acc the exact s32 sum over (ky, kx, c), zero padding, stride 1, odd square
// kernels, the epilogue unfused (__fmul_rn, __fadd_rn) in that order, so the
// bits are the __dp4a kernel's at every shape. The weights are the (K, KRp)
// rows that models/nn.py::Conv2d caches (ops/quant.py::_pack_weights).
//
// What bounds them on the H100: bytes. The products are a few percent of the
// tensor cores' rate; a stem's cost is the output it writes (268 MB in bf16
// at ADM-256's 3 -> 256, batch 8), a head's the input it reads (134 MB at
// ADM-256's 256 -> 6).
//
// The stem kernel (conv_s8_stem_kernel):
//   * a block owns a band of output rows of one image and copies the band's
//     input rows with the halo above and below, one contiguous run of NHWC
//     bytes, into shared memory with 16-byte cp.async copies (the run's ends
//     need not be aligned: the copy starts at the 16-byte boundary below and
//     the last copy reads only the bytes that are left). It walks several
//     bands with two patch buffers: the next band's copy is in flight while
//     the current one is multiplied and stored;
//   * the A fragments of mma.sync.m16n8k32 are gathered straight from the
//     patch into registers, one pixel's KRp bytes a row (27 real + 5 zero at
//     C = 3, 54 + 10 at C = 6): a lane always takes the same 8 or 16 bytes of
//     the reduction, so where each lies is a table made on the host
//     (ops/quant.py::stem_taps, (dy, dx, c) offsets in _pack_weights' (ky,
//     kx, c) order) that the lane reads once; no division in any loop;
//   * a warp keeps all of its weights' B fragments in registers (K/8 n-tiles
//     x KRp/32 k-steps x 2), so each 16-pixel A fragment feeds K/8 mma with
//     no further shared-memory read; past 32 n-tiles at one k-step (K = 256)
//     or 8 at two (K = 64) the output channels are split between warps;
//   * the epilogue is where the time goes: the sums are dequantized in
//     registers, staged per warp in shared memory (rows padded by 16 bytes,
//     so the fragment stores do not conflict) and written 16 bytes a lane,
//     neighbouring lanes on neighbouring addresses: a warp's 16 pixels x K
//     channels are one contiguous run of the output.
//
// The head kernel (conv_s8_head_kernel):
//   * a block stages a tile of up to 8 output rows x 32 columns with its halo,
//     16 bytes a cp.async, each pixel's C bytes padded by 16 so that the 8
//     rows of an ldmatrix matrix fall in distinct banks (conv_mma.cuh's
//     kPitch), zeros where the halo leaves the image; the weights stay in
//     shared memory, padded to 8 rows with zeros. Two blocks fit an SM, so
//     one block's copy runs under the other's products (one block walking
//     tiles with two patch buffers, measured, was slower: the products then
//     have 8 warps an SM to hide their latency);
//   * the A rows point straight into the patch: tap (dy, dx) of a pixel is C
//     contiguous bytes there, so there is no im2col copy. One n-tile of 8
//     holds the 3 or 6 channels. The A fragment reads are most of what the
//     products move (512 bytes an mma at n = 8), so a fragment is read once for all the
//     kernel rows it serves: the 16 pixels of a patch row at column offset
//     dx are, for tap (dy, dx), the A rows of output row (patch row - dy), so
//     one ldmatrix feeds up to ks mma with the B fragments of taps (0..ks-1,
//     dx) held in registers, a third of the reads of a fragment per tap;
//   * the reduction is split between the block's warps, four to each half of
//     the tile's columns, by (dx, 32-byte step of a tap's channels; the
//     weights staged with each tap padded to whole steps). A warp loads a
//     unit's fragments first and then runs the mma tap row by tap row, so
//     that consecutive mma add into different rows' sums; its s32 partials
//     go to a slice of its own in shared memory, summed in the epilogue
//     (integer adds: any order gives the same bits; shared atomics there
//     were slower);
//   * the tile's rows leave as runs of pixels x K values, 16 bytes a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "conv_mma.cuh"

namespace {

using namespace gdc;
using gdc::conv::store_one;
using gdc::conv::store_vec;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxKR = 64;      // a stem's reduction bytes: one or two 32-byte k-steps
constexpr int kTileW = 32;      // a head tile's output columns: two m-tiles a row
constexpr int kMaxTileRows = 8; // a head tile's output rows: at most 16 m-tiles
constexpr int kMaxSmem = 232448;
constexpr int kHeadBudget = 113 * 1024;  // shared memory of a head block, two to an SM

// a stem's reduction byte j: (offset << 8) | (ky << 4) | kx, offset in bytes
// from the pixel's (row - pad, column) in the patch; 15 in ky and kx for the
// zero bytes past ks*ks*C (ops/quant.py::stem_taps)
struct StemTaps {
  int e[kMaxKR];
};

struct ThinArgs {
  const int8_t* q;
  const int8_t* w;
  const float* s_img;
  const float* s_w;
  const float* bias;
  void* out;
  int B, H, W, C, K, ks, pad, KRp;
  // the stem's: output rows of a band, bands of an image and in all, warps along K, n-tiles a warp, bytes of
  // a patch buffer and of a staged output row
  int band_rows, bands_per_image, n_bands, split, ntw, patch_buf, stage_pitch;
  // the head's: output rows of a tile, tiles along W and along H
  int tile_rows, tiles_x, tiles_y;
};

__host__ __device__ constexpr int align16(int v) { return (v + 15) & ~15; }

// 16 bytes from device memory to shared memory of which only the first n
// (0 <= n <= 16) are read; the rest are zeros. Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async_16_n(unsigned dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(__cvta_generic_to_global(src)), "r"(n)
               : "memory");
}

__device__ __forceinline__ float dequant(int acc, float sw, float si, float bs, bool per_image, bool has_bias) {
  float v = __fmul_rn((float)acc, sw);
  if (per_image) v = __fmul_rn(v, si);
  if (has_bias) v = __fadd_rn(v, bs);
  return v;
}

// two adjacent channels of one staged output row
__device__ __forceinline__ void stage_pair(uint8_t* p, float v0, float v1, float*) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void stage_pair(uint8_t* p, float v0, float v1, __nv_bfloat16*) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16x2(v0, v1);
}

// ---------------------------------------------------------------------------
// the stem

template <int KS, int NT, typename OutT>
__global__ void __launch_bounds__(kThreads)
conv_s8_stem_kernel(const ThinArgs a, const StemTaps taps) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* sw_s = reinterpret_cast<float*>(smem);
  float* bias_s = sw_s + a.K;
  int* tap_s = reinterpret_cast<int*>(bias_s + a.K);
  uint8_t* patches = smem + align16((2 * a.K + kMaxKR) * 4);
  uint8_t* stage = patches + 2 * a.patch_buf;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const bool per_image = a.s_img != nullptr, has_bias = a.bias != nullptr;
  for (int k = tid; k < a.K; k += kThreads) {
    sw_s[k] = a.s_w[k];
    bias_s[k] = has_bias ? a.bias[k] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kMaxKR; ++j)  // constant indices: the table stays in the parameter bank until here
    if (tid == j) tap_s[j] = taps.e[j];

  // this warp's output channels: n-tiles nt0 .. nt0 + nts of the K / 8, and its share of the pixels
  const int ng = warp % a.split, mg = warp / a.split, n_mg = kWarps / a.split;
  const int nt0 = ng * a.ntw;
  const int nts = min(a.ntw, a.K / 8 - nt0);
  const bool active = mg < n_mg && nts > 0;
  unsigned bfr[KS][NT][2];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bool ok = active && nt < nts;
      const int8_t* row = a.w + (long long)((nt0 + nt) * 8 + g) * a.KRp + s * 32 + 4 * t4;
      bfr[s][nt][0] = ok ? __ldg(reinterpret_cast<const unsigned*>(row)) : 0u;
      bfr[s][nt][1] = ok ? __ldg(reinterpret_cast<const unsigned*>(row + 16)) : 0u;
    }

  const long long row_bytes = (long long)a.W * a.C;
  // the byte of a band's slot at which image row oy0 - pad begins: 16 bytes
  // in, plus what puts the first copy's source and destination on the same
  // 16-byte phase
  auto origin = [&](int b, int oy0) -> int {
    const unsigned long long first =
        (unsigned long long)(uintptr_t)a.q + (unsigned long long)(((long long)b * a.H + oy0 - a.pad) * row_bytes);
    return 16 + (int)(first & 15ull);
  };
  // band i's image rows oy0 - pad .. oy0 + rows + pad that lie in the image, one run of bytes, into slot
  auto issue = [&](int i, int slot) {
    const int b = i / a.bands_per_image;
    const int oy0 = (i - b * a.bands_per_image) * a.band_rows;
    const int lo = max(oy0 - a.pad, 0), hi = min(oy0 + a.band_rows + a.pad, a.H);
    const uintptr_t g0 = (uintptr_t)(a.q + ((long long)b * a.H + lo) * row_bytes);
    const uintptr_t g1 = (uintptr_t)(a.q + ((long long)b * a.H + hi) * row_bytes);
    const uintptr_t a0 = g0 & ~(uintptr_t)15;
    const unsigned dst = smem_u32(patches + slot * a.patch_buf) + origin(b, oy0) +
                         (unsigned)((lo - (oy0 - a.pad)) * row_bytes) - (unsigned)(g0 - a0);
    for (uintptr_t p = a0 + 16 * tid; p < g1; p += 16 * kThreads)
      cp_async_16_n(dst + (unsigned)(p - a0), reinterpret_cast<const void*>(p), g1 - p < 16 ? (int)(g1 - p) : 16);
  };

  int band = blockIdx.x;
  if (band < a.n_bands) issue(band, 0);
  cp_async_commit();
  __syncthreads();  // the scales and the table

  // this lane's reduction bytes: j = 32 s + 16 h + 4 t4 + e holds byte e of register 2h (+1 for row g + 8)
  int ent[KS][2][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) ent[s][h][e] = tap_s[32 * s + 16 * h + 4 * t4 + e];

  constexpr int kOut = (int)sizeof(OutT);
  uint8_t* stage_w = stage + warp * 16 * a.stage_pitch;
  const int cpr = nts * 8 * kOut / 16;  // 16-byte chunks of a warp's staged row

  for (int it = 0; band < a.n_bands; ++it, band += gridDim.x) {
    const int next = band + gridDim.x;
    if (next < a.n_bands) issue(next, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // this band's copies have landed
    __syncthreads();     // for every thread

    const int b = band / a.bands_per_image;
    const int oy0 = (band - b * a.bands_per_image) * a.band_rows;
    const int rows = min(a.band_rows, a.H - oy0);
    const uint8_t* patch = patches + (it & 1) * a.patch_buf + origin(b, oy0);
    const int npx = rows * a.W;
    const float si = per_image ? a.s_img[b] : 1.f;
    const long long m_base = ((long long)b * a.H + oy0) * a.W;  // the band's first output pixel

    if (active) {
      for (int mt = mg; mt * 16 < npx; mt += n_mg) {
        unsigned afr[KS][4];
#pragma unroll
        for (int hp = 0; hp < 2; ++hp) {  // pixels g and g + 8 of the m-tile
          const int p = mt * 16 + g + 8 * hp;
          unsigned rm = 0u, cm = 0u;  // the taps' rows and columns that lie in the image
          int r = 0, x = 0;
          if (p < npx) {
            r = p / a.W;
            x = p - r * a.W;
            for (int k = 0; k < a.ks; ++k) {
              rm |= ((unsigned)(oy0 + r - a.pad + k) < (unsigned)a.H ? 1u : 0u) << k;
              cm |= ((unsigned)(x - a.pad + k) < (unsigned)a.W ? 1u : 0u) << k;
            }
          }
          const uint8_t* base = patch + (r * a.W + x) * a.C;
#pragma unroll
          for (int s = 0; s < KS; ++s)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              unsigned word = 0u;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int en = ent[s][h][e];
                if ((rm >> ((en >> 4) & 15)) & (cm >> (en & 15)) & 1u) word |= (unsigned)base[en >> 8] << (8 * e);
              }
              afr[s][hp + 2 * h] = word;
            }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt < nts) {
            int acc[4] = {0, 0, 0, 0};
#pragma unroll
            for (int s = 0; s < KS; ++s) mma_tile(acc, afr[s], bfr[s][nt]);
            const int n = (nt0 + nt) * 8 + 2 * t4;
            const float sw0 = sw_s[n], sw1 = sw_s[n + 1], b0 = bias_s[n], b1 = bias_s[n + 1];
            uint8_t* o = stage_w + g * a.stage_pitch + (nt * 8 + 2 * t4) * kOut;
            stage_pair(o, dequant(acc[0], sw0, si, b0, per_image, has_bias),
                       dequant(acc[1], sw1, si, b1, per_image, has_bias), (OutT*)nullptr);
            stage_pair(o + 8 * a.stage_pitch, dequant(acc[2], sw0, si, b0, per_image, has_bias),
                       dequant(acc[3], sw1, si, b1, per_image, has_bias), (OutT*)nullptr);
          }
        }
        __syncwarp();
        // the m-tile's rows, nts * 8 channels each, 16 bytes a lane
        const int valid = min(16, npx - mt * 16);
        uint8_t* o0 = reinterpret_cast<uint8_t*>(a.out) + ((m_base + mt * 16) * a.K + nt0 * 8) * kOut;
        int row = lane / cpr, c = lane - (lane / cpr) * cpr;
        for (int i = lane; i < valid * cpr; i += 32) {
          const uint4 v = *reinterpret_cast<const uint4*>(stage_w + row * a.stage_pitch + c * 16);
          *reinterpret_cast<uint4*>(o0 + (long long)row * a.K * kOut + c * 16) = v;
          c += 32;
          while (c >= cpr) {
            c -= cpr;
            ++row;
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();  // the slot is read by all before the next band's copy lands in it
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// the head

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
conv_s8_head_kernel(const ThinArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int PW = kTileW + a.ks - 1, PH = a.tile_rows + a.ks - 1;
  const int taps = a.ks * a.ks, chunks = (a.C + 31) / 32, CP = chunks * 32;  // a tap's 32-byte steps
  const int pp = a.C + 16, wp = taps * CP + 16;  // bytes of a staged pixel and of a staged weight row
  const int slice = a.tile_rows * 16 * 8;        // a warp's s32 sums: its rows x 16 pixels x 8 channels
  uint8_t* wsm = smem;
  float* sw_s = reinterpret_cast<float*>(smem + 8 * wp);
  float* bias_s = sw_s + 8;
  int* part = reinterpret_cast<int*>(bias_s + 8);
  uint8_t* patch = reinterpret_cast<uint8_t*>(part + kWarps * slice);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int bx = blockIdx.x % a.tiles_x, rest = blockIdx.x / a.tiles_x;
  const int by = rest % a.tiles_y, b = rest / a.tiles_y;
  const int ox0 = bx * kTileW, oy0 = by * a.tile_rows;
  const bool per_image = a.s_img != nullptr, has_bias = a.bias != nullptr;

  // the weights, each tap's C bytes padded to CP with zeros, rows K .. 7 zeros
  const int wcpr = wp / 16;  // 16-byte chunks of a staged row, its padding included
  for (int i = tid; i < 8 * wcpr; i += kThreads) {
    const int n = i / wcpr, c16 = (i - n * wcpr) * 16, tap = c16 / CP, c = c16 - tap * CP;
    uint8_t* dst = wsm + n * wp + c16;
    if (n < a.K && tap < taps && c < a.C)
      cp_async_16(smem_u32(dst), a.w + (long long)n * a.KRp + tap * a.C + c, true);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  // the patch: PH x PW pixels from (oy0 - pad, ox0 - pad), zeros outside the image; chunk i is chunk c of
  // pixel pix, walked without division
  {
    const int cpp = a.C >> 4, npix = PH * PW;
    const int dq = kThreads / cpp, dr = kThreads - dq * cpp;
    int pix = tid / cpp, c = tid - (tid / cpp) * cpp;
    int pr = pix / PW, pc = pix - pr * PW;
    const unsigned pbase = smem_u32(patch);
    while (pix < npix) {
      const int iy = oy0 - a.pad + pr, ix = ox0 - a.pad + pc;
      const bool ok = (unsigned)iy < (unsigned)a.H && (unsigned)ix < (unsigned)a.W;
      const int8_t* src = ok ? a.q + (((long long)b * a.H + iy) * a.W + ix) * a.C + c * 16 : a.q;
      cp_async_16(pbase + pix * pp + c * 16, src, ok);
      c += dr;
      pix += dq;
      pc += dq;
      if (c >= cpp) {
        c -= cpp;
        ++pix;
        ++pc;
      }
      while (pc >= PW) {
        pc -= PW;
        ++pr;
      }
    }
  }
  cp_async_commit();
  if (tid < 8) {
    sw_s[tid] = tid < a.K ? a.s_w[tid] : 0.f;
    bias_s[tid] = tid < a.K && has_bias ? a.bias[tid] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // Warps 0-3 take the tile's left 16 columns, 4-7 its right 16. A warp walks
  // units (kx, 32-byte step j of a tap's channels): it loads the A fragments
  // of the patch rows' 16 pixels once, then multiplies each by the weights of
  // taps (ky, kx), ky = 0 .. ks - 1, into output rows pr - ky: each staged
  // byte is read once a unit, not once a tap, and the mma of one ky follow
  // one another on different rows' sums.
  const int half = warp >> 2, units = a.ks * chunks;
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, hh = lane >> 4;  // this lane's ldmatrix row and half
  const unsigned lane_base = smem_u32(patch) + (16 * half + lr) * pp + 16 * hh;
  const unsigned row_step = PW * pp;
  int acc[kMaxTileRows][4];
#pragma unroll
  for (int r = 0; r < kMaxTileRows; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0;
  for (int u = warp & 3; u < units; u += 4) {
    const int kx = u / chunks, j = u - kx * chunks;
    const unsigned addr = lane_base + kx * pp + 32 * j;
    unsigned afr[kMaxTileRows + 2][4];
#pragma unroll
    for (int pr = 0; pr < kMaxTileRows + 2; ++pr)
      if (pr < PH) ldmatrix_x4(afr[pr], addr + pr * row_step);
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      if (ky < a.ks) {
        unsigned bfr[2];  // tap (ky, kx)
        const uint8_t* wrow = wsm + g * wp + (ky * a.ks + kx) * CP + 32 * j + 4 * t4;
        bfr[0] = *reinterpret_cast<const unsigned*>(wrow);
        bfr[1] = *reinterpret_cast<const unsigned*>(wrow + 16);
#pragma unroll
        for (int r = 0; r < kMaxTileRows; ++r)
          if (r < a.tile_rows) mma_tile(acc[r], afr[r + ky], bfr);
      }
    }
  }
  // the warp's partial sums into its own slice (the four warps of a half are added in the epilogue)
  int* mine = part + warp * slice;
#pragma unroll
  for (int r = 0; r < kMaxTileRows; ++r) {
    if (r < a.tile_rows) {
      *reinterpret_cast<int2*>(mine + (r * 16 + g) * 8 + 2 * t4) = make_int2(acc[r][0], acc[r][1]);
      *reinterpret_cast<int2*>(mine + (r * 16 + g + 8) * 8 + 2 * t4) = make_int2(acc[r][2], acc[r][3]);
    }
  }
  __syncthreads();

  // each output row of the tile: nx pixels x K values, one run, in 16-byte chunks
  constexpr int E = 16 / (int)sizeof(OutT);
  const float si = per_image ? a.s_img[b] : 1.f;
  const int nx = min(kTileW, a.W - ox0), V = nx * a.K;
  const int nch = (kTileW * a.K + E - 1) / E;
  for (int i = tid; i < a.tile_rows * nch; i += kThreads) {
    const int r = i / nch, v0 = (i - r * nch) * E;
    if (oy0 + r >= a.H || v0 >= V) continue;
    OutT* seg = static_cast<OutT*>(a.out) + (((long long)b * a.H + oy0 + r) * a.W + ox0) * a.K;
    float v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      v[e] = 0.f;
      if (v0 + e < V) {
        const int px = (v0 + e) / a.K, k = v0 + e - px * a.K;
        const int* s0 = part + (px >> 4) * 4 * slice + (r * 16 + (px & 15)) * 8 + k;
        const int sum = s0[0] + s0[slice] + s0[2 * slice] + s0[3 * slice];
        v[e] = dequant(sum, sw_s[k], si, bias_s[k], per_image, has_bias);
      }
    }
    if (v0 + E <= V && ((uintptr_t)(seg + v0) & 15) == 0) {
      store_vec(seg + v0, v);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (v0 + e < V) store_one(seg + v0 + e, v[e]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch

// the current device's SMs, read once a device
int sm_count() {
  static std::atomic<int> cached[64];
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  sms = cached[dev].load(std::memory_order_relaxed);
  if (sms == 0 && cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
    cached[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

// a kernel's opt-in to an SM's whole shared memory, once a device (done: the
// devices it was made on, one static a kernel); a launch's own size still
// sets its occupancy
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (rc == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return rc;
}

// as many blocks of the stem kernel as fit the SMs at once, or one a band
template <int KS, int NT, typename OutT>
int launch_stem_kernel(const ThinArgs& a, const StemTaps& taps, int smem, cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  auto kernel = conv_s8_stem_kernel<KS, NT, OutT>;
  cudaError_t rc = opt_in(kernel, done);
  if (rc != cudaSuccess) return (int)rc;
  int per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (rc != cudaSuccess) return (int)rc;
  const int grid = std::min(a.n_bands, std::max(1, per_sm) * std::max(1, sm_count()));
  kernel<<<grid, kThreads, smem, stream>>>(a, taps);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_stem(ThinArgs a, const int* host_taps, cudaStream_t stream) {
  const int KS = a.KRp / 32, ntiles = a.K / 8;
  const int nt_max = KS == 1 ? 32 : 8;  // B fragments in 64 or 32 registers a lane
  a.split = (ntiles + nt_max - 1) / nt_max;
  if (a.split > kWarps) return (int)cudaErrorInvalidValue;
  a.ntw = (ntiles + a.split - 1) / a.split;
  // rows of a band: 256 pixels or more, but at least a band an SM where the images are small
  const int sms = std::max(1, sm_count());
  a.band_rows = std::min(std::max(1, std::min((256 + a.W - 1) / a.W, (a.B * a.H) / sms)), a.H);
  a.bands_per_image = (a.H + a.band_rows - 1) / a.band_rows;
  a.n_bands = a.B * a.bands_per_image;
  const long long patch = (long long)(a.band_rows + 2 * a.pad) * a.W * a.C + 48;
  const long long stage_pitch = (long long)a.ntw * 8 * sizeof(OutT) + 16;
  if (patch > kMaxSmem) return (int)cudaErrorInvalidValue;
  a.patch_buf = align16((int)patch);
  const long long smem = align16((2 * a.K + kMaxKR) * 4) + 2LL * a.patch_buf + kWarps * 16 * stage_pitch;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  a.stage_pitch = (int)stage_pitch;
  StemTaps taps;
  for (int j = 0; j < kMaxKR; ++j) taps.e[j] = j < a.KRp ? host_taps[j] : (15 << 4) | 15;
  const int nt_pad = a.ntw <= 8 ? 8 : a.ntw <= 16 ? 16 : 32;
  if (KS == 1) {
    if (nt_pad == 8) return launch_stem_kernel<1, 8, OutT>(a, taps, (int)smem, stream);
    if (nt_pad == 16) return launch_stem_kernel<1, 16, OutT>(a, taps, (int)smem, stream);
    return launch_stem_kernel<1, 32, OutT>(a, taps, (int)smem, stream);
  }
  return launch_stem_kernel<2, 8, OutT>(a, taps, (int)smem, stream);
}

int head_smem(const ThinArgs& a, int rows) {
  const int wp = a.ks * a.ks * ((a.C + 31) / 32) * 32 + 16;
  return 8 * wp + 16 * 4 + kWarps * rows * 16 * 8 * 4 + (rows + a.ks - 1) * (kTileW + a.ks - 1) * (a.C + 16);
}

template <typename OutT>
int launch_head(ThinArgs a, cudaStream_t stream) {
  // the most rows (up to 8) that let two blocks share an SM; one row if even that does not
  a.tile_rows = 1;
  for (int rows = kMaxTileRows; rows > 1; --rows)
    if (head_smem(a, rows) <= kHeadBudget) {
      a.tile_rows = rows;
      break;
    }
  const int smem = head_smem(a, a.tile_rows);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  a.tiles_x = (a.W + kTileW - 1) / kTileW;
  a.tiles_y = (a.H + a.tile_rows - 1) / a.tile_rows;
  const long long blocks = (long long)a.B * a.tiles_y * a.tiles_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> done{0};
  auto kernel = conv_s8_head_kernel<OutT>;
  const cudaError_t rc = opt_in(kernel, done);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, H, W, C) s8, 16-byte aligned; w: (K, KRp) s8 rows (_pack_weights'),
// 16-byte aligned, KRp a multiple of 32 >= ks*ks*C; s_img (B,) f32 or null;
// s_w (K,) f32; bias (K,) f32 or null; out (B, H, W, K) in out_dtype (0 =
// float32, 1 = bfloat16), 16-byte aligned. Stride 1, padding (ks - 1) / 2.
// kind 0, the stem: ks*ks*C <= 64, K % 8 == 0, taps the KRp entries of
// ops/quant.py::stem_taps(C, ks, W) in host memory. kind 1, the head: C % 16
// == 0, K <= 8, ks 1 or 3, taps null. Returns a cudaError_t code (0 =
// launched).
extern "C" int gdc_conv_s8_thin(const void* q, const void* w, const void* s_img, const void* s_w, const void* bias,
                                void* out, int B, int H, int W, int C, int K, int ks, int KRp, int out_dtype,
                                int kind, const void* taps, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || K < 1 || ks < 1 || ks % 2 == 0 || KRp % 32 || KRp < ks * ks * C ||
      (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  ThinArgs a{};
  a.q = static_cast<const int8_t*>(q);
  a.w = static_cast<const int8_t*>(w);
  a.s_img = static_cast<const float*>(s_img);
  a.s_w = static_cast<const float*>(s_w);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.K = K;
  a.ks = ks;
  a.pad = (ks - 1) / 2;
  a.KRp = KRp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    if (KRp > kMaxKR || K % 8 || ks > 15 || taps == nullptr) return (int)cudaErrorInvalidValue;
    const int* t = static_cast<const int*>(taps);
    return out_dtype == 0 ? launch_stem<float>(a, t, st) : launch_stem<__nv_bfloat16>(a, t, st);
  }
  if (kind == 1) {
    if (C % 16 || K > 8 || (ks != 1 && ks != 3)) return (int)cudaErrorInvalidValue;
    return out_dtype == 0 ? launch_head<float>(a, st) : launch_head<__nv_bfloat16>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}
