// The implicit-GEMM mainloop that the two convolution kernels share: K5
// (conv_s8_mma.cu, s8 activations from device memory) and K6 (conv_fused.cu,
// f32/bf16 activations quantized or rounded on the way in).
//
// The product is M = B*Ho*Wo output pixels by N = K output channels, reduced
// over kh*kw*C. Both operands lie reduction-contiguous in shared memory: a
// row of the A tile is one output pixel (NHWC makes the channels of one tap
// of a pixel contiguous), a row of the B tile one output channel's (K, KRp)
// weight row as it is stored. That is the row.col form mma.sync takes, fed by
// ldmatrix.x4 as in mma_probe.cu; in bytes m16n8k32 (s8, s32 sums) and
// m16n8k16 (bf16, f32 sums) look the same, so one mainloop serves both.
//
//   * block tile BM x 128 (BM = 128, or 64 for layers with few pixels), the
//     warps 2 along M. K5 runs 4 warps a block, each (BM / 2) x 64: at BM =
//     128 32 mma per 8 ldmatrix.x4, which is what keeps the fragment loads
//     and the cp.async writes together (48 KB a stage) under the shared
//     memory's 128 bytes a clock for the ~400 clocks the stage's mma take
//     (8 warps of 64 x 32, 16 mma per 6 ldmatrix.x4 and 64 KB a stage,
//     measured a tenth slower). K6 keeps 8 warps: its gather holds a stage's
//     activations in registers, and half as many a thread;
//   * a ring of kStages stages of kBK = 64 reduction bytes in dynamic shared
//     memory, rows padded by 16 bytes so that the 8 rows of an ldmatrix
//     matrix fall in distinct banks; one __syncthreads() per stage;
//   * TapWalker: a thread copies the same 16-byte column of the same rows in
//     every stage, so where its next source lies is a running offset, with no
//     division in the loop;
//   * the sums leave through shared memory (the ring, reused): the mma C
//     fragment holds 2 adjacent channels a lane, the staged tile is stored 16
//     bytes a thread.

#pragma once

#include "mma.cuh"

namespace gdc {
namespace conv {

constexpr int kBN = 128;            // output channels per block
constexpr int kBK = 64;             // reduction bytes per stage
constexpr int kPitch = kBK + 16;    // bytes of one shared row
constexpr int kStages = 4;
constexpr int kCPR = kBK / 16;      // 16-byte chunks per row
constexpr int kSlabs = kBK / 32;    // 32-byte mma steps per stage
constexpr int kOutPitch = kBN + 8;  // 32-bit words of one staged output row
// rows of a tile that one pass of a block of THREADS covers, a thread a chunk
template <int THREADS> __host__ __device__ constexpr int rows_per_pass() { return THREADS / kCPR; }

template <int BM> __host__ __device__ constexpr int stage_bytes() { return (BM + kBN) * kPitch; }
template <int BM> __host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<BM>() > BM * kOutPitch * 4 ? kStages * stage_bytes<BM>() : BM * kOutPitch * 4;
}

__device__ __forceinline__ unsigned as_bits(int v) { return (unsigned)v; }
__device__ __forceinline__ unsigned as_bits(float v) { return __float_as_uint(v); }
template <typename Acc> __device__ __forceinline__ Acc from_bits(unsigned v);
template <> __device__ __forceinline__ int from_bits<int>(unsigned v) { return (int)v; }
template <> __device__ __forceinline__ float from_bits<float>(unsigned v) { return __uint_as_float(v); }

// Where a thread's 16-byte chunk of the reduction lies in the input: element
// r of the reduction is channel c = r % C of tap r / C = ky * ks + kx, at
// (ky * W + kx) * C + c elements past the pixel's first tap. advance() moves
// on by a stage's worth of elements.
struct TapWalker {
  int c, kx, tap, off;
  __device__ __forceinline__ void init(int r, int C, int ks, int W) {
    tap = r / C;
    c = r - tap * C;
    const int ky = tap / ks;
    kx = tap - ky * ks;
    off = (ky * W + kx) * C + c;
  }
  __device__ __forceinline__ void advance(int step, int C, int ks, int W) {
    c += step;
    off += step;
    while (c >= C) {  // the next tap is the next pixel in memory, but for the end of a kernel row
      c -= C;
      ++tap;
      if (++kx == ks) {
        kx = 0;
        off += (W - ks) * C;
      }
    }
  }
  // whether this tap of a pixel whose in-image taps are the bits of mask is to be read
  __device__ __forceinline__ bool inside(unsigned mask) const { return tap < 32 && ((mask >> (tap & 31)) & 1u); }
};

// bit ky * ks + kx for every tap of the pixel at (iy0 + ky, ix0 + kx) that lies in the image
__device__ __forceinline__ unsigned tap_mask(int iy0, int ix0, int H, int W, int ks) {
  unsigned mask = 0u;
  for (int ky = 0; ky < ks; ++ky)
    for (int kx = 0; kx < ks; ++kx)
      if ((unsigned)(iy0 + ky) < (unsigned)H && (unsigned)(ix0 + kx) < (unsigned)W) mask |= 1u << (ky * ks + kx);
  return mask;
}

// A warp's share of the block tile of a block of THREADS: its sums and where
// its fragments lie. The warps lie 2 along M and THREADS / 64 along N.
template <int BM, int THREADS, typename Acc> struct WarpTile {
  static constexpr int WN = THREADS / 64;   // warps along N
  static constexpr int MT = BM / 32;        // 16-row mma tiles along M
  static constexpr int NT = kBN / WN / 8;   // 8-column mma tiles along N
  Acc acc[MT][NT][4];
  unsigned a_off, b_off;  // of this lane's ldmatrix rows inside a stage
  int wm, wn;

  __device__ __forceinline__ void init() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    wm = (warp / WN) * (BM / 2);
    wn = (warp % WN) * (NT * 8);
    // A: matrices (rows 0-7, bytes 0-15), (rows 8-15, 0-15), (rows 0-7, 16-31), (rows 8-15, 16-31)
    a_off = (wm + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch + (lane >> 4) * 16;
    // B: (columns 0-7, bytes 0-15), (columns 0-7, 16-31), (columns 8-15, 0-15), (columns 8-15, 16-31)
    b_off = (BM + wn + (lane & 7) + (lane >> 4) * 8) * kPitch + ((lane >> 3) & 1) * 16;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  }

  __device__ __forceinline__ void load_slab(unsigned (&a)[MT][4], unsigned (&b)[NT][2], unsigned stage, int s) const {
#pragma unroll
    for (int i = 0; i < MT; ++i) ldmatrix_x4(a[i], stage + a_off + i * 16 * kPitch + s * 32);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      unsigned r[4];
      ldmatrix_x4(r, stage + b_off + j * 8 * kPitch + s * 32);
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    }
  }

  // acc += A B^T over one landed stage (stage: its shared-memory address)
  __device__ __forceinline__ void consume(unsigned stage) {
    // two register buffers: a slab's fragments load while the slab before it multiplies
    unsigned a[2][MT][4], b[2][NT][2];
    load_slab(a[0], b[0], stage, 0);
#pragma unroll
    for (int s = 0; s < kSlabs; ++s) {
      if (s + 1 < kSlabs) load_slab(a[(s + 1) & 1], b[(s + 1) & 1], stage, s + 1);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tile(acc[i][j], a[s & 1][i], b[s & 1][j]);
    }
  }

  // the sums into the staged (BM x kOutPitch) tile; lane (g, t) holds rows g
  // and g + 8, columns 2t and 2t + 1 of each 16 x 8 tile
  __device__ __forceinline__ void stage_out(uint8_t* smem) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    unsigned* st = reinterpret_cast<unsigned*>(smem);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        unsigned* o = st + (wm + i * 16 + g) * kOutPitch + wn + j * 8 + t4 * 2;
        *reinterpret_cast<uint2*>(o) = make_uint2(as_bits(acc[i][j][0]), as_bits(acc[i][j][1]));
        *reinterpret_cast<uint2*>(o + 8 * kOutPitch) = make_uint2(as_bits(acc[i][j][2]), as_bits(acc[i][j][3]));
      }
  }
};

// This thread's chunks of a stage's B tile: rows n0 + r + i * RPP of the
// (K, row_bytes) weight rows, bytes kb .. kb + 16, by cp.async; zeros past K
// or past the row's end. dst: the chunk of row r in the stage's B tile.
template <int THREADS>
__device__ __forceinline__ void load_b_chunks(unsigned dst, const uint8_t* w, long long row_bytes, int n0, int r,
                                              int kb, int K) {
  constexpr int RPP = rows_per_pass<THREADS>();
#pragma unroll
  for (int i = 0; i < kBN / RPP; ++i) {
    const int n = n0 + r + i * RPP;
    const bool v = n < K && kb < row_bytes;
    cp_async_16(dst + i * RPP * kPitch, v ? w + n * row_bytes + kb : w, v);
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                            pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The staged tile to out (M, K): a thread takes 16 bytes of one output row
// (4 f32 or 8 bf16 channels) of every PASS-th row from its first. row_fn(m)
// gives what the epilogue needs of an output pixel (its image's or band's
// scale), elem_fn(sum, that, s_w[n], bias[n]) the output value. Channels past
// K and rows past M are skipped; rows of a K that is no multiple of the 16
// bytes are stored one value at a time.
template <int BM, int THREADS, typename Acc, typename OutT, typename RowFn, typename ElemFn>
__device__ __forceinline__ void store_tile(const uint8_t* smem, OutT* out, const float* s_w, const float* bias,
                                           int m0, int n0, int M, int K, RowFn row_fn, ElemFn elem_fn) {
  constexpr int VEC = 16 / (int)sizeof(OutT);
  constexpr int TPR = kBN / VEC;       // threads per row
  constexpr int PASS = THREADS / TPR;  // rows that one pass of the block covers
  const int col = (threadIdx.x % TPR) * VEC;
  const int n = n0 + col;
  if (n >= K) return;
  float sw[VEC], bs[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    sw[e] = (s_w != nullptr && n + e < K) ? s_w[n + e] : 0.f;
    bs[e] = (bias != nullptr && n + e < K) ? bias[n + e] : 0.f;
  }
  const bool whole = K % VEC == 0;  // then n + VEC <= K, and every row starts on 16 bytes
  for (int row = threadIdx.x / TPR; row < BM && m0 + row < M; row += PASS) {
    const int m = m0 + row;
    const auto of_row = row_fn(m);
    const unsigned* src = reinterpret_cast<const unsigned*>(smem) + row * kOutPitch + col;
    float v[VEC];
#pragma unroll
    for (int e4 = 0; e4 < VEC; e4 += 4) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + e4);
      v[e4 + 0] = elem_fn(from_bits<Acc>(u.x), of_row, sw[e4 + 0], bs[e4 + 0]);
      v[e4 + 1] = elem_fn(from_bits<Acc>(u.y), of_row, sw[e4 + 1], bs[e4 + 1]);
      v[e4 + 2] = elem_fn(from_bits<Acc>(u.z), of_row, sw[e4 + 2], bs[e4 + 2]);
      v[e4 + 3] = elem_fn(from_bits<Acc>(u.w), of_row, sw[e4 + 3], bs[e4 + 3]);
    }
    OutT* o = out + (long long)m * K + n;
    if (whole) {
      store_vec(o, v);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (n + e < K) store_one(o + e, v[e]);
    }
  }
}

}  // namespace conv
}  // namespace gdc
