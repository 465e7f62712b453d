// Hand-issued tensor-core building blocks for sm_90a, shared by the kernels
// that run their products on mma.sync: K7 (mma_probe.cu), the bf16 attention
// kernels K1 and K2 (attention_fwd_mma.cu, attention_bwd_mma.cu) and, through
// conv_mma.cuh, the convolutions K5 and K6 (conv_s8_mma.cu, conv_fused.cu).
//
//   * mma_tile / mma_bf16: mma.sync.aligned m16n8k32 (s8, s32 sums) and
//     m16n8k16 (bf16, f32 sums);
//   * ldmatrix_x4 / ldmatrix_x4_trans: four 8 x 16-byte matrices from shared
//     memory into the fragment layout the mma takes (plain: a row of the
//     stored tile runs along the reduction; trans: a column does);
//   * cp_async_16 / cp_async_16_ca / cp_async_4, commit, wait: copies from
//     device memory to shared memory that need no register and no thread in
//     between, zero-filled where the source is out of range;
//   * pack_bf16x2 / split3_bf16x2: two f32 values rounded into one register
//     of two bf16, and the hi + mid + lo split that keeps all 24 mantissa bits
//     of an f32 operand across three mma;
//   * fast_exp2: ex2.approx, the exp of the softmax;
//   * copy_rows_async / scale_rows: a (rows x D) bf16 tile of a strided tensor
//     into padded shared rows, and the "(x * s).astype(bf16)" pass over a
//     landed tile.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4), which the
// attention kernels rely on to feed one product's sums to the next as its A
// operand without a trip through shared memory:
//   A (16 x 16): a0 = (row g, k 2t..2t+1), a1 = (row g+8, same k),
//                a2 = (row g, k 2t+8..2t+9), a3 = (row g+8, same k)
//   B (16 x 8):  b0 = (k 2t..2t+1, column g), b1 = (k 2t+8..2t+9, column g)
//   C (16 x 8):  c0, c1 = (row g, columns 2t, 2t+1), c2, c3 = (row g+8, same)
// so C of the n-tiles 2i and 2i+1, packed to bf16 pairs, is A of k-step i.
//
// The float32 attention kernels (attention_fwd_f32mma.cu, attention_bwd_f32mma.cuh) run m16n8k8 on TF32:
//   * mma_tf32: mma.sync.aligned m16n8k8 (tf32, f32 sums);
//   * split_tf32: x = big + small, two TF32 values, big = tf32(x), small =
//     tf32(x - big), each rounded to nearest with ties away from zero (cvt.rna)
//     and the 13 low bits cleared; x - big is exact in f32 and what small
//     drops is 2^-22 |x|. A product of two f32 operands is then
//     small*big + big*small + big*big (small*small, 2^-22 of it, is left out):
//     three mma for one, the last issued last;
//   * tf32_abt / tf32_xb: the two shapes of product that attention takes, with
//     f32 tiles in shared memory (rows of f32_pitch<D>() bytes) and the split
//     done in registers at the fragment load;
//   * copy_rows_f32_async / scale_rows_f32: copy_rows_async and scale_rows for
//     f32 rows.
// Fragment layouts of m16n8k8 on TF32 (g = lane / 4, t = lane % 4):
//   A (16 x 8):  a0 = (row g, k t), a1 = (row g+8, k t), a2 = (row g, k t+4), a3 = (row g+8, k t+4)
//   B (8 x 8):   b0 = (k t, column g), b1 = (k t+4, column g)
//   C (16 x 8):  c0, c1 = (row g, columns 2t, 2t+1), c2, c3 = (row g+8, same), as m16n8k16's
// An ldmatrix.x4 of 32-bit elements hands lane l the word l % 4 of row l / 4 of
// each 8 x 16-byte matrix, (row g, column t) of an 8 x 4 f32 block: A from
// four blocks, and B from a tile whose rows are B's columns (a key's d values
// in Q K^T), with the bf16 kernels' lane offsets. C's columns 2t and 2t+1 do
// not lie where A's k t and t+4 do, so C feeds the next product as A with the
// reduction index permuted: a0 = c0, a1 = c2, a2 = c1, a3 = c3 takes k t as
// column 2t and k t+4 as column 2t+1, and B's b0, b1 are then read from rows 2t
// and 2t+1 (ldmatrix cannot transpose 32-bit elements: two 4-byte loads).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gdc {

__device__ __forceinline__ void mma_tile(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tile(float (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  mma_bf16(c, a, b[0], b[1]);
}

// four 8 x 16-byte matrices; lanes 8i .. 8i+7 give the row addresses of matrix
// i; lane l receives the elements 2*(l%4), 2*(l%4)+1 of row l/4 of each
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the same, each matrix transposed on the way: lane l receives the elements
// of column l/4 in rows 2*(l%4) and 2*(l%4)+1
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from device memory to shared memory, both 16-byte aligned; zeros
// when !valid (src is then not read, but must still be an address)
__device__ __forceinline__ void cp_async_16(unsigned dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(__cvta_generic_to_global(src)), "r"(n)
               : "memory");
}

// the same through the L1 (.ca): for data that the same block, or its
// neighbour on the SM, asks for again soon (a conv's taps overlap)
__device__ __forceinline__ void cp_async_16_ca(unsigned dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(__cvta_generic_to_global(src)), "r"(n)
               : "memory");
}

// the same for 4 bytes, 4-byte aligned
__device__ __forceinline__ void cp_async_4(unsigned dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(dst), "l"(__cvta_generic_to_global(src)), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's committed groups are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" : : "n"(N) : "memory");
}

// {bf16(lo), bf16(hi)}, lo in the low half: the element of the smaller index
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// x = hi + mid + lo, three bf16 values that together hold x's 24 mantissa
// bits: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), both
// differences exact in f32; for two values at once. A product with an f32 left
// operand is then hi * B + mid * B + lo * B on the tensor cores, B being bf16
// already. (hi + mid alone leaves 2^-17 |x|, which showed as more last-place
// flips in the bf16 results than the f32 FMA kernel has.)
__device__ __forceinline__ void split3_bf16x2(float x0, float x1, unsigned& hi, unsigned& mid, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = *reinterpret_cast<const unsigned*>(&h);
  mid = *reinterpret_cast<const unsigned*>(&m);
  lo = pack_bf16x2(r0 - mf.x, r1 - mf.y);
}

// 2^x by the special-function unit (ex2.approx: relative error 2^-22; -inf
// gives 0). exp(a - b) is fast_exp2(fmaf(a, kLog2e, -b * kLog2e)): one FMA and
// one ex2 an element.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// bytes of one shared row of D bf16: 16 bytes of padding put the 8 rows of an
// ldmatrix matrix on distinct banks (D * 2 is a multiple of 128 at D = 64, 128
// and 256; at D = 96 and 192 a row is 52 and 100 words, and rows 0-7 start at
// banks 0, 20, 8, 28, 16, 4, 24, 12 and 0, 4, ..., 28: distinct 4-bank groups)
template <int D> __host__ __device__ constexpr int row_pitch() { return D * 2 + 16; }

// Rows [r0, r0 + ROWS) of a (T, D) bf16 matrix whose rows lie row_stride
// elements apart (src = row 0, 16-byte aligned, row_stride a multiple of 8)
// into shared rows of row_pitch<D>() bytes, 16 bytes a cp.async; rows past Tn
// become zeros. Thread t takes chunk t % (D / 8) of the rows t / (D / 8) +
// n * THREADS / (D / 8): the loop unrolls and the addresses are a shift and
// an add. Where THREADS is no multiple of D / 8 (D = 192: 24 chunks a row),
// thread t takes the chunks t + n * THREADS of the tile in row order. The
// chunks a thread copies are the chunks scale_rows hands it.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void copy_rows_async(unsigned dst, const __nv_bfloat16* src, long long row_stride,
                                                int r0, int Tn) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * CPR % THREADS == 0, "the block's passes cover the tile");
  if constexpr (THREADS % CPR == 0) {
    constexpr int RPP = THREADS / CPR;  // rows per pass of the block
    const int r = threadIdx.x / CPR, c = threadIdx.x % CPR;
#pragma unroll
    for (int n = 0; n < ROWS / RPP; ++n) {
      const int row = r + n * RPP;
      const bool in = r0 + row < Tn;
      cp_async_16(dst + row * row_pitch<D>() + c * 16, src + (in ? r0 + row : 0) * row_stride + c * 8, in);
    }
  } else {
#pragma unroll
    for (int n = 0; n < ROWS * CPR / THREADS; ++n) {
      const int i = threadIdx.x + n * THREADS, row = i / CPR, c = i % CPR;
      const bool in = r0 + row < Tn;
      cp_async_16(dst + row * row_pitch<D>() + c * 16, src + (in ? r0 + row : 0) * row_stride + c * 8, in);
    }
  }
}

// dst = bf16(float(src) * s), rounded once ("(x * s).astype(x.dtype)"), over a
// landed tile; dst may be src. A thread touches only the chunks it copied
// itself, so its own cp_async_wait is enough before it and a __syncthreads()
// after it publishes both.
__device__ __forceinline__ void scale_chunk(uint8_t* dst, const uint8_t* src, float s) {
  uint4 v = *reinterpret_cast<const uint4*>(src);
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(p[e]);
    p[e] = __floats2bfloat162_rn(f.x * s, f.y * s);
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void scale_rows(uint8_t* dst, const uint8_t* src, float s) {
  constexpr int CPR = D / 8;
  static_assert(ROWS * CPR % THREADS == 0, "the block's passes cover the tile");
  if constexpr (THREADS % CPR == 0) {
    constexpr int RPP = THREADS / CPR;
    const int off = (threadIdx.x / CPR) * row_pitch<D>() + (threadIdx.x % CPR) * 16;
#pragma unroll
    for (int n = 0; n < ROWS / RPP; ++n) {
      const int o = off + n * RPP * row_pitch<D>();
      scale_chunk(dst + o, src + o, s);
    }
  } else {
#pragma unroll
    for (int n = 0; n < ROWS * CPR / THREADS; ++n) {
      const int i = threadIdx.x + n * THREADS, off = (i / CPR) * row_pitch<D>() + (i % CPR) * 16;
      scale_chunk(dst + off, src + off, s);
    }
  }
}

// ---- float32 on the tensor cores: m16n8k8 TF32 with split operands ----

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cvt.rna.tf32.f32's rounding on the bits (ties away from zero: the sign is
// apart), with the low 13 bits zero: an f32 value that TF32 holds exactly
__device__ __forceinline__ unsigned tf32_bits(unsigned x) { return (x + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  big = tf32_bits(__float_as_uint(x));
  small = tf32_bits(__float_as_uint(x - __uint_as_float(big)));
}

// c[j0 + j] += a b[j] for one A fragment (split: big ab, small as) and N B
// fragments (split: bb, bs), term by term over the n-tiles: small*big for all
// N, then big*small, then big*big, so that consecutive mma write different
// accumulators (no mma waits on the one before it) and the big product, issued
// last, meets sums of the size it makes. j0 is a constant once the caller's
// loop is unrolled.
template <int N, int NC>
__device__ __forceinline__ void mma_split(float (&c)[NC][4], int j0, const unsigned (&ab)[4],
                                          const unsigned (&as)[4], const unsigned (&bb)[N][2],
                                          const unsigned (&bs)[N][2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j0 + j], as, bb[j][0], bb[j][1]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j0 + j], ab, bs[j][0], bs[j][1]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j0 + j], ab, bb[j][0], bb[j][1]);
}

// bytes of one shared row of D floats: 16 bytes of padding make the pitch
// 4 (mod 32) words at every D here, so the 8 rows of an ldmatrix matrix start
// on distinct 4-bank groups, and the 4-byte loads of tf32_xb (rows 2t, 2t + 1,
// column g) on 32 distinct banks (8t + g)
template <int D> __host__ __device__ constexpr int f32_pitch() { return D * 4 + 16; }

// copy_rows_async for f32: rows [r0, r0 + ROWS) of a (T, D) f32 matrix whose
// rows lie row_stride elements apart (src = row 0, 16-byte aligned, row_stride
// a multiple of 4) into shared rows of f32_pitch<D>() bytes; rows past Tn
// become zeros. Thread t copies the chunks t + n * THREADS of the tile in row
// order, the chunks scale_rows_f32 hands it. The source address advances by a
// pointer step (by whole rows where THREADS is a multiple of the D / 4 chunks
// of a row), so that no offsets are kept in registers across the calls.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void copy_rows_f32_async(unsigned dst, const float* src, long long row_stride, int r0,
                                                    int Tn) {
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  static_assert(ROWS * CPR % THREADS == 0, "the block's passes cover the tile");
  if constexpr (THREADS % CPR == 0) {
    constexpr int RPP = THREADS / CPR;  // rows a pass of the block
    int row = threadIdx.x / CPR;
    const int c = threadIdx.x % CPR;
    const float* p = src + (r0 + row) * row_stride + c * 4;
    unsigned d = dst + row * f32_pitch<D>() + c * 16;
#pragma unroll 4
    for (int n = 0; n < ROWS / RPP; ++n) {
      const bool in = r0 + row < Tn;
      cp_async_16(d, in ? p : src, in);
      row += RPP;
      p += RPP * row_stride;
      d += RPP * f32_pitch<D>();
    }
  } else {
#pragma unroll 4
    for (int n = 0; n < ROWS * CPR / THREADS; ++n) {
      const int i = threadIdx.x + n * THREADS, row = i / CPR, c = i % CPR;
      const bool in = r0 + row < Tn;
      cp_async_16(dst + row * f32_pitch<D>() + c * 16, src + (in ? r0 + row : 0) * row_stride + c * 4, in);
    }
  }
}

// x *= s over a landed f32 tile, one f32 rounding ("(x * s).astype(f32)"); a
// thread touches the chunks it copied itself, so its own cp_async_wait is
// enough before it and a __syncthreads() after it publishes both
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void scale_rows_f32(uint8_t* tile, float s) {
  constexpr int CPR = D / 4;
#pragma unroll 4
  for (int n = 0; n < ROWS * CPR / THREADS; ++n) {
    const int i = threadIdx.x + n * THREADS;
    float4* p = reinterpret_cast<float4*>(tile + (i / CPR) * f32_pitch<D>() + (i % CPR) * 16);
    float4 v = *p;
    v.x *= s;
    v.y *= s;
    v.z *= s;
    v.w *= s;
    *p = v;
  }
}

// acc = A B^T for the warp's 16 rows of A (D wide) against NT n-tiles of 8
// rows of B (D wide), both f32 tiles of f32_pitch<D>() rows in shared memory:
// `a` and `b` are shared addresses with ldmatrix's lane offsets (a_off, b_off
// of the bf16 kernels) included. B's values are multiplied by `sb` first when
// SCALE_B (an operand needed both scaled and not). A group of four n-tiles
// whose rows all lie at or past `live` (rows past T only) is left at zero.
template <int D, int NT, bool SCALE_B>
__device__ __forceinline__ void tf32_abt(unsigned a, unsigned b, float sb, int live, float (&acc)[NT][4]) {
  constexpr int PITCH = f32_pitch<D>();
  constexpr int G = NT < 4 ? NT : 4;  // n-tiles a group: one A fragment against G B fragments, term by term
  static_assert(NT % 2 == 0 && NT % G == 0, "ldmatrix.x4 brings B for two n-tiles");
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    unsigned fa[4], ab[4], as[4];
    ldmatrix_x4(fa, a + kk * 32);
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(fa[e]), ab[e], as[e]);
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += G) {
      if (8 * j0 >= live) break;
      unsigned bb[G][2], bs[G][2];
#pragma unroll
      for (int jp = 0; jp < G / 2; ++jp) {
        unsigned r[4];
        ldmatrix_x4(r, b + (j0 / 2 + jp) * 16 * PITCH + kk * 32);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float f = SCALE_B ? __uint_as_float(r[e]) * sb : __uint_as_float(r[e]);
          split_tf32(f, bb[2 * jp + e / 2][e % 2], bs[2 * jp + e / 2][e % 2]);
        }
      }
      mma_split<G>(acc, j0, ab, as, bb, bs);
    }
  }
}

// acc += x B for the warp's 16 rows: x holds f32 sums as C fragments of NT
// n-tiles, the reduction running over their 8 * NT columns; B is an
// (8 * NT) x D f32 tile in shared memory whose rows run along the reduction,
// `b` the lane's element (row 2t, column g) of it. k-step kk takes x's n-tile
// kk as A in the permuted order (a0 = c0, a1 = c2, a2 = c1, a3 = c3), so B's
// b0 and b1 come from rows 2t and 2t + 1. Each tile's product is summed on its
// own, 32 columns at a time (16 above D = 128), and added to acc on the FMA pipes (rounded to
// nearest): the tensor cores truncate as they add to their accumulator, and
// over a whole row of tiles that bias would grow. k-steps from `live8` on
// (x's columns past T only, all zero) are skipped.
template <int D, int NT>
__device__ __forceinline__ void tf32_xb(const float (&x)[NT][4], const float* b, int live8, float (&acc)[D / 8][4]) {
  constexpr int P = D + 4;  // floats a shared row
  // columns of acc a pass: four n-tiles, one A fragment against four B; above D = 128 two (32 spilled in K2's
  // dQ kernel at D = 192)
  constexpr int CW = D > 128 ? 16 : 32;
  static_assert(D % CW == 0, "the passes cover acc's columns");
  unsigned xb[NT][4], xs[NT][4];
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    split_tf32(x[kk][0], xb[kk][0], xs[kk][0]);
    split_tf32(x[kk][2], xb[kk][1], xs[kk][1]);
    split_tf32(x[kk][1], xb[kk][2], xs[kk][2]);
    split_tf32(x[kk][3], xb[kk][3], xs[kk][3]);
  }
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += CW) {
    float part[CW / 8][4];
#pragma unroll
    for (int j = 0; j < CW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      if (kk >= live8) break;
      unsigned bb[CW / 8][2], bs[CW / 8][2];
#pragma unroll
      for (int j = 0; j < CW / 8; ++j) {
        const float* p = b + kk * 8 * P + c0 + 8 * j;
        split_tf32(p[0], bb[j][0], bs[j][0]);
        split_tf32(p[P], bb[j][1], bs[j][1]);
      }
      mma_split<CW / 8>(part, 0, xb[kk], xs[kk], bb, bs);
    }
#pragma unroll
    for (int j = 0; j < CW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c0 / 8 + j][e] += part[j][e];
  }
}

// cudaFuncSetAttribute(kern, MaxDynamicSharedMemorySize, bytes) once a device:
// `done` is the caller's, one array a kernel, so the attribute's host cost
// stays out of every launch after the first on a device
constexpr int kMaxDevices = 64;
template <typename Kernel>
__host__ int smem_attribute_once(bool (&done)[kMaxDevices], Kernel kern, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && done[dev]) return 0;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return (int)err;
}

}  // namespace gdc
