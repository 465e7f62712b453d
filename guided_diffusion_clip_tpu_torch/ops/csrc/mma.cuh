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

}  // namespace gdc
