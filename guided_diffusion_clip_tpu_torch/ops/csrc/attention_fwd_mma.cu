// Fused QKV self-attention forward (kernel K1) on the tensor cores, for bf16
// inputs and head widths 32, 64, 96, 128, 192 and 256, on Hopper (sm_90a).
//
// Replaces guided_diffusion_clip_tpu/ops/pallas_attention.py::_attn_kernel
// (reached via _flash_bhtd / qkv_attention_pallas), as attention_fwd.cu does
// on the f32 FMA pipes for float32 inputs. Per (batch, head) and per tile of
// query rows
//     out = softmax((q*s)(k*s)^T) v,   s = d^-1/4,
// with the TPU kernel's numerics: q*s and k*s each rounded to bf16 before the
// product, the logits summed in f32, max/exp/sum in f32, the weights rounded
// to bf16 before P.V, P.V summed in f32, one cast at the end.
//
// What bounds it on the H100: 4*T*T*d operations a head against 4*T*d
// elements moved, so at the UNet's T = 1024, d = 64 it is bound by the tensor
// cores, and beside them by what a tile costs in other instructions: the
// softmax (max, exp, sum, rescale and pack, ~6 an element of S), the fragment
// loads, the copies and the k*s pass take more issue slots than the 64 mma a
// warp and tile. On the FMA pipes the same products ran at 2 % of what the
// tensor cores do. At the training recipe's T = 256, d = 192 and T = 64,
// d = 256 it is T / 2 operations a byte, under the ~295 at which the tensor
// cores, not the bytes, would bound it.
//
// What the design does about it:
//   * both products are mma.sync m16n8k16 bf16 with f32 sums. q*s and k*s are
//     exact bf16 values, so S is exact up to the order of the f32 sum;
//   * operands sit in shared memory as bf16 (half of f32's bytes and of its
//     fragment traffic), copied 16 bytes a thread by cp.async straight from
//     qkv, in place through strides in either head order: a head's row of d
//     bf16 is contiguous. Rows past T are zero-filled. K/V tiles (64 keys, 32
//     above D = 128) are double-buffered, so the next tile's copy runs under this tile's mma;
//   * k*s is one pass over the landed K tile (each thread rounds the chunks it
//     copied itself), q*s the same once;
//   * fragments come from ldmatrix.x4, plain for K (a key's d values run
//     along the reduction of Q K^T) and .trans for V (the keys do in P V);
//     rows are padded by 16 bytes, so an ldmatrix never meets a bank conflict;
//   * a warp owns 16 query rows. Up to D = 128 it keeps Q's fragments in
//     registers for the whole kernel. 32 rows a warp (one K or V fragment
//     feeding two mma, half the shared-memory bytes per mma) measured no
//     faster at T = 1024 and slower below: the softmax's arithmetic, not the
//     fragment traffic, is what the tensor cores wait for;
//   * at D = 192 and 256 (the 128 px training recipe's one-head attention)
//     Q's fragments (D / 4 registers) and O (D / 2) and S for 64 keys (32)
//     would not fit a thread's 255 registers beside the addresses. There Q's
//     fragments are reloaded by ldmatrix at each k-step (one more load for
//     every two mma of S), K/V tiles are 32 keys (S in 16 registers) and O
//     stays in registers: ~77 KB of shared memory at D = 192 and ~101 KB at
//     256, two blocks an SM. A block is 64 query rows (4 warps) or 32 (2
//     warps): the caller picks 32 where 64-row tiles would leave SMs idle
//     (T = 64 at batch 48 is 48 blocks of 64 rows on 132 SMs);
//   * the f32 sums of two neighbouring n-tiles of S are, packed to bf16 pairs,
//     the A operand of one k-step of P V: P never goes through shared memory.
//     A row's max and sum are reduced over the 4 lanes of a quad;
//   * online softmax over the K/V tiles (running max m, sum l, rescaled O), so
//     shared memory is O(tile * d) at any T; keys past T are masked to -inf
//     before the max, query rows past T are computed and not stored;
//   * no atomics: one block a (q-tile, batch * head), every output element
//     written once, so repeat runs give the same bits.
// exp(s - m) is ex2.approx(s log2(e) - m log2(e)), one FMA and one special-
// function op a logit: its 2^-22 relative error and the FMA's rounding of the
// argument (~1e-6 of a weight) disappear in the rounding of the weights to
// bf16. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using namespace gdc;

template <int D> struct Tile {
  static constexpr bool HOLD_Q = D <= 128;  // Q's fragments stay in registers
  static constexpr int BK = HOLD_Q ? 64 : 32;  // keys per K/V tile
  static constexpr int PITCH = row_pitch<D>();
  static constexpr int KV_BYTES = BK * PITCH;
  // NW warps, 16 query rows each: Q, and two stages of K and V
  static constexpr int smem_bytes(int nw) { return 16 * nw * PITCH + 4 * KV_BYTES; }
};

// qkv: (B, T, 3C) with row stride 3C. For head h, q starts at channel
// h*head_stride, k at that + part_stride, v at that + 2*part_stride (legacy
// order: head_stride 3D, part_stride D; new order: D and C). out: (B, T, C).
template <int D, int NW>
__global__ void __launch_bounds__(32 * NW)
attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out, int Tn, int H,
                         int head_stride, int part_stride, float scale) {
  using P = Tile<D>;
  constexpr int PITCH = P::PITCH, kBK = P::BK, kBQ = 16 * NW, kThreads = 32 * NW;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* Qs = smem;
  uint8_t* KV = smem + kBQ * PITCH;  // stage i: K at i * 2 * KV_BYTES, V after it

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const long long row_stride = 3LL * H * D;
  const __nv_bfloat16* base = qkv + (long long)b * Tn * row_stride + (long long)h * head_stride;
  const unsigned q_s = smem_u32(Qs), kv_s = smem_u32(KV);
  const int ntiles = (Tn + kBK - 1) / kBK;

  auto load_kv = [&](int it) {
    const unsigned dst = kv_s + (it & 1) * 2 * P::KV_BYTES;
    copy_rows_async<D, kBK, kThreads>(dst, base + part_stride, row_stride, it * kBK, Tn);
    copy_rows_async<D, kBK, kThreads>(dst + P::KV_BYTES, base + 2 * part_stride, row_stride, it * kBK, Tn);
    cp_async_commit();
  };
  copy_rows_async<D, kBQ, kThreads>(q_s, base, row_stride, q0, Tn);
  load_kv(0);  // one group: Q and the first K/V tile

  // lane offsets of the ldmatrix addresses inside a tile:
  // A and the .trans B: matrices (rows 0-7, bytes 0-15), (rows 8-15, 0-15), (rows 0-7, 16-31), (rows 8-15, 16-31)
  const unsigned a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * PITCH + (lane >> 4) * 16;
  // the plain B: (rows 0-7, bytes 0-15), (rows 0-7, 16-31), (rows 8-15, 0-15), (rows 8-15, 16-31)
  const unsigned b_off = ((lane & 7) + (lane >> 4) * 8) * PITCH + ((lane >> 3) & 1) * 16;

  unsigned qf[P::HOLD_Q ? D / 16 : 1][4];  // above D = 128, the k-step's fragment only
  const unsigned q_a = q_s + warp * 16 * PITCH + a_off;
  float o[D / 8][4];
  // rows g and g + 8: the running max, kept as m log2(e) so that the rescale
  // 2^(m_old - m_new) and the weights 2^(s log2(e) - m_new) use the same value
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_kv(it + 1);  // into the stage that the barrier ending the last iteration freed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    uint8_t* Kt = KV + (it & 1) * 2 * P::KV_BYTES;
    if (it == 0) scale_rows<D, kBQ, kThreads>(Qs, Qs, scale);
    scale_rows<D, kBK, kThreads>(Kt, Kt, scale);
    __syncthreads();  // tile `it` has landed for every thread, K scaled
    if constexpr (P::HOLD_Q) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], q_a + kk * 32);
      }
    }
    const unsigned k_s = kv_s + (it & 1) * 2 * P::KV_BYTES, v_s = k_s + P::KV_BYTES;

    // S = (q s)(k s)^T: the warp's 16 rows x kBK keys
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if constexpr (!P::HOLD_Q) ldmatrix_x4(qf[0], q_a + kk * 32);
      const unsigned (&qa)[4] = qf[P::HOLD_Q ? kk : 0];
#pragma unroll
      for (int jp = 0; jp < kBK / 16; ++jp) {
        unsigned r[4];
        ldmatrix_x4(r, k_s + b_off + jp * 16 * PITCH + kk * 32);
        mma_bf16(s[2 * jp], qa, r[0], r[1]);
        mma_bf16(s[2 * jp + 1], qa, r[2], r[3]);
      }
    }

    const int k0 = it * kBK;
    if (k0 + kBK > Tn) {  // the ragged last tile: keys past T leave the softmax
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t4 + (e & 1) >= Tn) s[j][e] = -INFINITY;
    }

    // online softmax; a row's kBK logits lie in the 4 lanes of a quad
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx * kLog2e);  // finite: key k0 is always a real one
      const float alpha = fast_exp2(m[hh] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const float p0 = fast_exp2(fmaf(s[j][2 * hh], kLog2e, -m_new));
        const float p1 = fast_exp2(fmaf(s[j][2 * hh + 1], kLog2e, -m_new));
        sum += p0 + p1;
        s[j][2 * hh] = p0;
        s[j][2 * hh + 1] = p1;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hh] = l[hh] * alpha + sum;
      m[hh] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][2 * hh] *= alpha;
        o[j][2 * hh + 1] *= alpha;
      }
    }

    // O += P V, the weights rounded to bf16 as the A fragments
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      unsigned pf[4];
      pf[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jp = 0; jp < D / 16; ++jp) {
        unsigned r[4];
        ldmatrix_x4_trans(r, v_s + a_off + kk * 16 * PITCH + jp * 32);
        mma_bf16(o[2 * jp], pf, r[0], r[1]);
        mma_bf16(o[2 * jp + 1], pf, r[2], r[3]);
      }
    }
    __syncthreads();  // this stage's K and V are read; the next iteration may refill it
  }

  // out: (B, T, C), channel h*D + c (merge_heads order)
  const long long C = (long long)H * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int q = q0 + warp * 16 + g + 8 * hh;
    if (q >= Tn) continue;
    const float inv = 1.f / l[hh];
    __nv_bfloat16* orow = out + ((long long)b * Tn + q) * C + (long long)h * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[j][2 * hh] * inv, o[j][2 * hh + 1] * inv);
  }
}

template <int D, int NW>
int launch(const void* qkv, void* out, int B, int Tn, int H, int new_order, float scale, cudaStream_t stream) {
  constexpr int smem = Tile<D>::smem_bytes(NW);
  auto kern = attention_fwd_mma_kernel<D, NW>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int head_stride = new_order ? D : 3 * D;
  const int part_stride = new_order ? H * D : D;
  dim3 grid((Tn + 16 * NW - 1) / (16 * NW), B * H);
  kern<<<grid, 32 * NW, smem, stream>>>(static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
                                        Tn, H, head_stride, part_stride, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv: (B, T, 3 * H * D) bf16, out: (B, T, H * D) bf16, both contiguous and
// 16-byte aligned; D in {32, 64, 96, 128, 192, 256}; q_rows, the query rows of a
// block: 64, or at D = 192 and 256 also 32 (ops/attention.py::fwd_q_rows
// picks). Returns a cudaError_t code (0 = launched).
extern "C" int gdc_attention_fwd_mma(const void* qkv, void* out, int B, int Tn, int H, int D, int new_order,
                                     int q_rows, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_rows != 64 && !(q_rows == 32 && D > 128)) return (int)cudaErrorInvalidValue;
  const bool half = q_rows == 32;
  switch (D) {
    case 32: return launch<32, 4>(qkv, out, B, Tn, H, new_order, scale, s);
    case 64: return launch<64, 4>(qkv, out, B, Tn, H, new_order, scale, s);
    case 96: return launch<96, 4>(qkv, out, B, Tn, H, new_order, scale, s);
    case 128: return launch<128, 4>(qkv, out, B, Tn, H, new_order, scale, s);
    case 192: return half ? launch<192, 2>(qkv, out, B, Tn, H, new_order, scale, s)
                          : launch<192, 4>(qkv, out, B, Tn, H, new_order, scale, s);
    case 256: return half ? launch<256, 2>(qkv, out, B, Tn, H, new_order, scale, s)
                          : launch<256, 4>(qkv, out, B, Tn, H, new_order, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
