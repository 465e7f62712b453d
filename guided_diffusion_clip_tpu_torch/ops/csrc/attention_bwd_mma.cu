// Fused QKV self-attention backward (kernel K2) on the tensor cores, for bf16
// inputs and head widths 32, 64, 128, 192 and 256, on Hopper (sm_90a).
//
// Replaces guided_diffusion_clip_tpu/ops/pallas_attention.py::_attn_bwd_kernel
// (reached via _flash_bwd, the custom VJP of K1), as attention_bwd.cu does on
// the f32 FMA pipes for float32 inputs. Given qkv and the output cotangent
// dO, per (batch, head)
//     dV = P^T dO,   dP = dO V^T,   dS = P o (dP - rowsum(dP o P)),
//     dQ = dS K s^2,   dK = dS^T Q s^2,        s = d^-1/4,
// with the TPU kernel's numerics: the logits are f32 sums of products of q*s
// and k*s each rounded to bf16, P stays f32 (it is not rounded before P^T dO),
// dP, dS and every sum are f32, and dQ, dK and dV are cast once at the end.
//
// What bounds it on the H100: 15 products of 2*T*T*d operations a head (below)
// against 8*T*d elements moved, so at the classifier's T = 1024, d = 64 it is
// bound by the tensor cores and by the shared-memory bandwidth that feeds
// mma.sync; on the FMA pipes it ran at 1 % of what the tensor cores do.
//
// What the design does about it:
//   * every product is mma.sync m16n8k16 bf16 with f32 sums, its operands
//     bf16 tiles in shared memory, copied by cp.async (16 bytes a thread, in
//     place through qkv's strides, rows past T zero-filled, the streamed side
//     double-buffered) and loaded as fragments by ldmatrix.x4: plain where the
//     stored row runs along the reduction (K in Q K^T, V in dO V^T, Q in K Q^T,
//     dO in V dO^T), .trans where the stored column does (K in dS K, dO in
//     P^T dO, Q in dS^T Q);
//   * S and dP have bf16 operands on both sides (q*s, k*s, dO and V are bf16
//     values), so the tensor cores give them exactly, up to the order of the
//     f32 sum. P and dS are f32 and are the left operand of the other three
//     products. Rounding them to bf16 would break the contract (an error of
//     2e-3 * max|ref|), so each is split in registers into three bf16 values,
//     hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), and the
//     product issued three times, (hi + mid + lo) * B: all 24 mantissa bits for
//     three mma in place of one. Two terms (3e-6 * max|ref|) were tried first
//     and gave 5x the last-place flips of the bf16 results against the plain
//     version; the tensor cores have the room;
//   * the tensor cores truncate when they add into their accumulator, a bias
//     that grows with the length of the chain of mma. dQ, dK and dV would be
//     chains of hundreds (every tile of a row), so each tile's product is
//     summed on its own (12 mma deep) and added to the running sum on the FMA
//     pipes, rounded to nearest. With both, the results differ from the plain
//     version's in about twice as many last places as the FMA kernel's do, and
//     by no more;
//   * the f32 sums of two neighbouring n-tiles of S are the A operand of one
//     k-step of the next product, so P, dS, P^T and dS^T never go through
//     shared memory; a row's statistics are reduced over the 4 lanes of a quad;
//   * the structure that gives the same bits every run stays: GPU blocks run
//     in no order and float atomics would make dK and dV differ from run to
//     run, so there are two kernels and every output element is written once.
//       A, Q-stationary (one block a q-tile of 64 rows, 16 a warp): sweep 1
//         over the K/V tiles forms each row's max m, sum l and rowsum(dP o P)
//         (as sum_j exp(s_ij - m) dP_ij, rescaled online like l and divided by
//         l at the end: from f32 P and dP, not from dO.O). Sweep 2 recomputes
//         S and dP, forms dS and accumulates dQ. It leaves m log2(e), 1/l and
//         the rowsum in `stats` for kernel B;
//       B, K/V-stationary (one block a key tile of 64 rows): loops over the
//         q-tiles, recomputes P^T and dP^T from the saved statistics (copied
//         by cp.async with the tile, zero past T, which makes P^T = dS^T = 0
//         for a query column past T), and accumulates dK and dV.
//     Products a head: A 2 + 2 + 3 (dS K three times), B 2 + 3 (P^T dO) + 3
//     (dS^T Q) = 15 of 2*T*T*d. A single pass with fewer products would need
//     dQ summed across key blocks by atomics, or O and the forward's l as
//     inputs, which the TPU kernel does not take;
//   * the stationary operands' fragments are reloaded by ldmatrix at each use
//     (one in nine of a tile's loads) rather than held, which keeps kernel B
//     (dK, dV, S^T and dP^T in registers) free of spills at d = 32 and 64
//     (244 registers at 64). At d = 128 the streamed tile is 32 rows for the
//     same reason, and ptxas still reports 255 registers and 16 bytes of
//     spills a thread; a partial sum of 32 columns in place of 64 did not
//     remove them;
//   * at d = 192 and 256 (the 128 px training recipe's one-head attention)
//     kernel A holds dQ (D / 2 registers) and streams 32 rows, as at d = 128
//     (16 at d = 256, where 32 spilled). Kernel B cannot hold dK and dV in
//     one warp (D registers a thread beside S^T and dP^T), so its block has 8
//     warps and two roles: warps 0-3 hold dV of their 16 key rows and form
//     S^T and the three products of P^T dO (4 products), warps 4-7 hold dK
//     and form S^T, dP^T and the three of dS^T Q (5). S^T is formed twice (16
//     products a head where the other widths take 15), but both roles read
//     the same K, V and streamed Q, dO tiles from one block's shared memory,
//     and a warp's critical path is 5 products, as in a split of D's columns
//     between two warps that would both form S^T and dP^T (10 products a
//     tile, not 9). A dV kernel and a dK kernel would copy the streamed tiles
//     twice; f32 sums of dK and dV in shared memory (128 KB at d = 256) would
//     leave one block an SM and add a read and a write of the sums to every
//     product;
//   * exp(s - m) is ex2.approx(s log2(e) - m log2(e)), one FMA and one
//     special-function op, three times a logit (sweep 1, sweep 2, kernel B):
//     relative error 2^-22 plus the FMA's rounding of the argument, ~1e-6 of a
//     weight, of the order of f32's own rounding and far below the bf16 cast
//     of the results;
//   * keys past T are masked to -inf in sweep 1 and their dS set to 0 in sweep
//     2; zero-filled rows keep 0 * 0; rows past T are computed and not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using namespace gdc;

constexpr int kThreads = 128;  // 4 warps
constexpr int kBR = 64;        // stationary rows per block, 16 a warp

template <int D> struct Tile {
  static constexpr int BS = D <= 64 ? 64 : 32;  // streamed rows per tile
  // kernel A's: at D = 256, 32 rows spilled 8 bytes (dQ is 128 registers; 32-column partial sums
  // did not help), 16 do not, and its shared memory (110 KB) then holds two blocks an SM. At
  // D = 192, 16 rows measured 3-5 % slower than 32.
  static constexpr int BS_A = D > 192 ? 16 : BS;
  // kernel B: dK and dV in one warp up to D = 128; above, a dV warp and a dK warp for each 16 key rows
  static constexpr bool SPLIT_B = D > 128;
  static constexpr int THREADS_B = SPLIT_B ? 256 : 128;
  static constexpr int PITCH = row_pitch<D>();
  static constexpr int ST_BYTES = kBR * PITCH;  // a stationary tile
  static constexpr int SR_BYTES = BS * PITCH;   // a streamed tile
  static constexpr int STAT_BYTES = 3 * BS * 4; // m, 1/l, rowsum of a streamed q-tile
  static constexpr int SR_A_BYTES = BS_A * PITCH;  // a streamed tile of kernel A
  // A: round(q s), dO | two stages of (k, v) | round(k s)
  static constexpr int smem_a = 2 * ST_BYTES + 5 * SR_A_BYTES;
  // B: round(k s), v | two stages of (q, dO) | round(q s) | two stages of the statistics
  static constexpr int smem_b = 2 * ST_BYTES + 5 * SR_BYTES + 2 * STAT_BYTES;
};

// Strides shared by both kernels. qkv and dqkv: (B, T, 3C), row stride 3C;
// for head h, q starts at channel h*head_stride, k at that + part_stride, v at
// that + 2*part_stride (legacy order: head_stride 3D, part_stride D; new
// order: D and C). dO: (B, T, C), head h at channel h*D.
struct Layout {
  int Tn, H, head_stride, part_stride;
  float scale, scale2;  // s = d^-1/4 and s^2
};

// The two products with bf16 operands on both sides, for the warp's 16 rows
// of the stationary tiles a1 and a2 against NT n-tiles of the streamed b1 and
// b2: s = a1 b1^T, t = a2 b2^T (shared addresses, the lane offsets included).
template <int D, int NT>
__device__ __forceinline__ void two_products(unsigned a1, unsigned b1, unsigned a2, unsigned b2,
                                             float (&s)[NT][4], float (&t)[NT][4]) {
  constexpr int PITCH = row_pitch<D>();
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = t[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned fa[4], fc[4];
    ldmatrix_x4(fa, a1 + kk * 32);
    ldmatrix_x4(fc, a2 + kk * 32);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      unsigned r[4];
      ldmatrix_x4(r, b1 + jp * 16 * PITCH + kk * 32);
      mma_bf16(s[2 * jp], fa, r[0], r[1]);
      mma_bf16(s[2 * jp + 1], fa, r[2], r[3]);
      ldmatrix_x4(r, b2 + jp * 16 * PITCH + kk * 32);
      mma_bf16(t[2 * jp], fc, r[0], r[1]);
      mma_bf16(t[2 * jp + 1], fc, r[2], r[3]);
    }
  }
}

// s = a1 b1^T alone, as two_products
template <int D, int NT>
__device__ __forceinline__ void one_product(unsigned a1, unsigned b1, float (&s)[NT][4]) {
  constexpr int PITCH = row_pitch<D>();
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned fa[4];
    ldmatrix_x4(fa, a1 + kk * 32);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      unsigned r[4];
      ldmatrix_x4(r, b1 + jp * 16 * PITCH + kk * 32);
      mma_bf16(s[2 * jp], fa, r[0], r[1]);
      mma_bf16(s[2 * jp + 1], fa, r[2], r[3]);
    }
  }
}

// acc += x b for the warp's 16 rows of the f32 x (NT n-tiles of sums, the
// reduction's length) and the streamed bf16 tile b, (8 * NT) x D, whose rows
// run along the reduction (`b`: its shared address with the .trans lane
// offset): x goes in as hi + mid + lo, three mma for one.
template <int D, int NT>
__device__ __forceinline__ void split_product(const float (&x)[NT][4], unsigned b, float (&acc)[D / 8][4]) {
  constexpr int PITCH = row_pitch<D>();
  constexpr int CW = D < 64 ? D : 64;  // columns of acc at a time: wider spills more at D = 128
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += CW) {
    // The tile's product is summed on its own and added to acc by the FMA
    // pipes (round to nearest): the tensor cores truncate when they add to
    // their accumulator, and over the hundreds of mma of a whole row of tiles
    // that bias grows to ~1e-5 of the sum.
    float part[CW / 8][4];
#pragma unroll
    for (int j = 0; j < CW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      unsigned hi[4], mid[4], lo[4];
      split3_bf16x2(x[2 * kk][0], x[2 * kk][1], hi[0], mid[0], lo[0]);
      split3_bf16x2(x[2 * kk][2], x[2 * kk][3], hi[1], mid[1], lo[1]);
      split3_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], mid[2], lo[2]);
      split3_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], mid[3], lo[3]);
#pragma unroll
      for (int jp = 0; jp < CW / 16; ++jp) {
        unsigned r[4];
        ldmatrix_x4_trans(r, b + kk * 16 * PITCH + c0 * 2 + jp * 32);
        mma_bf16(part[2 * jp], lo, r[0], r[1]);
        mma_bf16(part[2 * jp + 1], lo, r[2], r[3]);
        mma_bf16(part[2 * jp], mid, r[0], r[1]);
        mma_bf16(part[2 * jp + 1], mid, r[2], r[3]);
        mma_bf16(part[2 * jp], hi, r[0], r[1]);
        mma_bf16(part[2 * jp + 1], hi, r[2], r[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < CW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c0 / 8 + j][e] += part[j][e];
  }
}

// The warp's 16 x D sums, times `mul`, cast to bf16, to rows row0 + g and
// row0 + g + 8 of a matrix whose rows lie row_stride elements apart.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long row_stride, int row0, int Tn,
                                           const float (&acc)[D / 8][4], float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + (lane >> 2) + 8 * hh;
    if (r >= Tn) continue;
    __nv_bfloat16* row = dst + r * row_stride + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * hh] * mul, acc[j][2 * hh + 1] * mul);
  }
}

// Kernel A: grid (ceil(T / 64), B * H). Writes dQ and the row statistics
// stats[0] = m log2(e), stats[1] = 1 / l, stats[2] = rowsum(dP o P), each
// (B * H, T).
template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_mma_dq_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
                            __nv_bfloat16* __restrict__ dqkv, float* __restrict__ stats, Layout L) {
  using P = Tile<D>;
  constexpr int PITCH = P::PITCH, BS = P::BS_A, NT = BS / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* Qs = smem;                       // round(q s), scaled in place
  uint8_t* dOs = Qs + P::ST_BYTES;
  uint8_t* KV = dOs + P::ST_BYTES;          // stage i: k at i * 2 * SR_A_BYTES, v after it
  uint8_t* Ks = KV + 4 * P::SR_A_BYTES;     // round(k s) of the tile in work

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / L.H;
  const int h = bh - b * L.H;
  const int q0 = blockIdx.x * kBR;
  const int Tn = L.Tn;
  const long long row_stride = 3LL * L.H * D;
  const long long C = (long long)L.H * D;
  const long long qoff = (long long)b * Tn * row_stride + (long long)h * L.head_stride;
  const __nv_bfloat16* base = qkv + qoff;
  const __nv_bfloat16* obase = dout + (long long)b * Tn * C + (long long)h * D;
  const unsigned kv_s = smem_u32(KV);
  const int ntiles = (Tn + BS - 1) / BS;

  // step i of the two sweeps works on key tile i % ntiles in stage i & 1
  auto load_kv = [&](int i) {
    const int k0 = (i < ntiles ? i : i - ntiles) * BS;
    const unsigned dst = kv_s + (i & 1) * 2 * P::SR_A_BYTES;
    copy_rows_async<D, BS, kThreads>(dst, base + L.part_stride, row_stride, k0, Tn);
    copy_rows_async<D, BS, kThreads>(dst + P::SR_A_BYTES, base + 2 * L.part_stride, row_stride, k0, Tn);
    cp_async_commit();
  };
  copy_rows_async<D, kBR, kThreads>(smem_u32(Qs), base, row_stride, q0, Tn);
  copy_rows_async<D, kBR, kThreads>(smem_u32(dOs), obase, C, q0, Tn);
  load_kv(0);  // one group: Q, dO and the first K/V tile

  const unsigned a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * PITCH + (lane >> 4) * 16;  // A, and .trans B
  const unsigned b_off = ((lane & 7) + (lane >> 4) * 8) * PITCH + ((lane >> 3) & 1) * 16;  // plain B
  const unsigned q_a = smem_u32(Qs) + warp * 16 * PITCH + a_off;
  const unsigned do_a = smem_u32(dOs) + warp * 16 * PITCH + a_off;
  const unsigned ks_b = smem_u32(Ks) + b_off;

  // Land step i's tile, round k s into Ks, and form S = Qs Ks^T, dP = dO V^T
  // for the warp's rows. Ends with Ks and the stage in use: the caller's
  // barrier after its work frees them.
  auto tile_products = [&](int i, float (&s)[NT][4], float (&dp)[NT][4]) {
    if (i + 1 < 2 * ntiles) {
      load_kv(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const uint8_t* Kr = KV + (i & 1) * 2 * P::SR_A_BYTES;
    if (i == 0) scale_rows<D, kBR, kThreads>(Qs, Qs, L.scale);
    scale_rows<D, BS, kThreads>(Ks, Kr, L.scale);
    __syncthreads();
    const unsigned v_b = kv_s + (i & 1) * 2 * P::SR_A_BYTES + P::SR_A_BYTES + b_off;
    two_products<D, NT>(q_a, ks_b, do_a, v_b, s, dp);
  };

  float s[NT][4], dp[NT][4];
  // rows g and g + 8; the running max is kept as m log2(e), so that the
  // rescale 2^(m_old - m_new), the weights 2^(s log2(e) - m) of both sweeps and
  // kernel B's all use the same value
  float m[2], l[2], acc[2];
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = acc[0] = acc[1] = 0.f;

  // sweep 1: row max m, sum l and rowsum(dP o P), online over the key tiles
  for (int i = 0; i < ntiles; ++i) {
    tile_products(i, s, dp);
    const int k0 = i * BS;
    if (k0 + BS > Tn) {  // keys past T leave the softmax (their dP is 0: v is zero-filled)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t4 + (e & 1) >= Tn) s[j][e] = -INFINITY;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx * kLog2e);  // finite: key k0 is always a real one
      const float alpha = fast_exp2(m[hh] - m_new);
      float sum = 0.f, sdp = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const float p = fast_exp2(fmaf(s[j][e], kLog2e, -m_new));
          sum += p;
          sdp = fmaf(p, dp[j][e], sdp);
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sdp += __shfl_xor_sync(0xffffffffu, sdp, 1);
      sdp += __shfl_xor_sync(0xffffffffu, sdp, 2);
      l[hh] = l[hh] * alpha + sum;
      acc[hh] = acc[hh] * alpha + sdp;
      m[hh] = m_new;
    }
    __syncthreads();
  }

  float rinv[2], rs[2];
  const long long nrow = (long long)gridDim.y * Tn;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rinv[hh] = 1.f / l[hh];
    rs[hh] = acc[hh] / l[hh];
    const int q = q0 + warp * 16 + g + 8 * hh;
    if (t4 == 0 && q < Tn) {
      const long long o = (long long)bh * Tn + q;
      stats[o] = m[hh];
      stats[nrow + o] = rinv[hh];
      stats[2 * nrow + o] = rs[hh];
    }
  }

  // sweep 2: dS = P o (dP - rowsum), dQ += dS K
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  for (int i = ntiles; i < 2 * ntiles; ++i) {
    tile_products(i, s, dp);
    const int k0 = (i - ntiles) * BS;
    const bool ragged = k0 + BS > Tn;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const float p = fast_exp2(fmaf(s[j][e], kLog2e, -m[hh])) * rinv[hh];
        const float ds = p * (dp[j][e] - rs[hh]);
        s[j][e] = ragged && k0 + 8 * j + 2 * t4 + (e & 1) >= Tn ? 0.f : ds;
      }
    split_product<D, NT>(s, kv_s + (i & 1) * 2 * P::SR_A_BYTES + a_off, dq);
    __syncthreads();
  }
  store_rows<D>(dqkv + qoff, row_stride, q0 + warp * 16, Tn, dq, L.scale2);
}

// Kernel B: grid (ceil(T / 64), B * H), Tile<D>::THREADS_B threads. Writes dK
// and dV of its key tile.
template <int D>
__global__ void __launch_bounds__(Tile<D>::THREADS_B)
attention_bwd_mma_dkv_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
                             __nv_bfloat16* __restrict__ dqkv, const float* __restrict__ stats, Layout L) {
  using P = Tile<D>;
  constexpr int PITCH = P::PITCH, BS = P::BS, NT = BS / 8, kThreadsB = P::THREADS_B;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* Ks = smem;                        // round(k s), scaled in place
  uint8_t* Vs = Ks + P::ST_BYTES;
  uint8_t* QO = Vs + P::ST_BYTES;            // stage i: q at i * 2 * SR_BYTES, dO after it
  uint8_t* Qs = QO + 4 * P::SR_BYTES;        // round(q s) of the tile in work
  float* St = reinterpret_cast<float*>(Qs + P::SR_BYTES);  // stage i: m log2(e), 1/l, rowsum at i * 3 * BS

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rows = P::SPLIT_B ? warp & 3 : warp;  // the warp's 16 key rows: rows * 16 of the tile
  const int t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / L.H;
  const int h = bh - b * L.H;
  const int k0 = blockIdx.x * kBR;
  const int Tn = L.Tn;
  const long long row_stride = 3LL * L.H * D;
  const long long C = (long long)L.H * D;
  const long long qoff = (long long)b * Tn * row_stride + (long long)h * L.head_stride;
  const __nv_bfloat16* base = qkv + qoff;
  const __nv_bfloat16* obase = dout + (long long)b * Tn * C + (long long)h * D;
  const long long nrow = (long long)gridDim.y * Tn;
  const float* srow = stats + (long long)bh * Tn;
  const unsigned qo_s = smem_u32(QO), st_s = smem_u32(St);
  const int ntiles = (Tn + BS - 1) / BS;

  auto load_q = [&](int it) {
    const int q0 = it * BS;
    const unsigned dst = qo_s + (it & 1) * 2 * P::SR_BYTES;
    copy_rows_async<D, BS, kThreadsB>(dst, base, row_stride, q0, Tn);
    copy_rows_async<D, BS, kThreadsB>(dst + P::SR_BYTES, obase, C, q0, Tn);
    for (int i = tid; i < 3 * BS; i += kThreadsB) {  // m, 1/l and the rowsum; zeros past T
      const int part = i / BS, q = q0 + i - part * BS;
      cp_async_4(st_s + ((it & 1) * 3 * BS + i) * 4, srow + part * nrow + (q < Tn ? q : 0), q < Tn);
    }
    cp_async_commit();
  };
  copy_rows_async<D, kBR, kThreadsB>(smem_u32(Ks), base + L.part_stride, row_stride, k0, Tn);
  copy_rows_async<D, kBR, kThreadsB>(smem_u32(Vs), base + 2 * L.part_stride, row_stride, k0, Tn);
  load_q(0);  // one group: K, V and the first q-tile

  const unsigned a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * PITCH + (lane >> 4) * 16;  // A, and .trans B
  const unsigned b_off = ((lane & 7) + (lane >> 4) * 8) * PITCH + ((lane >> 3) & 1) * 16;  // plain B
  const unsigned k_a = smem_u32(Ks) + rows * 16 * PITCH + a_off;
  const unsigned v_a = smem_u32(Vs) + rows * 16 * PITCH + a_off;
  const unsigned qs_b = smem_u32(Qs) + b_off;
  // above D = 128 warps 4-7 form dK and warps 0-3 dV; up to 128 every warp forms both
  const bool dk_warp = P::SPLIT_B && warp >= 4;

  float dk[P::SPLIT_B ? 1 : D / 8][4], dv[D / 8][4];  // SPLIT_B: dv holds the dK warps' dK
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[j][e] = 0.f;
  if constexpr (!P::SPLIT_B) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[j][e] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_q(it + 1);  // into the stage that the barrier ending the last iteration freed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const uint8_t* Qr = QO + (it & 1) * 2 * P::SR_BYTES;
    if (it == 0) scale_rows<D, kBR, kThreadsB>(Ks, Ks, L.scale);
    scale_rows<D, BS, kThreadsB>(Qs, Qr, L.scale);
    __syncthreads();
    const unsigned q_s = qo_s + (it & 1) * 2 * P::SR_BYTES, do_s = q_s + P::SR_BYTES;

    // S^T = Ks Qs^T and dP^T = V dO^T: the warp's 16 key rows x BS query columns (a dV warp
    // forms S^T alone)
    float st[NT][4], dpt[NT][4];
    if (P::SPLIT_B && !dk_warp) {
      one_product<D, NT>(k_a, qs_b, st);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[j][e] = 0.f;  // not read: P^T needs no dP^T
    } else {
      two_products<D, NT>(k_a, qs_b, v_a, do_s + b_off, st, dpt);
    }

    // P^T and dS^T from the columns' statistics. A query column past T has
    // q s = 0, m = 0 and 1/l = 0, so P^T = dS^T = 0 there.
    const float* Ms = St + (it & 1) * 3 * BS;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 mm = *reinterpret_cast<const float2*>(Ms + 8 * j + 2 * t4);
      const float2 rr = *reinterpret_cast<const float2*>(Ms + BS + 8 * j + 2 * t4);
      const float2 dd = *reinterpret_cast<const float2*>(Ms + 2 * BS + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        const float p = fast_exp2(fmaf(st[j][e], kLog2e, -(odd ? mm.y : mm.x))) * (odd ? rr.y : rr.x);
        if constexpr (P::SPLIT_B) {
          st[j][e] = dk_warp ? p * (dpt[j][e] - (odd ? dd.y : dd.x)) : p;  // a dK warp's st is dS^T
        } else {
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - (odd ? dd.y : dd.x));
        }
      }
    }
    if constexpr (P::SPLIT_B) {
      split_product<D, NT>(st, (dk_warp ? q_s : do_s) + a_off, dv);  // dK += dS^T Q, or dV += P^T dO
    } else {
      split_product<D, NT>(st, do_s + a_off, dv);  // dV += P^T dO
      split_product<D, NT>(dpt, q_s + a_off, dk);  // dK += dS^T Q
    }
    __syncthreads();  // this stage, Qs and the statistics are read; the next iteration may refill them
  }

  __nv_bfloat16* dbase = dqkv + qoff;
  if constexpr (P::SPLIT_B) {
    if (dk_warp) store_rows<D>(dbase + L.part_stride, row_stride, k0 + rows * 16, Tn, dv, L.scale2);
    else store_rows<D>(dbase + 2 * L.part_stride, row_stride, k0 + rows * 16, Tn, dv, 1.f);
  } else {
    store_rows<D>(dbase + L.part_stride, row_stride, k0 + rows * 16, Tn, dk, L.scale2);
    store_rows<D>(dbase + 2 * L.part_stride, row_stride, k0 + rows * 16, Tn, dv, 1.f);
  }
}

template <int D>
int launch(const void* qkv, const void* dout, void* dqkv, void* stats, int B, const Layout& L,
           cudaStream_t stream) {
  using P = Tile<D>;
  auto ka = attention_bwd_mma_dq_kernel<D>;
  auto kb = attention_bwd_mma_dkv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize, P::smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize, P::smem_b);
  if (err != cudaSuccess) return (int)err;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(dout);
  __nv_bfloat16* g = static_cast<__nv_bfloat16*>(dqkv);
  float* st = static_cast<float*>(stats);
  const dim3 grid((L.Tn + kBR - 1) / kBR, B * L.H);
  ka<<<grid, kThreads, P::smem_a, stream>>>(q, o, g, st, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kb<<<grid, P::THREADS_B, P::smem_b, stream>>>(q, o, g, st, L);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv, dqkv: (B, T, 3 * H * D); dout: (B, T, H * D); all bf16, contiguous and
// 16-byte aligned; stats: (3, B * H, T) f32 scratch; D in {32, 64, 128, 192,
// 256}. Returns a cudaError_t code (0 = both kernels launched).
extern "C" int gdc_attention_bwd_mma(const void* qkv, const void* dout, void* dqkv, void* stats, int B, int Tn,
                                     int H, int D, int new_order, float scale, float scale2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Layout L;
  L.Tn = Tn;
  L.H = H;
  L.head_stride = new_order ? D : 3 * D;
  L.part_stride = new_order ? H * D : D;
  L.scale = scale;
  L.scale2 = scale2;
  switch (D) {
    case 32: return launch<32>(qkv, dout, dqkv, stats, B, L, s);
    case 64: return launch<64>(qkv, dout, dqkv, stats, B, L, s);
    case 128: return launch<128>(qkv, dout, dqkv, stats, B, L, s);
    case 192: return launch<192>(qkv, dout, dqkv, stats, B, L, s);
    case 256: return launch<256>(qkv, dout, dqkv, stats, B, L, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
