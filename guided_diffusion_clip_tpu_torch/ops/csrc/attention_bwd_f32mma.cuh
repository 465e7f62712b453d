// Fused QKV self-attention backward (kernel K2) on the tensor cores, for
// float32 inputs and head widths 32, 64, 96, 128, 192 and 256, on Hopper
// (sm_90a).
//
// Replaces guided_diffusion_clip_tpu/ops/pallas_attention.py::_attn_bwd_kernel
// (reached via _flash_bwd, the custom VJP of K1) for float32, as
// attention_bwd_mma.cu does for bf16; attention_bwd.cu, the first version on
// the f32 FMA pipes, stays built as a yardstick. Given qkv and the output
// cotangent dO, per (batch, head)
//     dV = P^T dO,   dP = dO V^T,   dS = P o (dP - rowsum(dP o P)),
//     dQ = dS K s^2,   dK = dS^T Q s^2,        s = d^-1/4,
// with the TPU kernel's numerics (attention_bwd.cu's contract): P recomputed
// in f32 from q*s and k*s (AttentionFunction saves qkv alone, as the TPU
// kernel's VJP does), dP, dS and every sum in f32, rowsum(dP o P) taken from
// the f32 P and dP (not from dO.O), each result rounded once at the end.
//
// What bounds it on the H100: the five products of 2*T*T*d a head that the
// function needs (S, dP, dV, dQ, dK) against 8*T*d elements moved, T * 5 / 16
// operations a byte of f32: from T ~ 100 on it is bound by the operations.
// Its users are the classifier's attention pool (T = 65, d = 64: one launch a
// guided step and a classifier training microbatch) and the 64 px quality
// proxies' f32 training and classifier gradient (d = 96, 128).
//
// What the design does about it:
//   * every product is mma.sync m16n8k8 on TF32 with both f32 operands split
//     in registers at their fragment load into big + small, three mma for one
//     (mma.cuh: split_tf32, tf32_abt, tf32_xb): 2^-22 relative, where one TF32
//     rounding would be ~5e-4 of the results. The tiles stay f32 in shared
//     memory (padded rows, no bank conflicts), copied by cp.async in place
//     through qkv's strides, the streamed side double-buffered; q*s or k*s of
//     a stationary tile is one pass over it, a streamed operand that is needed
//     both scaled and not is scaled at its fragment load;
//   * each tile's product into dQ, dK or dV is summed on its own and added to
//     the running sum on the FMA pipes: the tensor cores truncate as they
//     accumulate (attention_bwd_mma.cu);
//   * the sums of S and dP (and S^T, dP^T) feed the next product as its A
//     operand in registers, the reduction index permuted (mma.cuh), so P, dS
//     and their transposes never go through shared memory;
//   * the structure that gives the same bits every run stays: two kernels, no
//     float atomics, every output element written once.
//       A, Q-stationary: sweep 1 over the key tiles forms each row's max m,
//         sum l and rowsum(dP o P) (sum_j exp(s_ij - m) dP_ij rescaled online
//         like l, divided by l at the end); sweep 2 recomputes S and dP, forms
//         dS and sums dQ = dS K. It leaves m log2(e), 1/l and the rowsum in
//         `stats` for kernel B;
//       B, K/V-stationary: loops over the q-tiles, recomputes S^T and dP^T,
//         rebuilds P^T and dS^T from the saved statistics (zero past T: a query
//         column past T gets P^T = dS^T = 0), and sums dV = P^T dO and
//         dK = dS^T Q (above d = 64 a dV warp and a dK warp for each 16 key
//         rows);
//   * blocks as K1's (attention_fwd_f32mma.cu): R row groups of 16 stationary
//     rows times KS groups that split each streamed tile's rows (R * KS = 4;
//     64 stationary rows whole, 32 split in two, up to d = 64 16 split in
//     four), picked by ops/attention.py::f32_bwd_rows: 64 from T = 129 on
//     where their blocks give half the SMs one, else the split, so that
//     every SM gets a block where the grid allows. A's groups meet twice in shared memory,
//     after sweep 1 (every warp of a row group adds the groups' m, l and
//     rowsum in the same order) and after sweep 2 (dQ), B's once (dK, dV),
//     the first group adding the others in a fixed order: no atomics, the
//     same bits every run;
//   * products a head, each of 2*T*T*d and three mma: A 2 + 3 (S and dP in
//     each sweep, dQ), B 4 (S^T, dP^T, dV, dK), 9 against the function's 5; above d = 64
//     the dV warps form S^T as well, 10. Dropping sweep 2's S and dP would need
//     dQ summed across key blocks (atomics, or a T x T dS in device memory and
//     a third kernel), or rowsum(dO o O) from the forward, which the contract
//     excludes;
//   * streamed tiles: 64 rows up to d = 64, 32 at 96, 16 above, or 16 a
//     warp where the tile is split, so that up to d = 192 a block's shared
//     memory (at most ~105 KB) leaves two blocks an SM (133 KB at d = 256);
//   * keys past T are masked to -inf in sweep 1 and their dS set to 0 in sweep
//     2; groups of four n-tiles that hold only rows past T issue no mma, a
//     warp whose share of a tile holds none skips it, and a warp whose
//     stationary rows all lie past T joins the copies and barriers only;
//   * the dynamic shared-memory attribute is set once per kernel and device.

// This header holds both kernels; attention_bwd_f32mma.cu launches kernel A
// and holds the C entry point, attention_bwd_f32mma_dkv.cu launches kernel B:
// two sources, so that nvcc builds the two kernels' instantiations in
// parallel.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace gdc {
namespace f32attn {

template <int D, int KS> struct Tile {
  static constexpr int PITCH = f32_pitch<D>();
  // streamed rows a tile: with the tile whole 64 up to D = 64, 32 at 96, 16 above; split, 16 a warp (at
  // D = 64 kernel A spilled with 32 a warp)
  static constexpr int BS = KS > 1 ? 16 * KS : D <= 64 ? 64 : D <= 96 ? 32 : 16;
  static constexpr int WS = BS / KS;  // of them, a warp's share
  // kernel B: dK and dV in one warp up to D = 64; above, a dV warp and a dK warp for each 16 key rows
  static constexpr bool SPLIT_B = D > 64;
  static constexpr int SR_BYTES = BS * PITCH;    // a streamed tile
  static constexpr int STAT_BYTES = 3 * BS * 4;  // m, 1/l, rowsum of a streamed q-tile
  __host__ __device__ static constexpr int threads_b(int r) { return (SPLIT_B ? 64 : 32) * r * KS; }
  // A: q s, dO | two stages of (k, v) | with KS > 1, each warp's m, l, rowsum (2 rows x 32 lanes each)
  __host__ __device__ static constexpr int smem_a(int r) {
    return 2 * 16 * r * PITCH + 4 * SR_BYTES + (KS > 1 ? r * KS * 6 * 32 * 4 : 0);
  }
  // B: k s, v | two stages of (q, dO) | two stages of the statistics
  __host__ __device__ static constexpr int smem_b(int r) {
    return 2 * 16 * r * PITCH + 4 * SR_BYTES + 2 * STAT_BYTES;
  }
};

// Strides shared by both kernels. qkv and dqkv: (B, T, 3C), row stride 3C;
// for head h, q starts at channel h*head_stride, k at that + part_stride, v at
// that + 2*part_stride (legacy order: head_stride 3D, part_stride D; new
// order: D and C). dO: (B, T, C), head h at channel h*D.
struct Layout {
  int Tn, H, head_stride, part_stride;
  float scale, scale2;  // s = d^-1/4 and s^2
};

// ldmatrix lane offsets in a tile of f32_pitch<D>() rows: A (rows 0-7, 8-15 at bytes 0-15, then 16-31), and B
// (rows 0-7 at bytes 0-15, 16-31, then rows 8-15)
template <int D> __device__ __forceinline__ unsigned a_lane() {
  const int lane = threadIdx.x & 31;
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * f32_pitch<D>() + (lane >> 4) * 16;
}
template <int D> __device__ __forceinline__ unsigned b_lane() {
  const int lane = threadIdx.x & 31;
  return ((lane & 7) + (lane >> 4) * 8) * f32_pitch<D>() + ((lane >> 3) & 1) * 16;
}
// floats: the lane's (row 2t, column g) of a tile, tf32_xb's B
template <int D> __device__ __forceinline__ int xb_lane() {
  const int lane = threadIdx.x & 31;
  return 2 * (lane & 3) * (D + 4) + (lane >> 2);
}

// A warp's D / 2 sums a lane to slot `slot` of shared memory, [value][lane]
// (no bank conflicts), and their sum over `n` slots back in a fixed order.
template <int D> __device__ __forceinline__ void put_slot(float* slots, int slot, const float (&acc)[D / 8][4]) {
  float* w = slots + slot * (D / 2) * 32 + (threadIdx.x & 31);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) w[(4 * j + e) * 32] = acc[j][e];
}
template <int D>
__device__ __forceinline__ void add_slots(const float* slots, int slot0, int stride, int n, float (&acc)[D / 8][4]) {
  for (int k = 0; k < n; ++k) {
    const float* r = slots + (slot0 + k * stride) * (D / 2) * 32 + (threadIdx.x & 31);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += r[(4 * j + e) * 32];
  }
}

// The warp's 16 x D sums, times `mul`, to rows row0 + g and row0 + g + 8 of a
// matrix whose rows lie row_stride elements apart.
template <int D>
__device__ __forceinline__ void store_rows(float* dst, long long row_stride, int row0, int Tn,
                                           const float (&acc)[D / 8][4], float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + (lane >> 2) + 8 * hh;
    if (r >= Tn) continue;
    float* row = dst + r * row_stride + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) = make_float2(acc[j][2 * hh] * mul, acc[j][2 * hh + 1] * mul);
  }
}

// Kernel A: grid (ceil(T / (16 R)), B * H), 32 R KS threads; warp w takes the
// rows of row group w % R and the keys of group w / R of every key tile.
// Writes dQ and the row statistics stats[0] = m log2(e), stats[1] = 1 / l,
// stats[2] = rowsum(dP o P), each (B * H, T).
template <int D, int R, int KS>
__global__ void __launch_bounds__(32 * R * KS)
attention_bwd_f32mma_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                               float* __restrict__ dqkv, float* __restrict__ stats, Layout L) {
  using P = Tile<D, KS>;
  constexpr int PITCH = P::PITCH, BS = P::BS, WS = P::WS, NT = WS / 8, kBR = 16 * R, kThreads = 32 * R * KS;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* Qs = smem;  // q s, scaled in place
  uint8_t* dOs = Qs + kBR * PITCH;
  uint8_t* KV = dOs + kBR * PITCH;  // stage i: k at i * 2 * SR_BYTES, v after it
  float* stat_slots = reinterpret_cast<float*>(KV + 4 * P::SR_BYTES);  // KS > 1: each warp's m, l, rowsum

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rg = warp % R, kg = warp / R;  // the warp's row group and key group
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / L.H;
  const int h = bh - b * L.H;
  const int q0 = blockIdx.x * kBR;
  const int Tn = L.Tn;
  const long long row_stride = 3LL * L.H * D;
  const long long C = (long long)L.H * D;
  const long long qoff = (long long)b * Tn * row_stride + (long long)h * L.head_stride;
  const float* base = qkv + qoff;
  const float* obase = dout + (long long)b * Tn * C + (long long)h * D;
  const unsigned kv_s = smem_u32(KV);
  const int ntiles = (Tn + BS - 1) / BS;
  const bool rows_live = q0 + rg * 16 < Tn;

  // step i of the two sweeps works on key tile i % ntiles in stage i & 1
  auto load_kv = [&](int i) {
    const int k0 = (i < ntiles ? i : i - ntiles) * BS;
    const unsigned dst = kv_s + (i & 1) * 2 * P::SR_BYTES;
    copy_rows_f32_async<D, BS, kThreads>(dst, base + L.part_stride, row_stride, k0, Tn);
    copy_rows_f32_async<D, BS, kThreads>(dst + P::SR_BYTES, base + 2 * L.part_stride, row_stride, k0, Tn);
    cp_async_commit();
  };
  copy_rows_f32_async<D, kBR, kThreads>(smem_u32(Qs), base, row_stride, q0, Tn);
  copy_rows_f32_async<D, kBR, kThreads>(smem_u32(dOs), obase, C, q0, Tn);
  load_kv(0);  // one group: Q, dO and the first K/V tile

  const unsigned q_a = smem_u32(Qs) + rg * 16 * PITCH + a_lane<D>();
  const unsigned do_a = smem_u32(dOs) + rg * 16 * PITCH + a_lane<D>();

  // Land step i's tile and form S = (q s)(k s)^T and dP = dO V^T for the warp's
  // rows and its share of the keys (k scaled at its fragment load: dQ takes it
  // unscaled). Returns the share's real keys (none: <= 0). Ends with the stage
  // in use: the caller's barrier after its work frees it.
  auto tile_products = [&](int i, float (&s)[NT][4], float (&dp)[NT][4]) {
    if (i + 1 < 2 * ntiles) {
      load_kv(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (i == 0) scale_rows_f32<D, kBR, kThreads>(Qs, L.scale);
    __syncthreads();
    const int live = min(WS, Tn - (i < ntiles ? i : i - ntiles) * BS - kg * WS);
    if (rows_live && live > 0) {
      const unsigned k_b = kv_s + (i & 1) * 2 * P::SR_BYTES + kg * WS * PITCH + b_lane<D>();
      tf32_abt<D, NT, true>(q_a, k_b, L.scale, live, s);
      tf32_abt<D, NT, false>(do_a, k_b + P::SR_BYTES, 1.f, live, dp);
    }
    return live;
  };

  float s[NT][4], dp[NT][4];
  // rows g and g + 8; the running max is kept as m log2(e), so that the
  // rescale, the weights of both sweeps and kernel B's all use the same value
  float m[2], l[2], acc[2];
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = acc[0] = acc[1] = 0.f;

  // sweep 1: row max m, sum l and rowsum(dP o P), online over the key tiles
  for (int i = 0; i < ntiles; ++i) {
    const int live = tile_products(i, s, dp);
    if (rows_live && live > 0) {
      if (live < WS) {  // keys past T leave the softmax (their dP is 0: v is zero-filled)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + 2 * t4 + (e & 1) >= live) s[j][e] = -INFINITY;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx * kLog2e);  // finite: the share's first key is a real one
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
    }
    __syncthreads();
  }

  if constexpr (KS > 1) {
    // the key groups' statistics of a row meet: every warp of the row group adds all KS of them in the
    // same order, so all hold the same values (a group that met no key has m = -inf, l = rowsum = 0)
    float* w = stat_slots + warp * 6 * 32 + lane;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      w[hh * 32] = m[hh];
      w[(2 + hh) * 32] = l[hh];
      w[(4 + hh) * 32] = acc[hh];
    }
    __syncthreads();
    if (rows_live) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mt = -INFINITY;
#pragma unroll
        for (int k = 0; k < KS; ++k) mt = fmaxf(mt, stat_slots[(k * R + rg) * 6 * 32 + hh * 32 + lane]);
        float lt = 0.f, at = 0.f;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const float* r = stat_slots + (k * R + rg) * 6 * 32 + lane;
          const float f = fast_exp2(r[hh * 32] - mt);
          lt = fmaf(r[(2 + hh) * 32], f, lt);
          at = fmaf(r[(4 + hh) * 32], f, at);
        }
        m[hh] = mt;
        l[hh] = lt;
        acc[hh] = at;
      }
    }
  }

  float rinv[2], rs[2];
  const long long nrow = (long long)gridDim.y * Tn;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rinv[hh] = 1.f / l[hh];
    rs[hh] = acc[hh] / l[hh];
    const int q = q0 + rg * 16 + g + 8 * hh;
    if (kg == 0 && t4 == 0 && q < Tn) {
      const long long o = (long long)bh * Tn + q;
      stats[o] = m[hh];
      stats[nrow + o] = rinv[hh];
      stats[2 * nrow + o] = rs[hh];
    }
  }

  // sweep 2: dS = P o (dP - rowsum), dQ += dS K over the warp's share of the keys
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  for (int i = ntiles; i < 2 * ntiles; ++i) {
    const int live = tile_products(i, s, dp);
    if (rows_live && live > 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const float p = fast_exp2(fmaf(s[j][e], kLog2e, -m[hh])) * rinv[hh];
          const float ds = p * (dp[j][e] - rs[hh]);
          s[j][e] = 8 * j + 2 * t4 + (e & 1) >= live ? 0.f : ds;
        }
      const float* k_raw =
          reinterpret_cast<const float*>(KV + (i & 1) * 2 * P::SR_BYTES) + kg * WS * (D + 4) + xb_lane<D>();
      tf32_xb<D, NT>(s, k_raw, (live + 7) / 8, dq);
    }
    __syncthreads();
  }
  if constexpr (KS > 1) {
    // the key groups' dQ meet in the K/V stages, read and idle now; group 0 adds groups 1.. in order
    static_assert((KS - 1) * R * (D / 2) * 32 * 4 <= 4 * P::SR_BYTES, "the slots fit the K/V stages");
    float* slots = reinterpret_cast<float*>(KV);
    if (kg > 0 && rows_live) put_slot<D>(slots, (kg - 1) * R + rg, dq);
    __syncthreads();
    if (kg > 0) return;
    if (rows_live) add_slots<D>(slots, rg, R, KS - 1, dq);
  }
  if (rows_live) store_rows<D>(dqkv + qoff, row_stride, q0 + rg * 16, Tn, dq, L.scale2);
}

// Kernel B: grid (ceil(T / (16 R)), B * H), Tile<D, KS>::threads_b(R) threads.
// Writes dK and dV of its key rows. Warp w takes (of the warps of its role) the
// key rows of row group w % R and the query columns of group w / R of every
// q-tile.
template <int D, int R, int KS>
__global__ void __launch_bounds__((Tile<D, KS>::threads_b(R)))
attention_bwd_f32mma_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                                float* __restrict__ dqkv, const float* __restrict__ stats, Layout L) {
  using P = Tile<D, KS>;
  constexpr int PITCH = P::PITCH, BS = P::BS, WS = P::WS, NT = WS / 8, kBR = 16 * R;
  constexpr int kThreadsB = P::threads_b(R), W = R * KS;  // W: warps of a role
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* Ks = smem;  // k s, scaled in place
  uint8_t* Vs = Ks + kBR * PITCH;
  uint8_t* QO = Vs + kBR * PITCH;  // stage i: q at i * 2 * SR_BYTES, dO after it
  float* St = reinterpret_cast<float*>(QO + 4 * P::SR_BYTES);  // stage i: m log2(e), 1/l, rowsum at i * 3 * BS

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bool dk_warp = P::SPLIT_B && warp >= W;  // above D = 64: warps W.. form dK, the others dV
  const int wr = warp % W, rg = wr % R, kg = wr / R;  // the warp's row group and column group
  const int t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / L.H;
  const int h = bh - b * L.H;
  const int k0 = blockIdx.x * kBR;
  const int Tn = L.Tn;
  const long long row_stride = 3LL * L.H * D;
  const long long C = (long long)L.H * D;
  const long long qoff = (long long)b * Tn * row_stride + (long long)h * L.head_stride;
  const float* base = qkv + qoff;
  const float* obase = dout + (long long)b * Tn * C + (long long)h * D;
  const long long nrow = (long long)gridDim.y * Tn;
  const float* srow = stats + (long long)bh * Tn;
  const unsigned qo_s = smem_u32(QO), st_s = smem_u32(St);
  const int ntiles = (Tn + BS - 1) / BS;
  const bool rows_live = k0 + rg * 16 < Tn;

  auto load_q = [&](int it) {
    const int q0 = it * BS;
    const unsigned dst = qo_s + (it & 1) * 2 * P::SR_BYTES;
    copy_rows_f32_async<D, BS, kThreadsB>(dst, base, row_stride, q0, Tn);
    copy_rows_f32_async<D, BS, kThreadsB>(dst + P::SR_BYTES, obase, C, q0, Tn);
    for (int i = tid; i < 3 * BS; i += kThreadsB) {  // m, 1/l and the rowsum; zeros past T
      const int part = i / BS, q = q0 + i - part * BS;
      cp_async_4(st_s + ((it & 1) * 3 * BS + i) * 4, srow + part * nrow + (q < Tn ? q : 0), q < Tn);
    }
    cp_async_commit();
  };
  copy_rows_f32_async<D, kBR, kThreadsB>(smem_u32(Ks), base + L.part_stride, row_stride, k0, Tn);
  copy_rows_f32_async<D, kBR, kThreadsB>(smem_u32(Vs), base + 2 * L.part_stride, row_stride, k0, Tn);
  load_q(0);  // one group: K, V and the first q-tile

  const unsigned k_a = smem_u32(Ks) + rg * 16 * PITCH + a_lane<D>();
  const unsigned v_a = smem_u32(Vs) + rg * 16 * PITCH + a_lane<D>();

  // SPLIT_B: acc is the dV warps' dV and the dK warps' dK; else acc is dV and dk dK
  float acc[D / 8][4], dk[P::SPLIT_B ? 1 : D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
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
    if (it == 0) scale_rows_f32<D, kBR, kThreadsB>(Ks, L.scale);
    __syncthreads();
    const int live = min(WS, Tn - it * BS - kg * WS);  // the real query columns of the warp's share
    if (rows_live && live > 0) {
      const uint8_t* Qr = QO + (it & 1) * 2 * P::SR_BYTES + kg * WS * PITCH;  // the share's rows
      const unsigned q_b = smem_u32(Qr) + b_lane<D>(), do_b = q_b + P::SR_BYTES;
      // S^T = (k s)(q s)^T and dP^T = V dO^T: the warp's 16 key rows x WS query columns (q scaled at its
      // fragment load: dK takes it unscaled); a dV warp forms S^T alone
      float st[NT][4], dpt[NT][4];
      tf32_abt<D, NT, true>(k_a, q_b, L.scale, live, st);
      if (!P::SPLIT_B || dk_warp) tf32_abt<D, NT, false>(v_a, do_b, 1.f, live, dpt);

      // P^T and dS^T from the columns' statistics. A query column past T has
      // q s = 0, m = 0 and 1/l = 0, so P^T = dS^T = 0 there.
      const float* Ms = St + (it & 1) * 3 * BS + kg * WS;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 mm = *reinterpret_cast<const float2*>(Ms + 8 * j + 2 * t4);
        const float2 rr = *reinterpret_cast<const float2*>(Ms + BS + 8 * j + 2 * t4);
        const float2 dd = *reinterpret_cast<const float2*>(Ms + 2 * BS + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          const float p = fast_exp2(fmaf(st[j][e], kLog2e, -(odd ? mm.y : mm.x))) * (odd ? rr.y : rr.x);
          if (P::SPLIT_B) {
            st[j][e] = dk_warp ? p * (dpt[j][e] - (odd ? dd.y : dd.x)) : p;  // a dK warp's st is dS^T
          } else {
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - (odd ? dd.y : dd.x));
          }
        }
      }
      const float* q_raw = reinterpret_cast<const float*>(Qr) + xb_lane<D>();
      const float* do_raw = reinterpret_cast<const float*>(Qr + P::SR_BYTES) + xb_lane<D>();
      const int live8 = (live + 7) / 8;
      if constexpr (P::SPLIT_B) {
        tf32_xb<D, NT>(st, dk_warp ? q_raw : do_raw, live8, acc);  // dK += dS^T Q, or dV += P^T dO
      } else {
        tf32_xb<D, NT>(st, do_raw, live8, acc);  // dV += P^T dO
        tf32_xb<D, NT>(dpt, q_raw, live8, dk);   // dK += dS^T Q
      }
    }
    __syncthreads();  // this stage and its statistics are read; the next iteration may refill them
  }

  if constexpr (KS > 1) {
    // the column groups' dK and dV meet in the q/dO stages, read and idle now: a slot a role (or, up to
    // D = 64, one for dV and one for dK) and group; group 0 adds groups 1.. in order
    static_assert(2 * (KS - 1) * R * (D / 2) * 32 * 4 <= 4 * P::SR_BYTES, "the slots fit the q/dO stages");
    float* slots = reinterpret_cast<float*>(QO);
    const int role = (KS - 1) * R;  // slots of a role
    if (kg > 0 && rows_live) {
      put_slot<D>(slots, (dk_warp ? role : 0) + (kg - 1) * R + rg, acc);
      if constexpr (!P::SPLIT_B) put_slot<D>(slots, role + (kg - 1) * R + rg, dk);
    }
    __syncthreads();
    if (kg > 0) return;
    if (rows_live) {
      add_slots<D>(slots, (dk_warp ? role : 0) + rg, R, KS - 1, acc);
      if constexpr (!P::SPLIT_B) add_slots<D>(slots, role + rg, R, KS - 1, dk);
    }
  }

  if (!rows_live) return;
  float* dbase = dqkv + qoff;
  if constexpr (P::SPLIT_B) {
    if (dk_warp) store_rows<D>(dbase + L.part_stride, row_stride, k0 + rg * 16, Tn, acc, L.scale2);
    else store_rows<D>(dbase + 2 * L.part_stride, row_stride, k0 + rg * 16, Tn, acc, 1.f);
  } else {
    store_rows<D>(dbase + L.part_stride, row_stride, k0 + rg * 16, Tn, dk, L.scale2);
    store_rows<D>(dbase + 2 * L.part_stride, row_stride, k0 + rg * 16, Tn, acc, 1.f);
  }
}

// Kernel B for stationary rows `rows` (ops/attention.py::f32_bwd_rows) at head
// width D, after kernel A has written `stats` (attention_bwd_f32mma_dkv.cu).
// Returns a cudaError_t code (0 = launched).
int launch_dkv(const float* qkv, const float* dout, float* dqkv, const float* stats, int B, const Layout& L, int D,
               int rows, cudaStream_t stream);

}  // namespace f32attn
}  // namespace gdc
