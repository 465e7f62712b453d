// Fused QKV self-attention forward (kernel K1) on the tensor cores, for
// float32 inputs and head widths 32, 64, 96, 128, 192 and 256, on Hopper
// (sm_90a).
//
// Replaces guided_diffusion_clip_tpu/ops/pallas_attention.py::_attn_kernel
// (reached via _flash_bhtd / qkv_attention_pallas) for float32, as
// attention_fwd_mma.cu does for bf16; attention_fwd.cu, the first version on
// the f32 FMA pipes, stays built as a yardstick. Per (batch, head) and per
// tile of query rows
//     out = softmax((q*s)(k*s)^T) v,   s = d^-1/4,
// with the TPU kernel's numerics for f32: q*s and k*s rounded to f32 (one
// multiply each), the logits, max, exp and sum in f32, P V summed in f32.
//
// What bounds it on the H100: 4*T*T*d operations a head against 4*T*d
// elements moved, T / 4 operations a byte of f32: from T ~ 200 on it is bound
// by the operations. Its users are the classifier's attention pool (T = 65,
// d = 64, float32 by the reference's design: one launch a guided step), the
// 64 px quality proxies' f32 training and classifier (d = 96, 128) and any
// model built with use_fp16=False. The first version ran both products on the
// FMA pipes (67 T/s), with 4-warp blocks, one an SM at those shapes.
//
// What the design does about it:
//   * every product is mma.sync m16n8k8 on TF32 with each f32 operand split in
//     registers at its fragment load into big + small (mma.cuh: split_tf32),
//     three mma for one product: 2^-22 relative, of the order of f32's own
//     rounding, where one TF32 rounding (2^-11) would be ~5e-4 of the output.
//     At three mma a product the tensor cores' TF32 rate is 165 T/s of f32
//     work, 2.5x the FMA pipes';
//   * the tiles stay f32 in shared memory (rows padded by 16 bytes, free of
//     bank conflicts for ldmatrix and for the 4-byte loads of V), copied 16
//     bytes a thread by cp.async straight from qkv, in place through strides in
//     either head order; K/V tiles (64 keys at d = 64, 32 at 32 and to 128, 16
//     above; at least 16 a key group) are double-buffered, the next tile's
//     copy behind this one's mma;
//   * q*s (once) and k*s (each tile) are one pass over the landed tile;
//   * blocks of 4 warps, each warp 16 query rows and a share of every K/V
//     tile's keys: R row groups of 16 rows times KS key groups (R * KS = 4:
//     64 rows whole, 32 rows with the keys split in two, 16 rows split in
//     four, up to d = 64). The caller (ops/attention.py::f32_rows) takes the
//     most rows that still give every SM a block: at the pool (64 heads,
//     T = 65) 32-row blocks, 192 of them, where 64-row blocks made 128 on 132
//     SMs. Each key group runs its own online softmax; at the end the groups'
//     (m, l, O) meet in shared memory and the first adds them in a fixed
//     order, so repeats give the same bits (a row's bits depend on KS).
//     Blocks of one warp with the keys whole measured 1.3-2.5x slower (their
//     copies are not shared, and an SM holds too few warps to hide latency),
//     and splitting the keys so that every SM got two blocks, not one, slower
//     at every timed shape but the smallest grids;
//     above d = 128 a block is 32 rows, 2 warps, the keys whole;
//   * Q K^T's fragments come by ldmatrix (32-bit words fall where TF32's A and
//     B take them); the sums of S feed P V as its A operand in registers, the
//     reduction index permuted (mma.cuh), so V's fragments are two 4-byte loads
//     an n-tile. P V is summed a tile at a time and added to O on the FMA pipes
//     (the tensor cores truncate as they accumulate);
//   * online softmax over the K/V tiles (running max m, sum l, rescaled O);
//     keys past T are masked to -inf, and groups of four n-tiles that hold only
//     keys past T issue no mma, nor does a key group whose share of a tile
//     holds none: at the pool's T = 65 the second 64-key tile, one real key,
//     costs one warp of each row group 32 keys and the others nothing. A warp
//     whose rows all lie past T issues none at all; rows past T are not stored;
//   * no atomics: every output element written once, repeats give the same
//     bits;
//   * the dynamic shared-memory attribute is set once per kernel and device,
//     not at every launch.
// exp(s - m) is ex2.approx(s log2(e) - m log2(e)): ~1e-6 of a weight, under the
// 1e-4 the kernel is held to.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using namespace gdc;

template <int D, int KS> struct Tile {
  static constexpr int PITCH = f32_pitch<D>();
  // keys a K/V tile: 64 at D = 64, 32 to D = 128, 16 above (at D = 32, 64 spilled), and at least 16 a key group
  static constexpr int BASE = D == 64 ? 64 : D <= 128 ? 32 : 16;
  static constexpr int BK = BASE > 16 * KS ? BASE : 16 * KS;
  static constexpr int WK = BK / KS;  // keys a warp takes of a tile
  static constexpr int KV_BYTES = BK * PITCH;
  // R row groups of 16 query rows: Q, and two stages of K and V
  __host__ __device__ static constexpr int smem_bytes(int r) { return 16 * r * PITCH + 4 * KV_BYTES; }
};

// qkv: (B, T, 3C) with row stride 3C. For head h, q starts at channel
// h*head_stride, k at that + part_stride, v at that + 2*part_stride (legacy
// order: head_stride 3D, part_stride D; new order: D and C). out: (B, T, C).
// Warp w takes the query rows of row group w % R and the keys of key group
// w / R of every tile.
template <int D, int R, int KS>
__global__ void __launch_bounds__(32 * R * KS)
attention_fwd_f32mma_kernel(const float* __restrict__ qkv, float* __restrict__ out, int Tn, int H, int head_stride,
                            int part_stride, float scale) {
  using P = Tile<D, KS>;
  constexpr int PITCH = P::PITCH, kBK = P::BK, kWK = P::WK, NT = kWK / 8, kBQ = 16 * R, kThreads = 32 * R * KS;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* Qs = smem;
  uint8_t* KV = smem + kBQ * PITCH;  // stage i: K at i * 2 * KV_BYTES, V after it

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rg = warp % R, kg = warp / R;  // the warp's row group and key group
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const long long row_stride = 3LL * H * D;
  const float* base = qkv + (long long)b * Tn * row_stride + (long long)h * head_stride;
  const unsigned q_s = smem_u32(Qs), kv_s = smem_u32(KV);
  const int ntiles = (Tn + kBK - 1) / kBK;
  // a warp whose 16 rows all lie past T joins the copies and barriers, not the products
  const bool rows_live = q0 + rg * 16 < Tn;

  auto load_kv = [&](int it) {
    const unsigned dst = kv_s + (it & 1) * 2 * P::KV_BYTES;
    copy_rows_f32_async<D, kBK, kThreads>(dst, base + part_stride, row_stride, it * kBK, Tn);
    copy_rows_f32_async<D, kBK, kThreads>(dst + P::KV_BYTES, base + 2 * part_stride, row_stride, it * kBK, Tn);
    cp_async_commit();
  };
  copy_rows_f32_async<D, kBQ, kThreads>(q_s, base, row_stride, q0, Tn);
  load_kv(0);  // one group: Q and the first K/V tile

  // ldmatrix lane offsets: A (rows 0-7, 8-15 at bytes 0-15, then 16-31), and B (rows 0-7 at 0-15, 16-31, then
  // rows 8-15)
  const unsigned a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * PITCH + (lane >> 4) * 16;
  const unsigned b_off = ((lane & 7) + (lane >> 4) * 8) * PITCH + ((lane >> 3) & 1) * 16;
  const unsigned q_a = q_s + rg * 16 * PITCH + a_off;
  // the key group's rows of a tile: the ldmatrix offset of K, and the lane's (row 2t, column g) of V in floats
  const unsigned k_off = kg * kWK * PITCH + b_off;
  const int v_lane = (kg * kWK + 2 * t4) * (D + 4) + g;

  float o[D / 8][4];
  // rows g and g + 8: the running max kept as m log2(e), and the sum
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
    if (it == 0) scale_rows_f32<D, kBQ, kThreads>(Qs, scale);
    scale_rows_f32<D, kBK, kThreads>(Kt, scale);
    __syncthreads();  // tile `it` has landed for every thread, K scaled
    const int live = min(kWK, Tn - it * kBK - kg * kWK);  // the real keys of the warp's share
    if (rows_live && live > 0) {
      float s[NT][4];
      tf32_abt<D, NT, false>(q_a, smem_u32(Kt) + k_off, 1.f, live, s);
      if (live < kWK) {  // the ragged last tile: keys past T leave the softmax
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + 2 * t4 + (e & 1) >= live) s[j][e] = -INFINITY;
      }
      // online softmax; a row's logits lie in the 4 lanes of a quad
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx * kLog2e);  // finite: the share's first key is a real one
        const float alpha = fast_exp2(m[hh] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
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
      // O += P V, the f32 weights split as V is
      tf32_xb<D, NT>(s, reinterpret_cast<const float*>(Kt + P::KV_BYTES) + v_lane, (live + 7) / 8, o);
    }
    __syncthreads();  // this stage's K and V are read; the next iteration may refill it
  }

  if constexpr (KS > 1) {
    // The key groups' (m, l, O) of each row group meet in the K/V stages, read and idle now: group kg > 0
    // leaves its lane's values at slot (kg - 1) * R + rg, [value][lane]; group 0 adds them in order.
    constexpr int SLOT = (D / 2 + 4) * 32;  // floats: O's D / 2 a lane, m and l's 2 each
    static_assert((KS - 1) * R * SLOT * 4 <= 4 * P::KV_BYTES, "the slots fit the K/V stages");
    float* slots = reinterpret_cast<float*>(KV);
    if (kg > 0 && rows_live) {
      float* w = slots + ((kg - 1) * R + rg) * SLOT + lane;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[(4 * j + e) * 32] = o[j][e];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        w[(D / 2 + hh) * 32] = m[hh];
        w[(D / 2 + 2 + hh) * 32] = l[hh];
      }
    }
    __syncthreads();
    if (kg > 0) return;
    if (rows_live) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mt = m[hh];
#pragma unroll
        for (int k = 1; k < KS; ++k) mt = fmaxf(mt, slots[((k - 1) * R + rg) * SLOT + (D / 2 + hh) * 32 + lane]);
        const float f0 = fast_exp2(m[hh] - mt);  // a group that met no key has m = -inf, l = 0, O = 0
        l[hh] *= f0;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[j][2 * hh] *= f0;
          o[j][2 * hh + 1] *= f0;
        }
#pragma unroll
        for (int k = 1; k < KS; ++k) {
          const float* r = slots + ((k - 1) * R + rg) * SLOT + lane;
          const float f = fast_exp2(r[(D / 2 + hh) * 32] - mt);
          l[hh] = fmaf(r[(D / 2 + 2 + hh) * 32], f, l[hh]);
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o[j][2 * hh] = fmaf(r[(4 * j + 2 * hh) * 32], f, o[j][2 * hh]);
            o[j][2 * hh + 1] = fmaf(r[(4 * j + 2 * hh + 1) * 32], f, o[j][2 * hh + 1]);
          }
        }
      }
    }
  }

  // out: (B, T, C), channel h*D + c (merge_heads order)
  if (!rows_live) return;
  const long long C = (long long)H * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int q = q0 + rg * 16 + g + 8 * hh;
    if (q >= Tn) continue;
    const float inv = 1.f / l[hh];
    float* orow = out + ((long long)b * Tn + q) * C + (long long)h * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(o[j][2 * hh] * inv, o[j][2 * hh + 1] * inv);
  }
}

template <int D, int R, int KS>
int launch(const void* qkv, void* out, int B, int Tn, int H, int new_order, float scale, cudaStream_t stream) {
  constexpr int smem = Tile<D, KS>::smem_bytes(R);
  static bool attr_set[kMaxDevices] = {};
  auto kern = attention_fwd_f32mma_kernel<D, R, KS>;
  const int err = smem_attribute_once(attr_set, kern, smem);
  if (err != 0) return err;
  const int head_stride = new_order ? D : 3 * D;
  const int part_stride = new_order ? H * D : D;
  dim3 grid((Tn + 16 * R - 1) / (16 * R), B * H);
  kern<<<grid, 32 * R * KS, smem, stream>>>(static_cast<const float*>(qkv), static_cast<float*>(out), Tn, H,
                                            head_stride, part_stride, scale);
  return (int)cudaGetLastError();
}

// query rows of a block -> (row groups, key groups): 64 (4, 1), 32 (2, 2), and up to D = 64 16 (1, 4), as K2
// takes them (at D = 96 K2's 64-row streamed tiles would hold one block an SM); above D = 128, 32 (2, 1) alone
template <int D>
int launch_rows(const void* qkv, void* out, int B, int Tn, int H, int new_order, int q_rows, float scale,
                cudaStream_t s) {
  if constexpr (D > 128) {
    if (q_rows == 32) return launch<D, 2, 1>(qkv, out, B, Tn, H, new_order, scale, s);
  } else {
    if (q_rows == 64) return launch<D, 4, 1>(qkv, out, B, Tn, H, new_order, scale, s);
    if (q_rows == 32) return launch<D, 2, 2>(qkv, out, B, Tn, H, new_order, scale, s);
    if constexpr (D <= 64) {
      if (q_rows == 16) return launch<D, 1, 4>(qkv, out, B, Tn, H, new_order, scale, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// qkv: (B, T, 3 * H * D) f32, out: (B, T, H * D) f32, both contiguous and
// 16-byte aligned; D in {32, 64, 96, 128, 192, 256}; q_rows, the query rows of
// a block: 64, 32 or (up to D = 64) 16, and 32 above D = 128
// (ops/attention.py::f32_rows picks). Returns a cudaError_t code (0 =
// launched).
extern "C" int gdc_attention_fwd_f32mma(const void* qkv, void* out, int B, int Tn, int H, int D, int new_order,
                                        int q_rows, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_rows<32>(qkv, out, B, Tn, H, new_order, q_rows, scale, s);
    case 64: return launch_rows<64>(qkv, out, B, Tn, H, new_order, q_rows, scale, s);
    case 96: return launch_rows<96>(qkv, out, B, Tn, H, new_order, q_rows, scale, s);
    case 128: return launch_rows<128>(qkv, out, B, Tn, H, new_order, q_rows, scale, s);
    case 192: return launch_rows<192>(qkv, out, B, Tn, H, new_order, q_rows, scale, s);
    case 256: return launch_rows<256>(qkv, out, B, Tn, H, new_order, q_rows, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
