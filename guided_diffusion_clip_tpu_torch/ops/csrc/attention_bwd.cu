// Fused QKV self-attention backward (kernel K2) for Hopper, sm_90a.
//
// Replaces guided_diffusion_clip_tpu/ops/pallas_attention.py::_attn_bwd_kernel
// (reached via _flash_bwd, the custom VJP of K1). Given qkv and the output
// cotangent dO, per (batch, head) it recomputes the f32 softmax weights and
// forms
//     dV = P^T dO,   dP = dO V^T,   dS = P o (dP - rowsum(dP o P)),
//     dQ = dS K s^2,   dK = dS^T Q s^2,        s = d^-1/4,
// with the numerics of the TPU kernel: the logits are products of q*s and
// k*s each rounded to the input type, P stays f32 (it is not rounded before
// P^T dO), dP, dS and every accumulator are f32, and dQ, dK and dV are cast
// to the input type once at the end.
//
// What bounds it on the H100: the products are about 4.5x the forward's FLOPs
// (see below) against 8*T*d elements moved per head, so at the classifier's
// T = 1024, d = 64 it is compute-bound; this first version runs every product
// on the f32 FMA pipes (no tensor cores), bound by FMA issue and shared-memory
// bandwidth.
//
// What the design does about it:
//   * the TPU kernel walks q-tiles in order and accumulates dK and dV across
//     them in place. GPU blocks run in parallel and in no order, and float
//     atomics would make the sums differ from run to run. So there are two
//     kernels, and every output element is written once, by one thread:
//       A, Q-stationary (one block per q-tile): sweep 1 over all K/V tiles
//         forms each row's max m and sum l with an online rescale, and
//         rowsum(dP o P) as sum_j exp(s_ij - m) dP_ij rescaled the same way
//         and divided by l at the end, i.e. from the f32 P and dP exactly as
//         the TPU kernel sums dp * p (not from dO.O, which would bring in
//         the forward's rounded output). Sweep 2 recomputes P and dP, forms
//         dS and accumulates dQ in registers. It writes m, l and the rowsum
//         for kernel B;
//       B, K/V-stationary (one block per key tile): loops over all q-tiles,
//         recomputes P^T and dP^T from the saved m and l, and accumulates dK
//         and dV in registers;
//   * no float atomics anywhere, so repeat runs are bit-identical;
//   * logits, P and dS never leave the SM: register tiles, and one shared
//     tile of P or dS for the second product;
//   * qkv, dO and dqkv are read and written in place through strides, in
//     either head order; any T works, the ragged edge is masked.
// FLOPs per head: A does 2 + 3 products of 2*T*T*d, B does 4, against the
// 2 of the forward. wgmma/TMA, tensor cores and a fused single pass are later
// work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 value to T and back: the TPU kernel's "q * scale" on a T array.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

constexpr int kThreads = 128;  // 4 warps; thread t -> (tx = t % 16, ty = t / 16)

template <int D> struct Tile {
  static constexpr int BQ = D <= 128 ? 64 : 32;  // query rows per tile
  static constexpr int BK = D <= 64 ? 64 : 32;   // keys per tile
  static constexpr int LD = D + 1;               // padded row stride (floats)
  static constexpr int LDK = BK + 1;             // dS tile of kernel A (BQ x BK)
  static constexpr int LDQ = BQ + 1;             // P^T and dS^T tiles of kernel B (BK x BQ)
  static constexpr int QROWS = BQ / 8;           // rows of a q-tile per thread
  static constexpr int KROWS = BK / 8;           // rows of a key tile per thread
  static constexpr int KCOLS = BK / 16;          // logits columns over keys per thread
  static constexpr int QCOLS = BQ / 16;          // logits columns over queries per thread
  static constexpr int DCOLS = D / 16;           // gradient columns per thread
  static constexpr size_t smem_a =
      sizeof(float) * (2 * size_t(BQ) * LD + 3 * size_t(BK) * LD + size_t(BQ) * LDK);
  static constexpr size_t smem_b =
      sizeof(float) * (2 * size_t(BK) * LD + 3 * size_t(BQ) * LD + 2 * size_t(BK) * LDQ + 3 * BQ);
};

// Strides shared by both kernels. qkv and dqkv: (B, T, 3C), row stride 3C;
// for head h, q starts at channel h*head_stride, k at that + part_stride, v at
// that + 2*part_stride (legacy order: head_stride 3D, part_stride D; new
// order: D and C). dO: (B, T, C), head h at channel h*D.
struct Layout {
  int Tn, H, head_stride, part_stride;
  float scale, scale2;  // s = d^-1/4 and s^2
};

// Load rows [r0, r0 + rows) of one head's q, k or v (part 0, 1, 2) into a
// shared tile, f32; scaled and rounded to T when `scaled`; zero past T.
template <typename T, int D>
__device__ __forceinline__ void load_part(float* dst, const T* base, int r0, int rows, int part,
                                          bool scaled, const Layout& L) {
  const long long row_stride = 3LL * L.H * D;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i - (i / D) * D;
    const int t = r0 + r;
    float v = 0.f;
    if (t < L.Tn) {
      v = to_f32(base[(long long)t * row_stride + (long long)part * L.part_stride + c]);
      if (scaled) v = round_to<T>(v * L.scale);
    }
    dst[r * (D + 1) + c] = v;
  }
}

template <typename T, int D>
__device__ __forceinline__ void load_dout(float* dst, const T* obase, int r0, int rows,
                                          const Layout& L) {
  const long long C = (long long)L.H * D;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i - (i / D) * D;
    const int t = r0 + r;
    dst[r * (D + 1) + c] = t < L.Tn ? to_f32(obase[(long long)t * C + c]) : 0.f;
  }
}

// Two register tiles from shared tiles of row stride D + 1: s = a1 b1^T and
// t = a2 b2^T, for rows ty + 8i of a1/a2 and rows tx + 16j of b1/b2. Column
// reads of the padded rows are free of bank conflicts.
template <int D, int ROWS, int COLS>
__device__ __forceinline__ void two_products(const float* __restrict__ a1,
                                             const float* __restrict__ b1,
                                             const float* __restrict__ a2,
                                             const float* __restrict__ b2,
                                             float (&s)[ROWS][COLS], float (&t)[ROWS][COLS]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < COLS; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < D; ++dd) {
    float av[ROWS], cv[ROWS], bv[COLS], ev[COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      av[i] = a1[(ty + 8 * i) * (D + 1) + dd];
      cv[i] = a2[(ty + 8 * i) * (D + 1) + dd];
    }
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      bv[j] = b1[(tx + 16 * j) * (D + 1) + dd];
      ev[j] = b2[(tx + 16 * j) * (D + 1) + dd];
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        t[i][j] = fmaf(cv[i], ev[j], t[i][j]);
      }
  }
}

// Kernel A: grid (ceil(T / BQ), B * H). Writes dQ and the row statistics
// stats[0] = m, stats[1] = l, stats[2] = rowsum(dP o P), each (B * H, T).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                        T* __restrict__ dqkv, float* __restrict__ stats, Layout L) {
  using P = Tile<D>;
  extern __shared__ float smem[];
  float* Qs = smem;                  // BQ x LD  round(q*s)
  float* dOs = Qs + P::BQ * P::LD;   // BQ x LD  dO
  float* Ks = dOs + P::BQ * P::LD;   // BK x LD  round(k*s)
  float* Kr = Ks + P::BK * P::LD;    // BK x LD  k
  float* Vs = Kr + P::BK * P::LD;    // BK x LD  v
  float* dSs = Vs + P::BK * P::LD;   // BQ x LDK dS

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / L.H;
  const int h = bh - b * L.H;
  const int q0 = blockIdx.x * P::BQ;
  const int Tn = L.Tn;
  const long long row_stride = 3LL * L.H * D;
  const long long qoff = (long long)b * Tn * row_stride + (long long)h * L.head_stride;
  const T* base = qkv + qoff;
  const T* obase = dout + (long long)b * Tn * L.H * D + (long long)h * D;

  load_part<T, D>(Qs, base, q0, P::BQ, 0, true, L);
  load_dout<T, D>(dOs, obase, q0, P::BQ, L);

  // S = Qs Ks^T and dP = dOs Vs^T for rows ty + 8i, key columns tx + 16j
  float s[P::QROWS][P::KCOLS], dp[P::QROWS][P::KCOLS];

  // sweep 1: row max m, sum l and rowsum(dP o P), online over key tiles; a
  // row's 16 column-owners are the 16 lanes of one half-warp, so xor-shuffles
  // 1..8 reduce exactly one row
  float m[P::QROWS], l[P::QROWS], acc[P::QROWS];
#pragma unroll
  for (int i = 0; i < P::QROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    acc[i] = 0.f;
  }
  for (int k0 = 0; k0 < Tn; k0 += P::BK) {
    __syncthreads();  // previous tile's reads are done (and Qs, dOs are written)
    load_part<T, D>(Ks, base, k0, P::BK, 1, true, L);
    load_part<T, D>(Vs, base, k0, P::BK, 2, false, L);
    __syncthreads();
    two_products<D>(Qs, Ks, dOs, Vs, s, dp);
#pragma unroll
    for (int i = 0; i < P::QROWS; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < P::KCOLS; ++j) {
        if (k0 + tx + 16 * j >= Tn) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);  // finite: column k0 is always a real key
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f, sdp = 0.f;
#pragma unroll
      for (int j = 0; j < P::KCOLS; ++j) {
        const float p = expf(s[i][j] - m_new);  // 0 on masked keys (and dP is 0 there)
        sum += p;
        sdp = fmaf(p, dp[i][j], sdp);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        sdp += __shfl_xor_sync(0xffffffffu, sdp, o);
      }
      l[i] = l[i] * alpha + sum;
      acc[i] = acc[i] * alpha + sdp;
      m[i] = m_new;
    }
  }
  float rinv[P::QROWS], rs[P::QROWS];
  const long long nrow = (long long)gridDim.y * Tn;
#pragma unroll
  for (int i = 0; i < P::QROWS; ++i) {
    rinv[i] = 1.f / l[i];
    rs[i] = acc[i] / l[i];
    const int q = q0 + ty + 8 * i;
    if (tx == 0 && q < Tn) {
      const long long o = (long long)bh * Tn + q;
      stats[o] = m[i];
      stats[nrow + o] = l[i];
      stats[2 * nrow + o] = rs[i];
    }
  }

  // sweep 2: dS = P o (dP - rowsum) and dQ += dS K, for rows ty + 8i and
  // gradient columns tx + 16j
  float dq[P::QROWS][P::DCOLS];
#pragma unroll
  for (int i = 0; i < P::QROWS; ++i)
#pragma unroll
    for (int j = 0; j < P::DCOLS; ++j) dq[i][j] = 0.f;
  for (int k0 = 0; k0 < Tn; k0 += P::BK) {
    __syncthreads();
    load_part<T, D>(Ks, base, k0, P::BK, 1, true, L);
    load_part<T, D>(Kr, base, k0, P::BK, 1, false, L);
    load_part<T, D>(Vs, base, k0, P::BK, 2, false, L);
    __syncthreads();
    two_products<D>(Qs, Ks, dOs, Vs, s, dp);
#pragma unroll
    for (int i = 0; i < P::QROWS; ++i)
#pragma unroll
      for (int j = 0; j < P::KCOLS; ++j) {
        const float p = k0 + tx + 16 * j < Tn ? expf(s[i][j] - m[i]) * rinv[i] : 0.f;
        dSs[(ty + 8 * i) * P::LDK + tx + 16 * j] = p * (dp[i][j] - rs[i]);
      }
    __syncwarp();  // a row of dSs is written and read by the same half-warp
#pragma unroll 4
    for (int kk = 0; kk < P::BK; ++kk) {
      float dsv[P::QROWS], kv[P::DCOLS];
#pragma unroll
      for (int i = 0; i < P::QROWS; ++i) dsv[i] = dSs[(ty + 8 * i) * P::LDK + kk];
#pragma unroll
      for (int j = 0; j < P::DCOLS; ++j) kv[j] = Kr[kk * P::LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < P::QROWS; ++i)
#pragma unroll
        for (int j = 0; j < P::DCOLS; ++j) dq[i][j] = fmaf(dsv[i], kv[j], dq[i][j]);
    }
  }

  T* dbase = dqkv + qoff;
#pragma unroll
  for (int i = 0; i < P::QROWS; ++i) {
    const int q = q0 + ty + 8 * i;
    if (q >= Tn) continue;
    T* row = dbase + (long long)q * row_stride;
#pragma unroll
    for (int j = 0; j < P::DCOLS; ++j) row[tx + 16 * j] = from_f32<T>(dq[i][j] * L.scale2);
  }
}

// Kernel B: grid (ceil(T / BK), B * H). Writes dK and dV of its key tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                         T* __restrict__ dqkv, const float* __restrict__ stats, Layout L) {
  using P = Tile<D>;
  extern __shared__ float smem[];
  float* Ks = smem;                   // BK x LD  round(k*s)
  float* Vs = Ks + P::BK * P::LD;     // BK x LD  v
  float* Qs = Vs + P::BK * P::LD;     // BQ x LD  round(q*s)
  float* Qr = Qs + P::BQ * P::LD;     // BQ x LD  q
  float* dOs = Qr + P::BQ * P::LD;    // BQ x LD  dO
  float* Pt = dOs + P::BQ * P::LD;    // BK x LDQ P^T
  float* dSt = Pt + P::BK * P::LDQ;   // BK x LDQ dS^T
  float* Ms = dSt + P::BK * P::LDQ;   // BQ: m of the q-tile's rows
  float* Rs = Ms + P::BQ;             // BQ: 1 / l
  float* Ds = Rs + P::BQ;             // BQ: rowsum(dP o P)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / L.H;
  const int h = bh - b * L.H;
  const int k0 = blockIdx.x * P::BK;
  const int Tn = L.Tn;
  const long long row_stride = 3LL * L.H * D;
  const long long qoff = (long long)b * Tn * row_stride + (long long)h * L.head_stride;
  const T* base = qkv + qoff;
  const T* obase = dout + (long long)b * Tn * L.H * D + (long long)h * D;
  const long long nrow = (long long)gridDim.y * Tn;
  const float* srow = stats + (long long)bh * Tn;

  load_part<T, D>(Ks, base, k0, P::BK, 1, true, L);
  load_part<T, D>(Vs, base, k0, P::BK, 2, false, L);

  float dk[P::KROWS][P::DCOLS], dv[P::KROWS][P::DCOLS];
#pragma unroll
  for (int i = 0; i < P::KROWS; ++i)
#pragma unroll
    for (int j = 0; j < P::DCOLS; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = 0; q0 < Tn; q0 += P::BQ) {
    __syncthreads();  // previous tile's reads are done (and Ks, Vs are written)
    load_part<T, D>(Qs, base, q0, P::BQ, 0, true, L);
    load_part<T, D>(Qr, base, q0, P::BQ, 0, false, L);
    load_dout<T, D>(dOs, obase, q0, P::BQ, L);
    for (int r = tid; r < P::BQ; r += kThreads) {
      const int q = q0 + r;
      const bool in = q < Tn;
      Ms[r] = in ? srow[q] : 0.f;
      Rs[r] = in ? 1.f / srow[nrow + q] : 0.f;
      Ds[r] = in ? srow[2 * nrow + q] : 0.f;
    }
    __syncthreads();

    // S^T = Ks Qs^T and dP^T = Vs dOs^T for key rows ty + 8i, query columns tx + 16j
    float st[P::KROWS][P::QCOLS], dpt[P::KROWS][P::QCOLS];
    two_products<D>(Ks, Qs, Vs, dOs, st, dpt);
#pragma unroll
    for (int i = 0; i < P::KROWS; ++i)
#pragma unroll
      for (int j = 0; j < P::QCOLS; ++j) {
        const int c = tx + 16 * j;
        const float p = q0 + c < Tn ? expf(st[i][j] - Ms[c]) * Rs[c] : 0.f;
        Pt[(ty + 8 * i) * P::LDQ + c] = p;
        dSt[(ty + 8 * i) * P::LDQ + c] = p * (dpt[i][j] - Ds[c]);
      }
    __syncwarp();  // a row of Pt / dSt is written and read by the same half-warp

    // dV += P^T dO and dK += dS^T Q for key rows ty + 8i, gradient columns tx + 16j
#pragma unroll 4
    for (int qq = 0; qq < P::BQ; ++qq) {
      float pv[P::KROWS], dsv[P::KROWS], ov[P::DCOLS], qv[P::DCOLS];
#pragma unroll
      for (int i = 0; i < P::KROWS; ++i) {
        pv[i] = Pt[(ty + 8 * i) * P::LDQ + qq];
        dsv[i] = dSt[(ty + 8 * i) * P::LDQ + qq];
      }
#pragma unroll
      for (int j = 0; j < P::DCOLS; ++j) {
        ov[j] = dOs[qq * P::LD + tx + 16 * j];
        qv[j] = Qr[qq * P::LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < P::KROWS; ++i)
#pragma unroll
        for (int j = 0; j < P::DCOLS; ++j) {
          dv[i][j] = fmaf(pv[i], ov[j], dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
        }
    }
  }

  T* dbase = dqkv + qoff;
#pragma unroll
  for (int i = 0; i < P::KROWS; ++i) {
    const int k = k0 + ty + 8 * i;
    if (k >= Tn) continue;
    T* row = dbase + (long long)k * row_stride;
#pragma unroll
    for (int j = 0; j < P::DCOLS; ++j) {
      row[L.part_stride + tx + 16 * j] = from_f32<T>(dk[i][j] * L.scale2);
      row[2 * L.part_stride + tx + 16 * j] = from_f32<T>(dv[i][j]);
    }
  }
}

template <typename T, int D>
int launch(const void* qkv, const void* dout, void* dqkv, void* stats, int B, const Layout& L,
           cudaStream_t stream) {
  using P = Tile<D>;
  auto ka = attention_bwd_dq_kernel<T, D>;
  auto kb = attention_bwd_dkv_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::smem_b);
  if (err != cudaSuccess) return (int)err;
  const T* q = static_cast<const T*>(qkv);
  const T* o = static_cast<const T*>(dout);
  T* g = static_cast<T*>(dqkv);
  float* st = static_cast<float*>(stats);
  dim3 grid_a((L.Tn + P::BQ - 1) / P::BQ, B * L.H);
  ka<<<grid_a, kThreads, P::smem_a, stream>>>(q, o, g, st, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_b((L.Tn + P::BK - 1) / P::BK, B * L.H);
  kb<<<grid_b, kThreads, P::smem_b, stream>>>(q, o, g, st, L);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* qkv, const void* dout, void* dqkv, void* stats, int B, int D,
               const Layout& L, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(qkv, dout, dqkv, stats, B, L, stream);
    case 64: return launch<T, 64>(qkv, dout, dqkv, stats, B, L, stream);
    case 96: return launch<T, 96>(qkv, dout, dqkv, stats, B, L, stream);
    case 128: return launch<T, 128>(qkv, dout, dqkv, stats, B, L, stream);
    case 192: return launch<T, 192>(qkv, dout, dqkv, stats, B, L, stream);
    case 256: return launch<T, 256>(qkv, dout, dqkv, stats, B, L, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv, dqkv: (B, T, 3 * H * D); dout: (B, T, H * D), contiguous, all in dtype
// (0 = float32, 1 = bfloat16); stats: (3, B * H, T) f32 scratch. Returns a
// cudaError_t code (0 = both kernels launched).
extern "C" int gdc_attention_bwd(const void* qkv, const void* dout, void* dqkv, void* stats,
                                 int B, int Tn, int H, int D, int new_order, int dtype,
                                 float scale, float scale2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Layout L;
  L.Tn = Tn;
  L.H = H;
  L.head_stride = new_order ? D : 3 * D;
  L.part_stride = new_order ? H * D : D;
  L.scale = scale;
  L.scale2 = scale2;
  if (dtype == 0) return dispatch_d<float>(qkv, dout, dqkv, stats, B, D, L, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(qkv, dout, dqkv, stats, B, D, L, s);
  return (int)cudaErrorInvalidValue;
}
