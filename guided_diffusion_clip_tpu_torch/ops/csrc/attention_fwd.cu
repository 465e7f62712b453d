// Fused QKV self-attention forward (kernel K1) for Hopper, sm_90a.
//
// Replaces guided_diffusion_clip_tpu/ops/pallas_attention.py::_attn_kernel
// (reached via _flash_bhtd / qkv_attention_pallas). Computes, per (batch,
// head) and per tile of query rows,
//     out = softmax((q*s)(k*s)^T) v,   s = d^-1/4,
// with the numerics contract of the TPU kernel: q*s and k*s are each rounded
// back to the input type before the product, max/exp/sum run in f32, the
// weights are rounded to the input type before P.V, and P.V accumulates in
// f32.
//
// What bounds it on the H100: the two products are 4*T*T*d FLOPs per head
// against 4*T*d elements of input and output, so at the UNet's T = 1024,
// d = 64 the kernel is compute-bound; this first version runs both products
// on the f32 FMA pipes (no tensor cores), so it is bound by FMA issue and
// shared-memory bandwidth, not by HBM.
//
// What the design does about it:
//   * the TPU kernel holds all of a head's K/V in VMEM; at T = 1024, d = 64
//     bf16 that is 256 KiB, more than a Hopper block's 227 KB. Here a block
//     loops over K/V tiles with an online softmax (running max m, running
//     sum l, rescaled accumulator), so shared memory is O(tile * d);
//   * the logits and weights never leave the SM: S and the accumulator live
//     in registers, P in shared memory for one tile;
//   * each thread computes a register tile of S (ROWS x SCOLS) and of the
//     output (ROWS x d/16) from shared memory, ~3 FMAs per shared load;
//   * shared rows are padded by one float so column reads are free of bank
//     conflicts;
//   * qkv is read in place through strides, in either head order, so the
//     wrapper never copies q, k and v apart; any T works, the ragged edge is
//     masked;
//   * no atomics: every output element is written by one thread in a fixed
//     order, so results are the same from run to run.
// wgmma/TMA and tensor cores are later work.

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

// Round an f32 value to T and back: the "(x * s).astype(x.dtype)" of the TPU kernel.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

constexpr int kThreads = 128;  // 4 warps; thread t -> (tx = t % 16, ty = t / 16)

template <int D> struct Tile {
  static constexpr int BQ = D <= 128 ? 64 : 32;   // query rows per block
  static constexpr int BK = D <= 64 ? 64 : 32;    // keys per K/V tile
  static constexpr int LD = D + 1;                // padded row stride (floats)
  static constexpr int LDP = BK + 1;
  static constexpr int ROWS = BQ / 8;             // rows per thread
  static constexpr int SCOLS = BK / 16;           // logits columns per thread
  static constexpr int OCOLS = D / 16;            // output columns per thread
  static constexpr size_t smem_bytes =
      sizeof(float) * (size_t(BQ) * LD + 2 * size_t(BK) * LD + size_t(BQ) * LDP);
};

// qkv: (B, T, 3C) with row stride 3C. For head h, q starts at channel
// h*head_stride, k at that + part_stride, v at that + 2*part_stride
// (legacy order: head_stride 3D, part_stride D; new order: D and C).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int Tn, int H,
                     int head_stride, int part_stride, float scale) {
  using P = Tile<D>;
  extern __shared__ float smem[];
  float* Qs = smem;                         // BQ x LD
  float* Ks = Qs + P::BQ * P::LD;           // BK x LD
  float* Vs = Ks + P::BK * P::LD;           // BK x LD
  float* Ps = Vs + P::BK * P::LD;           // BQ x LDP

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * P::BQ;
  const long long row_stride = 3LL * H * D;
  const long long C = (long long)H * D;
  const T* base = qkv + (long long)b * Tn * row_stride + (long long)h * head_stride;

  for (int i = tid; i < P::BQ * D; i += kThreads) {
    const int r = i / D, c = i - (i / D) * D;
    const int q = q0 + r;
    float v = 0.f;
    if (q < Tn) v = round_to<T>(to_f32(base[(long long)q * row_stride + c]) * scale);
    Qs[r * P::LD + c] = v;
  }

  float m[P::ROWS], l[P::ROWS], acc[P::ROWS][P::OCOLS];
#pragma unroll
  for (int i = 0; i < P::ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < P::OCOLS; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Tn; k0 += P::BK) {
    __syncthreads();  // previous tile's K/V/P reads are done (and Qs is written)
    for (int i = tid; i < P::BK * D; i += kThreads) {
      const int r = i / D, c = i - (i / D) * D;
      const int k = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (k < Tn) {
        const T* row = base + (long long)k * row_stride + c;
        kv = round_to<T>(to_f32(row[part_stride]) * scale);
        vv = to_f32(row[2 * part_stride]);
      }
      Ks[r * P::LD + c] = kv;
      Vs[r * P::LD + c] = vv;
    }
    __syncthreads();

    // S = Qs Ks^T for rows ty + 8i, columns tx + 16j
    float s[P::ROWS][P::SCOLS];
#pragma unroll
    for (int i = 0; i < P::ROWS; ++i)
#pragma unroll
      for (int j = 0; j < P::SCOLS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[P::ROWS], kv[P::SCOLS];
#pragma unroll
      for (int i = 0; i < P::ROWS; ++i) qv[i] = Qs[(ty + 8 * i) * P::LD + dd];
#pragma unroll
      for (int j = 0; j < P::SCOLS; ++j) kv[j] = Ks[(tx + 16 * j) * P::LD + dd];
#pragma unroll
      for (int i = 0; i < P::ROWS; ++i)
#pragma unroll
        for (int j = 0; j < P::SCOLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax over this tile; a row's 16 column-owners are the 16
    // lanes of one half-warp, so xor-shuffles 1..8 reduce exactly one row
#pragma unroll
    for (int i = 0; i < P::ROWS; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < P::SCOLS; ++j) {
        if (k0 + tx + 16 * j >= Tn) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);  // finite: column k0 is always a real key
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < P::SCOLS; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 8 * i) * P::LDP + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < P::OCOLS; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();  // a row of Ps is written and read by the same half-warp

    // acc += P V for rows ty + 8i, output columns tx + 16j
#pragma unroll 4
    for (int kk = 0; kk < P::BK; ++kk) {
      float pv[P::ROWS], vv[P::OCOLS];
#pragma unroll
      for (int i = 0; i < P::ROWS; ++i) pv[i] = Ps[(ty + 8 * i) * P::LDP + kk];
#pragma unroll
      for (int j = 0; j < P::OCOLS; ++j) vv[j] = Vs[kk * P::LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < P::ROWS; ++i)
#pragma unroll
        for (int j = 0; j < P::OCOLS; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  // out: (B, T, C), channel h*D + c (merge_heads order)
#pragma unroll
  for (int i = 0; i < P::ROWS; ++i) {
    const int q = q0 + ty + 8 * i;
    if (q >= Tn) continue;
    const float inv = 1.f / l[i];
    T* orow = out + ((long long)b * Tn + q) * C + (long long)h * D;
#pragma unroll
    for (int j = 0; j < P::OCOLS; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
int launch(const void* qkv, void* out, int B, int Tn, int H, int new_order, float scale,
           cudaStream_t stream) {
  using P = Tile<D>;
  auto kern = attention_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)P::smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int head_stride = new_order ? D : 3 * D;
  const int part_stride = new_order ? H * D : D;
  dim3 grid((Tn + P::BQ - 1) / P::BQ, B * H);
  kern<<<grid, kThreads, P::smem_bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), Tn, H, head_stride, part_stride, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* qkv, void* out, int B, int Tn, int H, int D, int new_order,
               float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(qkv, out, B, Tn, H, new_order, scale, stream);
    case 64: return launch<T, 64>(qkv, out, B, Tn, H, new_order, scale, stream);
    case 96: return launch<T, 96>(qkv, out, B, Tn, H, new_order, scale, stream);
    case 128: return launch<T, 128>(qkv, out, B, Tn, H, new_order, scale, stream);
    case 192: return launch<T, 192>(qkv, out, B, Tn, H, new_order, scale, stream);
    case 256: return launch<T, 256>(qkv, out, B, Tn, H, new_order, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code (0 = launched).
extern "C" int gdc_attention_fwd(const void* qkv, void* out, int B, int Tn, int H, int D,
                                 int new_order, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(qkv, out, B, Tn, H, D, new_order, scale, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(qkv, out, B, Tn, H, D, new_order, scale, s);
  return (int)cudaErrorInvalidValue;
}
