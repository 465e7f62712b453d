// Fused GroupNorm32 (+ adaGN scale-shift) (+ SiLU): kernel K3, three launches.
//
// Replaces guided_diffusion_clip_tpu/ops/pallas_groupnorm.py::fused_group_norm
// (its _stats_kernel, the (B, C)-sized glue, and _apply_kernel). x is
// (B, HW, C), channels contiguous, bf16 or f32.
//   stats:    per-(B, split, C) f32 partial sums of x and x^2 over a split of HW;
//   finalize: per (B, group): sum the partials, mean, var = E[x^2] - mean^2
//             (one-pass, as _gn_reference), and fold gamma/beta and the adaGN
//             (1 + scale, shift) into one per-(B, C) affine a, b; it also
//             writes the group's mean and rstd, which the backward reads;
//   apply:    y = [SiLU](x * a + b), written in x's dtype.
//
// What bounds it on the H100: stats and apply are bandwidth-bound (a few
// FLOPs per element, no tensor cores): the least traffic is one read of x for
// the stats and one read plus one write for the apply. At small maps the
// launches themselves bound it, so the (B, C) glue is one kernel, not a dozen
// small PyTorch ops.
//
// What the design does about it:
//   * the TPU stats pass carries its sums across a sequential grid axis; GPU
//     blocks run in parallel and in no order, so each stats block reduces one
//     (batch, HW split, channel tile) and writes a partial sum, and the
//     finalize kernel adds the partials in a fixed order (a fixed shuffle
//     tree). No float atomics, so the result is the same from run to run;
//   * the split count is chosen from the shape so that B = 8 at the UNet's
//     maps fills the card's 132 SMs several times over;
//   * each thread moves 16 bytes at a time (8 bf16 or 4 f32 channels) when C
//     and the pointers allow, and a warp covers 32 such vectors of one row,
//     so loads and stores are full, coalesced transactions;
//   * the apply pass keeps its channels' a and b in registers and walks rows,
//     so there is no per-element index division.

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

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

constexpr int kCT = 32;                // channel vectors per block (one warp-width)
constexpr int kRG = 8;                 // row groups per block
constexpr int kThreads = kCT * kRG;

// grid: (ceil(C / (32 * VEC)), splits, B). ps1/ps2: (B, splits, C) f32.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ ps1, float* __restrict__ ps2,
                int HW, int C, int rows_per_split) {
  __shared__ float sh1[kRG][kCT * VEC];
  __shared__ float sh2[kRG][kCT * VEC];
  const int tx = threadIdx.x % kCT;
  const int ty = threadIdx.x / kCT;
  const int c0 = (blockIdx.x * kCT + tx) * VEC;
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = split * rows_per_split;
  const int r1 = min(HW, r0 + rows_per_split);
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.f;
  if (c0 < C) {  // C % VEC == 0: a vector is wholly in range or wholly out
    const T* xb = x + (long long)b * HW * C + c0;
#pragma unroll 4
    for (int r = r0 + ty; r < r1; r += kRG) {
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xb + (long long)r * C);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float v = to_f32(p.v[j]);
        s1[j] += v;
        s2[j] += v * v;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sh1[ty][tx * VEC + j] = s1[j];
    sh2[ty][tx * VEC + j] = s2[j];
  }
  __syncthreads();
  if (ty == 0 && c0 < C) {
    const long long o = ((long long)b * gridDim.y + split) * C + c0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int g = 0; g < kRG; ++g) {
        t1 += sh1[g][tx * VEC + j];
        t2 += sh2[g][tx * VEC + j];
      }
      ps1[o + j] = t1;
      ps2[o + j] = t2;
    }
  }
}

// One warp per (b, group): lanes stride over the splits of every channel of
// the group, a fixed xor-shuffle tree combines them, then the lanes write the
// group's channels' a, b. ss/sb may be null (no scale-shift). stats: (2, B, G)
// f32, the mean then the rstd of every group.
__global__ void __launch_bounds__(32)
gn_finalize_kernel(const float* __restrict__ ps1, const float* __restrict__ ps2, int splits,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   const float* __restrict__ ss, const float* __restrict__ sb,
                   float* __restrict__ a, float* __restrict__ bo, float* __restrict__ stats,
                   int C, int G, float n, float eps) {
  const int b = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const int cg = C / G;
  const int lane = threadIdx.x;
  float t1 = 0.f, t2 = 0.f;
  for (int c = g * cg; c < (g + 1) * cg; ++c) {
    for (int s = lane; s < splits; s += 32) {
      const long long o = ((long long)b * splits + s) * C + c;
      t1 += ps1[o];
      t2 += ps2[o];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    t1 += __shfl_xor_sync(0xffffffffu, t1, o);
    t2 += __shfl_xor_sync(0xffffffffu, t2, o);
  }
  const float mean = t1 / n;
  const float var = t2 / n - mean * mean;
  const float inv = rsqrtf(var + eps);
  if (lane == 0) {
    stats[blockIdx.x] = mean;
    stats[gridDim.x + blockIdx.x] = inv;
  }
  for (int c = g * cg + lane; c < (g + 1) * cg; c += 32) {
    float av = inv * gamma[c];
    float bv = beta[c] - mean * av;
    if (ss != nullptr) {
      const float k = 1.f + ss[b * C + c];
      av *= k;
      bv = bv * k + sb[b * C + c];
    }
    a[b * C + c] = av;
    bo[b * C + c] = bv;
  }
}

// y = [silu](x * a[b, c] + bb[b, c]); same grid and thread layout as stats.
template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ bb, T* __restrict__ y, int HW, int C,
                int rows_per_split) {
  const int tx = threadIdx.x % kCT;
  const int ty = threadIdx.x / kCT;
  const int c0 = (blockIdx.x * kCT + tx) * VEC;
  const int b = blockIdx.z;
  if (c0 >= C) return;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(HW, r0 + rows_per_split);
  float ac[VEC], bc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    ac[j] = a[b * C + c0 + j];
    bc[j] = bb[b * C + c0 + j];
  }
  const long long off = (long long)b * HW * C + c0;
  const T* xb = x + off;
  T* yb = y + off;
#pragma unroll 4
  for (int r = r0 + ty; r < r1; r += kRG) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xb + (long long)r * C);
    Pack<T, VEC> q;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = to_f32(p.v[j]) * ac[j] + bc[j];
      if (SILU) v = v / (1.f + expf(-v));
      q.v[j] = from_f32<T>(v);
    }
    *reinterpret_cast<Pack<T, VEC>*>(yb + (long long)r * C) = q;
  }
}

template <typename T, int VEC>
int run(const T* x, float* ps1, float* ps2, const float* gamma, const float* beta,
        const float* ss, const float* sb, float* a, float* bb, float* stats, T* y, int B,
        int HW, int C, int G, float eps, int silu, int splits, cudaStream_t stream) {
  const int rows_per_split = (HW + splits - 1) / splits;
  const dim3 grid((C + kCT * VEC - 1) / (kCT * VEC), splits, B);
  gn_stats_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(x, ps1, ps2, HW, C, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_finalize_kernel<<<B * G, 32, 0, stream>>>(ps1, ps2, splits, gamma, beta, ss, sb, a, bb, stats,
                                                C, G, (float)HW * (float)(C / G), eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (silu)
    gn_apply_kernel<T, VEC, true><<<grid, kThreads, 0, stream>>>(x, a, bb, y, HW, C, rows_per_split);
  else
    gn_apply_kernel<T, VEC, false><<<grid, kThreads, 0, stream>>>(x, a, bb, y, HW, C, rows_per_split);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_vec(const void* x, void* ps1, void* ps2, const void* gamma, const void* beta,
                 const void* ss, const void* sb, void* a, void* bb, void* stats, void* y, int B,
                 int HW, int C, int G, float eps, int silu, int splits, int vec,
                 cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  float* p1 = static_cast<float*>(ps1);
  float* p2 = static_cast<float*>(ps2);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  const float* ssp = static_cast<const float*>(ss);
  const float* sbp = static_cast<const float*>(sb);
  float* ap = static_cast<float*>(a);
  float* bbp = static_cast<float*>(bb);
  float* stp = static_cast<float*>(stats);
  T* yp = static_cast<T*>(y);
  if (vec == 1)
    return run<T, 1>(xp, p1, p2, gp, bp, ssp, sbp, ap, bbp, stp, yp, B, HW, C, G, eps, silu, splits,
                     stream);
  if (vec == kWide)
    return run<T, kWide>(xp, p1, p2, gp, bp, ssp, sbp, ap, bbp, stp, yp, B, HW, C, G, eps, silu,
                         splits, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, y: (B, HW, C) in dtype (0 = float32, 1 = bfloat16); ps1, ps2: (B, splits, C)
// f32 scratch; gamma, beta: (C,) f32; ss, sb: (B, C) f32 or null; a, bb: (B, C)
// f32 scratch; stats: (2, B, G) f32 out, each group's mean and rstd. vec:
// channels per thread, 1 or 16 bytes' worth (C % vec == 0 and x, y 16-byte
// aligned). Returns a cudaError_t code (0 = launched).
extern "C" int gdc_group_norm(const void* x, void* ps1, void* ps2, const void* gamma,
                              const void* beta, const void* ss, const void* sb, void* a,
                              void* bb, void* stats, void* y, int B, int HW, int C, int G,
                              float eps, int silu, int splits, int vec, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_vec<float>(x, ps1, ps2, gamma, beta, ss, sb, a, bb, stats, y, B, HW, C, G, eps,
                               silu, splits, vec, s);
  if (dtype == 1)
    return dispatch_vec<__nv_bfloat16>(x, ps1, ps2, gamma, beta, ss, sb, a, bb, stats, y, B, HW, C,
                                       G, eps, silu, splits, vec, s);
  return (int)cudaErrorInvalidValue;
}
