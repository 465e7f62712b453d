// Fused GroupNorm32 (+ adaGN scale-shift) (+ SiLU), kernel K3, and the
// quantizing GroupNorm of the int8 path, kernel K4: one persistent
// cooperative launch a call, one kernel template for both.
//
// K3 replaces guided_diffusion_clip_tpu/ops/pallas_groupnorm.py::fused_group_norm
// (its _stats_kernel, the (B, C)-sized glue, and _apply_kernel); K4 replaces
// pallas_groupnorm.py::_fused_gn_quant_impl (its _stats_minmax_kernel,
// _bound_scale and _apply_quant_kernel). x is (B, HW, C), channels
// contiguous, bf16 or f32. The function:
//   per (image, group): mean, var = E[x^2] - mean^2 (one-pass, f32, as
//   _gn_reference), rstd = rsqrt(var + eps); per channel the folded affine
//   a' = rstd gamma, b' = beta - mean a', then a = a' (1 + ss), b = b' (1 + ss) + sb;
//   K3: y = [SiLU](x a + b) in x's dtype;
//   K4: the exact per-image scale s = max(bound, 1e-6) / 127 with bound =
//   max over channels of max(|a xmax + b|, |a xmin + b|), floored at 0.2785
//   under SiLU, and q = clip(rint([SiLU](x a + b) / s), -127, 127) as s8 or
//   as integer values in x's dtype. K4's affine and bound use unfused
//   multiply-adds (__fmul_rn/__fadd_rn), as the reference rounds them.
// Both write each group's mean and rstd to stats (2, B, G), which the
// backward reads; K4 writes scales (2, B): s, then 1/s.
//
// What bounds it on the H100: bytes. A few operations an element and no
// tensor cores; the least traffic is one read of x and one write of y. The
// statistics need all of a group before the first y, so a plain design
// reads x twice; at the UNet's 256 px maps x (up to 268 MB at batch 8) is
// far larger than the 50 MB L2, so the second read came from HBM too, and
// three launches a call cost more than the work at the small maps.
//
// What the design does about it:
//   * one launch: the grid is the co-resident block count (one block of 768
//     threads an SM), launched cooperatively, and walks the tensor in chunks
//     of whole (image, group) pairs that the L2 can hold. The chunks come
//     as a table from ops/groupnorm.py::_schedule (several whole images, or
//     a range of whole groups of one image; K4's chunk is whole images, since
//     its scale couples all of an image's channels), with each image's blocks
//     and rows a block: the kernel walks that table and computes no schedule
//     of its own. Per chunk: stats, a grid barrier, the fold, [K4: a second
//     barrier,] the apply;
//   * one stream of copies a thread: its rows of chunk 0 for the stats, the
//     same rows for the apply, then chunk 1's twice, and so on, 16 bytes a
//     copy through the thread's own ring of 10 cp.async stages in shared
//     memory (120 KB in flight an SM; one block an SM has too few threads to
//     cover the memory's latency with loads into registers). The copies run
//     10 rows ahead of their use across the phases' ends, so the memory stays
//     busy while the block reduces, waits at a barrier and folds;
//   * stats: block k sums its fixed range of the chunk's rows and writes its
//     per-group sums to slot k of a scratch buffer laid out (parity, sum,
//     group, block), double-buffered by chunk parity, so a fast block's next
//     chunk never overwrites what a slow block is still folding. The fold:
//     every block of an image folds that image's groups from the slots
//     (lanes across neighbouring slots, then a fixed xor-shuffle tree), so
//     all of them compute the same bits and no second barrier is needed; the
//     redundant reads are at most 132 slots x 32 groups x 8 bytes = 34 KB a
//     block, from the L2. (Slots laid out block-major put each lane on its
//     own L2 line and every block on the same lines, which made the fold the
//     largest cost of a chunk.) The first block of the image writes the
//     group's mean and rstd;
//   * the apply re-reads the block's rows last-read first: with a chunk about
//     the size of what the L2 keeps beside the output, the rows read last are
//     the likeliest still there (on the H100 it beat the statistics' order
//     at every map timed, PERF.md); y is stored streaming (evict-first), so
//     it pushes little of the chunk out;
//   * no float atomics: every sum has a fixed order, so a repeat call gives
//     the same bits.
//
// K4's per-image bound without its extremes in global memory: each block
// keeps its own rows' per-channel min and max in shared memory; after the
// fold it knows every a_c and b_c, so it computes its local bound
// max_c max(|fl(fl(a_c mx_ck) + b_c)|, |fl(fl(a_c mn_ck) + b_c)|). v ->
// fl(fl(a v) + b) is monotone in v (each rounding is monotone), so over any
// set of values inside [mn_c, mx_c] its absolute value peaks at one of the
// two ends; every block's ends lie inside the image's, and some block holds
// each of the image's ends. So the max of the blocks' local bounds equals
// the bound from the image's global extremes bit for bit. The blocks
// combine them with a max over per-block slots (exact in any order) after a
// second grid barrier.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// exact for the integers in [-127, 127] that K4 writes
template <> __device__ __forceinline__ int8_t from_f32<int8_t>(float v) {
  return static_cast<int8_t>(__float2int_rn(v));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// the output: written once, read by the next layer, so a streaming store
template <typename Q, int VEC>
__device__ __forceinline__ void store_stream(Q* p, const Pack<Q, VEC>& v) {
  if constexpr (sizeof(v) == 16) {
    __stcs(reinterpret_cast<int4*>(p), *reinterpret_cast<const int4*>(&v));
  } else if constexpr (sizeof(v) == 8) {
    __stcs(reinterpret_cast<int2*>(p), *reinterpret_cast<const int2*>(&v));
  } else if constexpr (sizeof(v) == 4) {
    __stcs(reinterpret_cast<int*>(p), *reinterpret_cast<const int*>(&v));
  } else {
    *reinterpret_cast<Pack<Q, VEC>*>(p) = v;
  }
}

// A thread's per-channel min and max of x (K4). bf16 keeps them as packed
// bf16 pairs (a min or max of bf16 values is exact in bf16), half the
// registers of f32.
template <typename T, int VEC>
struct Extremes {
  float mn[VEC], mx[VEC];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mn[j] = INFINITY;
      mx[j] = -INFINITY;
    }
  }
  __device__ __forceinline__ void update(const Pack<T, VEC>& p) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mn[j] = fminf(mn[j], to_f32(p.v[j]));
      mx[j] = fmaxf(mx[j], to_f32(p.v[j]));
    }
  }
  __device__ __forceinline__ float lo(int j) const { return mn[j]; }
  __device__ __forceinline__ float hi(int j) const { return mx[j]; }
};

template <>
struct Extremes<__nv_bfloat16, 8> {
  __nv_bfloat162 mn[4], mx[4];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mn[j] = __float2bfloat162_rn(INFINITY);
      mx[j] = __float2bfloat162_rn(-INFINITY);
    }
  }
  __device__ __forceinline__ void update(const Pack<__nv_bfloat16, 8>& p) {
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(p.v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mn[j] = __hmin2(mn[j], v[j]);
      mx[j] = __hmax2(mx[j], v[j]);
    }
  }
  __device__ __forceinline__ float lo(int j) const {
    return to_f32(j % 2 ? mn[j / 2].y : mn[j / 2].x);
  }
  __device__ __forceinline__ float hi(int j) const {
    return to_f32(j % 2 ? mx[j / 2].y : mx[j / 2].x);
  }
};

constexpr int kThreads = 768;  // one block an SM; 85 registers a thread at most, none spilled
constexpr int kWarps = kThreads / 32;
constexpr int kDepth = 10;  // a thread's 16-byte copies in flight: 120 KB an SM

struct Params {
  const void* x;
  void* out;
  // slots: (2 parities, 2 sums, ng, grid) f32 per-block group sums, then
  // (grid,) f32 per-block bounds (K4)
  float* slots;
  const float* gamma;
  const float* beta;
  const float* ss;  // (B, C) f32 or null
  const float* sb;
  float* stats;   // (2, B, G)
  float* scales;  // (2, B), K4
  // (n_chunks, 6) int32, a chunk a row: b0, images, g0, groups, blocks an
  // image, rows a block (ops/groupnorm.py::_schedule)
  const int* chunks;
  int B, HW, C, G;
  int n_chunks, ng;  // ng: the most groups a chunk holds
  float eps;
};

// Dynamic shared memory, in floats: the threads' rings of 16-byte copies
// (vec > 1), two (rows side by side, chunk channels) reduction buffers of
// kThreads * vec each, then a and b (and K4's min and max) for up to
// ng * C / G channels, then each group's mean and rstd.
__host__ __device__ constexpr int ring_floats(int vec) { return vec > 1 ? kDepth * kThreads * 4 : 0; }
__host__ __device__ constexpr int smem_floats(int vec, int nc_max, int ng, bool quant) {
  return ring_floats(vec) + 2 * kThreads * vec + (quant ? 4 : 2) * nc_max + 2 * ng;
}

// Row ci of the chunk table and thread tid's share of it in block k: the
// chunk's groups g0 .. g0+ngi-1 (nc channels from c0) of image b, nv = nc /
// VEC vectors a row, rows of them walked side by side (thread tid takes
// vector cv of the rows ry, ry + rows, ...); bpi blocks an image, block k the
// rows [r0, r1) of image b, the thread mine of them, the first at x + first.
struct Geom {
  int b, g0, ngi, nc, c0, cv, ry, rows, bpi, part, r0, r1, mine;
  bool on;
  long long first;
};

template <int VEC>
__device__ __forceinline__ Geom geom(const Params& p, int ci, int k, int tid) {
  Geom g;
  const int* row = p.chunks + 6 * ci;
  const int b0 = __ldg(row), nbi = __ldg(row + 1), rpb = __ldg(row + 5);
  g.g0 = __ldg(row + 2);
  g.ngi = __ldg(row + 3);
  g.bpi = __ldg(row + 4);
  g.nc = g.ngi * (p.C / p.G);
  g.c0 = g.g0 * (p.C / p.G);
  const int nv = g.nc / VEC;  // C / G * ng % VEC == 0
  g.rows = kThreads / nv;
  g.cv = tid % nv;
  g.ry = tid / nv;
  g.on = k < nbi * g.bpi;
  g.b = b0 + (g.on ? k / g.bpi : 0);
  g.part = k % g.bpi;
  g.r0 = g.on ? min(p.HW, g.part * rpb) : 0;
  g.r1 = g.on ? min(p.HW, g.r0 + rpb) : 0;
  g.mine = g.ry < g.rows && g.r1 - g.r0 > g.ry ? (g.r1 - g.r0 - g.ry + g.rows - 1) / g.rows : 0;
  g.first = ((long long)g.b * p.HW + g.r0 + g.ry) * p.C + g.c0 + g.cv * VEC;
  return g;
}

// One thread's rows of x as one stream: chunk 0's rows for the statistics,
// the same rows again for the apply, then chunk 1's twice, and so on. With
// 16-byte vectors they come through the thread's own ring of kDepth cp.async
// stages in shared memory (stage i at ring + i * kThreads * 16 bytes): the
// copies run kDepth rows ahead of their use across the phases' ends, so the
// memory stays busy while the block reduces, waits at a barrier and folds,
// the loads in flight hold no registers, and the thread needs no barrier to
// reuse its stages. Narrower vectors are loaded directly when used.
template <typename T, int VEC>
struct RowStream {
  static constexpr bool kAsync = sizeof(Pack<T, VEC>) == 16;
  char* ring;
  // the next copy: seg = 2 * chunk + pass (0 the statistics, 1 the apply), left rows of it
  const T* src;
  int stride, seg, left, in, out;

  __device__ __forceinline__ void open(const Params& p, const T* x, int n_chunks, int k, int tid) {
    while (left == 0 && seg < 2 * n_chunks) {
      ++seg;
      if (seg == 2 * n_chunks) break;
      const Geom g = geom<VEC>(p, seg / 2, k, tid);
      src = x + g.first;
      stride = g.rows * p.C;
      left = g.mine;
      if (seg % 2 == 1 && left > 0) {  // the apply: last-read first
        src += (long long)(left - 1) * stride;
        stride = -stride;
      }
    }
  }
  // one more copy (or an empty group past the last row): one group a call
  __device__ __forceinline__ void produce(const Params& p, const T* x, int n_chunks, int k, int tid) {
    if constexpr (kAsync) {
      open(p, x, n_chunks, k, tid);
      if (left > 0) {
        gdc::cp_async_16(gdc::smem_u32(ring + in * kThreads * 16), src, true);
        src += stride;
        --left;
        in = in + 1 == kDepth ? 0 : in + 1;
      }
      gdc::cp_async_commit();
    }
  }
  // use(v, i) for the n rows of the current pass, base the first
  template <typename F>
  __device__ __forceinline__ void consume(int n, const T* base, int step, const Params& p, const T* x,
                                          int n_chunks, int k, int tid, F&& use) {
    for (int i = 0; i < n; ++i) {
      if constexpr (kAsync) {
        gdc::cp_async_wait<kDepth - 1>();  // the oldest copy, this row's, has landed
        use(*reinterpret_cast<const Pack<T, VEC>*>(ring + out * kThreads * 16), i);
        out = out + 1 == kDepth ? 0 : out + 1;
        produce(p, x, n_chunks, k, tid);  // after the use: the stage is read before it is refilled (in-order execution)
      } else {
        use(*reinterpret_cast<const Pack<T, VEC>*>(base + (long long)i * step), i);
      }
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, typename Q, int VEC, bool SILU, bool QUANT>
__global__ void __launch_bounds__(kThreads, 1) gn_fused_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_part[kWarps];
  __shared__ float s_inv;
  cg::grid_group grid = cg::this_grid();
  const T* x = static_cast<const T*>(p.x);
  Q* out = static_cast<Q*>(p.out);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k = blockIdx.x, nblk = gridDim.x;
  const int cgs = p.C / p.G;
  const int nc_max = p.ng * cgs;
  float* red1 = smem + ring_floats(VEC);
  float* red2 = red1 + kThreads * VEC;
  float* s_a = red2 + kThreads * VEC;
  float* s_b = s_a + nc_max;
  float* s_mn = s_b + nc_max;  // K4 only
  float* s_mx = s_mn + nc_max;
  float* s_mean = s_a + (QUANT ? 4 : 2) * nc_max;
  float* s_rstd = s_mean + p.ng;
  float* bslots = p.slots + 4 * nblk * p.ng;
  const float n = (float)p.HW * (float)cgs;
  const int n_chunks = p.n_chunks;

  RowStream<T, VEC> rs{reinterpret_cast<char*>(smem) + tid * 16, x, 0, -1, 0, 0, 0};
  for (int i = 0; i < kDepth; ++i) rs.produce(p, x, n_chunks, k, tid);

  for (int ci = 0; ci < n_chunks; ++ci) {
    const Geom gm = geom<VEC>(p, ci, k, tid);
    const T* xr = x + gm.first;
    const int step = gm.rows * p.C;

    // ---- stats: this block's rows, per channel, then per group into its slot
    float s1[VEC], s2[VEC];
    Extremes<T, VEC> ext;
#pragma unroll
    for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.f;
    if constexpr (QUANT) ext.init();
    rs.consume(gm.mine, xr, step, p, x, n_chunks, k, tid, [&](const Pack<T, VEC>& v, int) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f32(v.v[j]);
        s1[j] += f;
        s2[j] += f * f;
      }
      if constexpr (QUANT) ext.update(v);
    });
    if (gm.ry < gm.rows) {
      Pack<float, VEC> u1, u2;  // whole vectors: a scalar store a channel would conflict 8 ways
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        u1.v[j] = s1[j];
        u2.v[j] = s2[j];
      }
      *reinterpret_cast<Pack<float, VEC>*>(red1 + gm.ry * gm.nc + gm.cv * VEC) = u1;
      *reinterpret_cast<Pack<float, VEC>*>(red2 + gm.ry * gm.nc + gm.cv * VEC) = u2;
    }
    __syncthreads();
    // slots: (parity, sum of x or of x^2, group, block), so a fold's lanes read neighbours;
    // one warp a group: lanes across (row lane, channel), then a fixed tree
    float* slot = p.slots + (ci & 1) * 2 * p.ng * nblk + k;
    for (int g = warp; g < gm.ngi; g += kWarps) {
      float t1 = 0.f, t2 = 0.f;
      for (int i = lane; i < gm.rows * cgs; i += 32) {
        const int o = i / cgs * gm.nc + g * cgs + i % cgs;
        t1 += red1[o];
        t2 += red2[o];
      }
      t1 = warp_sum(t1);
      t2 = warp_sum(t2);
      if (lane == 0) {
        slot[g * nblk] = t1;
        slot[(p.ng + g) * nblk] = t2;
      }
    }
    if constexpr (QUANT) {
      __syncthreads();
      if (gm.ry < gm.rows) {
        Pack<float, VEC> u1, u2;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          u1.v[j] = ext.lo(j);
          u2.v[j] = ext.hi(j);
        }
        *reinterpret_cast<Pack<float, VEC>*>(red1 + gm.ry * gm.nc + gm.cv * VEC) = u1;
        *reinterpret_cast<Pack<float, VEC>*>(red2 + gm.ry * gm.nc + gm.cv * VEC) = u2;
      }
      __syncthreads();
      for (int c = tid; c < gm.nc; c += kThreads) {
        float mn = INFINITY, mx = -INFINITY;
        for (int r = 0; r < gm.rows; ++r) {
          mn = fminf(mn, red1[r * gm.nc + c]);
          mx = fmaxf(mx, red2[r * gm.nc + c]);
        }
        s_mn[c] = mn;
        s_mx[c] = mx;
      }
    }
    // the affine's inputs for this thread's first channel, under the barrier
    const int cc0 = gm.c0 + tid;
    const bool pre = gm.on && tid < gm.nc;
    const float g_pre = pre ? p.gamma[cc0] : 0.f, be_pre = pre ? p.beta[cc0] : 0.f;
    const float k_pre = pre && p.ss != nullptr ? p.ss[gm.b * p.C + cc0] : 0.f;
    const float sh_pre = pre && p.ss != nullptr ? p.sb[gm.b * p.C + cc0] : 0.f;
    grid.sync();

    // ---- fold: every block of image b folds b's groups of the chunk, in the
    // same order, from the L2 (the slots are rewritten every other chunk)
    if (gm.on) {
      const float* base = p.slots + (ci & 1) * 2 * p.ng * nblk + (k - gm.part);
      for (int g = warp; g < gm.ngi; g += kWarps) {
        float t1 = 0.f, t2 = 0.f;
#pragma unroll 4
        for (int s = lane; s < gm.bpi; s += 32) {
          t1 += __ldcg(base + g * nblk + s);
          t2 += __ldcg(base + (p.ng + g) * nblk + s);
        }
        t1 = warp_sum(t1);
        t2 = warp_sum(t2);
        const float mean = t1 / n;
        const float var = t2 / n - mean * mean;
        const float rstd = rsqrtf(var + p.eps);
        if (lane == 0) {
          s_mean[g] = mean;
          s_rstd[g] = rstd;
          if (gm.part == 0) {
            p.stats[gm.b * p.G + gm.g0 + g] = mean;
            p.stats[(p.B + gm.b) * p.G + gm.g0 + g] = rstd;
          }
        }
      }
    }
    __syncthreads();
    float bound = 0.f;
    if (gm.on) {
      for (int c = tid; c < gm.nc; c += kThreads) {
        const int g = c / cgs, cc = gm.c0 + c;
        const bool first = c == tid;
        float av = s_rstd[g] * (first ? g_pre : p.gamma[cc]);
        float bv = (first ? be_pre : p.beta[cc]) - s_mean[g] * av;
        if (p.ss != nullptr) {
          const float kk = 1.f + (first ? k_pre : p.ss[gm.b * p.C + cc]);
          av *= kk;
          bv = bv * kk + (first ? sh_pre : p.sb[gm.b * p.C + cc]);
        }
        s_a[c] = av;
        s_b[c] = bv;
        if (QUANT && gm.r0 < gm.r1) {
          // unfused multiply and add, as the reference rounds them
          const float hi = fabsf(__fadd_rn(__fmul_rn(av, s_mx[c]), bv));
          const float lo = fabsf(__fadd_rn(__fmul_rn(av, s_mn[c]), bv));
          bound = fmaxf(bound, fmaxf(hi, lo));
        }
      }
    }
    if constexpr (QUANT) {
      bound = warp_max(bound);
      if (lane == 0) s_part[warp] = bound;
      __syncthreads();
      if (warp == 0) {
        bound = warp_max(lane < kWarps ? s_part[lane] : 0.f);
        if (lane == 0) bslots[k] = bound;
      }
      grid.sync();
      if (gm.on && warp == 0) {
        float m = 0.f;
#pragma unroll 4
        for (int s = lane; s < gm.bpi; s += 32) m = fmaxf(m, __ldcg(bslots + k - gm.part + s));
        m = warp_max(m);
        if (SILU) m = fmaxf(m, 0.2785f);
        const float sc = fmaxf(m, 1e-6f) * (1.0f / 127.0f);
        if (lane == 0) {
          s_inv = 1.0f / sc;
          if (gm.part == 0) {
            p.scales[gm.b] = sc;
            p.scales[p.B + gm.b] = 1.0f / sc;
          }
        }
      }
    }
    __syncthreads();

    // ---- apply: the same rows, last-read first, now from the L2
    const float ib = QUANT ? s_inv : 0.f;
    Q* const yr = out + gm.first;
    const long long last = (long long)(gm.mine - 1) * step;  // the apply's first row
    const int dir = -step;
    rs.consume(gm.mine, xr + last, dir, p, x, n_chunks, k, tid, [&](const Pack<T, VEC>& v, int i) {
      // a and b from shared memory on every row: registers are what bounds the threads an SM
      const Pack<float, VEC> ac = *reinterpret_cast<const Pack<float, VEC>*>(s_a + gm.cv * VEC);
      const Pack<float, VEC> bc = *reinterpret_cast<const Pack<float, VEC>*>(s_b + gm.cv * VEC);
      Pack<Q, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if constexpr (QUANT) {
          float y = __fadd_rn(__fmul_rn(to_f32(v.v[j]), ac.v[j]), bc.v[j]);
          if (SILU) y = y / (1.f + expf(-y));
          // rint rounds half to even, like torch.round and jnp.round
          o.v[j] = from_f32<Q>(fminf(fmaxf(rintf(__fmul_rn(y, ib)), -127.f), 127.f));
        } else {
          float y = to_f32(v.v[j]) * ac.v[j] + bc.v[j];
          // the fast exponential and division: a few ulp, far inside K3's tolerance
          if (SILU) y = __fdividef(y, 1.f + __expf(-y));
          o.v[j] = from_f32<Q>(y);
        }
      }
      store_stream<Q, VEC>(yr + last + (long long)i * dir, o);
    });
  }
  if constexpr (RowStream<T, VEC>::kAsync) gdc::cp_async_wait<0>();
}

template <typename T, typename Q, bool QUANT>
const void* pick(int vec, int silu) {
  constexpr int kWide = 16 / sizeof(T);
  if (vec == 1)
    return silu ? (const void*)gn_fused_kernel<T, Q, 1, true, QUANT>
                : (const void*)gn_fused_kernel<T, Q, 1, false, QUANT>;
  if (vec == kWide)
    return silu ? (const void*)gn_fused_kernel<T, Q, kWide, true, QUANT>
                : (const void*)gn_fused_kernel<T, Q, kWide, false, QUANT>;
  return nullptr;
}

// The kernel for (quant, dtype 0 = float32 / 1 = bfloat16, s8, vec, silu), or null.
const void* resolve(int quant, int dtype, int s8, int vec, int silu) {
  if (!quant) {
    if (dtype == 0) return pick<float, float, false>(vec, silu);
    if (dtype == 1) return pick<__nv_bfloat16, __nv_bfloat16, false>(vec, silu);
    return nullptr;
  }
  if (dtype == 0) return s8 ? pick<float, int8_t, true>(vec, silu) : pick<float, float, true>(vec, silu);
  if (dtype == 1)
    return s8 ? pick<__nv_bfloat16, int8_t, true>(vec, silu)
              : pick<__nv_bfloat16, __nv_bfloat16, true>(vec, silu);
  return nullptr;
}

// Sets the kernel's dynamic shared memory and returns its size, or -1.
int prepare(const void* fn, int quant, int vec, int C, int G, int ng, cudaError_t* err) {
  const int bytes = (int)sizeof(float) * smem_floats(vec, ng * (C / G), ng, quant != 0);
  *err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return bytes;
}

int launch(int quant, int dtype, int s8, int vec, int silu, int grid, Params p, cudaStream_t stream) {
  const void* fn = resolve(quant, dtype, s8, vec, silu);
  if (fn == nullptr || p.chunks == nullptr || p.n_chunks < 1 || p.C % p.G || (p.ng * (p.C / p.G)) % vec ||
      p.ng * (p.C / p.G) / vec > kThreads)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const int bytes = prepare(fn, quant, vec, p.C, p.G, p.ng, &err);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, (size_t)bytes, stream);
}

}  // namespace

// The co-resident block count of the kernel for these arguments (blocks an
// SM times SMs) into *blocks: the largest grid a cooperative launch takes.
// ng: groups a chunk (it sizes the shared memory). Returns a cudaError_t code.
extern "C" int gdc_group_norm_blocks(int quant, int dtype, int s8, int vec, int silu, int C, int G,
                                     int ng, int* blocks) {
  const void* fn = resolve(quant, dtype, s8, vec, silu);
  if (fn == nullptr || G < 1 || C % G) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const int bytes = prepare(fn, quant, vec, C, G, ng, &err);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, per_sm = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, (size_t)bytes);
  *blocks = per_sm * sms;
  return (int)err;
}

// K3. x, y: (B, HW, C) in dtype (0 = float32, 1 = bfloat16); slots: f32
// scratch of 4 * grid * ng floats; gamma, beta: (C,) f32; ss, sb: (B, C) f32
// or null; stats: (2, B, G) f32 out, each group's mean and rstd. vec:
// channels a thread, 1 or 16 bytes' worth (C % vec == 0, x and y 16-byte
// aligned). grid, chunks (the (n_chunks, 6) int32 table on the device), ng
// (the most groups a chunk): the schedule (ops/groupnorm.py::_schedule).
// Returns a cudaError_t code (0 = launched).
extern "C" int gdc_group_norm(const void* x, void* slots, const void* gamma, const void* beta,
                              const void* ss, const void* sb, void* stats, void* y, int B, int HW,
                              int C, int G, float eps, int silu, int vec, int dtype, int grid,
                              const void* chunks, int n_chunks, int ng, void* stream) {
  const Params p{x, y, static_cast<float*>(slots), static_cast<const float*>(gamma),
                 static_cast<const float*>(beta), static_cast<const float*>(ss),
                 static_cast<const float*>(sb), static_cast<float*>(stats), nullptr,
                 static_cast<const int*>(chunks), B, HW, C, G, n_chunks, ng, eps};
  return launch(0, dtype, 0, vec, silu, grid, p, static_cast<cudaStream_t>(stream));
}

// K4. As gdc_group_norm, with slots of 4 * grid * ng + grid floats, scales:
// (2, B) f32 out (s, 1/s) and q: (B, HW, C) out, int8 when s8 != 0, else x's
// dtype (aligned like x). Its chunks are whole images (ng == G).
extern "C" int gdc_group_norm_quant(const void* x, void* slots, const void* gamma,
                                    const void* beta, const void* ss, const void* sb, void* stats,
                                    void* scales, void* q, int B, int HW, int C, int G, float eps,
                                    int silu, int vec, int dtype, int s8, int grid,
                                    const void* chunks, int n_chunks, int ng, void* stream) {
  if (ng != G) return (int)cudaErrorInvalidValue;
  const Params p{x, q, static_cast<float*>(slots), static_cast<const float*>(gamma),
                 static_cast<const float*>(beta), static_cast<const float*>(ss),
                 static_cast<const float*>(sb), static_cast<float*>(stats),
                 static_cast<float*>(scales), static_cast<const int*>(chunks), B, HW, C, G,
                 n_chunks, ng, eps};
  return launch(1, dtype, s8, vec, silu, grid, p, static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// K3 and K4 split at their statistics, for a map whose rows are spread over
// ranks (spatial partitioning, parallel/sp.py): the sums have to cross the
// ranks between the two phases, which a launch cannot wait for. So the two
// phases of the TPU kernels (pallas_groupnorm.py's _stats_kernel and
// _apply_kernel for K3, _stats_minmax_kernel and _apply_quant_kernel for K4)
// are two entries here, with the all-reduce and the fold (ops/groupnorm.py)
// between them:
//   gn_stats_kernel       per (image, group) the f32 sum and sum of squares of
//                         the rank's rows; with K4 also each channel's min and
//                         max. One block an (image, group): thread t takes
//                         channel t % (C/G) and the rows t / (C/G), + 256 /
//                         (C/G), ...; the sums reduce in a fixed tree, so a
//                         repeat gives the same bits;
//   gn_apply_kernel       K3's apply, y = [SiLU](x a + b) with the folded
//                         per-(image, channel) a, b, as gn_fused_kernel's;
//   gn_quant_apply_kernel K4's, q = clip(rint([SiLU](x a + b) / s)), with the
//                         unfused multiply-adds of the reference and the
//                         per-image 1/s.
// What bounds them: bytes, one read of x for the stats and one read of x and
// write of y for the apply. They are simple passes: the stats kernel reads a
// group's C/G channels of a row (16 to 64 bytes) at a time and has B * G
// blocks; a grid-stride loop of scalar loads applies.

namespace {

constexpr int kSplitThreads = 256;

template <typename T, bool EXT>
__global__ void __launch_bounds__(kSplitThreads)
gn_stats_kernel(const T* __restrict__ x, int HW, int C, int G, float* __restrict__ sums, float* __restrict__ ext) {
  __shared__ float w1[kSplitThreads / 32], w2[kSplitThreads / 32];
  __shared__ float lo[kSplitThreads], hi[kSplitThreads];
  const int B = gridDim.x / G, b = blockIdx.x / G, g = blockIdx.x % G;
  const int cg = C / G, rows = kSplitThreads / cg;
  const int j = threadIdx.x % cg, r0 = threadIdx.x / cg;
  float s1 = 0.f, s2 = 0.f, mn = INFINITY, mx = -INFINITY;
  if (r0 < rows) {
    const T* p = x + (long long)b * HW * C + g * cg + j;
    for (int r = r0; r < HW; r += rows) {
      const float v = to_f32(p[(long long)r * C]);
      s1 += v;
      s2 += v * v;
      if (EXT) {
        mn = fminf(mn, v);
        mx = fmaxf(mx, v);
      }
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    w1[warp] = s1;
    w2[warp] = s2;
  }
  if (EXT) {
    lo[threadIdx.x] = mn;
    hi[threadIdx.x] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int w = 0; w < kSplitThreads / 32; ++w) {
      t1 += w1[w];
      t2 += w2[w];
    }
    sums[b * G + g] = t1;
    sums[(B + b) * G + g] = t2;
  }
  if (EXT && threadIdx.x < cg) {
    float m0 = INFINITY, m1 = -INFINITY;
    for (int r = 0; r < rows; ++r) {
      m0 = fminf(m0, lo[r * cg + threadIdx.x]);
      m1 = fmaxf(m1, hi[r * cg + threadIdx.x]);
    }
    ext[b * C + g * cg + threadIdx.x] = m0;
    ext[(B + b) * C + g * cg + threadIdx.x] = m1;
  }
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(kSplitThreads)
gn_apply_kernel(const T* __restrict__ x, long long n, long long hwc, int C, const float* __restrict__ a,
                const float* __restrict__ b, T* __restrict__ y) {
  for (long long i = (long long)blockIdx.x * kSplitThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kSplitThreads) {
    const long long k = i / hwc * C + i % C;
    float v = to_f32(x[i]) * a[k] + b[k];
    if (SILU) v = __fdividef(v, 1.f + __expf(-v));  // as gn_fused_kernel's K3 apply
    y[i] = from_f32<T>(v);
  }
}

template <typename T, typename Q, bool SILU>
__global__ void __launch_bounds__(kSplitThreads)
gn_quant_apply_kernel(const T* __restrict__ x, long long n, long long hwc, int C, const float* __restrict__ a,
                      const float* __restrict__ b, const float* __restrict__ inv, Q* __restrict__ q) {
  for (long long i = (long long)blockIdx.x * kSplitThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kSplitThreads) {
    const long long img = i / hwc, k = img * C + i % C;
    float v = __fadd_rn(__fmul_rn(to_f32(x[i]), a[k]), b[k]);
    if (SILU) v = v / (1.f + expf(-v));
    q[i] = from_f32<Q>(fminf(fmaxf(rintf(__fmul_rn(v, inv[img])), -127.f), 127.f));
  }
}

int split_grid(long long n) {
  const long long want = (n + kSplitThreads - 1) / kSplitThreads;
  return (int)(want < 1 ? 1 : (want > 132 * 16 ? 132 * 16 : want));
}

template <typename T>
int launch_stats(const void* x, void* sums, void* ext, int B, int HW, int C, int G, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  if (ext != nullptr)
    gn_stats_kernel<T, true><<<B * G, kSplitThreads, 0, st>>>(xp, HW, C, G, static_cast<float*>(sums),
                                                               static_cast<float*>(ext));
  else
    gn_stats_kernel<T, false><<<B * G, kSplitThreads, 0, st>>>(xp, HW, C, G, static_cast<float*>(sums), nullptr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply(const void* x, const void* a, const void* b, void* y, int B, int HW, int C, int silu,
                 cudaStream_t st) {
  const long long n = (long long)B * HW * C, hwc = (long long)HW * C;
  const T* xp = static_cast<const T*>(x);
  const float *ap = static_cast<const float*>(a), *bp = static_cast<const float*>(b);
  if (silu)
    gn_apply_kernel<T, true><<<split_grid(n), kSplitThreads, 0, st>>>(xp, n, hwc, C, ap, bp, static_cast<T*>(y));
  else
    gn_apply_kernel<T, false><<<split_grid(n), kSplitThreads, 0, st>>>(xp, n, hwc, C, ap, bp, static_cast<T*>(y));
  return (int)cudaGetLastError();
}

template <typename T, typename Q>
int launch_quant_apply(const void* x, const void* a, const void* b, const void* inv, void* q, int B, int HW, int C,
                       int silu, cudaStream_t st) {
  const long long n = (long long)B * HW * C, hwc = (long long)HW * C;
  const T* xp = static_cast<const T*>(x);
  const float *ap = static_cast<const float*>(a), *bp = static_cast<const float*>(b);
  const float* ip = static_cast<const float*>(inv);
  if (silu)
    gn_quant_apply_kernel<T, Q, true><<<split_grid(n), kSplitThreads, 0, st>>>(xp, n, hwc, C, ap, bp, ip,
                                                                               static_cast<Q*>(q));
  else
    gn_quant_apply_kernel<T, Q, false><<<split_grid(n), kSplitThreads, 0, st>>>(xp, n, hwc, C, ap, bp, ip,
                                                                                static_cast<Q*>(q));
  return (int)cudaGetLastError();
}

}  // namespace

// The statistics of K3 (ext null) or K4 over x (B, HW, C) in dtype (0 =
// float32, 1 = bfloat16), contiguous: sums (2, B, G) f32, each group's sum and
// sum of squares; ext (2, B, C) f32, each channel's min and max. C / G <= 256.
// Returns a cudaError_t code (0 = launched).
extern "C" int gdc_group_norm_stats(const void* x, void* sums, void* ext, int B, int HW, int C, int G, int dtype,
                                    void* stream) {
  if (B < 1 || HW < 1 || G < 1 || C % G || C / G > kSplitThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_stats<float>(x, sums, ext, B, HW, C, G, st);
  if (dtype == 1) return launch_stats<__nv_bfloat16>(x, sums, ext, B, HW, C, G, st);
  return (int)cudaErrorInvalidValue;
}

// K3's apply: y (B, HW, C) = [SiLU](x a + b) in x's dtype, a and b (B, C) f32.
extern "C" int gdc_group_norm_apply(const void* x, const void* a, const void* b, void* y, int B, int HW, int C,
                                    int silu, int dtype, void* stream) {
  if (B < 1 || HW < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_apply<float>(x, a, b, y, B, HW, C, silu, st);
  if (dtype == 1) return launch_apply<__nv_bfloat16>(x, a, b, y, B, HW, C, silu, st);
  return (int)cudaErrorInvalidValue;
}

// K4's apply: q (B, HW, C) = clip(rint([SiLU](x a + b) * inv[b]), -127, 127),
// int8 when s8 != 0, else in x's dtype; inv (B,) f32, each image's 1/s.
extern "C" int gdc_group_norm_quant_apply(const void* x, const void* a, const void* b, const void* inv, void* q,
                                          int B, int HW, int C, int silu, int dtype, int s8, void* stream) {
  if (B < 1 || HW < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return s8 ? launch_quant_apply<float, int8_t>(x, a, b, inv, q, B, HW, C, silu, st)
              : launch_quant_apply<float, float>(x, a, b, inv, q, B, HW, C, silu, st);
  if (dtype == 1)
    return s8 ? launch_quant_apply<__nv_bfloat16, int8_t>(x, a, b, inv, q, B, HW, C, silu, st)
              : launch_quant_apply<__nv_bfloat16, __nv_bfloat16>(x, a, b, inv, q, B, HW, C, silu, st);
  return (int)cudaErrorInvalidValue;
}
