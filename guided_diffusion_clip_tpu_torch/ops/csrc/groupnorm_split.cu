// K3 and K4 split at their statistics: the kernels of a GroupNorm whose map
// is spread over ranks, so that the sums must cross the ranks between the
// two phases (spatial partitioning, parallel/sp.py: every GroupNorm; tensor
// parallelism, parallel/tp.py: every quantizing one, whose per-image scale
// spans all channels). Two kernels, with the all-reduce and the fold
// (ops/groupnorm.py::_fold, _bound_scale) between them:
//
//   gn_split_stats_kernel  replaces guided_diffusion_clip_tpu/ops/
//                          pallas_groupnorm.py::_stats_kernel (K3) and
//                          _stats_minmax_kernel (K4, EXT): per (image, group)
//                          the f32 sum and sum of squares of x, and with EXT
//                          each channel's min and max;
//   gn_split_apply_kernel  replaces _apply_kernel (K3: y = [SiLU](x a + b))
//                          and _apply_quant_kernel (K4, QUANT: q = clip(rint(
//                          [SiLU](x a + b) / s), -127, 127)), with the folded
//                          per-(image, channel) a, b and K4's per-image 1/s.
//
// x is (B, HW, C), channels contiguous, bf16 or f32. The first versions
// (groupnorm.cu: gn_stats_kernel, gn_apply_kernel, gn_quant_apply_kernel)
// stay there as the yardstick these are held to, on no path.
//
// What bounds them on the H100: bytes. A few operations an element and no
// tensor cores; the stats read x once, the apply reads x and writes y once.
// At 3.35 TB/s a map of a few MB is a few microseconds, so the card needs
// megabytes in flight at once, from every SM, and few instructions a byte.
//
// What the design does about it:
//   * row tiles that fill the SMs: block (b, k) takes rows [k HW / tiles,
//     (k + 1) HW / tiles) of image b, with tiles from ops/groupnorm.py::
//     _split_plan (2-4 blocks an SM wherever the map holds that many tiles
//     of its minimum size; the kernels compute no plan of their own);
//   * a thread owns one 16-byte channel vector (8 bf16 or 4 f32; 1 value
//     where C or the pointer does not allow 16 bytes), threads side by side
//     on a row, `lanes` rows side by side a block, and walks its rows with
//     16-byte loads, kUnroll of them in flight (the block's lanes * C / V
//     threads hold 16 kUnroll bytes each: 64 KB an SM at 4 blocks of 256);
//   * stats: each thread sums its channels in registers (K4's extremes as
//     packed bf16 pairs); at the end of its tile the block combines the
//     lanes per channel and the channels per group in shared memory, in a
//     fixed order, and writes its (image, group) partial sums to its own
//     scratch slot. The last block of an image to finish (an atomic counter
//     behind __threadfence) folds that image's slots in a fixed order (each
//     thread one output over every chunks-th tile, neighbouring threads on
//     neighbouring slots, then each output its chunks in turn), so a repeat
//     call gives the same bits. The extremes need no order: each block's
//     per-channel min and max go to the scratch by atomicMax on
//     order-preserving keys (min as the complemented key), which the image's
//     last block decodes;
//   * apply: a thread loads its a[b, c:c+V] and b[b, c:c+V] (K4: inv[b])
//     into registers once; the loop has no integer division, and y (K4: q,
//     8 bytes of s8 from 8 bf16) goes out as one streaming store. The
//     arithmetic per element is the first versions' (K3: x a + b
//     contracted to one FMA as there, __fdividef(v, 1 + __expf(-v)); K4:
//     unfused
//     __fmul_rn/__fadd_rn, v / (1 + expf(-v)), rintf(__fmul_rn(v, inv)),
//     the clip; for s8 the rounding goes after the clip, by the adder
//     (to_pack), which gives the same integers), so the outputs are
//     bit-identical to the first versions'. bf16 results are converted in
//     pairs, which rounds them as one at a time does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 512;  // lanes * C / V threads a block (ops/groupnorm.py::_SPLIT_MAX_THREADS)
constexpr int kUnroll = 4;        // a thread's 16-byte loads in flight
// K4's apply under SiLU keeps 2: its IEEE division's slow path, called with
// 4 loads live, spilled at 64 registers
constexpr int kUnrollQuantSilu = 2;
constexpr int kFold = 16;  // a thread's slot loads in flight in the fold

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

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// one load of a thread's vector; `last`: x's last read (the apply), evict-first
template <bool LAST, typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  Pack<T, V> out;
  if constexpr (sizeof(out) == 16) {
    const int4 w = LAST ? __ldcs(reinterpret_cast<const int4*>(p)) : __ldg(reinterpret_cast<const int4*>(p));
    out = *reinterpret_cast<const Pack<T, V>*>(&w);
  } else {
    out = *reinterpret_cast<const Pack<T, V>*>(p);
  }
  return out;
}

// the output: written once, read by the next layer, so a streaming store
template <typename Q, int V>
__device__ __forceinline__ void store(Q* p, const Pack<Q, V>& v) {
  if constexpr (sizeof(v) == 16) {
    __stcs(reinterpret_cast<int4*>(p), *reinterpret_cast<const int4*>(&v));
  } else if constexpr (sizeof(v) == 8) {
    __stcs(reinterpret_cast<int2*>(p), *reinterpret_cast<const int2*>(&v));
  } else if constexpr (sizeof(v) == 4) {
    __stcs(reinterpret_cast<int*>(p), *reinterpret_cast<const int*>(&v));
  } else {
    *reinterpret_cast<Pack<Q, V>*>(p) = v;
  }
}

// V results in the output's type: bf16 in pairs (one packed conversion for
// two, rounded as two single ones); s8 from values in [-127, 127] rounded to
// the nearest integer, ties to even, by the adder: r + 1.5 2^23 holds
// rint(r) in its low mantissa bits, two's complement in its low byte (rintf
// and the conversion cost two of the card's 16-a-clock conversion pipe slots
// an element, the add one of its full-rate ones)
template <typename Q, int V>
__device__ __forceinline__ Pack<Q, V> to_pack(const float (&r)[V]) {
  Pack<Q, V> out;
  if constexpr (std::is_same_v<Q, __nv_bfloat16> && V % 2 == 0) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i)
      reinterpret_cast<__nv_bfloat162*>(out.v)[i] = __floats2bfloat162_rn(r[2 * i], r[2 * i + 1]);
  } else if constexpr (std::is_same_v<Q, int8_t>) {
#pragma unroll
    for (int i = 0; i < V; ++i) out.v[i] = static_cast<int8_t>(__float_as_uint(__fadd_rn(r[i], 12582912.f)) & 0xffu);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out.v[i] = from_f32<Q>(r[i]);
  }
  return out;
}

// A thread's per-channel min and max (K4). bf16 keeps them as packed bf16
// pairs (a min or max of bf16 values is exact in bf16), half the registers.
template <typename T, int V>
struct Extremes {
  float mn[V], mx[V];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mn[i] = INFINITY;
      mx[i] = -INFINITY;
    }
  }
  __device__ __forceinline__ void update(const Pack<T, V>& p) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mn[i] = fminf(mn[i], to_f32(p.v[i]));
      mx[i] = fmaxf(mx[i], to_f32(p.v[i]));
    }
  }
  __device__ __forceinline__ float lo(int i) const { return mn[i]; }
  __device__ __forceinline__ float hi(int i) const { return mx[i]; }
};

template <>
struct Extremes<__nv_bfloat16, 8> {
  __nv_bfloat162 mn[4], mx[4];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mn[i] = __float2bfloat162_rn(INFINITY);
      mx[i] = __float2bfloat162_rn(-INFINITY);
    }
  }
  __device__ __forceinline__ void update(const Pack<__nv_bfloat16, 8>& p) {
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(p.v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mn[i] = __hmin2(mn[i], v[i]);
      mx[i] = __hmax2(mx[i], v[i]);
    }
  }
  __device__ __forceinline__ float lo(int i) const { return to_f32(i % 2 ? mn[i / 2].y : mn[i / 2].x); }
  __device__ __forceinline__ float hi(int i) const { return to_f32(i % 2 ? mx[i / 2].y : mx[i / 2].x); }
};

// a float as an unsigned key in the same order; 0 lies below every float's key
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The rows [r0, r1) of tile k of `tiles` over an image's hw rows.
__device__ __forceinline__ void tile_rows(int k, int tiles, int hw, int* r0, int* r1) {
  *r0 = (int)((long long)k * hw / tiles);
  *r1 = (int)((long long)(k + 1) * hw / tiles);
}

// Block (b, k) = (blockIdx.x / tiles, blockIdx.x % tiles); lanes * C / V
// threads, thread t on the vector t % (C / V) of rows r0 + t / (C / V),
// + lanes, ... . flags (int32 words, zero on entry and left zero): B arrival
// counters, then (EXT) the (image, min|max, C) keys; slots: the f32 partial
// sums (B, tiles, 2, G). Dynamic shared memory: 2 * lanes * C floats.
// 2 G <= the block's threads.
template <typename T, int V, bool EXT>
__global__ void __launch_bounds__(kMaxThreads, 2)
gn_split_stats_kernel(const T* __restrict__ x, int HW, int C, int G, int tiles, int lanes,
                      float* __restrict__ sums, float* __restrict__ ext, unsigned* __restrict__ flags,
                      float* __restrict__ slots) {
  extern __shared__ float red[];
  __shared__ bool last;
  const int cv = C / V, B = gridDim.x / tiles;
  const int b = blockIdx.x / tiles, k = blockIdx.x % tiles;
  const int j = threadIdx.x % cv, l = threadIdx.x / cv;
  unsigned* counters = flags;
  unsigned* keys = flags + B;
  int r0, r1;
  tile_rows(k, tiles, HW, &r0, &r1);

  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  Extremes<T, V> e;
  if (EXT) e.init();
  auto take = [&](const Pack<T, V>& p) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float v = to_f32(p.v[i]);
      s1[i] += v;
      s2[i] += v * v;
    }
    if (EXT) e.update(p);
  };
  // batches of kUnroll rows a lane, the last one predicated: a tile's few
  // rows a lane take as few round trips to the memory as they can
  const long long step = (long long)lanes * C;
  const T* p = x + ((long long)b * HW + r0 + l) * C + j * V;
  for (int r = r0 + l; r < r1; r += kUnroll * lanes, p += kUnroll * step) {
    Pack<T, V> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * lanes < r1) v[u] = load<false, T, V>(p + u * step);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * lanes < r1) take(v[u]);
  }

  // the lanes per channel (in place: column c is one thread's alone), then
  // the channels per group, each in a fixed order
  float* red1 = red;
  float* red2 = red + lanes * C;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red1[l * C + j * V + i] = s1[i];
    red2[l * C + j * V + i] = s2[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int m = 0; m < lanes; ++m) {
      t1 += red1[m * C + c];
      t2 += red2[m * C + c];
    }
    red1[c] = t1;
    red2[c] = t2;
  }
  __syncthreads();
  const int cg = C / G, n_out = 2 * G;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    const float* src = (o < G ? red1 : red2) + (o % G) * cg;
    float t = 0.f;
    for (int i = 0; i < cg; ++i) t += src[i];
    slots[((long long)b * tiles + k) * n_out + o] = t;
  }
  if (EXT) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red1[l * C + j * V + i] = e.lo(i);
      red2[l * C + j * V + i] = e.hi(i);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float mn = INFINITY, mx = -INFINITY;
      for (int m = 0; m < lanes; ++m) {
        mn = fminf(mn, red1[m * C + c]);
        mx = fmaxf(mx, red2[m * C + c]);
      }
      // an atomic only where the block may move the image's key (a plain
      // read first: most blocks' extremes do not beat what others left)
      unsigned* lo = keys + (2 * b) * C + c;
      unsigned* hi = lo + C;
      if (~order_key(mn) > __ldcg(lo)) atomicMax(lo, ~order_key(mn));
      if (order_key(mx) > __ldcg(hi)) atomicMax(hi, order_key(mx));
    }
  }

  // the image's last block folds its tiles' slots; one thread fences and
  // counts for the block (after the barrier, as a grid barrier does)
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counters + b, 1u) == (unsigned)(tiles - 1);
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // thread t sums output t % n_out over the tiles t / n_out, + chunks, ...
  // (neighbouring threads on neighbouring slots), kFold loads issued before
  // the first add (an add waits for its load, and a warp issues in order),
  // then each output its chunks in order
  const int chunks = blockDim.x / n_out;
  if (threadIdx.x < chunks * n_out) {
    const float* src = slots + (long long)b * tiles * n_out + threadIdx.x % n_out;
    float t = 0.f;
    for (int i = threadIdx.x / n_out; i < tiles; i += kFold * chunks) {
      float v[kFold];
#pragma unroll
      for (int u = 0; u < kFold; ++u)
        v[u] = i + u * chunks < tiles ? __ldcg(src + (long long)(i + u * chunks) * n_out) : 0.f;
#pragma unroll
      for (int u = 0; u < kFold; ++u) t += v[u];
    }
    red[threadIdx.x] = t;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    float t = 0.f;
    for (int c = 0; c < chunks; ++c) t += red[c * n_out + o];
    sums[((o / G) * B + b) * G + o % G] = t;
  }
  if (EXT) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      ext[b * C + c] = from_key(~__ldcg(keys + (2 * b) * C + c));
      ext[(B + b) * C + c] = from_key(__ldcg(keys + (2 * b + 1) * C + c));
      keys[(2 * b) * C + c] = keys[(2 * b + 1) * C + c] = 0u;
    }
  }
  if (threadIdx.x == 0) counters[b] = 0u;  // the image's words zero again for the next call
}

// The apply: block (b, k) and its threads as the stats kernel's.
template <typename T, typename Q, int V, bool QUANT, bool SILU>
__global__ void __launch_bounds__(kMaxThreads, 2)
gn_split_apply_kernel(const T* __restrict__ x, int HW, int C, int tiles, int lanes, const float* __restrict__ a,
                      const float* __restrict__ b, const float* __restrict__ inv, Q* __restrict__ y) {
  const int cv = C / V;
  const int img = blockIdx.x / tiles, k = blockIdx.x % tiles;
  const int j = threadIdx.x % cv, l = threadIdx.x / cv;
  int r0, r1;
  tile_rows(k, tiles, HW, &r0, &r1);
  float av[V], bv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    av[i] = __ldg(a + img * C + j * V + i);
    bv[i] = __ldg(b + img * C + j * V + i);
  }
  const float s = QUANT ? __ldg(inv + img) : 0.f;
  auto apply = [&](const Pack<T, V>& p) {
    float out[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (QUANT) {
        float v = __fadd_rn(__fmul_rn(to_f32(p.v[i]), av[i]), bv[i]);
        if (SILU) v = v / (1.f + expf(-v));
        const float t = __fmul_rn(v, s);
        // s8: the clip to the integers +-127 commutes with rounding to the
        // nearest integer, ties to even, so to_pack rounds after it (the
        // same bits as the first version's clip(rint(t)))
        out[i] = std::is_same_v<Q, int8_t> ? fminf(fmaxf(t, -127.f), 127.f) : fminf(fmaxf(rintf(t), -127.f), 127.f);
      } else {
        float v = to_f32(p.v[i]) * av[i] + bv[i];
        if (SILU) v = __fdividef(v, 1.f + __expf(-v));
        out[i] = v;
      }
    }
    return to_pack<Q, V>(out);
  };
  constexpr int U = QUANT && SILU ? kUnrollQuantSilu : kUnroll;
  const long long step = (long long)lanes * C;
  long long off = ((long long)img * HW + r0 + l) * C + j * V;
  for (int r = r0 + l; r < r1; r += U * lanes, off += U * step) {
    Pack<T, V> v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r + u * lanes < r1) v[u] = load<true, T, V>(x + off + u * step);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r + u * lanes < r1) store<Q, V>(y + off + u * step, apply(v[u]));
  }
}

// The block's threads for C channels in vectors of V, or 0 where the plan
// does not fit the kernels.
int threads_for(int C, int V, int lanes) {
  if (V < 1 || C % V || lanes < 1) return 0;
  const long long t = (long long)lanes * (C / V);
  return t >= 32 && t <= kMaxThreads ? (int)t : 0;
}

template <typename T, int V>
int launch_stats(const void* x, void* sums, void* ext, void* flags, void* slots, int B, int HW, int C, int G,
                 int tiles, int lanes, cudaStream_t st) {
  const int threads = threads_for(C, V, lanes);
  if (!threads) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float) * lanes * C;
  const T* xp = static_cast<const T*>(x);
  float *sp = static_cast<float*>(sums), *ep = static_cast<float*>(ext), *slp = static_cast<float*>(slots);
  unsigned* fp = static_cast<unsigned*>(flags);
  if (ext != nullptr)
    gn_split_stats_kernel<T, V, true><<<B * tiles, threads, smem, st>>>(xp, HW, C, G, tiles, lanes, sp, ep, fp, slp);
  else
    gn_split_stats_kernel<T, V, false><<<B * tiles, threads, smem, st>>>(xp, HW, C, G, tiles, lanes, sp, ep, fp,
                                                                         slp);
  return (int)cudaGetLastError();
}

template <typename T, typename Q, int V, bool QUANT>
int launch_apply(const void* x, const void* a, const void* b, const void* inv, void* y, int B, int HW, int C,
                 int silu, int tiles, int lanes, cudaStream_t st) {
  const int threads = threads_for(C, V, lanes);
  if (!threads) return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const float *ap = static_cast<const float*>(a), *bp = static_cast<const float*>(b);
  const float* ip = static_cast<const float*>(inv);
  Q* yp = static_cast<Q*>(y);
  if (silu)
    gn_split_apply_kernel<T, Q, V, QUANT, true><<<B * tiles, threads, 0, st>>>(xp, HW, C, tiles, lanes, ap, bp,
                                                                               ip, yp);
  else
    gn_split_apply_kernel<T, Q, V, QUANT, false><<<B * tiles, threads, 0, st>>>(xp, HW, C, tiles, lanes, ap, bp,
                                                                                ip, yp);
  return (int)cudaGetLastError();
}

// vec: 1, or the elements of 16 bytes (8 bf16, 4 f32)
template <typename T>
int stats_by_vec(int vec, const void* x, void* sums, void* ext, void* flags, void* slots, int B, int HW, int C,
                 int G, int tiles, int lanes, cudaStream_t st) {
  constexpr int kWide = 16 / sizeof(T);
  if (vec == kWide) return launch_stats<T, kWide>(x, sums, ext, flags, slots, B, HW, C, G, tiles, lanes, st);
  if (vec == 1) return launch_stats<T, 1>(x, sums, ext, flags, slots, B, HW, C, G, tiles, lanes, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename Q, bool QUANT>
int apply_by_vec(int vec, const void* x, const void* a, const void* b, const void* inv, void* y, int B, int HW,
                 int C, int silu, int tiles, int lanes, cudaStream_t st) {
  constexpr int kWide = 16 / sizeof(T);
  if (vec == kWide) return launch_apply<T, Q, kWide, QUANT>(x, a, b, inv, y, B, HW, C, silu, tiles, lanes, st);
  if (vec == 1) return launch_apply<T, Q, 1, QUANT>(x, a, b, inv, y, B, HW, C, silu, tiles, lanes, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The statistics of K3 (ext null) or K4 over x (B, HW, C) in dtype (0 =
// float32, 1 = bfloat16), contiguous: sums (2, B, G) f32, each group's sum
// and sum of squares; ext (2, B, C) f32, each channel's min and max. flags:
// B + (ext ? 2 B C : 0) int32 words, zero, which the launch leaves zero
// (so the caller may keep them for the next launch on the same stream);
// slots: 2 B G tiles f32 scratch. vec, tiles, lanes: the plan
// (ops/groupnorm.py::_split_plan); with vec > 1, x 16-byte aligned. Returns
// a cudaError_t code (0 = launched).
extern "C" int gdc_group_norm_stats(const void* x, void* sums, void* ext, void* flags, void* slots, int B, int HW,
                                    int C, int G, int dtype, int vec, int tiles, int lanes, void* stream) {
  if (B < 1 || HW < 1 || G < 1 || C % G || 2 * G > lanes * (C / (vec > 0 ? vec : 1)) || tiles < 1 || tiles > HW)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return stats_by_vec<float>(vec, x, sums, ext, flags, slots, B, HW, C, G, tiles, lanes, st);
  if (dtype == 1)
    return stats_by_vec<__nv_bfloat16>(vec, x, sums, ext, flags, slots, B, HW, C, G, tiles, lanes, st);
  return (int)cudaErrorInvalidValue;
}

// K3's apply: y (B, HW, C) = [SiLU](x a + b) in x's dtype, a and b (B, C) f32;
// the plan and alignment as gdc_group_norm_stats's (y aligned like x).
extern "C" int gdc_group_norm_apply(const void* x, const void* a, const void* b, void* y, int B, int HW, int C,
                                    int silu, int dtype, int vec, int tiles, int lanes, void* stream) {
  if (B < 1 || HW < 1 || tiles < 1 || tiles > HW) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return apply_by_vec<float, float, false>(vec, x, a, b, nullptr, y, B, HW, C, silu, tiles, lanes, st);
  if (dtype == 1)
    return apply_by_vec<__nv_bfloat16, __nv_bfloat16, false>(vec, x, a, b, nullptr, y, B, HW, C, silu, tiles, lanes,
                                                             st);
  return (int)cudaErrorInvalidValue;
}

// K4's apply: q (B, HW, C) = clip(rint([SiLU](x a + b) * inv[b]), -127, 127),
// int8 when s8 != 0, else in x's dtype; inv (B,) f32, each image's 1/s.
extern "C" int gdc_group_norm_quant_apply(const void* x, const void* a, const void* b, const void* inv, void* q,
                                          int B, int HW, int C, int silu, int dtype, int s8, int vec, int tiles,
                                          int lanes, void* stream) {
  if (B < 1 || HW < 1 || tiles < 1 || tiles > HW) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return s8 ? apply_by_vec<float, int8_t, true>(vec, x, a, b, inv, q, B, HW, C, silu, tiles, lanes, st)
              : apply_by_vec<float, float, true>(vec, x, a, b, inv, q, B, HW, C, silu, tiles, lanes, st);
  if (dtype == 1)
    return s8 ? apply_by_vec<__nv_bfloat16, int8_t, true>(vec, x, a, b, inv, q, B, HW, C, silu, tiles, lanes, st)
              : apply_by_vec<__nv_bfloat16, __nv_bfloat16, true>(vec, x, a, b, inv, q, B, HW, C, silu, tiles,
                                                                 lanes, st);
  return (int)cudaErrorInvalidValue;
}
