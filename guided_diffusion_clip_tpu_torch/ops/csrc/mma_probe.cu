// T accumulating (512 x 2048) @ (2048 x 512) products on the tensor cores:
// kernel K7, the probe behind tools/mxu_ceiling.py.
//
// Replaces tools/pallas_mxu_ceiling.py::_kernel (via make): out = the sum over
// T repeats of x @ w, s8 operands with s32 sums (which wrap around, as the
// hardware's and the TPU's do: one product's entries reach 2048 * 127^2) or
// bf16 operands with f32 sums. The tool times two values of T and takes the
// matrix unit's rate from the slope.
//
// The TPU kernel holds both operands in VMEM for all T repeats. A 512 x 2048
// operand does not fit one SM's shared memory, so the blocks split the
// (512, 512) output into 128 x 128 tiles and the reduction into 8 slices of
// 256 elements: 128 blocks for 132 SMs. A block's two operand slices (2 x 32 KB
// in s8, 2 x 64 KB in bf16) do fit: it loads them once and they stay in its
// shared memory for every repeat, so after the prologue neither device memory
// nor the L2 is in the loop. Each block writes its tile's partial sum for its
// slice; a second small kernel adds the 8 partial sums of every entry in a
// fixed order (bit-identical repeats; the s32 sums wrap modulo 2^32 in the
// tensor cores and in that addition alike, so any split gives the same bits).
//
// The tensor-core instructions are issued by hand, mma.sync.aligned.m16n8k32
// (s8, s32) and m16n8k16 (bf16, f32) in inline PTX, their fragments loaded
// from shared memory with ldmatrix; wgmma and TMA are later work. In bytes
// both instructions look the same: an A fragment is a 16-row x 32-byte slab
// (four 8 x 16-byte matrices: rows 0-7 and 8-15, bytes 0-15 and 16-31), a B
// fragment an 8-column x 32-byte slab of w transposed, so one kernel serves
// both types and w is given transposed, (512, 2048), a column's reduction run
// contiguous.
//
// What bounds it: shared-memory bandwidth against the tensor cores' issue
// rate. 8 warps a block, each a 64 x 32 patch (4 x 4 mma tiles): a 32-byte
// slab costs a warp 6 ldmatrix.x4 (3 KB) for 16 mma, 24 KB a block against
// 128 bytes a clock, about 1.5x the clocks the 128 mma need at the data-sheet
// rate. Rows are padded by 16 bytes, so the 8 rows of an ldmatrix matrix fall
// in distinct banks. The rate it reads is therefore a floor under the
// data-sheet peak, the ceiling of hand-issued mma.sync fed from shared memory.
// A slab's fragments load while the slab before it multiplies (two register
// buffers). The repeat loop cannot be hoisted: ldmatrix and mma are volatile
// asm, issued once per repeat; the tool's two-T slope would show a hoisted loop as equal
// times.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using namespace gdc;  // mma_tile, ldmatrix_x4

constexpr int kM = 512, kN = 512;
constexpr int kBM = 128, kBN = 128;  // a block's output tile
constexpr int kSplit = 8;            // reduction slices
constexpr int kThreads = 256;        // 8 warps, 2 along M x 4 along N, each 64 x 32
constexpr int kPadB = 16;            // bytes of padding per shared-memory row

// x: (512, row_bytes) bytes, wt: w transposed, (512, row_bytes); partial:
// (kSplit, 512, 512) Acc. kSliceB: bytes of one row's reduction slice.
template <typename Acc, int kSliceB>
__global__ void __launch_bounds__(kThreads, 1)
mma_probe_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ wt,
                 Acc* __restrict__ partial, int T) {
  constexpr int kStride = kSliceB + kPadB;
  constexpr int kVecs = kSliceB / 16;  // 16-byte vectors per row
  constexpr int kRowB = kSliceB * kSplit;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* As = smem;
  uint8_t* Bs = smem + kBM * kStride;

  const int tid = threadIdx.x;
  const int m0 = (blockIdx.x / (kN / kBN)) * kBM;
  const int n0 = (blockIdx.x % (kN / kBN)) * kBN;
  const int slice = blockIdx.y;

  // prologue: this block's slices of both operands, once
  for (int v = tid; v < kBM * kVecs; v += kThreads) {
    const int r = v / kVecs, c = v - r * kVecs;
    *reinterpret_cast<uint4*>(As + r * kStride + c * 16) =
        *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * kRowB + slice * kSliceB + c * 16);
    *reinterpret_cast<uint4*>(Bs + r * kStride + c * 16) =
        *reinterpret_cast<const uint4*>(wt + (long long)(n0 + r) * kRowB + slice * kSliceB + c * 16);
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * 64;  // the warp's patch inside the block tile
  const int wn = (warp & 3) * 32;
  // A: matrices (rows 0-7, bytes 0-15), (rows 8-15, 0-15), (rows 0-7, 16-31), (rows 8-15, 16-31)
  const unsigned a_addr = (unsigned)__cvta_generic_to_shared(
      As + (wm + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 16);
  // B: (columns 0-7, bytes 0-15), (columns 0-7, 16-31), (columns 8-15, 0-15), (columns 8-15, 16-31)
  const unsigned b_addr = (unsigned)__cvta_generic_to_shared(
      Bs + (wn + (lane & 7) + (lane >> 4) * 8) * kStride + ((lane >> 3) & 1) * 16);

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // one slab's fragments: 4 A tiles of 16 rows, 4 B tiles of 8 columns
  auto load_slab = [&](unsigned (&a)[4][4], unsigned (&b)[4][2], int s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) ldmatrix_x4(a[i], a_addr + i * 16 * kStride + s * 32);
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      unsigned r[4];
      ldmatrix_x4(r, b_addr + j * 8 * kStride + s * 32);
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    }
  };

  // two register buffers: the next slab's fragments load while this one's
  // multiply (an even number of slabs, so a repeat starts in buffer 0 again;
  // the last slab of the last repeat loads slab 0 once more and drops it)
  constexpr int kSlabs = kSliceB / 32;
  static_assert(kSlabs % 2 == 0, "the buffers alternate by slab parity");
  unsigned a[2][4][4], b[2][4][2];
  load_slab(a[0], b[0], 0);
  for (int rep = 0; rep < T; ++rep) {
#pragma unroll
    for (int s = 0; s < kSlabs; ++s) {
      load_slab(a[(s + 1) & 1], b[(s + 1) & 1], (s + 1) % kSlabs);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tile(acc[i][j], a[s & 1][i], b[s & 1][j]);
    }
  }

  // an accumulator tile: rows g and g + 8, columns 2*t and 2*t + 1 (g = lane / 4, t = lane % 4)
  const int g = lane >> 2, t4 = lane & 3;
  Acc* tile = partial + (long long)slice * kM * kN;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Acc* o = tile + (long long)(m0 + wm + i * 16 + g) * kN + n0 + wn + j * 8 + t4 * 2;
      o[0] = acc[i][j][0];
      o[1] = acc[i][j][1];
      o[8 * kN] = acc[i][j][2];
      o[8 * kN + 1] = acc[i][j][3];
    }
}

// s32 sums add as unsigned, so that they wrap modulo 2^32 like the tensor cores' own
__device__ __forceinline__ int add_sums(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ float add_sums(float a, float b) { return a + b; }

// out = the kSplit partial sums, added in slice order
template <typename Acc>
__global__ void __launch_bounds__(kThreads)
sum_slices_kernel(const Acc* __restrict__ partial, Acc* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  Acc s = partial[i];
#pragma unroll
  for (int k = 1; k < kSplit; ++k) s = add_sums(s, partial[(long long)k * kM * kN + i]);
  out[i] = s;
}

template <typename Acc, int kSliceB>
int launch(const void* x, const void* wt, void* partial, void* out, int T, cudaStream_t st) {
  constexpr int kSmem = (kBM + kBN) * (kSliceB + kPadB);
  auto kernel = mma_probe_kernel<Acc, kSliceB>;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((kM / kBM) * (kN / kBN), kSplit);
  kernel<<<grid, kThreads, kSmem, st>>>(static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(wt),
                                        static_cast<Acc*>(partial), T);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  sum_slices_kernel<Acc><<<kM * kN / kThreads, kThreads, 0, st>>>(static_cast<const Acc*>(partial),
                                                                 static_cast<Acc*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// x: (512, 2048) row-major, wt: w transposed, (512, 2048) row-major; both s8
// (dtype 0, sums s32) or bf16 (dtype 1, sums f32), 16-byte aligned; partial:
// (8, 512, 512) scratch of the sums' type that the call fills; out: (512, 512);
// T >= 1 repeats. Returns a cudaError_t code (0 = launched).
extern "C" int gdc_mma_probe(const void* x, const void* wt, void* partial, void* out, int T, int dtype,
                             void* stream) {
  if (T < 1 || partial == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<int, 2048 / kSplit>(x, wt, partial, out, T, st);
  if (dtype == 1) return launch<float, 2 * 2048 / kSplit>(x, wt, partial, out, T, st);
  return (int)cudaErrorInvalidValue;
}
