// Kernel K2 for float32 on the tensor cores: kernel A's launch (dQ and the
// row statistics) and the C entry point, which launches kernel A and then
// kernel B (attention_bwd_f32mma_dkv.cu). The kernels and their design:
// attention_bwd_f32mma.cuh.

#include "attention_bwd_f32mma.cuh"

namespace {

using namespace gdc;
using namespace gdc::f32attn;

template <int D, int R, int KS>
int launch_dq(const float* qkv, const float* dout, float* dqkv, float* stats, int B, const Layout& L,
              cudaStream_t stream) {
  using P = Tile<D, KS>;
  static bool attr_set[kMaxDevices] = {};
  auto ka = attention_bwd_f32mma_dq_kernel<D, R, KS>;
  const int err = smem_attribute_once(attr_set, ka, P::smem_a(R));
  if (err != 0) return err;
  const dim3 grid((L.Tn + 16 * R - 1) / (16 * R), B * L.H);
  ka<<<grid, 32 * R * KS, P::smem_a(R), stream>>>(qkv, dout, dqkv, stats, L);
  return (int)cudaGetLastError();
}

// stationary rows of a block -> (row groups, groups that split the streamed tiles): 64 (4, 1), 32 (2, 2), up
// to D = 64 16 (1, 4) (K1 takes the same); above D = 128, 32 (2, 1) alone
template <int D>
int launch_dq_rows(const float* qkv, const float* dout, float* dqkv, float* stats, int B, const Layout& L, int rows,
                   cudaStream_t s) {
  if constexpr (D > 128) {
    if (rows == 32) return launch_dq<D, 2, 1>(qkv, dout, dqkv, stats, B, L, s);
  } else {
    if (rows == 64) return launch_dq<D, 4, 1>(qkv, dout, dqkv, stats, B, L, s);
    if (rows == 32) return launch_dq<D, 2, 2>(qkv, dout, dqkv, stats, B, L, s);
    if constexpr (D <= 64) {
      if (rows == 16) return launch_dq<D, 1, 4>(qkv, dout, dqkv, stats, B, L, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// qkv, dqkv: (B, T, 3 * H * D); dout: (B, T, H * D); all f32, contiguous and
// 16-byte aligned; stats: (3, B * H, T) f32 scratch; D in {32, 64, 96, 128,
// 192, 256}; rows, the stationary rows of a block of both kernels: 64, 32 or
// (up to D = 64) 16, and 32 above D = 128 (ops/attention.py::f32_bwd_rows picks).
// Returns a cudaError_t code (0 = both kernels launched).
extern "C" int gdc_attention_bwd_f32mma(const void* qkv, const void* dout, void* dqkv, void* stats, int B, int Tn,
                                        int H, int D, int new_order, int rows, float scale, float scale2,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Layout L;
  L.Tn = Tn;
  L.H = H;
  L.head_stride = new_order ? D : 3 * D;
  L.part_stride = new_order ? H * D : D;
  L.scale = scale;
  L.scale2 = scale2;
  const float* q = static_cast<const float*>(qkv);
  const float* o = static_cast<const float*>(dout);
  float* g = static_cast<float*>(dqkv);
  float* st = static_cast<float*>(stats);
  int err;
  switch (D) {
    case 32: err = launch_dq_rows<32>(q, o, g, st, B, L, rows, s); break;
    case 64: err = launch_dq_rows<64>(q, o, g, st, B, L, rows, s); break;
    case 96: err = launch_dq_rows<96>(q, o, g, st, B, L, rows, s); break;
    case 128: err = launch_dq_rows<128>(q, o, g, st, B, L, rows, s); break;
    case 192: err = launch_dq_rows<192>(q, o, g, st, B, L, rows, s); break;
    case 256: err = launch_dq_rows<256>(q, o, g, st, B, L, rows, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return launch_dkv(q, o, g, st, B, L, D, rows, s);
}
