// Kernel K2 for float32 on the tensor cores: kernel B's launch (dK and dV),
// called by the C entry point in attention_bwd_f32mma.cu after kernel A. The
// kernels and their design: attention_bwd_f32mma.cuh.

#include "attention_bwd_f32mma.cuh"

namespace {

using namespace gdc;
using namespace gdc::f32attn;

template <int D, int R, int KS>
int launch_b(const float* qkv, const float* dout, float* dqkv, const float* stats, int B, const Layout& L,
             cudaStream_t stream) {
  using P = Tile<D, KS>;
  static bool attr_set[kMaxDevices] = {};
  auto kb = attention_bwd_f32mma_dkv_kernel<D, R, KS>;
  const int err = smem_attribute_once(attr_set, kb, P::smem_b(R));
  if (err != 0) return err;
  const dim3 grid((L.Tn + 16 * R - 1) / (16 * R), B * L.H);
  kb<<<grid, P::threads_b(R), P::smem_b(R), stream>>>(qkv, dout, dqkv, stats, L);
  return (int)cudaGetLastError();
}

// the same (row groups, groups) for each stationary rows as kernel A's (attention_bwd_f32mma.cu)
template <int D>
int launch_b_rows(const float* qkv, const float* dout, float* dqkv, const float* stats, int B, const Layout& L,
                  int rows, cudaStream_t s) {
  if constexpr (D > 128) {
    if (rows == 32) return launch_b<D, 2, 1>(qkv, dout, dqkv, stats, B, L, s);
  } else {
    if (rows == 64) return launch_b<D, 4, 1>(qkv, dout, dqkv, stats, B, L, s);
    if (rows == 32) return launch_b<D, 2, 2>(qkv, dout, dqkv, stats, B, L, s);
    if constexpr (D <= 64) {
      if (rows == 16) return launch_b<D, 1, 4>(qkv, dout, dqkv, stats, B, L, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

namespace gdc {
namespace f32attn {

int launch_dkv(const float* qkv, const float* dout, float* dqkv, const float* stats, int B, const Layout& L, int D,
               int rows, cudaStream_t s) {
  switch (D) {
    case 32: return launch_b_rows<32>(qkv, dout, dqkv, stats, B, L, rows, s);
    case 64: return launch_b_rows<64>(qkv, dout, dqkv, stats, B, L, rows, s);
    case 96: return launch_b_rows<96>(qkv, dout, dqkv, stats, B, L, rows, s);
    case 128: return launch_b_rows<128>(qkv, dout, dqkv, stats, B, L, rows, s);
    case 192: return launch_b_rows<192>(qkv, dout, dqkv, stats, B, L, rows, s);
    case 256: return launch_b_rows<256>(qkv, dout, dqkv, stats, B, L, rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace f32attn
}  // namespace gdc
