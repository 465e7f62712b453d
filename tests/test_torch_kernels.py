"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip where torch sees no CUDA device (the CPU lane).
On a machine with an H100 and no JAX, run them without the suite's conftest:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest -p no:cacheprovider
"""

import pytest
import torch

from guided_diffusion_clip_tpu_torch.ops import attention as A
from guided_diffusion_clip_tpu_torch.ops import groupnorm as G

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "B,T,H,d,new_order",
    [(2, 1024, 8, 64, False), (2, 256, 16, 64, True), (3, 65, 2, 64, False),
     (1, 100, 2, 32, True), (2, 77, 3, 128, False), (2, 256, 1, 192, False), (2, 64, 1, 256, False)],
)
def test_attention_kernel(dev, B, T, H, d, new_order, dtype, tol):
    g = torch.Generator(device=dev).manual_seed(T + d)
    qkv = torch.randn(B, T, 3 * H * d, generator=g, device=dev).to(dtype)
    with torch.inference_mode():
        n0 = A.attention_fwd_cuda.launches
        out = A.attention(qkv, H, new_order=new_order)
        ref = A.qkv_attention_plain(qkv, H, new_order=new_order)
        torch.cuda.synchronize()
    assert A.attention_fwd_cuda.launches == n0 + 1
    assert out.dtype == dtype and out.shape == (B, T, H * d)
    diff = (out.float() - ref.float()).abs()
    assert (diff <= tol * ref.float().abs().clamp(min=1)).all(), diff.max()
    # no atomics: the same bits every run
    with torch.inference_mode():
        assert torch.equal(A.attention(qkv, H, new_order=new_order), out)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 64, 64, 256), (2, 8, 8, 1024), (3, 77, 96), (1, 5, 64)])
@pytest.mark.parametrize("fused", [False, True])
def test_group_norm_kernel(dev, shape, dtype, tol, fused):
    g = torch.Generator(device=dev).manual_seed(len(shape))
    B, C = shape[0], shape[-1]
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
    w = torch.randn(C, generator=g, device=dev) * 0.1 + 1
    b = torch.randn(C, generator=g, device=dev) * 0.1
    ss = (torch.randn(B, C, generator=g, device=dev) * 0.2,
          torch.randn(B, C, generator=g, device=dev) * 0.2) if fused else None
    with torch.inference_mode():
        n0 = G.fused_group_norm.launches
        out = G.group_norm(x, w, b, silu=fused, scale_shift=ss)
        ref = G.group_norm_plain(x, w, b, 32, 1e-5, fused, ss)
        torch.cuda.synchronize()
    assert G.fused_group_norm.launches == n0 + 1
    assert out.dtype == dtype and out.shape == x.shape
    diff = (out.float() - ref.float()).abs()
    assert (diff <= tol * ref.float().abs().clamp(min=1)).all(), diff.max()
    with torch.inference_mode():
        assert torch.equal(G.group_norm(x, w, b, silu=fused, scale_shift=ss), out)
