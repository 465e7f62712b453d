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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "B,T,H,d,new_order",
    [(2, 1024, 4, 64, False), (2, 256, 8, 64, False), (2, 64, 8, 64, False), (2, 65, 8, 64, True),
     (1, 100, 2, 32, True), (2, 77, 3, 128, False), (2, 256, 1, 192, False), (2, 64, 1, 256, False)],
)
def test_attention_backward_kernel(dev, B, T, H, d, new_order, dtype, tol):
    """K2 through ``attention``'s autograd Function against
    ``attention_bwd_plain``: |d| <= tol * max(1, |ref|); one K1 and one K2
    launch; repeat runs bit-identical."""
    g = torch.Generator(device=dev).manual_seed(T + d)
    qkv = torch.randn(B, T, 3 * H * d, generator=g, device=dev).to(dtype)
    do = torch.randn(B, T, H * d, generator=g, device=dev).to(dtype)

    def grad():
        x = qkv.clone().requires_grad_(True)
        A.attention(x, H, new_order=new_order).backward(do)
        return x.grad

    n1, n2 = A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches
    out = grad()
    torch.cuda.synchronize()
    assert (A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches) == (n1 + 1, n2 + 1)
    ref = A.qkv_attention_bwd_plain(qkv, do, H, new_order)
    assert out.dtype == dtype and out.shape == qkv.shape
    diff = (out.float() - ref.float()).abs()
    assert (diff <= tol * ref.float().abs().clamp(min=1)).all(), diff.max()
    # a non-contiguous cotangent (as autograd hands over through views)
    strided = torch.empty(B, H * d, T, device=dev, dtype=dtype).transpose(1, 2).copy_(do)
    assert torch.equal(A.attention_bwd_cuda(qkv, strided, H, new_order=new_order), out)
    # no atomics: the same bits every run
    assert torch.equal(grad(), out)


@pytest.mark.parametrize("fused", [False, True])
def test_group_norm_backward_on_the_card(dev, fused):
    """GroupNormFunction on CUDA: K3 forward (one launch) and the closed-form
    backward from K3's mean and rstd, against autograd through the plain
    version, f32."""
    g = torch.Generator(device=dev).manual_seed(5)
    B, C = 2, 256
    x = (torch.randn(B, 16, 16, C, generator=g, device=dev) * 2 + 0.5).requires_grad_(True)
    w = torch.randn(C, generator=g, device=dev) * 0.1 + 1
    b = torch.randn(C, generator=g, device=dev) * 0.1
    ss = (torch.randn(B, C, generator=g, device=dev) * 0.2, torch.randn(B, C, generator=g, device=dev) * 0.2)
    ss = ss if fused else None
    dy = torch.randn(x.shape, generator=g, device=dev)
    n0 = G.fused_group_norm.launches
    G.group_norm(x, w, b, silu=fused, scale_shift=ss).backward(dy)
    assert G.fused_group_norm.launches == n0 + 1
    ours, x.grad = x.grad, None
    G.group_norm_plain(x, w, b, 32, 1e-5, fused, ss).backward(dy)
    torch.testing.assert_close(ours, x.grad, rtol=1e-4, atol=1e-4)


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
