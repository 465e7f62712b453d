"""The port's plain attention (the CPU side of kernel K1) against the JAX
package's qkv_attention and its Pallas kernel in interpret mode; f32 within
2e-5, as tests/test_pallas_attention.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guided_diffusion_clip_tpu.ops.attention import qkv_attention
from guided_diffusion_clip_tpu.ops.pallas_attention import qkv_attention_pallas
from guided_diffusion_clip_tpu_torch.ops import attention as A

torch.set_num_threads(2)


@pytest.mark.parametrize("new_order", [False, True])
@pytest.mark.parametrize("T", [64, 256])
@pytest.mark.parametrize("d", [32, 64])
def test_plain_matches_jax(T, d, new_order):
    B, H = 2, 2
    qkv = np.random.RandomState(T + d).standard_normal((B, T, 3 * H * d)).astype(np.float32)
    out = A.attention(torch.from_numpy(qkv), H, new_order=new_order).numpy()
    ref = np.asarray(qkv_attention(jnp.asarray(qkv), H, new_order=new_order))
    pallas = np.asarray(qkv_attention_pallas(jnp.asarray(qkv), H, new_order=new_order, interpret=True))
    assert out.shape == (B, T, H * d)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, pallas, rtol=2e-5, atol=2e-5)


def test_split_merge_heads_roundtrip():
    B, T, H, d = 2, 5, 3, 4
    qkv = torch.arange(B * T * 3 * H * d, dtype=torch.float32).reshape(B, T, 3 * H * d)
    for new_order in (False, True):
        q, k, v = A.split_qkv(qkv, H, new_order)
        assert q.shape == (B, T, H, d)
        back = torch.stack([q, k, v], dim=2 if new_order else 3)
        torch.testing.assert_close(back.reshape(B, T, 3 * H * d), qkv)
    assert A.merge_heads(q).shape == (B, T, H * d)


def test_bf16_rounding_contract():
    """bf16 in, bf16 out; close to the f32 result of the same inputs."""
    qkv = torch.from_numpy(np.random.RandomState(0).standard_normal((2, 64, 3 * 2 * 32)).astype(np.float32))
    out = A.attention(qkv.bfloat16(), 2)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), A.attention(qkv.bfloat16().float(), 2), rtol=3e-2, atol=3e-2)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """Checks that run before any launch (no card needed)."""
    qkv = torch.zeros(1, 8, 3 * 2 * 48)
    with pytest.raises(ValueError, match="head dim 48"):
        A.attention_fwd_cuda(qkv, 2)
    with pytest.raises(TypeError):
        A.attention_fwd_cuda(qkv.half(), 2)
    with pytest.raises(NotImplementedError, match="slice 2"):
        A.attention_fwd_cuda(torch.zeros(1, 8, 3 * 64, requires_grad=True), 1)
    assert A.attention_fwd_cuda.launches == 0
