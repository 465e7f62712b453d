"""The port's plain attention (the CPU side of kernels K1 and K2) against the
JAX package's qkv_attention and its Pallas kernel in interpret mode: the
forward in f32 within 2e-5, the gradient (through ``AttentionFunction`` and
``attention_bwd_plain``) against ``jax.vjp`` within 1e-4, as
tests/test_pallas_attention.py."""

import jax
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


def _vjp(fn, qkv, do):
    _, vjp = jax.vjp(fn, jnp.asarray(qkv))
    return np.asarray(vjp(jnp.asarray(do))[0])


def _port_grad(qkv, do, H, new_order):
    x = torch.from_numpy(qkv).requires_grad_(True)
    A.attention(x, H, new_order=new_order).backward(torch.from_numpy(do))
    return x.grad.numpy()


@pytest.mark.parametrize("new_order", [False, True])
@pytest.mark.parametrize("T,H,d", [(64, 2, 64), (256, 2, 32)])
def test_backward_matches_jax_pallas(T, H, d, new_order):
    """K2's plain version against jax.vjp of the Pallas kernel (interpret
    mode), whose custom VJP is _attn_bwd_kernel, in both head orders."""
    rs = np.random.RandomState(T + d + new_order)
    qkv = rs.standard_normal((2, T, 3 * H * d)).astype(np.float32)
    do = rs.standard_normal((2, T, H * d)).astype(np.float32)
    ref = _vjp(lambda a: qkv_attention_pallas(a, H, new_order=new_order, interpret=True), qkv, do)
    out = _port_grad(qkv, do, H, new_order)
    assert out.shape == qkv.shape and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("new_order", [False, True])
def test_backward_ragged_matches_jax_grad(new_order):
    """The pool's ragged T = 65 (8 x 8 + the mean token) against jax.vjp of
    the XLA qkv_attention."""
    rs = np.random.RandomState(65)
    qkv = rs.standard_normal((2, 65, 3 * 4 * 64)).astype(np.float32)
    do = rs.standard_normal((2, 65, 4 * 64)).astype(np.float32)
    ref = _vjp(lambda a: qkv_attention(a, 4, new_order=new_order), qkv, do)
    np.testing.assert_allclose(_port_grad(qkv, do, 4, new_order), ref, rtol=1e-4, atol=1e-4)


def test_backward_plain_dtypes_and_rounding():
    """attention_bwd_plain keeps the TPU kernel's dtypes (dq, dk, dv in the
    input dtype) and its bf16 gradient is close to the f32 one of the same
    bf16 inputs; inputs that do not need grad record no graph."""
    rs = np.random.RandomState(2)
    q, k, v, do = (torch.from_numpy(rs.standard_normal((2, 3, 40, 32)).astype(np.float32)) for _ in range(4))
    grads = A.attention_bwd_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), do.bfloat16())
    ref = A.attention_bwd_plain(*(t.bfloat16().float() for t in (q, k, v, do)))
    for g, r in zip(grads, ref):
        assert g.dtype == torch.bfloat16 and g.shape == q.shape
        torch.testing.assert_close(g.float(), r, rtol=3e-2, atol=3e-2)
    assert A.attention(torch.zeros(1, 4, 3 * 32), 1).grad_fn is None
    with torch.no_grad():
        assert A.attention(torch.zeros(1, 4, 3 * 32, requires_grad=True), 1).grad_fn is None


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
    """Checks that run before any launch (no card needed): unsupported head
    dims and dtypes, a CPU tensor, and a direct K1 call on an input that
    needs grad (that goes through ``attention``, which records K2)."""
    qkv = torch.zeros(1, 8, 3 * 2 * 48)
    with pytest.raises(ValueError, match="head dim 48"):
        A.attention_fwd_cuda(qkv, 2)
    with pytest.raises(ValueError, match="head dim 48"):
        A.attention_bwd_cuda(qkv, torch.zeros(1, 8, 2 * 48), 2)
    with pytest.raises(TypeError):
        A.attention_fwd_cuda(qkv.half(), 2)
    with pytest.raises(RuntimeError, match="no backward"):
        A.attention_fwd_cuda(torch.zeros(1, 8, 3 * 64, requires_grad=True), 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        A.attention_fwd_cuda(torch.zeros(1, 8, 3 * 64), 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        A.attention_bwd_cuda(torch.zeros(1, 8, 3 * 64), torch.zeros(1, 8, 64), 1)
    assert A.attention_fwd_cuda.launches == 0 and A.attention_bwd_cuda.launches == 0
