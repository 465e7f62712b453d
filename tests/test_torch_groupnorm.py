"""The port's plain GroupNorm (the CPU side of kernel K3) against the JAX
package's _gn_reference and its Pallas kernel in interpret mode, with and
without scale-shift and SiLU, and its backward (``group_norm_bwd`` through
``GroupNormFunction``) against ``jax.vjp`` of ``_gn_reference``; f32 within
2e-5, as tests/test_pallas_groupnorm.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guided_diffusion_clip_tpu.ops.pallas_groupnorm import _gn_reference, fused_group_norm
from guided_diffusion_clip_tpu_torch.models.nn import GroupNorm32
from guided_diffusion_clip_tpu_torch.ops import groupnorm as G

torch.set_num_threads(2)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("scale_shift", [False, True])
@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 64), 32), ((3, 16, 32), 8)])
def test_plain_matches_jax(shape, groups, scale_shift, silu):
    rs = np.random.RandomState(len(shape) + groups)
    B, C = shape[0], shape[-1]
    x = (rs.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = (rs.standard_normal(C) * 0.1 + 1).astype(np.float32)
    b = (rs.standard_normal(C) * 0.1).astype(np.float32)
    ss = None
    if scale_shift:
        ss = tuple((rs.standard_normal((B, C)) * 0.2).astype(np.float32) for _ in range(2))
    jss = None if ss is None else tuple(jnp.asarray(a) for a in ss)
    tss = None if ss is None else tuple(torch.from_numpy(a) for a in ss)

    out = G.group_norm(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        groups=groups, silu=silu, scale_shift=tss,
    ).numpy()
    ref = np.asarray(_gn_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups, 1e-5, silu, jss))
    pallas = np.asarray(fused_group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups, 1e-5, silu, jss, True))
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("scale_shift", [False, True])
@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 64), 32), ((3, 16, 32), 8)])
def test_backward_matches_jax_vjp(shape, groups, scale_shift, silu):
    """dx, dscale, dbias and dss/dsb against jax.vjp of _gn_reference (what
    the JAX package's fused_group_norm VJP runs)."""
    rs = np.random.RandomState(7 * len(shape) + groups)
    B, C = shape[0], shape[-1]
    x = (rs.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = (rs.standard_normal(C) * 0.1 + 1).astype(np.float32)
    b = (rs.standard_normal(C) * 0.1).astype(np.float32)
    dy = rs.standard_normal(shape).astype(np.float32)
    ss = tuple((rs.standard_normal((B, C)) * 0.2).astype(np.float32) for _ in range(2)) if scale_shift else None

    def ref_fn(x_, w_, b_, ss_):
        return _gn_reference(x_, w_, b_, groups, 1e-5, silu, ss_)

    jargs = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), None if ss is None else tuple(map(jnp.asarray, ss)))
    _, vjp = jax.vjp(ref_fn, *jargs)
    jdx, jdw, jdb, jdss = vjp(jnp.asarray(dy))

    targs = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    tss = None if ss is None else tuple(torch.from_numpy(a).requires_grad_(True) for a in ss)
    G.group_norm(*targs, groups=groups, silu=silu, scale_shift=tss).backward(torch.from_numpy(dy))
    pairs = list(zip((t.grad for t in targs), (jdx, jdw, jdb)))
    if ss is not None:
        pairs += list(zip((t.grad for t in tss), jdss))
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_backward_computes_only_what_is_needed():
    """x alone needs grad (the guidance case): dx only, through the same
    closed form; parameters that need no grad get none."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy((rs.standard_normal((2, 4, 4, 64)) * 2).astype(np.float32)).requires_grad_(True)
    w, b = torch.ones(64), torch.zeros(64)
    ss = (torch.full((2, 64), 0.1), torch.zeros(2, 64))
    y = G.group_norm(x, w, b, silu=True, scale_shift=ss)
    assert y.grad_fn is not None and "GroupNormFunction" in type(y.grad_fn).__name__
    y.sum().backward()
    assert x.grad is not None and w.grad is None and ss[0].grad is None
    dx, dw, db, dss, dsb = G.group_norm_bwd(
        x.detach(), torch.ones_like(x), *G._group_norm_plain_stats(x.detach(), w, b, 32, 1e-5, True, ss)[1],
        w, b, 32, True, ss, needs=(True, False, False, False, False),
    )
    assert dw is None and db is None and dss is None and dsb is None
    torch.testing.assert_close(dx, x.grad, rtol=0, atol=0)


def test_module_on_channels_last_nchw():
    """GroupNorm32 takes logical NCHW in channels_last memory, hands the op
    the NHWC view (no copy) and returns channels_last NCHW."""
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, 8, 8, 64)).astype(np.float32)
    m = GroupNorm32(64)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # NHWC memory = channels_last
    assert xt.is_contiguous(memory_format=torch.channels_last)
    y = m(xt, activation="silu")
    assert y.is_contiguous(memory_format=torch.channels_last)
    ref = np.asarray(_gn_reference(jnp.asarray(x), jnp.ones(64), jnp.zeros(64), 32, 1e-5, True, None))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(), ref, rtol=2e-5, atol=2e-5)


def test_bf16_in_bf16_out():
    x = torch.from_numpy(np.random.RandomState(1).standard_normal((2, 16, 64)).astype(np.float32))
    out = G.group_norm(x.bfloat16(), torch.ones(64), torch.zeros(64))
    assert out.dtype == torch.bfloat16
    ref = G.group_norm(x.bfloat16().float(), torch.ones(64), torch.zeros(64))
    torch.testing.assert_close(out.float(), ref, rtol=3e-2, atol=3e-2)


def test_split_count_fills_the_card():
    """The stats pass's HW split is a function of the shape: at most one
    split per 64 rows, and ~1024 blocks at the ADM-256 maps."""
    assert G._splits(8, 256 * 256, 256, 8) == 128  # 8 x 1 x 128 = 1024 blocks
    assert G._splits(8, 64, 1024, 8) == 1
    assert G._splits(1, 5, 32, 1) == 1
    for B, hw, C in [(8, 65536, 256), (1, 65536, 256), (8, 1024, 512), (3, 77, 96)]:
        for vec in (1, 4, 8):
            s = G._splits(B, hw, C, vec)
            assert 1 <= s <= -(-hw // 64)


def test_vector_width():
    """16 bytes a thread when C allows it (8 bf16, 4 f32), else 1."""
    assert G._vec(torch.zeros(2, 4, 256, dtype=torch.bfloat16), 256) == 8
    assert G._vec(torch.zeros(2, 4, 256), 256) == 4
    assert G._vec(torch.zeros(2, 4, 36), 36) == 4
    assert G._vec(torch.zeros(2, 4, 36, dtype=torch.bfloat16), 36) == 1
    assert G._vec(torch.zeros(2, 4, 97)[..., 1:], 96) == 1  # misaligned view


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """A direct K3 call records no backward (inputs that need grad go through
    ``group_norm``), and the kernel takes only contiguous f32/bf16 CUDA x."""
    w, b = torch.ones(64), torch.zeros(64)
    with pytest.raises(RuntimeError, match="no backward"):
        G.fused_group_norm(torch.zeros(1, 4, 64, requires_grad=True), w, b, 32, 1e-5, False, None)
    with pytest.raises(RuntimeError, match="no backward"):  # a parameter that needs a gradient
        G.fused_group_norm(torch.zeros(1, 4, 64), torch.ones(64, requires_grad=True), b, 32, 1e-5, False, None)
    with pytest.raises(ValueError, match="CUDA tensor"):
        G.fused_group_norm(torch.zeros(1, 4, 64), w, b, 32, 1e-5, False, None)
    with pytest.raises(ValueError, match="contiguous"):
        G.fused_group_norm(torch.zeros(1, 64, 4).transpose(1, 2), w, b, 32, 1e-5, False, None)
    with pytest.raises(TypeError):
        G.fused_group_norm(torch.zeros(1, 4, 64, dtype=torch.float16), w, b, 32, 1e-5, False, None)
    assert G.fused_group_norm.launches == 0
