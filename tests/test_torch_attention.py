"""The port's plain attention (the CPU side of kernels K1 and K2) against the
JAX package's qkv_attention and its Pallas kernel in interpret mode: the
forward in f32 within 2e-5, the gradient (through ``AttentionFunction`` and
``attention_bwd_plain``) against ``jax.vjp`` within 1e-4, as
tests/test_pallas_attention.py. Then the arithmetic the tensor-core kernels
rest on, rehearsed in plain PyTorch: the tile-by-tile online softmax with
bf16 weights, the statistics and two sweeps of the backward, and the split of an f32
operand into bf16 terms; at d = 192 and 256 with the tiles and the dV/dK warp
roles of those kernels."""

import math

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
@pytest.mark.parametrize("d", [32, 64, 192, 256])
def test_plain_matches_jax(T, d, new_order):
    """d = 192 and 256 with one head: the 128 px training recipe's attention
    (T = 256 at 16 px, T = 64 at 8 px)."""
    B, H = 2, 2 if d <= 128 else 1
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
@pytest.mark.parametrize("T,H,d", [(64, 2, 64), (256, 2, 32), (256, 1, 192), (64, 1, 256)])
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


def _tiled_forward(qkv, H, new_order, tile=64):
    """K1's algorithm as the tensor-core kernel runs it, in plain PyTorch: K/V
    tiles of ``tile`` keys (the last one ragged), a running max m and sum l,
    the unnormalised weights exp(s - m) rounded to the input dtype before P V
    while l sums them unrounded, O rescaled by exp(m_old - m_new), one division
    and one cast at the end."""
    q, k, v = (a.permute(0, 2, 1, 3) for a in A.split_qkv(qkv, H, new_order))  # (B, H, T, d)
    B, _, T, d = q.shape
    scale = 1.0 / math.sqrt(math.sqrt(d))
    qs, ks, vf = (q * scale).to(qkv.dtype).float(), (k * scale).to(qkv.dtype).float(), v.float()
    m = torch.full((B, H, T, 1), -math.inf)
    l = torch.zeros(B, H, T, 1)
    o = torch.zeros(B, H, T, d)
    for k0 in range(0, T, tile):
        s = qs @ ks[:, :, k0:k0 + tile].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(qkv.dtype).float() @ vf[:, :, k0:k0 + tile]
        m = m_new
    return A.merge_heads((o / l).permute(0, 2, 1, 3).to(qkv.dtype))


def _check_tiled(qkv, H, tile, dtype):
    for new_order in (False, True):
        out = _tiled_forward(qkv, H, new_order, tile).float()
        ref = A.qkv_attention_plain(qkv, H, new_order=new_order).float()
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
        else:
            assert ((out - ref).abs() <= 2e-2 * ref.abs().clamp(min=1)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [64, 65, 100, 256])
def test_tiled_online_softmax_matches_plain(T, dtype):
    """The tile-by-tile forward against ``qkv_attention_plain`` (one softmax
    over the whole row, normalised weights rounded): within 2e-5 in f32, and
    within 2e-2 * max(1, |ref|) in bf16, where the two round the weights at
    different scales."""
    H, d = 2, 64
    qkv = torch.from_numpy(np.random.RandomState(T).standard_normal((2, T, 3 * H * d)).astype(np.float32)).to(dtype)
    _check_tiled(qkv, H, 64, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d", [(256, 192), (64, 256), (100, 192), (33, 256)])
def test_tiled_online_softmax_wide_heads(T, d, dtype):
    """The same at d = 192 and 256, one head, with the 32-key tiles the
    tensor-core kernel streams there (the recipe's T = 256 and 64, and two
    ragged T): more rescales of O a row than with 64-key tiles, the same
    bounds."""
    qkv = torch.from_numpy(np.random.RandomState(T + d).standard_normal((2, T, 3 * d)).astype(np.float32)).to(dtype)
    _check_tiled(qkv, 1, 32, dtype)


def _split(x, terms=3):
    """x as a sum of ``terms`` bf16 values: hi = bf16(x), mid = bf16(x - hi),
    lo = bf16(x - hi - mid); every difference is exact in f32."""
    parts = []
    for _ in range(terms):
        parts.append(x.bfloat16().float())
        x = x - parts[-1]
    return parts


def _p_ds(q, k, v, do):
    """f32 P and dS of ``attention_bwd_plain`` for bf16-valued (T, d) inputs."""
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    p = torch.softmax((q * scale).bfloat16().float() @ (k * scale).bfloat16().float().T, dim=-1)
    dp = do @ v.T
    return p, p * (dp - (dp * p).sum(-1, keepdim=True))


@pytest.mark.parametrize("terms", [2, 3])
@pytest.mark.parametrize("product", ["Pt_dO", "dS_K", "dSt_Q"])
def test_bf16_split_keeps_the_f32_products(product, terms):
    """K2's f32 left operands on a bf16 tensor core: P and dS split into bf16
    terms (one bf16 product a term, summed in f32) against the f64 product of
    the f32 operand, at T = 256, d = 64, N(0, 1) inputs. Measured here,
    relative to max|ref|: hi + lo 3.0e-6 (Pt_dO), 2.4e-6 (dS_K), 2.6e-6
    (dSt_Q); hi + mid + lo, which the kernel issues, 3.1e-7, 4.3e-7 and 3.9e-7; one rounding
    of P or dS to bf16 1.8e-3, 2.2e-3 and 2.1e-3. Bounds: two terms within
    1e-5, three within 1e-6 (f32's own sum of 256 terms), one rounding above
    5e-4 (so a kernel that rounded once would not pass for the split)."""
    rs = np.random.RandomState(7)
    q, k, v, do = (torch.from_numpy(rs.standard_normal((256, 64)).astype(np.float32)).bfloat16().float()
                   for _ in range(4))
    p, ds = _p_ds(q, k, v, do)
    left, right = {"Pt_dO": (p.T, do), "dS_K": (ds, k), "dSt_Q": (ds.T, q)}[product]
    ref = left.double() @ right.double()
    split = sum(part @ right for part in reversed(_split(left, terms))).double()
    once = (left.bfloat16().float() @ right).double()
    top = ref.abs().max()
    assert (split - ref).abs().max() <= {2: 1e-5, 3: 1e-6}[terms] * top
    assert (once - ref).abs().max() > 5e-4 * top


@pytest.mark.parametrize("T", [65, 100, 256])
def test_two_sweep_backward_matches_plain(T):
    """K2's structure in plain PyTorch against ``attention_bwd_plain``, f32
    within 1e-5 * max(1, |ref|): sweep 1 forms m, l and rowsum(dP o P) online
    over key tiles of 64 (the rowsum as sum_j exp(s - m) dP rescaled like l,
    divided by l at the end), sweep 2 forms dS tile by tile for dQ, and the
    key-stationary pass rebuilds P^T and dS^T from the saved statistics for
    dV and dK; P and dS enter their products as hi + mid + lo."""
    rs = np.random.RandomState(T)
    q, k, v, do = (torch.from_numpy(rs.standard_normal((T, 32)).astype(np.float32)).bfloat16().float()
                   for _ in range(4))
    scale = 1.0 / math.sqrt(math.sqrt(32))
    qs, ks = q * scale, k * scale  # f32 in: "rounded to the input dtype" rounds nothing
    m, l, acc = torch.full((T, 1), -math.inf), torch.zeros(T, 1), torch.zeros(T, 1)
    for k0 in range(0, T, 64):
        s, dp = qs @ ks[k0:k0 + 64].T, do @ v[k0:k0 + 64].T
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l, acc, m = l * alpha + p.sum(-1, keepdim=True), acc * alpha + (p * dp).sum(-1, keepdim=True), m_new
    rinv, rowsum = 1 / l, acc / l

    def split_matmul(x, b):
        return sum(part @ b for part in reversed(_split(x)))

    dq = torch.zeros(T, 32)
    for k0 in range(0, T, 64):
        p = torch.exp(qs @ ks[k0:k0 + 64].T - m) * rinv
        dq += split_matmul(p * (do @ v[k0:k0 + 64].T - rowsum), k[k0:k0 + 64])
    dk, dv = torch.zeros(T, 32), torch.zeros(T, 32)
    for q0 in range(0, T, 64):
        sl = slice(q0, q0 + 64)
        pt = torch.exp(ks @ qs[sl].T - m[sl].T) * rinv[sl].T
        dv += split_matmul(pt, do[sl])
        dk += split_matmul(pt * (v @ do[sl].T - rowsum[sl].T), q[sl])
    ref = A.attention_bwd_plain(q, k, v, do)
    for out, r in zip((dq * scale * scale, dk * scale * scale, dv), ref):
        assert ((out - r).abs() <= 1e-5 * r.abs().clamp(min=1)).all()


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("T", [64, 100, 256])
def test_role_split_backward_matches_plain(T, d):
    """K2 at d = 192 and 256 in plain PyTorch, as its kernels split the work,
    against ``attention_bwd_plain``, f32 within 1e-4 * max(1, |ref|): kernel A
    (q-tiles of 64 rows, key tiles of 32, 16 at d = 256) forms the statistics
    in sweep 1 and dQ in sweep 2; kernel B (key tiles of 64 rows, q-tiles of 32 with their
    statistics) runs two passes, one for each role of its warps: the dV pass
    forms S^T alone and sums P^T dO, the dK pass forms S^T and dP^T and sums
    dS^T Q. P and dS enter every product as hi + mid + lo, each tile's product
    summed on its own before it joins the running sum."""
    rs = np.random.RandomState(T + d)
    q, k, v, do = (torch.from_numpy(rs.standard_normal((T, d)).astype(np.float32)).bfloat16().float()
                   for _ in range(4))
    scale = 1.0 / math.sqrt(math.sqrt(d))
    qs, ks = q * scale, k * scale

    def split_matmul(x, b):
        return sum(part @ b for part in reversed(_split(x)))

    m, l, rowsum, dq = torch.zeros(T, 1), torch.zeros(T, 1), torch.zeros(T, 1), torch.zeros(T, d)
    bs = 16 if d > 192 else 32
    for q0 in range(0, T, 64):  # kernel A, one block a q-tile
        rows = slice(q0, q0 + 64)
        mq, lq, acc = torch.full((min(64, T - q0), 1), -math.inf), 0, 0
        for k0 in range(0, T, bs):
            s, dp = qs[rows] @ ks[k0:k0 + bs].T, do[rows] @ v[k0:k0 + bs].T
            m_new = torch.maximum(mq, s.amax(-1, keepdim=True))
            alpha, p = torch.exp(mq - m_new), torch.exp(s - m_new)
            lq, acc, mq = lq * alpha + p.sum(-1, keepdim=True), acc * alpha + (p * dp).sum(-1, keepdim=True), m_new
        m[rows], l[rows], rowsum[rows] = mq, lq, acc / lq
        for k0 in range(0, T, bs):
            p = torch.exp(qs[rows] @ ks[k0:k0 + bs].T - m[rows]) / l[rows]
            dq[rows] += split_matmul(p * (do[rows] @ v[k0:k0 + bs].T - rowsum[rows]), k[k0:k0 + bs])
    dk, dv = torch.zeros(T, d), torch.zeros(T, d)
    for k0 in range(0, T, 64):  # kernel B, one block a key tile
        keys = slice(k0, k0 + 64)
        for q0 in range(0, T, 32):
            cols = slice(q0, q0 + 32)
            pt = torch.exp(ks[keys] @ qs[cols].T - m[cols].T) / l[cols].T  # both passes
            dv[keys] += split_matmul(pt, do[cols])  # the dV warps
            dst = pt * (v[keys] @ do[cols].T - rowsum[cols].T)  # the dK warps form dP^T as well
            dk[keys] += split_matmul(dst, q[cols])
    ref = A.attention_bwd_plain(q, k, v, do)
    for out, r in zip((dq * scale * scale, dk * scale * scale, dv), ref):
        assert ((out - r).abs() <= 1e-4 * r.abs().clamp(min=1)).all()


def test_fwd_q_rows():
    """K1's query rows a block: 64 up to d = 128 at any grid; at d = 192 and
    256, 32 where 64-row blocks would leave an SM of 132 without one (the
    recipe's 8 px attention, T = 64 at batch 48: 48 blocks), else 64 (its 16 px
    one, T = 256: 192 blocks)."""
    assert A.fwd_q_rows(256, 48, 192, 132) == 64
    assert A.fwd_q_rows(64, 48, 256, 132) == 32
    assert A.fwd_q_rows(65, 66, 192, 132) == 64  # two blocks a pair
    assert A.fwd_q_rows(64, 131, 192, 132) == 32
    assert A.fwd_q_rows(64, 1, 64, 132) == A.fwd_q_rows(17, 1, 128, 132) == 64


def test_attention_tune_tool_is_card_only(monkeypatch):
    """The sweep behind ``fwd_q_rows`` has no CPU mode (a tile has no plain
    version): it refuses a missing card by name, and its shapes are the
    recipe's at d = 192 and 256, with each choice of rows picked at one."""
    from guided_diffusion_clip_tpu_torch.tools import attention_tune

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        attention_tune.main()
    assert {(T, d) for _, T, _, d in attention_tune.SHAPES} == {(256, 192), (64, 256)}
    assert {A.fwd_q_rows(T, B * H, d, 132) for B, T, H, d in attention_tune.SHAPES} == {32, 64}


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """Checks that run before any launch (no card needed): unsupported head
    dims and dtypes, a CPU tensor, a bf16 tensor whose pointer is not 16-byte
    aligned (the tensor-core kernels copy 16 bytes a ``cp.async``), and a
    direct K1 call on an input that needs grad (that goes through
    ``attention``, which records K2)."""
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
    # one bf16 element past an aligned start; float32 goes to the FMA kernels, which take any pointer
    odd = torch.zeros(1 + 8 * 3 * 64, dtype=torch.bfloat16)[1:].view(1, 8, 3 * 64)
    assert odd.is_contiguous() and odd.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="qkv 16-byte aligned"):
        A.attention_fwd_cuda(odd, 1)
    with pytest.raises(ValueError, match="qkv 16-byte aligned"):
        A.attention_bwd_cuda(odd, torch.zeros(1, 8, 64, dtype=torch.bfloat16), 1)
    with pytest.raises(ValueError, match="qkv 16-byte aligned"):  # d = 256 in bf16 runs on the tensor cores too
        A.attention_fwd_cuda(torch.zeros(1 + 8 * 3 * 256, dtype=torch.bfloat16)[1:].view(1, 8, 3 * 256), 1)
    with pytest.raises(ValueError, match="CUDA tensor"):  # float32 goes to the FMA kernels at every d
        A.attention_fwd_cuda(torch.zeros(1 + 8 * 3 * 256)[1:].view(1, 8, 3 * 256), 1)
    assert A.MMA_HEAD_DIMS == A.KERNEL_HEAD_DIMS == (32, 64, 128, 192, 256)
    assert A.attention_fwd_cuda.launches == 0 and A.attention_bwd_cuda.launches == 0
    assert A.attention_fwd_cuda.launches_mma == 0 and A.attention_bwd_cuda.launches_mma == 0
