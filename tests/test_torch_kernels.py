"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip where torch sees no CUDA device (the CPU lane).
On a machine with an H100 and no JAX, run them without the suite's conftest:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest -p no:cacheprovider
"""

import pytest
import torch

from guided_diffusion_clip_tpu_torch.ops import attention as A
from guided_diffusion_clip_tpu_torch.ops import fused_conv as FC
from guided_diffusion_clip_tpu_torch.ops import groupnorm as G
from guided_diffusion_clip_tpu_torch.ops import mma_probe as MP

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on_tensor_cores(dtype, d) -> int:
    """1 where K1 and K2 run their mma.sync kernels (bf16, d = 32, 64, 128, 192, 256), else 0."""
    return int(dtype == torch.bfloat16 and d in (32, 64, 128, 192, 256))


# T = 1, 17 and 129: one row, under one tile, one row over two tiles (bf16, both head orders); at the
# recipe's d = 192 with one head, 17, 129 and 255 (K1's 32-key and K2's 32-row tiles, 32- and 64-row blocks)
_RAGGED_BF16 = [pytest.param(2, T, 2, 64, new, torch.bfloat16, 2e-2, id=f"bf16-T{T}-{'new' if new else 'legacy'}")
                for T in (1, 17, 129) for new in (False, True)] + [
    pytest.param(2, T, 1, 192, new, torch.bfloat16, 2e-2, id=f"bf16-d192-T{T}-{'new' if new else 'legacy'}")
    for T in (17, 129, 255) for new in (False, True)]


def _attention_cases(shapes):
    return [pytest.param(*shape, dtype, tol, id="-".join(map(str, shape)) + f"-{str(dtype)[6:]}")
            for shape in shapes for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))] + _RAGGED_BF16


@pytest.mark.parametrize(
    "B,T,H,d,new_order,dtype,tol",
    _attention_cases([(2, 1024, 8, 64, False), (2, 256, 16, 64, True), (3, 65, 2, 64, False),
                      (1, 100, 2, 32, True), (2, 77, 3, 128, False), (2, 256, 1, 192, False), (2, 64, 1, 256, False)]),
)
def test_attention_kernel(dev, B, T, H, d, new_order, dtype, tol):
    g = torch.Generator(device=dev).manual_seed(T + d)
    qkv = torch.randn(B, T, 3 * H * d, generator=g, device=dev).to(dtype)
    with torch.inference_mode():
        n0, m0 = A.attention_fwd_cuda.launches, A.attention_fwd_cuda.launches_mma
        out = A.attention(qkv, H, new_order=new_order)
        ref = A.qkv_attention_plain(qkv, H, new_order=new_order)
        torch.cuda.synchronize()
    assert A.attention_fwd_cuda.launches == n0 + 1
    assert A.attention_fwd_cuda.launches_mma == m0 + _on_tensor_cores(dtype, d)
    assert out.dtype == dtype and out.shape == (B, T, H * d)
    diff = (out.float() - ref.float()).abs()
    assert (diff <= tol * ref.float().abs().clamp(min=1)).all(), diff.max()
    # no atomics: the same bits every run
    with torch.inference_mode():
        assert torch.equal(A.attention(qkv, H, new_order=new_order), out)


@pytest.mark.parametrize(
    "B,T,H,d,new_order,dtype,tol",
    _attention_cases([(2, 1024, 4, 64, False), (2, 256, 8, 64, False), (2, 64, 8, 64, False), (2, 65, 8, 64, True),
                      (1, 100, 2, 32, True), (2, 77, 3, 128, False), (2, 256, 1, 192, False), (2, 64, 1, 256, False)]),
)
def test_attention_backward_kernel(dev, B, T, H, d, new_order, dtype, tol):
    """K2 through ``attention``'s autograd Function against
    ``attention_bwd_plain``: |d| <= tol * max(1, |ref|); one K1 and one K2
    launch, on the tensor cores in bf16 and on the FMA pipes in float32;
    repeat runs bit-identical."""
    g = torch.Generator(device=dev).manual_seed(T + d)
    qkv = torch.randn(B, T, 3 * H * d, generator=g, device=dev).to(dtype)
    do = torch.randn(B, T, H * d, generator=g, device=dev).to(dtype)

    def grad():
        x = qkv.clone().requires_grad_(True)
        A.attention(x, H, new_order=new_order).backward(do)
        return x.grad

    n1, n2 = A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches
    m1, m2 = A.attention_fwd_cuda.launches_mma, A.attention_bwd_cuda.launches_mma
    out = grad()
    torch.cuda.synchronize()
    assert (A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches) == (n1 + 1, n2 + 1)
    mma = _on_tensor_cores(dtype, d)
    assert (A.attention_fwd_cuda.launches_mma, A.attention_bwd_cuda.launches_mma) == (m1 + mma, m2 + mma)
    ref = A.qkv_attention_bwd_plain(qkv, do, H, new_order)
    assert out.dtype == dtype and out.shape == qkv.shape
    diff = (out.float() - ref.float()).abs()
    assert (diff <= tol * ref.float().abs().clamp(min=1)).all(), diff.max()
    # a non-contiguous cotangent (as autograd hands over through views)
    strided = torch.empty(B, H * d, T, device=dev, dtype=dtype).transpose(1, 2).copy_(do)
    assert torch.equal(A.attention_bwd_cuda(qkv, strided, H, new_order=new_order), out)
    # no atomics: the same bits every run
    assert torch.equal(grad(), out)


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("T", [1, 64, 100, 256])
def test_attention_q_rows_same_bits(dev, T, d):
    """K1's tensor-core kernel at d = 192 and 256 with 32 and with 64 query
    rows a block (``fwd_q_rows`` picks one by the grid): a row's arithmetic is
    the same in both, so the bits are, in both head orders."""
    import math

    from guided_diffusion_clip_tpu_torch.ops import build

    g = torch.Generator(device=dev).manual_seed(T + d)
    B, H = 3, 2
    qkv = torch.randn(B, T, 3 * H * d, generator=g, device=dev).bfloat16()
    lib, stream = build.load(), torch.cuda.current_stream(dev).cuda_stream
    for new in (False, True):
        outs = []
        for rows in (32, 64):
            out = torch.empty(B, T, H * d, dtype=torch.bfloat16, device=dev)
            build.check(lib.gdc_attention_fwd_mma(qkv.data_ptr(), out.data_ptr(), B, T, H, d, int(new), rows,
                                                  1.0 / math.sqrt(math.sqrt(d)), stream), "gdc_attention_fwd_mma")
            outs.append(out)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1])
        ref = A.qkv_attention_plain(qkv, H, new_order=new).float()
        assert ((outs[0].float() - ref).abs() <= 2e-2 * ref.abs().clamp(min=1)).all()


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


# phases 3 and 3c of chip_smoke.py, and an odd size
_GN_SHAPES = [(8, 65536, 256), (8, 64, 1024), (8, 65536, 512), (8, 16384, 256), (8, 1024, 512), (8, 65536, 128),
              (8, 64, 2048), (3, 17, 96)]


@pytest.mark.parametrize("kernel", ["K3", "K4-s8", "K4-x"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _GN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_group_norm_one_launch_stats_and_repeats(dev, shape, dtype, kernel):
    """K3 and K4 at the smoke's shapes, scale-shift + SiLU: one launch a
    call, the (2, B, G) mean and rstd within 1e-5 relative of the plain
    version's, the output within the smoke's tolerances, and a repeat call
    gives the same bits."""
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    B, C = shape[0], shape[-1]
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
    w = torch.randn(C, generator=g, device=dev) * 0.1 + 1
    b = torch.randn(C, generator=g, device=dev) * 0.1
    ss = (torch.randn(B, C, generator=g, device=dev) * 0.2, torch.randn(B, C, generator=g, device=dev) * 0.2)
    with torch.inference_mode():
        if kernel == "K3":
            args = (x, w, b, 32, 1e-5, True, ss)
            n0 = G.fused_group_norm.launches
            out, stats = G._fused_group_norm_stats(*args)
            assert G.fused_group_norm.launches == n0 + 1
            ref, rstats = G._group_norm_plain_stats(*args)
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            diff = (out.float() - ref.float()).abs()
            assert (diff <= tol * ref.float().abs().clamp(min=1)).all(), diff.max()
            again = G._fused_group_norm_stats(*args)
        else:
            args = (x, w, b, 32, 1e-5, True, ss, torch.int8 if kernel == "K4-s8" else dtype)
            n0 = G.fused_group_norm_quant.launches
            out, s, stats = G._fused_group_norm_quant_stats(*args)
            assert G.fused_group_norm_quant.launches == n0 + 1
            ref, rs, rstats = G._group_norm_quant_plain_stats(*args)
            torch.testing.assert_close(s, rs, rtol=1e-6, atol=0)
            _q_flips_ok(out, ref)
            again = G._fused_group_norm_quant_stats(*args)
            assert torch.equal(again[1], s)
            again = (again[0], again[2])
        torch.cuda.synchronize()
    torch.testing.assert_close(stats, rstats, rtol=1e-5, atol=0)
    assert torch.equal(again[0], out) and torch.equal(again[1], stats)


def _q_flips_ok(q, ref, share=1e-4):
    """q within one level of ref, off on at most max(1, share * n) elements
    (a y at a rounding boundary may round the other way after a sum in
    another order)."""
    d = (q.float() - ref.float()).abs()
    assert d.max() <= 1, d.max()
    assert (d > 0).sum().item() <= max(1, share * d.numel()), (d > 0).sum().item()


@pytest.mark.parametrize("emit", ["s8", "x"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 64, 256), (2, 8, 8, 1024), (3, 77, 96), (1, 5, 64)])
@pytest.mark.parametrize("fused", [False, True])
def test_group_norm_quant_kernel(dev, shape, dtype, emit, fused):
    """K4 against ``group_norm_quant_plain``: s to rtol 1e-6, q within one
    level on at most 1e-4 of the elements; one launch; repeat runs
    bit-identical."""
    from guided_diffusion_clip_tpu_torch.ops import groupnorm as G

    g = torch.Generator(device=dev).manual_seed(len(shape) + 3)
    B, C = shape[0], shape[-1]
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
    w = torch.randn(C, generator=g, device=dev) * 0.1 + 1
    b = torch.randn(C, generator=g, device=dev) * 0.1
    ss = (torch.randn(B, C, generator=g, device=dev) * 0.2,
          torch.randn(B, C, generator=g, device=dev) * 0.2) if fused else None
    out_dtype = torch.int8 if emit == "s8" else dtype
    args = (x, w, b, 32, 1e-5, fused, ss, out_dtype)
    with torch.inference_mode():
        n0 = G.fused_group_norm_quant.launches
        q, s = G.fused_group_norm_quant(*args)
        rq, rs = G.group_norm_quant_plain(*args)
        torch.cuda.synchronize()
    assert G.fused_group_norm_quant.launches == n0 + 1
    assert q.dtype == out_dtype and q.shape == x.shape and s.shape == (B,)
    torch.testing.assert_close(s, rs, rtol=1e-6, atol=0)
    _q_flips_ok(q, rq)
    with torch.inference_mode():
        q2, s2 = G.fused_group_norm_quant(*args)
    assert torch.equal(q2, q) and torch.equal(s2, s)




@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,W,C,K,k,stride,per_image",
    [(2, 16, 16, 64, 64, 3, 1, True), (2, 8, 8, 512, 256, 3, 1, True), (1, 9, 10, 3, 256, 3, 1, False),
     (2, 16, 16, 256, 6, 3, 1, False), (2, 8, 8, 512, 256, 1, 1, False), (2, 16, 16, 64, 96, 3, 2, False),
     (1, 7, 5, 32, 40, 3, 1, True)],
)
def test_conv_s8_kernel(dev, B, H, W, C, K, k, stride, per_image, out_dtype):
    """K5 against ``conv_s8_plain``: 3x3 and 1x1, the 3-channel stem, the
    6-channel head, stride 2, odd sizes; f32 within 1e-6 * max(1, |ref|),
    bf16 within 2e-2 * max(1, |ref|); one launch; repeat runs bit-identical."""
    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(C + K + k)
    q = torch.randint(-127, 128, (B, H, W, C), generator=g, device=dev, dtype=torch.int8)
    w = torch.randn(k, k, C, K, generator=g, device=dev) * 0.05
    w_q, s_w = Q.quantize_per_out_channel(w)
    s_img = torch.rand(B, generator=g, device=dev) * 0.02 + 0.001 if per_image else None
    bias = torch.randn(K, generator=g, device=dev) * 0.1
    n0 = Q.conv_s8_cuda.launches
    out = Q.conv_s8(q, w_q, s_img, s_w, bias, stride, out_dtype)
    ref = Q.conv_s8_plain(q, w_q, s_img, s_w, bias, stride, out_dtype)
    torch.cuda.synchronize()
    assert Q.conv_s8_cuda.launches == n0 + 1
    Ho = (H + 2 * ((k - 1) // 2) - k) // stride + 1
    assert out.dtype == out_dtype and out.shape == (B, Ho, (W + 2 * ((k - 1) // 2) - k) // stride + 1, K)
    tol = 1e-6 if out_dtype == torch.float32 else 2e-2
    diff = (out.float() - ref.float()).abs()
    assert (diff <= tol * ref.float().abs().clamp(min=1)).all(), diff.max()
    assert torch.equal(Q.conv_s8(q, w_q, s_img, s_w, bias, stride, out_dtype), out)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,C,K,k,stride,per_image",
    [(8, 16, 1024, 1024, 3, 1, True), (8, 16, 2048, 1024, 3, 1, True), (8, 128, 768, 256, 1, 1, False),
     (3, 8, 2048, 1024, 3, 1, True), (1, 8, 2048, 1024, 3, 1, True), (1, 64, 256, 256, 3, 1, False),
     (2, 32, 512, 512, 3, 1, True), (2, 64, 256, 256, 3, 2, False), (2, 12, 48, 40, 3, 1, True),
     (1, 6, 16, 136, 5, 1, False), (2, 16, 144, 64, 3, 1, True), (1, 16, 1024, 1024, 3, 1, True),
     (1, 8, 1040, 256, 3, 1, False)],
)
def test_conv_s8_tensor_core_kernel(dev, B, H, C, K, k, stride, per_image, out_dtype):
    """K5 on the tensor cores against ``conv_s8_plain`` (f32 within 1e-6 *
    max(1, |ref|), bf16 within 2e-2) and, bit for bit, against the ``__dp4a``
    kernel: the s32 sums are exact and the epilogue is the same, under every
    tile and split ``pick_tile`` gives (128- and 64-row tiles, 2 to 9
    slices, the last one shorter, an odd M, K and C off the tile sizes, a
    reduction that ends inside a stage). Counted in ``launches_mma``; repeat runs bit-identical
    (integer atomics commute)."""
    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    torch.backends.cudnn.allow_tf32 = False
    assert Q.uses_tensor_cores(C, K, k)
    g = torch.Generator(device=dev).manual_seed(C + K + H)
    q = torch.randint(-127, 128, (B, H, H, C), generator=g, device=dev, dtype=torch.int8)
    w_q, s_w = Q.quantize_per_out_channel(torch.randn(k, k, C, K, generator=g, device=dev) * 0.05)
    s_img = torch.rand(B, generator=g, device=dev) * 0.02 + 0.001 if per_image else None
    bias = torch.randn(K, generator=g, device=dev) * 0.1
    args = (q, w_q, s_img, s_w, bias, stride, out_dtype)
    n0, m0 = Q.conv_s8_cuda.launches, Q.conv_s8_cuda.launches_mma
    out = Q.conv_s8(*args)
    torch.cuda.synchronize()
    assert (Q.conv_s8_cuda.launches, Q.conv_s8_cuda.launches_mma) == (n0 + 1, m0 + 1)
    ref = Q.conv_s8_plain(*args)
    assert out.dtype == out_dtype and out.shape == ref.shape
    tol = 1e-6 if out_dtype == torch.float32 else 2e-2
    diff = (out.float() - ref.float()).abs()
    assert (diff <= tol * ref.float().abs().clamp(min=1)).all(), diff.max()
    assert torch.equal(out, Q.conv_s8_dp4a(*args))
    assert (Q.conv_s8_cuda.launches, Q.conv_s8_cuda.launches_mma) == (n0 + 1, m0 + 1)  # the dp4a call is not counted
    assert torch.equal(Q.conv_s8(*args), out)
    # the cached packed rows give the same launch; without bias and scales too
    assert torch.equal(Q.conv_s8(*args, rows=Q._pack_weights(w_q)), out)
    bare = (q, w_q, None, s_w, None, stride, out_dtype)
    assert torch.equal(Q.conv_s8(*bare), Q.conv_s8_dp4a(*bare))


@pytest.mark.parametrize("C,K", [(3, 256), (256, 6)])
def test_conv_s8_stem_and_head_stay_on_dp4a(dev, C, K):
    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    g = torch.Generator(device=dev).manual_seed(C)
    q = torch.randint(-127, 128, (2, 16, 16, C), generator=g, device=dev, dtype=torch.int8)
    w_q, s_w = Q.quantize_per_out_channel(torch.randn(3, 3, C, K, generator=g, device=dev) * 0.05)
    n0, m0 = Q.conv_s8_cuda.launches, Q.conv_s8_cuda.launches_mma
    Q.conv_s8(q, w_q, None, s_w)
    assert (Q.conv_s8_cuda.launches, Q.conv_s8_cuda.launches_mma) == (n0 + 1, m0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["randn", "zeros", "huge", "ties"])
@pytest.mark.parametrize("shape", [(8, 256, 256, 3), (2, 32, 32, 512), (1, 7, 5, 3), (37,)])
def test_quantize_kernels(dev, shape, case, dtype):
    """The two quantize kernels against ``quantize_per_tensor`` on the card:
    s to rtol 1e-6 (the plain version's division by 127 is a product with the
    rounded reciprocal there), q within one level on at most 1e-4 of the
    elements (exactly equal where the scales agree); all zeros, one huge
    value, exact ties, sizes that are no multiple of 16; with ``s_w`` the
    factors are ``s * s_w`` rounded once."""
    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    g = torch.Generator(device=dev).manual_seed(len(shape))
    x = torch.randn(shape, generator=g, device=dev) * 3
    if case == "zeros":
        x.zero_()
    elif case == "huge":
        x.view(-1)[x.numel() // 2] = -3e30
    elif case == "ties":  # amax 127: the scale is 1, every value k + 0.5 is a tie
        x = torch.randint(-126, 126, shape, generator=g, device=dev).float() + 0.5
        x.view(-1)[0] = 127.0
    x = x.to(dtype)
    s_w = torch.rand(24, generator=g, device=dev) * 0.01 + 1e-4
    n0 = Q.quantize_per_tensor_cuda.launches
    q, s, factors = Q.quantize_per_tensor_cuda(x, s_w)
    torch.cuda.synchronize()
    assert Q.quantize_per_tensor_cuda.launches == n0 + 1
    rq, rs = Q.quantize_per_tensor(x)
    assert q.dtype == torch.int8 and q.shape == x.shape and s.shape == () and s.dtype == torch.float32
    torch.testing.assert_close(s, rs, rtol=1e-6, atol=0)
    _q_flips_ok(q, rq)
    if torch.equal(s, rs):
        assert torch.equal(q, rq)
    assert torch.equal(factors, s * s_w)
    if case == "zeros":
        assert not q.any() and s.item() == torch.tensor(1e-8).div(torch.tensor(127.0)).item()
    if case == "ties":
        assert s.item() == 1.0 and torch.equal(q, torch.round(x.float()).to(torch.int8))
    q2, s2, none = Q.quantize_per_tensor_cuda(x)
    assert none is None and torch.equal(q2, q) and torch.equal(s2, s)


def test_int8_conv_on_the_card_runs_the_quantize_kernels(dev):
    """``int8_conv`` on CUDA: one launch of the quantize kernels and one of
    K5, the output as the plain versions' on the same tensors."""
    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(2, 16, 16, 64, generator=g, device=dev)
    w = torch.randn(3, 3, 64, 32, generator=g, device=dev) * 0.05
    b = torch.randn(32, generator=g, device=dev) * 0.1
    nq, n5 = Q.quantize_per_tensor_cuda.launches, Q.conv_s8_cuda.launches
    out = Q.int8_conv(x, w, b)
    torch.cuda.synchronize()
    assert (Q.quantize_per_tensor_cuda.launches, Q.conv_s8_cuda.launches) == (nq + 1, n5 + 1)
    w_q, s_w = Q.quantize_per_out_channel(w)
    x_q, s_x = Q.quantize_per_tensor(x)
    ref = Q.conv_s8_plain(x_q, w_q, None, s_x * s_w, b, 1, torch.float32)
    assert ((out - ref).norm() / ref.norm()).item() <= 1e-3  # a tie may round the other way


def test_int8_autograd_on_the_card(dev):
    """GN_q -> conv_prequant with gradients on CUDA (K4 emitting integer-
    valued f32, K5, the straight-through backwards through cuDNN) against
    the same on the CPU (plain versions): q and the output within one level
    of rounding, the gradient of x within the bf16 backward's 2e-2."""
    from guided_diffusion_clip_tpu_torch.ops import groupnorm as G
    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(11)
    x = torch.randn(2, 16, 16, 128, generator=g) * 2 + 0.5
    w, b = torch.rand(128, generator=g) + 0.5, torch.randn(128, generator=g) * 0.1
    cw, cb = torch.randn(3, 3, 128, 64, generator=g) * 0.05, torch.randn(64, generator=g) * 0.1
    ct = torch.randn(2, 16, 16, 64, generator=g)

    def run(device):
        xx = x.to(device).requires_grad_(True)
        q, s = G.group_norm_quant(xx, w.to(device), b.to(device), silu=True)
        assert q.dtype == torch.float32 and q.requires_grad
        y = Q.conv_prequant(q, s, cw.to(device), cb.to(device))
        (y * ct.to(device)).sum().backward()
        return y.detach().cpu(), xx.grad.cpu()

    n4, n5 = G.fused_group_norm_quant.launches, Q.conv_s8_cuda.launches
    y, dx = run(dev)
    assert (G.fused_group_norm_quant.launches, Q.conv_s8_cuda.launches) == (n4 + 1, n5 + 1)
    ry, rdx = run("cpu")
    assert ((y - ry).norm() / ry.norm()).item() <= 1e-3
    assert (dx - rdx).abs().max() <= 2e-2 * rdx.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize(
    "B,H,W,C,K", [(2, 16, 16, 128, 128), (1, 32, 32, 128, 256), (3, 64, 64, 256, 128), (2, 48, 32, 128, 128)]
)
def test_fused_conv_kernel(dev, B, H, W, C, K, quantized, dtype):
    """K6 against ``fused_conv3x3_plain`` (cuDNN f32, TF32 off). Quantized, f32
    in: q and the s32 sums are exact, so within 1e-6 * max(1, |ref|); bf16 in
    or out and the bf16 mode: within 2e-2 * max(1, |ref|). Bands of unequal
    range hold the band scale; (2, 48, 32) has three bands of 16 rows."""
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(H + C)
    x = torch.randn(B, H, W, C, generator=g, device=dev)
    x = (x * torch.linspace(0.25, 4.0, H, device=dev)[None, :, None, None]).to(dtype)
    w = torch.randn(3, 3, C, K, generator=g, device=dev) * 0.05
    b = torch.randn(K, generator=g, device=dev)
    n0 = FC.fused_conv3x3_cuda.launches
    out = FC.fused_conv3x3(x, w, b, quantized=quantized)
    ref = FC.fused_conv3x3_plain(x, w, b, quantized=quantized)
    torch.cuda.synchronize()
    assert FC.fused_conv3x3_cuda.launches == n0 + 1
    assert out.dtype == dtype and out.shape == (B, H, W, K)
    tol = 1e-6 if quantized and dtype == torch.float32 else 2e-2
    diff = (out.float() - ref.float()).abs()
    assert (diff <= tol * ref.float().abs().clamp(min=1)).all(), diff.max()
    assert torch.equal(FC.fused_conv3x3(x, w, None, quantized=quantized),
                       FC.fused_conv3x3(x, w, torch.zeros_like(b), quantized=quantized))
    with pytest.raises(ValueError, match="contiguous"):
        FC.fused_conv3x3(x.transpose(1, 2), w, b, quantized=quantized)


@pytest.mark.parametrize("T", [1, 3, 64, 2000])
def test_mma_probe_kernel_s8(dev, T):
    """K7 in s8: bit-identical to the plain version at every T, wrapped sums
    (T = 64 and 2000 pass the s32 range) included."""
    g = torch.Generator(device=dev).manual_seed(T)
    x = torch.randint(-127, 128, (MP.BM, MP.BK), generator=g, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (MP.BK, MP.BN), generator=g, device=dev, dtype=torch.int8)
    n0 = MP.accumulating_dots_cuda.launches
    out = MP.accumulating_dots(x, w, T)
    torch.cuda.synchronize()
    assert MP.accumulating_dots_cuda.launches == n0 + 1
    assert out.dtype == torch.int32
    assert torch.equal(out, MP.accumulating_dots_plain(x, w, T))


@pytest.mark.parametrize("T", [1, 4])
def test_mma_probe_kernel_bf16(dev, T):
    """K7 in bf16: within 1e-2 * max|ref| of the f64 product (f32 sums in the
    tensor cores' order)."""
    g = torch.Generator(device=dev).manual_seed(T)
    x = torch.randn(MP.BM, MP.BK, generator=g, device=dev).bfloat16()
    w = torch.randn(MP.BK, MP.BN, generator=g, device=dev).bfloat16()
    out = MP.accumulating_dots(x, w, T)
    ref = MP.accumulating_dots_plain(x, w, T)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()
