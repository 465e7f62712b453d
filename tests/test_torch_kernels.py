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
    """1 where K1 and K2 run their mma.sync kernels (bf16 and f32, d = 32, 64, 96, 128, 192, 256), else 0."""
    return int(dtype in (torch.bfloat16, torch.float32) and d in (32, 64, 96, 128, 192, 256))


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
                      (1, 100, 2, 32, True), (2, 77, 3, 128, False), (2, 256, 1, 192, False), (2, 64, 1, 256, False),
                      (2, 256, 4, 96, False), (2, 129, 2, 96, True), (2, 65, 8, 64, True), (2, 64, 4, 128, False)]),
)
def test_attention_kernel(dev, B, T, H, d, new_order, dtype, tol):
    g = torch.Generator(device=dev).manual_seed(T + d)
    qkv = torch.randn(B, T, 3 * H * d, generator=g, device=dev).to(dtype)
    with torch.inference_mode():
        n0, m0, f0 = A.attention_fwd_cuda.launches, A.attention_fwd_cuda.launches_mma, A.attention_fwd_cuda.launches_f32
        out = A.attention(qkv, H, new_order=new_order)
        ref = A.qkv_attention_plain(qkv, H, new_order=new_order)
        torch.cuda.synchronize()
    assert A.attention_fwd_cuda.launches == n0 + 1
    assert A.attention_fwd_cuda.launches_mma == m0 + _on_tensor_cores(dtype, d)
    assert A.attention_fwd_cuda.launches_f32 == f0 + (dtype == torch.float32)
    assert out.dtype == dtype and out.shape == (B, T, H * d)
    diff = (out.float() - ref.float()).abs()
    assert (diff <= tol * ref.float().abs().clamp(min=1)).all(), diff.max()
    # no atomics: the same bits every run
    with torch.inference_mode():
        assert torch.equal(A.attention(qkv, H, new_order=new_order), out)


@pytest.mark.parametrize(
    "B,T,H,d,new_order,dtype,tol",
    _attention_cases([(2, 1024, 4, 64, False), (2, 256, 8, 64, False), (2, 64, 8, 64, False), (2, 65, 8, 64, True),
                      (1, 100, 2, 32, True), (2, 77, 3, 128, False), (2, 256, 1, 192, False), (2, 64, 1, 256, False),
                      (2, 256, 4, 96, False), (2, 129, 2, 96, True), (2, 64, 4, 128, False)]),
)
def test_attention_backward_kernel(dev, B, T, H, d, new_order, dtype, tol):
    """K2 through ``attention``'s autograd Function against
    ``attention_bwd_plain``: |d| <= tol * max(1, |ref|); one K1 and one K2
    launch, on the tensor cores in bf16 and in float32 (split TF32), the f32
    ones counted in ``launches_f32``; repeat runs bit-identical."""
    g = torch.Generator(device=dev).manual_seed(T + d)
    qkv = torch.randn(B, T, 3 * H * d, generator=g, device=dev).to(dtype)
    do = torch.randn(B, T, H * d, generator=g, device=dev).to(dtype)

    def grad():
        x = qkv.clone().requires_grad_(True)
        A.attention(x, H, new_order=new_order).backward(do)
        return x.grad

    n1, n2 = A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches
    m1, m2 = A.attention_fwd_cuda.launches_mma, A.attention_bwd_cuda.launches_mma
    f1, f2 = A.attention_fwd_cuda.launches_f32, A.attention_bwd_cuda.launches_f32
    out = grad()
    torch.cuda.synchronize()
    assert (A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches) == (n1 + 1, n2 + 1)
    mma, f32 = _on_tensor_cores(dtype, d), int(dtype == torch.float32)
    assert (A.attention_fwd_cuda.launches_mma, A.attention_bwd_cuda.launches_mma) == (m1 + mma, m2 + mma)
    assert (A.attention_fwd_cuda.launches_f32, A.attention_bwd_cuda.launches_f32) == (f1 + f32, f2 + f32)
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


@pytest.mark.parametrize("d", [32, 64, 96, 128, 192, 256])
def test_attention_f32_rows_choices(dev, d):
    """The float32 tensor-core K1 and K2 at each block shape ``f32_rows`` and
    ``f32_bwd_rows`` can pick (64 rows, 32 with the tiles split between 2 warps, up to d = 64 16
    split between 4; 32 above d = 128), at the pool's ragged T = 65 in both
    head orders: each holds the plain version's 1e-4 (K1) and
    1e-4 * max(1, |ref|) (K2) and gives the same bits on a repeat."""
    import math

    from guided_diffusion_clip_tpu_torch.ops import build

    g = torch.Generator(device=dev).manual_seed(d)
    B, T, H = 2, 65, 2
    qkv = torch.randn(B, T, 3 * H * d, generator=g, device=dev)
    do = torch.randn(B, T, H * d, generator=g, device=dev)
    lib, stream = build.load(), torch.cuda.current_stream(dev).cuda_stream
    scale = 1.0 / math.sqrt(math.sqrt(d))

    def run(rows, new):
        out, dqkv = torch.empty(B, T, H * d, device=dev), torch.empty_like(qkv)
        stats = torch.empty(3, B * H, T, device=dev)
        build.check(lib.gdc_attention_fwd_f32mma(qkv.data_ptr(), out.data_ptr(), B, T, H, d, int(new), rows,
                                                 scale, stream), "gdc_attention_fwd_f32mma")
        build.check(lib.gdc_attention_bwd_f32mma(qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
                                                 B, T, H, d, int(new), rows, scale, scale * scale, stream),
                    "gdc_attention_bwd_f32mma")
        torch.cuda.synchronize()
        return out, dqkv

    for new in (False, True):
        ref, ref_grad = A.qkv_attention_plain(qkv, H, new_order=new), A.qkv_attention_bwd_plain(qkv, do, H, new)
        for rows in (32,) if d > 128 else (64, 32, 16) if d <= 64 else (64, 32):
            out, dqkv = run(rows, new)
            assert (out - ref).abs().max() <= 1e-4, (rows, new)
            assert ((dqkv - ref_grad).abs() <= 1e-4 * ref_grad.abs().clamp(min=1)).all(), (rows, new)
            again = run(rows, new)
            assert torch.equal(again[0], out) and torch.equal(again[1], dqkv)


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
    """The stem and head convs that ran on ``__dp4a`` now run the thin
    kernels of ``conv_s8_thin.cu``: one launch counted in ``launches_thin``,
    none in ``launches_mma``."""
    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    g = torch.Generator(device=dev).manual_seed(C)
    q = torch.randint(-127, 128, (2, 16, 16, C), generator=g, device=dev, dtype=torch.int8)
    w_q, s_w = Q.quantize_per_out_channel(torch.randn(3, 3, C, K, generator=g, device=dev) * 0.05)
    n0, m0, t0 = Q.conv_s8_cuda.launches, Q.conv_s8_cuda.launches_mma, Q.conv_s8_cuda.launches_thin
    Q.conv_s8(q, w_q, None, s_w)
    assert (Q.conv_s8_cuda.launches, Q.conv_s8_cuda.launches_mma, Q.conv_s8_cuda.launches_thin) == (n0 + 1, m0, t0 + 1)


@pytest.mark.parametrize("scales", ["none", "per_image", "bias", "both"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,W,C,K,k",
    [(1, 9, 10, 3, 256, 3), (2, 7, 5, 6, 64, 3), (2, 13, 11, 3, 128, 3), (1, 5, 9, 3, 32, 3), (2, 3, 17, 6, 192, 3),
     (1, 33, 31, 3, 512, 3), (2, 6, 7, 40, 8, 1), (2, 16, 16, 256, 6, 3), (1, 9, 37, 64, 3, 3), (2, 7, 5, 192, 3, 1),
     (2, 1, 1, 64, 3, 1), (1, 20, 70, 48, 6, 3), (2, 11, 9, 16, 8, 3)],
)
def test_conv_s8_thin_kernels(dev, B, H, W, C, K, k, out_dtype, scales):
    """The stem and head kernels of ``conv_s8_thin.cu`` against
    ``conv_s8_plain`` (f32 within 1e-6 * max(1, |ref|), bf16 within 2e-2)
    and, bit for bit, against the ``__dp4a`` kernel: batch 1 and 2, H != W,
    odd sizes, stems with C = 3 and 6 (and a 1x1 of 40 channels), K from 8
    to 512 (the channels split between warps past 256 at one k-step and 64
    at two), heads with K = 3, 6 and 8 at 3x3 and 1x1, one pixel, a row
    wider than two tiles; with and without per-image scales and bias.
    Counted in ``launches_thin``; repeat runs bit-identical."""
    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    torch.backends.cudnn.allow_tf32 = False
    kind = Q.uses_thin_kernel(C, K, k, 1)
    assert kind == ("stem" if C * k * k <= 64 and K % 8 == 0 else "head")
    g = torch.Generator(device=dev).manual_seed(B + H + W + C + K + k)
    q = torch.randint(-127, 128, (B, H, W, C), generator=g, device=dev, dtype=torch.int8)
    w_q, s_w = Q.quantize_per_out_channel(torch.randn(k, k, C, K, generator=g, device=dev) * 0.05)
    s_img = torch.rand(B, generator=g, device=dev) * 0.02 + 0.001 if scales in ("per_image", "both") else None
    bias = torch.randn(K, generator=g, device=dev) * 0.1 if scales in ("bias", "both") else None
    args = (q, w_q, s_img, s_w, bias, 1, out_dtype)
    n0, m0, t0 = Q.conv_s8_cuda.launches, Q.conv_s8_cuda.launches_mma, Q.conv_s8_cuda.launches_thin
    out = Q.conv_s8(*args)
    torch.cuda.synchronize()
    assert (Q.conv_s8_cuda.launches, Q.conv_s8_cuda.launches_mma, Q.conv_s8_cuda.launches_thin) == (n0 + 1, m0, t0 + 1)
    ref = Q.conv_s8_plain(*args)
    assert out.dtype == out_dtype and out.shape == ref.shape == (B, H, W, K)
    tol = 1e-6 if out_dtype == torch.float32 else 2e-2
    diff = (out.float() - ref.float()).abs()
    assert (diff <= tol * ref.float().abs().clamp(min=1)).all(), diff.max()
    assert torch.equal(out, Q.conv_s8_dp4a(*args))
    assert torch.equal(Q.conv_s8(*args), out)
    assert torch.equal(Q.conv_s8(*args, rows=Q._pack_weights(w_q)), out)


def test_conv_s8_thin_kernels_take_a_channel_slice_of_the_rows(dev):
    """Under TP a stem runs on ``rows[out_slice]`` of the cached rows: a view
    that starts inside the weight tensor; the result is the slice's conv."""
    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randint(-127, 128, (2, 12, 12, 3), generator=g, device=dev, dtype=torch.int8)
    w_q, s_w = Q.quantize_per_out_channel(torch.randn(3, 3, 3, 256, generator=g, device=dev) * 0.05)
    rows, half = Q._pack_weights(w_q), slice(128, 256)
    out = Q.conv_s8(q, w_q[..., half], None, s_w[half], None, 1, torch.bfloat16, rows=rows[half])
    assert torch.equal(out, Q.conv_s8(q, w_q, None, s_w, None, 1, torch.bfloat16)[..., half])


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


# the split entries: ADM-256's half-H map at 256 px and its 16 and 8 px levels, its concatenated widths (C / G =
# 24, 48, 64), the recipe's C / G = 6 and 2, a 96-channel map (C / G = 3) and TP's local channels of it and of
# ADM-256 (16 or 8 of the 32 groups), a width that takes no 16-byte vector in bf16, and small, ragged maps
_SPLIT_CASES = [((2, 128, 256, 256), 32), ((2, 8, 16, 1024), 32), ((2, 4, 8, 2048), 32), ((2, 8, 16, 1536), 32),
                ((2, 16, 32, 768), 32), ((2, 16, 32, 192), 32), ((2, 128, 256, 128), 16), ((3, 5, 7, 96), 32),
                ((2, 7, 48), 16), ((2, 5, 24), 8), ((2, 6, 12), 4), ((1, 3, 64), 32)]
_SPLIT_IDS = ["x".join(map(str, s)) + f"-G{g}" for s, g in _SPLIT_CASES]


def _split_input(shape, dtype, seed, misaligned=False):
    """randn x * 2 + 0.5 of ``shape``, contiguous; ``misaligned``: 4 bytes off a
    16-byte boundary, so that the kernels take one value a thread."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    if not misaligned:
        return x
    buf = torch.empty(x.numel() + 8, dtype=dtype, device="cuda")
    out = buf[4 // x.element_size():][:x.numel()].view(shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("minmax", [False, True])
@pytest.mark.parametrize("shape,groups", _SPLIT_CASES, ids=_SPLIT_IDS)
def test_group_norm_stats_kernel(dev, shape, groups, minmax, dtype):
    """The split GroupNorm's stats entry against ``group_norm_stats_plain``:
    the sums within 1e-5 of the sum of |x| (f32 sums in another order), the
    extremes equal; one launch; a repeat gives the same bits, and so do the
    sums of a call with the extremes and one without."""
    x = _split_input(shape, dtype, len(shape) + shape[-1])
    n0 = G.group_norm_stats_cuda.launches
    sums, ext = G.group_norm_stats_cuda(x, groups, minmax)
    torch.cuda.synchronize()
    assert G.group_norm_stats_cuda.launches == n0 + 1
    rs, rext = G.group_norm_stats_plain(x, groups, minmax)
    B, C = shape[0], shape[-1]
    scale = torch.stack([x.float().abs(), x.float().square()]).reshape(2, B, -1, groups, C // groups).sum((2, 4))
    assert sums.shape == (2, B, groups) and ((sums - rs).abs() <= 1e-5 * scale + 1e-6).all()
    if minmax:
        assert torch.equal(ext, rext)
    else:
        assert ext is None
    sums2, ext2 = G.group_norm_stats_cuda(x, groups, minmax)
    assert torch.equal(sums2, sums) and (ext2 is None or torch.equal(ext2, ext))
    assert torch.equal(G.group_norm_stats_cuda(x, groups, not minmax)[0], sums)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_split_kernels_one_value_a_thread(dev, dtype):
    """A misaligned x takes one value a thread (vec 1): the stats, K3's and
    K4's applies as with 16-byte vectors, the applies bit-identical to the
    first versions."""
    shape = (2, 16, 32, 256)
    x = _split_input(shape, dtype, 3, misaligned=True)
    assert G._vec(x, 256) == 1
    sums, ext = G.group_norm_stats_cuda(x, 32, True)
    rs, rext = G.group_norm_stats_plain(x, 32, True)
    scale = torch.stack([x.float().abs(), x.float().square()]).reshape(2, 2, -1, 32, 8).sum((2, 4))
    assert ((sums - rs).abs() <= 1e-5 * scale + 1e-6).all() and torch.equal(ext, rext)
    g = torch.Generator(device=dev).manual_seed(4)
    a, b = torch.randn(2, 256, generator=g, device=dev), torch.randn(2, 256, generator=g, device=dev)
    inv = torch.rand(2, generator=g, device=dev) * 20 + 10
    assert torch.equal(G.group_norm_apply_cuda(x, a, b, True), G.group_norm_apply_simple(x, a, b, True))
    assert torch.equal(G.group_norm_quant_apply_cuda(x, a, b, inv, True), G.group_norm_quant_apply_simple(x, a, b, inv, True))


def test_group_norm_split_kernels_refuse(dev):
    """What the split kernels do not take raises on a CUDA tensor: a row of
    more than 512 vectors, another dtype, a non-contiguous x."""
    a = b = torch.zeros(2, 4096, device=dev)
    with pytest.raises(ValueError, match="at most 512 vectors"):
        G.group_norm_apply_cuda(torch.zeros(2, 4, 4096, device=dev), a, b, False)
    with pytest.raises(ValueError, match="at most 512 vectors"):
        G.group_norm_stats_cuda(torch.zeros(2, 4, 4096, device=dev), 32, False)
    with pytest.raises(TypeError):
        G.group_norm_stats_cuda(torch.zeros(2, 4, 64, device=dev, dtype=torch.float16), 32, False)
    with pytest.raises(ValueError, match="contiguous"):
        G.group_norm_quant_apply_cuda(torch.zeros(2, 64, 4, device=dev).transpose(1, 2), a[:, :64], b[:, :64],
                                      torch.ones(2, device=dev), False)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,groups", _SPLIT_CASES, ids=_SPLIT_IDS)
def test_group_norm_apply_kernel(dev, shape, groups, silu, dtype, tol):
    """K3's apply entry against ``group_norm_apply_plain`` (K3's tolerances:
    the kernel's fused multiply-add and fast exponential, bf16 roundings),
    and bit-identical to its first version."""
    g = torch.Generator(device=dev).manual_seed(len(shape) + 7)
    B, C = shape[0], shape[-1]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    a, b = torch.randn(B, C, generator=g, device=dev), torch.randn(B, C, generator=g, device=dev)
    n0 = G.group_norm_apply_cuda.launches
    y = G.group_norm_apply_cuda(x, a, b, silu)
    torch.cuda.synchronize()
    assert G.group_norm_apply_cuda.launches == n0 + 1
    assert y.dtype == dtype and y.shape == x.shape
    torch.testing.assert_close(y.float(), G.group_norm_apply_plain(x, a, b, silu).float(), rtol=tol, atol=tol)
    assert torch.equal(y, G.group_norm_apply_simple(x, a, b, silu))


@pytest.mark.parametrize("emit", ["s8", "x"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,groups", _SPLIT_CASES, ids=_SPLIT_IDS)
def test_group_norm_quant_apply_kernel(dev, shape, groups, silu, dtype, emit):
    """K4's apply entry against ``group_norm_quant_apply_plain``: q within one
    level on at most 1e-4 of the elements (the kernel's exponential against
    torch's SiLU), in the dtype asked for, and bit-identical to its first
    version."""
    g = torch.Generator(device=dev).manual_seed(len(shape) + 11)
    B, C = shape[0], shape[-1]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    a, b = torch.randn(B, C, generator=g, device=dev), torch.randn(B, C, generator=g, device=dev) * 0.1
    inv = torch.rand(B, generator=g, device=dev) * 20 + 10
    out_dtype = torch.int8 if emit == "s8" else dtype
    n0 = G.group_norm_quant_apply_cuda.launches
    q = G.group_norm_quant_apply_cuda(x, a, b, inv, silu, out_dtype)
    torch.cuda.synchronize()
    assert G.group_norm_quant_apply_cuda.launches == n0 + 1
    assert q.dtype == out_dtype and q.shape == x.shape
    _q_flips_ok(q, G.group_norm_quant_apply_plain(x, a, b, inv, silu, out_dtype))
    assert torch.equal(q, G.group_norm_quant_apply_simple(x, a, b, inv, silu, out_dtype))


@pytest.mark.parametrize("kernel", ["K3", "K4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_split_on_row_shards_equals_one_launch(dev, dtype, kernel):
    """The split path as two ranks run it, on one card: each half of the
    rows' stats, summed (and K4's extremes combined), folded and applied,
    against the one-launch K3 or K4 on the whole map, at ADM-256's 256 px
    width with scale-shift and SiLU (K3's and K4's tolerances)."""
    g = torch.Generator(device=dev).manual_seed(5)
    B, H, W, C = 2, 64, 256, 256
    x = (torch.randn((B, H, W, C), generator=g, device=dev) + 0.3).to(dtype)
    w, b = torch.randn(C, generator=g, device=dev) * 0.1 + 1, torch.randn(C, generator=g, device=dev) * 0.1
    ss = (torch.randn(B, C, generator=g, device=dev) * 0.2, torch.randn(B, C, generator=g, device=dev) * 0.2)
    halves = [x[:, :H // 2].contiguous(), x[:, H // 2:].contiguous()]
    parts = [G.group_norm_stats_cuda(h, 32, kernel == "K4") for h in halves]
    sums = parts[0][0] + parts[1][0]
    mean, rstd, a, bb = G._fold(sums, H * W * C // 32, w, b, 32, 1e-5, ss)
    with torch.inference_mode():
        if kernel == "K3":
            y = torch.cat([G.group_norm_apply_cuda(h, a, bb, True) for h in halves], dim=1)
            ref = G.fused_group_norm(x, w, b, 32, 1e-5, True, ss)
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)
            return
        lo = torch.minimum(parts[0][1][0], parts[1][1][0])
        hi = torch.maximum(parts[0][1][1], parts[1][1][1])
        s, inv = G._bound_scale(a, bb, lo, hi, True)
        q = torch.cat([G.group_norm_quant_apply_cuda(h, a, bb, inv, True) for h in halves], dim=1)
        rq, rs = G.fused_group_norm_quant(x, w, b, 32, 1e-5, True, ss)
    torch.testing.assert_close(s, rs, rtol=1e-6, atol=0)
    _q_flips_ok(q, rq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 128, 256, 256), (2, 32, 32, 512), (1, 7, 5, 3), (37,)])
def test_quantize_split_kernels(dev, shape, dtype):
    """The quantize kernels' two passes apart: the amax word equals the bits
    of ``absmax_plain``, a MAX of two halves' words is the whole tensor's,
    and ``quantize_given_cuda`` from it gives ``quantize_per_tensor_cuda``'s
    q, s and factors bit for bit."""
    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    g = torch.Generator(device=dev).manual_seed(len(shape) + 1)
    x = (torch.randn(shape, generator=g, device=dev) * 3).to(dtype)
    s_w = torch.rand(24, generator=g, device=dev) * 0.01 + 1e-4
    n0, m0 = Q.absmax_cuda.launches, Q.quantize_given_cuda.launches
    bits = Q.absmax_cuda(x)
    assert bits.dtype == torch.int32 and bits.view(torch.float32).item() == Q.absmax_plain(x).item()
    if x.numel() >= 32:
        flat = x.reshape(-1)
        half = flat.numel() // 32 * 16
        both = torch.maximum(Q.absmax_cuda(flat[:half]), Q.absmax_cuda(flat[half:].clone()))
        assert torch.equal(both, bits)
    q, s, factors = Q.quantize_given_cuda(x, bits, s_w)
    torch.cuda.synchronize()
    assert Q.quantize_given_cuda.launches == m0 + 1 and Q.absmax_cuda.launches >= n0 + 1
    rq, rs, rf = Q.quantize_per_tensor_cuda(x, s_w)
    assert torch.equal(q, rq) and torch.equal(s, rs) and torch.equal(factors, rf)


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
