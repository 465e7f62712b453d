"""Kernels K6 and K7's plain versions against the JAX package, and their two
tool entry points rehearsed on the CPU.

K6 (``ops/fused_conv.py``): the same x, w and bias from a numpy seed go
through ``fused_conv3x3_plain`` and through the Pallas kernel in interpret mode
(``guided_diffusion_clip_tpu.ops.pallas_conv.fused_conv3x3(...,
interpret=True)``), f32 on the CPU. Quantized mode within 1e-5 * max(1, |ref|):
q and the s32 sums are the same integers, only the epilogue's f32 products
round differently. bf16 mode within 1e-3 * max|ref| of the kernel (f32 sums in
another order) and within rtol 0.05 / atol 0.3 of the f32 conv, the bound of
``tests/test_pallas_conv.py``. The second shape has two row bands, so it holds
the band scale. K7 (``ops/mma_probe.py``): against numpy in int64 and f32.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guided_diffusion_clip_tpu.ops import pallas_conv as JP
from guided_diffusion_clip_tpu_torch.ops import fused_conv as FC
from guided_diffusion_clip_tpu_torch.ops import mma_probe as MP
from guided_diffusion_clip_tpu_torch.tools import conv_bench, mxu_ceiling

torch.set_num_threads(2)

SHAPES = [(2, 16, 16, 128, 128), (1, 32, 32, 128, 256)]


def _inputs(shape, seed):
    B, H, W, C, K = shape
    rs = np.random.RandomState(seed)
    x = rs.randn(B, H, W, C).astype(np.float32)
    # bands of unequal range, so that a wrong band scale shows
    x *= np.linspace(0.25, 4.0, H, dtype=np.float32)[None, :, None, None]
    w = (rs.randn(3, 3, C, K) * 0.05).astype(np.float32)
    b = rs.randn(K).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape", SHAPES)
def test_pick_tiles_keeps_the_band_rule(shape):
    B, H, W, C, K = shape
    assert FC.supports_shape(B, H, W, C, K) and JP.supports_shape(B, H, W, C, K)
    assert FC._pick_tiles(B, H, W, C, K) == JP._pick_tiles(B, H, W, C, K)[1]
    assert H // FC._pick_tiles(B, H, W, C, K) == (1 if H == 16 else 2)
    for bad in [(1, 16, 16, 64, 128), (1, 16, 16, 128, 64), (1, 16, 12, 128, 128), (1, 1, 16, 128, 128)]:
        assert FC.supports_shape(*bad) == JP.supports_shape(*bad) == False  # noqa: E712
    for other in [(8, 256, 256, 256, 256), (16, 64, 64, 512, 512), (16, 16, 16, 1024, 1024), (4, 24, 16, 128, 128)]:
        want = JP._pick_tiles(*other)
        assert FC._pick_tiles(*other) == (None if want is None else want[1]), other


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantized_plain_matches_the_pallas_kernel(shape, with_bias):
    x, w, b = _inputs(shape, 0)
    ref = np.asarray(JP.fused_conv3x3(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b) if with_bias else None, quantized=True, interpret=True,
    ))
    ours = FC.fused_conv3x3(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b) if with_bias else None, quantized=True,
    ).numpy()
    assert ours.shape == ref.shape and ours.dtype == np.float32
    assert (np.abs(ours - ref) <= 1e-5 * np.maximum(1.0, np.abs(ref))).all(), np.abs(ours - ref).max()


def test_band_scales_follow_the_two_block_window():
    """Band i's scale spans input rows [i*bh - 1, (i+2)*bh - 1): a spike in
    the LAST row of band 1 reaches band 0's scale (the TPU kernel holds both
    blocks), one in the first row of band 1 also does, and a spike in band
    0's first row does not reach band 1."""
    B, H, W, C, K = 1, 32, 32, 128, 128
    bh = FC._pick_tiles(B, H, W, C, K)
    assert bh == 16
    base = torch.full((B, H, W, C), 0.5)
    for row, want0, want1 in [(30, 9.0, 9.0), (31, 0.5, 9.0), (16, 9.0, 9.0), (0, 9.0, 0.5), (14, 9.0, 0.5), (15, 9.0, 9.0)]:
        x = base.clone()
        x[0, row, 3, 5] = -9.0
        s = FC.band_scales(x, bh)
        np.testing.assert_allclose(s.numpy()[0] * 127.0, [want0, want1], rtol=1e-6, err_msg=f"row {row}")


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_mode_plain_matches_the_pallas_kernel_and_the_f32_conv(shape):
    x, w, b = _inputs(shape, 1)
    ref = np.asarray(JP.fused_conv3x3(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), quantized=False, interpret=True,
    ))
    xt, wt, bt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    ours = FC.fused_conv3x3(xt, wt, bt, quantized=False).numpy()
    assert np.abs(ours - ref).max() <= 1e-3 * np.abs(ref).max()
    f32 = torch.nn.functional.conv2d(xt.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), bt, padding=1)
    np.testing.assert_allclose(ours, f32.permute(0, 2, 3, 1).numpy(), rtol=0.05, atol=0.3)


@pytest.mark.parametrize("quantized", [True, False])
def test_bf16_input_gives_bf16_output(quantized):
    x, w, b = _inputs(SHAPES[0], 2)
    xb = torch.from_numpy(x).bfloat16()
    y = FC.fused_conv3x3(xb, torch.from_numpy(w), torch.from_numpy(b), quantized=quantized)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 16, 16, 128)
    ref = FC.fused_conv3x3(xb.float(), torch.from_numpy(w), torch.from_numpy(b), quantized=quantized)
    assert (y.float() - ref).abs().max() <= 2 ** -7 * ref.abs().max()  # one bf16 rounding of the output


def test_fused_conv_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """On the CPU every refusal is reached before the library would load."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(SHAPES[0], 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        FC.fused_conv3x3_cuda(x, w, b)
    with pytest.raises(ValueError, match="unsupported"):
        FC.fused_conv3x3(torch.zeros(1, 16, 16, 64), torch.zeros(3, 3, 64, 128))
    with pytest.raises(ValueError, match="no implementation"):
        FC.fused_conv3x3(x.to("meta"), w)
    assert FC.fused_conv3x3_cuda.launches == 0


@pytest.mark.parametrize("T", [1, 7, 2000])
def test_accumulating_dots_s8_plain_wraps_like_int32(T):
    rs = np.random.RandomState(4)
    x = rs.randint(-127, 128, (MP.BM, MP.BK)).astype(np.int8)
    w = rs.randint(-127, 128, (MP.BK, MP.BN)).astype(np.int8)
    out = MP.accumulating_dots(torch.from_numpy(x), torch.from_numpy(w), T)
    assert out.dtype == torch.int32 and out.shape == (MP.BM, MP.BN)
    exact = (x.astype(np.int64) @ w.astype(np.int64)) * T
    np.testing.assert_array_equal(out.numpy(), exact.astype(np.int32))  # numpy's cast wraps modulo 2^32
    if T == 2000:
        assert (np.abs(exact) >= 2 ** 31).any()  # the sum does pass the s32 range


def test_accumulating_dots_bf16_plain():
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(MP.BM, MP.BK).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rs.randn(MP.BK, MP.BN).astype(np.float32)).bfloat16()
    out = MP.accumulating_dots(x, w, 3)
    assert out.dtype == torch.float32
    ref = 3.0 * (x.float().numpy() @ w.float().numpy())
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_accumulating_dots_refuses_other_shapes_and_types():
    x = torch.zeros(MP.BM, MP.BK, dtype=torch.int8)
    w = torch.zeros(MP.BK, MP.BN, dtype=torch.int8)
    with pytest.raises(ValueError, match="takes"):
        MP.accumulating_dots(x[:256], w, 1)
    with pytest.raises(TypeError):
        MP.accumulating_dots(x.float(), w.float(), 1)
    with pytest.raises(TypeError):
        MP.accumulating_dots(x, w.bfloat16(), 1)
    with pytest.raises(ValueError, match="T must"):
        MP.accumulating_dots(x, w, 0)
    with pytest.raises(ValueError, match="CUDA"):
        MP.accumulating_dots_cuda(x, w, 1)
    assert MP.accumulating_dots_cuda.launches == 0


def test_conv_bench_tool_on_cpu(monkeypatch, capsys):
    """The conv bench entry point at one tiny shape: four strategies run, the
    last line is the rows as JSON, and a CPU run reports no rate."""
    monkeypatch.setenv("PCB_SHAPES", "1x16x128x128")
    monkeypatch.setenv("CMB_ITERS", "1")
    rows = conv_bench.main(["--device", "cpu"])
    assert len(rows) == 1 and rows[0]["shape"] == "B1 16x16 128->128" and rows[0]["supported"]
    assert {"cudnn_bf16", "k5_int8", "k6_bf16", "k6_int8"} <= set(rows[0])
    assert rows[0]["device"] == "cpu" and rows[0]["k6_int8"] is None
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rows
    monkeypatch.setenv("PCB_ONLY", "k6_")
    assert "cudnn_bf16" not in conv_bench.main(["--device", "cpu"])[0]


def test_tools_need_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (conv_bench, mxu_ceiling):
        with pytest.raises(SystemExit, match="no CUDA device"):
            tool.main([])


def test_conv_tune_tool_is_card_only(monkeypatch):
    """The K5 schedule sweep has no CPU mode (a schedule has no plain
    version): it refuses a missing card by name; its layers are ones the
    tensor-core kernel takes and its grid holds every tile ``pick_tile`` can
    choose."""
    from guided_diffusion_clip_tpu_torch.ops import quant as TQ
    from guided_diffusion_clip_tpu_torch.tools import conv_tune

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        conv_tune.main()
    for _, B, H, C, K, k in conv_tune.LARGE + conv_tune.SMALL:
        assert TQ.uses_tensor_cores(C, K, k)
        assert TQ.pick_tile(B * H * H, K, -(-k * k * C // 32) * 32)[0] in {bm for bm, _ in conv_tune.GRID}


def test_mxu_ceiling_tool_on_cpu(capsys):
    out = mxu_ceiling.main(["--device", "cpu"])
    assert out["device"] == "cpu"
    for name in ("s8", "bf16"):
        assert out[name]["tf_per_sec_slope"] is None and out[name]["ms_lo"] > 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert (mxu_ceiling.T_LO, mxu_ceiling.T_HI) == (2000, 6000)
