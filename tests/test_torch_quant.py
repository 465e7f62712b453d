"""The port's int8 path (``--conv_impl int8``) against the JAX package's, on
the CPU: the quantizers, ``int8_conv`` and ``conv_prequant`` with their
straight-through backwards, K4's and K5's plain versions (against the XLA
composites and the Pallas kernels in interpret mode), and int8 UNet and
classifier forwards, guidance gradient and a guided chain with the same
weights.

Tolerances: the quantizers and convs within 1e-6 * max|ref| (the integer
products are exact; f32 sums in another order); the quantizing GroupNorm's
s to rtol 1e-6 (1e-5 against the interpret-mode kernel, whose sums run in
tiles) and q within one level on at most 1e-3 of the elements (a value at
a rounding boundary may flip); STE gradients within 1e-5 * max|ref|. The
int8 models are compared teacher-forced (``jax_quantization``): forwards
and guided steps within 1e-3 * max(1, |ref|) but for rare flips of the
unforced output head (``_close_but_flips``); the guidance gradient within
1e-5 * max|ref| with f32 straight-through convs, and within bf16's 2e-2 *
max|ref| as shipped (see the test).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guided_diffusion_clip_tpu.diffusion import guidance as JGd
from guided_diffusion_clip_tpu.diffusion import sampling as JS
from guided_diffusion_clip_tpu.diffusion import schedules as JSch
from guided_diffusion_clip_tpu.ops import pallas_groupnorm as JPG
from guided_diffusion_clip_tpu.ops import quant as JQ
from guided_diffusion_clip_tpu.ops.config import set_conv_impl
from guided_diffusion_clip_tpu.ops.pallas_conv import fused_conv3x3_s8
from guided_diffusion_clip_tpu.models.unet import UNetConfig as JaxConfig
from guided_diffusion_clip_tpu.models.unet import UNetModel as JaxUNet
from guided_diffusion_clip_tpu_torch.diffusion import guidance as TGd
from guided_diffusion_clip_tpu_torch.diffusion import sampling as TS
from guided_diffusion_clip_tpu_torch.diffusion import schedules as TSch
from guided_diffusion_clip_tpu_torch.models.nn import Conv2d
from guided_diffusion_clip_tpu_torch.models.unet import EncoderUNetModel, UNetConfig, UNetModel
from guided_diffusion_clip_tpu_torch.ops import groupnorm as TG
from guided_diffusion_clip_tpu_torch.ops import quant as TQ
from guided_diffusion_clip_tpu_torch.utils.convert import state_dict_from_flax
from torch_port_utils import clip_feat_pair, encoder_pair, nchw, nhwc, random_params, upstream_pair

torch.set_num_threads(2)


@contextlib.contextmanager
def jax_int8():
    """The JAX package's int8 path for what is traced inside."""
    set_conv_impl("int8")
    try:
        yield
    finally:
        set_conv_impl("auto")


def _close(out, ref, tol, scale=None):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * scale)


def _close_but_flips(out, ref, tol, scale, share=0.005, l2=5e-3):
    """Within ``tol * scale`` on all but ``share`` of the elements, relative
    L2 within ``l2``: the output head's per-tensor quantization is not
    teacher-forced, and a value at a rounding boundary there may flip,
    moving a 3x3 patch of the output."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    d = np.abs(out - ref)
    assert (d > tol * scale).mean() <= share, ((d > tol * scale).mean(), d.max() / scale)
    assert np.linalg.norm(d) <= l2 * np.linalg.norm(ref), np.linalg.norm(d) / np.linalg.norm(ref)


def _q_close(q, ref, share):
    """q within one level of ref everywhere, and off on at most ``share`` of it."""
    d = np.abs(np.asarray(q, np.int64) - np.asarray(ref, np.int64))
    assert d.max() <= 1 and (d > 0).mean() <= share, (d.max(), (d > 0).mean())


def _jax_int8_apply(jm, params, *args, **kw):
    """The JAX model's int8 forward and its captured intermediates."""
    with jax_int8():
        out, inter = jax.jit(lambda p, *a, **k: jm.apply(
            {"params": p}, *a, **k, capture_intermediates=True, mutable=["intermediates"]))(
            params, *map(jnp.asarray, args), **{k: jnp.asarray(v) for k, v in kw.items()})
    return np.asarray(out), inter["intermediates"]


# the JAX module name of each of the port's int8 submodules, by the path
# inside its block
_JAX_NAMES = {"in_layers.0": "in_norm", "out_layers.0": "out_norm", "in_layers.2": "in_conv",
              "out_layers.3": "out_conv", "skip_connection": "skip", "op": "op", "conv": "conv"}


def _jax_intermediate(inter, name):
    """The JAX model's captured output for the port's submodule ``name``."""
    parts = name.split(".")
    if parts[0] == "middle_block":
        key, rest = [f"middle_block_{parts[1]}"], parts[2:]
    else:
        key, rest = [f"{parts[0]}_{parts[1]}_{parts[2]}"], parts[3:]
    if rest:
        key.append(_JAX_NAMES[".".join(rest)])
    for k in key:
        inter = inter[k]
    return inter["__call__"][0]


def _forced(out, ref):
    """JAX's value in place of the port's, with the port's gradient."""
    ref = ref.to(out.dtype).contiguous(memory_format=torch.channels_last)
    return out + (ref - out).detach() if out.requires_grad else ref


@contextlib.contextmanager
def jax_quantization(m, inter, share=1e-3):
    """Teacher forcing at every rounding of the port's int8 model ``m``:
    each quantizing GroupNorm checks its own (q, s) against the JAX model's
    captured from the same forward (s to rtol 1e-6, plus 8 (mean / std)^2
    ulps, which the one-pass variance of an offset group loses; q within one level
    on all but ``share``), and each per-tensor ``int8_conv`` its output (max
    within 1e-2 * max|ref|, relative L2 within 5e-3: a flipped level of x_q
    moves a 3x3 patch by s_x * |w|), then passes on JAX's. The output head
    is not forced: the test compares it.

    Two int8 forwards with f32 arithmetic in another order put a value on
    the other side of a rounding boundary now and then (about once per
    tiny-model forward here); the changed level moves the next conv's
    outputs by s * |w|, which shifts many more values across boundaries in
    the layers after it, until the two outputs differ by as much as int8
    differs from float. Forcing JAX's values after checking them keeps each
    layer's comparison to its own rounding.
    """
    from guided_diffusion_clip_tpu_torch.models.nn import GroupNorm32

    patched = []

    def force_gn(gn, ref):
        orig = gn.forward

        def forward(x, activation=None, scale_shift=None, quantize=False):
            out = orig(x, activation, scale_shift, quantize)
            if not quantize:
                return out
            q, s = out
            rq, rsc = nchw(np.asarray(ref[0], np.float32)), torch.from_numpy(np.asarray(ref[1]))
            _q_close(q.detach().float().numpy(), rq.numpy(), share)
            # the one-pass variance E[x^2] - mean^2 loses (mean / std)^2 ulps,
            # a few times over (the sums, the variance, the folded bias)
            xg = x.detach().double().movedim(1, -1).reshape(x.shape[0], -1, 32, x.shape[1] // 32)
            ratio = (xg.mean((1, 3)).abs() / xg.std((1, 3))).max().item()
            np.testing.assert_allclose(s.numpy(), rsc.numpy(), rtol=1e-6 + ratio**2 * 2.0**-20,
                                       err_msg=f"groups' max |mean| / std {ratio:.3g}")
            return _forced(q, rq), rsc

        gn.forward = forward
        patched.append(gn)

    def force_conv(conv, ref):
        orig = conv.forward

        def forward(x, prequant_scales=None, out_dtype=None):
            out = orig(x, prequant_scales, out_dtype)
            if prequant_scales is not None:
                return out
            r = nchw(np.asarray(ref, np.float32))
            d = (out.detach().float() - r).abs()
            assert d.max() <= 1e-2 * r.abs().max(), d.max() / r.abs().max()
            assert d.norm() <= 5e-3 * r.norm(), d.norm() / r.norm()
            return _forced(out, r)

        conv.forward = forward
        patched.append(conv)

    for name, mod in m.named_modules():
        if not name.startswith(("input_blocks.", "middle_block.", "output_blocks.")):
            continue
        if isinstance(mod, GroupNorm32) and name.endswith(("in_layers.0", "out_layers.0")):
            force_gn(mod, _jax_intermediate(inter, name))
        elif isinstance(mod, Conv2d) and mod.int8:
            force_conv(mod, _jax_intermediate(inter, name))
    try:
        yield
    finally:
        for mod in patched:
            del mod.forward


# --- the quantizers and convs ------------------------------------------------


def test_quantizers_match_jax():
    rs = np.random.RandomState(0)
    x = (rs.standard_normal((2, 6, 6, 16)) * 3).astype(np.float32)
    w = (rs.standard_normal((3, 3, 16, 8)) * 0.1).astype(np.float32)
    w[..., 2] *= 100.0
    w[..., 5] = 0.0  # an all-zero channel: the 1e-8 floor
    for ours, theirs, a in ((TQ.quantize_per_tensor, JQ.quantize_per_tensor, x),
                            (TQ.quantize_per_out_channel, JQ.quantize_per_out_channel, w)):
        q, s = ours(torch.from_numpy(a))
        rq, rsc = theirs(jnp.asarray(a))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        _close(s.numpy(), rsc, 1e-6)


@pytest.mark.parametrize("k,stride,C,bias", [(3, 1, 16, True), (3, 2, 16, False), (1, 1, 24, True), (3, 1, 3, True)])
def test_int8_conv_matches_jax(k, stride, C, bias):
    """3x3 and 1x1, stride 1 and 2, the 3-channel stem; the JAX op adds the
    bias outside (``_QuantConvCore``), the port's inside."""
    rs = np.random.RandomState(k * 10 + stride + C)
    x = rs.standard_normal((2, 9, 10, C)).astype(np.float32)
    w = (rs.standard_normal((k, k, C, 12)) * 0.2).astype(np.float32)
    b = (rs.standard_normal(12) * 0.1).astype(np.float32)
    p = (k - 1) // 2
    ref = JQ.int8_conv(jnp.asarray(x), jnp.asarray(w), stride, ((p, p), (p, p)))
    if bias:
        ref = ref + b
    out = TQ.int8_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b) if bias else None, stride)
    assert out.dtype == torch.float32
    _close(out.numpy(), ref, 1e-6)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_prequant_matches_jax_given_q(stride):
    rs = np.random.RandomState(9 + stride)
    q = rs.randint(-127, 128, (2, 8, 8, 32)).astype(np.float32)
    s = np.array([0.01, 0.03], np.float32)
    w = (rs.standard_normal((3, 3, 32, 16)) * 0.1).astype(np.float32)
    b = (rs.standard_normal(16) * 0.1).astype(np.float32)
    ref = JQ.conv_prequant(jnp.asarray(q), jnp.asarray(s), jnp.asarray(w), jnp.asarray(b), stride)
    args = (torch.from_numpy(s), torch.from_numpy(w), torch.from_numpy(b), stride)
    for qt in (torch.from_numpy(q), torch.from_numpy(q).to(torch.int8)):  # both emissions
        _close(TQ.conv_prequant(qt, *args).numpy(), ref, 1e-6)
    bf = TQ.conv_prequant(torch.from_numpy(q).to(torch.int8), *args, out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.float().numpy(), np.asarray(jnp.asarray(ref).astype(jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_conv_s8_plain_matches_pallas_kernel(out_dtype):
    """K5's plain version against ``fused_conv3x3_s8`` in interpret mode, at a
    shape the TPU kernel takes (C, K multiples of 128, W >= 16)."""
    rs = np.random.RandomState(13)
    q = rs.randint(-127, 128, (2, 4, 16, 128)).astype(np.int8)
    w_q = rs.randint(-127, 128, (3, 3, 128, 128)).astype(np.int8)
    s_img = np.array([0.02, 0.005], np.float32)
    s_w = (rs.rand(128) * 1e-3 + 1e-4).astype(np.float32)
    b = (rs.standard_normal(128) * 0.1).astype(np.float32)
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    ref = fused_conv3x3_s8(jnp.asarray(q), jnp.asarray(s_img), jnp.asarray(w_q), jnp.asarray(s_w),
                           jnp.asarray(b), interpret=True, out_dtype=jdt)
    out = TQ.conv_s8(torch.from_numpy(q), torch.from_numpy(w_q), torch.from_numpy(s_img),
                     torch.from_numpy(s_w), torch.from_numpy(b), 1, out_dtype)
    assert out.dtype == out_dtype and tuple(out.shape) == (2, 4, 16, 128)
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    if out_dtype == torch.float32:
        _close(out.numpy(), ref, 1e-6)
    else:  # one bf16 rounding of the same f32 value, unless the f32 sums straddle it
        diff = np.abs(out.float().numpy() - ref)
        assert (diff <= 2 ** -7 * np.abs(ref)).all() and (diff > 0).mean() < 1e-3


def test_conv_s8_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 4, 32, dtype=torch.int8)
    w = torch.zeros(3, 3, 32, 8, dtype=torch.int8)
    one = torch.ones(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TQ.conv_s8_cuda(q, w, None, one, None, 1, torch.float32)
    with pytest.raises(ValueError, match="no implementation"):
        TQ.conv_s8(q.to("meta"), w, None, one)


def test_pack_weights_is_a_view_for_ohwi_memory():
    w = torch.randint(-127, 128, (8, 3, 3, 32), dtype=torch.int8)  # OHWI memory
    rows = TQ._pack_weights(w.permute(1, 2, 3, 0))
    assert rows.data_ptr() == w.data_ptr() and tuple(rows.shape) == (8, 288)
    stem = TQ._pack_weights(torch.randint(-127, 128, (3, 3, 3, 8), dtype=torch.int8))
    assert tuple(stem.shape) == (8, 32) and (stem[:, 27:] == 0).all()


# --- K4's plain version --------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale_shift", [False, True])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_quant_plain_matches_jax(silu, scale_shift, dtype):
    """Against ``_gn_reference_quant`` (integer values in x's dtype) and
    ``gn_reference_quant_s8`` (s8)."""
    rs = np.random.RandomState(int(silu) + 2 * int(scale_shift))
    B, C = 2, 64
    x = (rs.standard_normal((B, 8, 8, C)) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rs.standard_normal(C)).astype(np.float32)
    be = (0.1 * rs.standard_normal(C)).astype(np.float32)
    ss = tuple((0.2 * rs.standard_normal((B, C))).astype(np.float32) for _ in range(2)) if scale_shift else None
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = jnp.asarray(x).astype(jdt)
    jss = None if ss is None else tuple(jnp.asarray(t) for t in ss)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(dtype)
    tss = None if ss is None else tuple(torch.from_numpy(t) for t in ss)
    args = (torch.from_numpy(g), torch.from_numpy(be), 32, 1e-5, silu, tss)
    for emit, theirs in (("x", JPG._gn_reference_quant), ("s8", JPG.gn_reference_quant_s8)):
        rq, rsc = theirs(jx, jnp.asarray(g), jnp.asarray(be), 32, 1e-5, silu, jss)
        out_dtype = torch.int8 if emit == "s8" else dtype
        q, s = TG.group_norm_quant_plain(tx, *args, out_dtype=out_dtype)
        assert q.dtype == out_dtype and tuple(s.shape) == (B,)
        np.testing.assert_allclose(s.numpy(), np.asarray(rsc), rtol=1e-6)
        _q_close(q.float().numpy(), np.asarray(rq.astype(jnp.float32)), 1e-3)
    # the dispatching entry point emits s8 when nothing is differentiated
    q8, s8 = TG.group_norm_quant(tx, *args[:2], groups=32, silu=silu, scale_shift=tss)
    assert q8.dtype == torch.int8
    torch.testing.assert_close(s8, s, rtol=0, atol=0)


@pytest.mark.parametrize("scale_shift", [False, True])
def test_group_norm_quant_plain_matches_pallas_interpret(scale_shift):
    rs = np.random.RandomState(8)
    B, C = 2, 64
    x = rs.standard_normal((B, 8, 8, C)).astype(np.float32)
    g = (rs.rand(C) + 0.5).astype(np.float32)
    be = (rs.standard_normal(C) * 0.1).astype(np.float32)
    ss = tuple((0.2 * rs.standard_normal((B, C))).astype(np.float32) for _ in range(2)) if scale_shift else None
    rq, rsc = JPG.group_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(be), groups=32, silu=True,
                             scale_shift=None if ss is None else tuple(map(jnp.asarray, ss)),
                             impl="pallas_interpret", quantize_out=True, emit="s8")
    q, s = TG.group_norm_quant_plain(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(be), 32, 1e-5,
                                     True, None if ss is None else tuple(map(torch.from_numpy, ss)))
    np.testing.assert_allclose(s.numpy(), np.asarray(rsc), rtol=1e-5)
    _q_close(q.numpy(), np.asarray(rq), 1e-3)


def test_group_norm_quant_stats_match_group_norm():
    """The mean and rstd K4's finalize hands the backward are K3's."""
    x = torch.randn(2, 5, 5, 64) * 3 + 1
    w, b = torch.rand(64) + 0.5, torch.randn(64) * 0.1
    _, _, stats = TG._group_norm_quant_plain_stats(x, w, b, 32, 1e-5, True, None, torch.int8)
    _, ref = TG._group_norm_plain_stats(x, w, b, 32, 1e-5, True, None)
    torch.testing.assert_close(stats, ref, rtol=0, atol=0)


def test_fused_group_norm_quant_refuses_what_the_kernel_does_not_take():
    x = torch.randn(2, 4, 4, 64)
    w, b = torch.ones(64), torch.zeros(64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TG.fused_group_norm_quant(x, w, b, 32, 1e-5, True, None)
    with pytest.raises(TypeError, match="int8 or x's dtype"):
        TG.fused_group_norm_quant(x, w, b, 32, 1e-5, True, None, out_dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="records no backward"):
        TG.fused_group_norm_quant(x.requires_grad_(True), w, b, 32, 1e-5, True, None)


# --- straight-through gradients --------------------------------------------------


def test_int8_conv_gradients_match_jax():
    rs = np.random.RandomState(21)
    x = rs.standard_normal((2, 6, 6, 16)).astype(np.float32)
    w = (rs.standard_normal((3, 3, 16, 8)) * 0.2).astype(np.float32)
    g = rs.standard_normal((2, 3, 3, 8)).astype(np.float32)
    rdx, rdw = jax.vjp(lambda a, b: JQ.int8_conv(a, b, 2, ((1, 1), (1, 1))), jnp.asarray(x), jnp.asarray(w))[1](
        jnp.asarray(g))
    tx, tw = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    TQ.int8_conv(tx, tw, None, 2).backward(torch.from_numpy(g))
    _close(tx.grad.numpy(), rdx, 1e-5)
    _close(tw.grad.numpy(), rdw, 1e-5)


def test_gn_quant_conv_prequant_gradients_match_jax():
    """GN_q -> conv_prequant, as a ResBlock under int8: the gradient of x,
    the GroupNorm's scale and the conv's weight, f32 (the conv's backward in
    bf16, as the JAX package)."""
    rs = np.random.RandomState(10)
    x = rs.standard_normal((2, 8, 8, 64)).astype(np.float32)
    gamma = (rs.rand(64) + 0.5).astype(np.float32)
    beta = (rs.standard_normal(64) * 0.1).astype(np.float32)
    w = (rs.standard_normal((3, 3, 64, 32)) * 0.1).astype(np.float32)
    b = np.zeros(32, np.float32)
    ct = rs.standard_normal((2, 8, 8, 32)).astype(np.float32)

    def jloss(xx, gg, ww):
        q, s = JPG.group_norm(xx, gg, jnp.asarray(beta), groups=32, silu=True, impl="xla", quantize_out=True)
        return jnp.sum(JQ.conv_prequant(q, s, ww, jnp.asarray(b)) * ct)

    refs = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(w))
    tx, tg, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, gamma, w))
    q, s = TG.group_norm_quant(tx, tg, torch.from_numpy(beta), groups=32, silu=True)
    assert q.dtype == torch.float32  # the differentiable emission
    (TQ.conv_prequant(q, s, tw, torch.from_numpy(b)) * torch.from_numpy(ct)).sum().backward()
    for out, ref in zip((tx.grad, tg.grad, tw.grad), refs):
        assert np.abs(np.asarray(ref)).max() > 0
        _close(out.numpy(), ref, 1e-5)


# --- the models ----------------------------------------------------------------

# ADM-G's generator topology and the slice's CLIP UNet, shrunk to 16 px, and
# the fork's 128 px recipe (stride-2 conv Downsample, conv Upsample)
UPSTREAM = dict(
    image_size=16, in_channels=3, model_channels=64, out_channels=6, num_res_blocks=1,
    attention_resolutions=(2, 4), channel_mult=(1, 1, 2), num_classes=1000,
    num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True,
)
SLICE = dict(
    image_size=16, in_channels=3, model_channels=64, out_channels=6, num_res_blocks=1,
    attention_resolutions=(2, 4, 8), channel_mult=(1, 1, 2, 2), num_classes=512,
    num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True,
)
RECIPE128 = dict(
    image_size=16, in_channels=3, model_channels=32, out_channels=6, num_res_blocks=1,
    attention_resolutions=(2, 4), channel_mult=(1, 2, 3), num_classes=512,
    num_heads=1, use_scale_shift_norm=False, resblock_updown=False,
)
CLASSIFIER = dict(
    image_size=16, in_channels=3, model_channels=64, out_channels=1000, num_res_blocks=1,
    attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=64,
    use_scale_shift_norm=True, resblock_updown=True,
)


def _int8(tm):
    """The same torch model with its convs on the int8 path."""
    cls = EncoderUNetModel if isinstance(tm, EncoderUNetModel) else UNetModel
    kw = dict(pool=tm.pool) if cls is EncoderUNetModel else {}
    m = cls(tm.config, conv_impl="int8", **kw).eval()
    m.load_state_dict(tm.state_dict(), strict=True)
    return m


@pytest.mark.parametrize("which", ["upstream", "slice", "recipe128"])
def test_unet_int8_forward_matches_jax(which):
    """Teacher-forced (``jax_quantization``): every layer's q checked, the
    output within 1e-3 * max(1, |ref|)."""
    rs = np.random.RandomState(1)
    x = rs.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([17, 733], np.int32)
    if which == "upstream":
        jm, params, tm = upstream_pair(UPSTREAM, seed=1)
        kw = {"y": np.array([5, 871], np.int32)}
    else:
        jm, params, tm = clip_feat_pair(SLICE if which == "slice" else RECIPE128, seed=1)
        kw = {"clip_feat": rs.standard_normal((2, 512)).astype(np.float32)}
    ref, inter = _jax_int8_apply(jm, params, x, t, **kw)
    m = _int8(tm)
    with torch.inference_mode():
        with jax_quantization(m, inter):
            out = nhwc(m(nchw(x), torch.from_numpy(t), **{k: torch.from_numpy(v) for k, v in kw.items()}))
        plain = nhwc(tm(nchw(x), torch.from_numpy(t), **{k: torch.from_numpy(v) for k, v in kw.items()}))
    assert np.abs(ref).max() > 0.1 and np.abs(out - plain).max() > 1e-3 * np.abs(ref).max()  # int8 acts
    _close_but_flips(out, ref, 1e-3, max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("pool", ["attention", "adaptive"])
def test_classifier_int8_forward_matches_jax(pool):
    jm, params, tm = encoder_pair(CLASSIFIER, pool, seed=2)
    rs = np.random.RandomState(3)
    x = rs.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([3, 600], np.int32)
    ref, inter = _jax_int8_apply(jm, params, x, t)
    m = _int8(tm)
    with torch.inference_mode(), jax_quantization(m, inter):
        out = m(nchw(x), torch.from_numpy(t)).numpy()
    assert np.abs(ref).max() > 0.1
    _close_but_flips(out, ref, 1e-3, max(1.0, np.abs(ref).max()))


def test_bf16_torso_keeps_f32_conv_weights_under_int8():
    """use_fp16 with int8: the convs' w_q and s_w are the JAX package's
    quantization of the f32 params; the attention projections are bf16."""
    jm, params, tm = upstream_pair(UPSTREAM, seed=4)
    m = UNetModel(tm.config, dtype=torch.bfloat16, conv_impl="int8").eval()
    m.load_state_dict(tm.state_dict(), strict=True)
    sd = m.state_dict()
    assert sd["input_blocks.1.0.in_layers.2.weight"].dtype == torch.float32
    assert sd["input_blocks.3.1.qkv.weight"].dtype == torch.bfloat16
    convs = [(n, mod) for n, mod in m.named_modules() if isinstance(mod, Conv2d)]
    assert len(convs) > 10 and all(mod.int8 for _, mod in convs)
    for name in ("input_blocks.0.0", "input_blocks.1.0.in_layers.2", "output_blocks.2.0.skip_connection",
                 "out.2"):
        w_q, s_w = dict(convs)[name].quantized_weight()
        rq, rs_ = JQ.quantize_per_out_channel(jnp.asarray(sd[name + ".weight"].permute(2, 3, 1, 0).numpy()))
        np.testing.assert_array_equal(w_q.numpy(), np.asarray(rq), err_msg=name)
        np.testing.assert_array_equal(s_w.numpy(), np.asarray(rs_), err_msg=name)


def test_weight_quantization_follows_load_state_dict():
    _, _, tm = upstream_pair(UPSTREAM, seed=5)
    m = _int8(tm)
    conv = m.input_blocks[0][0]
    before = conv.quantized_weight()
    assert conv.quantized_weight() is before  # cached
    sd = m.state_dict()
    sd["input_blocks.0.0.weight"] = sd["input_blocks.0.0.weight"] * 2
    m.load_state_dict(sd, strict=True)
    w_q, s_w = conv.quantized_weight()
    torch.testing.assert_close(s_w, before[1] * 2)


def _conv_prequant_bwd_f32(stride, padding, res, g):
    """The JAX package's ``_conv_prequant_bwd`` with f32 operands in place of
    bf16."""
    q, s_img, w = res

    def ref(q_, w_, b_):
        x = q_.astype(jnp.float32) * s_img[:, None, None, None]
        y = jax.lax.conv_general_dilated(x, w_, (stride, stride), padding,
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return y + b_

    _, vjp = jax.vjp(ref, q, w, jnp.zeros((w.shape[-1],), jnp.float32))
    dq, dw, db = vjp(g.astype(jnp.float32))
    return dq.astype(q.dtype), jnp.zeros_like(s_img), dw, db


@pytest.mark.parametrize("ste", ["bfloat16", "float32"])
def test_int8_guidance_gradient_matches_jax_grad(ste, monkeypatch):
    """``classifier_cond_fn`` of the int8 classifier against ``jax.grad`` of
    the JAX package's, teacher-forced to the quantization of the forward
    inside that very gradient program (a separately compiled forward may
    round one value the other way, and this gradient moves by several
    percent for one flipped level). JAX runs op by op: XLA's fusions may
    keep f32 where the backward rounds to bf16.

    ``float32``: conv_prequant's straight-through convs in f32 on both
    sides, which isolates the algorithm: within 1e-5 * max|ref|.
    ``bfloat16``, as shipped: the two frameworks round the bf16 backward at
    other points (its f32 and bf16 versions differ by 0.6 % relative L2
    in either), so the bound is bf16's: 2e-2 * max|ref|, relative L2 1e-2.
    """
    jm, params, tm = encoder_pair(CLASSIFIER, "attention", seed=6)
    tm = _int8(tm).requires_grad_(False)
    rs = np.random.RandomState(7)
    x = rs.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t, y = np.array([40, 900], np.int32), np.array([3, 999], np.int32)

    def selected_logp(xx):  # JGd.classifier_cond_fn's, with the intermediates
        logits, inter = jm.apply({"params": params}, xx, jnp.asarray(t), capture_intermediates=True,
                                 mutable=["intermediates"])
        logp = jnp.take_along_axis(jax.nn.log_softmax(logits, axis=-1), jnp.asarray(y)[:, None], axis=-1)
        return logp.sum(), inter["intermediates"]

    if ste == "float32":
        monkeypatch.setattr(TQ, "_STE_DTYPE", torch.float32)
        JQ.conv_prequant.defvjp(JQ._conv_prequant_fwd, _conv_prequant_bwd_f32)
    try:
        with jax_int8(), jax.disable_jit():
            ref, inter = jax.grad(selected_logp, has_aux=True)(jnp.asarray(x))
    finally:
        JQ.conv_prequant.defvjp(JQ._conv_prequant_fwd, JQ._conv_prequant_bwd)
    ref = np.asarray(ref) * 2.5
    with torch.no_grad(), jax_quantization(tm, inter):
        grad = nhwc(TGd.classifier_cond_fn(tm, 2.5)(nchw(x), torch.from_numpy(t), y=torch.from_numpy(y)))
    assert np.abs(ref).max() > 0
    if ste == "float32":
        _close(grad, ref, 1e-5)
    else:
        _close(grad, ref, 2e-2)
        assert np.linalg.norm(grad - ref) <= 1e-2 * np.linalg.norm(ref)


def test_int8_guided_ancestral_chain_matches_with_jax_noise():
    """3 guided ancestral steps, generator and classifier both int8: from
    JAX's state each step, with the noise JAX draws, teacher-forced
    (``jax_quantization``, the quantization of JAX's own forwards at that
    state), within 1e-3 * max(1, |ref|) of JAX's next state.

    Forced, because the early steps multiply a model-output difference by
    1/sqrt(alpha_bar) (~150 at t = 999) before clipping x_0: one rounding
    flip in a free-running int8 forward moves the step's output by
    several percent."""
    jm, params, tm = upstream_pair(UPSTREAM, seed=1)
    jc, cparams, tc = encoder_pair(CLASSIFIER, "attention", seed=2)
    tm, tc = _int8(tm), _int8(tc).requires_grad_(False)
    x = np.random.RandomState(3).standard_normal((2, 16, 16, 3)).astype(np.float32)
    y = np.array([5, 871], np.int32)
    js = JSch.build_schedule(steps=1000, timestep_respacing="3")
    ts = TSch.build_schedule(steps=1000, timestep_respacing="3")
    with jax_int8():
        jcond = JGd.classifier_cond_fn(lambda xx, tt: jc.apply({"params": cparams}, xx, tt), 2.0)
        jmodel = JGd.model_fn_dropping_y(lambda xx, tt, **kw: jm.apply({"params": params}, xx, tt, **kw), True)
        jstep = lambda xx, tt, k: JS.p_sample_step(
            js, jmodel, xx, tt, k, cfg=JS.SamplerConfig(), cond_fn=jcond, model_kwargs={"y": jnp.asarray(y)})[0]
    for i, key in enumerate(jax.random.split(jax.random.key(11), 3)):
        t = np.full((2,), 2 - i, np.int32)
        # op by op, so that the forwards inside the step round as the
        # captured ones
        with jax_int8(), jax.disable_jit():
            ref = np.asarray(jstep(jnp.asarray(x), jnp.asarray(t), key))
            t_model = np.asarray(js.model_timesteps(jnp.asarray(t)))
            _, inter_m = _jax_int8_apply(jm, params, x, t_model, y=y)
            _, inter_c = _jax_int8_apply(jc, cparams, x, t_model)
        noise = nchw(np.array(JS._normal(key, x.shape, jnp.float32)))
        with torch.no_grad(), jax_quantization(tm, inter_m), jax_quantization(tc, inter_c):
            out, _ = TS.p_sample_step(
                ts, TGd.model_fn_dropping_y(tm, True), nchw(x), torch.from_numpy(t).long(), None,
                cfg=TS.SamplerConfig(), noise=noise, cond_fn=TGd.classifier_cond_fn(tc, 2.0),
                model_kwargs={"y": torch.from_numpy(y).long()},
            )
        _close_but_flips(nhwc(out), ref, 1e-3, max(1.0, np.abs(ref).max()))
        x = ref


def test_s8_and_float_emissions_give_identical_outputs():
    """The UNet under no_grad (s8 q) and with x requiring grad (integer
    values in x's dtype, through the autograd Functions): the same bits."""
    _, _, tm = upstream_pair(UPSTREAM, seed=8)
    m = _int8(tm)
    rs = np.random.RandomState(9)
    x, t, y = nchw(rs.standard_normal((2, 16, 16, 3)).astype(np.float32)), torch.tensor([3, 250]), torch.tensor([1, 2])
    with torch.no_grad():
        s8 = m(x, t, y=y)
    xg = x.clone().requires_grad_(True)
    h = torch.randn(2, 64, 16, 16).contiguous(memory_format=torch.channels_last)
    with torch.enable_grad():
        flt = m(xg, t, y=y)
        q, _ = m.input_blocks[1][0].in_layers[0](h.clone().requires_grad_(True), activation="silu", quantize=True)
    with torch.no_grad():
        q8, _ = m.input_blocks[1][0].in_layers[0](h, activation="silu", quantize=True)
    assert q.dtype == torch.float32 and q.requires_grad and q8.dtype == torch.int8
    torch.testing.assert_close(q.detach(), q8.float(), rtol=0, atol=0)
    assert flt.requires_grad
    torch.testing.assert_close(flt.detach(), s8, rtol=0, atol=0)


def test_flax_int8_params_load_strict():
    """The JAX model's parameter tree under int8 (its ``_QuantConvCore``s in
    place of ``nn.Conv``): converted, it loads into the int8 port with
    strict=True, and the weights land where they belong."""
    cfg = dict(UPSTREAM, variant="unet", label_emb_type="embedding")
    jm = JaxUNet(JaxConfig(**cfg))
    with jax_int8():
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.key(0), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32),
            y=jnp.zeros((1,), jnp.int32)))["params"]
    params = random_params(shapes, 3)
    m = UNetModel(UNetConfig(**cfg), conv_impl="int8")
    m.load_state_dict(state_dict_from_flax(params), strict=True)
    np.testing.assert_array_equal(m.input_blocks[0][0].weight.permute(2, 3, 1, 0).detach().numpy(),
                                  params["input_blocks_0_0"]["conv"]["kernel"])


def test_conv_impl_is_checked():
    with pytest.raises(ValueError, match="conv_impl"):
        UNetModel(UNetConfig(**dict(UPSTREAM, variant="unet")), conv_impl="int4")


# --- the tensor-core K5's tile picker, the packed-weight cache, the quantizer's edges ----------


def _conv_calls(model, image_size):
    """(H_in, C, K, ks, stride) of every Conv2d call of one forward of a
    UNetModel or EncoderUNetModel, from its modules: a ResBlock's convs all
    run at its output resolution (it resamples before its first conv), a
    Downsample's conv reads the resolution it halves, an Upsample's the one it
    has doubled."""
    from guided_diffusion_clip_tpu_torch.models.unet import Downsample, ResBlock, Upsample

    calls = []

    def conv(m, res):
        calls.append((res, m.in_channels, m.out_channels, m.kernel_size[0], m.stride[0]))

    def walk(mod, res):
        if isinstance(mod, Conv2d):
            conv(mod, res)
        elif isinstance(mod, ResBlock):
            res = res // 2 if mod.down else res * 2 if mod.up else res
            for m in mod.modules():
                if isinstance(m, Conv2d):
                    conv(m, res)
        elif isinstance(mod, Downsample):
            for m in mod.modules():
                if isinstance(m, Conv2d):
                    conv(m, res)
            res //= 2
        elif isinstance(mod, Upsample):
            res *= 2
            for m in mod.modules():
                if isinstance(m, Conv2d):
                    conv(m, res)
        else:
            for child in mod.children():
                res = walk(child, res)
        return res

    res = image_size
    for part in (model.input_blocks, model.middle_block, getattr(model, "output_blocks", None), model.out):
        if part is not None:
            res = walk(part, res)
    return calls


@pytest.mark.parametrize("which", ["upstream", "recipe128", "classifier"])
def test_conv_calls_walk_matches_a_forward(which):
    """The walk above against forward hooks on a small model: the same convs
    at the same input sizes, so it may stand in for a full-size forward."""
    if which == "classifier":
        tm = EncoderUNetModel(UNetConfig(**CLASSIFIER), pool="attention").eval()
    else:
        kw = UPSTREAM if which == "upstream" else dict(RECIPE128, num_classes=None)
        tm = UNetModel(UNetConfig(**dict(kw, num_classes=None))).eval()
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((args[0].shape[2], mod.in_channels, mod.out_channels, mod.kernel_size[0],
                                       mod.stride[0])))
        for m in tm.modules() if isinstance(m, Conv2d)]
    with torch.inference_mode():
        tm(torch.zeros(1, 3, 16, 16), torch.tensor([3]))
    for h in hooks:
        h.remove()
    assert len(seen) > 8 and sorted(seen) == sorted(_conv_calls(tm, 16))


def _full_size(which):
    """The ADM-G 256 UNet or its classifier at full width on the meta device
    (no memory, no arithmetic): only its modules are read."""
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_classifier, create_upstream_model

    with torch.device("meta"):
        if which == "classifier":
            return create_classifier(256, False, 128, 2, "32,16,8", True, True, "attention")
        return create_upstream_model(
            image_size=256, num_channels=256, num_res_blocks=2, learn_sigma=True, class_cond=True,
            attention_resolutions="32,16,8", num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True)


@pytest.mark.parametrize("batch", [1, 4, 8])
@pytest.mark.parametrize("which", ["unet", "classifier"])
def test_pick_tile_on_every_conv_of_the_full_models(which, batch):
    """Every distinct conv shape of an ADM-256 forward (106 convs) and of its
    classifier (41): the stems and the head go to the thin kernels; for the
    others the tile grid covers the M pixels once, the launch fills the card
    (99 blocks, or a block per SM once it splits) wherever 64-row tiles and
    slices of 32 stages allow it, splits are used only where unsplit tiles do
    not fill the card, and the slices cut the reduction into whole 32-byte
    steps, each byte once, none empty and none shorter than 32 stages."""
    calls = _conv_calls(_full_size(which), 256)
    assert len(calls) == (106 if which == "unet" else 41)
    off = [c for c in calls if not TQ.uses_tensor_cores(c[1], c[2], c[3])]
    assert sorted((c[1], c[2]) for c in off) == ([(3, 256), (256, 6)] if which == "unet" else [(3, 128)])
    shapes = sorted(set(calls) - set(off))
    assert len(shapes) >= 10
    for H, C, K, ks, stride in shapes:
        p = (ks - 1) // 2
        Ho = (H + 2 * p - ks) // stride + 1
        M, KRp = batch * Ho * Ho, -(-ks * ks * C // 32) * 32
        bm, split = TQ.pick_tile(M, K, KRp)
        assert bm in (64, 128) and split >= 1
        m_tiles, n_tiles, stages = -(-M // bm), -(-K // 128), -(-KRp // 64)
        assert (m_tiles - 1) * bm < M <= m_tiles * bm
        blocks = m_tiles * n_tiles * split
        small = -(-M // 64) * n_tiles  # blocks of 64-row tiles, unsplit
        if small >= 99:
            assert split == 1 and blocks >= 99
        elif small * (stages // 32) >= 132:
            assert blocks >= 132, (H, C, K, ks, batch, bm, split)
        if split > 1:
            assert bm == 64 and stages // split >= 32
        ranges = TQ.split_ranges(KRp, split)
        assert len(ranges) == split and ranges[0][0] == 0 and ranges[-1][1] == KRp
        for (b0, e0), nxt in zip(ranges, ranges[1:] + [(KRp, KRp)]):
            assert b0 < e0 == nxt[0] and b0 % 64 == 0 and (e0 - b0) % 32 == 0


@pytest.mark.parametrize("M,K,KRp,want", [
    (8 * 256 * 256, 256, 2304, (128, 1)),   # the headline conv: 8192 tiles
    (8 * 16 * 16, 1024, 9216, (128, 1)),    # 128 tiles of 128 rows: enough
    (8 * 16 * 16, 512, 9216, (64, 1)),      # 64 tiles of 128 rows, 128 of 64
    (8 * 8 * 8, 1024, 18432, (64, 3)),      # 64 tiles of 64 rows: three slices of 96 stages
    (3 * 8 * 8, 1024, 18432, (64, 6)),      # an odd M: 3 row tiles, the last half empty
    (8 * 8 * 8, 1024, 2048, (64, 1)),       # a 1x1: 32 stages are one slice
    (64, 1024, 18432, (64, 9)),             # batch 1 at 8 px: slices of 32 stages, no shorter
    (16, 128, 1152, (64, 1)),               # 18 stages: too short to split
])
def test_pick_tile_cases(M, K, KRp, want):
    assert TQ.pick_tile(M, K, KRp) == want


def test_uses_tensor_cores():
    assert TQ.uses_tensor_cores(256, 256, 3) and TQ.uses_tensor_cores(768, 256, 1) and TQ.uses_tensor_cores(16, 32, 5)
    assert not TQ.uses_tensor_cores(3, 256, 3)      # the stem: a 16-byte copy would span taps
    assert not TQ.uses_tensor_cores(256, 6, 3)      # the head: a 128-channel tile for 6 channels
    assert not TQ.uses_tensor_cores(40, 64, 3) and not TQ.uses_tensor_cores(32, 64, 7)


def test_uses_thin_kernel():
    assert TQ.uses_thin_kernel(3, 256, 3, 1) == "stem" and TQ.uses_thin_kernel(6, 64, 3, 1) == "stem"
    assert TQ.uses_thin_kernel(40, 8, 1, 1) == "stem"   # a pixel's 40 bytes: two 32-byte steps
    assert TQ.uses_thin_kernel(256, 6, 3, 1) == "head" and TQ.uses_thin_kernel(192, 3, 1, 1) == "head"
    assert TQ.uses_thin_kernel(16, 8, 3, 1) == "head"   # 144 bytes a pixel: too many for the stem
    assert TQ.uses_thin_kernel(3, 256, 3, 2) is None and TQ.uses_thin_kernel(256, 6, 3, 2) is None  # stride 2
    assert TQ.uses_thin_kernel(256, 256, 3, 1) is None  # the tensor-core kernel's
    assert TQ.uses_thin_kernel(3, 6, 3, 1) is None      # no whole 8-channel tile, and no 16-byte copy
    assert TQ.uses_thin_kernel(40, 64, 3, 1) is None and TQ.uses_thin_kernel(256, 6, 5, 1) is None


def _path_models(which):
    """The full-width models whose convs the int8 paths run, on the meta
    device: ADM-G 256's UNet and classifier, the CLIP UNet at ADM-256's
    widths, the training recipe (configs/config.yaml), its SR-delta model and
    the SR model that ``super_res_sample`` runs, and the quality tools'
    proxies (the generators with and without ``clip_feat`` and the
    classifiers, at every size the tools build)."""
    import os

    from guided_diffusion_clip_tpu_torch import image_train, super_res_sample
    from guided_diffusion_clip_tpu_torch.tools import _proxies as P
    from guided_diffusion_clip_tpu_torch.utils.script_util import (
        args_to_dict, create_model, create_model_and_diffusion, model_and_diffusion_defaults, parse_yaml,
        sr_create_model_and_diffusion, sr_model_and_diffusion_defaults, upstream_super_res,
    )

    if which in ("unet", "classifier"):
        return [_full_size(which)]
    with torch.device("meta"):
        if which == "clip":
            return [create_model(256, 256, 2, learn_sigma=True, class_cond=True, attention_resolutions="32,16,8",
                                 num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True,
                                 conv_impl="int8")]
        if which in ("recipe", "recipe_sr"):
            cfg = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "config.yaml")
            args = parse_yaml(image_train.create_argparser().parse_args(["--config-file", cfg]))
            if which == "recipe":
                return [create_model_and_diffusion(**args_to_dict(args, model_and_diffusion_defaults().keys()),
                                                   conv_impl="int8")[0]]
            kw = {k: getattr(args, k, v) for k, v in sr_model_and_diffusion_defaults().items()}
            return [sr_create_model_and_diffusion(**dict(kw, large_size=args.image_size), conv_impl="int8")[0]]
        if which == "super_res":
            args = super_res_sample.create_argparser().parse_args([
                "--large_size", "128", "--small_size", "64", "--num_channels", "64", "--num_res_blocks", "2",
                "--num_heads", "1", "--learn_sigma", "True", "--conv_impl", "int8"])
            model = sr_create_model_and_diffusion(**args_to_dict(args, sr_model_and_diffusion_defaults().keys()),
                                                  conv_impl=args.conv_impl)[0]
            return [upstream_super_res(model, args.class_cond)]
        return [m for size in (8, 16, 32, 64, 128) for m in (
            P.build_generator(P.generator_config(size), conv_impl="int8", device="meta"),
            P.build_generator(P.generator_config(size, True), conv_impl="int8", device="meta"),
            P.build_classifier(size, conv_impl="int8", device="meta"))]


@pytest.mark.parametrize("which", ["unet", "classifier", "clip", "recipe", "recipe_sr", "super_res", "proxies"])
def test_every_conv_of_the_models_runs_a_tensor_core_kernel(which):
    """Every conv of the models the int8 paths run goes to exactly one of
    ``conv_s8_mma.cu`` (``uses_tensor_cores``) and ``conv_s8_thin.cu``
    (``uses_thin_kernel``), none to ``__dp4a``; the thin ones are the stems
    (3 or 6 channels in) and the heads (3 or 6 out), which is how the smoke
    counts them from the modules (``chip_smoke.thin_convs``)."""
    convs = [m for root in _path_models(which) for m in root.modules() if isinstance(m, Conv2d)]
    thin = []
    for m in convs:
        C, K, ks, stride = m.in_channels, m.out_channels, m.kernel_size[0], m.stride[0]
        kind = TQ.uses_thin_kernel(C, K, ks, stride)
        assert TQ.uses_tensor_cores(C, K, ks) != (kind is not None), (C, K, ks, stride)
        if kind is not None:
            thin.append((kind, C, K))
    assert len(convs) > 10 and thin
    assert all((kind == "stem") == (C in (3, 6)) and (kind == "head") == (K in (3, 6)) for kind, C, K in thin), thin
    assert len(thin) == sum(m.in_channels in (3, 6) or m.out_channels in (3, 6) for m in convs)


@pytest.mark.parametrize("C,H,W", [(3, 7, 9), (6, 9, 5), (3, 5, 1), (6, 1, 7)])
def test_stem_taps_as_an_im2col_give_conv_s8_plain(C, H, W):
    """The stem kernel's table (``stem_taps``) read as the kernel reads it,
    an im2col of the NHWC bytes with _pack_weights' rows, gives the exact
    sums of ``conv_s8_plain`` on integer inputs: every tap and channel in
    the rows' order, zero padding at every edge, the padding bytes zero."""
    rng = np.random.default_rng(100 * C + 10 * H + W)
    B, K, ks = 2, 16, 3
    pad = (ks - 1) // 2
    q = torch.from_numpy(rng.integers(-127, 128, (B, H, W, C)).astype(np.int8))
    w_q = torch.from_numpy(rng.integers(-127, 128, (ks, ks, C, K)).astype(np.int8))
    rows = TQ._pack_weights(w_q).long()
    taps = TQ.stem_taps(C, ks, W)
    assert len(taps) == rows.shape[1] == -(-ks * ks * C // 32) * 32
    flat = q.reshape(B, -1).long()
    cols = torch.zeros(B, H, W, len(taps), dtype=torch.long)
    for j, e in enumerate(taps):
        off, ky, kx = e >> 8, (e >> 4) & 15, e & 15
        for oy in range(H):
            for ox in range(W):
                if 0 <= oy - pad + ky < H and 0 <= ox - pad + kx < W:
                    cols[:, oy, ox, j] = flat[:, ((oy - pad) * W + ox) * C + off]
    ref = TQ.conv_s8_plain(q, w_q, None, torch.ones(K), None, 1, torch.float32)
    assert torch.equal((cols @ rows.T).float(), ref)


@pytest.mark.parametrize("cin,cout,k", [(32, 8, 3), (3, 8, 3), (48, 24, 1)])
def test_packed_weight_cache(cin, cout, k):
    """``Conv2d.packed_weight`` is ``_pack_weights`` of the cached ``w_q``,
    cached with it, and follows ``load_state_dict`` and ``.to()``."""
    torch.manual_seed(cin + cout)
    conv = Conv2d(cin, cout, k, padding=(k - 1) // 2)
    rows = conv.packed_weight()
    w_q, _ = conv.quantized_weight()
    assert conv.packed_weight() is rows  # cached
    assert rows.dtype == torch.int8 and rows.is_contiguous()
    assert tuple(rows.shape) == (cout, -(-k * k * cin // 32) * 32)
    assert torch.equal(rows, TQ._pack_weights(w_q))
    assert torch.equal(rows[:, :k * k * cin], w_q.permute(3, 0, 1, 2).reshape(cout, -1))
    if k * k * cin % 32 == 0:
        assert rows.data_ptr() == w_q.data_ptr()  # a view of the OHWI memory, no copy
    conv.load_state_dict({"weight": conv.weight.detach().flip(0) * 3, "bias": conv.bias.detach()})
    rows2 = conv.packed_weight()
    assert rows2 is not rows and torch.equal(rows2, TQ._pack_weights(conv.quantized_weight()[0]))
    assert torch.equal(rows2, rows.flip(0))  # the same levels, channels reversed
    conv.to(torch.float64)
    rows3 = conv.packed_weight()
    assert rows3 is not rows2 and torch.equal(rows3, rows2)


def test_conv2d_int8_paths_take_the_cached_rows(monkeypatch):
    """Both int8 routes of ``Conv2d.forward`` hand K5's wrapper the cached
    rows (on the CPU the plain version ignores them)."""
    from guided_diffusion_clip_tpu_torch.models import nn as TNN

    conv = Conv2d(32, 8, 3, padding=1)
    conv.int8 = True
    seen = []
    for name in ("int8_conv", "conv_prequant"):
        real = getattr(TNN, name)
        monkeypatch.setattr(TNN, name, lambda *a, _real=real, **kw: (seen.append(kw["rows"]), _real(*a, **kw))[1])
    x = torch.randn(1, 32, 4, 4).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        conv(x)
        conv(torch.zeros(1, 32, 4, 4, dtype=torch.int8).contiguous(memory_format=torch.channels_last),
             prequant_scales=torch.ones(1))
    assert len(seen) == 2 and all(r is conv.packed_weight() for r in seen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_per_tensor_edges(dtype):
    """What the quantize kernels are held to on the card, here against the
    JAX quantizer: all zeros give the eps scale and q = 0; the largest value
    maps to +-127 and nothing passes it; ties round to even; a size that is no
    multiple of 16."""
    zeros = torch.zeros(3, 5, 7, dtype=dtype)
    q, s = TQ.quantize_per_tensor(zeros)
    assert q.dtype == torch.int8 and not q.any() and s.dtype == torch.float32
    assert s.item() == np.float32(1e-8) / np.float32(127)
    # amax = 127 makes the scale exactly 1: x / s is x, and .5 ties go to the even level
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0, -127.0, 3.0, 0.25], dtype=dtype)
    q, s = TQ.quantize_per_tensor(x)
    assert s.item() == 1.0 and q.tolist() == [0, 2, 2, 0, -2, -2, 126, 127, -127, 3, 0]
    # one huge value: everything else rounds to 0, nothing overflows
    rs = np.random.RandomState(0)
    big = torch.from_numpy(rs.standard_normal(37).astype(np.float32)).to(dtype)
    big[5] = -3e30
    q, s = TQ.quantize_per_tensor(big)
    assert q[5] == -127 and q.abs().sum() == 127 and torch.isfinite(s)
    for t in (zeros, x, big):
        rq, rs_ = JQ.quantize_per_tensor(jnp.asarray(t.float().numpy()).astype(jnp.float32 if dtype == torch.float32
                                                                                  else jnp.bfloat16))
        tq, ts = TQ.quantize_per_tensor(t)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        np.testing.assert_allclose(ts.numpy(), np.asarray(rs_), rtol=1e-6)


def test_quantize_kernels_refuse_what_they_do_not_take():
    with pytest.raises(ValueError, match="CUDA tensor"):
        TQ.quantize_per_tensor_cuda(torch.zeros(4, 4))
