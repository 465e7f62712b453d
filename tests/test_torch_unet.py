"""The PyTorch port's UNet against the JAX UNet, same weights, f32 on the CPU.

Weights go JAX tree -> ``state_dict_from_flax`` -> ``load_state_dict(strict=
True)``; the converted dict must equal the JAX package's own
``export_to_torch`` key for key. Tolerance 1e-4, as tests/test_unet_parity.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guided_diffusion_clip_tpu.utils.torch_import import export_to_torch
from guided_diffusion_clip_tpu_torch.models.unet import UNetConfig, UNetModel, build_plan
from guided_diffusion_clip_tpu_torch.utils.convert import state_dict_from_flax
from torch_port_utils import clip_feat_pair, nchw, nhwc, upstream_pair

torch.set_num_threads(2)

# the slice's topology (ADM-256 serving model), shrunk: clip_feat, scale-shift,
# resblock up/down, 64-channel heads at three attention levels, learned sigma
SLICE = dict(
    image_size=16, in_channels=3, model_channels=64, out_channels=6, num_res_blocks=1,
    attention_resolutions=(2, 4, 8), channel_mult=(1, 1, 2, 2), num_classes=512,
    num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True,
)
# the fork's 128 px training recipe, shrunk: stride-2 conv Downsample, conv
# Upsample, one head per attention block
RECIPE128 = dict(
    image_size=16, in_channels=3, model_channels=32, out_channels=6, num_res_blocks=1,
    attention_resolutions=(2, 4), channel_mult=(1, 2, 3), num_classes=512,
    num_heads=1, use_scale_shift_norm=True, resblock_updown=False,
)


@pytest.mark.parametrize("kw", [SLICE, RECIPE128], ids=["slice", "recipe128"])
def test_forward_parity(kw):
    jm, params, tm = clip_feat_pair(kw)
    rs = np.random.RandomState(1)
    x = rs.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([17, 733], np.int32)
    feat = rs.standard_normal((2, 512)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t), clip_feat=jnp.asarray(feat)))
    with torch.inference_mode():
        out = nhwc(tm(nchw(x), torch.from_numpy(t), clip_feat=torch.from_numpy(feat)))
    assert out.shape == ref.shape
    assert np.abs(ref).max() > 0.1  # random weights: a real, non-zero output
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", [SLICE, RECIPE128], ids=["slice", "recipe128"])
def test_state_dict_matches_export_to_torch(kw):
    _, params, tm = clip_feat_pair(kw)
    ours = state_dict_from_flax(params)
    theirs = export_to_torch(params)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k], err_msg=k)
    # the module tree carries exactly the reference key set and shapes
    own = tm.state_dict()
    assert sorted(own) == sorted(ours)
    for k in own:
        assert tuple(own[k].shape) == tuple(ours[k].shape), k
    for key in ("input_blocks.3.0.in_layers.0.weight", "time_embed.0.weight", "label_emb.2.weight", "out.2.weight"):
        assert key in own


def test_unconditional_unet_ignores_y():
    """An unconditional ``variant="unet"`` model takes ``y`` and ignores it, as
    the JAX model does: the output with and without ``y`` is the same, and the
    JAX model's within 1e-4."""
    kw = dict(SLICE, num_classes=None)
    jm, params, tm = upstream_pair(kw, seed=3)
    rs = np.random.RandomState(2)
    x = rs.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([5, 900], np.int32)
    y = np.array([1, 7], np.int32)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t), y=jnp.asarray(y)))
    with torch.inference_mode():
        with_y = tm(nchw(x), torch.from_numpy(t), y=torch.from_numpy(y).long())
        without = tm(nchw(x), torch.from_numpy(t))
    assert torch.equal(with_y, without)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(nhwc(with_y), ref, rtol=1e-4, atol=1e-4)
    # a conditional variant without a class table still refuses it
    cm = UNetModel(UNetConfig(**dict(kw, variant="clip_feat"))).eval()
    with pytest.raises(ValueError, match="unconditional"):
        cm(nchw(x), torch.from_numpy(t), y=torch.from_numpy(y).long())


def test_bf16_torso_split():
    """use_fp16: conv/conv1d weights of the torso are bf16; GroupNorm, emb
    projections, embedding MLPs and the head stay f32; a f32 checkpoint loads
    (cast on copy) and the output is f32."""
    tm = UNetModel(UNetConfig(**dict(SLICE, num_classes=None)), dtype=torch.bfloat16).eval()
    sd = tm.state_dict()
    assert sd["input_blocks.1.0.in_layers.2.weight"].dtype == torch.bfloat16
    assert sd["input_blocks.3.1.qkv.weight"].dtype == torch.bfloat16
    assert sd["input_blocks.1.0.in_layers.0.weight"].dtype == torch.float32
    assert sd["input_blocks.1.0.emb_layers.1.weight"].dtype == torch.float32
    assert sd["time_embed.0.weight"].dtype == torch.float32
    assert sd["out.2.weight"].dtype == torch.float32
    tm.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True)
    with torch.inference_mode():
        out = tm(torch.randn(1, 3, 16, 16), torch.tensor([5]))
    assert out.dtype == torch.float32 and out.shape == (1, 6, 16, 16)


def test_plan_counts_at_adm256():
    """The serving model has 16 attention blocks and 101 GroupNorms per forward."""
    cfg = UNetConfig(
        image_size=256, in_channels=3, model_channels=256, out_channels=6, num_res_blocks=2,
        attention_resolutions=(8, 16, 32), channel_mult=(1, 1, 2, 2, 4, 4), num_classes=512,
        num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True,
    )
    ib, mb, ob, _ = build_plan(cfg)
    layers = [s for blk in ib + [mb] + ob for s in blk]
    n_attn = sum(s["kind"] == "attn" for s in layers)
    n_res = sum(s["kind"] == "res" for s in layers)
    assert (n_attn, n_res) == (16, 42)
    assert 2 * n_res + n_attn + 1 == 101


def test_forward_ignores_pair_and_sr_inputs():
    """The data loader's CLIP batches carry ``img2`` and ``clip_feat2``; the SR
    variants take ``low_res``. The CLIP UNet accepts and ignores all three, as
    the JAX model does: the output equals the call without them, and the JAX
    model's called the same way within 1e-4."""
    jm, params, tm = clip_feat_pair(RECIPE128, seed=4)
    rs = np.random.RandomState(5)
    x, img2, low_res = (rs.standard_normal(s).astype(np.float32) for s in ((2, 16, 16, 3), (2, 16, 16, 3), (2, 8, 8, 3)))
    t = np.array([3, 600], np.int32)
    feat, feat2 = (rs.standard_normal((2, 512)).astype(np.float32) for _ in range(2))
    extra = dict(img2=img2, clip_feat2=feat2, low_res=low_res)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t), clip_feat=jnp.asarray(feat),
                                       **{k: jnp.asarray(v) for k, v in extra.items()}))
    with torch.inference_mode():
        plain = tm(nchw(x), torch.from_numpy(t), clip_feat=torch.from_numpy(feat))
        out = tm(nchw(x), torch.from_numpy(t), clip_feat=torch.from_numpy(feat),
                 img2=nchw(img2), clip_feat2=torch.from_numpy(feat2), low_res=nchw(low_res))
    assert torch.equal(out, plain)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(nhwc(out), ref, rtol=1e-4, atol=1e-4)


def test_f32_params_under_bf16_torso():
    """The trainer's precision: every parameter f32 (``model.float()``) while
    the torso computes in bf16. A torso conv casts its weight at the call, so
    the forward equals the sampling model's, whose torso weights were cast in
    place, bit for bit, and every gradient is f32."""
    cfg = UNetConfig(**dict(RECIPE128, variant="clip_feat", label_emb_type="mlp"))
    sampling = UNetModel(cfg, dtype=torch.bfloat16).eval()
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():  # every weight random: the zero-init output layers would give 0
        for p in sampling.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=g))
    training = UNetModel(cfg, dtype=torch.bfloat16).float().eval()
    training.load_state_dict(sampling.state_dict(), strict=True)
    assert {p.dtype for p in training.parameters()} == {torch.float32}
    assert sampling.state_dict()["input_blocks.1.0.in_layers.2.weight"].dtype == torch.bfloat16
    x, t, feat = torch.randn(2, 3, 16, 16, generator=g), torch.tensor([4, 700]), torch.randn(2, 512, generator=g)
    with torch.no_grad():
        want = sampling(x, t, clip_feat=feat)
    out = training(x, t, clip_feat=feat)
    assert torch.equal(out.detach(), want) and want.abs().max() > 0
    out.square().mean().backward()
    grads = {n: p.grad for n, p in training.named_parameters()}
    assert all(g is not None and g.dtype == torch.float32 for g in grads.values())
    assert grads["input_blocks.1.0.in_layers.2.weight"].abs().max() > 0


def test_dropout_runs_in_train_mode():
    """Dropout (the ResBlocks' ``out_layers.2``) is active under ``model.train()``
    and off under ``eval()``, as JAX's ``train=True``."""
    model = UNetModel(UNetConfig(**dict(RECIPE128, variant="clip_feat", label_emb_type="mlp", dropout=0.5)))
    g = torch.Generator().manual_seed(7)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1, generator=g)
    x, t, feat = torch.randn(1, 3, 16, 16, generator=g), torch.tensor([9]), torch.randn(1, 512, generator=g)
    with torch.no_grad():
        model.eval()
        assert torch.equal(model(x, t, clip_feat=feat), model(x, t, clip_feat=feat))
        model.train()
        assert not torch.equal(model(x, t, clip_feat=feat), model(x, t, clip_feat=feat))
