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
from torch_port_utils import clip_feat_pair, nchw, nhwc

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
