"""The port's EncoderUNetModel classifier and its guidance gradient against
the JAX package, same weights, f32 on the CPU.

Weights go JAX tree -> ``state_dict_from_flax(model="encoder", pool=...)`` ->
``load_state_dict(strict=True)``; the converted dict must equal the JAX
package's own ``export_to_torch`` key for key. Forward within
1e-4 * max(1, max|ref|) (1e-4 as tests/test_unet_parity.py; the random
spatial heads give logits of order 100, where f32 sums in another order
differ by ~1e-6 of that); the guidance gradient within 1e-4 * max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guided_diffusion_clip_tpu.diffusion.guidance import classifier_cond_fn as jax_cond_fn
from guided_diffusion_clip_tpu.utils.torch_import import export_to_torch
from guided_diffusion_clip_tpu_torch.diffusion.guidance import classifier_cond_fn
from guided_diffusion_clip_tpu_torch.models.unet import build_plan
from guided_diffusion_clip_tpu_torch.utils import script_util as SU
from guided_diffusion_clip_tpu_torch.utils.convert import state_dict_from_flax
from torch_port_utils import encoder_pair, nchw, nhwc

torch.set_num_threads(2)

POOLS = ["adaptive", "attention", "spatial", "spatial_v2"]
# the classifier's topology (ADM-G 256 classifier), shrunk: image 64, width 64,
# depth 1, attention at 32/16/8 px; every width a multiple of 64, so every
# head is 64 wide, and the attention pool takes 8 x 8 + 1 = 65 tokens
CLASSIFIER = dict(
    image_size=64, in_channels=3, model_channels=64, out_channels=1000, num_res_blocks=1,
    attention_resolutions=(2, 4, 8), channel_mult=(1, 2, 3, 4), num_head_channels=64,
    use_scale_shift_norm=True, resblock_updown=True,
)


def _inputs(seed=1, B=2):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((B, 64, 64, 3)).astype(np.float32)
    t = np.array([17, 733][:B], np.int32)
    return x, t


@pytest.mark.parametrize("pool", POOLS)
def test_forward_parity(pool):
    jm, params, tm = encoder_pair(CLASSIFIER, pool)
    x, t = _inputs()
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.inference_mode():
        out = tm(nchw(x), torch.from_numpy(t)).numpy()
    assert out.shape == ref.shape == (2, 1000)
    assert np.abs(ref).max() > 0.1  # random weights: real, non-zero logits
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("pool", POOLS)
def test_state_dict_matches_export_to_torch(pool):
    _, params, tm = encoder_pair(CLASSIFIER, pool)
    ours = state_dict_from_flax(params, model="encoder", pool=pool)
    theirs = export_to_torch(params, model="encoder", pool=pool)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k], err_msg=k)
    own = tm.state_dict()
    assert sorted(own) == sorted(ours)
    for k in own:
        assert tuple(own[k].shape) == tuple(ours[k].shape), k
    head = {
        "adaptive": ["out.0.weight", "out.3.weight"],
        "attention": ["out.0.weight", "out.2.positional_embedding", "out.2.qkv_proj.weight", "out.2.c_proj.bias"],
        "spatial": ["out.0.weight", "out.2.weight"],
        "spatial_v2": ["out.0.weight", "out.1.weight", "out.3.weight"],
    }[pool]
    for key in head:
        assert key in own, key
    if pool == "attention":
        assert tuple(own["out.2.positional_embedding"].shape) == (256, 65)
        assert tuple(own["out.2.qkv_proj.weight"].shape) == (768, 256, 1)


def test_guidance_gradient_matches_jax_grad():
    """classifier_cond_fn's dx (torch.autograd.grad, through the attention
    and GroupNorm backwards) against the JAX cond_fn (jax.grad)."""
    jm, params, tm = encoder_pair(CLASSIFIER, "attention", seed=3)
    tm.requires_grad_(False)
    x, t = _inputs(seed=4)
    y = np.array([3, 999], np.int32)
    jfn = jax_cond_fn(lambda xx, tt: jm.apply({"params": params}, xx, tt), 2.5)
    ref = np.asarray(jax.jit(lambda xx: jfn(xx, jnp.asarray(t), y=jnp.asarray(y)))(jnp.asarray(x)))
    with torch.no_grad():  # as in the sampling loop: cond_fn enables grad itself
        grad = classifier_cond_fn(tm, 2.5)(nchw(x), torch.from_numpy(t), y=torch.from_numpy(y))
    assert grad.shape == (2, 3, 64, 64) and np.abs(ref).max() > 0
    np.testing.assert_allclose(nhwc(grad), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_cond_fn_differentiates_x_only():
    """With requires_grad_(False) on the classifier, no parameter gradient
    is formed, and a classifier whose parameters need grad gives the same dx."""
    _, _, tm = encoder_pair(CLASSIFIER, "adaptive", seed=5)
    x, t = _inputs(seed=6, B=1)
    args = (nchw(x), torch.from_numpy(t))
    y = torch.tensor([7])
    with_params = classifier_cond_fn(tm)(*args, y=y)
    assert all(p.grad is None for p in tm.parameters())
    tm.requires_grad_(False)
    torch.testing.assert_close(classifier_cond_fn(tm)(*args, y=y), with_params, rtol=0, atol=0)
    with pytest.raises(ValueError, match="labels"):
        classifier_cond_fn(tm)(*args)


def test_create_classifier_at_adm_g_256():
    """The ADM-G 256 classifier: 7 attention blocks (T = 1024 with 4 heads,
    256 and 64 with 8), an attention pool over 65 tokens with 8 heads, and
    46 GroupNorms per forward; a bf16 torso with an f32 head and pool."""
    kw = dict(
        image_size=256, classifier_use_fp16=True, classifier_width=128, classifier_depth=2,
        classifier_attention_resolutions="32,16,8", classifier_use_scale_shift_norm=True,
        classifier_resblock_updown=True, classifier_pool="attention",
    )
    assert set(kw) == set(SU.classifier_defaults())
    with torch.device("meta"):
        m = SU.create_classifier(**kw)
    ib, mb, _, _ = build_plan(m.config)
    layers = [s for blk in ib + [mb] for s in blk]
    heads = [s["heads"] for s in layers if s["kind"] == "attn"]
    assert heads == [4, 4, 8, 8, 8, 8, 8]
    n_res = sum(s["kind"] == "res" for s in layers)
    assert 2 * n_res + len(heads) + 1 == 46
    assert m.out[2].num_heads == 8 and tuple(m.out[2].positional_embedding.shape) == (512, 65)
    assert m.input_blocks[1][0].in_layers[2].weight.dtype == torch.bfloat16
    assert m.out[2].qkv_proj.weight.dtype == torch.float32
    assert m.out[0].weight.dtype == torch.float32
    assert set(SU.classifier_and_diffusion_defaults()) >= set(SU.diffusion_defaults())


def test_upstream_model_has_a_class_table():
    with torch.device("meta"):
        m = SU.create_upstream_model(
            image_size=64, num_channels=64, num_res_blocks=1, learn_sigma=True, class_cond=True,
            attention_resolutions="16,8", num_head_channels=64, use_fp16=True,
        )
    assert m.config.variant == "unet" and m.config.num_classes == 1000
    assert tuple(m.label_emb.weight.shape) == (1000, 256)
    assert m.out[2].weight.shape[0] == 6
