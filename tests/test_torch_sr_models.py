"""The port's SR model family (``models/clip_models.py``: SRImageModel_Feat and
its warm start, SuperResModel, SpatFeatureModel; the ``sr_img_feat``,
``super_res`` and ``spat_feat`` variants and ``label_emb_type="mlp_zero"`` of
``models/unet.py``) against the JAX package's, f32 on the CPU.

The same random weights (every leaf, ``bias_feat`` included) reach both
frameworks through ``state_dict_from_flax`` with ``strict=True``. Forwards
within 1e-4 (``super_res``: atol 2e-4, as tests/test_fork_models.py holds the
JAX model to the reference); ``bilinear_resize`` within 1e-6 of
``jax.image.resize``; the warm start as tests/test_fork_models.py's
``TestWarmStartSurgery`` (the widened model's forward with a zero img2 equals
the plain model's within 1e-5); the int8 SR-delta forward teacher-forced, as
tests/test_torch_quant.py holds the CLIP UNet.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guided_diffusion_clip_tpu.models import clip_models as JCM
from guided_diffusion_clip_tpu.models.nn import bilinear_resize as jax_bilinear_resize
from guided_diffusion_clip_tpu.models.unet import UNetConfig as JaxConfig
from guided_diffusion_clip_tpu.utils import script_util as JSU
from guided_diffusion_clip_tpu.utils.torch_import import export_to_torch
from guided_diffusion_clip_tpu_torch.models import clip_models as TCM
from guided_diffusion_clip_tpu_torch.models.nn import bilinear_resize
from guided_diffusion_clip_tpu_torch.models.unet import UNetConfig, UNetModel
from guided_diffusion_clip_tpu_torch.utils import script_util as TSU
from guided_diffusion_clip_tpu_torch.utils.checkpoint import load_state_dict
from guided_diffusion_clip_tpu_torch.utils.convert import flax_path_to_torch_key, state_dict_from_flax
from test_torch_quant import _close_but_flips, _int8, _jax_int8_apply, jax_quantization
from torch_port_utils import nchw, nhwc, random_params

torch.set_num_threads(2)

# the fork's recipe, shrunk: CLIP conditioning, scale-shift, one head at 8 px
SR = dict(image_size=16, in_channels=6, model_channels=32, out_channels=6, num_res_blocks=1,
          attention_resolutions=(2,), channel_mult=(1, 2), num_classes=512, num_heads=1,
          use_scale_shift_norm=True)
# SpatFeatureModel is 128 px by construction (its planes); narrow and shallow
SPAT = dict(image_size=128, in_channels=5, model_channels=32, out_channels=3, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_heads=1)
VARIANTS = {  # name: (JAX factory, port factory, config, the conditioning's keys)
    "sr_img_feat": (JCM.SRImageModel_Feat, TCM.SRImageModel_Feat, SR, ("clip_feat", "clip_feat2", "img2")),
    "sr_img_feat_cont": (JCM.SRImageModel_Feat_cont, TCM.SRImageModel_Feat_cont, SR,
                         ("clip_feat", "clip_feat2", "img2")),
    "super_res": (JCM.SuperResModel, TCM.SuperResModel, dict(SR, num_classes=None), ("low_res",)),
    "super_res_class": (JCM.SuperResModel, TCM.SuperResModel, dict(SR, num_classes=10), ("low_res", "y")),
    "spat_feat": (JCM.SpatFeatureModel, TCM.SpatFeatureModel, SPAT, ("clip_feat",)),
}


def _inputs(name, batch=2, seed=0):
    """(x NHWC, t, {key: NHWC or flat numpy}) for a variant."""
    s = VARIANTS[name][2]["image_size"]
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((batch, s, s, 3)).astype(np.float32)
    t = np.array([17, 733][:batch], np.int32)
    make = {
        "clip_feat": lambda: (rs.standard_normal((batch, 512)) * 2).astype(np.float32),
        "clip_feat2": lambda: (rs.standard_normal((batch, 512)) * 2).astype(np.float32),
        "img2": lambda: rs.uniform(-1, 1, (batch, s, s, 3)).astype(np.float32),
        "low_res": lambda: rs.uniform(-1, 1, (batch, s // 2, s // 2, 3)).astype(np.float32),
        "y": lambda: rs.randint(0, 10, (batch,)).astype(np.int32),
    }
    return x, t, {k: make[k]() for k in VARIANTS[name][3]}


def _torch_kw(kw):
    return {k: nchw(v) if v.ndim == 4 else torch.from_numpy(v).long() if k == "y" else torch.from_numpy(v)
            for k, v in kw.items()}


@functools.lru_cache(maxsize=None)
def _pair(name, seed=0):
    """(jax model, numpy params, torch model with the same weights) of a variant."""
    jfac, tfac, kw, _ = VARIANTS[name]
    jm = jfac(JaxConfig(**kw))
    x, t, cond = _inputs(name, batch=1)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(t),
                                            **{k: jnp.asarray(v) for k, v in cond.items()}))["params"]
    params = jax.device_get(random_params(shapes, seed))
    tm = tfac(UNetConfig(**kw)).eval()
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_matches_jax(name):
    jm, params, tm = _pair(name)
    x, t, cond = _inputs(name, seed=1)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                       **{k: jnp.asarray(v) for k, v in cond.items()}))
    with torch.no_grad():
        out = nhwc(tm(nchw(x), torch.from_numpy(t), **_torch_kw(cond)))
    assert np.abs(ref).max() > 0.1
    atol = 2e-4 if name.startswith("super_res") else 1e-4
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_state_dict_keys_match_export_to_torch(name):
    """The port's parameter names are the JAX package's ``export_to_torch``
    names (``bias_feat`` included), and a JAX tree loads ``strict=True``."""
    _, params, tm = _pair(name)
    assert set(tm.state_dict()) == set(export_to_torch(params))
    assert ("bias_feat" in tm.state_dict()) == name.startswith("sr_img_feat")


def test_convert_maps_bias_feat():
    assert flax_path_to_torch_key(("bias_feat",)) == "bias_feat"
    sd = state_dict_from_flax({"bias_feat": np.arange(4, dtype=np.float32)})
    assert torch.equal(sd["bias_feat"], torch.arange(4, dtype=torch.float32))


def test_missing_conditioning_raises():
    _, _, tm = _pair("sr_img_feat")
    x, t, cond = _inputs("sr_img_feat")
    kw = _torch_kw(cond)
    with pytest.raises(ValueError, match="requires clip_feat, clip_feat2 and img2"):
        tm(nchw(x), torch.from_numpy(t), clip_feat=kw["clip_feat"], img2=kw["img2"])
    with pytest.raises(ValueError, match="requires low_res"):
        _pair("super_res")[2](nchw(x), torch.from_numpy(t))
    with pytest.raises(ValueError, match="needs num_classes"):
        TCM.SRImageModel_Feat(UNetConfig(**dict(SR, num_classes=None)))(nchw(x), torch.from_numpy(t), **kw)
    with pytest.raises(ValueError, match="variant"):
        UNetModel(UNetConfig(**dict(SR, variant="nope")))


def test_mlp_zero_starts_at_zero():
    m = TCM.SRImageModel_Feat_cont(UNetConfig(**SR))
    assert m.config.label_emb_type == "mlp_zero"
    lin = [m.label_emb[0], m.label_emb[2]]
    assert all(torch.count_nonzero(p) == 0 for layer in lin for p in layer.parameters())
    plain = TCM.SRImageModel_Feat(UNetConfig(**SR))
    assert torch.count_nonzero(plain.label_emb[0].weight) > 0
    # bias_feat: N(0, 1) of shape (num_classes,)
    assert m.bias_feat.shape == (512,) and 0.8 < m.bias_feat.std().item() < 1.2


@pytest.mark.parametrize("int8", [False, True])
def test_bias_feat_stays_f32_under_a_bf16_torso(int8):
    m = TCM.SRImageModel_Feat(UNetConfig(**SR), dtype=torch.bfloat16, conv_impl="int8" if int8 else "auto")
    assert m.bias_feat.dtype == torch.float32 and m.bias_feat.dim() == 1
    assert m.label_emb[0].weight.dtype == torch.float32
    assert m.input_blocks[0][0].weight.dtype == (torch.float32 if int8 else torch.bfloat16)
    m.convert_torso(torch.bfloat16)
    m.to(memory_format=torch.channels_last)
    assert m.bias_feat.dtype == torch.float32
    x, t, cond = _inputs("sr_img_feat")
    with torch.no_grad():
        out = m.eval()(nchw(x), torch.from_numpy(t), **_torch_kw(cond))
    assert out.dtype == torch.float32 and out.shape == (2, 6, 16, 16) and torch.isfinite(out).all()


def test_sr_factory_matches_jax():
    """``sr_model_and_diffusion_defaults`` has the JAX package's keys and
    values; ``sr_create_model`` builds the JAX factory's configuration (6
    input channels, the channel mults by ``large_size``, 512 classes when
    ``class_cond``) and takes ``conv_impl``."""
    assert TSU.sr_model_and_diffusion_defaults() == JSU.sr_model_and_diffusion_defaults()
    for large, cond in ((128, True), (64, False), (256, True)):
        kw = dict(TSU.sr_model_and_diffusion_defaults(), large_size=large, class_cond=cond, num_channels=32,
                  num_res_blocks=1)
        with torch.device("meta"):
            tm, _ = TSU.sr_create_model_and_diffusion(**kw, conv_impl="int8")
        jm, _ = JSU.sr_create_model_and_diffusion(**kw)
        assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
        assert tm.config.variant == "sr_img_feat" and tm.config.in_channels == 6 and tm.int8
    with pytest.raises(ValueError, match="unsupported large size"):
        TSU.sr_channel_mult(96)


def test_upstream_super_res_redispatch():
    with torch.device("meta"):
        model, _ = TSU.sr_create_model_and_diffusion(**dict(TSU.sr_model_and_diffusion_defaults(),
                                                            num_channels=32, class_cond=True))
        up = TSU.upstream_super_res(model, class_cond=False)
        up_y = TSU.upstream_super_res(model, class_cond=True)
    assert (up.config.variant, up.config.num_classes, up.config.in_channels) == ("super_res", None, 6)
    assert (up_y.config.label_emb_type, up_y.config.num_classes) == ("embedding", 512)
    assert not hasattr(up, "bias_feat")


# --- bilinear_resize ------------------------------------------------------------------------------------


@pytest.mark.parametrize("size,new", [(16, 32), (64, 128), (5, 11), (8, 8)])
def test_bilinear_resize_matches_jax(size, new):
    """Half-pixel centres with the edge rows and columns included, within 1e-6."""
    x = np.random.RandomState(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    ref = np.asarray(jax_bilinear_resize(jnp.asarray(x), (new, new)))
    out = nhwc(bilinear_resize(nchw(x), (new, new)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[:, [0, -1]], ref[:, [0, -1]], rtol=0, atol=1e-6)
    assert bilinear_resize(nchw(x).to(torch.bfloat16), (new, new)).dtype == torch.bfloat16


def test_bilinear_resize_refuses_a_shrink():
    with pytest.raises(ValueError, match="upsamples only"):
        bilinear_resize(torch.zeros(1, 3, 16, 16), (8, 16))


# --- the warm start --------------------------------------------------------------------------------------


def test_widen_stem_kernel():
    k = torch.randn(8, 3, 3, 3)
    w = TCM.widen_stem_kernel(k, 6)
    assert w.shape == (8, 6, 3, 3) and torch.equal(w[:, :3], k) and not w[:, 3:].any()
    with pytest.raises(ValueError, match="cannot narrow"):
        TCM.widen_stem_kernel(k, 2)


def test_warm_start_from_a_plain_checkpoint(tmp_path):
    """A plain unconditional UNet's ``.pt`` into ``SRImageModel_Feat_cont``:
    the stem's first 3 input channels copied and the rest zero, the label MLP
    at its zero init, ``bias_feat`` at its random init; with a zero img2 the
    widened model's forward equals the plain model's within 1e-5."""
    torch.manual_seed(0)
    plain = UNetModel(UNetConfig(**dict(SR, in_channels=3, num_classes=None))).eval()
    for p in plain.parameters():  # the zero-init output layers would make both outputs 0
        torch.nn.init.normal_(p, std=0.1)
    torch.save(plain.state_dict(), tmp_path / "plain.pt")
    sd = load_state_dict(str(tmp_path / "plain.pt"))
    cont = TCM.SRImageModel_Feat_cont(UNetConfig(**SR)).eval()
    bias = cont.bias_feat.detach().clone()
    TCM.warmstart_from_plain_checkpoint(cont, sd)
    stem = cont.input_blocks[0][0].weight
    assert torch.equal(stem[:, :3], sd["input_blocks.0.0.weight"]) and not stem[:, 3:].any()
    assert all(torch.count_nonzero(p) == 0 for p in cont.label_emb.parameters())
    assert torch.equal(cont.bias_feat, bias)
    x, t, cond = _inputs("sr_img_feat")
    kw = _torch_kw(cond)
    with torch.no_grad():
        out = cont(nchw(x), torch.from_numpy(t), clip_feat=kw["clip_feat"], clip_feat2=kw["clip_feat2"],
                   img2=torch.zeros_like(kw["img2"]))
        ref = plain(nchw(x), torch.from_numpy(t))
    assert ref.abs().max() > 0.1
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_warm_start_from_a_clip_unet_loads_its_label_mlp():
    """A CLIP UNet's checkpoint has the label MLP: it loads, as the
    reference's non-strict load_state_dict does; a key the model lacks or a
    missing torso key raises."""
    clip = TCM.UNetModel_clip_feat(UNetConfig(**dict(SR, in_channels=3)))
    sd = clip.state_dict()
    cont = TCM.SRImageModel_Feat_cont(UNetConfig(**SR))
    TCM.warmstart_from_plain_checkpoint(cont, sd)
    assert torch.equal(cont.label_emb[0].weight, sd["label_emb.0.weight"])
    with pytest.raises(KeyError, match="unexpected"):
        TCM.warmstart_from_plain_checkpoint(cont, {**sd, "label_emb.weight": torch.zeros(512, 128)})
    with pytest.raises(KeyError, match="missing"):
        TCM.warmstart_from_plain_checkpoint(cont, {k: v for k, v in sd.items() if k != "out.2.bias"})


def test_warm_start_matches_the_jax_surgery():
    """The same plain checkpoint through the JAX ``warmstart_from_plain_checkpoint``
    and the port's gives the same parameters (the template's own leaves
    where the checkpoint has none)."""
    jm, params, tm = _pair("sr_img_feat_cont")
    plain = UNetModel(UNetConfig(**dict(SR, in_channels=3, num_classes=None)))
    sd = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(i)) * 0.1
          for i, (k, v) in enumerate(sorted(plain.state_dict().items()))}
    jloaded = JCM.warmstart_from_plain_checkpoint({k: v.numpy() for k, v in sd.items()}, params, base_in_channels=3)
    TCM.warmstart_from_plain_checkpoint(tm, sd)
    ref = state_dict_from_flax(jloaded)
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0, msg=k)
    tm.load_state_dict(state_dict_from_flax(params), strict=True)  # the cached pair's weights back


# --- int8 ------------------------------------------------------------------------------------------------


def test_sr_int8_forward_matches_jax():
    """The SR-delta model's int8 forward (the 6-channel stem through
    ``int8_conv``) against the JAX package's, teacher-forced
    (``jax_quantization``): every layer's q checked, the output within 1e-3
    * max(1, |ref|)."""
    jm, params, tm = _pair("sr_img_feat", seed=1)
    x, t, cond = _inputs("sr_img_feat", seed=3)
    ref, inter = _jax_int8_apply(jm, params, x, t, **cond)
    m = _int8(tm)
    assert m.input_blocks[0][0].in_channels == 6 and m.input_blocks[0][0].int8
    with torch.inference_mode():
        with jax_quantization(m, inter):
            out = nhwc(m(nchw(x), torch.from_numpy(t), **_torch_kw(cond)))
        plain = nhwc(tm(nchw(x), torch.from_numpy(t), **_torch_kw(cond)))
    assert np.abs(ref).max() > 0.1 and np.abs(out - plain).max() > 1e-3 * np.abs(ref).max()  # int8 acts
    _close_but_flips(out, ref, 1e-3, max(1.0, np.abs(ref).max()))
