"""The port's CLIP (``models/clip_vit.py``, ``models/clip_tokenizer.py``)
against the JAX package's, f32 on the CPU at ``tests/test_clip_vit.py``'s
TINY config.

The same random flax parameters reach the port through
``state_dict_from_flax(model="clip")``; the encoders agree within rtol 1e-4,
atol 1e-5, the converted state_dict read back by the JAX
``import_openai_clip_pt`` gives the flax tree bit for bit, an HF
``CLIPModel`` state_dict and a TorchScript archive load through
``load_clip_params``, ``preprocess_for_clip`` and its VJP agree within 1e-5,
the guidance gradient within 1e-4 * max|ref| in both modes, and a 3-step
CLIP-guided ancestral chain (given the noise JAX draws) within 5e-4.
"""

import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guided_diffusion_clip_tpu.diffusion import gaussian as JG
from guided_diffusion_clip_tpu.diffusion import sampling as JS
from guided_diffusion_clip_tpu.diffusion import schedules as JSch
from guided_diffusion_clip_tpu.models import clip_tokenizer as JTok
from guided_diffusion_clip_tpu.models import clip_vit as J
from guided_diffusion_clip_tpu_torch.diffusion import sampling as TS
from guided_diffusion_clip_tpu_torch.diffusion import schedules as TSch
from guided_diffusion_clip_tpu_torch.models import clip_tokenizer as TTok
from guided_diffusion_clip_tpu_torch.models import clip_vit as P
from guided_diffusion_clip_tpu_torch.utils.convert import state_dict_from_flax
from torch_port_utils import clip_feat_pair, nchw, nhwc, random_params

torch.set_num_threads(2)
VOCAB = os.path.join(os.path.dirname(__file__), "assets", "tiny_bpe_vocab.txt.gz")
TINY = J.CLIPConfig(
    image_size=32, patch_size=16, vision_width=64, vision_layers=2, vision_heads=4,
    vocab_size=100, context_length=12, text_width=32, text_layers=2, text_heads=2, embed_dim=16,
)
PTINY = P.CLIPConfig(**dataclasses.asdict(TINY))
# the fork's CLIP-conditioned UNet, shrunk to 16 px (learned sigma, scale-shift)
UNET = dict(image_size=16, in_channels=3, model_channels=32, out_channels=6, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_classes=512, num_heads=2,
            use_scale_shift_norm=True)
SCALE = 3.0


@pytest.fixture(scope="module")
def clip():
    """(flax vision params, flax text params, the port's CLIP with their weights)."""
    venc, tenc = J.CLIPVisionEncoder(TINY), J.CLIPTextEncoder(TINY)
    vs = jax.eval_shape(lambda: venc.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3))))["params"]
    ts = jax.eval_shape(lambda: tenc.init(jax.random.key(0), jnp.zeros((1, 12), jnp.int32)))["params"]
    vp, tp = jax.device_get(random_params(vs, 0)), jax.device_get(random_params(ts, 1))
    model = P.CLIP(PTINY)
    model.load_state_dict(state_dict_from_flax((vp, tp, 2.5), model="clip"), strict=True)
    return vp, tp, model.eval().requires_grad_(False)


def _jax_vision(vp):
    enc = J.CLIPVisionEncoder(TINY)
    return lambda pixels: enc.apply({"params": vp}, pixels)


@pytest.mark.parametrize("texts,context", [
    (["the cat and the dog", "a thing"], 12),
    ("a photo of a cat", 77),
    (["", "THE  Cat's   dog!!  42"], 12),
    (["the cat and the dog and the cat and the dog and the cat"], 8),  # truncated, ends in <|endoftext|>
])
def test_tokenizer_ids_match_jax(texts, context):
    ours = TTok.SimpleTokenizer(bpe_path=VOCAB, context_length=context)
    ref = JTok.SimpleTokenizer(bpe_path=VOCAB, context_length=context)
    a, b = ours(texts), ref(texts)
    assert a.dtype == b.dtype == np.int32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    assert ours.encoder == ref.encoder and ours.decode(a[0][1:]) == ref.decode(b[0][1:])


def test_tokenizer_refusals_match_jax(monkeypatch):
    monkeypatch.delenv("CLIP_BPE_PATH", raising=False)
    with pytest.raises(FileNotFoundError, match="CLIP_BPE_PATH") as ours:
        TTok.SimpleTokenizer()
    with pytest.raises(FileNotFoundError) as ref:
        JTok.SimpleTokenizer()
    assert str(ours.value) == str(ref.value)
    monkeypatch.setenv("CLIP_BPE_PATH", VOCAB)
    np.testing.assert_array_equal(TTok.SimpleTokenizer(context_length=12)("a cat"),
                                  JTok.SimpleTokenizer(context_length=12)("a cat"))
    with pytest.raises(ValueError, match="too long"):
        TTok.SimpleTokenizer(context_length=4)("the cat and the dog", truncate=False)


def test_vision_encoder_matches_flax(clip):
    vp, _, model = clip
    pixels = np.random.RandomState(0).randn(3, 32, 32, 3).astype(np.float32)
    ref = np.asarray(_jax_vision(vp)(jnp.asarray(pixels)))
    ours = model.visual(nchw(pixels)).numpy()
    assert ours.shape == (3, 16)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


def test_text_encoder_matches_flax(clip):
    _, tp, model = clip
    rs = np.random.RandomState(1)
    ids = rs.randint(1, TINY.vocab_size - 1, (3, TINY.context_length)).astype(np.int32)
    ids[0, 5] = ids[1, 9] = TINY.vocab_size - 1  # the end-of-text id is the largest: argmax pooling
    ref = np.asarray(J.CLIPTextEncoder(TINY).apply({"params": tp}, jnp.asarray(ids)))
    ours = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)
    short = ids[:, :7]  # fewer tokens than the context: positions and mask cut to T
    np.testing.assert_allclose(model(torch.from_numpy(short)).numpy(),
                               np.asarray(J.CLIPTextEncoder(TINY).apply({"params": tp}, jnp.asarray(short))),
                               rtol=1e-4, atol=1e-5)


def test_converted_state_dict_reads_back_through_the_jax_importer(clip):
    vp, tp, model = clip
    sd = state_dict_from_flax((vp, tp, 2.5), model="clip")
    assert sorted(sd) == sorted(model.state_dict())
    vision, text, logit_scale = J.import_openai_clip_pt(sd, TINY)
    assert logit_scale == 2.5
    for ours, ref in ((vision, vp), (text, tp)):
        a, b = jax.tree_util.tree_leaves_with_path(ours), jax.tree_util.tree_leaves_with_path(ref)
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y), path


def test_torchscript_archive_loads(clip, tmp_path):
    """OpenAI's released .pt is a TorchScript archive with three buffers no
    module holds; load_clip_params takes its state_dict."""
    _, _, model = clip
    holder = P.CLIP(PTINY)
    holder.load_state_dict(model.state_dict())
    holder.register_buffer("input_resolution", torch.tensor(32))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        traced = torch.jit.trace(holder, torch.ones(1, 12, dtype=torch.long))
    torch.jit.save(traced, str(tmp_path / "clip.pt"))
    vision, text = P.load_clip_params(str(tmp_path / "clip.pt"), PTINY)
    assert vision is text.visual
    for k, v in model.state_dict().items():
        assert torch.equal(text.state_dict()[k], v), k


def test_hf_state_dict_loads_to_the_same_module(tmp_path):
    pytest.importorskip("transformers")
    from test_clip_vit import make_hf_model

    hf = make_hf_model(TINY)
    torch.save(hf.state_dict(), tmp_path / "hf.pt")
    vision, text = P.load_clip_params(str(tmp_path / "hf.pt"), PTINY)
    # the same weights as the JAX importer reads from it, carried across
    jv, jt, ls = J.import_clip_torch_state_dict(hf.state_dict(), TINY)
    want = state_dict_from_flax((jv, jt, ls), model="clip")
    for k, v in text.state_dict().items():
        assert torch.equal(v, want[k]), k
    rs = np.random.RandomState(2)
    pixels = rs.randn(2, 3, 32, 32).astype(np.float32)
    ids = rs.randint(1, TINY.vocab_size - 1, (2, TINY.context_length))
    ids[:, 6] = TINY.vocab_size - 1
    with torch.no_grad():
        np.testing.assert_allclose(vision(torch.from_numpy(pixels)).numpy(),
                                   hf.get_image_features(pixel_values=torch.from_numpy(pixels)).numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(text(torch.from_numpy(ids)).numpy(),
                                   hf.get_text_features(input_ids=torch.from_numpy(ids).long()).numpy(),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("size,to", [(256, 224), (64, 32), (16, 32), (32, 32)])
def test_preprocess_and_its_vjp_match_jax(size, to):
    rs = np.random.RandomState(size)
    x = rs.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    cot = rs.standard_normal((2, to, to, 3)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: J.preprocess_for_clip(a, to), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(cot))
    xt = nchw(x).requires_grad_(True)
    ours = P.preprocess_for_clip(xt, to)
    (dx,) = torch.autograd.grad(ours, xt, nchw(cot))
    np.testing.assert_allclose(nhwc(ours.detach()), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nhwc(dx), np.asarray(ref_dx), rtol=1e-5, atol=1e-5)


def _target():
    return np.random.RandomState(5).standard_normal((16,)).astype(np.float32)


@pytest.fixture(scope="module")
def unet():
    return clip_feat_pair(UNET, seed=3)


def _cond_fns(clip, unet, steps, respacing, pred_xstart):
    """(JAX cond_fn, the port's cond_fn, their schedules) on the same weights."""
    vp, _, model = clip
    jm, params, tm = unet
    tm.requires_grad_(False)
    js = JSch.build_schedule(steps=steps, noise_schedule="cosine", timestep_respacing=respacing)
    ts = TSch.build_schedule(steps=steps, noise_schedule="cosine", timestep_respacing=respacing)
    kw = dict(mean_type=JSch.ModelMeanType.EPSILON, var_type=JSch.ModelVarType.LEARNED_RANGE)
    tkw = dict(mean_type=TSch.ModelMeanType.EPSILON, var_type=TSch.ModelVarType.LEARNED_RANGE)
    jcond = J.clip_guidance_cond_fn(
        _jax_vision(vp), jnp.asarray(_target()), SCALE, clip_image_size=32, sched=js,
        model_fn=lambda x, t, **k: jm.apply({"params": params}, x, t, **k), use_pred_xstart=pred_xstart, **kw)
    tcond = P.clip_guidance_cond_fn(model.visual, torch.from_numpy(_target()), SCALE, clip_image_size=32,
                                    sched=ts, model_fn=tm, use_pred_xstart=pred_xstart, **tkw)
    return jcond, tcond, js, ts


def _inputs(seed=4):
    rs = np.random.RandomState(seed)
    return rs.standard_normal((2, 16, 16, 3)).astype(np.float32), rs.standard_normal((2, 512)).astype(np.float32)


@pytest.mark.parametrize("pred_xstart", [False, True], ids=["noisy_x", "pred_xstart"])
def test_guidance_gradient_matches_jax(clip, unet, pred_xstart):
    """Without respacing, where the JAX cond_fn's schedule index is its step."""
    jcond, tcond, _, _ = _cond_fns(clip, unet, 40, "", pred_xstart)
    x, feat = _inputs()
    t = np.array([17, 30], np.int32)
    ref = np.asarray(jax.jit(lambda a, b, f: jcond(a, b, clip_feat=f))(jnp.asarray(x), jnp.asarray(t),
                                                                        jnp.asarray(feat)))
    with torch.no_grad():
        ours = nhwc(tcond(nchw(x), torch.from_numpy(t).long(), clip_feat=torch.from_numpy(feat)))
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_pred_xstart_gradient_under_respacing_takes_the_schedule_step(clip, unet):
    """Under respacing the loops hand cond_fn the model's timesteps; the port
    predicts x0 at the schedule's step whose model timestep that is. The
    reference here is that composition of JAX functions; the JAX
    clip_guidance_cond_fn indexes the schedule with the model timestep
    itself (clamped to the last step), and its answer is not that one."""
    vp, _, _ = clip
    jm, params, _ = unet
    jcond, tcond, js, ts = _cond_fns(clip, unet, 1000, "10", True)
    x, feat = _inputs(6)
    local = np.array([3, 7], np.int32)
    t_model = np.asarray(js.model_timesteps(jnp.asarray(local)))
    target = jnp.asarray(_target() / np.linalg.norm(_target()))
    vision = _jax_vision(vp)

    def potential(xx):
        out = JG.p_mean_variance(js, lambda a, b, **k: jm.apply({"params": params}, a, b, **k), xx,
                                 jnp.asarray(local), var_type=JSch.ModelVarType.LEARNED_RANGE, clip_denoised=False,
                                 model_kwargs={"clip_feat": jnp.asarray(feat)})
        emb = vision(J.preprocess_for_clip(out.pred_xstart, 32))
        return jnp.sum(emb / jnp.linalg.norm(emb, axis=-1, keepdims=True) * target)

    ref = np.asarray(jax.jit(jax.grad(potential))(jnp.asarray(x))) * SCALE
    jax_fn = np.asarray(jax.jit(lambda a, b, f: jcond(a, b, clip_feat=f))(jnp.asarray(x), jnp.asarray(t_model),
                                                                          jnp.asarray(feat)))
    t = TSch.DiffusionSchedule.model_timesteps(ts, torch.from_numpy(local).long())
    assert t.tolist() == t_model.tolist()
    with torch.no_grad():
        ours = nhwc(tcond(nchw(x), t, clip_feat=torch.from_numpy(feat)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    assert np.abs(jax_fn - ref).max() > 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("steps,respacing,pred_xstart", [(1000, "3", False), (3, "", True)],
                         ids=["noisy_x", "pred_xstart"])
def test_clip_guided_ancestral_chain_matches_with_jax_noise(clip, unet, steps, respacing, pred_xstart):
    """3 CLIP-guided ancestral steps from the same x_T; the port is given the
    noise JAX's loop draws at each step."""
    jm, params, tm = unet
    jcond, tcond, js, ts = _cond_fns(clip, unet, steps, respacing, pred_xstart)
    x_T, feat = _inputs(7)
    jmodel = lambda x, t, **k: jm.apply({"params": params}, x, t, **k)
    key = jax.random.key(11)
    run = lambda cond: jax.jit(lambda n: JS.p_sample_loop(
        js, jmodel, n.shape, key, noise=n, cond_fn=cond, model_kwargs={"clip_feat": jnp.asarray(feat)},
    ))(jnp.asarray(x_T))
    ref, unguided = run(jcond), run(None)
    loop_rng, _ = jax.random.split(key, 2)  # the split JS._scan_loop makes
    step_noise = [nchw(np.array(JS._normal(k, x_T.shape, jnp.float32))) for k in jax.random.split(loop_rng, 3)]
    with torch.no_grad():
        ours = TS.p_sample_loop(ts, tm, (2, 3, 16, 16), None, noise=nchw(x_T), step_noise=step_noise,
                                cond_fn=tcond, model_kwargs={"clip_feat": torch.from_numpy(feat)})
    assert np.abs(np.asarray(ref) - np.asarray(unguided)).max() > 1e-2  # the guidance acts
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), rtol=5e-4, atol=5e-4)
