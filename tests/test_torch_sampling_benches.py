"""The sampling benches of the port (``guided_diffusion_clip_tpu_torch/tools/``:
``deep_cache_bench``, ``guidance_interval_bench``, ``sampler_family_bench``,
``sample_overlap_bench``, ``int8_quality_check``) against the JAX tools on
the CPU, in f32 at tiny sizes.

Each tool's chain is held to the composition the JAX tool builds, from the
same weights (the JAX tools' ``random_fill``: N(0, 0.02) in the params'
tree order, carried across by ``state_dict_from_flax``) and with the noise
JAX draws handed to the port: within 5e-4, as the 5-6 step chains of
``tests/test_torch_sampling_knobs.py``; the CLIP modes through a tiny ViT
(``TINY_CLIP``, its weights carried across the same way). ``int8_quality_check``'s
xla outputs within 1e-4 of the largest value, its int8 ones teacher-forced
at the int8 tolerances of ``tests/test_torch_quant.py``; the deviation
statistics equal the JAX tools' formulas on the same arrays (within 1e-6).
Each ``main()`` runs on ``--device cpu`` on the chain tests' 32 px pair (its
``make_models`` patched to build that pair, in f32, with the conv path,
checkpointing and respacing the tool asks for; ``make_models`` itself is
held to the factories at 64 px, its smallest ADM size) and two steps, and
prints the JAX keys plus ``card`` with every rate None; without a card and
without ``--device cpu`` each exits non-zero.
"""

import dataclasses
import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guided_diffusion_clip_tpu.diffusion import deep_cache as JD
from guided_diffusion_clip_tpu.diffusion import guidance as JGd
from guided_diffusion_clip_tpu.diffusion import sampling as JS
from guided_diffusion_clip_tpu.models import clip_vit as JC
from guided_diffusion_clip_tpu.models.unet import EncoderUNetModel as JaxEncoder
from guided_diffusion_clip_tpu.models.unet import UNetConfig as JaxConfig
from guided_diffusion_clip_tpu.models.unet import UNetModel as JaxUNet
from guided_diffusion_clip_tpu.utils.script_util import create_gaussian_diffusion as j_diffusion
from guided_diffusion_clip_tpu_torch.models.clip_vit import CLIP, TINY_CLIP
from guided_diffusion_clip_tpu_torch.models.unet import EncoderUNetModel, UNetConfig, UNetModel
from guided_diffusion_clip_tpu_torch.tools import _chains, _timing
from guided_diffusion_clip_tpu_torch.tools import deep_cache_bench as dcb
from guided_diffusion_clip_tpu_torch.tools import guidance_interval_bench as gib
from guided_diffusion_clip_tpu_torch.tools import int8_quality_check as qc
from guided_diffusion_clip_tpu_torch.tools import sample_overlap_bench as sob
from guided_diffusion_clip_tpu_torch.tools import sampler_family_bench as sfb
from guided_diffusion_clip_tpu_torch.utils.convert import state_dict_from_flax
from guided_diffusion_clip_tpu_torch.utils.script_util import (
    create_classifier,
    create_gaussian_diffusion,
    create_upstream_model,
)
from test_torch_quant import _close_but_flips, _int8, _jax_int8_apply, jax_int8, jax_quantization
from torch_port_utils import nchw, nhwc

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, SIZE = 2, 32
SHAPE_J, SHAPE_T = (B, SIZE, SIZE, 3), (B, 3, SIZE, SIZE)
# ADM-G's structure at 32 px: class table, learned sigma, scale-shift, conv resampling, attention at 16 px
UNET = dict(image_size=SIZE, in_channels=3, model_channels=64, out_channels=6, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_classes=1000, num_head_channels=64,
            use_scale_shift_norm=True, resblock_updown=True, variant="unet", label_emb_type="embedding")
CLASSIFIER = dict(image_size=SIZE, in_channels=3, model_channels=64, out_channels=1000, num_res_blocks=1,
                  attention_resolutions=(), channel_mult=(1,), num_head_channels=64,
                  use_scale_shift_norm=True, resblock_updown=True)
CLASSES = np.arange(B, dtype=np.int32) % 1000
TOL = 5e-4


def tool_fill(shapes, seed):
    """The JAX tools' ``random_fill`` (e.g. tools/deep_cache_bench.py:89-94)."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda s: (rs.standard_normal(s.shape) * 0.02).astype(s.dtype), shapes)


@functools.lru_cache(maxsize=None)
def pair():
    """(JAX UNet, params, JAX classifier, cparams, torch UNet, torch
    classifier): the JAX tools' weights (seeds 0 and 1), both sides f32."""
    jm, jc = JaxUNet(JaxConfig(**UNET)), JaxEncoder(JaxConfig(**CLASSIFIER), pool="attention")
    x, t = jnp.zeros(SHAPE_J), jnp.zeros((B,))
    params = tool_fill(jax.eval_shape(lambda: jm.init(jax.random.key(0), x, t, y=jnp.zeros((B,), jnp.int32))), 0)
    cparams = tool_fill(jax.eval_shape(lambda: jc.init(jax.random.key(1), x, t)), 1)
    tm = UNetModel(UNetConfig(**UNET)).eval().requires_grad_(False)
    tm.load_state_dict(state_dict_from_flax(params["params"]), strict=True)
    tc = EncoderUNetModel(UNetConfig(**CLASSIFIER), pool="attention").eval().requires_grad_(False)
    tc.load_state_dict(state_dict_from_flax(cparams["params"], model="encoder", pool="attention"), strict=True)
    return jm, params["params"], jc, cparams["params"], tm, tc


def j_fns():
    """The JAX tools' UNet and classifier guidance (scale 1)."""
    jm, params, jc, cparams, _, _ = pair()
    unet = lambda xx, t, **kw: jm.apply({"params": params}, xx, t, **kw)  # noqa: E731
    cond = JGd.classifier_cond_fn(lambda xx, t: jc.apply({"params": cparams}, xx, t), classifier_scale=1.0)
    return jm, params, unet, cond


def x_T(seed):
    return np.random.RandomState(seed).standard_normal(SHAPE_J).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _step_draws(n):
    def draw(key):
        loop_rng, _ = jax.random.split(key, 2)
        return jnp.stack([JS._normal(k, SHAPE_J, jnp.float32) for k in jax.random.split(loop_rng, n)])

    return jax.jit(draw)


def step_noise(key, n):
    """The noise the JAX scan loop draws at each of its n steps, NCHW."""
    return [nchw(a) for a in np.asarray(_step_draws(n)(key))]


@functools.lru_cache(maxsize=None)
def tiny_clip():
    """(JAX vision params, the port's tiny ViT with their weights): the JAX
    tool's ``random_fill`` (seed 2) on ``TINY_CLIP``'s image tower."""
    cfg = JC.CLIPConfig(**dataclasses.asdict(TINY_CLIP))
    venc, tenc = JC.CLIPVisionEncoder(cfg), JC.CLIPTextEncoder(cfg)
    size = cfg.image_size
    vp = tool_fill(jax.eval_shape(lambda: venc.init(jax.random.key(2), jnp.zeros((B, size, size, 3)))), 2)["params"]
    tp = tool_fill(jax.eval_shape(lambda: tenc.init(jax.random.key(0), jnp.zeros((1, cfg.context_length), jnp.int32))),
                   0)["params"]
    model = CLIP(TINY_CLIP)
    model.load_state_dict(state_dict_from_flax((vp, tp, 2.0), model="clip"), strict=True)
    return vp, model.visual.eval().requires_grad_(False)


def close(ours, ref, tol=TOL):
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), rtol=tol, atol=tol)


def classes_t():
    return torch.from_numpy(CLASSES).long()


# --- the model pair and the statistics ---------------------------------------


def test_make_models_builds_adm_g_as_the_factories_do():
    """``make_models`` constructs without storage and fills on the device:
    the same modules, dtypes and N(0, 0.02) draws as building with the
    factories and filling afterwards; eval mode, frozen."""
    model, clf, diffusion = _timing.make_models(64, "int8", 64, 64, respacing="ddim4")
    ref = _timing.random_weights_(create_upstream_model(
        image_size=64, num_channels=64, num_res_blocks=2, channel_mult="", learn_sigma=True, class_cond=True,
        attention_resolutions="32,16,8", num_heads=4, num_head_channels=64, num_heads_upsample=-1,
        use_scale_shift_norm=True, dropout=0.0, resblock_updown=True, use_fp16=True, conv_impl="int8"), 0)
    ref_clf = _timing.random_weights_(create_classifier(
        image_size=64, classifier_use_fp16=True, classifier_width=64, classifier_depth=2,
        classifier_attention_resolutions="32,16,8", classifier_use_scale_shift_norm=True,
        classifier_resblock_updown=True, classifier_pool="attention", conv_impl="int8"), 1)
    for ours, want in ((model, ref), (clf, ref_clf)):
        a, b = ours.state_dict(), want.state_dict()
        assert list(a) == list(b) and all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
        assert not ours.training and not any(p.requires_grad for p in ours.parameters()) and ours.int8
    assert model.dtype == torch.bfloat16 and diffusion.num_timesteps == 4 and not model.config.use_checkpoint
    assert _timing.make_models(64, "xla", 64, 64, use_checkpoint=True)[0].config.use_checkpoint
    assert 0.015 < float(ref.state_dict()["out.2.weight"].float().std()) < 0.025


def test_deviation_is_the_jax_tools_formulas():
    """int8_quality_check.py:97-104 on float32 arrays, deep_cache_bench.py:
    247-251 on float64 ones, unrounded."""
    rs = np.random.RandomState(0)
    a = rs.standard_normal((2, 6, 8, 8)).astype(np.float32)
    b = (a + 0.05 * rs.standard_normal(a.shape)).astype(np.float32)
    got = qc.stats(a, b)
    scale = np.abs(a).max() + 1e-12
    want = {"rel_rmse_vs_signal_std": float(np.sqrt(np.mean((a - b) ** 2)) / (a.std() + 1e-12)),
            "max_abs_rel": float(np.abs(a - b).max() / scale),
            "corr": float(np.corrcoef(a.ravel(), b.ravel())[0, 1])}
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6 * abs(want[k]), k
    a64, b64 = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    d = _timing.deviation(a64, b64)
    assert abs(d["corr"] - float(np.corrcoef(a64, b64)[0, 1])) <= 1e-6
    rrmse = float(np.sqrt(np.mean((a64 - b64) ** 2)) / (a64.std() + 1e-12))
    assert abs(d["rel_rmse"] - rrmse) <= 1e-6 * rrmse and 0.04 < rrmse < 0.06


def _jax_sampler_family():
    path = os.path.join(REPO, "tools", "sampler_family_bench.py")
    spec = importlib.util.spec_from_file_location("jax_sampler_family_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("spec", ["ddim25", "dpm25", "ancestral250", "ddim4", "dpm10", "ancestral1", "ddim", "plms25",
                                  "25", "DDIM25", ""])
def test_parse_sampler_matches_the_jax_tool(spec):
    try:
        want = _jax_sampler_family().parse_sampler(spec)
    except ValueError:
        with pytest.raises(ValueError, match="unknown sampler spec"):
            sfb.parse_sampler(spec)
        return
    assert sfb.parse_sampler(spec) == want


# --- the chains against the JAX tools' compositions --------------------------


def test_deep_cache_chain_matches():
    """deep_cache_bench's chain (``_chains.classifier_chain`` with DeepCache
    3) against the JAX tool's ``make_chain(3)`` over 4 guided ancestral steps:
    full forwards on steps 0 and 3, shallow ones between, the gradient fresh
    every step, the uncached chain's samples moved."""
    jm, params, _, cond = j_fns()
    _, _, _, _, tm, tc = pair()
    jd = j_diffusion(steps=1000, learn_sigma=True, noise_schedule="linear", timestep_respacing="4")
    td = create_gaussian_diffusion(steps=1000, learn_sigma=True, noise_schedule="linear", timestep_respacing="4")
    key, noise = jax.random.key(7), x_T(1)
    y = jnp.asarray(CLASSES)

    def apply_full(xx, t, **kw):
        return jm.apply({"params": params}, xx, t, cache_mode="full", cache_cut=0, **kw)

    def apply_shallow(xx, t, deep, **kw):
        return jm.apply({"params": params}, xx, t, deep_cache=deep, cache_mode="shallow", cache_cut=0, **kw)

    def cached(n):
        state0 = JD.zero_state(apply_full, jnp.zeros(SHAPE_J), jnp.zeros((B,), jnp.int32), y=y)
        return jd.p_sample_loop(JD.deep_cache_model_fn(apply_full, apply_shallow, 3), SHAPE_J, key, noise=n,
                                clip_denoised=True, model_kwargs={"y": y}, cond_fn=cond, model_state0=state0)

    ref = jax.jit(cached)(jnp.asarray(noise))
    kw = dict(noise=nchw(noise), step_noise=step_noise(key, 4))
    chain = _chains.classifier_chain(td.p_sample_loop, tm, tc, classes_t(), deep_cache=3)
    ours = chain(**kw)
    uncached = _chains.classifier_chain(td.p_sample_loop, tm, tc, classes_t())
    ours_plain = uncached(**kw)
    assert chain.calls == {"unet_full": 2, "unet_shallow": 2, "classifier": 4}
    assert uncached.calls == {"unet_full": 4, "unet_shallow": 0, "classifier": 4}
    assert (ours - ours_plain).abs().max() > 1e-3  # the cache does change the chain
    close(ours, ref)


def test_interval_chain_with_caches_matches():
    """guidance_interval_bench's chain with ``GIB_DEEP_CACHE 2`` and
    ``GIB_GUIDANCE_CACHE 2`` against the JAX tool's composition (the window
    inside the gradient cache, DeepCache on the generator), 4 ancestral
    steps at model timesteps 999, 666, 333, 0 with the window [200, 800]:
    the gradient cache refreshes on steps 0 and 2, and of those only step 2
    lies inside the window, so the classifier runs once; a refresh outside
    the window runs no classifier, and a step inside it that reuses the
    cache runs none either."""
    jm, params, _, cond = j_fns()
    _, _, _, _, tm, tc = pair()
    jd = j_diffusion(steps=1000, learn_sigma=True, noise_schedule="linear", timestep_respacing="4")
    td = create_gaussian_diffusion(steps=1000, learn_sigma=True, noise_schedule="linear", timestep_respacing="4")
    key, noise = jax.random.key(7), x_T(2)
    y = jnp.asarray(CLASSES)

    def apply_full(xx, t, y=None, **kw):
        return jm.apply({"params": params}, xx, t, y=y, cache_mode="full", **kw)

    def apply_shallow(xx, t, deep, y=None, **kw):
        return jm.apply({"params": params}, xx, t, y=y, deep_cache=deep, cache_mode="shallow", **kw)

    def run(n):
        cond_fn, cond_state0 = JGd.cached_cond_fn(JGd.interval_cond_fn(cond, 200.0, 800.0), 2, SHAPE_J)
        state0 = JD.zero_state(apply_full, jnp.zeros(SHAPE_J), jnp.zeros((B,), jnp.int32), y=y)
        return jd.p_sample_loop(JD.deep_cache_model_fn(apply_full, apply_shallow, 2), SHAPE_J, key, noise=n,
                                clip_denoised=True, model_kwargs={"y": y}, cond_fn=cond_fn, model_state0=state0,
                                cond_state0=cond_state0)

    ref = jax.jit(run)(jnp.asarray(noise))
    chain = _chains.classifier_chain(td.p_sample_loop, tm, tc, classes_t(), interval=(200.0, 800.0),
                                     deep_cache=2, guidance_cache=2)
    ours = chain(noise=nchw(noise), step_noise=step_noise(key, 4))
    assert td.sched.timestep_map.tolist() == [0, 333, 666, 999]
    assert chain.calls == {"unet_full": 2, "unet_shallow": 2, "classifier": 1}
    close(ours, ref)


@pytest.mark.parametrize("kind,guidance", [("ddim", "clip_x0"), ("dpm", "clip")])
def test_sampler_family_chain_matches(kind, guidance):
    """sampler_family_bench's CLIP-guided chains against the JAX tool's
    composition, from the same x_T (eta 0: no step noise): ``clip_x0``
    (DDIM; the gradient through the UNet's x0 prediction, a second UNet
    call a step) and ``clip`` (DPM-Solver++(2M); at the noisy x), scale
    100, the target from ``RandomState(3)``, a tiny ViT in place of
    ViT-B/32. Over 4 unrespaced cosine steps: the JAX cond_fn indexes the
    schedule with the model timestep, the port's with the schedule's own
    step, and the two agree only without respacing."""
    _, _, unet, _ = j_fns()
    _, _, _, _, tm, tc = pair()
    vp, vision = tiny_clip()
    _, target = sfb.clip_models("cpu", TINY_CLIP)
    assert np.array_equal(target.numpy(), np.random.RandomState(3).standard_normal(16).astype(np.float32))
    jd = j_diffusion(steps=4, learn_sigma=True, noise_schedule="cosine")
    td = create_gaussian_diffusion(steps=4, learn_sigma=True, noise_schedule="cosine")
    loop = jd.ddim_sample_loop if kind == "ddim" else jd.dpm_solver_pp_2m_loop
    noise, y = x_T(3), jnp.asarray(CLASSES)
    venc = JC.CLIPVisionEncoder(JC.CLIPConfig(**dataclasses.asdict(TINY_CLIP)))

    def run(n):
        model_fn = JGd.model_fn_dropping_y(unet, class_cond=True)
        cond_fn = JC.clip_guidance_cond_fn(
            lambda pixels: venc.apply({"params": vp}, pixels), jnp.asarray(target.numpy()), scale=100.0,
            clip_image_size=TINY_CLIP.image_size, sched=jd.sched, mean_type=jd.mean_type, var_type=jd.var_type,
            model_fn=model_fn, use_pred_xstart=guidance == "clip_x0")
        return loop(model_fn, SHAPE_J, jax.random.key(7), noise=n, clip_denoised=True, model_kwargs={"y": y},
                    cond_fn=cond_fn)

    ref = jax.jit(run)(jnp.asarray(noise))
    chain = sfb.make_chain(kind, td, tm, tc, classes_t(), guidance, vision=vision, target=target)
    ours = chain(noise=nchw(noise))
    plain_loop = td.ddim_sample_loop if kind == "ddim" else td.dpm_solver_pp_2m_loop
    unguided = _chains.runner(plain_loop, tm, classes_t(), SHAPE_T)(noise=nchw(noise))
    assert chain.calls == {"unet_full": 8 if guidance == "clip_x0" else 4, "unet_shallow": 0, "classifier": 0,
                           "clip": 4}
    assert torch.isfinite(ours).all() and (ours - unguided).abs().max() > 1e-4  # the guidance acts
    close(ours, ref)


def test_cfg_cached_chain_matches():
    """sampler_family_bench's ``cfg`` chain with ``SFB_CFG_CACHE 2`` (DDIM, 4
    steps, scale 2, ``{"y": 0}`` the null) against the JAX tool's
    ``cfg_cached_model_fn`` with ``cfg_cached_state0``: the conditional
    branch every step, the unconditional one on steps 0 and 2."""
    _, _, unet, _ = j_fns()
    _, _, _, _, tm, tc = pair()
    jd = j_diffusion(steps=1000, learn_sigma=True, noise_schedule="linear", timestep_respacing="ddim4")
    td = create_gaussian_diffusion(steps=1000, learn_sigma=True, noise_schedule="linear", timestep_respacing="ddim4")
    noise, y = x_T(4), jnp.asarray(CLASSES)
    model_fn = JGd.model_fn_dropping_y(unet, class_cond=True)

    def run(n):
        sfn = JGd.cfg_cached_model_fn(model_fn, 2.0, {"y": 0}, 2)
        state0 = JGd.cfg_cached_state0(model_fn, jnp.zeros(SHAPE_J), jnp.zeros((B,), jnp.int32), y=y)
        return jd.ddim_sample_loop(sfn, SHAPE_J, jax.random.key(7), noise=n, clip_denoised=True,
                                   model_kwargs={"y": y}, model_state0=state0)

    ref = jax.jit(run)(jnp.asarray(noise))
    chain = sfb.make_chain("ddim", td, tm, tc, classes_t(), "cfg", cfg_scale=2.0, cfg_cache=2)
    ours = chain(noise=nchw(noise))
    assert chain.calls["unet_full"] == 4 + 2 and chain.calls["classifier"] == 0
    close(ours, ref)


# --- int8_quality_check ------------------------------------------------------


def _qc_inputs():
    x, t, y = qc.inputs(B, SIZE, "cpu")
    assert x.shape == SHAPE_T and float(t[0]) == 128.0 and not y.any()
    np.testing.assert_array_equal(nhwc(x), np.random.RandomState(2).randn(*SHAPE_J).astype(np.float32))
    return x, t, y


def test_int8_quality_check_xla_outputs_match():
    """The UNet's output and the guidance gradient of the xla (here f32)
    pair, as the JAX tool computes them, within 1e-4 of the
    largest value."""
    jm, params, _, cond = j_fns()
    _, _, _, _, tm, tc = pair()
    x, t, y = _qc_inputs()
    xj, tj, yj = jnp.asarray(nhwc(x)), jnp.full((B,), 128.0), jnp.zeros((B,), jnp.int32)
    eps_ref = np.asarray(jax.jit(lambda xx: jm.apply({"params": params}, xx, tj, y=yj))(xj))
    grad_ref = np.asarray(jax.jit(lambda xx: cond(xx, tj, y=yj))(xj))
    eps, grad = qc.outputs(tm, tc, x, t, y)
    for ours, ref in ((eps, eps_ref), (grad, grad_ref)):
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(ours.transpose(0, 2, 3, 1), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_int8_quality_check_int8_outputs_match_teacher_forced():
    """The same with both models on the int8 path, teacher-forced to the JAX
    int8 program's own roundings (``jax_quantization``): the UNet's output
    within 1e-3 * max(1, |ref|) but for rare flips of the unforced head, the
    gradient within 2e-2 * max|ref| and 1e-2 relative L2 (bf16
    straight-through convs, as shipped). The gradient program is jitted with
    its intermediates captured inside it, the forcing's reference from the
    same program; it reads 2.1e-3 and 1.5e-3, as op by op (1.8e-3, 1.1e-3),
    at a tenth of the time."""
    jm, params, jc, cparams, tm, tc = pair()
    m, c = _int8(tm).requires_grad_(False), _int8(tc).requires_grad_(False)
    x, t, y = _qc_inputs()
    xn = nhwc(x)
    tn, yn = np.full((B,), 128.0, np.float32), np.zeros((B,), np.int32)
    eps_ref, inter_m = _jax_int8_apply(jm, params, xn, tn, y=yn)

    def selected_logp(xx):  # JGd.classifier_cond_fn's, with the intermediates
        logits, inter = jc.apply({"params": cparams}, xx, jnp.asarray(tn), capture_intermediates=True,
                                 mutable=["intermediates"])
        logp = jnp.take_along_axis(jax.nn.log_softmax(logits, axis=-1), jnp.asarray(yn)[:, None], axis=-1)
        return logp.sum(), inter["intermediates"]

    with jax_int8():
        grad_ref, inter_c = jax.jit(jax.grad(selected_logp, has_aux=True))(jnp.asarray(xn))
    grad_ref = np.asarray(grad_ref)
    with jax_quantization(m, inter_m), jax_quantization(c, inter_c):
        eps, grad = qc.outputs(m, c, x, t, y)
    eps_plain, _ = qc.outputs(tm, tc, x, t, y)
    assert np.abs(eps - eps_plain).max() > 0  # int8 acts
    _close_but_flips(eps.transpose(0, 2, 3, 1), eps_ref, 1e-3, max(1.0, np.abs(eps_ref).max()))
    grad = grad.transpose(0, 2, 3, 1)
    assert np.abs(grad_ref).max() > 0
    np.testing.assert_allclose(grad, grad_ref, rtol=0, atol=2e-2 * np.abs(grad_ref).max())
    assert np.linalg.norm(grad - grad_ref) <= 1e-2 * np.linalg.norm(grad_ref)


# --- sample_overlap_bench ----------------------------------------------------


def test_overlapped_and_serial_loops_write_the_same_pngs(tmp_path):
    """Both loops write each batch once, in order, as the same PNG bytes for
    the same seeds; the chain's samples are NHWC and depend on the seed."""
    _, _, _, _, tm, _ = pair()
    td = create_gaussian_diffusion(steps=1000, learn_sigma=True, noise_schedule="linear", timestep_respacing="ddim2")
    run_chain = sob.make_chain(tm, td, B, torch.device("cpu"))
    a = run_chain(5)
    assert a.shape == SHAPE_J and torch.equal(a, run_chain(5)) and not torch.equal(a, run_chain(6))
    written = {}
    for name, fn in (("serial", sob.run_serial), ("overlap", sob.run_overlapped)):
        out = tmp_path / name
        out.mkdir()
        written[name] = []
        assert fn(run_chain, sob.writer(str(out), written[name]), 3, 100) > 0
        assert sorted(os.listdir(out)) == ["s0.png", "s1.png", "s2.png"]
    assert written["serial"] == written["overlap"] == [0, 1, 2]
    for i in range(3):
        assert (tmp_path / "serial" / f"s{i}.png").read_bytes() == (tmp_path / "overlap" / f"s{i}.png").read_bytes()
    assert (tmp_path / "serial" / "s0.png").read_bytes() != (tmp_path / "serial" / "s1.png").read_bytes()


# --- the entry points --------------------------------------------------------

TINY = {  # 32 px (`tiny_models`), batch 1, 2 steps
    "dcb": {"DCB_IMAGE_SIZE": "32", "DCB_CH": "64", "DCB_BATCH": "1", "DCB_STEPS": "2", "DCB_INTERVALS": "2",
            "DCB_FP16": "0", "DCB_CONV_IMPL": "xla"},
    "gib": {"GIB_IMAGE_SIZE": "32", "GIB_CH": "64", "GIB_BATCH": "1", "GIB_STEPS": "2", "GIB_WINDOWS": "0,500",
            "GIB_FP16": "0", "GIB_CONV_IMPL": "xla"},
    "sfb": {"SFB_IMAGE_SIZE": "32", "SFB_CH": "64", "SFB_BATCH": "1", "SFB_SAMPLERS": "dpm2", "SFB_FP16": "0",
            "SFB_CONV_IMPL": "xla"},
    "sfb_cfg": {"SFB_IMAGE_SIZE": "32", "SFB_CH": "64", "SFB_BATCH": "1", "SFB_SAMPLERS": "ddim2", "SFB_FP16": "0",
                "SFB_CONV_IMPL": "int8", "SFB_GUIDANCE": "cfg", "SFB_CFG_CACHE": "2"},
    "qc": {"QC_IMAGE_SIZE": "32"},
    "sob": {"OB_IMAGE_SIZE": "32", "OB_BATCH": "1", "OB_BATCHES": "1", "OB_MODE": "bf16"},
}
# the arguments each tool hands make_models under TINY: (size, conv_impl, channels, fp16) of each call
BUILDS = {"dcb": [(32, "xla", 64, False)], "gib": [(32, "xla", 64, False)], "sfb": [(32, "xla", 64, False)],
          "sfb_cfg": [(32, "int8", 64, False)], "qc": [(32, "xla", 256, True), (32, "int8", 256, True)],
          "sob": [(32, "xla", 256, True)]}
TOOLS = {"dcb": dcb, "gib": gib, "sfb": sfb, "sfb_cfg": sfb, "qc": qc, "sob": sob}
ARGV = {"qc": ["1"]}
# the keys of the JAX tools' JSON lines (the overlap bench's: the numbers its last log line prints,
# tools/sample_overlap_bench.py:141-146), then the port's
JAX_KEYS = {
    "dcb": {"uncached_samples_per_min", "dc2"},  # tools/deep_cache_bench.py:236-258
    "gib": {"full_guidance_samples_per_min", "interval[0,500]"},  # tools/guidance_interval_bench.py:179-192
    "sfb": {"dpm2"},  # tools/sampler_family_bench.py:235-239
    "sfb_cfg": {"ddim2"},
    "qc": {"unet_out", "guidance_grad"},  # tools/int8_quality_check.py:95-106
    "sob": {"host_s", "serial_a", "overlap_a", "overlap_b", "serial_b", "serial", "overlapped", "saved", "saved_pct"},
}
EXTRA = {"dcb": {"uncached_secs_per_chain"}, "gib": {"full_guidance_secs_per_chain"}}
INNER = {  # the keys of the nested rows: the JAX tools', then the port's
    "dcb": ({"samples_per_min", "speedup", "corr", "rel_rmse"}, {"secs_per_chain"}),
    "gib": ({"samples_per_min", "speedup", "corr_vs_full_context_only"}, {"secs_per_chain", "rel_rmse_vs_full"}),
    "sfb": ({"secs_per_chain", "samples_per_min_per_chip", "steps"}, {"peak_memory_gib"}),
    "sfb_cfg": ({"secs_per_chain", "samples_per_min_per_chip", "steps"}, {"peak_memory_gib"}),
    "qc": ({"rel_rmse_vs_signal_std", "max_abs_rel", "corr"}, set()),
}
NONE_ON_CPU = {"samples_per_min", "uncached_samples_per_min", "full_guidance_samples_per_min",
               "samples_per_min_per_chip", "peak_memory_gib"}


def setenv(monkeypatch, env: dict) -> None:
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def tiny_models(monkeypatch, mod, **override) -> list:
    """Patch ``mod``'s ``make_models`` to build the chain tests' 32 px pair
    in f32 (``pair``'s weights) with the conv path, checkpointing and
    respacing the tool asks for, ``override`` on top; returns the list that
    records (size, conv_impl, channels, fp16) of each call."""
    _, _, _, _, tm, tc = pair()
    calls = []

    def make_models(size, conv_impl="auto", channels=256, clf_width=128, *, respacing="250", use_checkpoint=False,
                    fp16=True, device=None):
        calls.append((size, conv_impl, channels, fp16))
        respacing = override.get("respacing", respacing)
        model = UNetModel(dataclasses.replace(tm.config, use_checkpoint=use_checkpoint), conv_impl=conv_impl)
        model.load_state_dict(tm.state_dict(), strict=True)
        clf = EncoderUNetModel(tc.config, pool="attention", conv_impl=conv_impl)
        clf.load_state_dict(tc.state_dict(), strict=True)
        diffusion = create_gaussian_diffusion(steps=1000, learn_sigma=True, noise_schedule="linear",
                                              timestep_respacing=respacing)
        return model.eval().requires_grad_(False), clf.eval().requires_grad_(False), diffusion

    monkeypatch.setattr(mod, "make_models", make_models)
    return calls


@pytest.mark.parametrize("tool", sorted(TINY))
def test_main_on_cpu(tool, monkeypatch, capsys):
    """Each ``main()`` on ``--device cpu``: the models it asks for, the JAX
    keys plus ``card`` (and the port's extra keys), every rate None, every
    time positive; the overlap bench at ``ddim2`` (its ``ddim25`` cut for
    the CPU by ``tiny_models``, as it has no knob for it)."""
    setenv(monkeypatch, TINY[tool])
    mod = TOOLS[tool]
    builds = tiny_models(monkeypatch, mod, **({"respacing": "ddim2"} if tool == "sob" else {}))
    row = mod.main([*ARGV.get(tool, []), "--device", "cpu"])
    assert builds == BUILDS[tool]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == row
    assert set(row) == JAX_KEYS[tool] | EXTRA.get(tool, set()) | {"card"} and row["card"] == "cpu"
    nested = {k: v for k, v in row.items() if isinstance(v, dict)}
    for k, v in [*row.items(), *(kv for inner in nested.values() for kv in inner.items())]:
        if isinstance(v, (dict, str)):
            continue
        assert v is None if k in NONE_ON_CPU else np.isfinite(v), (k, v)
    if tool in INNER:
        keys, extra = INNER[tool]
        assert nested and all(set(v) == keys | extra for v in nested.values())
    if tool == "sob":
        assert row["serial"] == min(row["serial_a"], row["serial_b"]) > 0 and row["host_s"] > 0
    if tool == "dcb":
        assert 0 < row["dc2"]["rel_rmse"] and row["dc2"]["corr"] < 1  # the cache moves the samples


def test_sfb_use_checkpoint_gives_the_same_samples(monkeypatch, capsys):
    """``SFB_GUIDANCE clip_x0`` through ``main()`` with ``SFB_USE_CHECKPOINT``
    0 and 1, on the 32 px pair of the chain tests (``tiny_models``: built
    with the ``use_checkpoint`` the tool passes) and the tiny ViT in place
    of ViT-B/32, two DDIM steps: the same samples bit for bit,
    the blocks recomputed in the UNet's backward only with 1, and the rows'
    keys those of the other modes."""
    import torch.utils.checkpoint as tuc

    setenv(monkeypatch, {**TINY["sfb"], "SFB_GUIDANCE": "clip_x0", "SFB_SAMPLERS": "ddim2"})
    builds = tiny_models(monkeypatch, sfb)
    clip_models = sfb.clip_models
    monkeypatch.setattr(sfb, "clip_models", lambda device: clip_models(device, TINY_CLIP))
    samples, remat = [], []
    timed_twice, checkpoint = sfb.timed_twice, tuc.checkpoint

    def keep(fn, device):
        out, secs = timed_twice(fn, device)
        samples.append(out)
        return out, secs

    def counted(*a, **kw):
        remat.append(1)
        return checkpoint(*a, **kw)

    monkeypatch.setattr(sfb, "timed_twice", keep)
    monkeypatch.setattr(tuc, "checkpoint", counted)
    calls = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("SFB_USE_CHECKPOINT", flag)
        del remat[:]
        row = sfb.main(["--device", "cpu"])
        calls[flag] = len(remat)
        assert set(row) == {"ddim2", "card"} and set(row["ddim2"]) == set.union(*INNER["sfb"])
    capsys.readouterr()
    assert calls["0"] == 0 < calls["1"] and builds == [(SIZE, "xla", 64, False)] * 2
    assert len(samples) == 2 and torch.isfinite(samples[0]).all() and torch.equal(samples[0], samples[1])


@pytest.mark.parametrize("tool", sorted(TINY))
def test_main_without_a_card_exits_non_zero(tool, monkeypatch):
    setenv(monkeypatch, TINY[tool])
    with pytest.raises(SystemExit, match="no CUDA device") as e:
        TOOLS[tool].main(ARGV.get(tool, []))
    assert e.value.code not in (0, None)


def test_dcb_segment_is_refused(monkeypatch):
    setenv(monkeypatch, {**TINY["dcb"], "DCB_SEGMENT": "50"})
    with pytest.raises(SystemExit, match="DCB_SEGMENT: chain segmenting .* not ported"):
        dcb.main(["--device", "cpu"])
    monkeypatch.setenv("DCB_SEGMENT", "0")
    assert dcb.settings()["intervals"] == [2]
