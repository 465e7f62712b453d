"""The deploy preset's sampling knobs in the port against the JAX package.

DeepCache (the UNet's cache modes and ``deep_cache.py``), the guidance
interval and the guidance cache, classifier-free guidance (doubled batch,
cached unconditional branch, composed with DeepCache), DPM-Solver++(2M), DDIM
inversion and the progressive loops: the same inputs from a numpy seed go
through the JAX function and the port's, f32 on the CPU, with the noise JAX
draws handed to the port. Tolerances: one forward 1e-4 (as
``tests/test_torch_unet.py``), ``shallow(full's deep)`` against the plain
forward 1e-5, a chain of 5-6 steps 5e-4 (as ``tests/test_torch_diffusion.py``).
``lax.cond`` hides on the JAX side which branch ran; on the port's side the
networks' calls are counted, so a skipped branch is shown not to run. The two
entry points are rehearsed with the preset's flags at the end.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guided_diffusion_clip_tpu.diffusion import deep_cache as JD
from guided_diffusion_clip_tpu.diffusion import guidance as JGd
from guided_diffusion_clip_tpu.diffusion import sampling as JS
from guided_diffusion_clip_tpu.diffusion import schedules as JSch
from guided_diffusion_clip_tpu_torch import classifier_sample as CS
from guided_diffusion_clip_tpu_torch import serve
from guided_diffusion_clip_tpu_torch.diffusion import deep_cache as TD
from guided_diffusion_clip_tpu_torch.diffusion import guidance as TGd
from guided_diffusion_clip_tpu_torch.diffusion import sampling as TS
from guided_diffusion_clip_tpu_torch.diffusion import schedules as TSch
from guided_diffusion_clip_tpu_torch.diffusion.api import Diffusion
from guided_diffusion_clip_tpu_torch.models.unet import UNetConfig, UNetModel
from guided_diffusion_clip_tpu_torch.utils.script_util import (
    create_classifier,
    create_upstream_model,
    parse_yaml,
)
from torch_port_utils import clip_feat_pair, encoder_pair, nchw, nhwc, upstream_pair

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# 4 input blocks (stem, ResBlock, down, ResBlock): the default cut of 2 keeps
# the stem and the 16 px ResBlock shallow
UNET = dict(
    image_size=16, in_channels=3, model_channels=64, out_channels=6, num_res_blocks=1,
    attention_resolutions=(2,), channel_mult=(1, 2), num_classes=512,
    num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True,
)
CLASSIFIER = dict(
    image_size=16, in_channels=3, model_channels=64, out_channels=1000, num_res_blocks=1,
    attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=64,
    use_scale_shift_norm=True, resblock_updown=True,
)
B = 2
SHAPE_J, SHAPE_T = (B, 16, 16, 3), (B, 3, 16, 16)
FEAT = (np.random.RandomState(5).standard_normal((B, 512)) * 2).astype(np.float32)
LABELS = np.array([5, 871], np.int32)
NULL = {"clip_feat": 0.0}


class Counted:
    """A torch network whose calls are counted, with the batch of each."""

    def __init__(self, net):
        self.net, self.batches = net, []

    def __call__(self, x, *a, **kw):
        self.batches.append((x.shape[0], kw.get("cache_mode", "off")))
        return self.net(x, *a, **kw)

    @property
    def calls(self):
        return len(self.batches)


@functools.lru_cache(maxsize=None)
def _clip_pair():
    return clip_feat_pair(UNET, seed=3)


@functools.lru_cache(maxsize=None)
def _guided_pair():
    jm, params, tm = upstream_pair(dict(UNET, num_classes=1000), seed=1)
    jc, cparams, tc = encoder_pair(CLASSIFIER, "attention", seed=2)
    tc.requires_grad_(False)
    return jm, params, tm, jc, cparams, tc


def _x(seed, shape=SHAPE_J):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _schedules(respacing):
    return (JSch.build_schedule(steps=1000, timestep_respacing=respacing),
            TSch.build_schedule(steps=1000, timestep_respacing=respacing))


def _jax_step_noise(key, n):
    """The noise ``JS._scan_loop`` draws at each of its n steps, NCHW."""
    loop_rng, _ = jax.random.split(key, 2)
    return [nchw(np.array(JS._normal(k, SHAPE_J, jnp.float32))) for k in jax.random.split(loop_rng, n)]


def _close(ours_nchw, ref, tol):
    np.testing.assert_allclose(nhwc(ours_nchw), np.asarray(ref), rtol=tol, atol=tol)


def _close_feature(ours_nchw, ref, tol):
    """For an inner activation, whose values reach the tens with these random
    weights: ``tol`` of the tensor's largest value, as absolute error."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(nhwc(ours_nchw), ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


# --- the UNet's cache modes ------------------------------------------------


@pytest.mark.parametrize("cut", [0, 3, 4])
def test_unet_cache_modes_match(cut):
    """``full`` returns the plain output and the deep feature, ``shallow`` fed
    that feature reproduces the output; cut 0 is ``num_res_blocks + 1`` = 2,
    cut 4 = every input block (the deep feature is the middle block's)."""
    jm, params, tm = _clip_pair()
    x, t = _x(1), np.array([17, 733], np.int32)
    kw_j = dict(clip_feat=jnp.asarray(FEAT), cache_cut=cut)
    ref_full, ref_deep = jax.jit(lambda xx: jm.apply(
        {"params": params}, xx, jnp.asarray(t), cache_mode="full", **kw_j))(jnp.asarray(x))
    # another x with the first's deep feature: the shallow blocks do run
    x2 = _x(2)
    ref_shallow, _ = jax.jit(lambda xx, d: jm.apply(
        {"params": params}, xx, jnp.asarray(t), deep_cache=d, cache_mode="shallow", **kw_j))(jnp.asarray(x2), ref_deep)
    kw_t = dict(clip_feat=torch.from_numpy(FEAT), cache_cut=cut)
    tt = torch.from_numpy(t)
    with torch.inference_mode():
        full, deep = tm(nchw(x), tt, cache_mode="full", **kw_t)
        shallow, deep_back = tm(nchw(x2), tt, deep_cache=deep, cache_mode="shallow", **kw_t)
        off = tm(nchw(x), tt, clip_feat=kw_t["clip_feat"])
        again, _ = tm(nchw(x), tt, deep_cache=deep, cache_mode="shallow", **kw_t)
    assert deep_back is deep
    _close(full, ref_full, 1e-4)
    _close_feature(deep, ref_deep, 1e-4)
    _close(shallow, ref_shallow, 1e-4)
    assert np.abs(np.asarray(ref_shallow) - np.asarray(ref_full)).max() > 1e-2
    torch.testing.assert_close(full, off, rtol=0, atol=0)
    torch.testing.assert_close(again, off, rtol=1e-5, atol=1e-5)
    assert tuple(deep.shape) == TD.deep_feature_shape(tm.config, B, cut)


def test_unet_cache_mode_asserts():
    _, _, tm = _clip_pair()
    x, t, feat = nchw(_x(1)), torch.tensor([1, 2]), torch.from_numpy(FEAT)
    with torch.inference_mode():
        with pytest.raises(AssertionError, match="deep_cache must be given"):
            tm(x, t, clip_feat=feat, cache_mode="shallow")
        with pytest.raises(AssertionError, match="deep_cache must be given"):
            tm(x, t, clip_feat=feat, cache_mode="full", deep_cache=x)
        with pytest.raises(AssertionError):
            tm(x, t, clip_feat=feat, cache_mode="full", cache_cut=5)
        with pytest.raises(AssertionError):
            tm(x, t, clip_feat=feat, cache_mode="half")


@pytest.mark.parametrize("cut", [0, 1, 3, 5, 9])
def test_zero_state_shape_by_arithmetic(cut):
    """``zero_state`` finds the deep feature's shape from the plan alone; a
    three-level UNet with two ResBlocks a level and conv resampling checks it
    against a real ``full`` forward, bf16 torso included."""
    cfg = UNetConfig(
        image_size=16, in_channels=3, model_channels=32, out_channels=6, num_res_blocks=2,
        attention_resolutions=(4,), channel_mult=(1, 2, 3), num_heads=1, resblock_updown=cut % 2 == 1,
    )
    tm = UNetModel(cfg, dtype=torch.bfloat16).eval()
    with torch.inference_mode():
        _, deep = tm(torch.zeros(3, 3, 16, 16), torch.zeros(3, dtype=torch.long), cache_mode="full", cache_cut=cut)
    step, zeros = TD.zero_state(cfg, 3, cut, dtype=tm.dtype)
    assert step == 0 and zeros.shape == deep.shape and zeros.dtype == deep.dtype == torch.bfloat16
    assert not zeros.any()


# --- DeepCache through a chain ---------------------------------------------


def test_ddim_chain_with_deep_cache_matches():
    """6 DDIM steps at eta 0 with ``deep_cache 3``: full forwards on steps 0
    and 3, shallow ones in between."""
    jm, params, tm = _clip_pair()
    x_T = _x(4)
    js, ts = _schedules("ddim6")

    def j_full(x, t, **kw):
        return jm.apply({"params": params}, x, t, cache_mode="full", **kw)

    def j_shallow(x, t, deep, **kw):
        return jm.apply({"params": params}, x, t, deep_cache=deep, cache_mode="shallow", **kw)

    def run(n):
        kw = {"clip_feat": jnp.asarray(FEAT)}
        state0 = JD.zero_state(j_full, n, jnp.zeros((B,), jnp.int32), **kw)
        return JS.ddim_sample_loop(js, JD.deep_cache_model_fn(j_full, j_shallow, 3), n.shape, jax.random.key(0),
                                   noise=n, model_kwargs=kw, model_state0=state0)

    ref = jax.jit(run)(jnp.asarray(x_T))
    net = Counted(tm)
    fn = TD.deep_cache_model_fn(
        functools.partial(net, cache_mode="full"),
        lambda x, t, deep, **kw: net(x, t, deep_cache=deep, cache_mode="shallow", **kw), 3)
    with torch.inference_mode():
        ours = TS.ddim_sample_loop(ts, fn, SHAPE_T, None, noise=nchw(x_T),
                                   model_kwargs={"clip_feat": torch.from_numpy(FEAT)},
                                   model_state0=TD.zero_state(tm.config, B))
        plain = TS.ddim_sample_loop(ts, tm, SHAPE_T, None, noise=nchw(x_T),
                                    model_kwargs={"clip_feat": torch.from_numpy(FEAT)})
    assert [m for _, m in net.batches] == ["full", "shallow", "shallow", "full", "shallow", "shallow"]
    assert (ours - plain).abs().max() > 1e-3  # the cache does change the chain
    _close(ours, ref, 5e-4)


def test_stateful_model_fn_must_be_called_once_a_step():
    ts = TSch.build_schedule(steps=100, timestep_respacing="3")
    out = torch.zeros(1, 6, 4, 4)

    def twice(x, t, state, **kw):
        return out, state

    def step_calling_twice(sched, mf, img, t, rng, **kw):
        mf(img, t)
        return mf(img, t)[:, :3], img

    with pytest.raises(AssertionError, match="one call per step"):
        TS._loop(step_calling_twice, ts, twice, (1, 3, 4, 4), None, cfg=TS.SamplerConfig(), noise=torch.zeros(1, 3, 4, 4),
                 step_noise=None, init_image=None, cond_fn=None, denoised_fn=None, model_kwargs=None,
                 model_state0=(0, None))


# --- DPM-Solver++(2M), DDIM inversion, progressive loops ---------------------


def _guided_fns(scale=2.0):
    jm, params, tm, jc, cparams, tc = _guided_pair()
    jcond = JGd.classifier_cond_fn(lambda x, t: jc.apply({"params": cparams}, x, t), scale)
    jmodel = JGd.model_fn_dropping_y(lambda x, t, **kw: jm.apply({"params": params}, x, t, **kw), True)
    clf = Counted(tc)
    return jmodel, jcond, TGd.model_fn_dropping_y(tm, True), TGd.classifier_cond_fn(clf, scale), clf


@pytest.mark.parametrize("guided", [False, True], ids=["unguided", "guided"])
def test_dpm_solver_chain_matches(guided):
    """5 DPM-Solver++(2M) steps from the same x_T; guidance goes through
    ``condition_score``. The last step returns x0 itself, so the result is
    finite and, unguided, lies in [-1, 1] (clip_denoised; ``condition_score``
    re-derives x0 from the shifted eps without clipping)."""
    jmodel, jcond, tmodel, tcond, clf = _guided_fns()
    x_T = _x(6)
    js, ts = _schedules("5")
    ref = jax.jit(lambda n: JS.dpm_solver_pp_2m_loop(
        js, jmodel, n.shape, jax.random.key(0), noise=n, cond_fn=jcond if guided else None,
        model_kwargs={"y": jnp.asarray(LABELS)}))(jnp.asarray(x_T))
    with torch.no_grad():
        ours = TS.dpm_solver_pp_2m_loop(
            ts, tmodel, SHAPE_T, None, noise=nchw(x_T), cond_fn=tcond if guided else None,
            model_kwargs={"y": torch.from_numpy(LABELS).long()})
    assert clf.calls == (5 if guided else 0)
    assert torch.isfinite(ours).all() and (guided or ours.abs().max() <= 1.0)
    _close(ours, ref, 5e-4)


def test_dpm_solver_differs_from_ddim_and_is_deterministic():
    _, _, tm = _clip_pair()
    ts = TSch.build_schedule(steps=1000, timestep_respacing="5")
    kw = dict(noise=nchw(_x(7)), model_kwargs={"clip_feat": torch.from_numpy(FEAT)})
    with torch.inference_mode():
        a = TS.dpm_solver_pp_2m_loop(ts, tm, SHAPE_T, None, **kw)
        b = TS.dpm_solver_pp_2m_loop(ts, tm, SHAPE_T, None, **kw)
        ddim = TS.ddim_sample_loop(ts, tm, SHAPE_T, None, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - ddim).abs().max() > 1e-3


def test_ddim_reverse_loop_matches():
    """x_0 -> x_T over 5 steps through the UNet."""
    jm, params, tm = _clip_pair()
    x0 = np.tanh(_x(8))
    js, ts = _schedules("ddim5")
    ref = jax.jit(lambda x: JS.ddim_reverse_loop(
        js, lambda xx, t, **kw: jm.apply({"params": params}, xx, t, **kw), x,
        model_kwargs={"clip_feat": jnp.asarray(FEAT)}))(jnp.asarray(x0))
    with torch.inference_mode():
        ours = TS.ddim_reverse_loop(ts, tm, nchw(x0), model_kwargs={"clip_feat": torch.from_numpy(FEAT)})
    assert (ours - nchw(x0)).abs().max() > 0.1
    _close(ours, ref, 5e-4)


def _analytic_model():
    """A cheap model pair with the same x-dependent output in both layouts."""
    base = (np.random.RandomState(9).standard_normal((B, 16, 16, 6)) * 0.5).astype(np.float32)
    return (lambda x, t, **kw: jnp.asarray(base) + 0.1 * jnp.concatenate([x, x], -1),
            lambda x, t, **kw: nchw(base) + 0.1 * torch.cat([x, x], 1))


@pytest.mark.parametrize("which", ["ancestral", "ddim"])
def test_progressive_loops_return_the_jax_order(which):
    """``(final, (samples[T], pred_xstarts[T]))`` from the first step taken to
    the last; the last sample is the final one."""
    jf, tf = _analytic_model()
    js, ts = _schedules("4")
    x_T, key = _x(10), jax.random.key(13)
    jloop, tloop = ((JS.p_sample_loop_progressive, TS.p_sample_loop_progressive) if which == "ancestral"
                    else (JS.ddim_sample_loop_progressive, TS.ddim_sample_loop_progressive))
    ref, (ref_samples, ref_x0s) = jax.jit(lambda n: jloop(js, jf, n.shape, key, noise=n))(jnp.asarray(x_T))
    ours, (samples, x0s) = tloop(ts, tf, SHAPE_T, None, noise=nchw(x_T), step_noise=_jax_step_noise(key, 4))
    assert samples.shape == x0s.shape == (4, *SHAPE_T)
    torch.testing.assert_close(samples[-1], ours, rtol=0, atol=0)
    _close(ours, ref, 5e-4)
    for i in range(4):
        _close(samples[i], ref_samples[i], 5e-4)
        _close(x0s[i], ref_x0s[i], 5e-4)


def test_diffusion_handle_exposes_the_new_loops():
    """``Diffusion``'s methods hand their arguments to the functions."""
    _, tf = _analytic_model()
    ts = TSch.build_schedule(steps=1000, timestep_respacing="4")
    d = Diffusion(ts)
    x_T = nchw(_x(11))
    torch.testing.assert_close(
        d.dpm_solver_pp_2m_loop(tf, SHAPE_T, None, noise=x_T), TS.dpm_solver_pp_2m_loop(ts, tf, SHAPE_T, None, noise=x_T))
    torch.testing.assert_close(d.ddim_reverse_loop(tf, x_T.tanh()), TS.ddim_reverse_loop(ts, tf, x_T.tanh()))
    final, (samples, x0s) = d.ddim_sample_loop(tf, SHAPE_T, None, noise=x_T, progressive=True)
    torch.testing.assert_close(final, d.ddim_sample_loop(tf, SHAPE_T, None, noise=x_T))
    assert samples.shape == (4, *SHAPE_T) and x0s.shape == (4, *SHAPE_T)

    def stateful(x, t, state, **kw):
        return tf(x, t), state + 1

    assert torch.equal(d.p_sample_loop(stateful, SHAPE_T, None, noise=x_T, step_noise=[x_T] * 4, model_state0=0),
                       d.p_sample_loop(tf, SHAPE_T, None, noise=x_T, step_noise=[x_T] * 4))


# --- guidance interval and guidance cache ------------------------------------


@pytest.mark.parametrize("spec", ["", " ", "200,800", "0,0", "12.5,999", "5", "1,2,3", "800,200", "a,b"])
def test_parse_guidance_interval_matches(spec):
    try:
        want = JGd.parse_guidance_interval(spec)
    except ValueError:
        with pytest.raises(ValueError):
            TGd.parse_guidance_interval(spec)
        return
    assert TGd.parse_guidance_interval(spec) == want


def test_guided_ancestral_chain_with_interval_and_cache_matches():
    """6 guided ancestral steps, model timesteps 999, 799, 599, 400, 200, 0,
    with ``guidance_interval 200,800`` inside ``guidance_cache 2``: the cache's
    counter counts every step, so it refreshes on steps 0, 2 and 4; step 0 lies
    outside the window and caches zeros without running the classifier, steps
    2 and 4 run it, and step 5 (outside) recycles step 4's gradient."""
    jmodel, jcond, tmodel, tcond, clf = _guided_fns(scale=4.0)
    x_T, key = _x(12), jax.random.key(11)
    js, ts = _schedules("6")
    assert ts.timestep_map.tolist() == [0, 200, 400, 599, 799, 999]

    def run(n):
        cond, state0 = JGd.cached_cond_fn(JGd.interval_cond_fn(jcond, 200.0, 800.0), 2, n.shape)
        return JS.p_sample_loop(js, jmodel, n.shape, key, noise=n, cond_fn=cond, cond_state0=state0,
                                model_kwargs={"y": jnp.asarray(LABELS)})

    ref = jax.jit(run)(jnp.asarray(x_T))
    seen = []

    def watched(x, t, **kw):
        seen.append(t.host_t)
        return tcond(x, t, **kw)

    cond, state0 = TGd.cached_cond_fn(TGd.interval_cond_fn(watched, 200.0, 800.0), 2, SHAPE_T)
    kw = dict(noise=nchw(x_T), step_noise=_jax_step_noise(key, 6), model_kwargs={"y": torch.from_numpy(LABELS).long()})
    with torch.no_grad():
        ours = TS.p_sample_loop(ts, tmodel, SHAPE_T, None, cond_fn=cond, cond_state0=state0, **kw)
        always = TS.p_sample_loop(ts, tmodel, SHAPE_T, None, cond_fn=tcond, **kw)
    assert seen == [599, 200] and clf.calls == 2 + 6
    assert (ours - always).abs().max() > 1e-3
    _close(ours, ref, 5e-4)


def test_window_is_decided_on_the_host_when_the_loop_tags_t():
    """A ``t`` from ``chain_timesteps`` carries its Python value through
    ``model_timesteps``; the wrappers read that and not the tensor. A bare
    tensor is read back (element 0)."""
    ts = TSch.build_schedule(steps=1000, timestep_respacing="6")
    t = ts.chain_timesteps(3, 2, "cpu")
    assert t.tolist() == [3, 3] and t.host_t == 3
    tm = ts.model_timesteps(t)
    assert tm.tolist() == [599, 599] and tm.host_t == 599
    assert not hasattr(ts.model_timesteps(torch.tensor([3, 3])), "host_t")
    rescaled = TSch.build_schedule(steps=500, timestep_respacing="5", rescale_timesteps=True)
    assert rescaled.model_timesteps(rescaled.chain_timesteps(4, 1, "cpu")).host_t == pytest.approx(998.0)
    calls = []
    fn = TGd.interval_cond_fn(lambda x, t, **kw: calls.append(1) or torch.ones_like(x), 200.0, 800.0)
    x = torch.zeros(1, 3, 2, 2)
    lying = torch.tensor([500])
    lying.host_t = 900  # the tag wins: the tensor is not read
    assert not fn(x, lying).any() and not calls
    assert fn(x, torch.tensor([500])).all() and fn(x, torch.tensor([200.0])).all() and len(calls) == 2
    assert not fn(x, torch.tensor([801])).any() and len(calls) == 2


def test_cached_cond_fn_counts_every_step():
    calls = []

    def cond(x, t, **kw):
        calls.append(int(t[0]))
        return torch.full_like(x, float(t[0]))

    fn, state = TGd.cached_cond_fn(cond, 3, (1, 3, 2, 2))
    assert state[0] == 0 and not state[1].any()
    got = []
    for t in range(7):
        g, state = fn(torch.zeros(1, 3, 2, 2), torch.tensor([t]), state)
        got.append(float(g[0, 0, 0, 0]))
    assert calls == [0, 3, 6] and got == [0, 0, 0, 3, 3, 3, 6] and state[0] == 7


# --- classifier-free guidance -------------------------------------------------


def _jmodel_clip():
    jm, params, tm = _clip_pair()
    return (lambda x, t, **kw: jm.apply({"params": params}, x, t, **kw)), tm


@pytest.mark.parametrize("interval", [None, (200.0, 800.0)], ids=["always", "interval"])
def test_cfg_model_fn_matches(interval):
    """One doubled batch inside the window; outside it the plain batch only."""
    jmodel, tm = _jmodel_clip()
    net = Counted(tm)
    jfn = jax.jit(lambda x, t: JGd.cfg_model_fn(jmodel, 2.5, NULL, interval=interval)(x, t, clip_feat=jnp.asarray(FEAT)))
    tfn = TGd.cfg_model_fn(net, 2.5, NULL, interval=interval)
    x = _x(14)
    for t_model in (500, 900):
        ref = jfn(jnp.asarray(x), jnp.full((B,), t_model, jnp.int32))
        with torch.inference_mode():
            ours = tfn(nchw(x), torch.full((B,), t_model), clip_feat=torch.from_numpy(FEAT))
        _close(ours, ref, 1e-4)
    assert [b for b, _ in net.batches] == [2 * B, B if interval else 2 * B]
    with torch.inference_mode():
        cond_only = tm(nchw(x), torch.full((B,), 500), clip_feat=torch.from_numpy(FEAT))
        guided = tfn(nchw(x), torch.full((B,), 500), clip_feat=torch.from_numpy(FEAT))
    assert (guided[:, :3] - cond_only[:, :3]).abs().max() > 1e-3
    torch.testing.assert_close(guided[:, 3:], cond_only[:, 3:], rtol=1e-5, atol=1e-5)  # the variance passes through


@pytest.mark.parametrize("interval", [None, (200.0, 800.0)], ids=["always", "interval"])
def test_cfg_cached_model_fn_matches(interval):
    """Five steps at model timesteps 900, 700, 500, 300, 100 with ``every`` 2.
    Without a window the unconditional branch refreshes on steps 0, 2, 4 (8
    calls); with the window 200-800 its counter moves only inside, so it
    refreshes at 700 and 300 and nothing but the conditional call runs at 900
    and 100 (7 calls). The state's output stays f32."""
    jmodel, tm = _jmodel_clip()
    net = Counted(tm)
    jfn = JGd.cfg_cached_model_fn(jmodel, 2.5, NULL, 2, interval=interval)
    jstep = jax.jit(lambda x, t, state: jfn(x, t, state, clip_feat=jnp.asarray(FEAT)))
    tfn = TGd.cfg_cached_model_fn(net, 2.5, NULL, 2, interval=interval)
    x = _x(15)
    jstate = JGd.cfg_cached_state0(jmodel, jnp.asarray(x), jnp.zeros((B,), jnp.int32), clip_feat=jnp.asarray(FEAT))
    tstate = TGd.cfg_cached_state0((B, 6, 16, 16))
    assert tuple(jstate[1].shape) == (B, 16, 16, 6) and tstate[1].dtype == torch.float32
    for i, t_model in enumerate((900, 700, 500, 300, 100)):
        xi = x * (1.0 - 0.1 * i)
        ref, jstate = jstep(jnp.asarray(xi), jnp.full((B,), t_model, jnp.int32), jstate)
        with torch.inference_mode():
            ours, tstate = tfn(nchw(xi), torch.full((B,), t_model), tstate, clip_feat=torch.from_numpy(FEAT))
        _close(ours, ref, 1e-4)
        assert tstate[0] == int(jstate[0]) and tstate[1].dtype == torch.float32
        _close(tstate[1], jstate[1], 1e-4)
    assert net.calls == (7 if interval else 8) and all(b == B for b, _ in net.batches)
    assert tstate[0] == (3 if interval else 5)


def test_cfg_deep_cache_pair_matches():
    """CFG composed with DeepCache: both branches in one doubled batch, the
    cached deep feature 2B rows; a full step then a shallow one."""
    jm, params, tm = _clip_pair()
    net = Counted(tm)
    j_full, j_shallow = JD.cfg_deep_cache_pair(lambda x, t, **kw: jm.apply({"params": params}, x, t, **kw), 2.5, NULL)
    t_full, t_shallow = TD.cfg_deep_cache_pair(net, 2.5, NULL)
    x, x2 = _x(16), _x(17)
    tj = jnp.full((B,), 500, jnp.int32)
    ref, ref_deep = jax.jit(lambda xx: j_full(xx, tj, clip_feat=jnp.asarray(FEAT)))(jnp.asarray(x))
    ref2, _ = jax.jit(lambda xx, d: j_shallow(xx, tj, d, clip_feat=jnp.asarray(FEAT)))(jnp.asarray(x2), ref_deep)
    with torch.inference_mode():
        tt = torch.full((B,), 500)
        ours, deep = t_full(nchw(x), tt, clip_feat=torch.from_numpy(FEAT))
        ours2, deep_back = t_shallow(nchw(x2), tt, deep, clip_feat=torch.from_numpy(FEAT))
    assert deep.shape[0] == 2 * B and deep_back is deep
    assert tuple(deep.shape) == TD.deep_feature_shape(tm.config, 2 * B)
    assert net.batches == [(2 * B, "full"), (2 * B, "shallow")]
    _close(ours, ref, 1e-4)
    _close_feature(deep, ref_deep, 1e-4)
    _close(ours2, ref2, 1e-4)


def test_null_merge_and_cfg_double():
    kw = {"clip_feat": torch.ones(2, 4), "low_res": torch.full((2, 1), 3.0), "y": None}
    merged = TGd._null_merge(kw, {"clip_feat": 0.0})
    assert not merged["clip_feat"].any() and merged["clip_feat"].shape == (2, 4)
    assert merged["low_res"] is kw["low_res"] and merged["y"] is None
    x2, t2, kw2 = TGd.cfg_double(torch.zeros(2, 3, 2, 2), torch.tensor([7, 7]), kw, {"clip_feat": 0.0})
    assert x2.shape[0] == 4 and t2.tolist() == [7] * 4 and kw2["y"] is None
    assert kw2["clip_feat"][:2].all() and not kw2["clip_feat"][2:].any()
    assert (kw2["low_res"] == 3.0).all() and kw2["low_res"].shape == (4, 1)
    out2 = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6, 1, 1)
    got = TGd.cfg_combine(out2, 3.0, 3)
    want_eps = out2[2:, :3] + 3.0 * (out2[:2, :3] - out2[2:, :3])
    torch.testing.assert_close(got, torch.cat([want_eps, out2[:2, 3:]], 1))


# --- the entry points with the preset's flags -------------------------------

CLI_UNET = dict(
    image_size=64, num_channels=64, num_res_blocks=1, attention_resolutions="16,8",
    num_head_channels=64, resblock_updown=True, use_scale_shift_norm=True,
    learn_sigma=True, class_cond=True,
)
CLI_CLASSIFIER = dict(
    image_size=64, classifier_use_fp16=True, classifier_width=64, classifier_depth=1,
    classifier_attention_resolutions="32,16,8", classifier_use_scale_shift_norm=True,
    classifier_resblock_updown=True, classifier_pool="attention",
)
PRESET_KNOBS = {"conv_impl": "int8", "deep_cache": 5, "guidance_cache": 2, "guidance_interval": "200,800"}


def _random_pt(model, path, seed):
    g = torch.Generator().manual_seed(seed)
    torch.save({k: torch.randn(v.shape, generator=g) * 0.02 for k, v in model.state_dict().items()}, path)


def _cli_argv(tmp_path, *extra):
    argv = [
        "--device", "cpu", "--model_path", str(tmp_path / "model.pt"),
        "--classifier_path", str(tmp_path / "classifier.pt"), "--use_fp16", "True",
        "--batch_size", "2", "--num_samples", "2", "--classifier_scale", "10.0", "--seed", "7", *extra,
    ]
    for k, v in {**CLI_UNET, **CLI_CLASSIFIER}.items():
        argv += [f"--{k}", str(v)]
    return argv


def test_deploy_preset_file_parses_and_is_not_refused():
    """``configs/deploy256_fast.yaml`` overlays its knobs onto the CLI's
    arguments and none of them is refused any more."""
    args = CS.create_argparser().parse_args(["--config-file", os.path.join(REPO, "configs", "deploy256_fast.yaml")])
    args = parse_yaml(args)
    assert {k: getattr(args, k) for k in PRESET_KNOBS} == PRESET_KNOBS
    assert (args.image_size, args.num_channels, args.timestep_respacing) == (256, 256, "250")
    CS._refuse_unported(args)
    assert TGd.parse_guidance_interval(args.guidance_interval) == (200.0, 800.0)


def test_classifier_sample_cli_with_the_preset_knobs(tmp_path):
    """The preset's four knobs from a config file (the preset's own keys at a
    64 px model) over 12 ancestral steps: DeepCache refreshes on steps 0, 5
    and 10, and the classifier runs on the even steps inside the window."""
    import yaml

    _random_pt(create_upstream_model(**CLI_UNET), tmp_path / "model.pt", 0)
    _random_pt(create_classifier(**CLI_CLASSIFIER), tmp_path / "classifier.pt", 1)
    with open(os.path.join(REPO, "configs", "deploy256_fast.yaml")) as f:
        preset = yaml.safe_load(f)
    assert {k: preset[k] for k in PRESET_KNOBS} == PRESET_KNOBS
    config = tmp_path / "preset64.yaml"
    config.write_text(yaml.safe_dump({**{k: preset[k] for k in PRESET_KNOBS}, "timestep_respacing": "12"}))
    argv = _cli_argv(tmp_path, "--config-file", str(config), "--main_path", str(tmp_path / "runs"))
    out = CS.main(argv)
    tmap = TSch.build_schedule(steps=1000, timestep_respacing="12").timestep_map.tolist()
    inside_even = sum(1 for i in range(12) if i % 2 == 0 and 200 <= tmap[11 - i] <= 800)
    assert 0 < inside_even < 6
    assert out["steps"] == 12 and out["calls"] == {"unet_full": 3, "unet_shallow": 9, "classifier": inside_even}
    images = np.load(out["path"])["arr_0"]
    assert images.shape == (2, 64, 64, 3) and images.dtype == np.uint8 and all(images[i].std() > 0 for i in range(2))
    np.testing.assert_array_equal(np.load(CS.main(argv)["path"])["arr_0"], images)


def test_classifier_sample_cli_with_dpm_solver_and_all_knobs(tmp_path):
    """``--sampler dpm++2m`` takes the guidance and both caches."""
    _random_pt(create_upstream_model(**CLI_UNET), tmp_path / "model.pt", 0)
    _random_pt(create_classifier(**CLI_CLASSIFIER), tmp_path / "classifier.pt", 1)
    out = CS.main(_cli_argv(
        tmp_path, "--sampler", "dpm++2m", "--timestep_respacing", "4", "--deep_cache", "2", "--deep_cache_cut", "3",
        "--guidance_cache", "3", "--main_path", str(tmp_path / "runs")))
    assert out["calls"] == {"unet_full": 2, "unet_shallow": 2, "classifier": 2}
    images = np.load(out["path"])["arr_0"]
    assert images.shape == (2, 64, 64, 3) and all(images[i].std() > 0 for i in range(2))


SERVE_TINY = [
    "--image_size", "16", "--num_channels", "32", "--num_res_blocks", "1",
    "--channel_mult", "1,2", "--attention_resolutions", "8", "--num_heads", "1",
    "--use_scale_shift_norm", "True", "--resblock_updown", "True",
    "--learn_sigma", "True", "--class_cond", "True", "--noise_schedule", "linear",
    "--diffusion_steps", "1000", "--timestep_respacing", "6", "--batch_size", "2", "--device", "cpu",
]


@pytest.fixture(scope="module")
def serve_ckpt(tmp_path_factory):
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_model

    path = tmp_path_factory.mktemp("knobs") / "model.pt"
    model = create_model(16, 32, 1, channel_mult="1,2", learn_sigma=True, class_cond=True,
                         attention_resolutions="8", num_heads=1, use_scale_shift_norm=True, resblock_updown=True)
    _random_pt(model, path, 3)
    return str(path)


@pytest.mark.parametrize("flags,forwards", [
    (["--cfg_scale", "2.0", "--cfg_cache", "2", "--sampler", "dpm++2m"], 6 + 3),
    (["--cfg_scale", "2.0", "--cfg_cache", "2", "--guidance_interval", "200,800"], 6 + 2),
    (["--cfg_scale", "2.0", "--guidance_interval", "200,800", "--use_ddim", "True"], 6),
    (["--deep_cache", "3", "--sampler", "dpm++2m"], 6),
])
def test_serve_with_the_cfg_and_cache_flags(serve_ckpt, flags, forwards):
    """The server's sampler with the CFG and cache flags together: 6 steps at
    model timesteps 999, 799, 599, 400, 200, 0. ``--cfg_cache 2`` adds a
    refresh on steps 0, 2, 4, or with the window on the first and third step
    inside it; the same request gives the same bytes."""
    sampler = serve.Sampler(serve.parse_args([*SERVE_TINY, *flags, "--model_path", serve_ckpt]))
    try:
        cond = (np.random.RandomState(0).randn(2, 512) * 4).astype(np.float32)
        out = sampler.sample(2, seed=3, cond=cond)
        assert out.shape == (2, 16, 16, 3) and out.dtype == np.uint8 and out.std() > 0
        assert sampler.forwards == forwards
        np.testing.assert_array_equal(sampler.sample(2, seed=3, cond=cond), out)
    finally:
        sampler.close()
