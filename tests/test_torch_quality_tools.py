"""The quality tools of the port (``guided_diffusion_clip_tpu_torch/tools/``:
``fidelity``, ``_proxies``, ``int8_chain_quality``, ``guidance_quality_sweep``,
``opt_long_horizon``) against the JAX tools on the CPU, in float32.

The blob data and the class-matched real sets equal the JAX tools' bit for
bit. The feature net, with flax params drawn from a numpy seed carried
across, is within 1e-5 of flax's at 16 and 32 px (SAME pads an even size by
(0, 1)); one AdamW step of its optimizer, and of the noised classifier's (t
and the noise handed to both), within 1e-5 relative L2 of optax's. The
Frechet distance and ``score_sets`` equal the evaluator's and the JAX
tool's within 1e-6 relative, and the port's own extractor passes
``tests/test_fidelity_metric.py``'s power check. Each study chain, at 16 px
over 4 respaced ancestral steps with the noise JAX draws handed over, is
within 5e-4 of the JAX tool's composition (``base``, ``dc2``, ``gc2``,
``cfgc2`` and a ``guidance_quality_sweep`` point with a window and a cache),
each JAX chain one jitted program (op by op it took 3-5x longer). The int8 variant is held by its models, not by a free-running
chain. Two steps of ``tree``, ``flat`` and ``zero1`` (a one-rank gloo group)
agree within 1e-6. Each ``main()`` runs on ``--device cpu`` at tiny sizes and
prints the JAX tool's keys plus ``card``; ``--device cuda`` without a card
exits non-zero.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from evaluations.evaluator import statistics_from_activations
from guided_diffusion_clip_tpu.diffusion import deep_cache as JD
from guided_diffusion_clip_tpu.diffusion import guidance as JGd
from guided_diffusion_clip_tpu.diffusion import sampling as JS
from guided_diffusion_clip_tpu.models.clip_models import UNetModel_clip_feat as JaxClipFeat
from guided_diffusion_clip_tpu.models.unet import EncoderUNetModel as JaxEncoder
from guided_diffusion_clip_tpu.models.unet import UNetConfig as JaxConfig
from guided_diffusion_clip_tpu.models.unet import UNetModel as JaxUNet
from guided_diffusion_clip_tpu.utils.script_util import create_gaussian_diffusion as j_diffusion
from guided_diffusion_clip_tpu_torch.parallel import dist as pdist
from guided_diffusion_clip_tpu_torch.tools import _proxies as P
from guided_diffusion_clip_tpu_torch.tools import fidelity as F
from guided_diffusion_clip_tpu_torch.tools import guidance_quality_sweep as gqs
from guided_diffusion_clip_tpu_torch.tools import int8_chain_quality as icq
from guided_diffusion_clip_tpu_torch.tools import opt_long_horizon as olh
from guided_diffusion_clip_tpu_torch.utils.convert import state_dict_from_flax
from guided_diffusion_clip_tpu_torch.utils.script_util import create_gaussian_diffusion
from tools import fidelity as JF
from tools import guidance_quality_sweep as JGQS
from torch_port_utils import nchw, nhwc, random_params

torch.set_num_threads(2)

B, SIZE = 2, 16
SHAPE_J = (B, SIZE, SIZE, 3)
TOL = 5e-4


def rel_l2(ours: dict, ref: dict) -> float:
    num = sum(float(((ours[k].double() - ref[k].double()) ** 2).sum()) for k in ref)
    den = sum(float((ref[k].double() ** 2).sum()) for k in ref)
    return (num / den) ** 0.5


# --- the blob data -------------------------------------------------------------


@pytest.mark.parametrize("size", [16, 33])
def test_blob_batch_and_real_sets_match_the_jax_tools(size):
    """``make_blob_batch`` (images and latents, then the next draws from the
    same stream) and ``class_matched_real_set`` give the JAX tools' bytes;
    the labels and conditioning rows come from the NHWC arrays."""
    ours, theirs = np.random.RandomState(4), np.random.RandomState(4)
    for _ in range(2):
        a, la = F.make_blob_batch(ours, 5, size, return_latents=True)
        b, lb = JF.make_blob_batch(theirs, 5, size, return_latents=True)
        assert a.dtype == b.dtype and np.array_equal(a, b) and np.array_equal(la, lb)
    assert np.array_equal(F.make_blob_batch(ours, 3, size, s_lo=0.15, s_hi=0.35),
                          JF.make_blob_batch(theirs, 3, size, s_lo=0.15, s_hi=0.35))
    real = P.class_matched_real_set(1000 + 97, 7, size)
    assert np.array_equal(real, JGQS.class_matched_real_set(1000 + 97, 7, size))
    assert np.array_equal(P.blob_labels(real), np.arange(7) % 3)
    assert np.array_equal(P.blob_labels(real), JGQS.blob_labels(real))
    x, cond = next(P.blob_stream(np.random.RandomState(0), 4, size, clip_feat=True))
    want = JF.make_blob_batch(np.random.RandomState(0), 4, size)
    assert np.array_equal(x, want.transpose(0, 3, 1, 2))
    rows = np.random.RandomState(7).randn(3, 16).astype(np.float32)
    assert np.array_equal(cond["clip_feat"], rows[want.mean(axis=(1, 2)).argmax(axis=-1)])


# --- the feature net and its optimizer ------------------------------------------


@functools.lru_cache(maxsize=None)
def flax_feature_params(size):
    net = JF._feat_net()
    shapes = jax.eval_shape(lambda: net.init(jax.random.key(0), jnp.zeros((1, size, size, 3))))["params"]
    return net, random_params(shapes, 11)


@pytest.mark.parametrize("size", [16, 32])
def test_feature_net_matches_flax(size):
    """The forward with flax's params carried across: features and the
    regressed parameters within 1e-5 of flax's (SAME at stride 2 pads an
    even size by (0, 1))."""
    net, params = flax_feature_params(size)
    x = JF.make_blob_batch(np.random.RandomState(3), 4, size)
    f_ref, p_ref = (np.asarray(a) for a in net.apply({"params": params}, jnp.asarray(x)))
    tn = F.BlobFeatureNet()
    tn.load_state_dict(F.state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        f, p = (a.numpy() for a in tn(F.nchw(x, "cpu")))
    assert F.same_pads(size) == (0, 1) and F.same_pads(size + 1) == (1, 1)
    for ours, ref in ((f, f_ref), (p, p_ref)):
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_feature_optimizer_step_matches_optax():
    """One step of ``train_feature_extractor``'s optimizer (AdamW at optax
    ``adamw(1e-3)``'s settings) on the regression loss, from the same params
    and batch: within 1e-5 relative L2 of optax's."""
    net, params = flax_feature_params(SIZE)
    x, y = JF.make_blob_batch(np.random.RandomState(5), 8, SIZE, return_latents=True)
    opt = optax.adamw(1e-3)

    def loss_fn(p):
        return ((net.apply({"params": p}, jnp.asarray(x))[1] - jnp.asarray(y)) ** 2).mean()

    @jax.jit
    def step(p):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, _ = opt.update(grads, opt.init(p), p)
        return loss, optax.apply_updates(p, updates)

    loss, new = step(params)
    want = F.state_dict_from_flax(jax.device_get(new))
    tn = F.BlobFeatureNet()
    tn.load_state_dict(F.state_dict_from_flax(params), strict=True)
    topt = F.feature_optimizer(tn, "cpu")
    ours = F.regression_loss(tn, F.nchw(x, "cpu"), torch.from_numpy(y))
    ours.backward()
    topt.step()
    assert abs(float(ours) - float(loss)) <= 1e-5 * float(loss)
    start = F.state_dict_from_flax(params)
    assert rel_l2(want, start) > 1e-4  # the step moves the weights
    assert rel_l2(tn.state_dict(), want) <= 1e-5


def test_classifier_step_matches_optax():
    """One step of the noised classifier (``_proxies.classifier_step``:
    q_sample at t with the noise given, the cross-entropy of the labels,
    AdamW 3e-4 with weight decay 0.05) against optax ``adamw(3e-4,
    weight_decay=0.05)`` on the JAX tools' loss: within 1e-5 relative L2."""
    jc = JaxEncoder(JaxConfig(**dataclasses.asdict(P.classifier_config(SIZE))), pool="adaptive")
    shapes = jax.eval_shape(lambda: jc.init(jax.random.key(2), jnp.zeros(SHAPE_J), jnp.zeros((B,))))["params"]
    params = random_params(shapes, 12)
    xb = JF.make_blob_batch(np.random.RandomState(6), 4, SIZE)
    y = P.blob_labels(xb)
    rs = np.random.RandomState(7)
    t = np.array([3, 40, 77, 99])
    noise = rs.standard_normal(xb.shape).astype(np.float32)
    jd = j_diffusion(steps=100, noise_schedule="cosine")
    opt = optax.adamw(3e-4, weight_decay=0.05)

    def loss_fn(p):
        xt = jd.q_sample(jnp.asarray(xb), jnp.asarray(t), jnp.asarray(noise))
        ll = jax.nn.log_softmax(jc.apply({"params": p}, xt, jnp.asarray(t, jnp.float32)), axis=-1)
        return -jnp.take_along_axis(ll, jnp.asarray(y)[:, None], axis=-1).mean()

    @jax.jit
    def step(p):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, _ = opt.update(grads, opt.init(p), p)
        return loss, optax.apply_updates(p, updates)

    loss, new = step(params)
    to_sd = functools.partial(state_dict_from_flax, model="encoder", pool="adaptive")
    want = to_sd(jax.device_get(new))
    clf = P.build_classifier(SIZE)
    clf.load_state_dict(to_sd(params), strict=True)
    td = create_gaussian_diffusion(steps=100, noise_schedule="cosine")
    ours = P.classifier_step(clf, P.classifier_optimizer(clf), td, torch.from_numpy(P.to_nchw(xb)),
                             torch.from_numpy(y), torch.from_numpy(t), nchw(noise))
    assert abs(float(ours) - float(loss)) <= 1e-5 * float(loss)
    assert rel_l2(want, to_sd(params)) > 1e-5
    assert rel_l2(clf.state_dict(), want) <= 1e-5


# --- the scores ------------------------------------------------------------------


def test_frechet_and_score_sets_match_the_evaluator():
    """``frechet`` against the evaluator's statistics, and ``score_sets``
    against the JAX tool's on the same features, within 1e-6 relative;
    every key the same."""
    rs = np.random.RandomState(8)
    fx = rs.standard_normal((64, 32))
    fy = (rs.standard_normal((64, 32)) * 1.2 + 0.3).astype(np.float32)
    want = statistics_from_activations(fx).frechet_distance(statistics_from_activations(fy))
    assert abs(F.frechet(fx, fy) - want) <= 1e-6 * abs(want)
    proj = rs.standard_normal((SIZE * SIZE * 3, 32)).astype(np.float32)

    def feats(x):
        return np.tanh(x.reshape(len(x), -1) @ proj / 8)

    draw = functools.partial(JF.make_blob_batch, n=48, size=SIZE)
    sets = {"base_a": draw(np.random.RandomState(100)), "base_b": draw(np.random.RandomState(500)),
            "base_c": draw(np.random.RandomState(900)), "shifted": draw(np.random.RandomState(1), s_lo=0.15,
                                                                           s_hi=0.35)}
    ours, ref = F.score_sets(feats, sets), JF.score_sets(feats, sets)
    assert ours.keys() == ref.keys() and ours["shifted"].keys() == ref["shifted"].keys()
    for k in ("mean", "max"):
        assert abs(ours["floor"][k] - ref["floor"][k]) <= 1e-6 * abs(ref["floor"][k])
    for a, b in zip(ours["floor"]["values"], ref["floor"]["values"]):
        assert abs(a - b) <= 1e-6 * abs(b)
    for k, v in ref["shifted"].items():
        assert abs(ours["shifted"][k] - v) <= 1e-6 * abs(v), k


def test_own_extractor_passes_the_power_check():
    """``tests/test_fidelity_metric.py``'s check on the port's own trained
    extractor: loss < 0.15 after 150 steps, a shifted distribution more
    than 2x the floor's max, an independent same-distribution draw under 2x."""
    feats_fn, loss = F.train_feature_extractor(SIZE, steps=150, batch=64, seed=5)
    assert loss < 0.15, loss

    def draw(seed, **kw):
        return F.make_blob_batch(np.random.RandomState(seed), 64, SIZE, **kw)

    scores = F.score_sets(feats_fn, {"base_a": draw(100), "base_b": draw(500), "base_c": draw(900),
                                     "same_dist": draw(1300), "shifted": draw(1700, s_lo=0.15, s_hi=0.35)})
    floor_max = scores["floor"]["max"]
    assert floor_max > 0
    assert scores["shifted"]["mean"] > 2.0 * floor_max, scores
    assert scores["same_dist"]["mean"] < 2.0 * floor_max, scores


# --- the chains against the JAX tools' compositions ---------------------------------


def jax_pair(cfg, model_cls, seed, **init_kw):
    jm = model_cls(JaxConfig(**dataclasses.asdict(cfg)))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros(SHAPE_J), jnp.zeros((B,)), **init_kw))
    return jm, random_params(shapes["params"], seed)


@functools.lru_cache(maxsize=None)
def proxies():
    """(JAX generator, params, JAX classifier, cparams, the port's sampling
    copies: generator and classifier), 16 px, float32; and the clip_feat pair."""
    cfg = P.generator_config(SIZE)
    jm, params = jax_pair(cfg, JaxUNet, 0)
    jc = JaxEncoder(JaxConfig(**dataclasses.asdict(P.classifier_config(SIZE))), pool="adaptive")
    cshapes = jax.eval_shape(lambda: jc.init(jax.random.key(2), jnp.zeros(SHAPE_J), jnp.zeros((B,))))["params"]
    cparams = random_params(cshapes, 1)
    tm = P.sampling_copy(cfg, state_dict_from_flax(params), "cpu")
    tc = P.build_classifier(SIZE)
    tc.load_state_dict(state_dict_from_flax(cparams, model="encoder", pool="adaptive"), strict=True)
    ccfg = P.generator_config(SIZE, clip_feat=True)
    jf = JaxClipFeat(JaxConfig(**dataclasses.asdict(ccfg)))
    fshapes = jax.eval_shape(lambda: jf.init(jax.random.key(0), jnp.zeros(SHAPE_J), jnp.zeros((B,)),
                                             clip_feat=jnp.zeros((B, 16))))["params"]
    fparams = random_params(fshapes, 3)
    tf = P.sampling_copy(ccfg, state_dict_from_flax(fparams), "cpu")
    return jm, params, jc, cparams, tm, tc.eval().requires_grad_(False), jf, fparams, tf


def step_noise(key, n):
    """The noise the JAX loop draws at each of its n steps (its
    ``_split(rng, 2)`` then ``_split(rng, n)``), NCHW."""
    loop_rng, _ = jax.random.split(key, 2)
    return [nchw(np.asarray(JS._normal(k, SHAPE_J, jnp.float32))) for k in jax.random.split(loop_rng, n)]


def study(**over):
    s = dict(batch=B, size=SIZE, sampler="ancestral", dc=0, gc=0, cfgc=0, guide_scale=10.0, cfg_scale=3.0)
    s.update(over)
    return s


def j_sched():
    return j_diffusion(steps=100, noise_schedule="cosine", timestep_respacing="4")


def t_sched():
    return create_gaussian_diffusion(steps=100, noise_schedule="cosine", timestep_respacing="4")


@pytest.mark.parametrize("variant", ["base", "dc2", "gc2", "dc2+gc2", "cfgc2"])
def test_study_chain_matches_the_jax_composition(variant):
    """``int8_chain_quality.make_chain`` against the JAX tool's
    ``make_chain`` over 4 respaced ancestral steps from the same x_T and step
    noise: ``base`` unguided, ``dc2`` DeepCache on it, ``gc2`` the guided
    study's cached chain (scale 10, labels 0, 1), ``dc2+gc2`` both,
    ``cfgc2`` the cached-unconditional CFG chain (scale 3). Within 5e-4; the
    networks' calls as the caches say."""
    jm, params, jc, cparams, tm, tc, jf, fparams, tf = proxies()
    parts = variant.split("+")
    dc = 2 if "dc2" in parts else 0
    gc = 2 if "gc2" in parts else 0
    cfgc = 2 if "cfgc2" in parts else 0
    s = study(dc=dc, gc=gc, cfgc=cfgc)
    key, x_t = jax.random.key(100), np.random.RandomState(9).standard_normal(SHAPE_J).astype(np.float32)
    y = jnp.arange(B, dtype=jnp.int32) % 3
    jd = j_sched()
    if cfgc:
        feats = jnp.asarray(P.FEAT_ROWS[np.arange(B) % 3])

        def base_fn(x, t, **kw):
            return jf.apply({"params": fparams}, x, t, **kw)

        sfn = JGd.cfg_cached_model_fn(base_fn, 3.0, {"clip_feat": 0.0}, 2)
        state0 = JGd.cfg_cached_state0(base_fn, jnp.zeros(SHAPE_J), jnp.zeros((B,), jnp.int32), clip_feat=feats)
        ref = jax.jit(lambda n: jd.p_sample_loop(sfn, SHAPE_J, key, noise=n, model_kwargs={"clip_feat": feats},
                                                 model_state0=state0))(jnp.asarray(x_t))
        chain = icq.make_chain(s, t_sched(), tf, variant=True)
    else:
        def strip(kw):
            return {k: v for k, v in kw.items() if k != "y"}

        model_state0 = None
        if dc:
            def apply_full(x, t, **kw):
                return jm.apply({"params": params}, x, t, cache_mode="full", **strip(kw))

            def apply_shallow(x, t, deep, **kw):
                return jm.apply({"params": params}, x, t, deep_cache=deep, cache_mode="shallow", **strip(kw))

            model_fn = JD.deep_cache_model_fn(apply_full, apply_shallow, 2)
            model_state0 = JD.zero_state(apply_full, jnp.zeros(SHAPE_J), jnp.zeros((B,), jnp.int32))
        else:
            def model_fn(x, t, **kw):
                return jm.apply({"params": params}, x, t, **strip(kw))

        kw = {}
        if gc:
            cond = JGd.classifier_cond_fn(lambda x, t: jc.apply({"params": cparams}, x, t), 10.0)
            cond_fn, cond_state0 = JGd.cached_cond_fn(cond, 2, SHAPE_J)
            kw = dict(model_kwargs={"y": y}, cond_fn=cond_fn, cond_state0=cond_state0)
        ref = jax.jit(lambda n: jd.p_sample_loop(model_fn, SHAPE_J, key, noise=n, model_state0=model_state0,
                                                 **kw))(jnp.asarray(x_t))
        chain = icq.make_chain(s, t_sched(), tm, tc if gc else None, variant=True)
    ours = chain(noise=nchw(x_t), step_noise=step_noise(key, 4))
    want_calls = {"unet_full": 4 + (2 if cfgc else 0), "unet_shallow": 0, "classifier": 2 if gc else 0}
    if dc:
        want_calls.update(unet_full=2, unet_shallow=2)
    assert chain.calls == want_calls
    assert torch.isfinite(ours).all()
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), rtol=TOL, atol=TOL)


def test_sweep_point_chain_matches_the_jax_composition():
    """A ``guidance_quality_sweep`` point with a window and a cache
    (``20:80:gc2``: model timesteps 99, 66, 33, 0; the cache refreshes on
    steps 0 and 2, and only step 2's timestep lies in the window, so the
    classifier runs once) against the JAX tool's ``make_chain``: within 5e-4."""
    jm, params, jc, cparams, tm, tc, *_ = proxies()
    ((interval, gc),) = gqs.parse_sweep("20:80:gc2")
    key, x_t = jax.random.key(100), np.random.RandomState(10).standard_normal(SHAPE_J).astype(np.float32)
    y = jnp.arange(B, dtype=jnp.int32) % 3

    def model_fn(x, t, **kw):
        return jm.apply({"params": params}, x, t, **{k: v for k, v in kw.items() if k != "y"})

    cond = JGd.interval_cond_fn(JGd.classifier_cond_fn(lambda x, t: jc.apply({"params": cparams}, x, t), 10.0),
                                *interval)
    cond, cond_state0 = JGd.cached_cond_fn(cond, gc, SHAPE_J)
    ref = jax.jit(lambda n: j_sched().p_sample_loop(model_fn, SHAPE_J, key, noise=n, model_kwargs={"y": y},
                                                    cond_fn=cond, cond_state0=cond_state0))(jnp.asarray(x_t))
    td = t_sched()
    chain = gqs.point_chain(td, tm, tc, torch.arange(B) % 3, interval, gc, 10.0)
    ours = chain(noise=nchw(x_t), step_noise=step_noise(key, 4))
    assert td.sched.timestep_map.tolist() == [0, 33, 66, 99]
    assert chain.calls == {"unet_full": 4, "unet_shallow": 0, "classifier": 1}
    unguided = gqs.point_chain(td, tm, None, torch.arange(B) % 3, None, 1, 0.0)(noise=nchw(x_t),
                                                                                 step_noise=step_noise(key, 4))
    assert (ours - unguided).abs().max() > 1e-4  # the guidance acts
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), rtol=TOL, atol=TOL)


def test_int8_variant_runs_the_int8_models():
    """The int8 variant is held by its models: the sampling copy built with
    ``conv_impl="int8"`` is the port's int8 UNet on the same weights (the
    same output), and differs from the xla copy; the classifier's int8 copy
    likewise."""
    from guided_diffusion_clip_tpu_torch.models.unet import EncoderUNetModel, UNetModel

    _, params, _, _, tm, tc, *_ = proxies()
    sd = state_dict_from_flax(params)
    cfg = P.generator_config(SIZE)
    variant = P.sampling_copy(cfg, sd, "cpu", "int8")
    ref = UNetModel(cfg, conv_impl="int8").eval()
    ref.load_state_dict(sd, strict=True)
    x = nchw(np.random.RandomState(11).standard_normal(SHAPE_J).astype(np.float32))
    t = torch.tensor([50.0, 90.0])
    with torch.no_grad():
        out, want, plain = variant(x, t), ref(x, t), tm(x, t)
    assert variant.int8 and torch.equal(out, want) and (out - plain).abs().max() > 0
    clf = P.classifier_copy(tc, "int8")
    cref = EncoderUNetModel(P.classifier_config(SIZE), pool="adaptive", conv_impl="int8").eval()
    cref.load_state_dict(tc.state_dict(), strict=True)
    with torch.no_grad():
        assert clf.int8 and torch.equal(clf(x, t), cref(x, t)) and (clf(x, t) - tc(x, t)).abs().max() > 0


# --- the helpers ---------------------------------------------------------------------


@pytest.mark.parametrize("spec", [gqs.DEFAULT_SWEEP, "off", "gc3", "off:gc2", ":gc2", "100:900", "0:700:gc1",
                                  " 200:800:gc2 , off:gc4", ""])
def test_parse_sweep_matches_the_jax_tool(spec):
    assert gqs.parse_sweep(spec) == JGQS.parse_sweep(spec)


def test_snapshot_is_a_copy_of_the_ema():
    """The positive control's snapshot after step 1 is a clone: three more
    steps move the EMA and leave the snapshot where it was (a reference
    would follow the in-place EMA to the end)."""
    from guided_diffusion_clip_tpu_torch.utils import logger

    logger.configure_dir(format_strs=[])
    torch.manual_seed(0)
    cfg = P.generator_config(SIZE)
    model = P.build_generator(cfg)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    loop, snap, curve = P.train_generator(model, create_gaussian_diffusion(steps=100, noise_schedule="cosine"),
                                          P.blob_stream(np.random.RandomState(0), B, SIZE), B, 4, snapshot_at=1)
    final = P.ema_values(loop)
    snap = dict(zip(loop.names, snap))
    assert curve == []
    assert rel_l2(snap, start) > 0 and rel_l2(final, snap) > 1e-4


# --- opt_long_horizon ---------------------------------------------------------------


def test_tree_flat_zero1_agree_over_two_steps(tmp_path):
    """Two steps of the 16 px proxy under ``tree``, ``flat`` and ``zero1``
    (one rank on gloo, the group destroyed after) from the same weights and
    data: losses and updated weights within 1e-6, as ``tests/test_opt_flat.py``
    holds the JAX layouts; then ``compare``'s keys are the JAX tool's."""
    from guided_diffusion_clip_tpu_torch.utils import logger

    logger.configure_dir(dir=str(tmp_path), format_strs=[])
    torch.manual_seed(0)
    init = P.build_generator(P.generator_config(SIZE)).state_dict()
    curves, weights = {}, {}
    with pdist.one_rank_group("cpu"):
        assert pdist.is_initialized() and pdist.world_size() == 1
        for impl in ("tree", "flat", "zero1"):
            model = P.build_generator(P.generator_config(SIZE))
            model.load_state_dict(init, strict=True)
            loop, _, curve = P.train_generator(
                model, create_gaussian_diffusion(steps=100, noise_schedule="cosine"),
                P.blob_stream(np.random.RandomState(0), B, SIZE), B, 2, losses=True, opt_impl=impl, weight_decay=0.01)
            curves[impl], weights[impl] = np.asarray(curve), {n: p.detach().clone() for n, p in zip(loop.names,
                                                                                                  loop.params)}
    assert not pdist.is_initialized()
    assert rel_l2(weights["tree"], init) > 1e-4
    for impl in ("flat", "zero1"):
        np.testing.assert_allclose(curves[impl], curves["tree"], rtol=1e-6, atol=1e-8)
        for n, w in weights["tree"].items():
            np.testing.assert_allclose(weights[impl][n].numpy(), w.numpy(), rtol=1e-6, atol=1e-8, err_msg=n)
    row = olh.compare({k: np.concatenate([v, v, v]) for k, v in curves.items()}, ["tree", "flat", "zero1"], 6, 16, B)
    assert set(row) == JAX_KEYS["olh"]


# --- the entry points ---------------------------------------------------------------------

TINY = {  # 8 px; 36 samples a set: a 32-d covariance of fewer is singular, and sqrtm refuses it as the evaluator's does
    "icq": {"INT8Q_IMAGE": "8", "INT8Q_TRAIN_STEPS": "2", "INT8Q_SAMPLES": "36", "INT8Q_BATCH": "36",
            "INT8Q_RESPACING": "3", "INT8Q_FEAT_STEPS": "2", "INT8Q_VARIANT": "int8+dc2+gc2"},
    "icq_cfgc": {"INT8Q_IMAGE": "8", "INT8Q_TRAIN_STEPS": "2", "INT8Q_SAMPLES": "36", "INT8Q_BATCH": "36",
                 "INT8Q_RESPACING": "ddim3", "INT8Q_SAMPLER": "ddim", "INT8Q_FEAT_STEPS": "2", "INT8Q_VARIANT": "cfgc2"},
    "gqs": {"GQS_IMAGE": "8", "GQS_TRAIN_STEPS": "2", "GQS_SAMPLES": "36", "GQS_BATCH": "36",
            "GQS_DIFFUSION_STEPS": "100", "GQS_RESPACING": "3", "GQS_FEAT_STEPS": "2", "GQS_SWEEP": "off:gc1,0:50:gc2"},
    "olh": {"OLH_STEPS": "3", "OLH_BATCH": "2"},
}
TOOLS = {"icq": icq, "icq_cfgc": icq, "gqs": gqs, "olh": olh}
# the keys of the JAX tools' JSON lines: tools/int8_chain_quality.py:431-448,
# tools/guidance_quality_sweep.py:257-306, tools/opt_long_horizon.py:86-109 (at OLH_IMPLS tree,flat,zero1)
_ICQ = {"config", "variant", "same_seed_pixel_corr_mean", "same_seed_pixel_corr_min", "same_seed_rel_rmse_mean",
        "same_seed_rel_rmse_max", "set_frechet", "feat_extractor_final_loss", "posctrl_separated",
        "variant_within_floor", "wall_s"}
JAX_KEYS = {
    "icq": _ICQ, "icq_cfgc": _ICQ,
    "gqs": {"config", "feat_extractor_final_loss", "floor_real_vs_real", "sweep", "unguided_frechet_to_real_mean",
            "unguided_classifier_acc", "wall_s"},
    "olh": {"config", "impls", "tree_final_third_loss_mean", "tree_step_noise_sd",
            *(f"{i}_{k}" for i in ("flat", "zero1") for k in ("final_third_loss_mean", "mean_abs_delta_vs_tree",
                                                               "delta_over_step_noise", "mean_diff_in_sems"))},
}


@pytest.mark.parametrize("tool", sorted(TINY))
def test_main_on_cpu(tool, monkeypatch, capsys):
    """Each ``main()`` on ``--device cpu`` at tiny sizes: one JSON line with
    the JAX tool's keys plus ``card`` ("cpu"), finite numbers, the nested
    rows' keys as the JAX tool's."""
    for k, v in TINY[tool].items():
        monkeypatch.setenv(k, v)
    row = TOOLS[tool].main(["--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert json.loads(lines[-1]) == json.loads(json.dumps(row))
    assert set(row) == JAX_KEYS[tool] | {"card"} and row["card"] == "cpu"
    if tool.startswith("icq"):
        assert set(row["set_frechet"]) == {"floor", "variant", "undertrained_posctrl"}
        assert set(row["set_frechet"]["variant"]) == {"vs_b", "vs_c", "mean", "over_floor_max"}
        assert np.isfinite(row["same_seed_pixel_corr_mean"]) and row["variant"] == TINY[tool]["INT8Q_VARIANT"]
    if tool == "gqs":
        assert [r["point"] for r in row["sweep"]] == ["off:gc1", "0:50:gc2"]
        assert all(set(r) == {"point", "frechet_to_real", "frechet_to_real_mean", "over_floor_max",
                              "classifier_acc_on_samples"} for r in row["sweep"])
    if tool == "olh":
        assert row["impls"] == ["tree", "flat", "zero1"] and not pdist.is_initialized()


@pytest.mark.parametrize("tool", ["icq", "gqs", "olh"])
def test_main_refuses_a_missing_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as exc:
        TOOLS[tool].main(["--device", "cuda"])
    assert exc.value.code not in (0, None)
