"""The port's schedules, p_mean_variance and sampling steps against the JAX
package, from the same inputs (and, for random steps, the same noise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guided_diffusion_clip_tpu.diffusion import gaussian as JG
from guided_diffusion_clip_tpu.diffusion import sampling as JS
from guided_diffusion_clip_tpu.diffusion import schedules as JSch
from guided_diffusion_clip_tpu_torch.diffusion import gaussian as TG
from guided_diffusion_clip_tpu_torch.diffusion import sampling as TS
from guided_diffusion_clip_tpu_torch.diffusion import schedules as TSch
from torch_port_utils import clip_feat_pair, nchw, nhwc

torch.set_num_threads(2)

TABLES = [f.name for f in __import__("dataclasses").fields(TSch.DiffusionSchedule)
          if f.name not in ("timestep_map", "original_num_steps", "rescale_timesteps")]


@pytest.mark.parametrize("name", ["linear", "cosine"])
def test_named_tables_f64(name):
    np.testing.assert_array_equal(
        TSch.get_named_beta_schedule(name, 1000), JSch.get_named_beta_schedule(name, 1000)
    )
    betas = JSch.get_named_beta_schedule(name, 1000)
    ours, theirs = TSch._tables_from_betas(betas), JSch._tables_from_betas(betas)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == np.float64
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


@pytest.mark.parametrize(
    "steps,schedule,respacing",
    [(1000, "linear", ""), (1000, "linear", "ddim25"), (1000, "cosine", "10"),
     (1000, "cosine", "10,5,3"), (200, "cosine", "lambda12")],
)
def test_built_schedule_matches(steps, schedule, respacing):
    ours = TSch.build_schedule(steps=steps, noise_schedule=schedule, timestep_respacing=respacing)
    theirs = JSch.build_schedule(steps=steps, noise_schedule=schedule, timestep_respacing=respacing)
    assert ours.num_timesteps == theirs.num_timesteps
    assert ours.original_num_steps == theirs.original_num_steps
    np.testing.assert_array_equal(ours.timestep_map.numpy(), np.asarray(theirs.timestep_map))
    for k in TABLES:
        a = getattr(ours, k)
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(theirs, k)), err_msg=k)
    if respacing and not respacing.startswith("lambda"):
        assert TSch.space_timesteps(steps, respacing) == JSch.space_timesteps(steps, respacing)


def _fixed_model(out_nhwc):
    """model_fn pairs returning the same (x-dependent) output in both layouts."""
    def jax_fn(x, t, **kw):
        return jnp.asarray(out_nhwc) + 0.1 * jnp.concatenate([x] * (out_nhwc.shape[-1] // x.shape[-1]), -1)

    def torch_fn(x, t, **kw):
        return nchw(out_nhwc) + 0.1 * torch.cat([x] * (out_nhwc.shape[-1] // x.shape[1]), 1)

    return jax_fn, torch_fn


@pytest.mark.parametrize("mean_type", list(JSch.ModelMeanType))
@pytest.mark.parametrize("var_type", list(JSch.ModelVarType))
def test_p_mean_variance(mean_type, var_type):
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, 4, 4, 3)).astype(np.float32)
    learned = var_type in (JSch.ModelVarType.LEARNED, JSch.ModelVarType.LEARNED_RANGE)
    out = (rs.standard_normal((2, 4, 4, 6 if learned else 3)) * 0.5).astype(np.float32)
    jf, tf = _fixed_model(out)
    t = np.array([3, 17], np.int32)
    js = JSch.build_schedule(steps=100, noise_schedule="cosine", timestep_respacing="25")
    ts = TSch.build_schedule(steps=100, noise_schedule="cosine", timestep_respacing="25")
    kw = dict(mean_type=mean_type, var_type=var_type, clip_denoised=True)
    ref = JG.p_mean_variance(js, jf, jnp.asarray(x), jnp.asarray(t), **kw)
    ours = TG.p_mean_variance(
        ts, tf, nchw(x), torch.from_numpy(t).long(),
        mean_type=TSch.ModelMeanType(mean_type.value), var_type=TSch.ModelVarType(var_type.value),
        clip_denoised=True,
    )
    for field in ref._fields:
        r = np.broadcast_to(np.asarray(getattr(ref, field)), x.shape)
        o = getattr(ours, field).expand(2, 3, 4, 4)
        np.testing.assert_allclose(nhwc(o), r, rtol=2e-5, atol=2e-5, err_msg=field)


def test_q_sample_matches():
    rs = np.random.RandomState(1)
    x0, noise = (rs.standard_normal((2, 4, 4, 3)).astype(np.float32) for _ in range(2))
    t = np.array([0, 999], np.int32)
    js = JSch.build_schedule(steps=1000)
    ts = TSch.build_schedule(steps=1000)
    ref = np.asarray(JG.q_sample(js, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)))
    ours = nhwc(TG.q_sample(ts, nchw(x0), torch.from_numpy(t).long(), nchw(noise)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


SLICE = dict(
    image_size=16, in_channels=3, model_channels=64, out_channels=6, num_res_blocks=1,
    attention_resolutions=(2, 4), channel_mult=(1, 1, 2), num_classes=512,
    num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True,
)


def _model_fns(seed=0):
    jm, params, tm = clip_feat_pair(SLICE, seed)
    feat = np.random.RandomState(5).standard_normal((2, 512)).astype(np.float32)

    def jf(x, t, **kw):
        return jm.apply({"params": params}, x, t, clip_feat=jnp.asarray(feat))

    def tf(x, t, **kw):
        return tm(x, t, clip_feat=torch.from_numpy(feat))

    return jf, tf


def test_ddim_chain_eta0_matches():
    """5 DDIM steps at eta 0 from the same injected x_T, through the UNet."""
    jf, tf = _model_fns()
    x_T = np.random.RandomState(2).standard_normal((2, 16, 16, 3)).astype(np.float32)
    js = JSch.build_schedule(steps=1000, timestep_respacing="ddim5")
    ts = TSch.build_schedule(steps=1000, timestep_respacing="ddim5")
    ref = jax.jit(
        lambda n: JS.ddim_sample_loop(js, jf, n.shape, jax.random.key(0), noise=n)
    )(jnp.asarray(x_T))
    with torch.inference_mode():
        ours = TS.ddim_sample_loop(ts, tf, (2, 3, 16, 16), None, noise=nchw(x_T))
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), rtol=5e-4, atol=5e-4)


def test_ancestral_step_matches_with_jax_noise():
    """One p_sample_step from the same x and t; the port is given the noise
    JAX's sampling._normal draws for that step."""
    jf, tf = _model_fns(seed=1)
    x = np.random.RandomState(3).standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([10, 10], np.int32)
    js = JSch.build_schedule(steps=1000, timestep_respacing="25")
    ts = TSch.build_schedule(steps=1000, timestep_respacing="25")
    key = jax.random.key(7)
    cfg = JS.SamplerConfig()
    ref, _ = jax.jit(lambda xx: JS.p_sample_step(js, jf, xx, jnp.asarray(t), key, cfg=cfg))(jnp.asarray(x))
    noise = np.asarray(JS._normal(key, x.shape, jnp.float32))
    with torch.inference_mode():
        ours, _ = TS.p_sample_step(
            ts, tf, nchw(x), torch.from_numpy(t).long(), None, cfg=TS.SamplerConfig(), noise=nchw(noise)
        )
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), rtol=5e-4, atol=5e-4)


def test_per_sample_rng_is_independent_of_the_batch():
    """Sample i's chain depends only on its own generator: the same
    (seed, subidx) alone, first or second in a batch gives the same bits."""
    ts = TSch.build_schedule(steps=100, noise_schedule="cosine", timestep_respacing="5")

    def model(x, t, **kw):  # per-sample, learned-range output
        return torch.cat([torch.tanh(x), torch.sin(x)], 1)

    def run(seeds, subidx):
        gens = TS.sample_generators(seeds, subidx, "cpu")
        return TS.p_sample_loop(ts, model, (len(seeds), 3, 8, 8), gens)

    both = run([4, 9], [0, 1])
    torch.testing.assert_close(run([9], [1])[0], both[1], rtol=0, atol=0)
    torch.testing.assert_close(run([4, 4], [0, 7])[0], both[0], rtol=0, atol=0)
    assert not torch.equal(run([5], [0])[0], both[0])
    assert TS.sample_seed(4, 0) != TS.sample_seed(5, 0)
    assert TS.sample_seed(4, 0) & 0xFFFFFFFF != TS.sample_seed(5, 0) & 0xFFFFFFFF
