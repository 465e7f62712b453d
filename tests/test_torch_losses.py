"""The port's diffusion losses and bpd against the JAX package's, f32 on the CPU.

The same inputs (NHWC for JAX, NCHW for the port) and the same noise: for the
bpd loop, JAX's ``fold_in(rng, t)`` draws are given to the port as ``noise``.
The model is the same function of (x_t, t) in both layouts. Tolerance 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guided_diffusion_clip_tpu.diffusion import gaussian as JG
from guided_diffusion_clip_tpu.diffusion import losses as JL
from guided_diffusion_clip_tpu.diffusion import schedules as JSch
from guided_diffusion_clip_tpu_torch.diffusion import Diffusion
from guided_diffusion_clip_tpu_torch.diffusion import gaussian as TG
from guided_diffusion_clip_tpu_torch.diffusion import losses as TL
from guided_diffusion_clip_tpu_torch.diffusion import schedules as TSch
from torch_port_utils import nchw, nhwc

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
B, H, C = 4, 8, 3


def _pair(steps=20):
    return (TSch.build_schedule(steps=steps, noise_schedule="cosine"),
            JSch.build_schedule(steps=steps, noise_schedule="cosine"))


def _models(tsched, jsched, x0, mean_type, learned: bool, seed=0):
    """(jax model_fn, torch model_fn): a near-oracle of the schedule, as a
    trained model would be (x_0 within 0.02, predicted in ``mean_type``'s
    terms from x_t and t), with random variance channels when ``learned``.
    Far from the truth the discretized likelihood's bin mass underflows, and
    its logarithm is no longer a well-conditioned function of f32 inputs."""
    rs = np.random.RandomState(seed)
    xhat = (x0 + 0.02 * rs.standard_normal(x0.shape)).astype(np.float32)
    var = np.tanh(rs.standard_normal(x0.shape)).astype(np.float32)

    def fn(sched, x, t, xh, v, cat, extract):
        if mean_type == "EPSILON":
            out = (extract(sched.sqrt_recip_alphas_cumprod, t) * x - xh) / extract(sched.sqrt_recipm1_alphas_cumprod, t)
        elif mean_type == "START_X":
            out = xh
        else:
            out = extract(sched.posterior_mean_coef1, t) * xh + extract(sched.posterior_mean_coef2, t) * x
        return cat([out, v]) if learned else out

    def jax_fn(x, t, **kw):
        return fn(jsched, x, t, jnp.asarray(xhat), jnp.asarray(var), lambda a: jnp.concatenate(a, -1),
                  lambda tab, t: tab[t][:, None, None, None])

    def torch_fn(x, t, **kw):
        return fn(tsched, x, t, nchw(xhat), nchw(var), lambda a: torch.cat(a, 1),
                  lambda tab, t: tab[t][:, None, None, None])

    return jax_fn, torch_fn


def _data(seed=1):
    rs = np.random.RandomState(seed)
    x0 = rs.uniform(-1, 1, (B, H, H, C)).astype(np.float32)
    x0[0, 0, 0] = [-1.0, 1.0, 0.0]  # the open bins of the decoder likelihood
    noise = rs.standard_normal((B, H, H, C)).astype(np.float32)
    return x0, noise


@pytest.mark.parametrize("fn", ["normal_kl", "approx_standard_normal_cdf", "discretized_gaussian_log_likelihood",
                                "mean_flat"])
def test_loss_primitives(fn):
    rs = np.random.RandomState(3)
    a, b, c, d = (rs.standard_normal((B, H, H, C)).astype(np.float32) for _ in range(4))
    if fn == "normal_kl":
        ref, ours = JL.normal_kl(a, b, c, d), TL.normal_kl(*map(torch.from_numpy, (a, b, c, d)))
    elif fn == "approx_standard_normal_cdf":
        ref, ours = JL.approx_standard_normal_cdf(3 * a), TL.approx_standard_normal_cdf(torch.from_numpy(3 * a))
    elif fn == "discretized_gaussian_log_likelihood":
        # means near x, scales of a late step: where the bin's CDF difference is well conditioned in f32
        x = np.clip(a, -1, 1)
        means, log_scales = x + 0.05 * b, -2.0 + 0.1 * c
        ref = JL.discretized_gaussian_log_likelihood(x, means=means, log_scales=log_scales)
        ours = TL.discretized_gaussian_log_likelihood(torch.from_numpy(x), means=torch.from_numpy(means),
                                                      log_scales=torch.from_numpy(log_scales))
    else:
        ref, ours = JL.mean_flat(a), TL.mean_flat(nchw(a))  # every axis but the first, in either layout
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("var_type", ["FIXED_SMALL", "FIXED_LARGE", "LEARNED_RANGE"])
@pytest.mark.parametrize("mean_type", ["EPSILON", "START_X", "PREVIOUS_X"])
@pytest.mark.parametrize("loss_type", ["MSE", "RESCALED_MSE", "KL", "RESCALED_KL"])
def test_training_losses(loss_type, mean_type, var_type):
    tsched, jsched = _pair()
    x0, noise = _data()
    jax_fn, torch_fn = _models(tsched, jsched, x0, mean_type, var_type == "LEARNED_RANGE")
    t = np.array([0, 3, 10, 19], np.int32)
    enums = dict(mean_type=getattr(JSch.ModelMeanType, mean_type), var_type=getattr(JSch.ModelVarType, var_type),
                 loss_type=getattr(JSch.LossType, loss_type))
    ref = JG.training_losses(jsched, jax_fn, x_start=jnp.asarray(x0), t=jnp.asarray(t), noise=jnp.asarray(noise),
                             **enums)
    diffusion = Diffusion(tsched, **{k: getattr(TSch, type(v).__name__)[v.name] for k, v in enums.items()})
    ours = diffusion.training_losses(torch_fn, nchw(x0), torch.from_numpy(t).long(), nchw(noise))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].shape == (B,)
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), err_msg=k, **TOL)


def test_learned_sigma_freezes_the_mean():
    """The vb term's gradient reaches only the variance channels; the mse
    term's only the mean channels (the stop-gradient at gaussian.py:288-293)."""
    tsched, _ = _pair()
    x0, noise = _data()
    out = torch.randn(B, 2 * C, H, H, requires_grad=True)
    terms = TG.training_losses(tsched, lambda *a, **k: out, x_start=nchw(x0), t=torch.tensor([0, 3, 10, 19]),
                               noise=nchw(noise), loss_type=TSch.LossType.MSE)
    (g_vb,) = torch.autograd.grad(terms["vb"].sum(), out, retain_graph=True)
    (g_mse,) = torch.autograd.grad(terms["mse"].sum(), out)
    assert torch.count_nonzero(g_vb[:, :C]) == 0 and torch.count_nonzero(g_vb[:, C:]) > 0
    assert torch.count_nonzero(g_mse[:, C:]) == 0 and torch.count_nonzero(g_mse[:, :C]) > 0


@pytest.mark.parametrize("mean_type,var_type,clip", [
    ("EPSILON", "LEARNED_RANGE", True), ("EPSILON", "FIXED_LARGE", False), ("START_X", "FIXED_SMALL", True),
])
def test_calc_bpd_loop(mean_type, var_type, clip):
    """A 4-step chain, every t, with JAX's fold_in draws given as the noise."""
    tsched, jsched = _pair(steps=4)
    x0, _ = _data(seed=5)
    jax_fn, torch_fn = _models(tsched, jsched, x0, mean_type, var_type == "LEARNED_RANGE", seed=4)
    key = jax.random.key(7)
    enums = dict(mean_type=getattr(JSch.ModelMeanType, mean_type), var_type=getattr(JSch.ModelVarType, var_type))
    ref = JG.calc_bpd_loop(jsched, jax_fn, x_start=jnp.asarray(x0), rng=key, clip_denoised=clip, **enums)
    noise = [nchw(np.asarray(jax.random.normal(jax.random.fold_in(key, t), x0.shape))) for t in range(4)]
    diffusion = Diffusion(tsched, **{k: getattr(TSch, type(v).__name__)[v.name] for k, v in enums.items()})
    ours = diffusion.calc_bpd_loop(torch_fn, nchw(x0), noise=noise, clip_denoised=clip)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert tuple(ours[k].shape) == tuple(np.shape(ref[k])), k
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), err_msg=k, **TOL)
    # the same chain with the noise drawn from a generator runs and is finite
    drawn = diffusion.calc_bpd_loop(torch_fn, nchw(x0), torch.Generator().manual_seed(0), clip_denoised=clip)
    assert torch.isfinite(drawn["total_bpd"]).all()


def test_q_mean_variance_and_prior_bpd():
    tsched, jsched = _pair()
    x0, _ = _data(seed=6)
    t = np.array([0, 5, 12, 19], np.int32)
    ref = JG.q_mean_variance(jsched, jnp.asarray(x0), jnp.asarray(t))
    ours = TG.q_mean_variance(tsched, nchw(x0), torch.from_numpy(t).long())
    np.testing.assert_allclose(nhwc(ours[0]), np.asarray(ref[0]), **TOL)
    for a, b in zip(ours[1:], ref[1:]):
        np.testing.assert_allclose(a.reshape(-1).numpy(), np.asarray(b).reshape(-1), **TOL)
    np.testing.assert_allclose(TG.prior_bpd(tsched, nchw(x0)).numpy(),
                               np.asarray(JG.prior_bpd(jsched, jnp.asarray(x0))), **TOL)
