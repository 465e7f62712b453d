"""Gaussian diffusion q/p distributions as pure functions on tensors.

Counterpart of ``guided_diffusion_clip_tpu/diffusion/gaussian.py`` (reference
guided_diffusion/gaussian_diffusion.py:171-354): functions over a
``DiffusionSchedule`` plus a model callable ``model_fn(x, t_model, **kwargs)
-> raw output``.

Conventions: images are NCHW float32 in [-1, 1] (the model's logical layout);
``t`` is an integer [B] tensor indexing the (possibly respaced) schedule; the
model sees ``sched.model_timesteps(t)``. The learned-sigma split of the
losses is on the channel axis 1 (the JAX package's -1).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import torch

from .losses import discretized_gaussian_log_likelihood, mean_flat, normal_kl
from .schedules import DiffusionSchedule, LossType, ModelMeanType, ModelVarType


def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients, broadcastable over an ndim tensor."""
    out = table[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def q_mean_variance(sched: DiffusionSchedule, x_start, t):
    """Mean/var/logvar of q(x_t | x_0) (reference :171-186)."""
    nd = x_start.dim()
    mean = _extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
    variance = _extract(1.0 - sched.alphas_cumprod, t, nd)
    log_variance = _extract(sched.log_one_minus_alphas_cumprod, t, nd)
    return mean, variance, log_variance


def q_sample(sched: DiffusionSchedule, x_start, t, noise):
    """Diffuse x_0 for t steps (reference :188-206)."""
    nd = x_start.dim()
    return (
        _extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
        + _extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise
    )


def q_posterior_mean_variance(sched: DiffusionSchedule, x_start, x_t, t):
    """Mean/var/logvar of q(x_{t-1} | x_t, x_0) (reference :208-230)."""
    nd = x_t.dim()
    posterior_mean = (
        _extract(sched.posterior_mean_coef1, t, nd) * x_start
        + _extract(sched.posterior_mean_coef2, t, nd) * x_t
    )
    posterior_variance = _extract(sched.posterior_variance, t, nd)
    posterior_log_variance = _extract(sched.posterior_log_variance_clipped, t, nd)
    return posterior_mean, posterior_variance, posterior_log_variance


def predict_xstart_from_eps(sched: DiffusionSchedule, x_t, t, eps):
    """x_0 = sqrt(1/ab_t) x_t - sqrt(1/ab_t - 1) eps (reference :328-336)."""
    nd = x_t.dim()
    return (
        _extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
        - _extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * eps
    )


def predict_xstart_from_xprev(sched: DiffusionSchedule, x_t, t, xprev):
    """Invert the posterior mean for PREVIOUS_X models (reference :338-348)."""
    nd = x_t.dim()
    coef1 = _extract(sched.posterior_mean_coef1, t, nd)
    coef2 = _extract(sched.posterior_mean_coef2, t, nd)
    return xprev / coef1 - (coef2 / coef1) * x_t


def predict_eps_from_xstart(sched: DiffusionSchedule, x_t, t, pred_xstart):
    """eps implied by an x_0 prediction (reference :350-354)."""
    nd = x_t.dim()
    return (
        _extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart
    ) / _extract(sched.sqrt_recipm1_alphas_cumprod, t, nd)


class PMeanVariance(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor
    model_eps: torch.Tensor  # eps implied by the prediction


def p_mean_variance(
    sched: DiffusionSchedule,
    model_fn: Callable,
    x,
    t,
    *,
    mean_type: ModelMeanType = ModelMeanType.EPSILON,
    var_type: ModelVarType = ModelVarType.LEARNED_RANGE,
    clip_denoised: bool = True,
    denoised_fn: Callable | None = None,
    model_kwargs: dict | None = None,
) -> PMeanVariance:
    """Distribution p(x_{t-1} | x_t) from the model output (reference :232-326).

    LEARNED_RANGE interpolates the log-variance between
    posterior_log_variance_clipped and log(beta) with the model's second half
    of channels; FIXED_LARGE uses betas with the t=0 slot patched to
    posterior_variance[1].
    """
    model_kwargs = model_kwargs or {}
    nd = x.dim()
    C = x.shape[1]

    model_output = model_fn(x, sched.model_timesteps(t), **model_kwargs)

    if var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
        if model_output.shape[1] != 2 * C:
            raise ValueError(f"learned-variance model must output 2C channels, got {tuple(model_output.shape)}")
        model_output, model_var_values = model_output.split(C, dim=1)
        if var_type == ModelVarType.LEARNED:
            model_log_variance = model_var_values
        else:
            min_log = _extract(sched.posterior_log_variance_clipped, t, nd)
            max_log = _extract(torch.log(sched.betas), t, nd)
            frac = (model_var_values + 1.0) / 2.0
            model_log_variance = frac * max_log + (1.0 - frac) * min_log
        model_variance = torch.exp(model_log_variance)
    elif var_type == ModelVarType.FIXED_LARGE:
        model_log_variance = _extract(sched.log_fixed_large_variance, t, nd)
        model_variance = torch.exp(model_log_variance)
    elif var_type == ModelVarType.FIXED_SMALL:
        model_variance = _extract(sched.posterior_variance, t, nd)
        model_log_variance = _extract(sched.posterior_log_variance_clipped, t, nd)
    else:
        raise NotImplementedError(var_type)

    def process_xstart(x0):
        if denoised_fn is not None:
            x0 = denoised_fn(x0)
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        return x0

    if mean_type == ModelMeanType.PREVIOUS_X:
        pred_xstart = process_xstart(predict_xstart_from_xprev(sched, x, t, model_output))
        model_mean = model_output
    elif mean_type in (ModelMeanType.START_X, ModelMeanType.EPSILON):
        if mean_type == ModelMeanType.START_X:
            pred_xstart = process_xstart(model_output)
        else:
            pred_xstart = process_xstart(predict_xstart_from_eps(sched, x, t, model_output))
        model_mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    else:
        raise NotImplementedError(mean_type)

    model_eps = predict_eps_from_xstart(sched, x, t, pred_xstart)
    return PMeanVariance(model_mean, model_variance, model_log_variance, pred_xstart, model_eps)


def condition_mean(sched: DiffusionSchedule, cond_fn, out: PMeanVariance, x, t, model_kwargs=None):
    """Sohl-Dickstein conditioning: mean += variance * grad (reference :356-369)."""
    gradient = cond_fn(x, sched.model_timesteps(t), **(model_kwargs or {}))
    return out._replace(mean=out.mean + out.variance * gradient)


def condition_score(sched: DiffusionSchedule, cond_fn, out: PMeanVariance, x, t, model_kwargs=None):
    """Song et al. score conditioning: eps -= sqrt(1-ab_t) * grad (reference :371-393).

    Recomputes pred_xstart and the posterior mean from the shifted eps.
    """
    alpha_bar = _extract(sched.alphas_cumprod, t, x.dim())
    eps = predict_eps_from_xstart(sched, x, t, out.pred_xstart)
    gradient = cond_fn(x, sched.model_timesteps(t), **(model_kwargs or {}))
    eps = eps - torch.sqrt(1.0 - alpha_bar) * gradient
    pred_xstart = predict_xstart_from_eps(sched, x, t, eps)
    mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return out._replace(mean=mean, pred_xstart=pred_xstart, model_eps=eps)


# ---------------------------------------------------------------------------
# Losses and bpd (reference :718-902)
# ---------------------------------------------------------------------------

_LN2 = math.log(2.0)


def vb_terms_bpd(
    sched: DiffusionSchedule,
    model_fn: Callable,
    *,
    x_start,
    x_t,
    t,
    mean_type: ModelMeanType,
    var_type: ModelVarType,
    clip_denoised: bool = True,
    model_kwargs: dict | None = None,
):
    """Variational bound term at one timestep, in bits (reference :718-751):
    KL(q(x_{t-1}|x_t,x_0) || p(x_{t-1}|x_t)) / ln 2, except at t = 0, where it
    is the discretized decoder NLL."""
    true_mean, _, true_log_variance_clipped = q_posterior_mean_variance(sched, x_start, x_t, t)
    out = p_mean_variance(
        sched, model_fn, x_t, t,
        mean_type=mean_type, var_type=var_type,
        clip_denoised=clip_denoised, model_kwargs=model_kwargs,
    )
    kl = mean_flat(normal_kl(true_mean, true_log_variance_clipped, out.mean, out.log_variance)) / _LN2
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_start, means=out.mean, log_scales=0.5 * out.log_variance
    )
    decoder_nll = mean_flat(decoder_nll) / _LN2
    return {"output": torch.where(t == 0, decoder_nll, kl), "pred_xstart": out.pred_xstart}


def training_losses(
    sched: DiffusionSchedule,
    model_fn: Callable,
    *,
    x_start,
    t,
    noise,
    mean_type: ModelMeanType = ModelMeanType.EPSILON,
    var_type: ModelVarType = ModelVarType.LEARNED_RANGE,
    loss_type: LossType = LossType.RESCALED_MSE,
    model_kwargs: dict | None = None,
):
    """Per-example training losses (reference :753-826), each of shape [B].

    MSE variants: the target per ``mean_type``; a learned variance adds the vb
    term with the mean frozen (``detach``, reference :797), times T/1000 for
    RESCALED_MSE. KL variants: the vb term alone (times T for RESCALED_KL).
    Returns {"loss", and "mse"/"vb" where they exist}.
    """
    model_kwargs = model_kwargs or {}
    x_t = q_sample(sched, x_start, t, noise)
    terms = {}
    if loss_type.is_vb:
        out = vb_terms_bpd(
            sched, model_fn, x_start=x_start, x_t=x_t, t=t,
            mean_type=mean_type, var_type=var_type, clip_denoised=False, model_kwargs=model_kwargs,
        )
        terms["loss"] = out["output"]
        if loss_type == LossType.RESCALED_KL:
            terms["loss"] = terms["loss"] * sched.num_timesteps
    elif loss_type in (LossType.MSE, LossType.RESCALED_MSE):
        model_output = model_fn(x_t, sched.model_timesteps(t), **model_kwargs)
        if var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            C = x_t.shape[1]
            if model_output.shape[1] != 2 * C:
                raise ValueError(f"learned-variance model must output 2C channels, got {tuple(model_output.shape)}")
            model_output, model_var_values = model_output.split(C, dim=1)
            # the vb term learns the variance only: the mean it sees is frozen
            frozen_out = torch.cat([model_output.detach(), model_var_values], dim=1)
            terms["vb"] = vb_terms_bpd(
                sched, lambda *_a, **_k: frozen_out,
                x_start=x_start, x_t=x_t, t=t,
                mean_type=mean_type, var_type=var_type, clip_denoised=False,
            )["output"]
            if loss_type == LossType.RESCALED_MSE:
                terms["vb"] = terms["vb"] * sched.scale_loss_timestep_factor()
        if mean_type == ModelMeanType.PREVIOUS_X:
            target = q_posterior_mean_variance(sched, x_start, x_t, t)[0]
        elif mean_type == ModelMeanType.START_X:
            target = x_start
        else:
            target = noise
        if not model_output.shape == target.shape == x_start.shape:
            raise ValueError(f"model output {tuple(model_output.shape)} != target {tuple(target.shape)}")
        terms["mse"] = mean_flat((target - model_output) ** 2)
        terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
    else:
        raise NotImplementedError(loss_type)
    return terms


def prior_bpd(sched: DiffusionSchedule, x_start):
    """KL(q(x_T | x_0) || N(0, I)) in bits, per batch element (reference :828-844)."""
    t = torch.full((x_start.shape[0],), sched.num_timesteps - 1, dtype=torch.long, device=x_start.device)
    qt_mean, _, qt_log_variance = q_mean_variance(sched, x_start, t)
    return mean_flat(normal_kl(qt_mean, qt_log_variance, 0.0, 0.0)) / _LN2


def calc_bpd_loop(
    sched: DiffusionSchedule,
    model_fn: Callable,
    *,
    x_start,
    rng: torch.Generator | None = None,
    noise: Sequence[torch.Tensor] | None = None,
    mean_type: ModelMeanType = ModelMeanType.EPSILON,
    var_type: ModelVarType = ModelVarType.LEARNED_RANGE,
    clip_denoised: bool = True,
    model_kwargs: dict | None = None,
):
    """The whole chain's NLL, a loop over t = 0..T-1 (reference :846-902).

    Step t diffuses x_start with ``noise[t]`` when given (one tensor per t, in
    x_start's shape: the JAX package's ``fold_in(rng, t)`` draws, for tests),
    else with a draw from ``rng``. Returns [B] total_bpd and prior_bpd, and
    [B, T] vb, xstart_mse and mse, t ascending on axis 1.
    """
    B, T = x_start.shape[0], sched.num_timesteps
    if noise is not None and len(noise) != T:
        raise ValueError(f"{len(noise)} noise tensors for {T} timesteps")
    vb, xstart_mse, mse = [], [], []
    for t_scalar in range(T):
        t = torch.full((B,), t_scalar, dtype=torch.long, device=x_start.device)
        eps = noise[t_scalar] if noise is not None else torch.randn(
            x_start.shape, generator=rng, device=x_start.device, dtype=x_start.dtype)
        x_t = q_sample(sched, x_start, t, eps)
        out = vb_terms_bpd(
            sched, model_fn, x_start=x_start, x_t=x_t, t=t,
            mean_type=mean_type, var_type=var_type,
            clip_denoised=clip_denoised, model_kwargs=model_kwargs,
        )
        vb.append(out["output"])
        xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
        pred_eps = predict_eps_from_xstart(sched, x_t, t, out["pred_xstart"])
        mse.append(mean_flat((pred_eps - eps) ** 2))
    vb, xstart_mse, mse = (torch.stack(v, dim=1) for v in (vb, xstart_mse, mse))
    prior = prior_bpd(sched, x_start)
    return {
        "total_bpd": vb.sum(dim=1) + prior,
        "prior_bpd": prior,
        "vb": vb,
        "xstart_mse": xstart_mse,
        "mse": mse,
    }
