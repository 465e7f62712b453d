"""Ancestral (p_sample) and DDIM sampling loops.

Counterpart of ``guided_diffusion_clip_tpu/diffusion/sampling.py``
(reference guided_diffusion/gaussian_diffusion.py:395-716). Each JAX
``lax.scan`` is a Python loop over the (respaced) timesteps here, with the
state on the device; PyTorch runs eagerly, so there is nothing to compile.

RNG. ``rng`` is either one ``torch.Generator`` (batch-level noise) or a
sequence of B generators, one per sample: PER-SAMPLE RNG. Then every noise
draw for sample i comes from its own generator only, so sample i's result
depends on its generator and not on what it is batched with -- the property
the server's padding, chunking and request coalescing rely on. The model
mixes nothing across the batch axis (GroupNorm and attention are per image).
``sample_generators`` seeds per-sample generators from ``(seed, subidx)``.

For tests, ``noise=`` gives x_T and ``step_noise=`` the per-step noise, so
the same numbers can be given to both frameworks.

Spatial partitioning (``parallel/sp.py``): ``shape``, ``noise``,
``step_noise`` and ``init_image`` are the full images', every noise is drawn
at full size from the same generators and sliced to the rank's rows, and the
chain's state and the loops' results are the rank's rows (gather them with
``sp.gather_rows`` where a full image is needed).

Guidance: ``cond_fn(x, t_model, **model_kwargs) -> gradient`` (see
``guidance.py``) shifts the ancestral step's mean by variance * gradient
(``condition_mean``) and the DDIM step's eps by -sqrt(1 - ab) * gradient
(``condition_score``).

Stateful functions. ``model_state0`` opts into a stateful model,
``model_fn(x, t, state, **kw) -> (out, new_state)`` (DeepCache,
``deep_cache.py``; the cached classifier-free branch,
``guidance.cfg_cached_model_fn``), and ``cond_state0`` into a stateful
``cond_fn(x, t, state, **kw) -> (gradient, new_state)``
(``guidance.cached_cond_fn``). The state is threaded from step to step, and a
step must call each stateful function exactly once. Step counters in a state
are Python ints, and each loop hands its steps a ``t`` that carries its Python
value (``DiffusionSchedule.chain_timesteps``), so a wrapper that picks a
branch by step or by timestep decides on the host and the skipped branch
never runs.

The chain-segmenting functions of the JAX package (``sample_chain_segment*``)
bound the run time of one compiled program; an eager loop needs none.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from ..parallel import sp
from . import gaussian as G
from .schedules import DiffusionSchedule, ModelMeanType, ModelVarType

Rng = torch.Generator | Sequence[torch.Generator] | None


_M64 = (1 << 64) - 1


def sample_seed(seed: int, subidx: int) -> int:
    """The generator seed of sample ``subidx`` of a request seeded ``seed``:
    splitmix64 of ``(seed mod 2**32) << 32 | (subidx mod 2**32)``.

    The mix makes every bit depend on both inputs: the CPU generator keeps
    only the low 32 bits of its seed, the CUDA generator all 64.
    """
    z = ((((int(seed) & 0xFFFFFFFF) << 32) | (int(subidx) & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def sample_generators(seeds, subidx, device) -> list[torch.Generator]:
    """One generator per sample on ``device``, seeded by ``sample_seed``."""
    return [
        torch.Generator(device=device).manual_seed(sample_seed(s, i))
        for s, i in zip(seeds, subidx)
    ]


def _normal(rng: Rng, shape) -> torch.Tensor:
    """Standard normal f32 draws from one generator, or row-wise from B generators."""
    if isinstance(rng, torch.Generator):
        return torch.randn(shape, generator=rng, device=rng.device)
    if rng is None:
        raise ValueError("no generator given and no noise injected")
    if len(rng) != shape[0]:
        raise ValueError(f"{len(rng)} generators for a batch of {shape[0]}")
    return torch.stack(
        [torch.randn(tuple(shape[1:]), generator=g, device=g.device) for g in rng]
    )


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static sampling configuration."""

    mean_type: ModelMeanType = ModelMeanType.EPSILON
    var_type: ModelVarType = ModelVarType.LEARNED_RANGE
    clip_denoised: bool = True
    eta: float = 0.0  # DDIM stochasticity (reference :546, eq. 12 eta)
    # -1 => start from noise at T-1; otherwise start from q_sample(init, t0)
    denoise_start_point: int = -1


def _noise_like(rng: Rng, x) -> torch.Tensor:
    """A step's noise for the state x: drawn at the full image's size and
    cut to the rank's rows under spatial partitioning."""
    return sp.shard_rows(_normal(rng, sp.full_shape(x.shape)))


def _start_state(sched, cfg, shape, rng, noise=None, init_image=None):
    """Initial latent + first timestep index (reference :509-529); the
    rank's rows of it under spatial partitioning."""
    if init_image is not None:
        init_image = sp.shard_rows(init_image)
    if cfg.denoise_start_point == -1:
        return sp.shard_rows(noise if noise is not None else _normal(rng, shape)), sched.num_timesteps
    t_start = int(cfg.denoise_start_point)
    if not 0 < t_start <= sched.num_timesteps:
        raise ValueError(f"denoise_start_point {t_start} outside (0, {sched.num_timesteps}]")
    if init_image is None:
        raise ValueError("denoise_start_point requires an init image")
    start_noise = sp.shard_rows(noise if noise is not None else _normal(rng, shape))
    t0 = torch.full((shape[0],), t_start - 1, dtype=torch.long, device=start_noise.device)
    return G.q_sample(sched.to(start_noise.device), init_image, t0, start_noise), t_start


def p_sample_step(
    sched: DiffusionSchedule,
    model_fn: Callable,
    x,
    t,
    rng: Rng,
    *,
    cfg: SamplerConfig,
    noise=None,
    cond_fn: Callable | None = None,
    denoised_fn: Callable | None = None,
    model_kwargs: dict | None = None,
):
    """One ancestral step x_t -> x_{t-1} (reference p_sample :395-439):
    sample = mean + 1{t != 0} * exp(0.5 logvar) * z, z from ``rng`` unless
    ``noise`` is given; guidance shifts the mean by variance * cond_fn
    (condition_mean, reference :434-437)."""
    out = G.p_mean_variance(
        sched, model_fn, x, t,
        mean_type=cfg.mean_type, var_type=cfg.var_type,
        clip_denoised=cfg.clip_denoised, denoised_fn=denoised_fn,
        model_kwargs=model_kwargs,
    )
    if cond_fn is not None:
        out = G.condition_mean(sched, cond_fn, out, x, t, model_kwargs=model_kwargs)
    if noise is None:
        noise = _noise_like(rng, x)
    nonzero_mask = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
    sample = out.mean + nonzero_mask * torch.exp(0.5 * out.log_variance) * noise
    return sample, out.pred_xstart


def ddim_step(
    sched: DiffusionSchedule,
    model_fn: Callable,
    x,
    t,
    rng: Rng,
    *,
    cfg: SamplerConfig,
    noise=None,
    cond_fn: Callable | None = None,
    denoised_fn: Callable | None = None,
    model_kwargs: dict | None = None,
):
    """One DDIM step (reference ddim_sample :546-594, eq. 12 of Song et al.).

    At eta == 0 the step is deterministic and draws no noise (the JAX loop
    draws and multiplies by zero). Guidance uses condition_score (reference
    :570-571): eps shifted by -sqrt(1-ab) * grad before x0 and the update.
    """
    out = G.p_mean_variance(
        sched, model_fn, x, t,
        mean_type=cfg.mean_type, var_type=cfg.var_type,
        clip_denoised=cfg.clip_denoised, denoised_fn=denoised_fn,
        model_kwargs=model_kwargs,
    )
    if cond_fn is not None:
        out = G.condition_score(sched, cond_fn, out, x, t, model_kwargs=model_kwargs)
    nd = x.dim()
    eps = G.predict_eps_from_xstart(sched, x, t, out.pred_xstart)
    alpha_bar = G._extract(sched.alphas_cumprod, t, nd)
    alpha_bar_prev = G._extract(sched.alphas_cumprod_prev, t, nd)
    sigma = (
        cfg.eta
        * torch.sqrt((1.0 - alpha_bar_prev) / (1.0 - alpha_bar))
        * torch.sqrt(1.0 - alpha_bar / alpha_bar_prev)
    )
    mean_pred = (
        out.pred_xstart * torch.sqrt(alpha_bar_prev)
        + torch.sqrt(1.0 - alpha_bar_prev - sigma**2) * eps
    )
    if cfg.eta == 0:
        return mean_pred, out.pred_xstart
    if noise is None:
        noise = _noise_like(rng, x)
    nonzero_mask = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (nd - 1))
    return mean_pred + nonzero_mask * sigma * noise, out.pred_xstart


def ddim_reverse_step(
    sched: DiffusionSchedule,
    model_fn: Callable,
    x,
    t,
    *,
    cfg: SamplerConfig,
    model_kwargs: dict | None = None,
):
    """Deterministic encoding step x_t -> x_{t+1} (reference :596-632, eta = 0 only)."""
    out = G.p_mean_variance(
        sched, model_fn, x, t,
        mean_type=cfg.mean_type, var_type=cfg.var_type,
        clip_denoised=cfg.clip_denoised, model_kwargs=model_kwargs,
    )
    nd = x.dim()
    eps = (
        G._extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x - out.pred_xstart
    ) / G._extract(sched.sqrt_recipm1_alphas_cumprod, t, nd)
    alpha_bar_next = G._extract(sched.alphas_cumprod_next, t, nd)
    mean_pred = out.pred_xstart * torch.sqrt(alpha_bar_next) + torch.sqrt(1.0 - alpha_bar_next) * eps
    return mean_pred, out.pred_xstart


def _threaded(fn: Callable | None, state):
    """``fn`` bound to ``state`` for one step: ``(plain_fn, captured)`` where
    ``captured`` collects the new state of every call (None for a stateless fn)."""
    if state is None:
        return fn, None
    captured = []

    def bound(x, t, **kw):
        out, new_state = fn(x, t, state, **kw)
        captured.append(new_state)
        return out

    return bound, captured


def _next_state(captured, state, what: str):
    if captured is None:
        return state
    assert len(captured) == 1, f"stateful {what} requires one call per step"
    return captured[0]


def _loop(
    step_fn,
    sched,
    model_fn,
    shape,
    rng: Rng,
    *,
    cfg,
    noise,
    step_noise,
    init_image,
    cond_fn,
    denoised_fn,
    model_kwargs,
    progressive: bool = False,
    model_state0=None,
    cond_state0=None,
):
    """Run ``step_fn`` from the start state down to t = 0; returns x_0, or with
    ``progressive`` ``(x_0, (samples, pred_xstarts))``, each stacked over the
    steps from the first taken to the last.

    ``step_noise[i]``, when given, is the noise of the i-th step taken.
    """
    img, t_start = _start_state(sched, cfg, shape, rng, noise=noise, init_image=init_image)
    sched = sched.to(img.device)
    mstate, cstate = model_state0, cond_state0
    samples, pred_xstarts = [], []
    for i, t_scalar in enumerate(range(t_start - 1, -1, -1)):
        t = sched.chain_timesteps(t_scalar, shape[0], img.device)
        mf, m_captured = _threaded(model_fn, mstate)
        cf, c_captured = _threaded(cond_fn, cstate)
        img, pred_xstart = step_fn(
            sched, mf, img, t, rng,
            cfg=cfg, noise=None if step_noise is None else sp.shard_rows(step_noise[i]),
            cond_fn=cf, denoised_fn=denoised_fn, model_kwargs=model_kwargs,
        )
        mstate = _next_state(m_captured, mstate, "model_fn")
        cstate = _next_state(c_captured, cstate, "cond_fn")
        if progressive:
            samples.append(img)
            pred_xstarts.append(pred_xstart)
    if progressive:
        return img, (torch.stack(samples), torch.stack(pred_xstarts))
    return img


def p_sample_loop(
    sched: DiffusionSchedule,
    model_fn: Callable,
    shape,
    rng: Rng,
    *,
    cfg: SamplerConfig = SamplerConfig(),
    noise=None,
    step_noise=None,
    init_image=None,
    cond_fn: Callable | None = None,
    denoised_fn: Callable | None = None,
    model_kwargs: dict | None = None,
    model_state0=None,
    cond_state0=None,
    progressive: bool = False,
):
    """Full ancestral sampling chain (reference :441-544)."""
    return _loop(
        p_sample_step, sched, model_fn, shape, rng,
        cfg=cfg, noise=noise, step_noise=step_noise, init_image=init_image,
        cond_fn=cond_fn, denoised_fn=denoised_fn, model_kwargs=model_kwargs,
        progressive=progressive, model_state0=model_state0, cond_state0=cond_state0,
    )


def p_sample_loop_progressive(sched, model_fn, shape, rng, **kw):
    """``p_sample_loop`` that also returns every intermediate (reference
    :489-544): ``(final, (samples[T, ...], pred_xstarts[T, ...]))``, ordered
    from the first denoise step to the last."""
    return p_sample_loop(sched, model_fn, shape, rng, progressive=True, **kw)


def ddim_sample_loop(
    sched: DiffusionSchedule,
    model_fn: Callable,
    shape,
    rng: Rng,
    *,
    cfg: SamplerConfig = SamplerConfig(),
    noise=None,
    step_noise=None,
    init_image=None,
    cond_fn: Callable | None = None,
    denoised_fn: Callable | None = None,
    model_kwargs: dict | None = None,
    model_state0=None,
    cond_state0=None,
    progressive: bool = False,
):
    """Full DDIM chain (reference :634-716)."""
    return _loop(
        ddim_step, sched, model_fn, shape, rng,
        cfg=cfg, noise=noise, step_noise=step_noise, init_image=init_image,
        cond_fn=cond_fn, denoised_fn=denoised_fn, model_kwargs=model_kwargs,
        progressive=progressive, model_state0=model_state0, cond_state0=cond_state0,
    )


def ddim_sample_loop_progressive(sched, model_fn, shape, rng, **kw):
    """``ddim_sample_loop`` with the intermediates, as ``p_sample_loop_progressive``."""
    return ddim_sample_loop(sched, model_fn, shape, rng, progressive=True, **kw)


def _lambda(alpha_bar):
    """Half log-SNR, log(alpha / sigma)."""
    return 0.5 * (torch.log(alpha_bar) - torch.log1p(-alpha_bar))


def dpm_solver_pp_2m_loop(
    sched: DiffusionSchedule,
    model_fn: Callable,
    shape,
    rng: Rng,
    *,
    cfg: SamplerConfig = SamplerConfig(),
    noise=None,
    init_image=None,
    cond_fn: Callable | None = None,
    denoised_fn: Callable | None = None,
    model_kwargs: dict | None = None,
    model_state0=None,
    cond_state0=None,
):
    """DPM-Solver++(2M) sampling chain (Lu et al. 2022, arXiv:2211.01095,
    Algorithm 2): a second-order multistep ODE solver in data-prediction form
    on the (respaced) discrete grid. Per step t -> t_prev,

        h_i   = lambda(t_prev) - lambda(t),  lambda = log(alpha / sigma)
        r_i   = h_{i-1} / h_i
        D_i   = (1 + 1/(2 r_i)) x0_i - 1/(2 r_i) x0_{i-1}   (first step: x0_i)
        x     = (sigma_prev / sigma_t) x - alpha_prev * expm1(-h_i) * D_i

    The final step (t == 0, sigma_prev = 0, h -> inf) returns the predicted
    x0 (``lower_order_final``). Guidance composes as on the DDIM path
    (``condition_score`` shifts eps before x0 is derived). Deterministic
    given the start noise; ``rng`` only seeds x_T.
    """
    x, t_start = _start_state(sched, cfg, shape, rng, noise=noise, init_image=init_image)
    sched = sched.to(x.device)
    nd = len(shape)
    mstate, cstate = model_state0, cond_state0
    x0_prev = h_prev = None
    for t_scalar in range(t_start - 1, -1, -1):
        t = sched.chain_timesteps(t_scalar, shape[0], x.device)
        mf, m_captured = _threaded(model_fn, mstate)
        cf, c_captured = _threaded(cond_fn, cstate)
        out = G.p_mean_variance(
            sched, mf, x, t,
            mean_type=cfg.mean_type, var_type=cfg.var_type,
            clip_denoised=cfg.clip_denoised, denoised_fn=denoised_fn,
            model_kwargs=model_kwargs,
        )
        if cond_fn is not None:
            out = G.condition_score(sched, cf, out, x, t, model_kwargs=model_kwargs)
        mstate = _next_state(m_captured, mstate, "model_fn")
        cstate = _next_state(c_captured, cstate, "cond_fn")
        x0 = out.pred_xstart
        if t_scalar == 0:
            # selected, not blended: lambda diverges at ab_prev == 1, and no
            # non-finite value of that update may reach the result
            x = x0
            break
        ab_t = G._extract(sched.alphas_cumprod, t, nd)
        # 1 - 1e-8 rounds back to 1.0 in f32: the clamp must exceed f32 epsilon
        ab_prev = G._extract(sched.alphas_cumprod_prev, t, nd).clamp(max=1.0 - 1e-6)
        h = _lambda(ab_prev) - _lambda(ab_t)
        if x0_prev is None:
            d = x0  # the first step is first-order
        else:
            coef = 1.0 / (2.0 * (h_prev / h))
            d = (1.0 + coef) * x0 - coef * x0_prev
        sigma_ratio = torch.sqrt(1.0 - ab_prev) / torch.sqrt(1.0 - ab_t)
        x = sigma_ratio * x - torch.sqrt(ab_prev) * torch.expm1(-h) * d
        x0_prev, h_prev = x0, h
    return x


def ddim_reverse_loop(
    sched: DiffusionSchedule,
    model_fn: Callable,
    x0,
    *,
    cfg: SamplerConfig = SamplerConfig(),
    model_kwargs: dict | None = None,
):
    """Deterministically encode x_0 to x_T: ``ddim_reverse_step`` from t = 0 up."""
    sched = sched.to(x0.device)
    x = x0
    for t_scalar in range(sched.num_timesteps):
        t = sched.chain_timesteps(t_scalar, x0.shape[0], x0.device)
        x, _ = ddim_reverse_step(sched, model_fn, x, t, cfg=cfg, model_kwargs=model_kwargs)
    return x
