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

Guidance: ``cond_fn(x, t_model, **model_kwargs) -> gradient`` (see
``guidance.py``) shifts the ancestral step's mean by variance * gradient
(``condition_mean``) and the DDIM step's eps by -sqrt(1 - ab) * gradient
(``condition_score``). DPM-Solver++ and the progressive/segmented loops are
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

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


def _start_state(sched, cfg, shape, rng, noise=None, init_image=None):
    """Initial latent + first timestep index (reference :509-529)."""
    if cfg.denoise_start_point == -1:
        return (noise if noise is not None else _normal(rng, shape)), sched.num_timesteps
    t_start = int(cfg.denoise_start_point)
    if not 0 < t_start <= sched.num_timesteps:
        raise ValueError(f"denoise_start_point {t_start} outside (0, {sched.num_timesteps}]")
    if init_image is None:
        raise ValueError("denoise_start_point requires an init image")
    start_noise = noise if noise is not None else _normal(rng, shape)
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
        noise = _normal(rng, x.shape)
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
        noise = _normal(rng, x.shape)
    nonzero_mask = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (nd - 1))
    return mean_pred + nonzero_mask * sigma * noise, out.pred_xstart


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
):
    """Run ``step_fn`` from the start state down to t = 0; returns x_0.

    ``step_noise[i]``, when given, is the noise of the i-th step taken.
    """
    img, t_start = _start_state(sched, cfg, shape, rng, noise=noise, init_image=init_image)
    sched = sched.to(img.device)
    for i, t_scalar in enumerate(range(t_start - 1, -1, -1)):
        t = torch.full((shape[0],), t_scalar, dtype=torch.long, device=img.device)
        img, _ = step_fn(
            sched, model_fn, img, t, rng,
            cfg=cfg, noise=None if step_noise is None else step_noise[i],
            cond_fn=cond_fn, denoised_fn=denoised_fn, model_kwargs=model_kwargs,
        )
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
):
    """Full ancestral sampling chain (reference :441-544)."""
    return _loop(
        p_sample_step, sched, model_fn, shape, rng,
        cfg=cfg, noise=noise, step_noise=step_noise, init_image=init_image,
        cond_fn=cond_fn, denoised_fn=denoised_fn, model_kwargs=model_kwargs,
    )


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
):
    """Full DDIM chain (reference :634-716)."""
    return _loop(
        ddim_step, sched, model_fn, shape, rng,
        cfg=cfg, noise=noise, step_noise=step_noise, init_image=init_image,
        cond_fn=cond_fn, denoised_fn=denoised_fn, model_kwargs=model_kwargs,
    )
