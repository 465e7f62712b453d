"""High-level Diffusion handle bundling a schedule with mean/var/loss types.

Counterpart of ``guided_diffusion_clip_tpu/diffusion/api.py``: the same
ergonomic handle over the pure functions (``diffusion.p_sample_loop(...)``,
``diffusion.training_losses(...)``). Each method moves the schedule to its
input's device (a no-op where it lies there already).
"""

from __future__ import annotations

import dataclasses

from . import gaussian as G
from . import sampling as S
from .schedules import DiffusionSchedule, LossType, ModelMeanType, ModelVarType


@dataclasses.dataclass(frozen=True)
class Diffusion:
    sched: DiffusionSchedule
    mean_type: ModelMeanType = ModelMeanType.EPSILON
    var_type: ModelVarType = ModelVarType.LEARNED_RANGE
    loss_type: LossType = LossType.MSE

    @property
    def num_timesteps(self) -> int:
        return self.sched.num_timesteps

    def _cfg(self, clip_denoised=True, eta=0.0, denoise_start_point=-1) -> S.SamplerConfig:
        return S.SamplerConfig(
            mean_type=self.mean_type,
            var_type=self.var_type,
            clip_denoised=clip_denoised,
            eta=eta,
            denoise_start_point=denoise_start_point,
        )

    def q_sample(self, x_start, t, noise):
        return G.q_sample(self.sched.to(x_start.device), x_start, t, noise)

    def p_mean_variance(self, model_fn, x, t, *, clip_denoised=True, denoised_fn=None, model_kwargs=None):
        return G.p_mean_variance(
            self.sched.to(x.device), model_fn, x, t,
            mean_type=self.mean_type, var_type=self.var_type,
            clip_denoised=clip_denoised, denoised_fn=denoised_fn, model_kwargs=model_kwargs,
        )

    def training_losses(self, model_fn, x_start, t, noise, model_kwargs=None):
        return G.training_losses(
            self.sched.to(x_start.device), model_fn, x_start=x_start, t=t, noise=noise,
            mean_type=self.mean_type, var_type=self.var_type, loss_type=self.loss_type,
            model_kwargs=model_kwargs,
        )

    def calc_bpd_loop(self, model_fn, x_start, rng=None, *, noise=None, clip_denoised=True, model_kwargs=None):
        return G.calc_bpd_loop(
            self.sched.to(x_start.device), model_fn, x_start=x_start, rng=rng, noise=noise,
            mean_type=self.mean_type, var_type=self.var_type,
            clip_denoised=clip_denoised, model_kwargs=model_kwargs,
        )

    def p_sample_loop(
        self, model_fn, shape, rng, *, noise=None, step_noise=None, init_image=None,
        clip_denoised=True, cond_fn=None, denoised_fn=None, model_kwargs=None,
        denoise_start_point=-1, progressive=False, model_state0=None, cond_state0=None,
    ):
        return S.p_sample_loop(
            self.sched, model_fn, shape, rng,
            cfg=self._cfg(clip_denoised, denoise_start_point=denoise_start_point),
            noise=noise, step_noise=step_noise, init_image=init_image,
            cond_fn=cond_fn, denoised_fn=denoised_fn, model_kwargs=model_kwargs,
            progressive=progressive, model_state0=model_state0, cond_state0=cond_state0,
        )

    def ddim_sample_loop(
        self, model_fn, shape, rng, *, noise=None, step_noise=None, init_image=None,
        clip_denoised=True, cond_fn=None, denoised_fn=None, model_kwargs=None, eta=0.0,
        denoise_start_point=-1, progressive=False, model_state0=None, cond_state0=None,
    ):
        return S.ddim_sample_loop(
            self.sched, model_fn, shape, rng,
            cfg=self._cfg(clip_denoised, eta=eta, denoise_start_point=denoise_start_point),
            noise=noise, step_noise=step_noise, init_image=init_image,
            cond_fn=cond_fn, denoised_fn=denoised_fn, model_kwargs=model_kwargs,
            progressive=progressive, model_state0=model_state0, cond_state0=cond_state0,
        )

    def dpm_solver_pp_2m_loop(
        self, model_fn, shape, rng, *, noise=None, init_image=None,
        clip_denoised=True, cond_fn=None, denoised_fn=None, model_kwargs=None,
        denoise_start_point=-1, model_state0=None, cond_state0=None,
    ):
        """Second-order multistep ODE sampler (DPM-Solver++ 2M): better
        quality than DDIM at 10-25 steps."""
        return S.dpm_solver_pp_2m_loop(
            self.sched, model_fn, shape, rng,
            cfg=self._cfg(clip_denoised, denoise_start_point=denoise_start_point),
            noise=noise, init_image=init_image,
            cond_fn=cond_fn, denoised_fn=denoised_fn, model_kwargs=model_kwargs,
            model_state0=model_state0, cond_state0=cond_state0,
        )

    def ddim_reverse_loop(self, model_fn, x0, *, clip_denoised=True, model_kwargs=None):
        """Deterministically encode x_0 -> x_T (reference ddim_reverse_sample
        :596-632 iterated forward)."""
        return S.ddim_reverse_loop(
            self.sched, model_fn, x0, cfg=self._cfg(clip_denoised), model_kwargs=model_kwargs
        )
