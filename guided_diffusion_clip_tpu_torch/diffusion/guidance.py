"""Guidance gradient builders: classifier guidance and generic potentials.

Counterpart of ``guided_diffusion_clip_tpu/diffusion/guidance.py`` (reference
scripts/classifier_sample.py:54-65): ``cond_fn`` is the gradient with respect
to x of the selected class log-probability through the noised classifier,
scaled by ``classifier_scale``. Where the JAX package composes ``jax.grad``
into the scanned step, the port runs ``torch.autograd.grad`` on a detached
copy of x inside ``torch.enable_grad()``, so the sampling loop itself may run
under ``torch.no_grad()`` (not ``inference_mode``: an inference tensor cannot
be saved for backward). Give the classifier ``requires_grad_(False)`` so that
autograd forms dx only, as ``jax.grad`` with respect to x does.

The interval, caching and classifier-free wrappers pick their branch in
Python: ``lax.cond`` becomes an ``if``, so the skipped branch (the classifier's
forward and backward, the unconditional half) never runs. A window test needs
the timestep on the host: the sampling loops tag the ``t`` they build with its
Python value (``DiffusionSchedule.chain_timesteps``), and only a caller that
hands over an untagged tensor pays a read-back from the device. Step counters
in the carried states are Python ints. Channels are axis 1 here (NCHW).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..parallel import sp, tp


def classifier_cond_fn(classifier_fn: Callable, classifier_scale: float = 1.0) -> Callable:
    """Build ``cond_fn(x, t, y=..., **kw) -> d/dx [log p(y | x, t)] * scale``.

    ``classifier_fn(x, t) -> logits``. The sum of the selected log-softmax,
    differentiated with respect to x (classifier_sample.py:54-61). Under
    spatial partitioning x is this rank's rows and the logits are every
    rank's (the classifier pools over the ranks), so the sum is weighted by
    ``sp.owner_weight()``: the adjoints then count it once. Under tensor
    parallelism x is whole on every rank: the sum is weighted by
    ``tp.owner_weight()`` and the ranks' gradients are summed.
    """

    def cond_fn(x, t, y=None, **kwargs):
        if y is None:
            raise ValueError("classifier guidance requires labels y")
        with torch.enable_grad():
            x_in = x.detach().requires_grad_(True)
            log_probs = F.log_softmax(classifier_fn(x_in, t).float(), dim=-1)
            selected = log_probs.gather(-1, y.reshape(-1, 1).long()).sum()
            if sp.sharded(x_in):
                selected = selected * sp.owner_weight()
            (grad,) = torch.autograd.grad(_owned(selected), x_in)
        return _summed(grad) * classifier_scale

    return cond_fn


def _owned(value):
    """Under tensor parallelism a replicated scalar, weighted by
    ``tp.owner_weight()``: the ranks' gradients with respect to the whole x
    then sum to its gradient (``_summed``)."""
    return value * tp.owner_weight() if tp.active() else value


def _summed(grad):
    """The gradient with respect to the whole x, summed over the model group
    under tensor parallelism: each rank's is its share."""
    return tp.reduce_sum_(grad) if tp.active() else grad


def potential_cond_fn(potential: Callable, scale: float = 1.0) -> Callable:
    """Generic guidance from any scalar potential U(x, t, **kw): grad_x U * scale.
    Under spatial partitioning x is this rank's rows and U must be the
    data group's one value on every rank (computed from gathered rows); it
    is weighted by ``sp.owner_weight()``, as ``classifier_cond_fn``'s sum."""

    def cond_fn(x, t, **kwargs):
        with torch.enable_grad():
            x_in = x.detach().requires_grad_(True)
            u = potential(x_in, t, **kwargs)
            if sp.sharded(x_in):
                u = u * sp.owner_weight()
            (grad,) = torch.autograd.grad(_owned(u), x_in)
        return _summed(grad) * scale

    return cond_fn


def parse_guidance_interval(spec: str) -> tuple[float, float] | None:
    """Parse the --guidance_interval flag: "lo,hi" in original-model-timestep
    units (0..T_orig-1, the values the model itself sees), or "" for
    always-on guidance. Returns (lo, hi) or None."""
    spec = (spec or "").strip()
    if not spec:
        return None
    parts = spec.split(",")
    if len(parts) != 2:
        raise ValueError(f"--guidance_interval wants 'lo,hi', got {spec!r}")
    lo, hi = float(parts[0]), float(parts[1])
    if lo > hi:
        raise ValueError(f"--guidance_interval lo > hi: {spec!r}")
    return lo, hi


def _window_t(t) -> float:
    """The chain's model timestep as a Python number: the loops' host tag
    when ``t`` carries one, else element 0 read back from the tensor (the
    loops build ``t`` from one scalar, so element 0 speaks for the batch)."""
    host_t = getattr(t, "host_t", None)
    if host_t is not None:
        return float(host_t)
    return float(torch.as_tensor(t).reshape(-1)[0])


def _inside(t, interval) -> bool:
    return interval is None or interval[0] <= _window_t(t) <= interval[1]


def interval_cond_fn(cond_fn: Callable, t_lo: float, t_hi: float) -> Callable:
    """Apply guidance only while t_lo <= t <= t_hi (original timestep units;
    Kynkaenniemi et al. 2024, "Applying Guidance in a Limited Interval").

    Outside the window ``cond_fn`` is not called at all, so the guided chain
    costs what an unguided one does there. A zero gradient is a no-op for
    both composition rules (``condition_mean`` adds variance * grad;
    ``condition_score`` shifts eps by sqrt(1 - ab) * grad).
    """

    def fn(x, t, **kwargs):
        if _inside(t, (t_lo, t_hi)):
            return cond_fn(x, t, **kwargs)
        return torch.zeros_like(x)

    return fn


def cached_cond_fn(cond_fn: Callable, every: int, shape, dtype=torch.float32, device=None):
    """Guidance-gradient caching: recompute ``cond_fn`` every ``every`` steps
    and reuse the previous gradient in between. Returns ``(stateful_fn,
    state0)`` for the sampling loops' ``cond_state0`` slot; on reuse steps the
    guidance network does not run.

    The counter counts every step and starts at 0, so the first step always
    recomputes. Composes with ``interval_cond_fn``: wrap the interval first
    (inside), then reuse steps outside the window recycle the cached zeros and
    refresh steps there skip the network through the inner test.

    ``shape`` is the gradient's shape (x's).
    """
    assert every >= 1

    def fn(x, t, state, **kwargs):
        i, g_prev = state
        grad = cond_fn(x, t, **kwargs).to(dtype) if i % every == 0 else g_prev
        return grad, (i + 1, grad)

    return fn, (0, torch.zeros(sp.local_shape(shape), dtype=dtype, device=device))  # the rank's rows under SP


def cfg_model_fn(
    model_fn: Callable,
    cfg_scale: float,
    null_kwargs: dict,
    interval: tuple[float, float] | None = None,
) -> Callable:
    """Classifier-free guidance (Ho & Salimans 2022).

    Wraps a conditional ``model_fn(x, t, **kwargs)`` so that each call runs the
    conditional and unconditional branches in one doubled batch and combines
    the eps halves as ``eps_u + scale * (eps_c - eps_u)``. Channels beyond the
    input's (the learned variance) pass through from the conditional half.

    ``null_kwargs`` maps the conditioning keys to their unconditional value
    (broadcast per example): ``clip_feat -> 0`` for the embedding conditioning,
    ``y -> null class index`` for models trained with a reserved null row. Keys
    not in it are duplicated into both halves.

    ``interval=(lo, hi)`` restricts CFG to that model-timestep window: outside
    it only the plain conditional call runs, on the plain batch.
    """

    def fn(x, t, **kwargs):
        if not _inside(t, interval):
            return model_fn(x, t, **kwargs)
        x2, t2, kw2 = cfg_double(x, t, kwargs, null_kwargs)
        return cfg_combine(model_fn(x2, t2, **kw2), cfg_scale, x.shape[1])

    return fn


def cfg_cached_model_fn(
    model_fn: Callable,
    cfg_scale: float,
    null_kwargs: dict,
    every: int,
    interval: tuple[float, float] | None = None,
) -> Callable:
    """Classifier-free guidance with a cached unconditional branch.

    The conditional branch runs every step on the plain batch; the
    unconditional one only 1 step in ``every``, its output carried in between:
    (1 + 1/every) model calls a step instead of 2. Returns a stateful model fn
    ``(x, t, state, **kw) -> (out, state)`` for the loops' ``model_state0``
    slot; build the state with ``cfg_cached_state0``. Refresh steps run two
    B-sized calls, not a doubled batch.

    With ``interval`` only the conditional output is used outside the window
    and the unconditional call is skipped. The counter advances only inside
    the window, so the first guided step always refreshes and never combines
    against the zeros of the initial state.
    """
    assert every >= 1

    def fn(x, t, state, **kwargs):
        j, u = state
        cond_out = model_fn(x, t, **kwargs)
        if not _inside(t, interval):
            return cond_out, (j, u)
        if j % every == 0:
            u = model_fn(x, t, **_null_merge(kwargs, null_kwargs)).to(u.dtype)
        c = x.shape[1]
        eps = u[:, :c] + cfg_scale * (cond_out[:, :c] - u[:, :c])
        return torch.cat([eps, cond_out[:, c:]], dim=1), (j + 1, u)

    return fn


def cfg_cached_state0(out_shape, dtype=torch.float32, device=None):
    """(counter, zeros of the model's output) initial state for
    ``cfg_cached_model_fn``. The JAX package infers the output's shape with
    ``eval_shape``; here the caller states it (for a UNet, x's shape with
    ``out_channels`` channels; the model's output is f32)."""
    return (0, torch.zeros(sp.local_shape(out_shape), dtype=dtype, device=device))  # the rank's rows under SP


def _null_value(null, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(null, dtype=like.dtype, device=like.device).expand(like.shape)


def _null_merge(kwargs: dict, null_kwargs: dict) -> dict:
    """kwargs with the conditioning keys replaced by their null values
    (the single-batch counterpart of ``cfg_double``'s second half)."""
    return {
        k: v if v is None or k not in null_kwargs else _null_value(null_kwargs[k], v)
        for k, v in kwargs.items()
    }


def cfg_double(x, t, kwargs: dict, null_kwargs: dict):
    """Stack the conditional batch on top of its null-conditioned twin."""
    kw2 = {}
    for k, v in kwargs.items():
        if v is None:
            kw2[k] = None
        else:
            kw2[k] = torch.cat([v, _null_value(null_kwargs[k], v) if k in null_kwargs else v], dim=0)
    return torch.cat([x, x], dim=0), torch.cat([t, t], dim=0), kw2


def cfg_combine(out2, cfg_scale: float, c: int):
    """eps_u + scale * (eps_c - eps_u) over the first c channels; the other
    channels (learned variance) pass through from the conditional half."""
    cond_out, uncond_out = out2.chunk(2, dim=0)
    eps = uncond_out[:, :c] + cfg_scale * (cond_out[:, :c] - uncond_out[:, :c])
    return torch.cat([eps, cond_out[:, c:]], dim=1)


def model_fn_dropping_y(model_fn: Callable, class_cond: bool) -> Callable:
    """classifier_sample.py:63-65: drop y from the UNet call unless class-conditional
    (guidance labels are still consumed by cond_fn)."""

    def fn(x, t, y=None, **kwargs):
        return model_fn(x, t, y=y if class_cond else None, **kwargs)

    return fn
