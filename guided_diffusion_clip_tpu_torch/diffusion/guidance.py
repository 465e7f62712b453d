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

The interval, caching and classifier-free variants are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def classifier_cond_fn(classifier_fn: Callable, classifier_scale: float = 1.0) -> Callable:
    """Build ``cond_fn(x, t, y=..., **kw) -> d/dx [log p(y | x, t)] * scale``.

    ``classifier_fn(x, t) -> logits``. The sum of the selected log-softmax,
    differentiated with respect to x (classifier_sample.py:54-61).
    """

    def cond_fn(x, t, y=None, **kwargs):
        if y is None:
            raise ValueError("classifier guidance requires labels y")
        with torch.enable_grad():
            x_in = x.detach().requires_grad_(True)
            log_probs = F.log_softmax(classifier_fn(x_in, t).float(), dim=-1)
            selected = log_probs.gather(-1, y.reshape(-1, 1).long())
            (grad,) = torch.autograd.grad(selected.sum(), x_in)
        return grad * classifier_scale

    return cond_fn


def potential_cond_fn(potential: Callable, scale: float = 1.0) -> Callable:
    """Generic guidance from any scalar potential U(x, t, **kw): grad_x U * scale."""

    def cond_fn(x, t, **kwargs):
        with torch.enable_grad():
            x_in = x.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(potential(x_in, t, **kwargs), x_in)
        return grad * scale

    return cond_fn


def model_fn_dropping_y(model_fn: Callable, class_cond: bool) -> Callable:
    """classifier_sample.py:63-65: drop y from the UNet call unless class-conditional
    (guidance labels are still consumed by cond_fn)."""

    def fn(x, t, y=None, **kwargs):
        return model_fn(x, t, y=y if class_cond else None, **kwargs)

    return fn
