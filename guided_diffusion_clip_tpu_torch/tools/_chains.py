"""The classifier-guided chain that the sampling tools time, composed as
``classifier_sample`` composes it: the classifier's gradient every step,
optionally gated to a window of model timesteps (``interval_cond_fn``), reused
between refreshes (``cached_cond_fn``, the window inside the cache), and
DeepCache on the generator (``deep_cache_model_fn``). The networks' calls are
counted, so a caller can check which steps ran which network."""

from __future__ import annotations

import functools

import torch

from ..diffusion.deep_cache import deep_cache_model_fn, zero_state
from ..diffusion.guidance import cached_cond_fn, classifier_cond_fn, interval_cond_fn
from ..diffusion.sampling import sample_generators

SEED = 7  # the JAX tools' jax.random.key(7)


def labels(batch: int, device) -> torch.Tensor:
    """The tools' class labels: 0, 1, ..., batch - 1 (mod 1000)."""
    return torch.arange(batch, device=device) % 1000


def counted_unet(model, calls: dict):
    """``model`` as the loops call it, each call counted in ``calls`` as
    ``unet_full`` or, for a DeepCache shallow forward, ``unet_shallow``."""

    def unet(x, t, y=None, cache_mode="off", **kw):
        calls["unet_shallow" if cache_mode == "shallow" else "unet_full"] += 1
        return model(x, t, y=y, cache_mode=cache_mode, **kw)

    return unet


def with_deep_cache(unet, config, batch: int, interval: int, cut: int, dtype, device) -> tuple:
    """(model_fn, model_state0): DeepCache over ``unet`` (a ``counted_unet``),
    refreshing the deep sub-UNet one step in ``interval`` at ``cut`` (0: the
    model's default)."""

    def apply_shallow(x, t, deep, **kw):
        return unet(x, t, deep_cache=deep, cache_mode="shallow", cache_cut=cut, **kw)

    fn = deep_cache_model_fn(functools.partial(unet, cache_mode="full", cache_cut=cut), apply_shallow, interval)
    return fn, zero_state(config, batch, cut, dtype=dtype, device=device)


def generators(batch: int, device, seed: int = SEED) -> list:
    """The per-sample generators every chain draws from, built anew for each
    chain: two chains of one batch and one ``seed`` draw the same noise."""
    return sample_generators([seed] * batch, range(batch), device)


def classifier_chain(loop, model, classifier, classes, *, deep_cache: int = 0, cache_cut: int = 0,
                     interval=None, guidance_cache: int = 0, scale: float = 1.0):
    """``run(noise=None, step_noise=None, seed=SEED) -> samples``: ``loop`` (a
    ``Diffusion`` sampling method) over ``model`` guided by ``classifier``'s
    gradient at ``scale`` for the labels ``classes`` (unguided with
    ``classifier`` None), under ``torch.no_grad()``, the noise from
    ``generators`` unless given. ``run.calls`` counts the networks' calls over
    every run: ``unet_full``, ``unet_shallow``, ``classifier``."""
    device, batch = classes.device, classes.shape[0]
    size = model.config.image_size
    shape = (batch, 3, size, size)
    calls = {"unet_full": 0, "unet_shallow": 0, "classifier": 0}

    def classifier_fn(x, t):
        calls["classifier"] += 1
        return classifier(x, t)

    cond_fn = classifier_cond_fn(classifier_fn, scale) if classifier is not None else None
    if interval is not None:
        cond_fn = interval_cond_fn(cond_fn, *interval)
    cond_state0 = None
    if guidance_cache > 1:
        cond_fn, cond_state0 = cached_cond_fn(cond_fn, guidance_cache, shape, device=device)
    model_fn, model_state0 = counted_unet(model, calls), None
    if deep_cache > 1:
        model_fn, model_state0 = with_deep_cache(model_fn, model.config, batch, deep_cache, cache_cut, model.dtype,
                                                 device)

    run = runner(loop, model_fn, classes, shape, cond_fn=cond_fn, model_state0=model_state0,
                 cond_state0=cond_state0)
    run.calls = calls
    return run


def runner(loop, model_fn, classes, shape, *, cond_fn=None, model_state0=None, cond_state0=None,
           model_kwargs=None):
    """``run(noise=None, step_noise=None, seed=SEED) -> samples``: ``loop``
    over ``model_fn`` with the labels ``classes`` (or ``model_kwargs`` in
    their place) under ``torch.no_grad()`` (not ``inference_mode``: a cond_fn
    differentiates through its networks), the noise from ``generators`` unless
    given."""
    device, batch = classes.device, classes.shape[0]
    kwargs = {"y": classes} if model_kwargs is None else model_kwargs

    def run(noise=None, step_noise=None, seed=SEED):
        extra = {} if step_noise is None else {"step_noise": step_noise}
        with torch.no_grad():
            return loop(model_fn, shape, None if noise is not None else generators(batch, device, seed), noise=noise,
                        clip_denoised=True, model_kwargs=kwargs, cond_fn=cond_fn,
                        model_state0=model_state0, cond_state0=cond_state0, **extra)

    return run
