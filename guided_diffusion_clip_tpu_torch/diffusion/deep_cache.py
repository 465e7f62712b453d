"""DeepCache-style deep-feature reuse across denoise steps.

Counterpart of ``guided_diffusion_clip_tpu/diffusion/deep_cache.py``.
Training-free sampling acceleration (Ma et al. 2023, arXiv:2312.00858; the
block-caching observation also in Wimbauer et al., arXiv:2312.03209): the
UNet's low-resolution "deep" features change slowly between adjacent
timesteps, so the deep sub-UNet (deep input blocks, middle, deep output
blocks) is computed once every ``interval`` steps and reused in between, while
the high-resolution shallow path is recomputed every step. Opt-in
(``--deep_cache N`` on the sampling CLIs).

Mechanics: ``UNetModel`` exposes ``cache_mode="full"`` (compute everything and
also return the deep feature) and ``"shallow"`` (recompute only the shallow
blocks around a cached deep feature), ``models/unet.py``. The sampling loops
thread a ``(step_index, deep_feature)`` state through their ``model_state0``
slot; the step index is a Python int, so each step picks its branch on the
host and only that branch runs.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..parallel import sp, tp


def deep_cache_model_fn(apply_full: Callable, apply_shallow: Callable, interval: int) -> Callable:
    """Build a stateful model fn for the sampling loops' ``model_state0`` slot.

    ``apply_full(x, t, **kw) -> (out, deep)`` runs the whole UNet and returns
    the deep feature; ``apply_shallow(x, t, deep, **kw) -> (out, deep)`` runs
    only the shallow blocks around a cached deep feature. Steps where
    ``step_index % interval == 0`` refresh the cache; the first step always
    does, so the initial feature is never consumed.
    """
    assert interval >= 1

    def fn(x, t, state, **kw):
        step_i, deep = state
        if step_i % interval == 0:
            out, deep = apply_full(x, t, **kw)
        else:
            out, deep = apply_shallow(x, t, deep, **kw)
        return out, (step_i + 1, deep)

    return fn


def deep_feature_shape(config, batch: int, cache_cut: int = 0) -> tuple:
    """Shape (B, C, H, W) of the deep feature of a UNet of ``config`` at
    ``cache_cut``, by arithmetic over ``build_plan``: the activation entering
    output block ``n_in - cut`` is the output of the block before it (the
    middle block when ``cut == n_in``), at the resolution that block leaves."""
    from ..models.unet import build_plan

    input_plan, middle_plan, output_plan, _ = build_plan(config)
    n_in = len(input_plan)
    cut = cache_cut if cache_cut > 0 else config.num_res_blocks + 1
    assert 1 <= cut <= n_in, (cut, n_in)
    specs = [spec for block in input_plan + [middle_plan] + output_plan[: n_in - cut] for spec in block]
    ch, size = config.in_channels, config.image_size
    for spec in specs:
        ch = spec.get("out", ch)
        if spec["kind"] == "down" or spec.get("down"):
            size //= 2
        elif spec["kind"] == "up" or spec.get("up"):
            size *= 2
    return (batch, ch, size, size)


def zero_state(config, batch: int, cache_cut: int = 0, dtype=torch.float32, device=None):
    """Initial ``(step_index, deep_feature)`` state: zeros of the deep
    feature's shape, found by arithmetic (no forward runs). The JAX package
    asks ``eval_shape`` of ``apply_full``; here the caller names the UNet's
    config, the batch (twice the sample batch under ``cfg_deep_cache_pair``)
    and the torso's dtype."""
    # the rank's rows under SP, its channels under TP
    shape = tp.local_shape(sp.local_shape(deep_feature_shape(config, batch, cache_cut)))
    return (0, torch.zeros(shape, dtype=dtype, device=device))


def cfg_deep_cache_pair(
    cached_apply: Callable,
    cfg_scale: float,
    null_kwargs: dict,
) -> tuple[Callable, Callable]:
    """Compose classifier-free guidance with deep-feature caching.

    ``cached_apply(x, t, deep_cache=?, cache_mode=?, **kw)`` is the raw model
    call exposing the cache modes (``cache_cut`` bound by the caller). Both
    CFG branches ride the same doubled batch (``guidance.cfg_double``), so the
    cached deep feature has 2B rows; the eps combination
    (``guidance.cfg_combine``) happens on the way out of either branch. Feed
    the pair to ``deep_cache_model_fn`` as usual.
    """
    from .guidance import cfg_combine, cfg_double

    def apply_full(x, t, **kw):
        x2, t2, kw2 = cfg_double(x, t, kw, null_kwargs)
        out2, deep2 = cached_apply(x2, t2, cache_mode="full", **kw2)
        return cfg_combine(out2, cfg_scale, x.shape[1]), deep2

    def apply_shallow(x, t, deep2, **kw):
        x2, t2, kw2 = cfg_double(x, t, kw, null_kwargs)
        out2, _ = cached_apply(x2, t2, deep_cache=deep2, cache_mode="shallow", **kw2)
        return cfg_combine(out2, cfg_scale, x.shape[1]), deep2

    return apply_full, apply_shallow
