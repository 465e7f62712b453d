"""Sampling-script helpers (counterpart of ``guided_diffusion_clip_tpu/utils/sample_util.py``).

The reference star-imports ``guided_diffusion.sample_util`` and never ships
it; the JAX package reconstructed the three helpers from their call sites,
and the port keeps them as they are there. ``to_device`` and ``to_host`` are
the port's own: the copies between host and card that its CLIs and trainers
queue without waiting for the card.
"""

from __future__ import annotations

import torch


def to_device(a, device) -> torch.Tensor:
    """A host array or tensor on ``device``; from the host to the card through
    pinned memory, without waiting for the card (a pageable copy would wait
    for the work in flight)."""
    t = torch.as_tensor(a)
    if t.device.type == "cpu" and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_host(t: torch.Tensor):
    """(host copy, event): a CUDA tensor's copy into pinned memory, queued
    behind the work that makes it, and the event that marks the copy's end;
    a CPU tensor as it is and None."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def overlap_device_host(dispatched, process):
    """Pipeline the host's work one batch behind the card's.

    ``dispatched`` yields items whose card work has just been queued (not
    waited for); ``process(item)`` does the host's share (the wait for the
    copy, uint8 conversion, PNG and npz writes). Item i is processed after
    item i + 1 was queued, so its host work runs while the card works through
    batch i + 1's chain; every item is processed once, in order. A sampling
    CLI queues each batch's device-to-host copy into pinned memory behind an
    event and waits on that event in ``process``.
    """
    sentinel = prev = object()
    for item in dispatched:
        if prev is not sentinel:
            process(prev)
        prev = item
    if prev is not sentinel:
        process(prev)


def add_delta_imgimg(kwargs: dict) -> dict:
    """The loader's kwargs with ``clip_feat2`` present wherever ``clip_feat``
    is (the delta-conditioned models read both; a dataset without a partner
    pairs each image with itself). The input dict is not changed."""
    kwargs = dict(kwargs)
    if "clip_feat" in kwargs and "clip_feat2" not in kwargs:
        kwargs["clip_feat2"] = kwargs["clip_feat"]
    return kwargs


def process1(kwargs: dict) -> dict:
    """The depth sweep's staging of the loader's kwargs: ``add_delta_imgimg``."""
    return add_delta_imgimg(kwargs)
