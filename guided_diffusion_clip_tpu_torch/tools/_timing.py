"""Shared by the tools: device choice, the card's label, timers, random
weights and the ADM-G 256 pair the sampling tools run."""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

from ..utils.script_util import create_classifier, create_gaussian_diffusion, create_upstream_model


def pick_device(name: str) -> torch.device:
    """The device a tool was asked for; a missing card is an error, never a
    silent fall back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    return device


def card_label(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, for the
    record beside every number; "cpu" on the CPU. A card whose limit cannot
    be read is an error: no rate is printed without it."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()
    return out[device.index or 0]


def _run_seconds(fn, device: torch.device, iters: int) -> float:
    """Seconds of ``iters`` back-to-back calls: CUDA events on the card, the
    host clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return time.perf_counter() - t0


def seconds_per_call(fn, device: torch.device, iters: int, repeats: int = 3) -> float:
    """Best of ``repeats`` runs of ``iters`` back-to-back calls after one
    warm-up call: CUDA events on the card, the host clock on the CPU."""
    fn()
    return min(_run_seconds(fn, device, iters) for _ in range(repeats)) / iters


def seconds_per_call_in_turns(fns: dict, device: torch.device, iters: int, rounds: int = 5) -> dict:
    """``seconds_per_call`` of each of ``fns`` (name -> function), the runs
    taken in turns: one warm-up call each, then ``rounds`` rounds of one run
    of ``iters`` calls of each function, and each one's best run. A burst of
    load on a shared host then falls on a run of every function, not on all
    runs of one."""
    for fn in fns.values():
        fn()
    best = dict.fromkeys(fns, float("inf"))
    for _ in range(rounds):
        for name, fn in fns.items():
            best[name] = min(best[name], _run_seconds(fn, device, iters))
    return {name: t / iters for name, t in best.items()}


def random_weights_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter and buffer of ``model`` drawn from N(0, 0.02) with a
    fixed seed, in place (as the JAX tools fill their params: the init's zero
    output layers would make a UNet's output exactly 0); returns ``model``.
    The draws come from a generator on the device the tensors lie on: on the
    CPU the same numbers wherever the model is built, on the card the card's."""
    gens = {}
    with torch.no_grad():
        for t in model.state_dict().values():
            g = gens.get(t.device) or gens.setdefault(t.device, torch.Generator(device=t.device).manual_seed(seed))
            t.copy_(torch.randn(t.shape, generator=g, device=t.device) * 0.02)
    return model


def built_on(factory, device: torch.device, seed: int) -> torch.nn.Module:
    """``factory()`` constructed without storage, then allocated on ``device``
    and filled by ``random_weights_``: no initializer runs on the host, which
    at ADM-G 256's width takes seconds a model."""
    with torch.device("meta"):
        model = factory()
    return random_weights_(model.to_empty(device=device), seed)


def make_models(size: int, conv_impl: str = "auto", channels: int = 256, clf_width: int = 128, *,
                respacing: str = "250", use_checkpoint: bool = False, fp16: bool = True,
                device: torch.device = torch.device("cpu")) -> tuple:
    """(UNet, classifier, diffusion): ADM-G (bench.py:170-198: ``channels``
    wide, attention at 32/16/8 px in 64-channel heads, class labels, the
    torso in bf16 with ``fp16``) and its ``clf_width``-wide, depth-2
    classifier with its attention pool, N(0, 0.02) weights from seeds 0 and 1
    on ``device``, and the linear schedule respaced to ``respacing``. Both
    models in eval mode, their parameters frozen (the guidance gradient is
    taken with respect to x only); ``use_checkpoint`` takes effect in train
    mode only (``TimestepEmbedSequential``)."""
    model = built_on(lambda: create_upstream_model(
        image_size=size, num_channels=channels, num_res_blocks=2, channel_mult="", learn_sigma=True,
        class_cond=True, use_checkpoint=use_checkpoint, attention_resolutions="32,16,8", num_heads=4,
        num_head_channels=64, num_heads_upsample=-1, use_scale_shift_norm=True, dropout=0.0,
        resblock_updown=True, use_fp16=fp16, use_new_attention_order=False, conv_impl=conv_impl,
    ), device, 0)
    classifier = built_on(lambda: create_classifier(
        image_size=size, classifier_use_fp16=fp16, classifier_width=clf_width, classifier_depth=2,
        classifier_attention_resolutions="32,16,8", classifier_use_scale_shift_norm=True,
        classifier_resblock_updown=True, classifier_pool="attention", conv_impl=conv_impl,
    ), device, 1)
    diffusion = create_gaussian_diffusion(steps=1000, learn_sigma=True, noise_schedule="linear",
                                          timestep_respacing=respacing)
    return model.eval().requires_grad_(False), classifier.eval().requires_grad_(False), diffusion


def on_card_defaults(device: torch.device) -> None:
    """On the card: the kernels built or loaded, and PyTorch's TF32 defaults,
    as the sampling CLIs leave them."""
    if device.type == "cuda":
        from ..ops import build

        build.load()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True


def timed_twice(fn, device: torch.device) -> tuple:
    """(the second call's result, its seconds): one warm-up call of ``fn``,
    then one timed, by CUDA events on the card (synchronized) and the host
    clock on the CPU."""
    fn()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def per_min(n: int, seconds: float, device: torch.device):
    """``n`` samples in ``seconds`` as samples a minute on the card; None on
    the CPU, whose run rehearses the tool and gives no rate."""
    return n / seconds * 60 if device.type == "cuda" else None


def deviation(a, b) -> dict:
    """How far ``b`` lies from the reference ``a``, by the JAX tools'
    formulas (tools/int8_quality_check.py:97-104,
    tools/deep_cache_bench.py:247-251) in the arrays' own dtype:
    ``rel_rmse`` the RMS difference over a's standard deviation,
    ``max_abs_rel`` the largest difference over a's largest magnitude, and
    ``corr`` the correlation of the flattened arrays."""
    a, b = np.asarray(a), np.asarray(b)
    return {
        "rel_rmse": float(np.sqrt(np.mean((a - b) ** 2)) / (a.std() + 1e-12)),
        "max_abs_rel": float(np.abs(a - b).max() / (np.abs(a).max() + 1e-12)),
        "corr": float(np.corrcoef(a.ravel(), b.ravel())[0, 1]),
    }
