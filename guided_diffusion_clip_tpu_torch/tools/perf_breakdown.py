"""Split the classifier-guided step on the card into its parts.

    python -m guided_diffusion_clip_tpu_torch.tools.perf_breakdown [batch] [--device cuda]

Counterpart of ``tools/perf_breakdown.py``: ADM-G 256 (bench.py:170-188: 256
channels, attention at 32/16/8 px in 64-channel heads, class labels, bf16
torso) guided by the 128-wide, depth-2 classifier with its attention pool,
250 respaced steps, random N(0, 0.02) weights, ``batch`` images (16). Four
parts, each a function of the same x:

    unet_fwd_ms   the UNet's forward (under ``no_grad``, as the sampler runs it)
    cls_fwd_ms    the classifier's forward with x requiring grad, as inside
                  ``cond_fn``
    cls_grad_ms   ``cond_fn``: the classifier's forward and its backward to x
    full_step_ms  ``p_sample_step`` with ``cond_fn``: all of the above and
                  the step's diffusion math

Each part is timed as ``BD_REPS`` (8) back-to-back calls between two CUDA
events after one warm-up call, best of five, per call, the four parts' runs
taken in turns (``_timing.seconds_per_call_in_turns``: a burst of load on
the shared host falls on a run of each part, not on every run of one); then
each part's device time by ``torch.profiler`` (``utils/profiling.kernel_times``:
the sum of its kernels' device times a call over two calls after one), as
``unet_fwd_device_ms`` and the like. The CUDA-event times of the host-bound
parts (the classifier's forward keeps the card busy for a third of it or
less) follow the shared host's speed, the device times only the card's.
Then ``per_sample_step_ms`` and ``proj_samples_per_min_250``, the rate of a
250-step chain at this step time.

Environment: ``BD_IMAGE_SIZE`` (256; other sizes take 192 channels),
``BD_REPS``, ``BD_ONLY`` (a substring of the parts to run), and
``BD_CONV_IMPL`` (auto, the default, or xla: cuDNN; int8: both models' convs
on the int8 path, kernels K4 and K5, as ``--conv_impl int8``; the JAX tool's
``int8_emit`` and global conv setting). ``BD_CH`` and ``BD_CLF_CH`` set the
UNet's channels and the classifier's width, for rehearsing the tool on the
CPU at a small width only. ``GDC_ATTENTION_IMPL`` is not read: the JAX
package picks its attention through ``ops/config.py``, which the port does
not have; the port dispatches by device, so the card runs K1 and K2 and the
CPU the plain versions, and ``attention_impl`` says which.

One JSON line with the JAX tool's keys, ``card``, the card's name and
power limit, and the parts' device times. ``--device cpu`` runs the plain
versions, for rehearsing the tool only: it prints times but no rate and no
device time.
"""

from __future__ import annotations

import argparse
import json
import os
import types

import torch

from ..diffusion import sampling as S
from ..diffusion.guidance import classifier_cond_fn, model_fn_dropping_y
from ..models.unet import CONV_IMPLS
from ..ops import build
from ..utils.flops import flops_per_step
from ..utils.profiling import kernel_times
from ._timing import card_label, make_models, pick_device, seconds_per_call_in_turns

PARTS = ("unet_fwd_ms", "cls_fwd_ms", "cls_grad_ms", "full_step_ms")
DEVICE_KEYS = {name: name.replace("_ms", "_device_ms") for name in PARTS}  # None on the CPU


def build_step(batch: int, size: int, conv_impl: str, channels: int, clf_width: int,
               device: torch.device) -> types.SimpleNamespace:
    """The guided step's parts on ``device``: ``parts`` maps each of ``PARTS``
    to a function of no argument; ``full_step(noise=None)`` returns the step's
    sample, with the given noise in place of the generator's draw."""
    model, classifier, diffusion = make_models(size, conv_impl, channels, clf_width, device=device)
    sched = diffusion.sched.to(device)
    cfg = S.SamplerConfig(mean_type=diffusion.mean_type, var_type=diffusion.var_type)
    g = torch.Generator(device=device).manual_seed(2)
    x = torch.randn(batch, 3, size, size, generator=g, device=device)
    t = torch.full((batch,), 128, dtype=torch.long, device=device)
    tm = sched.model_timesteps(t)
    y = torch.zeros(batch, dtype=torch.long, device=device)
    cond_fn = classifier_cond_fn(classifier, 1.0)
    model_fn = model_fn_dropping_y(model, True)
    rng = torch.Generator(device=device).manual_seed(3)

    def unet_fwd():
        with torch.no_grad():
            return model(x, tm, y=y)

    def cls_fwd():
        with torch.enable_grad():
            return classifier(x.detach().requires_grad_(True), tm)

    def cls_grad():
        with torch.no_grad():
            return cond_fn(x, tm, y=y)

    def full_step(noise=None):
        with torch.no_grad():
            return S.p_sample_step(sched, model_fn, x, t, rng, cfg=cfg, noise=noise, cond_fn=cond_fn,
                                   model_kwargs={"y": y})[0]

    return types.SimpleNamespace(
        parts=dict(zip(PARTS, (unet_fwd, cls_fwd, cls_grad, full_step))), full_step=full_step,
        model=model, classifier=classifier, sched=sched, cfg=cfg, x=x, t=t, y=y,
    )


def step_flops(batch: int, size: int, conv_impl: str = "auto", channels: int = 256, clf_width: int = 128) -> float:
    """The operations of one guided step at ``batch`` (``utils/flops.py``),
    counted on the CPU at batch 1 (the count is linear in the batch)."""
    with torch.random.fork_rng(devices=[]):
        step = build_step(1, size, conv_impl, channels, clf_width, torch.device("cpu"))
        return flops_per_step(step.full_step) * batch


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("batch", nargs="?", type=int, default=16)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = pick_device(args.device)
    size = int(os.environ.get("BD_IMAGE_SIZE", 256))
    reps = int(os.environ.get("BD_REPS", 8))
    only = os.environ.get("BD_ONLY", "")
    conv_impl = os.environ.get("BD_CONV_IMPL", "auto")
    if conv_impl not in CONV_IMPLS:
        raise SystemExit(f"BD_CONV_IMPL {conv_impl!r}: choose from {CONV_IMPLS}")
    channels = int(os.environ.get("BD_CH", 256 if size == 256 else 192))
    clf_width = int(os.environ.get("BD_CLF_CH", 128))
    card = card_label(device)
    on_card = device.type == "cuda"
    if on_card:
        build.load()
        torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's defaults, as classifier_sample leaves them
        torch.backends.cudnn.allow_tf32 = True
    step = build_step(args.batch, size, conv_impl, channels, clf_width, device)

    B = args.batch
    results = {"batch": B, "attention_impl": "K1, K2 (ops/csrc)" if on_card else "plain PyTorch"}
    if conv_impl != "auto":
        results["conv_impl"] = conv_impl
    parts = {name: fn for name, fn in step.parts.items() if not only or only in name}
    for name, seconds in seconds_per_call_in_turns(parts, device, reps).items():
        results[name] = seconds * 1e3
        line = f"{name}: {results[name]}"
        results[DEVICE_KEYS[name]] = None
        if on_card:
            results[DEVICE_KEYS[name]] = sum(ms for ms, _ in kernel_times(parts[name]).values())
            line += f" (device {results[DEVICE_KEYS[name]]:.2f} ms by the profiler, {card})"
        print(line, flush=True)
    results["card"] = card
    if "full_step_ms" in results:
        results["per_sample_step_ms"] = results["full_step_ms"] / B
        # a CPU rehearsal prints no rate
        results["proj_samples_per_min_250"] = (
            60.0 / (results["full_step_ms"] / 1000 * 250 / B) if on_card else None)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
