"""Measure the training step's sustained rate on the card.

    python -m guided_diffusion_clip_tpu_torch.tools.train_step_bench [--device cuda]

Counterpart of ``tools/train_step_bench.py``: ``TrainLoop.run_step`` (AdamW,
EMA, microbatches, metrics read one step late) on random weights and random
data, with the same environment variables:

    TSB_CONFIG      readme64 (default): the README's 64 px ADM, 192 channels,
                    three res blocks, attention at 32/16/8 px in 64-channel
                    heads, class labels; fork128: the fork's recipe
                    (configs/config.yaml: the CLIP UNet at 128 px, 64
                    channels, two res blocks, one head at 16 and 8 px, the
                    512-d CLIP embedding as its label, batch 48)
    TSB_BATCH       48 for fork128, else 32
    TSB_MICRO       fork128: the recipe's microbatch, the whole batch; else 16
    TSB_IMAGE_SIZE  128 for fork128, else 64
    TSB_REPEATS     windows timed (5); the best one is reported
    TSB_WINDOW      steps a window (10)
    TSB_DROPOUT     0.0 for fork128, else 0.1
    TSB_CONV_IMPL   xla (default): cuDNN in the bf16 torso; int8: the model's
                    convs on the int8 path (``--train_conv_impl int8``: K4, K5
                    and the quantize kernels forward, straight-through convs
                    on cuDNN backward)
    TSB_OPT_IMPL    tree (default) or flat: ``TrainLoop``'s ``opt_impl``
                    (one fused AdamW either way)
    TSB_CH          the model's channels (64 for fork128, else 192); for
                    rehearsing the tool on the CPU at a small width only

The rate is sustained over a window: ``run_step`` reads a step's metrics back
one step late, so a step's host time is its launches only, and each window
ends with the last step's metrics flushed and the card synchronized (host
clock). Two batches are drawn at set-up and alternate, so a window times the
step and not numpy's generator. ``compile_sec`` is the first step's seconds:
in eager mode nothing is compiled, and it holds cuDNN's and cuBLAS's first
calls (the kernels of ``ops/csrc`` are built or loaded before it).

One JSON line with the JAX tool's keys (``config``, ``ms_per_step``,
``samples_per_sec_per_chip``, ``compile_sec``, ``window_steps``) and:

    card                the card's name and power limit (``nvidia-smi``)
    flops_per_step      the operations of one step, forward and backward
                        (``utils/flops.py``: the same model and step on the
                        CPU at batch 1, times the batch)
    model_tflops_per_s  flops_per_step over the step's seconds
    device_ms_per_step  the card's busy time a step: the sum of its kernels'
                        device times by ``torch.profiler`` over two steps
                        after the timed windows and one more (``utils/profiling.py``);
                        the window's host-clock rate follows the shared
                        host's speed, this sum only the card's

``--device cpu`` runs the step with the plain versions, for rehearsing the
tool only: it prints times but no rate.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time

import numpy as np
import torch

from ..ops import build
from ..training.train_loop import TrainLoop
from ..utils import logger
from ..utils.flops import flops_per_step
from ..utils.profiling import kernel_times
from ..utils.script_util import create_gaussian_diffusion, create_model, create_upstream_model
from ._timing import card_label, pick_device, random_weights_

CONFIGS = ("readme64", "fork128")
CONV_IMPLS = ("xla", "int8")
OPT_IMPLS = ("tree", "flat")


def settings() -> dict:
    """The ``TSB_*`` environment variables, with their defaults."""
    config = os.environ.get("TSB_CONFIG", "readme64")
    if config not in CONFIGS:
        raise SystemExit(f"TSB_CONFIG {config!r}: choose from {CONFIGS}")
    fork = config == "fork128"
    batch = int(os.environ.get("TSB_BATCH", 48 if fork else 32))
    s = dict(
        config=config, batch=batch,
        micro=int(os.environ.get("TSB_MICRO", batch if fork else 16)),
        size=int(os.environ.get("TSB_IMAGE_SIZE", 128 if fork else 64)),
        repeats=int(os.environ.get("TSB_REPEATS", 5)),
        window=int(os.environ.get("TSB_WINDOW", 10)),
        dropout=float(os.environ.get("TSB_DROPOUT", 0.0 if fork else 0.1)),
        conv_impl=os.environ.get("TSB_CONV_IMPL", "xla"),
        opt_impl=os.environ.get("TSB_OPT_IMPL", "tree"),
        channels=int(os.environ.get("TSB_CH", 64 if fork else 192)),
    )
    if s["conv_impl"] not in CONV_IMPLS:
        raise SystemExit(f"TSB_CONV_IMPL {s['conv_impl']!r}: choose from {CONV_IMPLS}")
    if s["opt_impl"] not in OPT_IMPLS:
        raise SystemExit(f"TSB_OPT_IMPL {s['opt_impl']!r}: choose from {OPT_IMPLS}")
    return s


def make_model(s: dict) -> torch.nn.Module:
    """The configuration's model with N(0, 0.02) weights (seed 1), on the CPU."""
    if s["config"] == "fork128":
        # the fork's recipe (reference config.yaml:28-32)
        model = create_model(
            image_size=s["size"], num_channels=s["channels"], num_res_blocks=2, learn_sigma=True,
            class_cond=True, use_checkpoint=False, attention_resolutions="16,8", num_heads=1,
            num_head_channels=-1, num_heads_upsample=-1, use_scale_shift_norm=True, dropout=s["dropout"],
            use_fp16=True, conv_impl=s["conv_impl"],
        )
    else:
        # the README's 64 px training config (reference README.md:151-156)
        model = create_upstream_model(
            image_size=s["size"], num_channels=s["channels"], num_res_blocks=3, channel_mult="",
            learn_sigma=True, class_cond=True, use_checkpoint=False, attention_resolutions="32,16,8",
            num_heads=4, num_head_channels=64, num_heads_upsample=-1, use_scale_shift_norm=True,
            dropout=s["dropout"], resblock_updown=True, use_fp16=True, use_new_attention_order=True,
            conv_impl=s["conv_impl"],
        )
    return random_weights_(model, seed=1)


def make_loop(s: dict, device: torch.device, batch: int, microbatch: int) -> TrainLoop:
    """A ``TrainLoop`` of the configuration on ``device``: lr 1e-4, one EMA at 0.9999."""
    diffusion = create_gaussian_diffusion(steps=1000, learn_sigma=True, noise_schedule="cosine")
    return TrainLoop(
        model=make_model(s).to(device), diffusion=diffusion, data=None, batch_size=batch,
        microbatch=microbatch, lr=1e-4, ema_rate=0.9999, log_interval=10**9, save_interval=10**9,
        opt_impl=s["opt_impl"],
    )


def make_batch(s: dict, n: int, rs: np.random.RandomState) -> tuple:
    """A host batch (NCHW images, cond dict) of ``n`` rows."""
    x = rs.randn(n, 3, s["size"], s["size"]).astype(np.float32)
    if s["config"] == "fork128":
        return x, {"clip_feat": rs.randn(n, 512).astype(np.float32)}
    return x, {"y": rs.randint(0, 1000, (n,)).astype(np.int64)}


def step_flops(s: dict) -> float:
    """The operations of one step at the configuration's batch, counted on the
    CPU at batch 1 (the count is linear in the batch)."""
    with torch.random.fork_rng(devices=[]):
        loop = make_loop(s, torch.device("cpu"), 1, -1)
        x, cond = make_batch(s, 1, np.random.RandomState(3))
        per_sample = flops_per_step(loop.run_step, x, cond)
    return per_sample * s["batch"]


def run_window(loop: TrainLoop, data, steps: int, device: torch.device) -> float:
    """``steps`` steps on batches from ``data``, the last one's metrics
    flushed and the card synchronized; returns the seconds a step (host clock)."""
    t0 = time.perf_counter()
    for _ in range(steps):
        loop.run_step(*next(data))
        loop.step += 1
    loop.flush_metrics()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / steps


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = pick_device(args.device)
    s = settings()
    card = card_label(device)
    if device.type == "cuda":
        build.load()
        torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's defaults, as image_train leaves them
        torch.backends.cudnn.allow_tf32 = True
    logger.configure_dir(format_strs=[])
    flops = step_flops(s)
    loop = make_loop(s, device, s["batch"], s["micro"])
    rs = np.random.RandomState(0)
    data = itertools.cycle([make_batch(s, s["batch"], rs) for _ in range(2)])

    compile_s = run_window(loop, data, 1, device)
    best = min(run_window(loop, data, s["window"], device) for _ in range(s["repeats"]))
    on_card = device.type == "cuda"  # a CPU rehearsal prints no rate
    device_ms = None
    if on_card:
        def step():
            loop.run_step(*next(data))
            loop.step += 1

        device_ms = sum(ms for ms, _ in kernel_times(step).values())
        loop.flush_metrics()

    desc = (f"{s['size']}px fork recipe (ch{s['channels']}, clip_feat cond)" if s["config"] == "fork128"
            else f"{s['size']}px ADM {s['channels']}ch")
    if s["conv_impl"] != "xla":
        desc += f" [conv_impl={s['conv_impl']}]"
    if s["opt_impl"] != "tree":
        desc += f" [opt_impl={s['opt_impl']}]"
    row = {
        "config": f"{desc} train step, batch {s['batch']} (micro {loop.microbatch}), bf16",
        "ms_per_step": best * 1e3,
        "samples_per_sec_per_chip": s["batch"] / best if on_card else None,
        "compile_sec": compile_s,
        "window_steps": s["window"],
        "card": card,
        "flops_per_step": flops,
        "model_tflops_per_s": flops / best / 1e12 if on_card else None,
        "device_ms_per_step": device_ms,
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
