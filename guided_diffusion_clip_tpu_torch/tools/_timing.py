"""Shared by the tools: device choice, the card's label, a timer and random
weights."""

from __future__ import annotations

import subprocess
import time

import torch


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
    output layers would make a UNet's output exactly 0); returns ``model``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.copy_(torch.randn(t.shape, generator=g) * 0.02)
    return model
