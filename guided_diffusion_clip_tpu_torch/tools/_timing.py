"""Shared by the tools: device choice, the card's label and a timer."""

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


def seconds_per_call(fn, device: torch.device, iters: int, repeats: int = 3) -> float:
    """Best of ``repeats`` runs of ``iters`` back-to-back calls after one
    warm-up call: CUDA events on the card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            elapsed = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            elapsed = time.perf_counter() - t0
        best = min(best, elapsed)
    return best / iters
