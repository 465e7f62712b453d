"""Time one GroupNorm+SiLU -> 3x3 conv pair on the card: bf16 against int8.

    python -m guided_diffusion_clip_tpu_torch.tools.block_microbench [--device cuda]

Counterpart of ``tools/block_microbench.py``: where the int8 path's time goes
at the size of one ResBlock half, at the JAX tool's four shapes
(``B x H x C -> K``, square NHWC bf16 maps, 32 groups, f32 scale and shift).
The convs are the models' own ``Conv2d`` modules (``models/nn.py``), so each
row runs what a UNet runs:

    bf16_block  K3 (GroupNorm + SiLU, bf16 out), then cuDNN's 3x3 conv in
                bf16 (the bf16 torso's conv: bf16 weights and bias)
    int8_block  K4 (the same GroupNorm with an s8 output and a per-image
                scale), then K5 on it through ``conv_prequant``, f32 out, the
                weight's quantization cached as the module caches it
    gn_only     K3 alone
    gnq_only    K4 alone

and, derived as in the JAX tool, ``conv_bf16_tfs`` and ``conv_int8_tfs``:
2 * B * H * H * C * K * 9 operations over the block's time less its
GroupNorm's. Each time is ``CMB_ITERS`` (20) back-to-back calls between two
CUDA events after a warm-up call, best of three (``_timing.seconds_per_call``).
``BMB_SHAPES`` (e.g. ``1x8x64x64``) replaces the four shapes, for rehearsing
the tool on the CPU at a small size; the JAX tool's ``BMB_GN_IMPL`` is not
read: the port dispatches by device.

Each row names the card and its power limit (``card``), and the rows are
printed one a line, then all of them as one JSON line. ``--device cpu`` runs
the plain versions, for rehearsing the tool only: it prints times but no rate.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..models.nn import conv2d
from ..ops import build
from ..ops.groupnorm import group_norm, group_norm_quant
from ._timing import card_label, pick_device, seconds_per_call

SHAPES = [
    (16, 64, 512, 512),
    (16, 128, 256, 256),
    (16, 256, 256, 256),
    (16, 32, 512, 512),
]


def _shapes():
    spec = os.environ.get("BMB_SHAPES")
    if not spec:
        return SHAPES
    return [tuple(int(v) for v in s.split("x")) for s in spec.split(",")]


def make_block(B, H, C, K, device) -> tuple:
    """(x NHWC bf16, gamma, beta, the f32 conv module, its bf16 copy in the
    torso's layout), from seed 0 as the JAX tool draws them."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(B, H, H, C).astype(np.float32)).to(device).bfloat16()
    gamma = torch.from_numpy((rs.rand(C) + 0.5).astype(np.float32)).to(device)
    beta = torch.from_numpy((rs.randn(C) * 0.1).astype(np.float32)).to(device)
    w = rs.randn(3, 3, C, K).astype(np.float32) * 0.05  # HWIO
    b = rs.randn(K).astype(np.float32)
    conv = conv2d(C, K, 3)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        conv.bias.copy_(torch.from_numpy(b))
    conv = conv.to(device, memory_format=torch.channels_last).requires_grad_(False)
    conv_bf16 = conv2d(C, K, 3).to(device, torch.bfloat16, memory_format=torch.channels_last)
    conv_bf16.load_state_dict(conv.state_dict())
    return x, gamma, beta, conv, conv_bf16.requires_grad_(False)


def rows_of(x, gamma, beta, conv, conv_bf16) -> dict:
    """The four timed functions of one shape, each of no argument."""

    def gn(xx):
        return group_norm(xx, gamma, beta, groups=32, silu=True)

    def gnq(xx):
        return group_norm_quant(xx, gamma, beta, groups=32, silu=True)

    def bf16_block():
        return conv_bf16(gn(x).permute(0, 3, 1, 2))

    def int8_block():
        q, s = gnq(x)
        return conv(q.permute(0, 3, 1, 2), prequant_scales=s)

    return {"bf16_block": bf16_block, "int8_block": int8_block, "gn_only": lambda: gn(x),
            "gnq_only": lambda: gnq(x)[0]}


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = pick_device(args.device)
    iters = int(os.environ.get("CMB_ITERS", 20))
    card = card_label(device)
    on_card = device.type == "cuda"
    if on_card:
        build.load()
    results = []
    with torch.no_grad():
        for B, H, C, K in _shapes():
            fns = rows_of(*make_block(B, H, C, K, device))
            row = {"shape": f"B{B} {H}x{H} {C}->{K}"}
            for name, fn in fns.items():
                row[name + "_ms"] = seconds_per_call(fn, device, iters) * 1e3
            flops = 2 * B * H * H * C * K * 9
            # a CPU rehearsal prints no rate
            row["conv_bf16_tfs"] = flops / (row["bf16_block_ms"] - row["gn_only_ms"]) / 1e9 if on_card else None
            row["conv_int8_tfs"] = flops / (row["int8_block_ms"] - row["gnq_only_ms"]) / 1e9 if on_card else None
            row["card"] = card
            print(json.dumps(row), flush=True)
            results.append(row)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
