"""Benchmark the fused 3x3 conv (kernel K6) against cuDNN and the int8 path.

    python -m guided_diffusion_clip_tpu_torch.tools.conv_bench [--device cuda]

Counterpart of ``tools/pallas_conv_bench.py``: the same five shapes
(``B x H x C x K``, square images, 3x3 stride 1) and the same environment
variables, ``PCB_SHAPES`` (e.g. ``16x256x256x256,16x128x256x256``),
``PCB_ONLY`` (a substring that picks strategies) and ``CMB_ITERS`` (calls per
timing, default 20). Four strategies a shape, each from the same f32 NHWC x,
HWIO w and bias:

    cudnn_bf16  x and w cast to bf16, cuDNN's conv, + bias
    k5_int8     the port's ``int8_conv`` (per-tensor quantize, kernel K5) + bias
    k6_bf16     ``fused_conv3x3(..., quantized=False)``
    k6_int8     ``fused_conv3x3(..., quantized=True)``

and reports TF/s per strategy (2 * B * H * W * C * K * 9 operations over the
best of three timings, CUDA events), one row a shape and the rows again as one
JSON line. The card is the default device, and a missing card is an error;
``--device cpu`` runs the plain versions, for rehearsing the tool only: it
reports no rate.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.fused_conv import fused_conv3x3, supports_shape
from ..ops.quant import int8_conv
from ._timing import card_label, pick_device, seconds_per_call

SHAPES = [
    (16, 256, 256, 256),
    (16, 128, 256, 256),
    (16, 64, 512, 512),
    (16, 32, 512, 512),
    (16, 16, 1024, 1024),
]


def _shapes():
    spec = os.environ.get("PCB_SHAPES")
    if not spec:
        return SHAPES
    return [tuple(int(v) for v in s.split("x")) for s in spec.split(",")]


def _cudnn_bf16(x, w, b):
    y = F.conv2d(
        x.bfloat16().permute(0, 3, 1, 2), w.bfloat16().permute(3, 2, 0, 1), padding=1,
    )
    return y.permute(0, 2, 3, 1).float() + b


STRATEGIES = {
    "cudnn_bf16": _cudnn_bf16,
    "k5_int8": lambda x, w, b: int8_conv(x, w) + b,
    "k6_bf16": lambda x, w, b: fused_conv3x3(x, w, b, quantized=False),
    "k6_int8": lambda x, w, b: fused_conv3x3(x, w, b, quantized=True),
}


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = pick_device(args.device)
    which = os.environ.get("PCB_ONLY", "")
    iters = int(os.environ.get("CMB_ITERS", 20))
    card = card_label(device)
    results = []
    with torch.no_grad():
        for B, H, C, K in _shapes():
            W = H
            rs = np.random.RandomState(0)
            x = torch.from_numpy(rs.randn(B, H, W, C).astype(np.float32)).to(device)
            w = torch.from_numpy((rs.randn(3, 3, C, K) * 0.05).astype(np.float32)).to(device)
            b = torch.from_numpy(rs.randn(K).astype(np.float32)).to(device)
            flops = 2 * B * H * W * C * K * 9
            row = {"shape": f"B{B} {H}x{W} {C}->{K}", "supported": supports_shape(B, H, W, C, K),
                   "device": card, "unit": "TF/s"}
            for name, fn in STRATEGIES.items():
                if which and which not in name:
                    continue
                if name.startswith("k6_") and not row["supported"]:
                    continue
                t = seconds_per_call(lambda: fn(x, w, b), device, iters)
                # a CPU rehearsal shows that the strategy ran, not a rate
                row[name] = round(flops / t / 1e12, 3) if device.type == "cuda" else None
            print(row, flush=True)
            results.append(row)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
