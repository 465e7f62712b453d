"""Which tile and split a layer should get from kernel K5's tensor-core kernel.

    python -m guided_diffusion_clip_tpu_torch.tools.conv_tune

The sweep behind ``ops/quant.py::pick_tile``'s constants. It runs on the card
only: a schedule has no plain version. The kernel library's C entry point,
which takes the tile's rows and the slices of the reduction as arguments, is
called on preallocated tensors, so that no wrapper's host time is in the
numbers (20 back-to-back calls a timing, best of 3). The large layers are
timed with the schedule ``pick_tile`` gives them; the layers with few pixels
with every (tile rows, slices) of a grid as well, the zeroing of a split
launch's scratch and its second kernel included. One row a layer is printed,
then all rows as one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import json

import torch

from ..ops import build
from ..ops import quant as Q
from ._timing import card_label, pick_device, seconds_per_call

ITERS = 20
# (name, B, H, C, K, kernel size): layers of ADM-256 and its classifier at batch 8
LARGE = [("3x3 256px 256->256", 8, 256, 256, 256, 3), ("3x3 128px 256->256", 8, 128, 256, 256, 3),
         ("3x3 64px 512->512", 8, 64, 512, 512, 3), ("1x1 128px 768->256", 8, 128, 768, 256, 1)]
SMALL = [("3x3 32px 512->512", 8, 32, 512, 512, 3), ("3x3 16px 1024->1024", 8, 16, 1024, 1024, 3),
         ("3x3 16px 1024->512", 8, 16, 1024, 512, 3), ("3x3 16px 256->512", 8, 16, 256, 512, 3),
         ("3x3 8px 2048->1024", 8, 8, 2048, 1024, 3), ("3x3 8px 1024->1024", 8, 8, 1024, 1024, 3),
         ("1x1 8px 2048->1024", 8, 8, 2048, 1024, 1), ("3x3 8px 2048->1024 batch 1", 1, 8, 2048, 1024, 3)]
GRID = [(bm, split) for bm in (128, 64) for split in (1, 2, 3, 4, 6, 9, 18)]


class Layer:
    """One conv's operands on the card, and a call of the kernel on them."""

    def __init__(self, B, H, C, K, k, device, seed=0):
        g = torch.Generator(device=device).manual_seed(seed)
        self.dims = (B, H, H, C, K, k, 1, (k - 1) // 2, H, H)
        self.q = torch.randint(-127, 128, (B, H, H, C), generator=g, device=device, dtype=torch.int8)
        w_q, self.s_w = Q.quantize_per_out_channel(torch.randn(k, k, C, K, generator=g, device=device) * 0.05)
        self.rows = Q._pack_weights(w_q)
        self.s_img = torch.rand(B, generator=g, device=device) * 0.02 + 0.001
        self.bias = torch.randn(K, generator=g, device=device) * 0.1
        self.out = torch.empty((B, H, H, K), dtype=torch.bfloat16, device=device)
        self.M, self.K, self.KRp = B * H * H, K, self.rows.shape[1]
        self.scratch = torch.empty((self.M, K), dtype=torch.int32, device=device)
        self.ops = 2 * self.M * K * k * k * C

    def call(self, bm, split):
        if split > 1:
            self.scratch.zero_()
        rc = build.load().gdc_conv_s8_mma(
            self.q.data_ptr(), self.rows.data_ptr(), self.s_img.data_ptr(), self.s_w.data_ptr(),
            self.bias.data_ptr(), self.out.data_ptr(), self.scratch.data_ptr() if split > 1 else None,
            *self.dims, self.KRp, 1, bm, split, torch.cuda.current_stream().cuda_stream)
        build.check(rc, "gdc_conv_s8_mma")


def main() -> list:
    device = pick_device("cuda")
    rows = []
    for name, B, H, C, K, k in LARGE + SMALL:
        layer = Layer(B, H, C, K, k, device)
        stages = -(-layer.KRp // 64)

        def ms(bm, split):
            return round(1e3 * seconds_per_call(lambda: layer.call(bm, split), device, ITERS), 4)

        picked = Q.pick_tile(layer.M, layer.K, layer.KRp)
        row = {"layer": name, "pick_tile": list(picked), "picked": ms(*picked)}
        row["TOP/s"] = round(layer.ops / row["picked"] / 1e9, 1)
        if (name, B, H, C, K, k) in SMALL:
            row.update({f"{bm},{split}": ms(bm, split) for bm, split in GRID if split <= stages})
        print(row, flush=True)
        rows.append(row)
    print(json.dumps({"device": card_label(device), "unit": "ms", "layers": rows}))
    return rows


if __name__ == "__main__":
    main()
