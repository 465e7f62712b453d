"""How many query rows a block of kernel K1 should take at d = 192 and 256.

    python -m guided_diffusion_clip_tpu_torch.tools.attention_tune

The sweep behind ``ops/attention.py::fwd_q_rows``. It runs on the card only:
a tile has no plain version. At the 128 px training recipe's two attention
shapes (one head, d = 192 at T = 256 and d = 256 at T = 64), at batch 48 and
8, K1's C entry point is called with 32 and with 64 query rows a block on
preallocated tensors, and K2's once, and torch.profiler gives each kernel's
device time: a call at T = 64 is shorter than its launch from Python, so an
event around it would time the host. One row a shape is printed (us a call,
mean of ``ITERS``, and the rows ``fwd_q_rows`` picks), then all rows as one
JSON line with the card's name and power limit.
"""

from __future__ import annotations

import json
import math

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..ops import attention as A
from ..ops import build
from ._timing import card_label, pick_device

ITERS = 20
SHAPES = [(48, 256, 1, 192), (48, 64, 1, 256), (8, 256, 1, 192), (8, 64, 1, 256)]  # (B, T, heads, d)


def device_us(fn) -> dict:
    """Device time (us a call, mean of ITERS calls after one warm-up) of each
    kernel ``fn`` launches, by kernel name."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / ITERS for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def main() -> list:
    device = pick_device("cuda")
    lib = build.load()
    stream = torch.cuda.current_stream(device).cuda_stream
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for B, T, H, d in SHAPES:
        g = torch.Generator(device=device).manual_seed(T + d)
        qkv = torch.randn(B, T, 3 * H * d, generator=g, device=device).bfloat16()
        do = torch.randn(B, T, H * d, generator=g, device=device).bfloat16()
        out, dqkv = torch.empty_like(do), torch.empty_like(qkv)
        stats = torch.empty((3, B * H, T), dtype=torch.float32, device=device)
        scale = 1.0 / math.sqrt(math.sqrt(d))
        row = {"B": B, "T": T, "heads": H, "d": d, "unit": "us", "picks": A.fwd_q_rows(T, B * H, d, sms)}
        for q_rows in (32, 64):
            def fwd(q_rows=q_rows):
                build.check(lib.gdc_attention_fwd_mma(qkv.data_ptr(), out.data_ptr(), B, T, H, d, 0, q_rows, scale,
                                                      stream), "gdc_attention_fwd_mma")

            row[f"K1, {q_rows} rows"] = round(sum(device_us(fwd).values()), 2)

        def bwd():
            build.check(lib.gdc_attention_bwd_mma(qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
                                                  B, T, H, d, 0, scale, scale * scale, stream), "gdc_attention_bwd_mma")

        for name, us in device_us(bwd).items():
            row["K2, dQ kernel" if "dq_kernel" in name else "K2, dK/dV kernel"] = round(us, 2)
        print(row, flush=True)
        rows.append(row)
    print(json.dumps({"device": card_label(device), "shapes": rows}))
    return rows


if __name__ == "__main__":
    main()
