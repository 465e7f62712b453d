"""How many rows a block of kernels K1 and K2 should take.

    python -m guided_diffusion_clip_tpu_torch.tools.attention_tune

The sweeps behind ``ops/attention.py::fwd_q_rows``, ``f32_rows`` and
``f32_bwd_rows``. It runs on the card only: a tile has no plain version. The
C entry points are called on preallocated tensors and torch.profiler gives
each kernel's device time: a call at T = 64 is shorter than its launch from
Python, so an event around it would time the host.

  - bfloat16, at the 128 px training recipe's two attention shapes (one head,
    d = 192 at T = 256 and d = 256 at T = 64), at batch 48 and 8: K1 with 32
    and with 64 query rows a block, K2 once;
  - float32 (``F32_SHAPES``: the classifier's attention pool, the same pool
    at T = 64, which has no 1-row tail, the quality proxies' float32 shapes
    and an f32 torso's 32 px attention): K1 and K2 (both its kernels) at
    every rows a block they offer.

One row a shape is printed (us a call, mean of ``ITERS``, and the rows the
dispatch picks), then all rows as one JSON line with the card's name and
power limit.
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
# (B, T, heads, d, new_order): the pool at guidance's batch 8 and classifier_train's 16, the pool's shape at
# T = 64, the quality proxies' (tools/_proxies.py; 16 px: d = 64 and 32 at T = 64, 64 px: d = 96 and 128) at
# the tools' batch 16 and the smoke's 36, and an f32 torso's 32 px attention
F32_SHAPES = [
    (8, 65, 8, 64, True), (8, 64, 8, 64, True), (16, 65, 8, 64, True),
    *((B, T, H, d, False) for B in (16, 36)
      for T, H, d in ((64, 2, 64), (64, 2, 32), (256, 4, 96), (64, 4, 128), (256, 2, 96))),
    (8, 1024, 8, 64, False),
]


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


def f32_sweep(device, lib, stream, sms) -> list:
    """K1 and K2 in float32 at ``F32_SHAPES``, at each rows a block."""
    rows = []
    for B, T, H, d, new in F32_SHAPES:
        g = torch.Generator(device=device).manual_seed(T + d)
        qkv = torch.randn(B, T, 3 * H * d, generator=g, device=device)
        do = torch.randn(B, T, H * d, generator=g, device=device)
        out, dqkv = torch.empty_like(do), torch.empty_like(qkv)
        stats = torch.empty((3, B * H, T), dtype=torch.float32, device=device)
        scale = 1.0 / math.sqrt(math.sqrt(d))
        row = {"B": B, "T": T, "heads": H, "d": d, "new_order": new, "dtype": "float32", "unit": "us",
               "picks": {"K1": A.f32_rows(T, B * H, d, sms), "K2": A.f32_bwd_rows(T, B * H, d, sms)}}
        for r in (64, 32, 16) if d <= 64 else (64, 32) if d <= 128 else (32,):
            def fwd(r=r):
                build.check(lib.gdc_attention_fwd_f32mma(qkv.data_ptr(), out.data_ptr(), B, T, H, d, int(new), r,
                                                         scale, stream), "gdc_attention_fwd_f32mma")

            def bwd(r=r):
                build.check(lib.gdc_attention_bwd_f32mma(qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(),
                                                         stats.data_ptr(), B, T, H, d, int(new), r, scale,
                                                         scale * scale, stream), "gdc_attention_bwd_f32mma")

            row[f"K1, {r} rows"] = round(sum(device_us(fwd).values()), 2)
            row[f"K2, {r} rows"] = round(sum(device_us(bwd).values()), 2)
        print(row, flush=True)
        rows.append(row)
    return rows


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
    rows += f32_sweep(device, lib, stream, sms)
    print(json.dumps({"device": card_label(device), "shapes": rows}))
    return rows


if __name__ == "__main__":
    main()
