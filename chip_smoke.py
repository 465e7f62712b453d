#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100 (sm_90a).

    python3 chip_smoke.py

Drives the port's two main paths end to end, the serving path at the
ADM-256 widths of the fork's CLIP-conditioned UNet and classifier-guided
sampling with ADM-G 256 and its classifier, and exits non-zero if any phase
fails:

  1. device: the card's name, power limit and compute capability (9, 0);
  2. build: the CUDA kernels of ``guided_diffusion_clip_tpu_torch/ops/csrc``
     compiled from this checkout (one nvcc per source, in parallel);
  3. each forward kernel (K1 attention, K3 GroupNorm) against its plain
     PyTorch version on the card, at the shapes the paths give it, in f32
     (TF32 off) and bf16, with kernel and plain times (median of 12 runs
     after warm-up, CUDA events);
  3b. the same for K2 (attention backward) at the classifier's shapes;
  4. one full-width forward (batch 1, f32, TF32 off) on the card, through the
     kernels, against the same forward on the CPU, through the plain versions;
  4b. the full-width classifier's logits and guidance gradient (batch 1,
     f32, TF32 off), card (K1, K2, K3) against the CPU (plain versions);
  5. the HTTP server (``guided_diffusion_clip_tpu_torch.serve``) built from
     flags with random weights loaded from a .pt, answering /healthz and
     /sample requests (padded, explicit clip_feat, chunked, coalesced), with
     the kernels' launch counters checked against the forwards it ran;
  6. ``classifier_sample.main`` on the bf16 ADM-G 256 UNet and classifier
     (random weights from .pt files), 250 ancestral steps at batch 8, with
     the launch counters checked against the steps it ran; then one guided
     step timed by part and profiled by kernel.

The int8 path (``--conv_impl int8``, kernels K4 and K5) adds:
  3c. K4 (the quantizing GroupNorm) against its plain version at the paths'
      shapes, with and without scale-shift, f32 and bf16, both emissions;
  3d. K5 (the s8 conv) against its plain version, and cuDNN's bf16 conv
      timed at the same shapes: 3x3 at 256/32/8 px, the stem, the head,
      a 1x1 and a stride-2 conv;
  4c. a full-width int8 forward (batch 1, f32, TF32 off), card against
      CPU, teacher-forced: every quantizing GroupNorm's (q, s) and every
      per-tensor int8 conv's output is checked against the CPU's and
      replaced by it (a level that rounds the other way would otherwise
      move every later layer), the output head compared;
  4d. the same for the full-width int8 classifier's logits and guidance
      gradient;
  5b. ``serve --conv_impl int8`` answering requests (the same request
      twice gives the same bytes);
  6b. ``classifier_sample.main --conv_impl int8`` at batch 8, with its
      samples' spread held to the bf16 chain's, and one int8 guided step
      timed by part and profiled by kernel.

Every count is set to 0 just before each main path (phases 5, 5b, 6 and 6b)
and read just after it. The last lines are the kernels' JSON record
(``launches`` summed over the main paths), the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

SLICE_FLAGS = [
    "--image_size", "256", "--num_channels", "256", "--num_res_blocks", "2",
    "--attention_resolutions", "32,16,8", "--num_head_channels", "64",
    "--resblock_updown", "True", "--use_scale_shift_norm", "True",
    "--learn_sigma", "True", "--class_cond", "True", "--use_fp16", "True",
    "--noise_schedule", "linear", "--diffusion_steps", "1000",
    "--timestep_respacing", "ddim25", "--use_ddim", "True",
    "--batch_size", "8", "--batch_buckets", "1,4", "--coalesce_ms", "50",
]
ATTN_PER_FORWARD = 16  # attention blocks of the ADM-256 UNet at 32/16/8 px
GN_PER_FORWARD = 101   # 42 ResBlocks x 2 + 16 attention norms + the head
# ADM-G 256 and its classifier (bench.py:170-198), 250 respaced ancestral steps
GUIDED_FLAGS = [
    "--image_size", "256", "--num_channels", "256", "--num_res_blocks", "2",
    "--attention_resolutions", "32,16,8", "--num_heads", "4", "--num_head_channels", "64",
    "--resblock_updown", "True", "--use_scale_shift_norm", "True", "--learn_sigma", "True",
    "--class_cond", "True", "--use_fp16", "True", "--noise_schedule", "linear",
    "--diffusion_steps", "1000", "--timestep_respacing", "250",
    "--classifier_use_fp16", "True", "--classifier_width", "128", "--classifier_depth", "2",
    "--classifier_attention_resolutions", "32,16,8", "--classifier_use_scale_shift_norm", "True",
    "--classifier_resblock_updown", "True", "--classifier_pool", "attention",
    "--classifier_scale", "1.0", "--batch_size", "8", "--num_samples", "8", "--seed", "0",
]
# per guided step: the UNet forward (16 K1, 101 K3), the classifier forward
# (7 attention blocks + the pool: 8 K1; 19 ResBlocks x 2 + 7 + out_norm: 46
# K3) and its backward (8 K2)
CLF_ATTN_PER_FORWARD = 8
CLF_GN_PER_FORWARD = 46
WEIGHT_SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 12, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def tf32_off() -> None:
    """Full f32 matmuls and convs, for comparisons in f32."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase3_kernels(dev):
    """Each kernel against its plain version; returns the headline records."""
    import torch

    from guided_diffusion_clip_tpu_torch.ops import attention as A
    from guided_diffusion_clip_tpu_torch.ops import groupnorm as G

    tf32_off()
    g = torch.Generator(device=dev).manual_seed(1)
    records = {}

    def check(name, out, ref, dtype, kind):
        diff = (out.float() - ref.float()).abs()
        scale = ref.float().abs().clamp(min=1.0)
        if dtype == torch.float32 and kind == "attn":
            bound, ok = "max|d| <= 1e-4", bool(diff.max() <= 1e-4)
        elif dtype == torch.float32:
            bound, ok = "|d| <= 1e-5*max(1,|ref|)", bool((diff <= 1e-5 * scale).all())
        else:
            bound, ok = "|d| <= 2e-2*max(1,|ref|)", bool((diff <= 2e-2 * scale).all())
        err = diff.max().item()
        if not torch.isfinite(out.float()).all() or not ok:
            raise AssertionError(f"{name}: max|d| {err:.3g} fails {bound}")
        return err, bound

    attn_cases = [  # (B, T, heads, d, new_order)
        (8, 1024, 8, 64, False), (8, 256, 16, 64, False), (8, 64, 16, 64, False),
        (8, 256, 16, 64, True), (8, 65, 4, 64, False),
        (8, 256, 1, 192, False), (8, 64, 1, 192, False),
        (8, 256, 1, 256, False), (8, 64, 1, 256, False),
    ]
    with torch.inference_mode():
        for B, T, H, d, new in attn_cases:
            for dtype in (torch.float32, torch.bfloat16):
                qkv = torch.randn(B, T, 3 * H * d, generator=g, device=dev).to(dtype)
                out = A.attention_fwd_cuda(qkv, H, new_order=new)
                ref = A.qkv_attention_plain(qkv, H, new_order=new)
                torch.cuda.synchronize()
                name = f"K1 attention B={B} T={T} heads={H} d={d} {'new' if new else 'legacy'} {str(dtype)[6:]}"
                err, bound = check(name, out, ref, dtype, "attn")
                ms = cuda_ms(lambda: A.attention_fwd_cuda(qkv, H, new_order=new))
                pms = cuda_ms(lambda: A.qkv_attention_plain(qkv, H, new_order=new))
                log(f"  {name}: max|d| {err:.3g} ({bound}); kernel {ms:.4f} ms, plain {pms:.4f} ms")
                if (B, T, H, d, new, dtype) == (8, 1024, 8, 64, False, torch.bfloat16):
                    records["attention"] = (err, ms, pms)

        for B, hw, C in [(8, 256 * 256, 256), (8, 8 * 8, 1024)]:
            for dtype in (torch.float32, torch.bfloat16):
                for fused in (False, True):
                    x = (torch.randn(B, hw, C, generator=g, device=dev) * 2 + 0.5).to(dtype)
                    w = torch.randn(C, generator=g, device=dev) * 0.1 + 1
                    b = torch.randn(C, generator=g, device=dev) * 0.1
                    ss = None
                    if fused:
                        ss = (torch.randn(B, C, generator=g, device=dev) * 0.2,
                              torch.randn(B, C, generator=g, device=dev) * 0.2)
                    args = (x, w, b, 32, 1e-5, fused, ss)
                    out = G.fused_group_norm(*args)
                    ref = G.group_norm_plain(*args)
                    torch.cuda.synchronize()
                    name = (f"K3 group_norm x=({B},{hw},{C}) {str(dtype)[6:]} "
                            f"{'scale-shift+silu' if fused else 'plain affine'}")
                    err, bound = check(name, out, ref, dtype, "gn")
                    ms = cuda_ms(lambda: G.fused_group_norm(*args))
                    pms = cuda_ms(lambda: G.group_norm_plain(*args))
                    log(f"  {name}: max|d| {err:.3g} ({bound}); kernel {ms:.4f} ms, plain {pms:.4f} ms")
                    if (B, hw, C, dtype, fused) == (8, 65536, 256, torch.bfloat16, True):
                        records["group_norm"] = (err, ms, pms)
    return records


def phase3b_attention_bwd(dev):
    """K2 against attention_bwd_plain at the classifier's shapes; returns the
    headline record (T = 1024, bf16)."""
    import torch

    from guided_diffusion_clip_tpu_torch.ops import attention as A

    tf32_off()
    g = torch.Generator(device=dev).manual_seed(5)
    record = None
    cases = [  # (B, T, heads, d, new_order): the classifier's blocks at batch 8, then its pool
        (8, 1024, 4, 64, False), (8, 256, 8, 64, False), (8, 64, 8, 64, False), (8, 65, 8, 64, True),
    ]
    for B, T, H, d, new in cases:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            qkv = torch.randn(B, T, 3 * H * d, generator=g, device=dev).to(dtype)
            do = torch.randn(B, T, H * d, generator=g, device=dev).to(dtype)
            out = A.attention_bwd_cuda(qkv, do, H, new_order=new)
            ref = A.qkv_attention_bwd_plain(qkv, do, H, new)
            torch.cuda.synchronize()
            name = f"K2 attention_bwd B={B} T={T} heads={H} d={d} {'new' if new else 'legacy'} {str(dtype)[6:]}"
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            bound = f"|d| <= {tol:g}*max(1,|ref|)"
            if not torch.isfinite(out.float()).all() or not bool((diff <= tol * ref.float().abs().clamp(min=1.0)).all()):
                raise AssertionError(f"{name}: max|d| {err:.3g} fails {bound}")
            if not torch.equal(A.attention_bwd_cuda(qkv, do, H, new_order=new), out):
                raise AssertionError(f"{name}: a repeat run gave other bits")
            ms = cuda_ms(lambda: A.attention_bwd_cuda(qkv, do, H, new_order=new))
            pms = cuda_ms(lambda: A.qkv_attention_bwd_plain(qkv, do, H, new))
            log(f"  {name}: max|d| {err:.3g} ({bound}), repeat bit-identical; kernel {ms:.4f} ms, plain {pms:.4f} ms")
            if (T, dtype) == (1024, torch.bfloat16):
                record = (err, ms, pms)
    return record


def phase3c_group_norm_quant(dev):
    """K4 against group_norm_quant_plain at the paths' shapes; returns the
    headline record ((8, 65536, 256) bf16, scale-shift, s8)."""
    import torch

    from guided_diffusion_clip_tpu_torch.ops import groupnorm as G

    tf32_off()
    g = torch.Generator(device=dev).manual_seed(7)
    record = None
    with torch.inference_mode():
        for B, hw, C in [(8, 256 * 256, 256), (8, 32 * 32, 512), (8, 8 * 8, 2048)]:
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.randn(B, hw, C, generator=g, device=dev) * 2 + 0.5).to(dtype)
                w = torch.randn(C, generator=g, device=dev) * 0.1 + 1
                b = torch.randn(C, generator=g, device=dev) * 0.1
                for fused in (False, True):
                    ss = None
                    if fused:
                        ss = (torch.randn(B, C, generator=g, device=dev) * 0.2,
                              torch.randn(B, C, generator=g, device=dev) * 0.2)
                    for out_dtype in (torch.int8, dtype):
                        args = (x, w, b, 32, 1e-5, True, ss, out_dtype)
                        q, sc = G.fused_group_norm_quant(*args)
                        rq, rsc = G.group_norm_quant_plain(*args)
                        torch.cuda.synchronize()
                        name = (f"K4 group_norm_quant x=({B},{hw},{C}) {str(dtype)[6:]} "
                                f"{'scale-shift+silu' if fused else 'silu'} emit {str(out_dtype)[6:]}")
                        d = (q.float() - rq.float()).abs()
                        flips = int((d > 0).sum())
                        s_err = ((sc - rsc).abs() / rsc).max().item()
                        if (q.dtype != out_dtype or d.max() > 1 or flips > max(1, 1e-4 * d.numel())
                                or not s_err <= 1e-6):
                            raise AssertionError(f"{name}: s rel err {s_err:.3g} (bound 1e-6), q max|d| "
                                                 f"{d.max().item()}, {flips} of {d.numel()} off (bound 1e-4)")
                        # in y's units: q * s against the plain version's
                        bshape = (B,) + (1,) * (q.dim() - 1)
                        deq = (q.float() * sc.reshape(bshape) - rq.float() * rsc.reshape(bshape)).abs().max().item()
                        ms = cuda_ms(lambda: G.fused_group_norm_quant(*args))
                        pms = cuda_ms(lambda: G.group_norm_quant_plain(*args))
                        log(f"  {name}: s rel err {s_err:.3g} (bound 1e-6), q off by one on {flips} "
                            f"(bound 1e-4 of {d.numel()}), max|q*s - ref| {deq:.3g}; kernel {ms:.4f} ms, "
                            f"plain {pms:.4f} ms")
                        if (hw, dtype, fused, out_dtype) == (65536, torch.bfloat16, True, torch.int8):
                            record = (deq, ms, pms)
    return record


def phase3d_conv_s8(dev):
    """K5 against conv_s8_plain at the paths' shapes (batch 8), and cuDNN's
    bf16 conv timed at the same shapes; returns the headline record (3x3 at
    256 px, 256 -> 256, bf16 out)."""
    import torch
    import torch.nn.functional as F

    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    tf32_off()
    g = torch.Generator(device=dev).manual_seed(8)
    record = None
    cases = [  # (name, H, C, K, k, stride, per-image scales)
        ("3x3 256px", 256, 256, 256, 3, 1, True), ("3x3 32px", 32, 512, 512, 3, 1, True),
        ("3x3 8px", 8, 2048, 1024, 3, 1, True), ("stem", 256, 3, 256, 3, 1, False),
        ("head", 256, 256, 6, 3, 1, False), ("1x1 8px", 8, 2048, 1024, 1, 1, False),
        ("3x3 stride 2 64px", 64, 256, 256, 3, 2, False),
    ]
    with torch.inference_mode():
        for name, H, C, K, k, stride, per_image in cases:
            B = 8
            q = torch.randint(-127, 128, (B, H, H, C), generator=g, device=dev, dtype=torch.int8)
            w_q, s_w = Q.quantize_per_out_channel(torch.randn(k, k, C, K, generator=g, device=dev) * 0.05)
            s_img = torch.rand(B, generator=g, device=dev) * 0.02 + 0.001 if per_image else None
            bias = torch.randn(K, generator=g, device=dev) * 0.1
            xb = q.to(torch.bfloat16).permute(0, 3, 1, 2)  # channels_last NCHW view
            wb = w_q.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            cudnn_ms = cuda_ms(lambda: F.conv2d(xb, wb, stride=stride, padding=(k - 1) // 2))
            for out_dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
                args = (q, w_q, s_img, s_w, bias, stride, out_dtype)
                out = Q.conv_s8_cuda(*args)
                ref = Q.conv_s8_plain(*args)
                torch.cuda.synchronize()
                diff = (out.float() - ref.float()).abs()
                err = diff.max().item()
                label = f"K5 conv_s8 {name} B={B} {C}->{K} out {str(out_dtype)[6:]}"
                if out.shape != ref.shape or not bool((diff <= tol * ref.float().abs().clamp(min=1)).all()):
                    raise AssertionError(f"{label}: max|d| {err:.3g} fails {tol:g}*max(1,|ref|)")
                ms = cuda_ms(lambda: Q.conv_s8_cuda(*args))
                pms = cuda_ms(lambda: Q.conv_s8_plain(*args))
                log(f"  {label}: max|d| {err:.3g} (bound {tol:g}*max(1,|ref|)); kernel {ms:.4f} ms, "
                    f"plain {pms:.4f} ms, cuDNN bf16 conv {cudnn_ms:.4f} ms")
                if (name, out_dtype) == ("3x3 256px", torch.bfloat16):
                    record = (err, ms, pms)
            del q, xb
    return record


def counters() -> dict:
    """Every kernel wrapper's launch count."""
    from guided_diffusion_clip_tpu_torch.ops import attention as A
    from guided_diffusion_clip_tpu_torch.ops import groupnorm as G
    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    return {"attention": A.attention_fwd_cuda.launches, "attention_bwd": A.attention_bwd_cuda.launches,
            "group_norm": G.fused_group_norm.launches,
            "group_norm_quant": G.fused_group_norm_quant.launches, "conv_s8": Q.conv_s8_cuda.launches}


def reset_counters() -> None:
    from guided_diffusion_clip_tpu_torch.ops import attention as A
    from guided_diffusion_clip_tpu_torch.ops import groupnorm as G
    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    for fn in (A.attention_fwd_cuda, A.attention_bwd_cuda, G.fused_group_norm, G.fused_group_norm_quant,
               Q.conv_s8_cuda):
        fn.launches = 0


def gn_conv_counts(model, int8: bool) -> dict:
    """K3, K4 and K5 launches of one forward of ``model``'s structure with
    ``int8`` or without, counted from its modules: under int8 every ResBlock's
    out_norm and every in_norm but a down block's quantizes (K4), every
    other GroupNorm is K3, and every conv runs K5 once; otherwise every
    GroupNorm is K3 and no conv runs K5."""
    from guided_diffusion_clip_tpu_torch.models.nn import Conv2d, GroupNorm32
    from guided_diffusion_clip_tpu_torch.models.unet import ResBlock

    mods = list(model.modules())
    gn = sum(isinstance(m, GroupNorm32) for m in mods)
    if not int8:
        return {"group_norm": gn, "group_norm_quant": 0, "conv_s8": 0}
    k4 = sum((1 if m.down else 2) for m in mods if isinstance(m, ResBlock))
    return {"group_norm": gn - k4, "group_norm_quant": k4, "conv_s8": sum(isinstance(m, Conv2d) for m in mods)}


def random_state_dict(model):
    """N(0, 0.02) for every weight, from a seed (as bench.py fills its
    params): the module's zero-init output layers would make the UNet's
    output exactly 0."""
    import torch

    g = torch.Generator().manual_seed(WEIGHT_SEED)
    return {
        k: torch.randn(v.shape, generator=g, dtype=torch.float32) * 0.02
        for k, v in sorted(model.state_dict().items())
    }


def phase4_forward(dev, sd):
    """Full-width forward, batch 1, f32: card (kernels) vs CPU (plain)."""
    import torch

    from guided_diffusion_clip_tpu_torch.utils.script_util import create_model

    tf32_off()
    model = create_model(
        256, 256, 2, learn_sigma=True, class_cond=True, attention_resolutions="32,16,8",
        num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True, use_fp16=False,
    ).eval()
    model.load_state_dict(sd, strict=True)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 3, 256, 256, generator=g)
    t = torch.tensor([500])
    feat = torch.randn(1, 512, generator=g)
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = model(x, t, clip_feat=feat)
        cpu_s = time.perf_counter() - t0
        model.to(dev)
        out = model(x.to(dev), t.to(dev), clip_feat=feat.to(dev)).cpu()
    if out.shape != (1, 6, 256, 256) or not torch.isfinite(out).all():
        raise AssertionError(f"forward output {tuple(out.shape)} not finite (1, 6, 256, 256)")
    rel = ((out - ref).norm() / ref.norm()).item()
    log(f"  forward (1, 3, 256, 256) f32: |ref| {ref.norm().item():.4g}, rel L2 err card vs CPU "
        f"{rel:.3g} (bound 1e-3); CPU forward {cpu_s:.2f} s")
    if not ref.norm() > 0 or not rel <= 1e-3:
        raise AssertionError(f"card forward differs from the CPU forward: rel L2 {rel:.3g}")
    del model


def phase4b_guidance(dev):
    """The full-width classifier, batch 1, f32: logits and classifier_cond_fn's
    dx on the card (K1, K2, K3) against the CPU (plain versions)."""
    import torch

    from guided_diffusion_clip_tpu_torch.diffusion.guidance import classifier_cond_fn
    from guided_diffusion_clip_tpu_torch.ops import attention as A
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_classifier

    tf32_off()
    clf = create_classifier(256, False, 128, 2, "32,16,8", True, True, "attention").eval()
    clf.load_state_dict(random_state_dict(clf), strict=True)
    clf.requires_grad_(False)
    cond = classifier_cond_fn(clf, 1.0)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(1, 3, 256, 256, generator=g)
    t, y = torch.tensor([500]), torch.tensor([417])
    with torch.no_grad():
        t0 = time.perf_counter()
        ref_logits, ref_dx = clf(x, t), cond(x, t, y=y)
        cpu_s = time.perf_counter() - t0
        clf.to(dev)
        k2 = A.attention_bwd_cuda.launches
        logits = clf(x.to(dev), t.to(dev)).cpu()
        dx = cond(x.to(dev), t.to(dev), y=y.to(dev)).cpu()
    if A.attention_bwd_cuda.launches - k2 != CLF_ATTN_PER_FORWARD:
        raise AssertionError(f"guidance gradient ran K2 {A.attention_bwd_cuda.launches - k2} times, "
                             f"not {CLF_ATTN_PER_FORWARD}")
    for name, out, ref, shape in (("logits", logits, ref_logits, (1, 1000)), ("dx", dx, ref_dx, (1, 3, 256, 256))):
        if out.shape != shape or not torch.isfinite(out).all():
            raise AssertionError(f"guidance {name}: {tuple(out.shape)} not finite {shape}")
        rel = ((out - ref).norm() / ref.norm()).item()
        log(f"  classifier {name} {shape} f32: |ref| {ref.norm().item():.4g}, rel L2 err card vs CPU "
            f"{rel:.3g} (bound 1e-3)")
        if not ref.norm() > 0 or not rel <= 1e-3:
            raise AssertionError(f"card guidance {name} differs from the CPU: rel L2 {rel:.3g}")
    log(f"  CPU classifier forward + guidance gradient {cpu_s:.2f} s")


class Int8Forcing:
    """Teacher forcing of an int8 model's roundings, from the CPU to the card.

    ``record(model)``: forward hooks keep each quantizing GroupNorm's
    (q, s) and each per-tensor int8 conv's output of the next forwards (the
    plain versions on the CPU), in call order. ``force(model)``: in the same
    forwards on the card, each such output is checked against the recorded
    one (s to rtol 1e-5, for f32 sums in another order on the CPU, plus 8
    (mean / std)^2 ulps of the group; q within one level on at most 1e-4 of
    it; the
    conv's relative L2 within 5e-3 and max within 1e-2 * max|ref|, as one
    flipped level of x_q moves a 3x3 patch by s_x * |w|) and replaced by it,
    keeping the card's gradient. Without it, a value that rounds the other
    way in the card's sums moves the next layer's inputs by a level's worth
    and the flips compound layer by layer. The output heads (``out.*``) are
    left alone: the caller compares what they give.
    """

    def __init__(self):
        self.rec = []
        self.pos = 0
        self.flips = self.elems = 0
        self.s_err = self.conv_l2 = 0.0
        self.handles = []

    def _hook(self, forcing):
        import torch

        def hook(mod, args, kwargs, out):
            quant_gn = kwargs.get("quantize", False)
            if not quant_gn and (kwargs.get("prequant_scales") is not None or not getattr(mod, "int8", False)):
                return None
            if not forcing:
                self.rec.append(tuple(t.detach().cpu().clone() for t in (out if quant_gn else (out,))))
                return None
            ref = self.rec[self.pos]
            self.pos += 1
            if quant_gn:
                (q, sc), (rq, rsc) = out, ref
                d = (q.detach().float().cpu() - rq.float()).abs()
                flips = int((d > 0).sum())
                s_err = ((sc.cpu() - rsc).abs() / rsc).max().item()
                # f32 sums of up to 2^21 terms in another order on the CPU
                # (~1e-6), and the one-pass variance E[x^2] - mean^2 loses
                # (mean / std)^2 ulps, a few times over, where a group is offset
                x = args[0].detach().movedim(1, -1).double()
                xg = x.reshape(x.shape[0], -1, 32, x.shape[-1] // 32)
                ratio = (xg.mean((1, 3)).abs() / xg.std((1, 3))).max().item()
                s_tol = 1e-5 + ratio**2 * 2.0**-20
                if d.max() > 1 or flips > max(1, 1e-4 * d.numel()) or not s_err <= s_tol:
                    raise AssertionError(f"int8 forcing: q max|d| {d.max().item()}, {flips} of {d.numel()} "
                                         f"off (bound 1e-4), s rel err {s_err:.3g} (bound {s_tol:.3g})")
                self.flips += flips
                self.elems += d.numel()
                self.s_err = max(self.s_err, s_err)
                rq = rq.to(device=q.device, dtype=q.dtype).contiguous(memory_format=torch.channels_last)
                return (q + (rq - q).detach() if q.requires_grad else rq), rsc.to(sc.device)
            (r,) = ref
            d = (out.detach().float().cpu() - r.float())
            l2 = (d.norm() / r.float().norm()).item()
            if not l2 <= 5e-3 or d.abs().max() > 1e-2 * r.float().abs().max():
                raise AssertionError(f"int8 forcing: int8_conv output rel L2 {l2:.3g} (bound 5e-3)")
            self.conv_l2 = max(self.conv_l2, l2)
            r = r.to(device=out.device, dtype=out.dtype).contiguous(memory_format=torch.channels_last)
            return out + (r - out).detach() if out.requires_grad else r

        return hook

    def _attach(self, model, forcing):
        from guided_diffusion_clip_tpu_torch.models.nn import Conv2d, GroupNorm32

        for name, m in model.named_modules():
            if isinstance(m, (GroupNorm32, Conv2d)) and not name.startswith("out."):
                self.handles.append(m.register_forward_hook(self._hook(forcing), with_kwargs=True))

    def record(self, model):
        self._attach(model, False)
        return self

    def force(self, model):
        self.pos = 0
        self._attach(model, True)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles = []
        if exc[0] is None and self.pos not in (0, len(self.rec)):
            raise AssertionError(f"int8 forcing: {self.pos} of {len(self.rec)} recorded outputs replayed")

    def summary(self) -> str:
        return (f"forced {len(self.rec)} roundings: q off by one on {self.flips} of {self.elems} "
                f"({self.flips / max(1, self.elems):.2g}), max s rel err {self.s_err:.3g}, "
                f"worst int8_conv rel L2 {self.conv_l2:.3g}")


def phase4c_int8_forward(dev, sd):
    """Full-width int8 forward, batch 1, f32: card (K4, K5) vs CPU (plain),
    teacher-forced; the free-running difference is reported."""
    import torch

    from guided_diffusion_clip_tpu_torch.utils.script_util import create_model

    tf32_off()
    model = create_model(
        256, 256, 2, learn_sigma=True, class_cond=True, attention_resolutions="32,16,8",
        num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True, use_fp16=False,
        conv_impl="int8",
    ).eval()
    model.load_state_dict(sd, strict=True)
    want = gn_conv_counts(model, True)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 3, 256, 256, generator=g)
    t = torch.tensor([500])
    feat = torch.randn(1, 512, generator=g)
    with torch.inference_mode():
        t0 = time.perf_counter()
        with Int8Forcing().record(model) as forcing:
            ref = model(x, t, clip_feat=feat)
        cpu_s = time.perf_counter() - t0
        model.to(dev)
        before = counters()
        with forcing.force(model):
            out = model(x.to(dev), t.to(dev), clip_feat=feat.to(dev)).cpu()
        ran = {k: counters()[k] - before[k] for k in want}
        free = model(x.to(dev), t.to(dev), clip_feat=feat.to(dev)).cpu()
    if ran != want:
        raise AssertionError(f"int8 forward launched {ran}, planned {want}")
    if out.shape != (1, 6, 256, 256) or not torch.isfinite(out).all():
        raise AssertionError(f"int8 forward output {tuple(out.shape)} not finite (1, 6, 256, 256)")
    rel = ((out - ref).norm() / ref.norm()).item()
    free_rel = ((free - ref).norm() / ref.norm()).item()
    log(f"  int8 forward (1, 3, 256, 256) f32, launches {ran} (planned from the modules); "
        f"{forcing.summary()}")
    log(f"  |ref| {ref.norm().item():.4g}, rel L2 err card vs CPU {rel:.3g} teacher-forced (bound 1e-3), "
        f"{free_rel:.3g} free-running (not bounded); CPU forward {cpu_s:.2f} s")
    if not ref.norm() > 0 or not rel <= 1e-3:
        raise AssertionError(f"card int8 forward differs from the CPU forward: rel L2 {rel:.3g}")
    del model


def phase4d_int8_guidance(dev):
    """The full-width int8 classifier, batch 1, f32: logits and
    classifier_cond_fn's dx, card (K1-K5) against the CPU (plain versions),
    teacher-forced. dx twice: with conv_prequant's straight-through convs
    in f32 (bound 1e-3: the algorithm), and in bf16 as shipped (bound 2e-2:
    cuDNN and the CPU round the bf16 convs' outputs at other places)."""
    import torch

    from guided_diffusion_clip_tpu_torch.diffusion.guidance import classifier_cond_fn
    from guided_diffusion_clip_tpu_torch.ops import quant as Q
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_classifier

    tf32_off()
    clf = create_classifier(256, False, 128, 2, "32,16,8", True, True, "attention", conv_impl="int8").eval()
    clf.load_state_dict(random_state_dict(clf), strict=True)
    clf.requires_grad_(False)
    cond = classifier_cond_fn(clf, 1.0)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(1, 3, 256, 256, generator=g)
    t, y = torch.tensor([500]), torch.tensor([417])
    stes = ((torch.float32, 1e-3), (torch.bfloat16, 2e-2))
    refs, forcings = {}, {}
    try:
        with torch.no_grad():
            t0 = time.perf_counter()
            with Int8Forcing().record(clf) as forcings["logits"]:
                refs["logits"] = clf(x, t)
            for ste, _ in stes:
                Q._STE_DTYPE = ste
                with Int8Forcing().record(clf) as forcings[ste]:
                    refs[ste] = cond(x, t, y=y)
            cpu_s = time.perf_counter() - t0
            clf.to(dev)
            with forcings["logits"].force(clf):
                logits = clf(x.to(dev), t.to(dev)).cpu()
            outs = {}
            for ste, _ in stes:
                Q._STE_DTYPE = ste
                with forcings[ste].force(clf):
                    outs[ste] = cond(x.to(dev), t.to(dev), y=y.to(dev)).cpu()
            free = cond(x.to(dev), t.to(dev), y=y.to(dev)).cpu()
    finally:
        Q._STE_DTYPE = torch.bfloat16
    log(f"  logits: {forcings['logits'].summary()}")
    checks = [("logits", logits, refs["logits"], (1, 1000), 1e-3)]
    for ste, bound in stes:
        log(f"  guidance gradient, {str(ste)[6:]} straight-through convs: {forcings[ste].summary()}")
        checks.append((f"dx ({str(ste)[6:]} straight-through convs)", outs[ste], refs[ste], (1, 3, 256, 256), bound))
    for name, out, ref, shape, bound in checks:
        if out.shape != shape or not torch.isfinite(out).all():
            raise AssertionError(f"int8 guidance {name}: {tuple(out.shape)} not finite {shape}")
        rel = ((out - ref).norm() / ref.norm()).item()
        log(f"  int8 classifier {name} {shape} f32: |ref| {ref.norm().item():.4g}, rel L2 err card vs CPU "
            f"{rel:.3g} teacher-forced (bound {bound:g})")
        if not ref.norm() > 0 or not rel <= bound:
            raise AssertionError(f"card int8 guidance {name} differs from the CPU: rel L2 {rel:.3g}")
    ref_dx = refs[torch.bfloat16]
    log(f"  dx free-running: rel L2 {((free - ref_dx).norm() / ref_dx.norm()).item():.3g} (not bounded); "
        f"CPU int8 classifier forward + 2 guidance gradients {cpu_s:.2f} s")


def phase5_serve(dev, ckpt_path, conv_impl="auto"):
    """The serving path over HTTP; returns the kernels' launch counts. Under
    int8 the per-sample RNG contract across packings does not hold (the
    per-tensor scale of int8_conv spans the batch, in the JAX server too),
    so only the same request at the same bucket is held to the same bytes."""
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from guided_diffusion_clip_tpu_torch import serve

    int8 = conv_impl == "int8"
    # PyTorch's defaults, which the server leaves as they are
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    args = serve.parse_args([*SLICE_FLAGS, "--model_path", ckpt_path, "--device", dev.type,
                             "--conv_impl", conv_impl])
    size = args.image_size

    # the main path starts here: count every launch of its kernels
    reset_counters()
    t0 = time.perf_counter()
    sampler = serve.Sampler(args)
    sampler.warmup()
    log(f"  server built and warm in {time.perf_counter() - t0:.1f} s; warm chain latency "
        f"by bucket {{{', '.join(f'{b}: {s:.3f} s' for b, s in sorted(sampler.bucket_latency.items()))}}}")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(sampler))
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def healthz():
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            return json.loads(r.read())

    def sample(n, seed, feat=None):
        payload = {"num_samples": n, "seed": seed}
        if feat is not None:
            payload["clip_feat"] = feat.tolist()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/sample", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            arr = np.load(io.BytesIO(r.read()))["arr_0"]
        dt = time.perf_counter() - t
        if arr.shape != (n, size, size, 3) or arr.dtype != np.uint8:
            raise AssertionError(f"/sample n={n}: got {arr.shape} {arr.dtype}")
        if not all(arr[i].std() > 0 for i in range(n)):
            raise AssertionError(f"/sample n={n}: a constant image")
        return arr, dt

    try:
        h = healthz()
        if not (h["ok"] and h["compiled"] and h["batch_buckets"] == [1, 4, 8] and h["steps"] == 25):
            raise AssertionError(f"/healthz: {h}")
        log(f"  /healthz: {h}")
        rs = np.random.RandomState(3)
        feat4 = rs.standard_normal((4, 512)).astype(np.float32)
        lat = []
        a1, dt = sample(1, 11)
        lat.append((1, dt))
        a4, dt = sample(4, 12, feat4)
        lat.append((4, dt))
        a12, dt = sample(12, 13)
        lat.append((12, dt))
        for n, dt in lat:
            log(f"  /sample n={n}: {dt:.3f} s, {n / dt:.3f} samples/s")

        # the same request at the same bucket gives the same bytes
        a4b, _ = sample(4, 12, feat4)
        if not np.array_equal(a4, a4b):
            raise AssertionError("repeated /sample n=4 returned different bytes")
        log("  repeated /sample n=4: the same bytes")
        if not int8:  # coalescing, and the per-sample RNG across packings
            # two concurrent requests coalesce into one chain
            d0 = healthz()["dispatches"]
            with concurrent.futures.ThreadPoolExecutor(2) as pool:
                fa = pool.submit(sample, 2, 21)
                fb = pool.submit(sample, 2, 22)
                (ca, dta), (cb, dtb) = fa.result(), fb.result()
            h2 = healthz()
            if h2["dispatches"] != d0 + 1 or h2["coalesced_requests"] < 2:
                raise AssertionError(f"concurrent requests did not coalesce: {d0} -> {h2}")
            log(f"  coalesced 2 x /sample n=2 in one chain: {dta:.3f} s and {dtb:.3f} s")

            # per-sample RNG: the same (seed, subidx, clip_feat) solo, coalesced and
            # in another bucket; cuDNN may pick batch-dependent algorithms
            sa, _ = sample(2, 21)
            s1, _ = sample(1, 21)
            s13, _ = sample(1, 13)
            b1, b2, b8 = (sampler._bucket_for(n) for n in (1, 2, 8))
            diffs = {
                f"coalesced vs solo n=2 (bucket {b2})": np.abs(ca.astype(int) - sa.astype(int)).max(),
                f"n=1 (bucket {b1}) vs n=2 (bucket {b2})": np.abs(s1[0].astype(int) - sa[0].astype(int)).max(),
                f"n=1 (bucket {b1}) vs first chunk of n=12 (bucket {b8})":
                    np.abs(s13[0].astype(int) - a12[0].astype(int)).max(),
            }
            for k, v in diffs.items():
                log(f"  max |uint8 diff| {k}: {v} (bound 2)")
            if max(diffs.values()) > 2:
                raise AssertionError(f"per-sample RNG contract broken: {diffs}")
    finally:
        stop_server(sampler, httpd, thread)
    return check_serve_launches(sampler, int8)


def stop_server(sampler, httpd, thread) -> None:
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    sampler.close()


def check_serve_launches(sampler, int8: bool) -> dict:
    """The kernels' launch counts, checked against the forwards served."""
    forwards = sampler.forwards
    launches = counters()
    log(f"  {forwards} UNet forwards served; kernel launches {launches}")
    per = gn_conv_counts(sampler.model, int8)
    if not int8 and per["group_norm"] != GN_PER_FORWARD:
        raise AssertionError(f"{per['group_norm']} GroupNorms in the UNet, not {GN_PER_FORWARD}")
    want = {"attention": ATTN_PER_FORWARD * forwards, "attention_bwd": 0,
            **{k: n * forwards for k, n in per.items()}}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want} ({forwards} forwards)")
    return launches


def phase6_guided(dev, tmp, conv_impl="auto", paths=None):
    """classifier_sample.main on ADM-G 256 + its classifier (random weights
    from .pt files, written on the first call); returns the kernels' launch
    counts over the run, the .pt paths and the samples."""
    import numpy as np
    import torch

    from guided_diffusion_clip_tpu_torch import classifier_sample
    from guided_diffusion_clip_tpu_torch.utils.script_util import args_to_dict, create_classifier, create_upstream_model

    int8 = conv_impl == "int8"
    flags = [*GUIDED_FLAGS, "--conv_impl", conv_impl]
    # PyTorch's defaults, as the CLI leaves them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    args = classifier_sample.create_argparser().parse_args(flags)
    per = {}
    new_paths = {}
    for name, model in (
        ("model", create_upstream_model(**args_to_dict(args, classifier_sample._UNET_KEYS))),
        ("classifier", create_classifier(**args_to_dict(args, classifier_sample.classifier_defaults().keys()))),
    ):
        per[name] = gn_conv_counts(model, int8)
        if paths is None:
            new_paths[name] = os.path.join(tmp, f"{name}_random.pt")
            torch.save(random_state_dict(model), new_paths[name])
        del model
    paths = paths or new_paths
    argv = [*flags, "--model_path", paths["model"], "--classifier_path", paths["classifier"],
            "--main_path", os.path.join(tmp, f"runs_{conv_impl}"), "--device", dev.type]

    # the main path starts here: count every launch of its kernels
    reset_counters()
    t0 = time.perf_counter()
    out = classifier_sample.main(argv)
    wall = time.perf_counter() - t0
    launches = counters()

    data = np.load(out["path"])
    images, labels = data["arr_0"], data["arr_1"]
    if images.shape != (8, 256, 256, 3) or images.dtype != np.uint8:
        raise AssertionError(f"samples {images.shape} {images.dtype}, not (8, 256, 256, 3) uint8")
    if not all(images[i].std() > 0 for i in range(8)):
        raise AssertionError("a constant image among the guided samples")
    if labels.shape != (8,) or not ((labels >= 0) & (labels < 1000)).all():
        raise AssertionError(f"labels {labels} not 8 classes in [0, 1000)")
    steps = out["steps"] * out["batches"]
    if not int8 and (per["model"]["group_norm"], per["classifier"]["group_norm"]) != (GN_PER_FORWARD, CLF_GN_PER_FORWARD):
        raise AssertionError(f"GroupNorms {per}, not {GN_PER_FORWARD} and {CLF_GN_PER_FORWARD}")
    want = {"attention": (ATTN_PER_FORWARD + CLF_ATTN_PER_FORWARD) * steps,
            "attention_bwd": CLF_ATTN_PER_FORWARD * steps,
            **{k: (per["model"][k] + per["classifier"][k]) * steps for k in per["model"]}}
    log(f"  {steps} guided steps ({conv_impl}); kernel launches {launches} (expected {want}: per step the "
        f"UNet's {per['model']} and the classifier's {per['classifier']})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    chain = sum(out["chain_seconds"])
    log(f"  guided chain ({conv_impl}, batch 8, {out['steps']} steps): {chain:.3f} s, "
        f"{8 * 60 / chain:.3f} samples/min, {1000 * chain / steps:.2f} ms a step; main() {wall:.1f} s "
        f"with model building and loading")
    return launches, paths, images


def _kernel_group(name: str) -> str:
    if "attention_fwd_kernel" in name:
        return "K1 attention"
    if "attention_bwd_" in name:
        return "K2 attention backward"
    if "gnq_" in name or ("gn_stats_kernel" in name and "true" in name):
        return "K4 quantizing GroupNorm"
    if "conv_s8_kernel" in name:
        return "K5 s8 conv"
    if "gn_" in name and "kernel" in name:
        return "K3 GroupNorm"
    if any(k in name for k in ("implicit_gemm", "dgrad", "wgrad", "conv", "cudnn")):
        return "cuDNN convs"
    if "gemm" in name or "cutlass" in name:
        return "cuBLAS matmuls"
    if "at::native" in name:
        return "PyTorch ops (elementwise, reductions, pools, copies)"
    return "other"


def _profile_kernels(fn, reps: int = 2) -> dict:
    """Device time (ms per call) and count per call of every kernel ``fn`` launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            out[e.key] = (us / 1000 / reps, e.count / reps)
    return out


def profile_guided_step(dev, paths, conv_impl="auto"):
    """One guided ancestral step at batch 8: CUDA-event times of its parts,
    and torch.profiler device time by kernel group for the UNet forward, the
    classifier forward and the classifier backward (cond_fn less the
    forward); returns the step's ms."""
    import torch

    from guided_diffusion_clip_tpu_torch import classifier_sample
    from guided_diffusion_clip_tpu_torch.diffusion import sampling as S
    from guided_diffusion_clip_tpu_torch.diffusion.guidance import classifier_cond_fn
    from guided_diffusion_clip_tpu_torch.utils.checkpoint import load_model_weights
    from guided_diffusion_clip_tpu_torch.utils.script_util import (
        args_to_dict, create_classifier, create_gaussian_diffusion, create_upstream_model,
    )

    args = classifier_sample.create_argparser().parse_args(GUIDED_FLAGS)
    model = create_upstream_model(**args_to_dict(args, classifier_sample._UNET_KEYS), conv_impl=conv_impl)
    model = load_model_weights(model, paths["model"]).to(dev).eval().requires_grad_(False)
    clf = create_classifier(**args_to_dict(args, classifier_sample.classifier_defaults().keys()),
                            conv_impl=conv_impl)
    clf = load_model_weights(clf, paths["classifier"]).to(dev).eval().requires_grad_(False)
    diffusion = create_gaussian_diffusion(steps=1000, learn_sigma=True, timestep_respacing="250")
    sched = diffusion.sched.to(dev)
    cfg = S.SamplerConfig(mean_type=diffusion.mean_type, var_type=diffusion.var_type)
    cond = classifier_cond_fn(clf, 1.0)
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(8, 3, 256, 256, generator=g, device=dev)
    y = torch.randint(0, 1000, (8,), generator=g, device=dev)
    t = torch.full((8,), 125, dtype=torch.long, device=dev)
    tm = sched.model_timesteps(t)

    def unet_fwd():
        with torch.no_grad():
            model(x, tm, y=y)

    def clf_fwd():  # with grad on, as inside cond_fn
        with torch.enable_grad():
            clf(x.detach().requires_grad_(True), tm)

    def clf_fwd_bwd():
        with torch.no_grad():
            cond(x, tm, y=y)

    def step():
        with torch.no_grad():
            S.p_sample_step(sched, model, x, t, g, cfg=cfg, cond_fn=cond, model_kwargs={"y": y})

    parts = {name: cuda_ms(fn, runs=5, warmup=1) for name, fn in (
        ("UNet forward", unet_fwd), ("classifier forward", clf_fwd),
        ("classifier forward + backward", clf_fwd_bwd), ("guided step", step))}
    parts["classifier backward"] = parts["classifier forward + backward"] - parts["classifier forward"]
    log("  CUDA events, ms: " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))

    prof = {"UNet forward": _profile_kernels(unet_fwd), "classifier forward": _profile_kernels(clf_fwd)}
    both, fwd = _profile_kernels(clf_fwd_bwd), prof["classifier forward"]
    prof["classifier backward"] = {
        k: (ms - fwd.get(k, (0, 0))[0], n - fwd.get(k, (0, 0))[1]) for k, (ms, n) in both.items()
    }
    busy = sum(ms for ms, _ in _profile_kernels(step).values())
    log(f"  profiler: device busy {busy:.2f} ms of the {parts['guided step']:.2f} ms step "
        f"(idle {100 * (1 - busy / parts['guided step']):.0f} %)")
    for part, kernels in prof.items():
        groups: dict = {}
        for k, (ms, n) in kernels.items():
            grp = groups.setdefault(_kernel_group(k), [0.0, 0.0])
            grp[0] += ms
            grp[1] += n
        total = sum(ms for ms, _ in groups.values())
        log(f"  {part}: device {total:.2f} ms; " + "; ".join(
            f"{k} {ms:.2f} ms ({n:.0f} launches)" for k, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    log("  classifier backward, top kernels (ms, launches):")
    for k, (ms, n) in sorted(prof["classifier backward"].items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"    {ms:8.3f} x{n:<5.0f} {k[:110]}")
    return parts["guided step"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs an H100", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from guided_diffusion_clip_tpu_torch.ops import build
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_model

    dev = torch.device("cuda", 0)
    log("phase 1: device")
    card = smi()
    cap = torch.cuda.get_device_capability(0)
    log(f"  nvidia-smi: {card}; torch: {torch.cuda.get_device_name(0)}, capability {cap}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability (9, 0) (sm_90a), found {cap}")

    log("phase 2: build")
    t0 = time.perf_counter()
    build.load()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds:.2f} s): {build.library_path()}")
    for line in build.build_log.splitlines():
        spills = "spill stores" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill")
        if "registers" in line or spills:
            log(f"  ptxas: {line.strip()}")

    log("phase 3: kernels vs plain versions on the card")
    records = phase3_kernels(dev)
    log("phase 3b: K2 (attention backward) vs its plain version on the card")
    records["attention_bwd"] = phase3b_attention_bwd(dev)
    log("phase 3c: K4 (quantizing GroupNorm) vs its plain version on the card")
    records["group_norm_quant"] = phase3c_group_norm_quant(dev)
    log("phase 3d: K5 (s8 conv) vs its plain version and cuDNN's bf16 conv on the card")
    records["conv_s8"] = phase3d_conv_s8(dev)

    log("phase 4: full-width forward, card vs CPU")
    sd = random_state_dict(create_model(
        256, 256, 2, learn_sigma=True, class_cond=True, attention_resolutions="32,16,8",
        num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True,
    ))
    phase4_forward(dev, sd)
    log("phase 4b: full-width guidance gradient, card vs CPU")
    phase4b_guidance(dev)
    log("phase 4c: full-width int8 forward, card vs CPU")
    phase4c_int8_forward(dev, sd)
    log("phase 4d: full-width int8 guidance gradient, card vs CPU")
    phase4d_int8_guidance(dev)

    import numpy as np

    runs = []  # each main path's launch counts
    with tempfile.TemporaryDirectory() as tmp:
        log("phase 5: the slice, served over HTTP")
        ckpt = os.path.join(tmp, "model_random.pt")
        torch.save(sd, ckpt)
        del sd
        runs.append(phase5_serve(dev, ckpt))
        log("phase 5b: the slice served over HTTP with --conv_impl int8")
        runs.append(phase5_serve(dev, ckpt, "int8"))
        os.remove(ckpt)
        log("phase 6: classifier-guided sampling, ADM-G 256 + classifier")
        launches, paths, bf16_images = phase6_guided(dev, tmp)
        runs.append(launches)
        log("phase 6, profile: one guided step at batch 8")
        bf16_step = profile_guided_step(dev, paths)
        log("phase 6b: classifier-guided sampling with --conv_impl int8")
        launches, _, int8_images = phase6_guided(dev, tmp, "int8", paths)
        runs.append(launches)
        sd_bf16, sd_int8 = bf16_images.astype(np.float64).std(), int8_images.astype(np.float64).std()
        diff = np.abs(int8_images.astype(np.int64) - bf16_images.astype(np.int64))
        saturated = ((bf16_images == 0) | (bf16_images == 255)).mean()
        log(f"  samples' std: int8 {sd_int8:.3f}, bf16 {sd_bf16:.3f} (bound: within 0.5 relative); "
            f"int8 vs bf16 (same seeds and weights): mean |uint8 diff| {diff.mean():.3f}, "
            f"{100 * (diff > 0).mean():.2f} % of values differ; {100 * saturated:.1f} % of bf16 values at 0 or 255")
        if not abs(sd_int8 - sd_bf16) <= 0.5 * sd_bf16:
            raise AssertionError(f"int8 samples' std {sd_int8:.3f} not within 0.5 of bf16's {sd_bf16:.3f}")
        log("phase 6b, profile: one int8 guided step at batch 8")
        int8_step = profile_guided_step(dev, paths, "int8")
        log(f"  guided step at batch 8: int8 {int8_step:.2f} ms, bf16 {bf16_step:.2f} ms (CUDA events, "
            f"this run)")

    kernels = []
    for name, src, replaces in (
        ("attention", "guided_diffusion_clip_tpu_torch/ops/csrc/attention_fwd.cu",
         "guided_diffusion_clip_tpu/ops/pallas_attention.py:27"),
        ("attention_bwd", "guided_diffusion_clip_tpu_torch/ops/csrc/attention_bwd.cu",
         "guided_diffusion_clip_tpu/ops/pallas_attention.py:46"),
        ("group_norm", "guided_diffusion_clip_tpu_torch/ops/csrc/groupnorm.cu",
         "guided_diffusion_clip_tpu/ops/pallas_groupnorm.py:29"),
        ("group_norm_quant", "guided_diffusion_clip_tpu_torch/ops/csrc/groupnorm.cu",
         "guided_diffusion_clip_tpu/ops/pallas_groupnorm.py:50"),
        ("conv_s8", "guided_diffusion_clip_tpu_torch/ops/csrc/conv_s8.cu",
         "guided_diffusion_clip_tpu/ops/pallas_conv.py:258"),
    ):
        err, ms, pms = records[name]
        launched = sum(run[name] for run in runs)
        if launched == 0:
            raise AssertionError(f"kernel {name} was never launched by a main path")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launched, "max_abs_err": err, "ms": ms, "plain_ms": pms,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
