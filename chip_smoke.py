#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100 (sm_90a).

    python3 chip_smoke.py

Drives the port's main paths end to end, the serving path at the ADM-256
widths of the fork's CLIP-conditioned UNet, classifier-guided sampling with
ADM-G 256 and its classifier, training of the fork's 128 px recipe (bf16 and
int8), and sampling and scoring what it trained through the fork's CLIs, and
exits non-zero if any phase fails:

  1. device: the card's name, power limit and compute capability (9, 0);
  2. build: the CUDA kernels of ``guided_diffusion_clip_tpu_torch/ops/csrc``
     compiled from this checkout (one nvcc per source, in parallel);
  3. each forward kernel (K1 attention, K3 GroupNorm) against its plain
     PyTorch version on the card, at the shapes the paths give it, in f32
     (TF32 off) and bf16, with kernel and plain times (median of 12 runs
     after warm-up, CUDA events). K1 also at the recipe's one-head
     attention at batch 8 and 16 (image_sample, and under CFG). K3 (one
     launch a call) at six maps of the UNet and the classifier and at the
     recipe's four must also give each group's mean and rstd
     within 1e-5 relative of the plain version's, and the same bits again.
     K1 in bf16 (every d) must go to
     the tensor-core kernel (``launches_mma``); beside it each bf16 case
     logs ``F.scaled_dot_product_attention``, the f32-FMA kernel on the same
     bf16 input (through its C entry point, for the log only) and the bound;
     in f32 at the classifier pool's shape (T = 65, 8 heads, d = 64, the FMA
     kernel's one main-path user) the library call (TF32 off) and the bound
     at the f32 rate;
  3b. the same for K2 (attention backward) at the classifier's shapes; in
     bf16 it is also held to the float64 result of the same values, where
     it may not be further off than the FMA kernel by more than f32's own
     rounding; the f32 pool shape is timed against the library as in 3;
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
      shapes, with and without scale-shift, f32 and bf16, both emissions,
      with the same stats and repeat checks as K3;
  3d. K5 (the s8 conv) against its plain version, and cuDNN's bf16 conv
      timed at the same shapes: 3x3 at 256/32/16/8 px, the stem, the head,
      1x1 and stride-2 convs, an odd M and batch 1. Every shape with
      C % 16 == 0 and K > 16 must go to the tensor-core kernel
      (``launches_mma``) and equal the ``__dp4a`` kernel's output bit for
      bit (exact sums, the same epilogue, split launches included); the
      ``__dp4a`` kernel's time is logged beside it;
  3g. the two quantize kernels of ``int8_conv`` against
      ``quantize_per_tensor`` on the card (all zeros, one huge value, exact
      ties, f32 and bf16, a size that is no multiple of 16);
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

The deploy preset's sampling knobs and the last two kernels add:
  3e. K6 (the fused quantizing conv, both modes on the tensor cores) against
      its plain version at 256 px, 256 -> 256 and 32 px, 512 -> 512, batch 8,
      f32 and bf16 inputs, both modes, with cuDNN's bf16 conv timed at the
      same shapes;
  3f. K7 (the tensor-core probe) against its plain version (s8 bit for bit,
      wrapped sums included; bf16 at small T), then its two-T rate;
  4e. a full-width ``cache_mode="full"`` forward and a ``"shallow"`` one fed
      its deep feature (batch 1, f32, TF32 off), card against CPU, and on
      the card the shallow forward against the plain one at the same (x, t);
  5c. ``serve --cfg_scale 2.0 --cfg_cache 2 --sampler dpm++2m``, bf16, 25
      steps: the same request twice gives the same bytes, and the model ran
      steps + refreshes times a chain;
  6c. ``classifier_sample.main`` with the preset's four knobs (``--conv_impl
      int8 --deep_cache 5 --guidance_cache 2 --guidance_interval 200,800``),
      250 ancestral steps at batch 8: the launch counts equal those derived
      from the modules (full and shallow forwards) and from the schedule
      (which steps run the classifier);
  7.  the two tool entry points, ``tools.conv_bench`` and
      ``tools.mxu_ceiling``, called in-process: the paths that launch K6, K7.

Training, the fork's recipe (``configs/config.yaml``: the CLIP-conditioned
UNet at 128 px, one head at 16 and 8 px, bf16 torso, batch 48), adds:
  8a. K1 and K2 at its attention shapes (batch 48, d = 192 at T = 256 and
      d = 256 at T = 64), f32 (the FMA-pipe kernels) and bf16 (the
      tensor-core kernels: ``launches_mma`` rises by one each), against
      their plain versions, the same bits again, with the library call (f32
      with TF32 off) and the bound beside them; in bf16 also the FMA kernels'
      time on the same input, K1 with 32 and with 64 query rows a block, and
      both kernels held to the float64 result as in 3b;
  8b. one ``TrainLoop`` step of the full-width model (batch 4, dropout 0) on
      the card and on the CPU from the same weights, batch, t and noise: in
      f32 (TF32 off) loss, grad_norm, updated parameters and gradient within
      1e-3 relative L2; with the recipe's bf16 torso (f32 parameters, the
      convs' weights cast at the call, K1/K2/K3 in bf16 under autograd)
      within ``TRAIN_BF16_TOL``, the CPU's bf16 step against its f32 step
      printed beside it as the control;
  8c. ``python -m guided_diffusion_clip_tpu_torch.image_train --config-file``
      on 64 generated PNGs and a ``.pt`` CLIP dict (the recipe's file with
      save_interval 10, log_interval 5 and the paths pointed at them), with
      ``DIFFUSION_TRAINING_TEST=1``: the three checkpoints, finite losses in
      progress.csv, the model loading strict=True into the sampler, and the
      entry point's ms a step and samples/s over steps 6-10, loader
      included, with the loop's wait for the loader; then a resume from
      ``model000010.pt`` for 2 steps (step, EMA and Adam count restored);
      the resume runs with ``--profile_dir``, whose trace must hold the
      ``train_step`` scope (``GDC_NATIVE_LOADER=1`` is not run: the native
      decoder needs libjpeg's and libpng's headers to build);
  8d. 20 timed ``run_step`` calls at batch 48 after 5 of warm-up, without
      and with ``use_checkpoint``: no host sync (``set_sync_debug_mode``),
      K1/K2/K3 launches against the counts from the modules (every K1/K2
      launch on the tensor-core kernels), ms a step and its split by part,
      samples/s, peak memory, device time by kernel group;
  8e. ``--train_conv_impl int8``: one step (batch 4, dropout 0) card against
      CPU, teacher-forced (``Int8Forcing``), in f32 within 1e-3 relative L2
      and with the bf16 torso within ``INT8_TRAIN_TOL``; then 20 int8 steps
      at batch 48 as 8d, K1-K5 and the quantize kernels counted.

Sampling and scoring the trained recipe through the fork's CLIs (from 8c's
run directory, ``configs/image_sample_config.yaml`` pointed at 16 generated
256 px test images):
  9.  ``image_sample.main`` from a checkpoint of N(0, 0.02) weights written
      into 8c's run directory (8c's EMA is still the initialization, whose
      output is 0), two batches of 8, 100 respaced ancestral steps, in
      bf16, with ``--conv_impl int8``, with ``--cfg_scale 3 --cfg_cache 2``
      and with ``denoise_start_point 800``: the UNet's forwards against the
      schedule, the launches against the modules' counts, seconds a batch,
      each mode's samples other than bf16's; then 5-step DDIM chains of
      ``image_sample.make_chain`` card against CPU (``SAMPLE_CHAINS``): f32
      at batch 2, bf16 and int8 (teacher-forced) at batch 8;
  9b. ``image_sample_repeat.main --repeats 2`` from 8c's EMA checkpoint: two
      run directories;
  9c. ``image_nll.main`` on 8 images from 8c's EMA checkpoint: 1000 forwards, bpd and the term files.

Phases 3c, 3d and 3g hold K4, K5 and the quantize kernels at the recipe's
shapes too (64 channels at 128 px is 2 channels a GroupNorm group; the
3-channel stem and 6-channel head on ``__dp4a``; batch 8 and 48).

Every count is set to 0 just before each main path (phases 5, 5b, 5c, 6, 6b,
6c, 7, the timed steps of 8d and 8e, each mode of 9, 9b and 9c) and read just after it; every bf16 K1 and K2 launch of a main path
(the sampling torsos at d = 64, the recipe's at d = 192 and 256) must have been a tensor-core launch, and
the FMA-pipe kernels must have taken only the classifier's attention pool,
which is float32 by the reference's design (one K1 and one K2 a classifier call).
Likewise every K5 launch of an int8 main path must have been a tensor-core
launch but for the 3-channel stems and the 6-channel head, counted from the
modules; a ptxas spill in one of the tensor-core conv kernels, the quantize
kernels, the GroupNorm kernel (K3, K4) or K1/K2 at d = 64, 192 or 256 fails
the run (the other kernels' are printed).
The last lines are the kernels' JSON record (``launches`` summed over the main paths, K1's and K2's
split between their tensor-core kernels, timed at d = 64 in phases 3 and 3b,
and their FMA-pipe kernels, timed in f32 at the classifier pool's shape there; ``bound_ms`` the least time the card
could take, from the bytes moved at 3.35 TB/s and the operations at the
data-sheet peak of their type; ``library_ms`` the time of the one PyTorch call
that computes the same function, timed here and used nowhere in the port),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits non-zero and prints no result. It imports
nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import math
import os
import re
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


# the H100's data-sheet rates (SXM, dense): device memory, and operations by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "s8": 1979e12, "f32": 67e12}


def record(err, ms, plain_ms, nbytes, ops, op_type, library_ms=None) -> dict:
    """A kernel's headline record. ``nbytes``: every input read once and every
    output written once; ``ops``: the operations of the function on these
    inputs, of type ``op_type``."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S[op_type]
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms}


def rate(ops, ms) -> str:
    """Operations over a time in ms, in T/s."""
    return f"{ops / (ms * 1e-3) / 1e12:.0f}"


def attention_bound(B, T, H, d, backward: bool, f32: bool = False) -> dict:
    """``record``'s bound of K1 (q, k, v read, out written; the two products)
    or K2 (qkv and dO read, dqkv written; five T x T x d products: S again,
    dP, dV, dQ, dK) in bf16, or with ``f32`` in float32 at the FMA pipes' rate."""
    size, op_type = (4, "f32") if f32 else (2, "bf16")
    if backward:
        return dict(nbytes=(3 + 1 + 3) * B * T * H * d * size, ops=10 * B * H * T * T * d, op_type=op_type)
    return dict(nbytes=4 * B * T * H * d * size, ops=4 * B * H * T * T * d, op_type=op_type)


# the classifier's attention pool at batch 8 (8 x 8 tokens and their mean; 512 channels in heads of
# 64, new head order): float32 by the reference's design, the FMA-pipe kernels' one main-path user
POOL_SHAPE = (8, 65, 8, 64, True)


def fma_attention(qkv, H, new, do=None):
    """K1 (or, given ``do``, K2) on the f32 FMA pipes for a bf16 input, through
    the C entry points: the port sends bf16 at these head widths to the
    tensor-core kernels, so this call is for the log only."""
    import math

    import torch

    from guided_diffusion_clip_tpu_torch.ops import build

    B, T, W = qkv.shape
    d = W // (3 * H)
    scale = 1.0 / math.sqrt(math.sqrt(d))
    lib, stream = build.load(), torch.cuda.current_stream(qkv.device).cuda_stream
    if do is None:
        out = torch.empty((B, T, H * d), dtype=qkv.dtype, device=qkv.device)
        rc = lib.gdc_attention_fwd(qkv.data_ptr(), out.data_ptr(), B, T, H, d, int(new), 1, scale, stream)
    else:
        out = torch.empty_like(qkv)
        stats = torch.empty((3, B * H, T), dtype=torch.float32, device=qkv.device)
        rc = lib.gdc_attention_bwd(qkv.data_ptr(), do.data_ptr(), out.data_ptr(), stats.data_ptr(), B, T, H, d,
                                   int(new), 1, scale, scale * scale, stream)
    build.check(rc, "the FMA attention kernel")
    return out


def attention_fwd_f64(qkv, H, new):
    """K1's function in float64 on the same bf16 values: q*s and k*s rounded
    to bf16 as the contract has it, the softmax, the weights (unrounded) and
    P V in float64."""
    import math

    import torch

    from guided_diffusion_clip_tpu_torch.ops import attention as A

    q, k, v = (a.transpose(1, 2) for a in A.split_qkv(qkv, H, new))  # (B, H, T, d)
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    p = torch.softmax((q * scale).double() @ (k * scale).double().transpose(-1, -2), dim=-1)
    return A.merge_heads((p @ v.double()).transpose(1, 2))


def held_to_f64(name, out, fma, ref64) -> None:
    """A tensor-core kernel's bf16 result against the float64 one, beside the
    FMA kernel's on the same input: against the bf16 plain version both differ
    in last places only, and which of the two meets the larger of its flipped
    values is chance. The unrounded result tells them apart: the tensor-core
    kernel may not be behind the FMA kernel by more than f32's own rounding
    (one rounding of P or dS to bf16 would be 1e-3 * max|ref|)."""
    top, exact = ref64.abs().max().item(), ref64.to(out.dtype)
    err64, fma_err64 = ((x.double() - ref64).abs().max().item() for x in (out, fma))
    log(f"    against the float64 result of the same bf16 values, unrounded: max|d| {err64:.6g}, the FMA "
        f"kernel {fma_err64:.6g} (max|ref| {top:.3g}); results that differ from its bf16 rounding: "
        f"{int((out != exact).sum())} and {int((fma != exact).sum())} of {out.numel()}")
    if err64 > fma_err64 + 1e-5 * top:
        raise AssertionError(f"{name}: {err64:.6g} from the float64 result, the FMA kernel {fma_err64:.6g}")


def attention_bwd_f64(qkv, do, H, new):
    """K2's function in float64 on the same bf16 values, dqkv unrounded: q*s
    and k*s rounded to bf16 as the contract has it, every product, the
    softmax and the sums in float64."""
    import math

    import torch

    from guided_diffusion_clip_tpu_torch.ops import attention as A

    B, T, _ = qkv.shape
    q, k, v = (a.transpose(1, 2) for a in A.split_qkv(qkv, H, new))  # (B, H, T, d)
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    dof = do.reshape(B, T, H, -1).transpose(1, 2).double()
    p = torch.softmax((q * scale).double() @ (k * scale).double().transpose(-1, -2), dim=-1)
    dv = p.transpose(-1, -2) @ dof
    dp = dof @ v.double().transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    del p, dp
    dq = ds @ k.double() * (scale * scale)
    dk = ds.transpose(-1, -2) @ q.double() * (scale * scale)
    grads = [g.transpose(1, 2) for g in (dq, dk, dv)]  # (B, T, H, d)
    return torch.stack(grads, dim=2 if new else 3).reshape(qkv.shape)


def phase3_kernels(dev):
    """Each kernel against its plain version; returns the headline records."""
    import torch
    import torch.nn.functional as F

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
        (8, 256, 1, 256, False), (8, 64, 1, 256, False), POOL_SHAPE,
        # the recipe's one-head attention as image_sample runs it under CFG (batch 16; batch 8 is above),
        # where fwd_q_rows picks 32-row blocks
        (16, 256, 1, 192, False), (16, 64, 1, 256, False),
    ]
    with torch.inference_mode():
        for B, T, H, d, new in attn_cases:
            for dtype in (torch.float32, torch.bfloat16):
                qkv = torch.randn(B, T, 3 * H * d, generator=g, device=dev).to(dtype)
                n_mma = A.attention_fwd_cuda.launches_mma
                out = A.attention_fwd_cuda(qkv, H, new_order=new)
                ref = A.qkv_attention_plain(qkv, H, new_order=new)
                torch.cuda.synchronize()
                name = f"K1 attention B={B} T={T} heads={H} d={d} {'new' if new else 'legacy'} {str(dtype)[6:]}"
                mma = dtype == torch.bfloat16 and d in A.MMA_HEAD_DIMS
                if A.attention_fwd_cuda.launches_mma - n_mma != int(mma):
                    raise AssertionError(f"{name}: {'not ' if mma else ''}launched on the tensor cores")
                err, bound = check(name, out, ref, dtype, "attn")
                if not torch.equal(A.attention_fwd_cuda(qkv, H, new_order=new), out):
                    raise AssertionError(f"{name}: a repeat run gave other bits")
                ms = cuda_ms(lambda: A.attention_fwd_cuda(qkv, H, new_order=new))
                pms = cuda_ms(lambda: A.qkv_attention_plain(qkv, H, new_order=new))
                log(f"  {name}: max|d| {err:.3g} ({bound}), repeat bit-identical; kernel {ms:.4f} ms "
                    f"({'mma.sync' if mma else 'FMA pipes'}), plain {pms:.4f} ms")
                if dtype == torch.bfloat16 or (B, T, H, d, new) == POOL_SHAPE:
                    q, k, v = (t.permute(0, 2, 1, 3) for t in A.split_qkv(qkv, H, new))
                    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
                    rec = record(err, ms, pms, **attention_bound(B, T, H, d, False, not mma), library_ms=lib)
                    fma = f", the FMA kernel {cuda_ms(lambda: fma_attention(qkv, H, new)):.4f} ms" if mma else ""
                    log(f"    F.scaled_dot_product_attention on the same q, k, v: {lib:.4f} ms{fma}; bound "
                        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
                    if (B, T, H, d, new) == (8, 1024, 8, 64, False):
                        records["attention"] = rec
                    elif not mma:
                        records["attention_fma"] = rec

        # the UNet's 256 px maps (256, 512 channels), 128 px, 32 px, 8 px, the classifier's 256 px, and the
        # training recipe's maps (64 channels is 2 a group)
        for B, hw, C in [(8, 256 * 256, 256), (8, 8 * 8, 1024), (8, 256 * 256, 512), (8, 128 * 128, 256),
                         (8, 32 * 32, 512), (8, 256 * 256, 128), *RECIPE_GN_SHAPES]:
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
                    n0 = G.fused_group_norm.launches
                    out, stats = G._fused_group_norm_stats(*args)
                    ref, rstats = G._group_norm_plain_stats(*args)
                    torch.cuda.synchronize()
                    name = (f"K3 group_norm x=({B},{hw},{C}) {str(dtype)[6:]} "
                            f"{'scale-shift+silu' if fused else 'plain affine'}")
                    if G.fused_group_norm.launches != n0 + 1:
                        raise AssertionError(f"{name}: {G.fused_group_norm.launches - n0} launches counted for one call")
                    err, bound = check(name, out, ref, dtype, "gn")
                    st_err = ((stats - rstats).abs() / rstats.abs()).max().item()
                    if not st_err <= 1e-5:
                        raise AssertionError(f"{name}: (2, B, G) mean and rstd rel err {st_err:.3g} (bound 1e-5)")
                    again, again_stats = G._fused_group_norm_stats(*args)
                    if not (torch.equal(again, out) and torch.equal(again_stats, stats)):
                        raise AssertionError(f"{name}: a repeat run gave other bits")
                    ms = cuda_ms(lambda: G.fused_group_norm(*args))
                    pms = cuda_ms(lambda: G.group_norm_plain(*args))
                    # 8 f32 operations an element (two moments, normalize, affine, SiLU)
                    rec = record(err, ms, pms, nbytes=2 * B * hw * C * x.element_size(), ops=8 * B * hw * C,
                                 op_type="f32")
                    log(f"  {name}: max|d| {err:.3g} ({bound}), stats rel err {st_err:.3g} (bound 1e-5), repeat "
                        f"bit-identical; kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {rec['bound_ms']:.4f} ms")
                    if dtype == torch.bfloat16 and fused:
                        xc = x.transpose(1, 2).contiguous()  # (B, C, HW), the layout F.group_norm takes
                        wl, bl = w.to(dtype), b.to(dtype)
                        lib = cuda_ms(lambda: F.silu(F.group_norm(xc, 32, wl, bl, 1e-5)))
                        log(f"    F.silu(F.group_norm(x)) on the same x (no scale-shift): {lib:.4f} ms")
                        if (B, hw, C) == (8, 65536, 256):
                            records["group_norm"] = {**rec, "library_ms": lib}
    return records


def phase3b_attention_bwd(dev):
    """K2 against attention_bwd_plain at the classifier's shapes; returns the
    headline records: the tensor-core kernel's (T = 1024, bf16) and the FMA
    kernel's (the pool, f32)."""
    import torch
    import torch.nn.functional as F

    from guided_diffusion_clip_tpu_torch.ops import attention as A

    tf32_off()
    g = torch.Generator(device=dev).manual_seed(5)
    cases = [  # (B, T, heads, d, new_order): the classifier's blocks at batch 8, then its pool
        (8, 1024, 4, 64, False), (8, 256, 8, 64, False), (8, 64, 8, 64, False), POOL_SHAPE,
    ]
    records = {}
    for B, T, H, d, new in cases:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            qkv = torch.randn(B, T, 3 * H * d, generator=g, device=dev).to(dtype)
            do = torch.randn(B, T, H * d, generator=g, device=dev).to(dtype)
            n_mma = A.attention_bwd_cuda.launches_mma
            out = A.attention_bwd_cuda(qkv, do, H, new_order=new)
            ref = A.qkv_attention_bwd_plain(qkv, do, H, new)
            torch.cuda.synchronize()
            name = f"K2 attention_bwd B={B} T={T} heads={H} d={d} {'new' if new else 'legacy'} {str(dtype)[6:]}"
            mma = dtype == torch.bfloat16 and d in A.MMA_HEAD_DIMS
            if A.attention_bwd_cuda.launches_mma - n_mma != int(mma):
                raise AssertionError(f"{name}: {'not ' if mma else ''}launched on the tensor cores")
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            bound = f"|d| <= {tol:g}*max(1,|ref|)"
            if not torch.isfinite(out.float()).all() or not bool((diff <= tol * ref.float().abs().clamp(min=1.0)).all()):
                raise AssertionError(f"{name}: max|d| {err:.3g} fails {bound}")
            if not torch.equal(A.attention_bwd_cuda(qkv, do, H, new_order=new), out):
                raise AssertionError(f"{name}: a repeat run gave other bits")
            ms = cuda_ms(lambda: A.attention_bwd_cuda(qkv, do, H, new_order=new))
            pms = cuda_ms(lambda: A.qkv_attention_bwd_plain(qkv, do, H, new))
            log(f"  {name}: max|d| {err:.3g} ({bound}), repeat bit-identical; kernel {ms:.4f} ms "
                f"({'mma.sync' if mma else 'FMA pipes'}), plain {pms:.4f} ms")
            if dtype == torch.bfloat16 or (B, T, H, d, new) == POOL_SHAPE:
                q, k, v = (t.permute(0, 2, 1, 3).detach().requires_grad_(True) for t in A.split_qkv(qkv, H, new))
                with torch.enable_grad():
                    o = F.scaled_dot_product_attention(q, k, v)
                dob = do.reshape(B, T, H, d).permute(0, 2, 1, 3)
                lib = cuda_ms(lambda: torch.autograd.grad(o, (q, k, v), dob, retain_graph=True))
                rec = record(err, ms, pms, **attention_bound(B, T, H, d, True, not mma), library_ms=lib)
            if not mma and (B, T, H, d, new) == POOL_SHAPE:
                log(f"    backward of F.scaled_dot_product_attention on the same q, k, v, do: {lib:.4f} ms; bound "
                    f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, at the f32 rate)")
                records["attention_bwd_fma"] = rec
            if dtype == torch.bfloat16:
                fma = fma_attention(qkv, H, new, do)
                fma_err = (fma.float() - ref.float()).abs().max().item()
                fma_ms = cuda_ms(lambda: fma_attention(qkv, H, new, do))
                log(f"    backward of F.scaled_dot_product_attention on the same q, k, v, do: {lib:.4f} ms, the FMA "
                    f"kernel {fma_ms:.4f} ms with max|d| {fma_err:.3g}; bound {rec['bound_ms']:.4f} ms "
                    f"({rec['bound_by']})")
                held_to_f64(name, out, fma, attention_bwd_f64(qkv, do, H, new))
                if T == 1024:
                    records["attention_bwd"] = rec
    return records


# The training recipe's int8 shapes (configs/config.yaml: 64/128/192/256 channels at 128/32/16/8 px;
# sampling at batch 8, training at batch 48): K4's maps, K5's convs (3x3, the 1x1 skips, the
# stride-2 downsamples, the 3-channel stem and the 6-channel head on __dp4a) and the quantize
# kernels' inputs of int8_conv (the stem's image, a skip's and a downsample's input)
RECIPE_GN_SHAPES = [(8, 128 * 128, 64), (8, 16 * 16, 192), (8, 8 * 8, 256), (48, 128 * 128, 64)]
RECIPE_CONVS = [
    ("recipe 3x3 128px", 8, 128, 64, 64, 3, 1, True), ("recipe 3x3 16px", 8, 16, 192, 192, 3, 1, True),
    ("recipe 3x3 8px", 8, 8, 512, 256, 3, 1, True), ("recipe stem", 8, 128, 3, 64, 3, 1, False),
    ("recipe head", 8, 128, 64, 6, 3, 1, False), ("recipe 1x1 32px", 8, 32, 64, 128, 1, 1, False),
    ("recipe 1x1 16px", 8, 16, 384, 192, 1, 1, False), ("recipe stride 2", 8, 128, 64, 64, 3, 2, False),
    ("recipe 3x3 128px", 48, 128, 64, 64, 3, 1, True), ("recipe stem", 48, 128, 3, 64, 3, 1, False),
]
RECIPE_QUANTIZE_SHAPES = [(8, 128, 128, 3), (8, 128, 128, 64), (48, 128, 128, 64), (8, 16, 16, 384)]


def phase3c_group_norm_quant(dev):
    """K4 against group_norm_quant_plain at the paths' shapes; returns the
    headline record ((8, 65536, 256) bf16, scale-shift, s8)."""
    import torch

    from guided_diffusion_clip_tpu_torch.ops import groupnorm as G

    tf32_off()
    g = torch.Generator(device=dev).manual_seed(7)
    headline = None
    with torch.inference_mode():
        # ADM-256's maps, then the training recipe's (RECIPE_GN_SHAPES: 64 channels at 128 px is 2 a group)
        for B, hw, C in [(8, 256 * 256, 256), (8, 32 * 32, 512), (8, 8 * 8, 2048), (8, 256 * 256, 512),
                         (8, 128 * 128, 256), (8, 256 * 256, 128), *RECIPE_GN_SHAPES]:
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
                        n0 = G.fused_group_norm_quant.launches
                        q, sc, stats = G._fused_group_norm_quant_stats(*args)
                        rq, rsc, rstats = G._group_norm_quant_plain_stats(*args)
                        torch.cuda.synchronize()
                        name = (f"K4 group_norm_quant x=({B},{hw},{C}) {str(dtype)[6:]} "
                                f"{'scale-shift+silu' if fused else 'silu'} emit {str(out_dtype)[6:]}")
                        if G.fused_group_norm_quant.launches != n0 + 1:
                            raise AssertionError(f"{name}: {G.fused_group_norm_quant.launches - n0} launches counted")
                        st_err = ((stats - rstats).abs() / rstats.abs()).max().item()
                        again = G._fused_group_norm_quant_stats(*args)
                        if not all(torch.equal(u, v) for u, v in zip(again, (q, sc, stats))):
                            raise AssertionError(f"{name}: a repeat run gave other bits")
                        if not st_err <= 1e-5:
                            raise AssertionError(f"{name}: (2, B, G) mean and rstd rel err {st_err:.3g} (bound 1e-5)")
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
                        # x read once, q written once; no PyTorch call quantizes a GroupNorm
                        rec = record(deq, ms, pms, nbytes=B * hw * C * (x.element_size() + q.element_size()),
                                     ops=12 * B * hw * C, op_type="f32")
                        log(f"  {name}: s rel err {s_err:.3g} (bound 1e-6), q off by one on {flips} "
                            f"(bound 1e-4 of {d.numel()}), max|q*s - ref| {deq:.3g}, stats rel err {st_err:.3g} "
                            f"(bound 1e-5), repeat bit-identical; kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
                            f"{rec['bound_ms']:.4f} ms")
                        if (B, hw, C, dtype, fused, out_dtype) == (8, 65536, 256, torch.bfloat16, True, torch.int8):
                            headline = rec
    return headline


def phase3d_conv_s8(dev):
    """K5 against conv_s8_plain at the paths' shapes, and cuDNN's bf16 conv
    timed at the same shapes; where the tensor-core kernel applies, it must
    have been launched and must equal the ``__dp4a`` kernel bit for bit.
    Returns the headline record (3x3 at 256 px, 256 -> 256, batch 8, bf16
    out)."""
    import torch
    import torch.nn.functional as F

    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    tf32_off()
    g = torch.Generator(device=dev).manual_seed(8)
    headline = None
    cases = [  # (name, B, H, C, K, k, stride, per-image scales)
        ("3x3 256px", 8, 256, 256, 256, 3, 1, True), ("3x3 32px", 8, 32, 512, 512, 3, 1, True),
        ("3x3 8px", 8, 8, 2048, 1024, 3, 1, True), ("stem", 8, 256, 3, 256, 3, 1, False),
        ("head", 8, 256, 256, 6, 3, 1, False), ("1x1 8px", 8, 8, 2048, 1024, 1, 1, False),
        ("3x3 stride 2 64px", 8, 64, 256, 256, 3, 2, False),
        ("3x3 16px", 8, 16, 1024, 1024, 3, 1, True), ("3x3 16px", 8, 16, 2048, 1024, 3, 1, True),
        ("1x1 128px", 8, 128, 768, 256, 1, 1, False), ("3x3 8px", 3, 8, 2048, 1024, 3, 1, True),
        ("3x3 256px", 1, 256, 256, 256, 3, 1, True), *RECIPE_CONVS,
    ]
    with torch.inference_mode():
        for name, B, H, C, K, k, stride, per_image in cases:
            q = torch.randint(-127, 128, (B, H, H, C), generator=g, device=dev, dtype=torch.int8)
            w_q, s_w = Q.quantize_per_out_channel(torch.randn(k, k, C, K, generator=g, device=dev) * 0.05)
            s_img = torch.rand(B, generator=g, device=dev) * 0.02 + 0.001 if per_image else None
            bias = torch.randn(K, generator=g, device=dev) * 0.1
            xb = q.to(torch.bfloat16).permute(0, 3, 1, 2)  # channels_last NCHW view
            wb = w_q.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            cudnn_ms = cuda_ms(lambda: F.conv2d(xb, wb, stride=stride, padding=(k - 1) // 2))
            rows = Q._pack_weights(w_q)  # packed once, as the models' Conv2d caches them
            mma = Q.uses_tensor_cores(C, K, k)
            Ho = (H + 2 * ((k - 1) // 2) - k) // stride + 1
            M, KRp = B * Ho * Ho, -(-k * k * C // 32) * 32
            how = "tile %d x 128, %d slice(s) of the reduction" % Q.pick_tile(M, K, KRp) if mma else "__dp4a"
            for out_dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
                args = (q, w_q, s_img, s_w, bias, stride, out_dtype)
                n_mma = Q.conv_s8_cuda.launches_mma
                out = Q.conv_s8_cuda(*args, rows)
                ref = Q.conv_s8_plain(*args)
                torch.cuda.synchronize()
                label = f"K5 conv_s8 {name} B={B} {C}->{K} out {str(out_dtype)[6:]}"
                if Q.conv_s8_cuda.launches_mma - n_mma != int(mma):
                    raise AssertionError(f"{label}: {'not ' if mma else ''}launched on the tensor cores")
                diff = (out.float() - ref.float()).abs()
                err = diff.max().item()
                if out.shape != ref.shape or not bool((diff <= tol * ref.float().abs().clamp(min=1)).all()):
                    raise AssertionError(f"{label}: max|d| {err:.3g} fails {tol:g}*max(1,|ref|)")
                ms = cuda_ms(lambda: Q.conv_s8_cuda(*args, rows))
                pms = cuda_ms(lambda: Q.conv_s8_plain(*args))
                ops = 2 * M * C * K * k * k
                rec = record(err, ms, pms, nbytes=B * H * H * C + M * K * out.element_size() + k * k * C * K,
                             ops=ops, op_type="s8", library_ms=cudnn_ms)
                old = ""
                if mma:
                    same = Q.conv_s8_dp4a(*args, rows)
                    if not torch.equal(out, same) or not torch.equal(Q.conv_s8_cuda(*args), out):
                        raise AssertionError(f"{label}: {int((out != same).sum())} of {out.numel()} values differ from "
                                             f"the __dp4a kernel's, or a repeat run gave other bits")
                    old = (f", bit-identical to the __dp4a kernel ({cuda_ms(lambda: Q.conv_s8_dp4a(*args, rows)):.4f} ms) "
                           f"and to a repeat run")
                log(f"  {label} ({how}): max|d| {err:.3g} (bound {tol:g}*max(1,|ref|)){old}; kernel {ms:.4f} ms "
                    f"({rate(ops, ms)} TOP/s), plain {pms:.4f} ms, cuDNN bf16 conv {cudnn_ms:.4f} ms, "
                    f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
                if (name, B, out_dtype) == ("3x3 256px", 8, torch.bfloat16):
                    headline = rec
            del q, xb
    return headline


def phase3g_quantize(dev):
    """The quantize kernels against quantize_per_tensor on the card: s within
    1e-6 relative (the plain version divides by 127 as a product with the
    rounded reciprocal there), q within one level on at most 1e-4 of the
    tensor and equal wherever the scales are; the factors are s * s_w rounded
    once. Returns the headline record ((8, 256, 256, 256) bf16, the UNet's
    largest float conv input)."""
    import torch

    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    g = torch.Generator(device=dev).manual_seed(13)
    headline = None
    s_w = torch.rand(256, generator=g, device=dev) * 0.01 + 1e-4
    cases = [("randn", (8, 256, 256, 256)), ("randn", (8, 256, 256, 3)), ("randn", (8, 8, 8, 1024)),
             ("randn", (3, 7, 5, 3)), ("zeros", (2, 16, 16, 64)), ("one huge value", (2, 16, 16, 64)),
             ("exact ties", (2, 16, 16, 67)), *(("randn", shape) for shape in RECIPE_QUANTIZE_SHAPES)]
    with torch.inference_mode():
        for case, shape in cases:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(shape, generator=g, device=dev) * 3
                if case == "zeros":
                    x.zero_()
                elif case == "one huge value":
                    x.view(-1)[x.numel() // 2] = -3e30
                elif case == "exact ties":  # amax 127: the scale is 1 and every k + 0.5 is a tie
                    x = torch.randint(-126, 126, shape, generator=g, device=dev).float() + 0.5
                    x.view(-1)[0] = 127.0
                x = x.to(dtype)
                q, s, factors = Q.quantize_per_tensor_cuda(x, s_w)
                rq, rs = Q.quantize_per_tensor(x)
                torch.cuda.synchronize()
                label = f"quantize {case} {shape} {str(dtype)[6:]}"
                d = (q.float() - rq.float()).abs()
                flips = int((d > 0).sum())
                s_err = ((s - rs).abs() / rs).item()
                ok = (q.dtype == torch.int8 and q.shape == x.shape and d.max() <= 1 and flips <= max(1, 1e-4 * d.numel())
                      and s_err <= 1e-6 and torch.equal(factors, s * s_w) and (flips == 0 or not torch.equal(s, rs)))
                if case == "zeros":
                    ok = ok and not q.any() and s.item() == torch.tensor(1e-8).div(torch.tensor(127.0)).item()
                if case == "exact ties":
                    ok = ok and s.item() == 1.0 and torch.equal(q, torch.round(x.float()).to(torch.int8))
                if not ok:
                    raise AssertionError(f"{label}: s rel err {s_err:.3g} (bound 1e-6), q max|d| {d.max().item()}, "
                                         f"{flips} of {d.numel()} off (bound 1e-4, 0 with equal scales)")
                ms = cuda_ms(lambda: Q.quantize_per_tensor_cuda(x, s_w))
                pms = cuda_ms(lambda: Q.quantize_per_tensor(x))
                # the bound as K3's and K4's: x read once, q written once (the kernels read x twice, the amax
                # and then the values, from HBM wherever x exceeds the L2); ~6 f32 operations a value
                rec = record(float(d.max().item()), ms, pms, nbytes=x.numel() * (x.element_size() + 1),
                             ops=6 * x.numel(), op_type="f32")
                log(f"  {label}: s rel err {s_err:.3g} (bound 1e-6), q off by one on {flips} (bound 1e-4 of {d.numel()}); "
                    f"kernels {ms:.4f} ms, plain {pms:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
                if (case, shape, dtype) == ("randn", (8, 256, 256, 256), torch.bfloat16):
                    headline = rec
    return headline


def phase3e_fused_conv(dev):
    """K6 against fused_conv3x3_plain at 256 px, 256 -> 256 and 32 px,
    512 -> 512, batch 8, f32 and bf16 inputs, both modes, and cuDNN's bf16
    conv timed at the same shapes; returns the headline record (quantized,
    256 px, f32 in)."""
    import torch
    import torch.nn.functional as F

    from guided_diffusion_clip_tpu_torch.ops import fused_conv as FC

    tf32_off()
    g = torch.Generator(device=dev).manual_seed(9)
    headline = None
    with torch.inference_mode():
        for H, C, K in ((256, 256, 256), (32, 512, 512)):
            B = 8
            w = torch.randn(3, 3, C, K, generator=g, device=dev) * 0.05
            bias = torch.randn(K, generator=g, device=dev) * 0.1
            wb = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            for dtype in (torch.float32, torch.bfloat16):
                # rows of unequal range, so that a wrong band scale would show
                x = torch.randn(B, H, H, C, generator=g, device=dev)
                x = (x * torch.linspace(0.25, 4.0, H, device=dev)[None, :, None, None]).to(dtype)
                xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)  # channels_last NCHW view
                cudnn_ms = cuda_ms(lambda: F.conv2d(xb, wb, bias.to(torch.bfloat16), padding=1))
                for quantized in (True, False):
                    tol = 1e-6 if quantized and dtype == torch.float32 else 2e-2
                    out = FC.fused_conv3x3_cuda(x, w, bias, quantized=quantized)
                    ref = FC.fused_conv3x3_plain(x, w, bias, quantized=quantized)
                    torch.cuda.synchronize()
                    diff = (out.float() - ref.float()).abs()
                    err = diff.max().item()
                    label = (f"K6 fused_conv3x3 {'quantized' if quantized else 'bf16 mode'} {H}px B={B} "
                             f"{C}->{K} in {str(dtype)[6:]}")
                    if (out.shape != ref.shape or out.dtype != dtype or not torch.isfinite(out.float()).all()
                            or not bool((diff <= tol * ref.float().abs().clamp(min=1)).all())):
                        raise AssertionError(f"{label}: max|d| {err:.3g} fails {tol:g}*max(1,|ref|)")
                    ms = cuda_ms(lambda: FC.fused_conv3x3_cuda(x, w, bias, quantized=quantized))
                    pms = cuda_ms(lambda: FC.fused_conv3x3_plain(x, w, bias, quantized=quantized), runs=5, warmup=1)
                    log(f"  {label}: max|d| {err:.3g} (bound {tol:g}*max(1,|ref|)); kernel {ms:.4f} ms "
                        f"({rate(2 * B * H * H * C * K * 9, ms)} T/s), plain {pms:.4f} ms, cuDNN bf16 conv "
                        f"{cudnn_ms:.4f} ms")
                    if (H, dtype, quantized) == (256, torch.float32, True):
                        headline = record(err, ms, pms, nbytes=B * H * H * (C + K) * 4 + 9 * C * K * 4,
                                          ops=2 * B * H * H * C * K * 9, op_type="s8", library_ms=cudnn_ms)
                del x, xb
    return headline


def phase3f_mma_probe(dev):
    """K7 against accumulating_dots_plain: s8 bit for bit at T = 1, 3, 64 and
    2000 (the last two pass the s32 range, so they hold the wrap-around), bf16
    within 1e-2 * max|ref| at T = 4; then the rate from T = 2000 and 6000.
    Returns the headline record (s8, T = 2000). No one library call repeats
    a product T times, so its library time is T times the measured time of
    one ``torch._int_mm`` of the same operands."""
    import torch

    from guided_diffusion_clip_tpu_torch.ops import mma_probe as MP

    g = torch.Generator(device=dev).manual_seed(10)
    x8 = torch.randint(-127, 128, (MP.BM, MP.BK), generator=g, device=dev, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (MP.BK, MP.BN), generator=g, device=dev, dtype=torch.int8)
    xb = torch.randn(MP.BM, MP.BK, generator=g, device=dev).bfloat16()
    wb = torch.randn(MP.BK, MP.BN, generator=g, device=dev).bfloat16()
    for T in (1, 3, 64, 2000):
        out, ref = MP.accumulating_dots_cuda(x8, w8, T), MP.accumulating_dots_plain(x8, w8, T)
        torch.cuda.synchronize()
        bad = int((out != ref).sum())
        err_s8 = (out.long() - ref.long()).abs().max().item()  # the last T's is the headline's
        if out.dtype != torch.int32 or bad:
            raise AssertionError(f"K7 mma_probe s8 T={T}: {bad} of {out.numel()} entries differ from the plain "
                                 f"version, max|d| {err_s8}")
    log("  K7 mma_probe s8: bit-identical to the plain version (sum modulo 2^32) at T = 1, 3, 64, 2000")
    out, ref = MP.accumulating_dots_cuda(xb, wb, 4), MP.accumulating_dots_plain(xb, wb, 4)
    torch.cuda.synchronize()
    err_bf16 = (out - ref).abs().max().item()
    if not torch.isfinite(out).all() or not err_bf16 <= 1e-2 * ref.abs().max().item():
        raise AssertionError(f"K7 mma_probe bf16 T=4: max|d| {err_bf16:.3g} fails 1e-2*max|ref|")
    log(f"  K7 mma_probe bf16 T=4: max|d| {err_bf16:.3g} (bound 1e-2*max|ref| = {1e-2 * ref.abs().max().item():.3g})")
    t_lo, t_hi = 2000, 6000
    ops = 2 * MP.BM * MP.BK * MP.BN
    times = {}
    for name, (x, w) in (("s8", (x8, w8)), ("bf16", (xb, wb))):
        lo = cuda_ms(lambda: MP.accumulating_dots_cuda(x, w, t_lo), runs=5, warmup=1)
        hi = cuda_ms(lambda: MP.accumulating_dots_cuda(x, w, t_hi), runs=5, warmup=1)
        rate = (t_hi - t_lo) * ops / ((hi - lo) * 1e-3)
        if not hi > lo or rate > PEAK_OPS_PER_S[name]:
            raise AssertionError(f"K7 mma_probe {name}: T={t_lo} {lo:.3f} ms, T={t_hi} {hi:.3f} ms: no valid slope")
        times[name] = lo
        log(f"  K7 mma_probe {name}: T={t_lo} {lo:.4f} ms, T={t_hi} {hi:.4f} ms, slope {rate / 1e12:.2f} T/s "
            f"({100 * rate / PEAK_OPS_PER_S[name]:.1f} % of the data-sheet {PEAK_OPS_PER_S[name] / 1e12:.0f})")
    pms = cuda_ms(lambda: MP.accumulating_dots_plain(x8, w8, t_lo), runs=5, warmup=1)
    one_s8 = cuda_ms(lambda: torch._int_mm(x8, w8))
    one_bf16 = cuda_ms(lambda: torch.matmul(xb, wb))
    log(f"  one product: torch._int_mm {one_s8:.4f} ms ({ops / (one_s8 * 1e-3) / 1e12:.1f} TOP/s), torch.matmul bf16 "
        f"{one_bf16:.4f} ms ({ops / (one_bf16 * 1e-3) / 1e12:.1f} TFLOP/s); {t_lo} of them {t_lo * one_s8:.4f} ms and "
        f"{t_lo * one_bf16:.4f} ms, against K7's {times['s8']:.4f} ms and {times['bf16']:.4f} ms; plain version "
        f"(one f64 product times T) {pms:.4f} ms")
    # both operands read once, the sum written once
    return record(float(err_s8), times["s8"], pms, nbytes=MP.BM * MP.BK + MP.BK * MP.BN + 4 * MP.BM * MP.BN,
                  ops=t_lo * ops, op_type="s8", library_ms=t_lo * one_s8)


def _wrappers() -> dict:
    """Kernel name -> the wrapper that launches it (and counts its launches)."""
    from guided_diffusion_clip_tpu_torch.ops import attention as A
    from guided_diffusion_clip_tpu_torch.ops import fused_conv as FC
    from guided_diffusion_clip_tpu_torch.ops import groupnorm as G
    from guided_diffusion_clip_tpu_torch.ops import mma_probe as MP
    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    return {"attention": A.attention_fwd_cuda, "attention_bwd": A.attention_bwd_cuda,
            "group_norm": G.fused_group_norm, "group_norm_quant": G.fused_group_norm_quant,
            "conv_s8": Q.conv_s8_cuda, "quantize": Q.quantize_per_tensor_cuda,
            "conv_fused": FC.fused_conv3x3_cuda, "mma_probe": MP.accumulating_dots_cuda}


def counters() -> dict:
    """Every kernel wrapper's launch count."""
    return {fn_name: fn.launches for fn_name, fn in _wrappers().items()}


def reset_counters() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_mma"):
            fn.launches_mma = 0


def tensor_core_split(launches: dict) -> dict:
    """A path's ``counters()``, read just before with no launch since, plus the
    K1 and K2 launches that ran on the FMA-pipe kernels (``attention_fwd.cu``,
    ``attention_bwd.cu``: float32 calls, every bf16 one runs the tensor-core
    kernels) as ``attention_fma`` and ``attention_bwd_fma``; ``attention``
    and ``attention_bwd`` keep counting both kernels."""
    from guided_diffusion_clip_tpu_torch.ops import attention as A

    return {**launches, "attention_fma": launches["attention"] - A.attention_fwd_cuda.launches_mma,
            "attention_bwd_fma": launches["attention_bwd"] - A.attention_bwd_cuda.launches_mma}


def f32_attention_calls(clf) -> int:
    """Attention calls of one classifier forward that are float32 by the
    reference's design: the attention pool keeps f32 in a bf16 classifier, so
    its K1 (and K2) stays on the FMA-pipe kernels, which are exact to 1e-4."""
    from guided_diffusion_clip_tpu_torch.models.unet import AttentionPool2d

    return sum(isinstance(m, AttentionPool2d) for m in clf.modules())


def check_tensor_core_launches(path: str, k1_f32: int = 0, k2_f32: int = 0) -> None:
    """After a main path (bf16 torsos): every bf16 K1 and K2 launch since the
    counts were reset ran on the tensor cores; the FMA-pipe kernels took the
    ``k1_f32`` and ``k2_f32`` float32 calls and nothing else."""
    from guided_diffusion_clip_tpu_torch.ops import attention as A

    for name, fn, f32 in (("K1", A.attention_fwd_cuda, k1_f32), ("K2", A.attention_bwd_cuda, k2_f32)):
        if fn.launches - fn.launches_mma != f32:
            raise AssertionError(f"{path}: {fn.launches_mma} of {name}'s {fn.launches} launches ran on the tensor "
                                 f"cores, with {f32} float32 calls")
    log(f"  {path}: {A.attention_fwd_cuda.launches_mma} of {A.attention_fwd_cuda.launches} K1 and "
        f"{A.attention_bwd_cuda.launches_mma} of {A.attention_bwd_cuda.launches} K2 launches ran on the tensor cores: "
        f"every bf16 one (float32 calls, the classifier's attention pool: {k1_f32} and {k2_f32})")


def dp4a_convs(model) -> int:
    """The convs of ``model``'s structure (a module or a list of modules) that
    K5 keeps on ``__dp4a`` under int8: the stems (3 channels in) and the head
    (6 channels out), counted from the modules' channels alone and not by the
    wrapper's own dispatch rule, so that a rule that sent any other conv to
    ``__dp4a`` would fail the count."""
    from guided_diffusion_clip_tpu_torch.models.nn import Conv2d

    roots = model if isinstance(model, (list, tuple)) else [model]
    return sum(isinstance(m, Conv2d) and (m.in_channels == 3 or m.out_channels == 6)
               for root in roots for m in root.modules())


def check_conv_tensor_core_launches(path: str, dp4a: int) -> None:
    """After an int8 main path: every K5 launch since the counts were reset
    ran on the tensor cores but the ``dp4a`` stem and head convs counted from
    the modules."""
    from guided_diffusion_clip_tpu_torch.ops.quant import conv_s8_cuda as k5

    if k5.launches - k5.launches_mma != dp4a or (k5.launches and not k5.launches_mma):
        raise AssertionError(f"{path}: {k5.launches_mma} of K5's {k5.launches} launches ran on the tensor cores, "
                             f"with {dp4a} stem and head convs")
    log(f"  {path}: {k5.launches_mma} of {k5.launches} K5 launches ran on the tensor cores: all but the {dp4a} "
        f"stem (3 channels in) and head (6 channels out) convs")


def gn_conv_counts(model, int8: bool) -> dict:
    """K3, K4 and K5 launches and launches of the quantize kernels of one
    forward of ``model``'s structure (a module, or a list of the modules a
    partial forward runs) with ``int8`` or without, counted from its modules:
    under int8 every ResBlock's out_norm and every in_norm but a down
    block's quantizes (K4) and feeds one conv, every other GroupNorm is K3,
    every conv runs K5 once, and every conv that no K4 feeds quantizes its
    float input itself; otherwise every GroupNorm is K3 and no conv runs K5."""
    from guided_diffusion_clip_tpu_torch.models.nn import Conv2d, GroupNorm32
    from guided_diffusion_clip_tpu_torch.models.unet import ResBlock

    roots = model if isinstance(model, (list, tuple)) else [model]
    mods = [m for root in roots for m in root.modules()]
    gn = sum(isinstance(m, GroupNorm32) for m in mods)
    if not int8:
        return {"group_norm": gn, "group_norm_quant": 0, "conv_s8": 0, "quantize": 0}
    k4 = sum((1 if m.down else 2) for m in mods if isinstance(m, ResBlock))
    convs = sum(isinstance(m, Conv2d) for m in mods)
    return {"group_norm": gn - k4, "group_norm_quant": k4, "conv_s8": convs, "quantize": convs - k4}


def shallow_roots(model, cut: int) -> list:
    """The modules that a ``cache_mode="shallow"`` forward of a UNetModel runs."""
    n_in = len(model.input_blocks)
    return [*list(model.input_blocks)[:cut], *list(model.output_blocks)[n_in - cut:], model.out]


def unet_counts(model, int8: bool, shallow_cut=None) -> dict:
    """K1, K3, K4 and K5 launches of one forward of a UNetModel, from its
    modules: the whole model, or with ``shallow_cut`` the blocks that a
    ``cache_mode="shallow"`` forward runs (``input_blocks[:cut]``, the last
    ``cut`` output blocks and the head)."""
    from guided_diffusion_clip_tpu_torch.models.unet import AttentionBlock

    roots = [model] if shallow_cut is None else shallow_roots(model, shallow_cut)
    attn = sum(isinstance(m, AttentionBlock) for root in roots for m in root.modules())
    return {"attention": attn, **gn_conv_counts(roots, int8)}


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


def phase4e_deep_cache(dev, sd):
    """The UNet's cache modes at full width, batch 1, f32: a ``full`` forward
    and a ``shallow`` one fed its deep feature, card against CPU; on the card
    the shallow forward against the plain (``off``) one at the same (x, t),
    which it must equal but for the order of the kernels' launches."""
    import torch

    from guided_diffusion_clip_tpu_torch.utils.script_util import create_model

    tf32_off()
    model = create_model(
        256, 256, 2, learn_sigma=True, class_cond=True, attention_resolutions="32,16,8",
        num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True, use_fp16=False,
    ).eval()
    model.load_state_dict(sd, strict=True)
    g = torch.Generator().manual_seed(12)
    x = torch.randn(1, 3, 256, 256, generator=g)
    t = torch.tensor([500])
    feat = torch.randn(1, 512, generator=g)

    def run(m, to):
        kw = dict(clip_feat=feat.to(to))
        full, deep = m(x.to(to), t.to(to), cache_mode="full", **kw)
        shallow, deep_back = m(x.to(to), t.to(to), deep_cache=deep, cache_mode="shallow", **kw)
        if deep_back is not deep:
            raise AssertionError("a shallow forward must hand back the deep feature it was given")
        return full, deep, shallow

    with torch.inference_mode():
        ref = run(model, "cpu")
        model.to(dev)
        before = counters()
        out = run(model, dev)
        ran = {k: counters()[k] - before[k] for k in ("attention", "group_norm")}
        off = model(x.to(dev), t.to(dev), clip_feat=feat.to(dev))
    cut = model.config.num_res_blocks + 1
    per_full, per_shallow = unet_counts(model, False), unet_counts(model, False, cut)
    want = {k: per_full[k] + per_shallow[k] for k in ran}
    if ran != want:
        raise AssertionError(f"full + shallow forward launched {ran}, planned {want}")
    if tuple(out[1].shape) != (1, 256, 256, 256):
        raise AssertionError(f"deep feature {tuple(out[1].shape)}, not (1, 256, 256, 256)")
    for name, o, r in zip(("full output", "deep feature", "shallow output"), out, ref):
        rel = ((o.cpu().float() - r.float()).norm() / r.float().norm()).item()
        log(f"  {name} {tuple(o.shape)} f32: rel L2 err card vs CPU {rel:.3g} (bound 1e-3)")
        if not torch.isfinite(o).all() or not r.norm() > 0 or not rel <= 1e-3:
            raise AssertionError(f"card {name} differs from the CPU's: rel L2 {rel:.3g}")
    rel = ((out[2] - off).norm() / off.norm()).item()
    log(f"  shallow(deep from full) vs the plain forward on the card: rel L2 {rel:.3g} (bound 1e-5); a full "
        f"forward launches {per_full}, a shallow one {per_shallow} (cut {cut})")
    if not rel <= 1e-5:
        raise AssertionError(f"shallow forward differs from the plain forward: rel L2 {rel:.3g}")
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
    (mean / std)^2 ulps of the group; q within one level on at most ``share``
    of it, 1e-4 by default; the
    conv's relative L2 within 5e-3 and max within 1e-2 * max|ref|, as one
    flipped level of x_q moves a 3x3 patch by s_x * |w|) and replaced by it,
    keeping the card's gradient. Without it, a value that rounds the other
    way in the card's sums moves the next layer's inputs by a level's worth
    and the flips compound layer by layer. The output heads (``out.*``) are
    left alone: the caller compares what they give.
    """

    def __init__(self, share: float = 1e-4):
        self.share = share
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
                if d.max() > 1 or flips > max(1, self.share * d.numel()) or not s_err <= s_tol:
                    raise AssertionError(f"int8 forcing: q max|d| {d.max().item()}, {flips} of {d.numel()} "
                                         f"off (bound {self.share:g}), s rel err {s_err:.3g} (bound {s_tol:.3g})")
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


def start_server(sampler):
    """Serve ``sampler`` over HTTP on a free local port; returns (httpd,
    thread, base url)."""
    from http.server import ThreadingHTTPServer

    from guided_diffusion_clip_tpu_torch import serve

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(sampler))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, f"http://127.0.0.1:{httpd.server_address[1]}"


def get_healthz(url) -> dict:
    with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
        return json.loads(r.read())


def post_sample(url, n, seed, feat=None, size=256):
    """POST /sample; returns (the n uint8 images of ``size`` px, the request's
    seconds)."""
    import numpy as np

    payload = {"num_samples": n, "seed": seed}
    if feat is not None:
        payload["clip_feat"] = feat.tolist()
    req = urllib.request.Request(
        f"{url}/sample", data=json.dumps(payload).encode(),
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


def phase5_serve(dev, ckpt_path, conv_impl="auto"):
    """The serving path over HTTP; returns the kernels' launch counts. Under
    int8 the per-sample RNG contract across packings does not hold (the
    per-tensor scale of int8_conv spans the batch, in the JAX server too),
    so only the same request at the same bucket is held to the same bytes."""
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
    httpd, thread, url = start_server(sampler)


    def healthz():
        return get_healthz(url)

    def sample(n, seed, feat=None):
        return post_sample(url, n, seed, feat, size)

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


def phase5c_serve_cfg(dev, ckpt_path):
    """``serve --cfg_scale 2.0 --cfg_cache 2 --sampler dpm++2m`` over HTTP, one
    bucket of 4, bf16, 25 steps; returns the kernels' launch counts. A chain
    runs the conditional branch every step and refreshes the unconditional
    one on steps 0, 2, ..., 24: 25 + 13 forwards."""
    import numpy as np
    import torch

    from guided_diffusion_clip_tpu_torch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    flags = list(SLICE_FLAGS)
    for name, value in (("--batch_size", "4"), ("--batch_buckets", ""), ("--coalesce_ms", "0"), ("--use_ddim", "False")):
        flags[flags.index(name) + 1] = value
    args = serve.parse_args([*flags, "--sampler", "dpm++2m", "--cfg_scale", "2.0", "--cfg_cache", "2",
                             "--model_path", ckpt_path, "--device", dev.type])

    reset_counters()
    t0 = time.perf_counter()
    sampler = serve.Sampler(args)
    sampler.warmup()
    log(f"  CFG server built and warm in {time.perf_counter() - t0:.1f} s; warm chain latency "
        f"{sampler.bucket_latency[4]:.3f} s (batch 4, 25 dpm++2m steps, 38 forwards)")
    httpd, thread, url = start_server(sampler)
    try:
        h = get_healthz(url)
        if not (h["ok"] and h["compiled"] and h["sampler"] == "dpm++2m" and h["steps"] == 25):
            raise AssertionError(f"/healthz: {h}")
        feat = np.random.RandomState(5).standard_normal((4, 512)).astype(np.float32)
        a, dt = post_sample(url, 4, 31, feat)
        b, _ = post_sample(url, 4, 31, feat)
        if not np.array_equal(a, b):
            raise AssertionError("repeated CFG /sample n=4 returned different bytes")
        log(f"  /sample n=4 (cfg_scale 2.0, cfg_cache 2, dpm++2m): {dt:.3f} s, {4 / dt:.3f} samples/s; "
            f"repeated: the same bytes")
    finally:
        stop_server(sampler, httpd, thread)
    chains = sampler.dispatches
    if sampler.forwards != chains * (25 + 13):
        raise AssertionError(f"{sampler.forwards} forwards in {chains} chains, not 25 steps + 13 refreshes each")
    return check_serve_launches(sampler, False)


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
    want = {**dict.fromkeys(launches, 0), "attention": ATTN_PER_FORWARD * forwards,
            **{k: n * forwards for k, n in per.items()}}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want} ({forwards} forwards)")
    check_tensor_core_launches("serving")
    if int8:
        check_conv_tensor_core_launches("serving", dp4a_convs(sampler.model) * forwards)
    return tensor_core_split(launches)


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
        per[name]["dp4a"] = dp4a_convs(model)
        pools = f32_attention_calls(model)  # the last model of the loop is the classifier
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
    dp4a = (per["model"].pop("dp4a") + per["classifier"].pop("dp4a")) * steps
    want = {**dict.fromkeys(launches, 0), "attention": (ATTN_PER_FORWARD + CLF_ATTN_PER_FORWARD) * steps,
            "attention_bwd": CLF_ATTN_PER_FORWARD * steps,
            **{k: (per["model"][k] + per["classifier"][k]) * steps for k in per["model"]}}
    log(f"  {steps} guided steps ({conv_impl}); kernel launches {launches} (expected {want}: per step the "
        f"UNet's {per['model']} and the classifier's {per['classifier']})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    check_tensor_core_launches("guided sampling", pools * steps, pools * steps)
    if int8:
        check_conv_tensor_core_launches("guided sampling", dp4a)
    chain = sum(out["chain_seconds"])
    log(f"  guided chain ({conv_impl}, batch 8, {out['steps']} steps): {chain:.3f} s, "
        f"{8 * 60 / chain:.3f} samples/min, {1000 * chain / steps:.2f} ms a step; main() {wall:.1f} s "
        f"with model building and loading")
    return tensor_core_split(launches), paths, images, chain


PRESET_FLAGS = ["--conv_impl", "int8", "--deep_cache", "5", "--guidance_cache", "2",
                "--guidance_interval", "200,800"]


def phase6c_preset(dev, tmp, paths):
    """classifier_sample.main with the deploy preset's four knobs (the keys of
    configs/deploy256_fast.yaml, given as flags) on ADM-G 256 + classifier,
    250 ancestral steps at batch 8; returns the launch counts, the samples
    and the chain's seconds. The expected counts come from the modules (what
    a full and a shallow UNet forward and a classifier forward launch) and
    from the schedule (DeepCache refreshes on steps 0, 5, ...; the classifier
    runs on the even steps whose model timestep lies in [200, 800])."""
    import numpy as np
    import torch

    from guided_diffusion_clip_tpu_torch import classifier_sample
    from guided_diffusion_clip_tpu_torch.utils.script_util import (
        args_to_dict, create_classifier, create_gaussian_diffusion, create_upstream_model,
    )

    flags = [*GUIDED_FLAGS, *PRESET_FLAGS]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    args = classifier_sample.create_argparser().parse_args(flags)
    model = create_upstream_model(**args_to_dict(args, classifier_sample._UNET_KEYS), conv_impl="int8")
    cut = model.config.num_res_blocks + 1
    per_full, per_shallow = unet_counts(model, True), unet_counts(model, True, cut)
    clf = create_classifier(**args_to_dict(args, classifier_sample.classifier_defaults().keys()), conv_impl="int8")
    per_clf = {"attention": CLF_ATTN_PER_FORWARD, "attention_bwd": CLF_ATTN_PER_FORWARD, **gn_conv_counts(clf, True)}
    pools = f32_attention_calls(clf)
    dp4a_full, dp4a_shallow, dp4a_clf = dp4a_convs(model), dp4a_convs(shallow_roots(model, cut)), dp4a_convs(clf)
    del model, clf
    # the schedule says which steps guide: step i runs local timestep T - 1 - i
    tmap = create_gaussian_diffusion(steps=1000, learn_sigma=True, timestep_respacing="250").sched.timestep_map.tolist()
    steps = len(tmap)
    inside = [200 <= tmap[steps - 1 - i] <= 800 for i in range(steps)]
    n_clf = sum(1 for i in range(steps) if i % 2 == 0 and inside[i])
    n_full = len(range(0, steps, 5))
    n_shallow = steps - n_full

    argv = [*flags, "--model_path", paths["model"], "--classifier_path", paths["classifier"],
            "--main_path", os.path.join(tmp, "runs_preset"), "--device", dev.type]
    reset_counters()
    t0 = time.perf_counter()
    out = classifier_sample.main(argv)
    wall = time.perf_counter() - t0
    launches = counters()

    calls = out["calls"]
    want_calls = {"unet_full": n_full, "unet_shallow": n_shallow, "classifier": n_clf}
    log(f"  {steps} steps: {sum(inside)} inside the window [200, 800]; network calls {calls} "
        f"(expected {want_calls} from the schedule)")
    if calls != want_calls or out["steps"] != steps or out["batches"] != 1:
        raise AssertionError(f"network calls {calls} != {want_calls}")
    want = dict.fromkeys(launches, 0)
    for per, n in ((per_full, n_full), (per_shallow, n_shallow), (per_clf, n_clf)):
        for k, v in per.items():
            want[k] += v * n
    log(f"  kernel launches {launches} (expected {want}: a full UNet forward {per_full}, a shallow one "
        f"{per_shallow}, a classifier forward + backward {per_clf})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    check_tensor_core_launches("the preset", pools * n_clf, pools * n_clf)
    check_conv_tensor_core_launches("the preset", dp4a_full * n_full + dp4a_shallow * n_shallow + dp4a_clf * n_clf)
    images = np.load(out["path"])["arr_0"]
    if images.shape != (8, 256, 256, 3) or images.dtype != np.uint8 or not all(images[i].std() > 0 for i in range(8)):
        raise AssertionError(f"preset samples {images.shape} {images.dtype}: not 8 non-constant uint8 images")
    chain = sum(out["chain_seconds"])
    log(f"  preset chain (int8, deep_cache 5, guidance_cache 2, guidance_interval 200,800; batch 8, {steps} "
        f"steps): {chain:.3f} s, {8 * 60 / chain:.3f} samples/min, {1000 * chain / steps:.2f} ms a step; "
        f"main() {wall:.1f} s with model building and loading")
    return tensor_core_split(launches), images, chain


def phase7_tools():
    """The two tool entry points, called as their ``main()`` on the card: the
    paths that launch K6 and K7. Returns the kernels' launch counts."""
    from guided_diffusion_clip_tpu_torch.tools import conv_bench, mxu_ceiling

    os.environ["PCB_SHAPES"] = "8x256x256x256,8x32x512x512"
    for name in ("PCB_ONLY", "CMB_ITERS", "MXU_REPS"):  # the tools' defaults: 20 calls a timing, best of 3
        os.environ.pop(name, None)
    reset_counters()
    rows = conv_bench.main([])
    ceiling = mxu_ceiling.main([])
    launches = counters()
    if len(rows) != 2 or not all(isinstance(r.get(k), float) and r[k] > 0 for r in rows
                                 for k in ("cudnn_bf16", "k5_int8", "k6_bf16", "k6_int8")):
        raise AssertionError(f"conv_bench rows: {rows}")
    if not all(ceiling[k]["tf_per_sec_slope"] > 0 for k in ("s8", "bf16")):
        raise AssertionError(f"mxu_ceiling: {ceiling}")
    # per shape and K6 mode 1 warm-up call and 3 timings of 20 calls;
    # per type and T 1 warm-up call and 3 timings
    want = {**dict.fromkeys(launches, 0), "conv_fused": 2 * 2 * 61, "conv_s8": 2 * 61, "quantize": 2 * 61,
            "mma_probe": 2 * 2 * 4}
    log(f"  kernel launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    check_conv_tensor_core_launches("conv_bench", 0)
    return tensor_core_split(launches)


def _kernel_group(name: str) -> str:
    if "attention_fwd_" in name:
        return "K1 attention"
    if "attention_bwd_" in name:
        return "K2 attention backward"
    if "gn_fused_kernel" in name:  # <T, Q, VEC, SILU, QUANT>, demangled or mangled
        args = re.search(r"gn_fused_kernel<([^>]*)>", name)
        quant = (args.group(1).split(",")[-1].strip() == "true" if args
                 else re.search(r"gn_fused_kernelI\w*?Lb[01]ELb1EE", name) is not None)
        return "K4 quantizing GroupNorm" if quant else "K3 GroupNorm"
    if "conv_s8_" in name:
        return "K5 s8 conv"
    if "absmax_kernel" in name or "quantize_kernel" in name:
        return "int8_conv's quantize kernels"
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


# ---------------------------------------------------------------------------
# Phase 8: one-GPU training of the fork's recipe (configs/config.yaml: the
# CLIP-conditioned UNet at 128 px, 64 channels, mult (1,1,2,3,4), attention at
# 16 and 8 px with one head, learned sigma, bf16 torso, batch 48)
# ---------------------------------------------------------------------------

TRAIN_BATCH = 48  # the recipe's batch_size
TRAIN_ATTN_SHAPES = [(48, 256, 1, 192), (48, 64, 1, 256)]  # (B, T, heads, d) of its attention at 16 and 8 px


def recipe_args(**over):
    """configs/config.yaml as ``image_train`` reads it (the file's keys over
    the flags' defaults), then ``over``."""
    from guided_diffusion_clip_tpu_torch import image_train
    from guided_diffusion_clip_tpu_torch.utils.script_util import parse_yaml

    root = os.path.dirname(os.path.abspath(__file__))
    args = parse_yaml(image_train.create_argparser().parse_args(
        ["--config-file", os.path.join(root, "configs", "config.yaml")]))
    for k, v in over.items():
        setattr(args, k, v)
    return args


def recipe_model(**over):
    from guided_diffusion_clip_tpu_torch.utils.script_util import (
        args_to_dict, create_model_and_diffusion, model_and_diffusion_defaults,
    )

    args = recipe_args(**over)
    return args, *create_model_and_diffusion(**args_to_dict(args, model_and_diffusion_defaults().keys()),
                                             conv_impl=args.train_conv_impl)


def recipe_loop(dev, sd, batch_size, tmp, **over):
    """A ``TrainLoop`` of the recipe on ``dev`` with the weights ``sd``, logging to ``tmp``."""
    from guided_diffusion_clip_tpu_torch.training.train_loop import TrainLoop
    from guided_diffusion_clip_tpu_torch.utils import logger

    args, model, diffusion = recipe_model(**over)
    model.load_state_dict(sd, strict=True)
    logger.configure_dir(tmp, format_strs=[])
    return TrainLoop(model=model.to(dev), diffusion=diffusion, data=None, batch_size=batch_size, microbatch=-1,
                     lr=args.lr, ema_rate=args.ema_rate, log_interval=10**9, save_interval=10**9,
                     weight_decay=args.weight_decay)


def recipe_batch(n, seed=0):
    """A host batch as ``load_data`` yields one for a CLIP dict: NCHW images
    in [-1, 1], clip_feat, and the pair img2 / clip_feat2."""
    import numpy as np

    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (n, 3, 128, 128)).astype(np.float32)
    feat = rs.standard_normal((n, 512)).astype(np.float32)
    return x, {"clip_feat": feat, "img2": np.roll(x, 1, axis=0), "clip_feat2": np.roll(feat, 1, axis=0)}


def train_counts(model, remat: bool) -> dict:
    """K1, K2 and K3 launches of one train step (one microbatch) of a UNetModel,
    from its modules: every attention block runs K1 in the forward and K2 in
    the backward, every GroupNorm K3; under ``use_checkpoint`` the backward
    recomputes each ResBlock and AttentionBlock, so their K1 and K3 launch
    twice (the output head's GroupNorm is in no block). Under int8 (no
    ``use_checkpoint``) the forward's K3, K4, K5 and quantize launches are
    ``gn_conv_counts``'s; the backward launches none of them (straight-through
    convs on cuDNN, the GroupNorm backward in PyTorch ops)."""
    from guided_diffusion_clip_tpu_torch.models.nn import GroupNorm32
    from guided_diffusion_clip_tpu_torch.models.unet import AttentionBlock, ResBlock

    blocks = [m for m in model.modules() if isinstance(m, (ResBlock, AttentionBlock))]
    attn = sum(isinstance(m, AttentionBlock) for m in blocks)
    if model.int8:
        assert not remat, "the smoke trains int8 without use_checkpoint"
        return {"attention": attn, "attention_bwd": attn, **gn_conv_counts(model, True)}
    gn = sum(isinstance(m, GroupNorm32) for m in model.modules())
    gn_blocks = sum(isinstance(m, GroupNorm32) for b in blocks for m in b.modules())
    return {"attention": attn * (1 + remat), "attention_bwd": attn, "group_norm": gn + remat * gn_blocks}


def phase8a_attention(dev) -> None:
    """K1 and K2 at the recipe's shapes (batch 48, one head, d = 192 at T = 256
    and d = 256 at T = 64) against their plain versions, f32 (TF32 off; the
    FMA-pipe kernels) and bf16 (the tensor-core kernels, as the training path
    runs them), the same bits on a repeat, with the library call and the bound
    beside each. In bf16 also: the FMA kernels' time on the same input, K1
    with 32 and with 64 query rows a block through its C entry point, and both
    kernels held to the float64 result beside the FMA kernels (``held_to_f64``)."""
    import torch
    import torch.nn.functional as F

    from guided_diffusion_clip_tpu_torch.ops import attention as A
    from guided_diffusion_clip_tpu_torch.ops import build

    tf32_off()
    g = torch.Generator(device=dev).manual_seed(8)
    for B, T, H, d in TRAIN_ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(B, T, 3 * H * d, generator=g, device=dev).to(dtype)
            do = torch.randn(B, T, H * d, generator=g, device=dev).to(dtype)
            q, k, v = (t.permute(0, 2, 1, 3).detach().requires_grad_(True) for t in A.split_qkv(qkv, H, False))
            with torch.enable_grad():
                o = F.scaled_dot_product_attention(q, k, v)
            dob = do.reshape(B, T, H, d).permute(0, 2, 1, 3)
            mma = dtype == torch.bfloat16
            for name, fn, kernel, plain, library, fma, bound in (
                ("K1 attention", A.attention_fwd_cuda, lambda: A.attention_fwd_cuda(qkv, H),
                 lambda: A.qkv_attention_plain(qkv, H),
                 lambda: F.scaled_dot_product_attention(q.detach(), k.detach(), v.detach()),
                 lambda: fma_attention(qkv, H, False), attention_bound(B, T, H, d, False, not mma)),
                ("K2 attention_bwd", A.attention_bwd_cuda, lambda: A.attention_bwd_cuda(qkv, do, H),
                 lambda: A.qkv_attention_bwd_plain(qkv, do, H, False),
                 lambda: torch.autograd.grad(o, (q, k, v), dob, retain_graph=True),
                 lambda: fma_attention(qkv, H, False, do), attention_bound(B, T, H, d, True, not mma)),
            ):
                label = f"{name} B={B} T={T} heads={H} d={d} {str(dtype)[6:]}"
                n_mma = fn.launches_mma
                out, ref = kernel(), plain()
                torch.cuda.synchronize()
                if fn.launches_mma - n_mma != int(mma):
                    raise AssertionError(f"{label}: {'not ' if mma else ''}launched on the tensor cores")
                diff = (out.float() - ref.float()).abs()
                if dtype == torch.float32 and name.startswith("K1"):
                    tol, ok = "max|d| <= 1e-4", bool(diff.max() <= 1e-4)
                else:
                    rtol = 1e-4 if dtype == torch.float32 else 2e-2
                    tol, ok = f"|d| <= {rtol:g}*max(1,|ref|)", bool((diff <= rtol * ref.float().abs().clamp(min=1.0)).all())
                if not torch.isfinite(out.float()).all() or not ok:
                    raise AssertionError(f"{label}: max|d| {diff.max().item():.3g} fails {tol}")
                if not torch.equal(kernel(), out):
                    raise AssertionError(f"{label}: a repeat run gave other bits")
                ms, pms, lib = cuda_ms(kernel), cuda_ms(plain), cuda_ms(library)
                rec = record(diff.max().item(), ms, pms, **bound, library_ms=lib)
                log(f"  {label}: max|d| {rec['max_abs_err']:.3g} ({tol}), repeat bit-identical; kernel {ms:.4f} ms "
                    f"({'mma.sync' if mma else 'FMA pipes'}), plain {pms:.4f} ms, library {lib:.4f} ms, bound "
                    f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), {ms / rec['bound_ms']:.1f}x the bound")
                if not mma:
                    continue
                fma_out, fma_ms = fma(), cuda_ms(fma)
                line = f"    the FMA kernel on the same input {fma_ms:.4f} ms ({fma_ms / ms:.2f}x the tensor-core kernel)"
                if name.startswith("K1"):
                    lib_c, stream, scale = build.load(), torch.cuda.current_stream(dev).cuda_stream, 1 / math.sqrt(math.sqrt(d))

                    def rows(n):
                        res = torch.empty(B, T, H * d, dtype=dtype, device=dev)
                        build.check(lib_c.gdc_attention_fwd_mma(qkv.data_ptr(), res.data_ptr(), B, T, H, d, 0, n,
                                                                scale, stream), "gdc_attention_fwd_mma")
                        return res

                    picked = A.fwd_q_rows(T, B * H, d, torch.cuda.get_device_properties(dev).multi_processor_count)
                    line += (f"; through the C entry point, 32 query rows a block {cuda_ms(lambda: rows(32)):.4f} ms, "
                             f"64 rows {cuda_ms(lambda: rows(64)):.4f} ms (fwd_q_rows picks {picked}; "
                             f"{math.ceil(T / 32) * B * H} and {math.ceil(T / 64) * B * H} blocks)")
                    ref64 = attention_fwd_f64(qkv, H, False)
                else:
                    ref64 = attention_bwd_f64(qkv, do, H, False)
                log(line)
                held_to_f64(label, out, fma_out, ref64)


# The bf16-torso step, card against CPU (both bf16), in relative L2 (step_errors). Readings on an H100
# (the card's step is deterministic; the CPU's is oneDNN's): loss 3.5e-7, grad_norm 2.8e-5, updated
# params 1.0e-5, gradient 6.3e-4, attention qkv/norm 6.1e-3, proj_out 5.6e-3, GroupNorms 4.2e-4; the
# control, the CPU's bf16 step against its f32 step: 1.2e-6, 2.2e-4, 1.6e-3, 2.0e-3, 8.6e-3, 8.1e-3,
# 2.1e-3. Faults injected on the card only gave: K2's output x 1.01, qkv/norm 1.1e-2; K1's x 1.05,
# proj_out 1.5e-2; K3's saved rstd x 1.002, grad_norm 9.0e-4, gradient 2.2e-3, GroupNorms 2.1e-3.
TRAIN_BF16_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "updated params": 5e-5, "gradient": 1.5e-3,
                  "gradient, attention qkv, norm": 1e-2, "gradient, attention proj_out": 1e-2,
                  "gradient, GroupNorms": 1e-3}


def train_step_on(d, sd, x, cond, noise, tmp, forcing=None, **over) -> dict:
    """One ``run_step`` of the recipe (dropout 0) on device ``d`` from the
    weights ``sd``: its metrics, the updated parameters and the summed
    gradient (Adam's first moment after one update is 0.1 x the gradient), on
    the host, the names of the parameters in three groups (the attention
    blocks' qkv and norm, which K2's gradient reaches first; their proj_out,
    which K1's output reaches; the GroupNorms), and the step's seconds (the
    first, with its set-up). With an ``Int8Forcing``, the step's roundings
    are recorded on the CPU and forced on the card."""
    from guided_diffusion_clip_tpu_torch.models.nn import GroupNorm32
    from guided_diffusion_clip_tpu_torch.models.unet import AttentionBlock

    loop = recipe_loop(d, sd, len(x), tmp, dropout=0.0, **over)
    t0 = time.perf_counter()
    if forcing is None:
        loop.run_step(x, cond, noise=noise)
    else:
        with forcing.record(loop.model) if d.type == "cpu" else forcing.force(loop.model):
            loop.run_step(x, cond, noise=noise)
    met = loop._fetch(loop._pending_log[2])
    secs = time.perf_counter() - t0
    groups: dict = {"attention qkv, norm": set(), "attention proj_out": set(), "GroupNorms": set()}
    for m, mod in loop.model.named_modules():
        parts = ((("qkv", "attention qkv, norm"), ("norm", "attention qkv, norm"), ("proj_out", "attention proj_out"))
                 if isinstance(mod, AttentionBlock) else (("", "GroupNorms"),) if isinstance(mod, GroupNorm32) else ())
        for part, label in parts:
            sub = getattr(mod, part) if part else mod
            groups[label].update(".".join(filter(None, (m, part, n))) for n, _ in sub.named_parameters())
    return {"met": met, "params": {n: p.detach().cpu() for n, p in zip(loop.names, loop.params)},
            "grad": {n: 10 * loop.opt.state[p]["exp_avg"].cpu() for n, p in zip(loop.names, loop.params)},
            "groups": groups, "secs": secs}


def step_errors(a: dict, b: dict) -> dict:
    """How far step ``a`` is from step ``b``: loss and grad_norm relative; the
    updated parameters and the gradient in relative L2 over all parameters;
    and the gradient over each of ``train_step_on``'s groups of parameters
    (K1, K2 and K3 reach these first, and they hold a small share of the
    whole gradient), each in relative L2."""
    def rel(x, y, names):
        return (sum(float((x[k] - y[k]).double().square().sum()) for k in names)
                / sum(float(y[k].double().square().sum()) for k in names)) ** 0.5

    return {"loss": abs(float(a["met"]["loss"]) / float(b["met"]["loss"]) - 1),
            "grad_norm": abs(float(a["met"]["grad_norm"]) / float(b["met"]["grad_norm"]) - 1),
            "updated params": rel(a["params"], b["params"], b["params"]),
            "gradient": rel(a["grad"], b["grad"], b["grad"]),
            **{f"gradient, {g}": rel(a["grad"], b["grad"], names) for g, names in b["groups"].items()}}


def phase8b_train_step(dev, tmp):
    """One train step of the full-width recipe (dropout 0, batch 4) on the CPU
    and on the card from the same weights, batch, t and noise, twice: in f32
    with TF32 off, where loss, grad_norm, the updated parameters and the
    gradient agree within 1e-3 relative L2; and with the recipe's bf16 torso
    (f32 parameters, bf16 activations, K1/K2/K3 in bf16 under autograd),
    held to ``TRAIN_BF16_TOL``, beside the control: the CPU's bf16 step
    against its f32 step."""
    import torch

    tf32_off()
    sd = random_state_dict(recipe_model(use_fp16=False)[1])
    x, cond = recipe_batch(4, seed=1)
    noise = torch.randn(4, 3, 128, 128, generator=torch.Generator().manual_seed(3))
    steps = {(fp16, d.type): train_step_on(d, sd, x, cond, noise, os.path.join(tmp, f"step_{fp16}_{d.type}"),
                                           use_fp16=fp16)
             for fp16 in (False, True) for d in (torch.device("cpu"), dev)}
    ref = steps[False, "cpu"]

    def show(errs):
        return ", ".join(f"{k} {v:.3g}" for k, v in errs.items())

    f32 = step_errors(steps[False, "cuda"], ref)
    log(f"  train step (4, 3, 128, 128) f32: loss {float(ref['met']['loss']):.6g}, grad_norm "
        f"{float(ref['met']['grad_norm']):.6g} (CPU); card vs CPU: {show(f32)} (bound 1e-3); CPU step {ref['secs']:.2f} s, card step {steps[False, 'cuda']['secs']:.2f} s (first, with set-up)")
    bad = {k: v for k, v in f32.items() if not v <= 1e-3}
    if bad or not float(ref["met"]["loss"]) > 0:
        raise AssertionError(f"card train step (f32) differs from the CPU's: {bad}")

    bf16 = step_errors(steps[True, "cuda"], steps[True, "cpu"])
    control = step_errors(steps[True, "cpu"], ref)
    log(f"  train step bf16 torso: card vs CPU (both bf16): {show(bf16)}; control, CPU bf16 vs CPU f32: "
        f"{show(control)}; bound {TRAIN_BF16_TOL}; CPU step {steps[True, 'cpu']['secs']:.2f} s, card step "
        f"{steps[True, 'cuda']['secs']:.2f} s")
    bad = {k: bf16[k] for k, tol in TRAIN_BF16_TOL.items() if not bf16[k] <= tol}
    if bad or not math.isfinite(float(steps[True, "cuda"]["met"]["loss"])):
        raise AssertionError(f"card train step (bf16 torso) differs from the CPU's: {bad}")


def phase8c_cli(dev, tmp):
    """``python -m guided_diffusion_clip_tpu_torch.image_train --config-file``
    on 64 generated 128 px PNGs and a .pt CLIP dict: configs/config.yaml with
    save_interval 10 and log_interval 5 and the paths pointed here, stopped by
    DIFFUSION_TRAINING_TEST=1 after the save at step 10; then resumed from
    model000010.pt for 2 more steps. The throughput of the entry point, its
    loader included, is the 5 steps between the log rows of steps 5 and 10
    (each row is printed after its step's metrics came back, so the card has
    finished that step), timed by the arrival of the rows on the child's
    stdout; ``progress.csv``'s ``wait_data`` and ``wait_step`` split them
    into the time the loop waited for the loader and the time in
    ``run_step``. The resume runs with ``--profile_dir``, whose trace must
    hold the ``train_step`` scope. Returns the first run's directory.

    ``GDC_NATIVE_LOADER=1`` is not run: ``native/gdc_loader.cpp`` compiles
    only where libjpeg's and libpng's headers are installed, which a card's
    host need not have; the CPU tests hold the native loader's batches to
    the Python loader's bit for bit."""
    import csv
    import math

    import numpy as np
    import torch
    import yaml
    from PIL import Image

    from guided_diffusion_clip_tpu_torch.utils.checkpoint import load_model_weights, load_state_dict

    root = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(tmp, "images")
    os.makedirs(data)
    rs = np.random.RandomState(4)
    clip = {}
    for i in range(64):
        name = f"{i:05d}.png"
        Image.fromarray(rs.randint(0, 256, (128, 128, 3), dtype=np.uint8)).save(os.path.join(data, name))
        clip[name] = torch.from_numpy(rs.standard_normal((2, 512)).astype(np.float32))
    clip_path = os.path.join(tmp, "clip_dict.pt")
    torch.save(clip, clip_path)
    with open(os.path.join(root, "configs", "config.yaml")) as f:
        cfg = yaml.safe_load(f)
    runs = os.path.join(tmp, "runs")
    cfg.update(save_interval=10, log_interval=5, data_dir=data, clip_file_path=clip_path, data_dir_test=data,
               clip_file_path_test=clip_path, main_path=runs)
    cfg_path = os.path.join(tmp, "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)

    def run(argv, env):
        """Run image_train: (seconds, {step: seconds from the start to its log row})."""
        env = {**{k: v for k, v in os.environ.items() if k not in ("DIFFUSION_TRAINING_TEST", "DIFFUSION_BLOB_LOGDIR")},
               "OPENAI_LOG_FORMAT": "stdout,log,csv", "PYTHONUNBUFFERED": "1", **env}
        rows, lines = {}, []
        t0 = time.perf_counter()
        with tempfile.TemporaryFile("w+") as err:
            proc = subprocess.Popen([sys.executable, "-m", "guided_diffusion_clip_tpu_torch.image_train",
                                     "--config-file", cfg_path, *argv], stdout=subprocess.PIPE, stderr=err,
                                    text=True, cwd=root, env=env)
            watchdog = threading.Timer(600, proc.kill)
            watchdog.start()
            try:
                for line in proc.stdout:
                    lines.append(line)
                    found = re.match(r"\| step +\| (\d+) ", line)
                    if found:
                        rows[int(found.group(1))] = time.perf_counter() - t0
                proc.wait()
            finally:
                watchdog.cancel()
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            if proc.returncode != 0:
                err.seek(0)
                raise AssertionError(f"image_train exited {proc.returncode}:\n{''.join(lines)[-3000:]}\n"
                                     f"{err.read()[-3000:]}")
        return time.perf_counter() - t0, rows

    secs, row_at = run([], {"DIFFUSION_TRAINING_TEST": "1"})
    (first,) = os.listdir(runs)
    run_dir = os.path.join(runs, first)
    files = set(os.listdir(run_dir))
    want = {"model000010.pt", "ema_0.9999_000010.pt", "opt000010.pt", "progress.csv", "log.txt",
            "val_samples_0_000010.png", "val_samples_1_000010.png"}
    if not want <= files:
        raise AssertionError(f"run directory {run_dir} lacks {sorted(want - files)}")
    with open(os.path.join(run_dir, "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows]
    if [int(r["step"]) for r in rows] != [0, 5, 10] or not all(math.isfinite(v) and v > 0 for v in losses):
        raise AssertionError(f"progress.csv: steps {[r['step'] for r in rows]}, losses {losses}")
    sampler = recipe_model()[1]
    load_model_weights(sampler, os.path.join(run_dir, "model000010.pt"))
    log(f"  image_train --config-file (batch 48, 128 px, save at step 10 with two 1000-step validation chains of 8): "
        f"{secs:.1f} s; {run_dir}: {', '.join(sorted(files))}; progress.csv losses {losses}; model000010.pt "
        f"loads strict=True into the sampler model (bf16 torso)")
    if sorted(row_at) != [0, 5, 10]:
        raise AssertionError(f"log rows on stdout for steps {sorted(row_at)}, want [0, 5, 10]")
    span = row_at[10] - row_at[5]
    wait_data, wait_step = float(rows[2]["wait_data"]), float(rows[2]["wait_step"])
    log(f"  image_train throughput, steps 6-10 (between the log rows of steps 5 and 10, loader included): "
        f"{1e3 * span / 5:.2f} ms a step, {5 * TRAIN_BATCH / span:.1f} samples/s; per step the loop waited "
        f"{1e3 * wait_data / 5:.2f} ms for the loader and spent {1e3 * wait_step / 5:.2f} ms in run_step "
        f"(progress.csv wait_data, wait_step)")

    # the resume, traced (--profile_dir: its steps 1 to 3, here the last of its 2)
    prof_dir = os.path.join(tmp, "profile")
    secs, _ = run(["--resume_checkpoint", os.path.join(run_dir, "model000010.pt"), "--lr_anneal_steps", "12",
                   "--profile_dir", prof_dir], {})
    (second,) = set(os.listdir(runs)) - {first}
    res_dir = os.path.join(runs, second)
    traces = [os.path.join(prof_dir, n) for n in os.listdir(prof_dir) if n.endswith(".pt.trace.json")]
    with open(traces[0]) as f:
        trace = f.read() if len(traces) == 1 else ""
    if '"train_step"' not in trace or '"data"' not in trace:
        raise AssertionError(f"--profile_dir {prof_dir}: {os.listdir(prof_dir)} holds no trace of a train step")
    log(f"  --profile_dir: {os.path.basename(traces[0])}, {len(trace) / 2**20:.1f} MiB, with the train_step and "
        f"data scopes")
    with open(os.path.join(res_dir, "log.txt")) as f:
        text = f.read()
    # step 0 is an update too: the save at step 10 follows 11 of them
    count10, count12 = (torch.load(os.path.join(d, n), map_location="cpu", weights_only=True)["count"]
                        for d, n in ((run_dir, "opt000010.pt"), (res_dir, "opt000012.pt")))
    e10, e12, m10 = (load_state_dict(os.path.join(d, n)) for d, n in (
        (run_dir, "ema_0.9999_000010.pt"), (res_dir, "ema_0.9999_000012.pt"), (run_dir, "model000010.pt")))
    moved = sum(float((e12[k] - e10[k]).double().norm() ** 2) for k in e10) ** 0.5
    apart = sum(float((m10[k] - e10[k]).double().norm() ** 2) for k in e10) ** 0.5
    if "(step 10)" not in text or "loading EMA from checkpoint" not in text or "loading optimizer state" not in text:
        raise AssertionError(f"the resumed run did not restore step 10, the EMA and the optimizer:\n{text[-2000:]}")
    if (count10, count12) != (11, 13) or not moved < 1e-2 * apart:
        raise AssertionError(f"Adam count {count10} at step 10 (want 11), {count12} after the resumed run's 2 steps "
                             f"(want 13); EMA moved {moved:.3g} against {apart:.3g} between the model and its EMA")
    log(f"  resumed from model000010.pt for 2 steps ({secs:.1f} s): resume_step 10, Adam count {count10} -> "
        f"{count12}, |EMA(12) - EMA(10)| {moved:.3g} against |model(10) - EMA(10)| {apart:.3g} (EMA restored)")
    return run_dir


def time_train_steps(dev, tmp, sd, x, cond, tag, **over) -> dict:
    """20 ``run_step`` calls of the recipe (``over`` on top) at batch 48 after 5
    of warm-up (and 2 under ``torch.cuda.set_sync_debug_mode("error")``: no
    step waits for the card), the kernels' launches of those 20 against
    ``train_counts`` (every K1/K2 launch on the tensor cores; under int8 every
    K5 launch but the stem's and the head's too), ms a step (median, CUDA
    events) and its split into forward, backward and optimizer + EMA,
    samples/s, peak memory and the profiler's device time by kernel group.
    Returns {"launches": the 20 steps' counts, "step_ms", "parts", "busy_ms",
    "peak_gib"}."""
    import torch

    loop = recipe_loop(dev, sd, TRAIN_BATCH, os.path.join(tmp, f"time_{tag}".replace(" ", "_")), **over)
    remat = bool(over.get("use_checkpoint"))
    for _ in range(5):
        loop.run_step(x, cond)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            loop.run_step(x, cond)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    steps = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loop.run_step(x, cond)
        end.record()
        end.synchronize()
        steps.append(start.elapsed_time(end))
    counts = counters()
    split = tensor_core_split(counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_step = train_counts(loop.model, remat)
    want = {k: 20 * v for k, v in per_step.items()}
    got = {k: counts[k] for k in want}
    if got != want or any(v for k, v in counts.items() if k not in want):
        raise AssertionError(f"{tag}: launches {counts} over 20 steps, want {want} and no other kernel")
    if split["attention_fma"] or split["attention_bwd_fma"]:
        raise AssertionError(f"{tag}: K1/K2 at d = 192 and 256 ran on the FMA pipes: {split}")
    if loop.model.int8:
        check_conv_tensor_core_launches(tag, 20 * dp4a_convs(loop.model))
    loop.flush_metrics()

    # forward, backward and optimizer + EMA of the same step, by events between them
    xb, cb = loop._upload(x).float(), {k: loop._upload(v) for k, v in cond.items()}
    parts = {"forward": [], "backward": [], "optimizer + EMA": []}
    for _ in range(20):
        t_np, w_np = loop.schedule_sampler.sample(TRAIN_BATCH, loop.np_rng)
        t, w = loop._upload(t_np).long(), loop._upload(w_np)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        loop.opt.zero_grad(set_to_none=True)
        ev[0].record()
        loss, _ = loop.micro_loss(xb, cb, t, w)
        ev[1].record()
        loss.backward()
        ev[2].record()
        loop.update()
        ev[3].record()
        ev[3].synchronize()
        for (k, lst), a, b in zip(parts.items(), ev, ev[1:]):
            lst.append(a.elapsed_time(b))
    med = {k: sorted(v)[len(v) // 2] for k, v in parts.items()}
    step_ms = sorted(steps)[len(steps) // 2]

    prof = _profile_kernels(lambda: loop.run_step(x, cond))
    loop.flush_metrics()
    busy = sum(ms for ms, _ in prof.values())
    groups: dict = {}
    for k, (ms, n) in prof.items():
        grp = groups.setdefault(_kernel_group(k), [0.0, 0.0])
        grp[0] += ms
        grp[1] += n
    log(f"  {tag}, batch {TRAIN_BATCH}, bf16 torso, f32 parameters, fused AdamW (either opt_impl): step {step_ms:.2f} ms "
        f"(median of 20, CUDA events; range {min(steps):.2f}-{max(steps):.2f}), {1e3 * TRAIN_BATCH / step_ms:.1f} "
        f"samples/s; forward {med['forward']:.2f}, backward {med['backward']:.2f}, optimizer + EMA "
        f"{med['optimizer + EMA']:.2f} ms; peak memory {peak:.2f} GiB")
    log(f"  {tag}: launches a step {per_step} (from the modules; 20 steps counted {got}); no host sync in 2 steps "
        f"under set_sync_debug_mode('error')")
    log(f"  {tag}, profiler: device busy {busy:.2f} ms of the {step_ms:.2f} ms step "
        f"({100 * busy / step_ms:.0f} %); " + "; ".join(
            f"{k} {ms:.2f} ms ({n:.0f})" for k, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    log(f"  {tag}, top kernels (ms, launches):")
    for k, (ms, n) in sorted(prof.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"    {ms:8.3f} x{n:<5.0f} {k[:110]}")
    del loop
    torch.cuda.empty_cache()
    return {"launches": split, "step_ms": step_ms, "parts": med, "busy_ms": busy, "peak_gib": peak}


def phase8d_time(dev, tmp):
    """The recipe at batch 48 in bf16, without and with ``use_checkpoint``
    (``time_train_steps``). Returns the launch counts of the timed steps."""
    import torch

    # torch's defaults, as image_train runs: no TF32 in matmuls, TF32 in cuDNN's f32 convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    sd = random_state_dict(recipe_model()[1])
    x, cond = recipe_batch(TRAIN_BATCH, seed=2)
    return {remat: time_train_steps(dev, tmp, sd, x, cond, "use_checkpoint" if remat else "plain backward",
                                    use_checkpoint=remat)
            for remat in (False, True)}


# The int8 step (the recipe's bf16 torso, the convs on the int8 path, straight-through convs in bf16 as
# shipped), card against CPU (both int8, teacher-forced), in relative L2 (step_errors). Readings on an H100
# (two calls): loss 1.2e-7, grad_norm 7.6e-6, updated params 4.8e-6, gradient 6.9e-5, attention qkv/norm
# 5.4e-3-5.8e-3, proj_out 4.4e-3-4.5e-3, GroupNorms 4.0e-5; free-running (not forced) 1.9e-6, 4.9e-5,
# 2.2e-5, 7.0e-4, 1.5e-2, 1.4e-2, 9.5e-4; the control, the CPU's bf16 int8 step against its f32 one:
# 2.2e-6, 2.5e-5, 5.2e-4, 1.0e-3, 1.2e-2, 1.1e-2, 1.4e-3. Faults injected on the card only gave: K5's
# prequantized outputs x 1.002, grad_norm 3.3e-5, gradient 1.7e-4, GroupNorms 1.5e-4; x 1.01 fails the
# forcing's own check (an int8_conv output 1.2e-2 off); K2's output x 1.01, qkv/norm 1.09e-2.
INT8_TRAIN_TOL = {"loss": 1e-5, "grad_norm": 2e-5, "updated params": 1e-5, "gradient": 1.2e-4,
                  "gradient, attention qkv, norm": 8e-3, "gradient, attention proj_out": 8e-3,
                  "gradient, GroupNorms": 1e-4}


def int8_step_pair(dev, sd, x, cond, noise, tmp, share=1e-4, **over) -> tuple:
    """One int8 ``run_step`` of the recipe on the CPU, then on the card
    teacher-forced to the CPU's roundings (``Int8Forcing`` with ``share``):
    (CPU step, card step, the forcing's summary), each as ``train_step_on``
    returns it."""
    import torch

    forcing = Int8Forcing(share)
    cpu = train_step_on(torch.device("cpu"), sd, x, cond, noise, os.path.join(tmp, "cpu"), forcing=forcing,
                        train_conv_impl="int8", **over)
    card = train_step_on(dev, sd, x, cond, noise, os.path.join(tmp, "card"), forcing=forcing,
                         train_conv_impl="int8", **over)
    return cpu, card, forcing.summary()


def phase8e_int8_train(dev, tmp) -> dict:
    """``--train_conv_impl int8``: one step of the full-width recipe (dropout
    0, batch 4) on the CPU and on the card, teacher-forced, twice: in f32
    (TF32 off, the straight-through convs in f32) within 1e-3 relative L2, as
    8b's f32 step; with the recipe's bf16 torso and the bf16 straight-through
    convs as shipped within ``INT8_TRAIN_TOL``. Then 20 timed int8 steps at
    batch 48 (``time_train_steps``). Returns the timed steps' record."""
    import torch

    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    tf32_off()
    sd = random_state_dict(recipe_model(use_fp16=False)[1])
    x, cond = recipe_batch(4, seed=5)
    noise = torch.randn(4, 3, 128, 128, generator=torch.Generator().manual_seed(6))

    def show(errs):
        return ", ".join(f"{k} {v:.3g}" for k, v in errs.items())

    try:
        Q._STE_DTYPE = torch.float32
        cpu, card, forced = int8_step_pair(dev, sd, x, cond, noise, os.path.join(tmp, "f32"), use_fp16=False)
    finally:
        Q._STE_DTYPE = torch.bfloat16
    f32 = step_errors(card, cpu)
    log(f"  int8 train step (4, 3, 128, 128) f32: loss {float(cpu['met']['loss']):.6g}, grad_norm "
        f"{float(cpu['met']['grad_norm']):.6g} (CPU); card vs CPU teacher-forced: {show(f32)} (bound 1e-3); "
        f"{forced}; CPU step {cpu['secs']:.2f} s")
    bad = {k: v for k, v in f32.items() if not v <= 1e-3}
    if bad or not float(cpu["met"]["loss"]) > 0:
        raise AssertionError(f"card int8 train step (f32) differs from the CPU's: {bad}")
    # bf16 activations: K1's bf16 output differs from the plain version's by bf16 roundings (phase 3's bound is
    # 2e-2 * max(1, |ref|)), and the blocks after an attention block see inputs an ulp (2^-8 relative) off in
    # many places, which moves a GroupNorm's q by a level wherever it lies at a rounding boundary: 1.1e-3 of
    # q at 8 px on an H100, against 5.8e-6 over the whole f32 step. Forcing replaces those levels;
    # the step's gradient is then held to INT8_TRAIN_TOL
    cpu, card, forced = int8_step_pair(dev, sd, x, cond, noise, os.path.join(tmp, "bf16"), share=1e-2, use_fp16=True)
    bf16 = step_errors(card, cpu)
    log(f"  int8 train step, bf16 torso and straight-through convs: card vs CPU teacher-forced: {show(bf16)}; "
        f"bound {INT8_TRAIN_TOL}; {forced}; CPU step {cpu['secs']:.2f} s")
    bad = {k: bf16[k] for k, tol in INT8_TRAIN_TOL.items() if not bf16[k] <= tol}
    if bad or not math.isfinite(float(card["met"]["loss"])):
        raise AssertionError(f"card int8 train step (bf16 torso) differs from the CPU's: {bad}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    sd = random_state_dict(recipe_model()[1])
    xb, condb = recipe_batch(TRAIN_BATCH, seed=2)
    return time_train_steps(dev, tmp, sd, xb, condb, "int8 (--train_conv_impl int8)", train_conv_impl="int8")


# ---------------------------------------------------------------------------
# Phase 9: sampling the trained recipe through the fork's CLIs
# (configs/image_sample_config.yaml: batch 8, 100 respaced steps)
# ---------------------------------------------------------------------------

SAMPLE_MODES = [  # (name, flags, the config's keys changed)
    ("bf16", [], {}),
    ("int8", ["--conv_impl", "int8"], {}),
    ("cfg 3, cfg_cache 2", ["--cfg_scale", "3", "--cfg_cache", "2"], {}),
    ("denoise_start_point 800", [], {"denoise_start_point": 800}),
]


def sample_test_set(tmp, n=16):
    """``n`` generated 256 px PNGs (the size of the config's CelebA-HQ test
    set; the loader halves them to 128) and their CLIP dict (.pt, one
    embedding a flip)."""
    import numpy as np
    import torch
    from PIL import Image

    data = os.path.join(tmp, "test_images")
    os.makedirs(data)
    rs = np.random.RandomState(11)
    clip = {}
    for i in range(n):
        name = f"{i:05d}.png"
        Image.fromarray(rs.randint(0, 256, (256, 256, 3), dtype=np.uint8)).save(os.path.join(data, name))
        clip[name] = torch.from_numpy(rs.standard_normal((2, 512)).astype(np.float32))
    clip_path = os.path.join(tmp, "test_clip_dict.pt")
    torch.save(clip, clip_path)
    return data, clip_path


def sample_config(tmp, name, run_dir, data, clip, **over) -> str:
    """configs/image_sample_config.yaml with its paths pointed at ``run_dir``'s
    EMA checkpoint (``main_path``, ``f``, ``load_file``) and the test set, 16
    samples, then ``over``; written to ``tmp`` (a config file's keys win over
    the command line's)."""
    import yaml

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "image_sample_config.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(main_path=os.path.dirname(run_dir), f=os.path.basename(run_dir), load_file="ema_0.9999_000010.pt",
               data_dir_test=data, clip_file_path_test=clip, num_samples=16)
    cfg.update(over)
    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def sampling_model(cfg_path, *flags):
    """(args, model, diffusion) as ``image_sample`` builds them from a config file and flags."""
    from guided_diffusion_clip_tpu_torch import image_sample
    from guided_diffusion_clip_tpu_torch.utils.script_util import (
        args_to_dict, create_model_and_diffusion, model_and_diffusion_defaults, parse_yaml,
    )

    args = parse_yaml(image_sample.create_argparser().parse_args(["--config-file", cfg_path, *flags]))
    return args, *create_model_and_diffusion(**args_to_dict(args, model_and_diffusion_defaults().keys()),
                                             conv_impl=args.conv_impl)


def check_samples(path, n) -> "np.ndarray":
    import numpy as np

    images = np.load(path)["arr_0"]
    if images.shape != (n, 128, 128, 3) or images.dtype != np.uint8:
        raise AssertionError(f"{path}: samples {images.shape} {images.dtype}, not ({n}, 128, 128, 3) uint8")
    if not all(images[i].std() > 0 for i in range(n)):
        raise AssertionError(f"{path}: a constant image among the samples")
    return images


# The checkpoint the modes below sample, written beside 8c's: N(0, 0.02) weights (random_state_dict). 8c's EMA of
# 11 steps at rate 0.9999 is the initialization, whose zero output convs make eps 0 whatever the kernels give
RANDOM_CKPT = "ema_random.pt"
# Short DDIM chains of image_sample.make_chain, card against CPU from the same x_T: (name, flags, the config's
# keys changed, batch, bound on the larger of the samples' and the UNet outputs' relative L2). f32 runs with TF32
# off; bf16 is the recipe's torso (K1, K3 on the card; the plain versions on the CPU); int8 is teacher-forced
# (Int8Forcing, 1e-2 of q may flip, as 8e's bf16 step), which holds K4, K5 and the quantize kernels at each call.
# Readings on an H100 (samples, UNet outputs): f32 2.6e-8, 3.8e-6; bf16 3.6e-6, 1.2e-3; int8 8.5e-7, 3.2e-4 (2.6e-5
# of q off by one, worst int8_conv 2.8e-3). Faults injected on the card only gave: bf16, K3's output x 1.01, UNet
# outputs 2.6e-3; K1's x 1.01, 1.2e-3 (the attention blocks' share of the output is below the bf16 torso's
# roundings with N(0, 0.02) weights: phase 3 holds K1 at these shapes); int8, K5's x 1.002 and K1's x 1.01 fail
# the forcing's own check (an int8_conv output 8.4e-3 and 6.4e-3 off).
SAMPLE_CHAINS = [
    ("f32", [], {"use_fp16": False}, 2, 1e-3),
    ("bf16", [], {}, 8, 2e-3),
    ("int8", ["--conv_impl", "int8"], {}, 8, 1e-3),
]


def chain_card_vs_cpu(dev, tmp, run_dir, data, clip, sd, name, flags, over, batch) -> tuple:
    """A 5-step DDIM chain of ``image_sample.make_chain`` from ``sd`` on the
    CPU, then on the card from the same x_T, img2 and conditioning
    (teacher-forced under int8): (the larger of the samples' relative L2 and
    the UNet outputs' worst, |ref|, a line to log)."""
    import torch

    from guided_diffusion_clip_tpu_torch import image_sample

    # 5 of 50 DDIM steps from img2 noised to t = 100 (--denoise_start_point 100): a chain from t = 999 clips
    # every value of x_0 to -1 or 1 at its first step, and its samples are signs that hardly follow eps
    cfg = sample_config(tmp, f"ddim5_{name}", run_dir, data, clip, use_ddim=True, timestep_respacing=50,
                        denoise_start_point=100, **over)
    args, model, diffusion = sampling_model(cfg, *flags)
    model.load_state_dict(sd, strict=True)
    model.eval().requires_grad_(False)
    shape = (batch, 3, model.config.image_size, model.config.image_size)
    g = torch.Generator().manual_seed(12)
    x_T = torch.randn(shape, generator=g)
    kw = {"clip_feat": torch.randn(batch, 512, generator=g), "img2": torch.rand(shape, generator=g) * 2 - 1}
    int8 = args.conv_impl == "int8"
    forcing = Int8Forcing(1e-2)
    outs, unet_outs, secs = [], ([], []), []
    for i, d in enumerate((torch.device("cpu"), dev)):
        model.to(d)
        run_chain = image_sample.make_chain(model, diffusion, args)
        hooks = (forcing.force if i else forcing.record)(model) if int8 else contextlib.nullcontext()
        keep = model.register_forward_hook(lambda m, a, o, i=i: unet_outs[i].append(o.float().cpu()))
        t0 = time.perf_counter()
        with torch.inference_mode(), hooks:
            outs.append(run_chain(batch, {k: v.to(d) for k, v in kw.items()}, None, kw["img2"].to(d),
                                  noise=x_T.to(d)).float().cpu())
        secs.append(time.perf_counter() - t0)
        keep.remove()
    del model
    ref, out = outs
    if not torch.isfinite(out).all() or out.shape != ref.shape or len(unet_outs[0]) != len(unet_outs[1]):
        raise AssertionError(f"the card's 5-step DDIM chain ({name}): {tuple(out.shape)}, finite: "
                             f"{bool(torch.isfinite(out).all())}, {len(unet_outs[1])} forwards")
    rel = ((out - ref).norm() / ref.norm()).item()
    # the UNet's outputs along the chain: the samples follow eps by sqrt(1 - alpha_bar) <= 0.2 at t <= 100
    rel_unet = max(((o - r).norm() / r.norm()).item() for r, o in zip(*unet_outs))
    line = (f"{shape} {name}: card vs CPU from the same x_T{', teacher-forced' if int8 else ''}: samples' rel L2 "
            f"{rel:.3g} (|ref| {ref.norm().item():.4g}), the UNet's outputs' worst rel L2 {rel_unet:.3g} over "
            f"{len(unet_outs[0])} forwards; CPU {secs[0]:.2f} s, card {secs[1]:.2f} s"
            f"{'; ' + forcing.summary() if int8 else ''}")
    return max(rel, rel_unet), ref.norm().item(), line


def phase9_image_sample(dev, tmp, run_dir) -> list:
    """``image_sample.main`` on 16 generated test images (two batches of 8,
    100 respaced ancestral steps) from ``RANDOM_CKPT``, written into 8c's run
    directory, in each of ``SAMPLE_MODES``: the UNet's forwards against the
    schedule, the kernels' launches against the modules' counts times those
    forwards (every K1 on the tensor cores; under int8 every K5 but the stem's
    and the head's), seconds a batch (CUDA events), the PNGs and the uint8
    npz, each mode's samples other than bf16's. Then ``SAMPLE_CHAINS``: short
    DDIM chains card against CPU. Returns each mode's launch counts."""
    import numpy as np
    import torch

    from guided_diffusion_clip_tpu_torch import image_sample
    from guided_diffusion_clip_tpu_torch.utils import logger

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    data, clip = sample_test_set(tmp)
    sd = random_state_dict(recipe_model(use_fp16=False)[1])
    torch.save(sd, os.path.join(run_dir, RANDOM_CKPT))
    runs, images = [], {}
    for name, flags, over in SAMPLE_MODES:
        cfg = sample_config(tmp, name.replace(" ", "_"), run_dir, data, clip, load_file=RANDOM_CKPT, **over)
        args, model, diffusion = sampling_model(cfg, *flags)
        int8 = args.conv_impl == "int8"
        steps = diffusion.num_timesteps if args.denoise_start_point == -1 else round(
            args.denoise_start_point * diffusion.num_timesteps / 1000)
        cfg_cache = args.cfg_scale > 0 and args.cfg_cache > 1
        # CFG with its cache: the conditional half every step, the unconditional one every other step
        forwards = 2 * (steps + -(-steps // 2) if cfg_cache else steps)
        per = unet_counts(model, int8)
        reset_counters()  # the main path starts here
        t0 = time.perf_counter()
        out = image_sample.main(["--config-file", cfg, "--device", dev.type, "-d", name.replace(" ", "_"), *flags])
        wall = time.perf_counter() - t0
        launches = counters()
        logger.reset()
        run = os.path.dirname(out["path"])
        images[name] = check_samples(out["path"], 16)
        pngs = {"samples_test0.png", "samples_test1.png", "target_0.png", "target_1.png"}
        if not pngs <= set(os.listdir(run)):
            raise AssertionError(f"{run} lacks {sorted(pngs - set(os.listdir(run)))}")
        if out["calls"] != {"unet_full": forwards, "unet_shallow": 0} or out["steps"] != steps:
            raise AssertionError(f"image_sample {name}: {out['calls']} forwards over {out['steps']} steps, want "
                                 f"{forwards} over {steps}")
        want = {**dict.fromkeys(launches, 0), **{k: forwards * v for k, v in per.items()}}
        log(f"  image_sample {name}: 2 batches of 8, {steps} steps, {forwards} UNet forwards; kernel launches "
            f"{launches} (expected {want}: per forward {per})")
        if launches != want:
            raise AssertionError(f"image_sample {name}: launch counts {launches} != {want}")
        check_tensor_core_launches(f"image_sample {name}")
        if int8:
            check_conv_tensor_core_launches(f"image_sample {name}", forwards * dp4a_convs(model))
        secs = out["batch_seconds"]
        log(f"  image_sample {name}: seconds a batch {', '.join(f'{v:.3f}' for v in secs)} (CUDA events; the "
            f"second overlaps the first's host work), {1e3 * secs[-1] / steps:.2f} ms a step; main() "
            f"{wall:.1f} s with the model's building and loading; {run}")
        runs.append(tensor_core_split(launches))
        del model
    base = images["bf16"].astype(np.float64)
    for name, imgs in images.items():
        sd_ = imgs.astype(np.float64).std()
        diff = np.abs(imgs.astype(np.float64) - base).mean()
        log(f"  samples' std: {name} {sd_:.3f} (bound: within 0.5 relative of bf16's); mean |uint8 diff| against "
            f"bf16 {diff:.3f} (bound: > 0 but for bf16)")
        if not abs(sd_ - base.std()) <= 0.5 * base.std():
            raise AssertionError(f"image_sample {name}: samples' std {sd_:.3f} not within 0.5 of bf16's {base.std():.3f}")
        if name != "bf16" and not diff > 0:
            raise AssertionError(f"image_sample {name}: the same samples as bf16's")

    tf32_off()
    for name, flags, over, batch, bound in SAMPLE_CHAINS:
        rel, norm, line = chain_card_vs_cpu(dev, tmp, run_dir, data, clip, sd, name, flags, over, batch)
        log(f"  5-step DDIM chain {line} (bound {bound})")
        if not norm > 0 or not rel <= bound:
            raise AssertionError(f"the card's 5-step DDIM chain ({name}) differs from the CPU's: rel L2 {rel:.3g}")
    return runs


def phase9b_repeat(dev, tmp, run_dir) -> dict:
    """``image_sample_repeat.main --repeats 2`` (8 samples each, seeds 0 and
    1): two run directories with ``_rep0`` and ``_rep1``, different samples,
    and the launches of 200 forwards. Returns the launch counts."""
    import numpy as np

    from guided_diffusion_clip_tpu_torch import image_sample_repeat

    data, clip = os.path.join(tmp, "test_images"), os.path.join(tmp, "test_clip_dict.pt")
    cfg = sample_config(tmp, "repeat", run_dir, data, clip, num_samples=8, sub_dir_tstsave="repeats")
    _, model, diffusion = sampling_model(cfg)
    reset_counters()
    t0 = time.perf_counter()
    outs = image_sample_repeat.main(["--config-file", cfg, "--device", dev.type, "--repeats", "2", "-d", "rep"])
    wall = time.perf_counter() - t0
    launches = counters()
    dirs = sorted(os.path.basename(os.path.dirname(o["path"])) for o in outs)
    a, b = (check_samples(o["path"], 8) for o in outs)
    forwards = 2 * diffusion.num_timesteps
    want = {**dict.fromkeys(launches, 0), **{k: forwards * v for k, v in unet_counts(model, False).items()}}
    log(f"  image_sample_repeat --repeats 2: {dirs}, {wall:.1f} s; {np.mean(a != b) * 100:.1f} % of the values "
        f"differ between the seeds; launches {launches} (expected {want})")
    if len(dirs) != 2 or not (dirs[0].endswith("_rep_rep0") and dirs[1].endswith("_rep_rep1")) or np.array_equal(a, b):
        raise AssertionError(f"image_sample_repeat: run directories {dirs}, samples equal: {np.array_equal(a, b)}")
    if launches != want:
        raise AssertionError(f"image_sample_repeat: launch counts {launches} != {want}")
    check_tensor_core_launches("image_sample_repeat")
    return tensor_core_split(launches)


def phase9c_nll(dev, tmp, run_dir) -> dict:
    """``image_nll.main`` on the 8 first test images (batch 8) with the recipe's
    model and its 1000-step cosine schedule: ``calc_bpd_loop``'s 1000 UNet
    forwards, the kernels' launches against them, a finite positive bpd and
    the three (1000,) term files. Returns the launch counts."""
    import numpy as np

    from guided_diffusion_clip_tpu_torch import image_nll
    from guided_diffusion_clip_tpu_torch.utils import logger

    data, clip = os.path.join(tmp, "test_images"), os.path.join(tmp, "test_clip_dict.pt")
    model = recipe_model()[1]
    argv = ["--image_size", "128", "--num_channels", "64", "--num_res_blocks", "2", "--learn_sigma", "True",
            "--class_cond", "True", "--num_heads", "1", "--use_fp16", "True", "--noise_schedule", "cosine",
            "--diffusion_steps", "1000", "--model_path", os.path.join(run_dir, "ema_0.9999_000010.pt"),
            "--data_dir", data, "--clip_file_path", clip, "--batch_size", "8", "--num_samples", "8",
            "--main_path", os.path.join(tmp, "nll"), "--device", dev.type]
    reset_counters()
    t0 = time.perf_counter()
    out = image_nll.main(argv)
    wall = time.perf_counter() - t0
    launches = counters()
    run = logger.get_dir()
    logger.reset()
    want = {**dict.fromkeys(launches, 0), **{k: 1000 * v for k, v in unet_counts(model, False).items()}}
    terms = {n: np.load(os.path.join(run, f"{n}_terms.npz"))["arr_0"] for n in ("vb", "mse", "xstart_mse")}
    log(f"  image_nll on 8 images: bpd {out['bpd']}, {wall:.1f} s with the model's building ({wall:.2f} ms a "
        f"forward of batch 8); launches {launches} (expected {want}); terms {', '.join(f'{k} {v.shape}' for k, v in terms.items())}")
    if out["samples"] != 8 or not all(math.isfinite(b) and b > 0 for b in out["bpd"]):
        raise AssertionError(f"image_nll: {out['samples']} samples, bpd {out['bpd']}")
    if any(v.shape != (1000,) or not np.isfinite(v).all() for v in terms.values()):
        raise AssertionError(f"image_nll terms: {[(k, v.shape) for k, v in terms.items()]}")
    if launches != want:
        raise AssertionError(f"image_nll: launch counts {launches} != {want}")
    check_tensor_core_launches("image_nll")
    return tensor_core_split(launches)


def check_ptxas(build_log: str) -> None:
    """Print ptxas's registers and spills by kernel; raise on a spill in a kernel the main paths launch."""
    # the kernel ptxas is reporting on: a tensor-core attention kernel as name<d> (K1's as name<d, warps>),
    # any other by its (mangled) name; a spill fails the run in the former at d = 64 (the sampling paths),
    # 192 and 256 (training) and in a kernel of the convs', the quantizer's and the GroupNorms' sources,
    # which were built without any
    entry, on_path = "", False
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"(attention_[a-z_]+_kernel)I((?:Li\d+E)+)E", line)
            mangled = re.search(r"Compiling entry function '(\w+)'", line)
            args = re.findall(r"\d+", found.group(2)) if found else []
            entry = f"{found.group(1)}<{', '.join(args)}>" if found else mangled.group(1) if mangled else ""
            on_path = bool(args) and args[0] in ("64", "192", "256")
            found = re.search(r"\d+(conv_s8_mma_kernel|conv_s8_finish_kernel|conv_fused_mma_kernel|absmax_kernel|"
                              r"quantize_kernel|gn_fused_kernel)(\w*)'", line)
            if found:
                entry, on_path = found.group(1) + found.group(2), True
        spills = "spill stores" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill")
        if "registers" in line or spills:
            log(f"  ptxas: {line.strip()}" + (f" ({entry})" if entry else ""))
        if spills and on_path:
            raise AssertionError(f"{entry}, a kernel the main paths launch and that was built without spills, "
                                 f"spills: {line.strip()}")


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
    check_ptxas(build.build_log)

    log("phase 3: kernels vs plain versions on the card")
    records = phase3_kernels(dev)
    log("phase 3b: K2 (attention backward) vs its plain version on the card")
    records.update(phase3b_attention_bwd(dev))
    log("phase 3c: K4 (quantizing GroupNorm) vs its plain version on the card")
    records["group_norm_quant"] = phase3c_group_norm_quant(dev)
    log("phase 3d: K5 (s8 conv) vs its plain version, the __dp4a kernel and cuDNN's bf16 conv on the card")
    records["conv_s8"] = phase3d_conv_s8(dev)
    log("phase 3e: K6 (fused quantizing conv) vs its plain version and cuDNN's bf16 conv on the card")
    records["conv_fused"] = phase3e_fused_conv(dev)
    log("phase 3f: K7 (tensor-core probe) vs its plain version on the card")
    records["mma_probe"] = phase3f_mma_probe(dev)
    log("phase 3g: int8_conv's quantize kernels vs quantize_per_tensor on the card")
    records["quantize"] = phase3g_quantize(dev)

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
    log("phase 4e: full-width DeepCache forwards (full, shallow), card vs CPU")
    phase4e_deep_cache(dev, sd)

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
        log("phase 5c: the slice served with --cfg_scale 2.0 --cfg_cache 2 --sampler dpm++2m")
        runs.append(phase5c_serve_cfg(dev, ckpt))
        os.remove(ckpt)
        log("phase 6: classifier-guided sampling, ADM-G 256 + classifier")
        launches, paths, bf16_images, bf16_chain = phase6_guided(dev, tmp)
        runs.append(launches)
        log("phase 6, profile: one guided step at batch 8")
        bf16_step = profile_guided_step(dev, paths)
        log("phase 6b: classifier-guided sampling with --conv_impl int8")
        launches, _, int8_images, int8_chain = phase6_guided(dev, tmp, "int8", paths)
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
        log("phase 6c: classifier-guided sampling with the deploy preset's knobs")
        launches, preset_images, preset_chain = phase6c_preset(dev, tmp, paths)
        runs.append(launches)
        sd_preset = preset_images.astype(np.float64).std()
        diff = np.abs(preset_images.astype(np.int64) - int8_images.astype(np.int64))
        log(f"  samples' std: preset {sd_preset:.3f}, plain int8 {sd_int8:.3f} (bound: within 0.5 relative); "
            f"preset vs plain int8 (same seeds and weights): mean |uint8 diff| {diff.mean():.3f}, "
            f"{100 * (diff > 0).mean():.2f} % of values differ")
        if not abs(sd_preset - sd_int8) <= 0.5 * sd_int8:
            raise AssertionError(f"preset samples' std {sd_preset:.3f} not within 0.5 of plain int8's {sd_int8:.3f}")
        log(f"  250-step chains at batch 8, this run: preset {preset_chain:.3f} s ({480 / preset_chain:.3f} "
            f"samples/min, {4 * preset_chain:.2f} ms a step), plain int8 {int8_chain:.3f} s "
            f"({480 / int8_chain:.3f} samples/min, {4 * int8_chain:.2f} ms a step), bf16 {bf16_chain:.3f} s "
            f"({480 / bf16_chain:.3f} samples/min, {4 * bf16_chain:.2f} ms a step)")

    log("phase 7: the tool entry points (conv_bench, mxu_ceiling)")
    runs.append(phase7_tools())

    t8 = time.perf_counter()
    log("phase 8a: K1 and K2 at the training recipe's shapes (batch 48, one head, d = 192 and 256)")
    phase8a_attention(dev)
    with tempfile.TemporaryDirectory() as tmp:
        log("phase 8b: one train step of the full-width recipe, card vs CPU")
        phase8b_train_step(dev, tmp)
        log("phase 8c: python -m guided_diffusion_clip_tpu_torch.image_train --config-file, then a resume with "
            "--profile_dir")
        run_dir = phase8c_cli(dev, tmp)
        log("phase 8d: train steps of the recipe at batch 48, without and with use_checkpoint")
        timed = phase8d_time(dev, tmp)
        runs.extend(t["launches"] for t in timed.values())
        log("phase 8e: --train_conv_impl int8: one step card vs CPU, then train steps at batch 48")
        int8_timed = phase8e_int8_train(dev, tmp)
        runs.append(int8_timed["launches"])
        log(f"  train step at batch {TRAIN_BATCH}, this run: int8 {int8_timed['step_ms']:.2f} ms (busy "
            f"{int8_timed['busy_ms']:.2f}), bf16 {timed[False]['step_ms']:.2f} ms (busy {timed[False]['busy_ms']:.2f})")
        log(f"  phase 8 took {time.perf_counter() - t8:.1f} s")
        t9 = time.perf_counter()
        log("phase 9: python -m guided_diffusion_clip_tpu_torch.image_sample from random weights in 8c's run directory")
        runs.extend(phase9_image_sample(dev, tmp, run_dir))
        log("phase 9b: image_sample_repeat --repeats 2")
        runs.append(phase9b_repeat(dev, tmp, run_dir))
        log("phase 9c: image_nll on 8 images")
        runs.append(phase9c_nll(dev, tmp, run_dir))
        log(f"  phase 9 took {time.perf_counter() - t9:.1f} s")

    # K1 and K2 run on two kernels each: the tensor-core ones (bf16: the sampling paths at d = 64, training at
    # d = 192 and 256) and the FMA-pipe ones (f32: the classifier's attention pool)
    for run in runs:
        run["attention"] -= run["attention_fma"]
        run["attention_bwd"] -= run["attention_bwd_fma"]
    kernels = []
    for name, src, replaces in (
        ("attention", "guided_diffusion_clip_tpu_torch/ops/csrc/attention_fwd_mma.cu",
         "guided_diffusion_clip_tpu/ops/pallas_attention.py:27"),
        ("attention_fma", "guided_diffusion_clip_tpu_torch/ops/csrc/attention_fwd.cu",
         "guided_diffusion_clip_tpu/ops/pallas_attention.py:27"),
        ("attention_bwd", "guided_diffusion_clip_tpu_torch/ops/csrc/attention_bwd_mma.cu",
         "guided_diffusion_clip_tpu/ops/pallas_attention.py:46"),
        ("attention_bwd_fma", "guided_diffusion_clip_tpu_torch/ops/csrc/attention_bwd.cu",
         "guided_diffusion_clip_tpu/ops/pallas_attention.py:46"),
        ("group_norm", "guided_diffusion_clip_tpu_torch/ops/csrc/groupnorm.cu",
         "guided_diffusion_clip_tpu/ops/pallas_groupnorm.py:29"),
        ("group_norm_quant", "guided_diffusion_clip_tpu_torch/ops/csrc/groupnorm.cu",
         "guided_diffusion_clip_tpu/ops/pallas_groupnorm.py:50"),
        ("conv_s8", "guided_diffusion_clip_tpu_torch/ops/csrc/conv_s8_mma.cu",
         "guided_diffusion_clip_tpu/ops/pallas_conv.py:258"),
        # no TPU kernel: XLA fuses this pass of the JAX package's quantize_per_tensor
        ("quantize", "guided_diffusion_clip_tpu_torch/ops/csrc/quantize.cu",
         "guided_diffusion_clip_tpu/ops/quant.py:34"),
        ("conv_fused", "guided_diffusion_clip_tpu_torch/ops/csrc/conv_fused.cu",
         "guided_diffusion_clip_tpu/ops/pallas_conv.py:71"),
        ("mma_probe", "guided_diffusion_clip_tpu_torch/ops/csrc/mma_probe.cu",
         "tools/pallas_mxu_ceiling.py:39"),
    ):
        launched = sum(run[name] for run in runs)
        if launched == 0:
            raise AssertionError(f"kernel {name} was never launched by a main path")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launched, **records[name],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
