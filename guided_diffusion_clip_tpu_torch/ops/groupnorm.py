"""Fused GroupNorm32 (+ adaGN scale-shift) (+ SiLU).

Counterpart of ``guided_diffusion_clip_tpu/ops/pallas_groupnorm.py``, in the
same layout at the public surface: x is ``(B, *spatial, C)`` with channels
last, scale/bias are ``(C,)``, scale_shift is None or ``((B, C), (B, C))``.
Statistics are f32 with the one-pass variance E[x^2] - mean^2 of the TPU
kernel and of ``_gn_reference`` (not ``torch.nn.functional.group_norm``'s
formula); the output has x's dtype.

``group_norm`` dispatches on the tensor's device: a CPU tensor goes to the
plain PyTorch version ``group_norm_plain``; a CUDA tensor goes to the
hand-written kernel K3 (``csrc/groupnorm.cu``), or raises. Every GroupNorm on
the card goes through the kernel, whatever the map size.

Kernel K3 replaces ``guided_diffusion_clip_tpu/ops/pallas_groupnorm.py::
fused_group_norm`` (``_stats_kernel`` + the (B, C) glue + ``_apply_kernel``).
On the H100 the stats and apply passes are bandwidth-bound and, at small
maps, launch-bound: the stats pass splits HW over blocks and writes per-split
partial sums (no float atomics), a finalize kernel sums them in a fixed order
and folds the affine, and the apply pass reads x once and writes y once, 16
bytes per thread.
"""

from __future__ import annotations

import torch

from . import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TARGET_BLOCKS = 1024  # stats/apply blocks to aim for: several waves of the 132 SMs


def group_norm_plain(x, scale, bias, groups: int, eps: float, silu: bool, scale_shift):
    """Plain PyTorch version of K3, mirroring ``_gn_reference``."""
    orig_dtype = x.dtype
    B, C = x.shape[0], x.shape[-1]
    xf = x.float()
    spatial = xf.shape[1:-1]
    xg = xf.reshape(B, *spatial, groups, C // groups)
    axes = tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,)
    n = 1
    for a in axes:
        n *= xg.shape[a]
    s1 = xg.sum(dim=axes, keepdim=True)
    s2 = (xg * xg).sum(dim=axes, keepdim=True)
    mean = s1 / n
    var = s2 / n - mean * mean
    xg = (xg - mean) * torch.rsqrt(var + eps)
    y = xg.reshape(xf.shape) * scale.float() + bias.float()
    if scale_shift is not None:
        ss, sb = scale_shift
        bshape = (B,) + (1,) * len(spatial) + (C,)
        y = y * (1.0 + ss.float().reshape(bshape)) + sb.float().reshape(bshape)
    if silu:
        y = torch.nn.functional.silu(y)
    return y.to(orig_dtype)


def _splits(B: int, hw: int, C: int, vec: int) -> int:
    """HW splits per (batch, channel tile of 32 vectors): enough blocks to fill
    the card, at most one per 64 rows. A function of the shape only, so the
    partial-sum order (and the result) is the same from run to run."""
    cblocks = -(-C // (32 * vec))
    return max(1, min(-(-hw // 64), -(-_TARGET_BLOCKS // (cblocks * B))))


def _vec(x: torch.Tensor, C: int) -> int:
    """Channels per thread: 16 bytes' worth when C and the pointer allow."""
    wide = 16 // x.element_size()
    return wide if C % wide == 0 and x.data_ptr() % 16 == 0 else 1


def fused_group_norm(x, scale, bias, groups: int, eps: float, silu: bool, scale_shift):
    """Kernel K3 on a CUDA tensor x (B, *spatial, C), contiguous; raises on
    what it does not take. Stats, the (B, C) affine folding and the apply are
    three launches of ``csrc/groupnorm.cu``."""
    inputs = (x, scale, bias, *(scale_shift or ()))
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError("group_norm backward: not ported")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"group_norm kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm kernel needs x contiguous in (B, *spatial, C) order")
    B, C = x.shape[0], x.shape[-1]
    hw = x.numel() // (B * C)
    vec = _vec(x, C)
    splits = _splits(B, hw, C, vec)
    lib = build.load()
    dev = x.device
    gamma = scale.to(device=dev, dtype=torch.float32).contiguous()
    beta = bias.to(device=dev, dtype=torch.float32).contiguous()
    ss = sb = None
    if scale_shift is not None:
        ss, sb = (t.to(device=dev, dtype=torch.float32).reshape(B, C).contiguous() for t in scale_shift)
    partial = torch.empty((2, B, splits, C), dtype=torch.float32, device=dev)
    affine = torch.empty((2, B, C), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    rc = lib.gdc_group_norm(
        x.data_ptr(), partial[0].data_ptr(), partial[1].data_ptr(),
        gamma.data_ptr(), beta.data_ptr(),
        None if ss is None else ss.data_ptr(), None if sb is None else sb.data_ptr(),
        affine[0].data_ptr(), affine[1].data_ptr(), y.data_ptr(),
        B, hw, C, groups, eps, int(silu), splits, vec, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(rc, "gdc_group_norm")
    fused_group_norm.launches += 1
    return y


fused_group_norm.launches = 0


def group_norm(x, scale, bias, *, groups: int = 32, eps: float = 1e-5, silu: bool = False, scale_shift=None):
    """Dispatching entry point: plain on CPU, K3 on CUDA.

    The JAX signature minus its int8 arguments and its ``impl`` switch: the
    device decides, so no setting sends a CUDA tensor to the plain version.
    """
    if x.shape[-1] % groups:
        raise ValueError(f"channels {x.shape[-1]} not divisible by {groups} groups")
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, groups, eps, silu, scale_shift)
    if x.device.type == "cuda":
        return fused_group_norm(x, scale, bias, groups, eps, silu, scale_shift)
    raise ValueError(f"group_norm: no implementation for device {x.device}")
