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
the card goes through the kernel, whatever the map size. Inputs that require
grad go through ``GroupNormFunction``: K3 (or the plain version) forward,
which also gives each group's mean and rstd, and the closed-form
``group_norm_bwd`` backward in PyTorch ops, the counterpart of the JAX
package's ``_fused_gn_bwd`` (the VJP of the XLA composite ``_gn_reference``,
not a Pallas kernel).

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
from torch.autograd.function import once_differentiable

from . import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TARGET_BLOCKS = 1024  # stats/apply blocks to aim for: several waves of the 132 SMs


def group_norm_plain(x, scale, bias, groups: int, eps: float, silu: bool, scale_shift):
    """Plain PyTorch version of K3, mirroring ``_gn_reference``."""
    return _group_norm_plain_stats(x, scale, bias, groups, eps, silu, scale_shift)[0]


def _group_norm_plain_stats(x, scale, bias, groups, eps, silu, scale_shift):
    """``group_norm_plain``'s output and the (2, B, G) f32 mean and rstd."""
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
    rstd = torch.rsqrt(var + eps)
    xg = (xg - mean) * rstd
    y = xg.reshape(xf.shape) * scale.float() + bias.float()
    if scale_shift is not None:
        ss, sb = scale_shift
        bshape = (B,) + (1,) * len(spatial) + (C,)
        y = y * (1.0 + ss.float().reshape(bshape)) + sb.float().reshape(bshape)
    if silu:
        y = torch.nn.functional.silu(y)
    return y.to(orig_dtype), torch.stack([mean.reshape(B, groups), rstd.reshape(B, groups)])


def group_norm_bwd(x, dy, mean, rstd, scale, bias, groups: int, silu: bool, scale_shift,
                   needs=(True, True, True, True, True)):
    """Closed-form VJP of ``group_norm`` at x, from the cotangent dy and each
    group's f32 ``mean`` and ``rstd`` (B, G), computed in f32.

    With xhat = (x - mean) * rstd, z = xhat * scale + bias, u = z * (1 + ss) + sb
    (u = z without scale-shift) and y = silu(u) (or u):
    du = dy * silu'(u); dss = sum_hw du * z; dsb = sum_hw du; dz = du * (1 + ss);
    dscale = sum_{b,hw} dz * xhat; dbias = sum_{b,hw} dz;
    dx = rstd * (g - mean_grp(g) - xhat * mean_grp(g * xhat)), g = dz * scale.
    It is the gradient of the one-pass variance of ``_gn_reference`` too:
    E[x^2] - mean^2 and E[(x - mean)^2] are the same function of x.

    ``needs`` flags (dx, dscale, dbias, dss, dsb); returns the five, None
    where not needed. dx has x's dtype and shape; dss and dsb are (B, C).
    """
    B, C = x.shape[0], x.shape[-1]
    cg = C // groups
    xg = x.float().reshape(B, -1, groups, cg)
    xhat = ((xg - mean.reshape(B, 1, groups, 1)) * rstd.reshape(B, 1, groups, 1)).reshape(B, -1, C)
    g = dy.float().reshape(B, -1, C)
    z = xhat * scale.float() + bias.float()
    k = None
    if scale_shift is not None:
        ss, sb = scale_shift
        k = 1.0 + ss.float().reshape(B, 1, C)
    if silu:
        u = z if k is None else z * k + sb.float().reshape(B, 1, C)
        sig = torch.sigmoid(u)
        g = g * (sig * (1.0 + u * (1.0 - sig)))
    dss = (g * z).sum(1) if k is not None and needs[3] else None
    dsb = g.sum(1) if k is not None and needs[4] else None
    if k is not None:
        g = g * k
    dscale = (g * xhat).sum((0, 1)) if needs[1] else None
    dbias = g.sum((0, 1)) if needs[2] else None
    dx = None
    if needs[0]:
        gx = (g * scale.float()).reshape(B, -1, groups, cg)
        xh = xhat.reshape(B, -1, groups, cg)
        m1 = gx.mean(dim=(1, 3), keepdim=True)
        m2 = (gx * xh).mean(dim=(1, 3), keepdim=True)
        dx = ((gx - m1 - xh * m2) * rstd.reshape(B, 1, groups, 1)).reshape(x.shape).to(x.dtype)
    return dx, dscale, dbias, dss, dsb


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
    three launches of ``csrc/groupnorm.cu``.

    It records no backward: inputs that require grad go through
    ``group_norm``, which wraps K3 in ``GroupNormFunction``.
    """
    return _fused_group_norm_stats(x, scale, bias, groups, eps, silu, scale_shift)[0]


def _fused_group_norm_stats(x, scale, bias, groups, eps, silu, scale_shift):
    """K3's output and the (2, B, G) f32 mean and rstd its finalize pass wrote."""
    inputs = (x, scale, bias, *(scale_shift or ()))
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError("fused_group_norm records no backward; call group_norm()")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"group_norm kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm kernel needs x contiguous in (B, *spatial, C) order")
    if x.device.type != "cuda":
        raise ValueError(f"group_norm kernel needs a CUDA tensor, got one on {x.device}")
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
    stats = torch.empty((2, B, groups), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    rc = lib.gdc_group_norm(
        x.data_ptr(), partial[0].data_ptr(), partial[1].data_ptr(),
        gamma.data_ptr(), beta.data_ptr(),
        None if ss is None else ss.data_ptr(), None if sb is None else sb.data_ptr(),
        affine[0].data_ptr(), affine[1].data_ptr(), stats.data_ptr(), y.data_ptr(),
        B, hw, C, groups, eps, int(silu), splits, vec, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(rc, "gdc_group_norm")
    fused_group_norm.launches += 1
    return y, stats


fused_group_norm.launches = 0


def _group_norm_stats(x, scale, bias, groups, eps, silu, scale_shift):
    if x.device.type == "cpu":
        return _group_norm_plain_stats(x, scale, bias, groups, eps, silu, scale_shift)
    if x.device.type == "cuda":
        return _fused_group_norm_stats(x, scale, bias, groups, eps, silu, scale_shift)
    raise ValueError(f"group_norm: no implementation for device {x.device}")


class GroupNormFunction(torch.autograd.Function):
    """K3 (the plain version on the CPU) forward, ``group_norm_bwd`` backward:
    the counterpart of ``fused_group_norm``'s custom VJP in the JAX package.
    Saves x and the groups' mean and rstd; ss and sb may be None."""

    @staticmethod
    def forward(ctx, x, scale, bias, ss, sb, groups, eps, silu):
        scale_shift = None if ss is None else (ss, sb)
        y, stats = _group_norm_stats(x, scale, bias, groups, eps, silu, scale_shift)
        ctx.save_for_backward(x, scale, bias, ss, sb, stats)
        ctx.groups, ctx.silu = groups, silu
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, scale, bias, ss, sb, stats = ctx.saved_tensors
        scale_shift = None if ss is None else (ss, sb)
        dx, dscale, dbias, dss, dsb = group_norm_bwd(
            x, dy, stats[0], stats[1], scale, bias, ctx.groups, ctx.silu, scale_shift,
            needs=ctx.needs_input_grad[:5],
        )
        cast = lambda g, like: None if g is None else g.reshape(like.shape).to(like.dtype)
        return (dx, cast(dscale, scale), cast(dbias, bias), cast(dss, ss), cast(dsb, sb),
                None, None, None)


def _needs_grad(*inputs) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs)


def group_norm(x, scale, bias, *, groups: int = 32, eps: float = 1e-5, silu: bool = False, scale_shift=None):
    """Dispatching entry point: plain on CPU, K3 on CUDA; inputs that require
    grad go through ``GroupNormFunction``.

    The JAX signature minus its int8 arguments and its ``impl`` switch: the
    device decides, so no setting sends a CUDA tensor to the plain version.
    The int8 variant is ``group_norm_quant``.
    """
    if x.shape[-1] % groups:
        raise ValueError(f"channels {x.shape[-1]} not divisible by {groups} groups")
    ss, sb = scale_shift if scale_shift is not None else (None, None)
    if _needs_grad(x, scale, bias, ss, sb):
        return GroupNormFunction.apply(x, scale, bias, ss, sb, groups, eps, silu)
    return _group_norm_stats(x, scale, bias, groups, eps, silu, scale_shift)[0]


# ---------------------------------------------------------------------------
# The quantizing GroupNorm (kernel K4): the same statistics and folded affine,
# plus the per-image int8 scale s from each channel's min and max of x, and
# q = clip(round(y / s), -127, 127) in place of y.
# ---------------------------------------------------------------------------


def _bound_scale(a, b, xmin, xmax, silu: bool):
    """Exact per-image int8 scale (s, 1/s), both (B,), from the folded
    affine a, b and the channels' extremes of x, all (B, C) f32: y is affine
    in raw x, so max|y_c| = max(|a_c xmax_c + b_c|, |a_c xmin_c + b_c|); SiLU
    only shrinks magnitudes except for its -0.2785 floor."""
    bound = torch.maximum((a * xmax + b).abs(), (a * xmin + b).abs()).amax(dim=-1)
    if silu:
        bound = bound.clamp(min=0.2785)
    s = bound.clamp(min=1e-6) * (1.0 / 127.0)
    return s, 1.0 / s


def _group_norm_quant_plain_stats(x, scale, bias, groups, eps, silu, scale_shift, out_dtype):
    """``group_norm_quant_plain``'s (q, s) and the (2, B, G) f32 mean and rstd."""
    B, C = x.shape[0], x.shape[-1]
    xf = x.float()
    spatial = xf.shape[1:-1]
    xg = xf.reshape(B, -1, groups, C // groups)
    n = xg.shape[1] * xg.shape[3]
    mean = xg.sum(dim=(1, 3)) / n  # (B, G)
    var = (xg * xg).sum(dim=(1, 3)) / n - mean * mean
    rstd = torch.rsqrt(var + eps)
    a = rstd.repeat_interleave(C // groups, dim=1) * scale.float()  # (B, C)
    b = bias.float() - mean.repeat_interleave(C // groups, dim=1) * a
    if scale_shift is not None:
        k = 1.0 + scale_shift[0].float().reshape(B, C)
        a = a * k
        b = b * k + scale_shift[1].float().reshape(B, C)
    bshape = (B,) + (1,) * len(spatial) + (C,)
    y = xf * a.reshape(bshape) + b.reshape(bshape)
    if silu:
        y = torch.nn.functional.silu(y)
    flat = xf.reshape(B, -1, C)
    s, inv = _bound_scale(a, b, flat.amin(dim=1), flat.amax(dim=1), silu)
    q = torch.round(y * inv.reshape((B,) + (1,) * (y.dim() - 1))).clamp(-127, 127)
    return q.to(out_dtype), s, torch.stack([mean, rstd])


def group_norm_quant_plain(x, scale, bias, groups: int, eps: float, silu: bool, scale_shift,
                           out_dtype=torch.int8):
    """Plain PyTorch version of K4, mirroring ``_gn_ref_quant_math``: the
    folded affine ``y = x * a + b`` (not ``_gn_reference``'s
    ``(x - mean) * rstd * scale + bias``), then (q, s) with q in
    ``out_dtype`` (s8, or integer values in x's dtype) and s (B,) f32."""
    return _group_norm_quant_plain_stats(x, scale, bias, groups, eps, silu, scale_shift, out_dtype)[:2]


def fused_group_norm_quant(x, scale, bias, groups: int, eps: float, silu: bool, scale_shift,
                           out_dtype=torch.int8):
    """Kernel K4 on a CUDA tensor x (B, *spatial, C), contiguous: (q, s),
    q contiguous in x's shape (NHWC, which K5 reads directly) in
    ``out_dtype`` (s8 or x's dtype). Stats with min/max, the finalize (the
    affine, each group's mean and rstd, and the per-image s) and the
    quantizing apply are three launches of ``csrc/groupnorm.cu``.

    It records no backward: inputs that require grad go through
    ``group_norm_quant``, which wraps K4 in ``GroupNormQuantFunction``.
    """
    return _fused_group_norm_quant_stats(x, scale, bias, groups, eps, silu, scale_shift, out_dtype)[:2]


def _fused_group_norm_quant_stats(x, scale, bias, groups, eps, silu, scale_shift, out_dtype):
    inputs = (x, scale, bias, *(scale_shift or ()))
    if _needs_grad(*inputs):
        raise RuntimeError("fused_group_norm_quant records no backward; call group_norm_quant()")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"group_norm_quant kernel takes float32 or bfloat16, got {x.dtype}")
    if out_dtype not in (torch.int8, x.dtype):
        raise TypeError(f"group_norm_quant kernel emits int8 or x's dtype, not {out_dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm_quant kernel needs x contiguous in (B, *spatial, C) order")
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_quant kernel needs a CUDA tensor, got one on {x.device}")
    B, C = x.shape[0], x.shape[-1]
    hw = x.numel() // (B * C)
    vec = _vec(x, C)
    splits = _splits(B, hw, C, vec)
    dev = x.device
    gamma = scale.to(device=dev, dtype=torch.float32).contiguous()
    beta = bias.to(device=dev, dtype=torch.float32).contiguous()
    ss = sb = None
    if scale_shift is not None:
        ss, sb = (t.to(device=dev, dtype=torch.float32).reshape(B, C).contiguous() for t in scale_shift)
    partial = torch.empty((4, B, splits, C), dtype=torch.float32, device=dev)
    affine = torch.empty((2, B, C), dtype=torch.float32, device=dev)
    stats = torch.empty((2, B, groups), dtype=torch.float32, device=dev)
    scales = torch.empty((2, B), dtype=torch.float32, device=dev)
    q = torch.empty(x.shape, dtype=out_dtype, device=dev)
    rc = build.load().gdc_group_norm_quant(
        x.data_ptr(), partial.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if ss is None else ss.data_ptr(), None if sb is None else sb.data_ptr(),
        affine.data_ptr(), stats.data_ptr(), scales.data_ptr(), q.data_ptr(),
        B, hw, C, groups, eps, int(silu), splits, vec, _DTYPE_CODE[x.dtype], int(out_dtype == torch.int8),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(rc, "gdc_group_norm_quant")
    fused_group_norm_quant.launches += 1
    return q, scales[0], stats


fused_group_norm_quant.launches = 0


def _group_norm_quant_stats(x, scale, bias, groups, eps, silu, scale_shift, out_dtype):
    if x.device.type == "cpu":
        return _group_norm_quant_plain_stats(x, scale, bias, groups, eps, silu, scale_shift, out_dtype)
    if x.device.type == "cuda":
        return _fused_group_norm_quant_stats(x, scale, bias, groups, eps, silu, scale_shift, out_dtype)
    raise ValueError(f"group_norm_quant: no implementation for device {x.device}")


class GroupNormQuantFunction(torch.autograd.Function):
    """K4 (the plain version on the CPU) forward emitting integer-valued q in
    x's dtype; straight-through backward, as the JAX package's
    ``_gn_ref_quant_bwd``: ``dy = (dq / s).to(x.dtype)`` (s is
    stop-gradient), then ``group_norm_bwd`` from the mean and rstd that the
    forward wrote."""

    @staticmethod
    def forward(ctx, x, scale, bias, ss, sb, groups, eps, silu):
        scale_shift = None if ss is None else (ss, sb)
        q, s, stats = _group_norm_quant_stats(x, scale, bias, groups, eps, silu, scale_shift, x.dtype)
        ctx.mark_non_differentiable(s)
        ctx.save_for_backward(x, scale, bias, ss, sb, stats, s)
        ctx.groups, ctx.silu = groups, silu
        return q, s

    @staticmethod
    @once_differentiable
    def backward(ctx, dq, _ds):
        x, scale, bias, ss, sb, stats, s = ctx.saved_tensors
        dy = (dq.float() / s.reshape((-1,) + (1,) * (dq.dim() - 1))).to(x.dtype)
        scale_shift = None if ss is None else (ss, sb)
        dx, dscale, dbias, dss, dsb = group_norm_bwd(
            x, dy, stats[0], stats[1], scale, bias, ctx.groups, ctx.silu, scale_shift,
            needs=ctx.needs_input_grad[:5],
        )
        cast = lambda g, like: None if g is None else g.reshape(like.shape).to(like.dtype)
        return (dx, cast(dscale, scale), cast(dbias, bias), cast(dss, ss), cast(dsb, sb),
                None, None, None)


def group_norm_quant(x, scale, bias, *, groups: int = 32, eps: float = 1e-5, silu: bool = False,
                     scale_shift=None):
    """The quantizing GroupNorm: (q, s) with ``y ~= q * s[b]``, q of x's
    shape in [-127, 127], s (B,) f32. Plain on the CPU, K4 on CUDA.

    The emission follows autograd, in place of the JAX package's
    ``int8_emit``: with nothing to differentiate, q is real s8 (the
    generator's sampling path); when an input requires grad, q holds the
    same integers in x's dtype and goes through ``GroupNormQuantFunction``
    (the guided classifier).
    """
    if x.shape[-1] % groups:
        raise ValueError(f"channels {x.shape[-1]} not divisible by {groups} groups")
    ss, sb = scale_shift if scale_shift is not None else (None, None)
    if _needs_grad(x, scale, bias, ss, sb):
        return GroupNormQuantFunction.apply(x, scale, bias, ss, sb, groups, eps, silu)
    return _group_norm_quant_stats(x, scale, bias, groups, eps, silu, scale_shift, torch.int8)[:2]
