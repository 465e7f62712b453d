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
fused_group_norm`` (``_stats_kernel`` + the (B, C) glue + ``_apply_kernel``),
K4 its ``_fused_gn_quant_impl``. On the H100 both are bandwidth-bound and, at
small maps, launch-bound: each call is one cooperative launch of one block an
SM that walks x in chunks the L2 can hold (``_schedule``), reading a chunk
from device memory for its statistics, then, after a grid barrier and a fold
in a fixed order (no float atomics), from the L2 for the apply.

Under spatial partitioning (``parallel/sp.py``) a rank holds some rows of
each image, and the statistics must cross the ranks between the two
phases. A call on a row shard (``sp.sharded``) then runs K3 or K4 split at
its statistics: the stats entry (``group_norm_stats``: each group's f32 sum
and sum of squares, with K4 each channel's min and max), an all-reduce over
the space group (SUM of the sums, MAX of max and of -min), the fold with the
image's count ``H*W*C/G`` (``_fold``, and K4's ``_bound_scale``), then the
apply entry (``group_norm_apply``, ``group_norm_quant_apply``): the one-pass
E[x^2] - mean^2 in f32, eps 1e-5, as before. The backward all-reduces its
per-group sums of the cotangent likewise. An unsharded call keeps its one
launch.

Under tensor parallelism (``parallel/tp.py``) a rank holds whole groups of
some channels (``models/nn.py::GroupNorm32`` passes their scale, bias and
group count), so K3 and its backward need no collective. K4's per-image
scale is a max over all the channels, so ``group_norm_quant(...,
channel_shard=True)`` runs K4 split at its statistics: the stats entry with
the channels' extremes, the fold, each image's bound over the rank's
channels (``_bound``) reduced MAX over the model group, the quant-apply
entry.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from ..parallel import sp, tp
from . import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
CHUNK_BYTES = 32 << 20  # x a chunk, at most (tools/gn_tune.py sweeps 8-32 MiB)
_THREADS = 768  # a block (csrc/groupnorm.cu's kThreads): 16-byte vectors of a row side by side
_MIN_BLOCK_BYTES = 32 << 10  # x a block takes of a chunk, at least: fewer slots at small maps


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
                   needs=(True, True, True, True, True), split: bool = False):
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
    ``split``: x is a row shard (``sp.sharded``), so the groups' sums of g
    and g * xhat are all-reduced over the space group before dx; dscale,
    dbias, dss and dsb are this rank's part (the ranks' parts are summed
    where the gradients of replicated values meet: DDP, or the adjoints).
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
        if split:
            sums = sp.reduce_sum_(torch.stack([gx.sum(dim=(1, 3)), (gx * xh).sum(dim=(1, 3))]))
            sums = sums / (gx.shape[1] * cg * sp.size())
            m1, m2 = (m.reshape(B, 1, groups, 1) for m in sums)
        else:
            m1 = gx.mean(dim=(1, 3), keepdim=True)
            m2 = (gx * xh).mean(dim=(1, 3), keepdim=True)
        dx = ((gx - m1 - xh * m2) * rstd.reshape(B, 1, groups, 1)).reshape(x.shape).to(x.dtype)
    return dx, dscale, dbias, dss, dsb


def _schedule(B: int, hw: int, C: int, G: int, vec: int, itemsize: int, quant: bool, max_blocks: int,
              budget: int | None = None):
    """How K3 or K4 walks x (B, hw, C): ``(chunks, grid, nb, ng)``.

    A chunk is ``(b0, nb, g0, ng, blocks_per_image, rows_per_block)``: the
    images b0 .. b0+nb-1 and the groups g0 .. g0+ng-1 of each. It is several
    whole images where one fits the byte ``budget`` of x, else (K3) a range of
    whole groups of one image, as many as fit (``budget``: ``CHUNK_BYTES``); K4's chunk is whole images,
    one at least, since its scale couples an image's channels. In a chunk,
    each image's rows are split into ``blocks_per_image`` ranges of
    ``rows_per_block``, one a block, so every row is read by one block; the
    grid is at most ``max_blocks`` (the co-resident count a cooperative launch
    takes), and no larger than gives each block ``_MIN_BLOCK_BYTES`` of x.
    The kernel walks this chunk list, uploaded as a table (``_plan``), and
    computes no schedule of its own.
    """
    budget = CHUNK_BYTES if budget is None else budget
    cg = C // G
    if max_blocks < 1 or C % vec:
        raise ValueError(f"group_norm schedule: {max_blocks} blocks, C={C}, vec={vec}")
    image = hw * C * itemsize
    if quant or (image <= budget and C // vec <= _THREADS):
        if C // vec > _THREADS:
            raise ValueError(f"group_norm_quant kernel takes at most {_THREADS} vectors a row, got {C // vec}")
        nb, ng = max(1, min(B, budget // image, max_blocks)), G
    else:
        step = vec // math.gcd(cg, vec)  # groups whose channels fill whole vectors
        fit = min(budget // (hw * cg * itemsize), _THREADS * vec // cg)
        nb, ng = 1, min(G, max(step, fit // step * step))
    grid = nb * max(1, min(max_blocks // nb, -(-hw * ng * cg * itemsize // _MIN_BLOCK_BYTES)))
    chunks = []
    for b0 in range(0, B, nb):
        for g0 in range(0, G, ng):
            nbi = min(nb, B - b0)
            per = grid // nbi
            chunks.append((b0, nbi, g0, min(ng, G - g0), per, -(-hw // per)))
    return chunks, grid, nb, ng


def _vec(x: torch.Tensor, C: int) -> int:
    """Channels per thread: 16 bytes' worth when C and the pointer allow."""
    wide = 16 // x.element_size()
    return wide if C % wide == 0 and x.data_ptr() % 16 == 0 else 1


_plans: dict = {}


def _co_resident(lib, quant: bool, dtype_code: int, s8: bool, vec: int, silu: bool, C: int, G: int,
                 device: torch.device) -> int:
    """The largest grid a cooperative launch of the kernel takes (blocks an SM
    times SMs), asked of the card; sized for a chunk of all G groups, the
    most shared memory a call can use."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.gdc_group_norm_blocks(int(quant), dtype_code, int(s8), vec, int(silu), C, G, G, ctypes.byref(blocks))
    build.check(rc, "gdc_group_norm_blocks")
    return blocks.value


def _schedule_on_card(lib, x, groups, silu, quant, s8, budget=None):
    """``_schedule`` for x on its card: (grid, the chunk list as an
    (n_chunks, 6) int32 tensor on x's device, ng)."""
    B, C = x.shape[0], x.shape[-1]
    vec = _vec(x, C)
    max_blocks = _co_resident(lib, quant, _DTYPE_CODE[x.dtype], s8, vec, silu, C, groups, x.device)
    chunks, grid, _, ng = _schedule(B, x.numel() // (B * C), C, groups, vec, x.element_size(), quant, max_blocks,
                                    budget)
    return grid, torch.tensor(chunks, dtype=torch.int32, device=x.device), ng


def _plan(x, scale, bias, groups, silu, scale_shift, quant, s8):
    """What a K3 or K4 launch needs besides x and its outputs: the library,
    (B, hw, C, vec) and the schedule (grid, chunk table, ng) from
    ``_schedule_on_card`` (kept per shape and kernel, so a call spends no
    host time on it after the first), gamma, beta, ss and sb as f32 on x's
    device, and the slots (scratch of 4 * grid * ng + grid f32: the
    per-block group sums, two chunks' worth, and K4's per-block bounds)."""
    B, C = x.shape[0], x.shape[-1]
    hw = x.numel() // (B * C)
    vec = _vec(x, C)
    lib = build.load()
    dev = x.device
    key = (B, hw, C, groups, vec, _DTYPE_CODE[x.dtype], quant, s8, silu, dev.index)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = (B, hw, C, vec, *_schedule_on_card(lib, x, groups, silu, quant, s8))
    gamma = scale.to(device=dev, dtype=torch.float32).contiguous()
    beta = bias.to(device=dev, dtype=torch.float32).contiguous()
    ss = sb = None
    if scale_shift is not None:
        ss, sb = (t.to(device=dev, dtype=torch.float32).reshape(B, C).contiguous() for t in scale_shift)
    slots = torch.empty(4 * plan[4] * plan[6] + plan[4], dtype=torch.float32, device=dev)
    return lib, plan, gamma, beta, ss, sb, slots


def fused_group_norm(x, scale, bias, groups: int, eps: float, silu: bool, scale_shift):
    """Kernel K3 on a CUDA tensor x (B, *spatial, C), contiguous; raises on
    what it does not take. Stats, the affine folding and the apply are one
    launch of ``csrc/groupnorm.cu``.

    It records no backward: inputs that require grad go through
    ``group_norm``, which wraps K3 in ``GroupNormFunction``.
    """
    return _fused_group_norm_stats(x, scale, bias, groups, eps, silu, scale_shift)[0]


def _fused_group_norm_stats(x, scale, bias, groups, eps, silu, scale_shift):
    """K3's output and the (2, B, G) f32 mean and rstd it wrote."""
    inputs = (x, scale, bias, *(scale_shift or ()))
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError("fused_group_norm records no backward; call group_norm()")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"group_norm kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm kernel needs x contiguous in (B, *spatial, C) order")
    if x.device.type != "cuda":
        raise ValueError(f"group_norm kernel needs a CUDA tensor, got one on {x.device}")
    lib, plan, gamma, beta, ss, sb, slots = _plan(x, scale, bias, groups, silu, scale_shift, False, False)
    B, hw, C, vec, grid, chunks, ng = plan
    stats = torch.empty((2, B, groups), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    rc = lib.gdc_group_norm(
        x.data_ptr(), slots.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if ss is None else ss.data_ptr(), None if sb is None else sb.data_ptr(),
        stats.data_ptr(), y.data_ptr(), B, hw, C, groups, eps, int(silu), vec, _DTYPE_CODE[x.dtype],
        grid, chunks.data_ptr(), len(chunks), ng, torch.cuda.current_stream(x.device).cuda_stream,
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
        ctx.split = sp.sharded(x)
        if ctx.split:
            y, stats = _group_norm_split(x, scale, bias, groups, eps, silu, scale_shift, False, None)
        else:
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
            needs=ctx.needs_input_grad[:5], split=ctx.split,
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
    if sp.sharded(x):
        return _group_norm_split(x, scale, bias, groups, eps, silu, scale_shift, False, None)[0]
    return _group_norm_stats(x, scale, bias, groups, eps, silu, scale_shift)[0]


# ---------------------------------------------------------------------------
# The quantizing GroupNorm (kernel K4): the same statistics and folded affine,
# plus the per-image int8 scale s from each channel's min and max of x, and
# q = clip(round(y / s), -127, 127) in place of y.
# ---------------------------------------------------------------------------


def _bound(a, b, xmin, xmax):
    """Each image's max |y| (B,) over the channels of the folded affine a, b
    and x's extremes, all (B, C) f32: y is affine in raw x, so max|y_c| =
    max(|a_c xmax_c + b_c|, |a_c xmin_c + b_c|)."""
    return torch.maximum((a * xmax + b).abs(), (a * xmin + b).abs()).amax(dim=-1)


def _scale(bound, silu: bool):
    """The per-image int8 scale (s, 1/s), both (B,), of each image's bound;
    SiLU only shrinks magnitudes except for its -0.2785 floor."""
    if silu:
        bound = bound.clamp(min=0.2785)
    s = bound.clamp(min=1e-6) * (1.0 / 127.0)
    return s, 1.0 / s


def _bound_scale(a, b, xmin, xmax, silu: bool):
    """Exact per-image int8 scale (s, 1/s), both (B,), from the folded
    affine a, b and the channels' extremes of x, all (B, C) f32."""
    return _scale(_bound(a, b, xmin, xmax), silu)


def _group_norm_quant_plain_stats(x, scale, bias, groups, eps, silu, scale_shift, out_dtype):
    """``group_norm_quant_plain``'s (q, s) and the (2, B, G) f32 mean and rstd."""
    B, C = x.shape[0], x.shape[-1]
    sums, ext = group_norm_stats_plain(x, groups, True)
    mean, rstd, a, b = _fold(sums, x.numel() // (B * groups), scale, bias, groups, eps, scale_shift)
    s, inv = _bound_scale(a, b, ext[0], ext[1], silu)
    return group_norm_quant_apply_plain(x, a, b, inv, silu, out_dtype), s, torch.stack([mean, rstd])


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
    ``out_dtype`` (s8 or x's dtype). Stats with min/max, the fold (the
    affine, each group's mean and rstd, and the per-image s) and the
    quantizing apply are one launch of ``csrc/groupnorm.cu``.

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
    s8 = out_dtype == torch.int8
    lib, plan, gamma, beta, ss, sb, slots = _plan(x, scale, bias, groups, silu, scale_shift, True, s8)
    B, hw, C, vec, grid, chunks, ng = plan
    stats = torch.empty((2, B, groups), dtype=torch.float32, device=x.device)
    scales = torch.empty((2, B), dtype=torch.float32, device=x.device)
    q = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    rc = lib.gdc_group_norm_quant(
        x.data_ptr(), slots.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if ss is None else ss.data_ptr(), None if sb is None else sb.data_ptr(),
        stats.data_ptr(), scales.data_ptr(), q.data_ptr(), B, hw, C, groups, eps, int(silu), vec,
        _DTYPE_CODE[x.dtype], int(s8), grid, chunks.data_ptr(), len(chunks), ng,
        torch.cuda.current_stream(x.device).cuda_stream,
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
    def forward(ctx, x, scale, bias, ss, sb, groups, eps, silu, channel_shard=False):
        scale_shift = None if ss is None else (ss, sb)
        ctx.split = sp.sharded(x)
        if ctx.split:
            q, s, stats = _group_norm_split(x, scale, bias, groups, eps, silu, scale_shift, True, x.dtype)
        elif channel_shard:
            q, s, stats = _group_norm_channels(x, scale, bias, groups, eps, silu, scale_shift, x.dtype)
        else:
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
            needs=ctx.needs_input_grad[:5], split=ctx.split,
        )
        cast = lambda g, like: None if g is None else g.reshape(like.shape).to(like.dtype)
        return (dx, cast(dscale, scale), cast(dbias, bias), cast(dss, ss), cast(dsb, sb),
                None, None, None, None)


def group_norm_quant(x, scale, bias, *, groups: int = 32, eps: float = 1e-5, silu: bool = False,
                     scale_shift=None, channel_shard: bool = False):
    """The quantizing GroupNorm: (q, s) with ``y ~= q * s[b]``, q of x's
    shape in [-127, 127], s (B,) f32. Plain on the CPU, K4 on CUDA.

    The emission follows autograd, in place of the JAX package's
    ``int8_emit``: with nothing to differentiate, q is real s8 (the
    generator's sampling path); when an input requires grad, q holds the
    same integers in x's dtype and goes through ``GroupNormQuantFunction``
    (the guided classifier).

    ``channel_shard``: x is the rank's channels (whole groups) under tensor
    parallelism, and s is the whole activation's: K4 split at its
    statistics, the bound reduced over the model group
    (``_group_norm_channels``).
    """
    if x.shape[-1] % groups:
        raise ValueError(f"channels {x.shape[-1]} not divisible by {groups} groups")
    ss, sb = scale_shift if scale_shift is not None else (None, None)
    if _needs_grad(x, scale, bias, ss, sb):
        return GroupNormQuantFunction.apply(x, scale, bias, ss, sb, groups, eps, silu, channel_shard)
    if sp.sharded(x):
        return _group_norm_split(x, scale, bias, groups, eps, silu, scale_shift, True, torch.int8)[:2]
    if channel_shard:
        return _group_norm_channels(x, scale, bias, groups, eps, silu, scale_shift, torch.int8)[:2]
    return _group_norm_quant_stats(x, scale, bias, groups, eps, silu, scale_shift, torch.int8)[:2]


# ---------------------------------------------------------------------------
# K3 and K4 split at their statistics (spatial partitioning): the stats
# entry, the fold, and the apply entries, each plain on the CPU and its
# kernel in csrc/groupnorm.cu on CUDA (``gdc_group_norm_stats``,
# ``gdc_group_norm_apply``, ``gdc_group_norm_quant_apply``).
# ---------------------------------------------------------------------------


def group_norm_stats_plain(x, groups: int, minmax: bool):
    """Plain version of the stats entry: (sums, ext) of x (B, *spatial, C):
    sums (2, B, G) f32, each group's sum and sum of squares; ext (2, B, C)
    f32, each channel's min and max (``minmax``), else None."""
    B, C = x.shape[0], x.shape[-1]
    xf = x.float()
    xg = xf.reshape(B, -1, groups, C // groups)
    sums = torch.stack([xg.sum(dim=(1, 3)), (xg * xg).sum(dim=(1, 3))])
    ext = None
    if minmax:
        flat = xf.reshape(B, -1, C)
        ext = torch.stack([flat.amin(dim=1), flat.amax(dim=1)])
    return sums, ext


def _check_split(x, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} kernel needs a CUDA tensor, got one on {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} kernel needs x contiguous in (B, *spatial, C) order")


def group_norm_stats_cuda(x, groups: int, minmax: bool):
    """The stats entry on a CUDA tensor x (B, *spatial, C), contiguous:
    ``group_norm_stats_plain``'s (sums, ext) from one launch."""
    _check_split(x, "group_norm_stats")
    B, C = x.shape[0], x.shape[-1]
    if C % groups or C // groups > 256:
        raise ValueError(f"group_norm_stats kernel takes at most 256 channels a group, got {C} in {groups}")
    sums = torch.empty((2, B, groups), dtype=torch.float32, device=x.device)
    ext = torch.empty((2, B, C), dtype=torch.float32, device=x.device) if minmax else None
    rc = build.load().gdc_group_norm_stats(
        x.data_ptr(), sums.data_ptr(), None if ext is None else ext.data_ptr(), B, x.numel() // (B * C), C, groups,
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "gdc_group_norm_stats")
    group_norm_stats_cuda.launches += 1
    return sums, ext


group_norm_stats_cuda.launches = 0


def group_norm_stats(x, groups: int, minmax: bool = False):
    """The stats entry: plain on the CPU, its kernel on CUDA."""
    if x.device.type == "cpu":
        return group_norm_stats_plain(x, groups, minmax)
    if x.device.type == "cuda":
        return group_norm_stats_cuda(x, groups, minmax)
    raise ValueError(f"group_norm_stats: no implementation for device {x.device}")


def _fold(sums, n: int, scale, bias, groups: int, eps: float, scale_shift):
    """The fold between the two phases, from the (2, B, G) sums over ``n``
    values a group: each group's mean and rstd (B, G) and the folded affine
    a, b (B, C) of ``y = x * a + b``, all f32."""
    B, C = sums.shape[1], scale.shape[0]
    mean = sums[0] / n
    var = sums[1] / n - mean * mean
    rstd = torch.rsqrt(var + eps)
    a = rstd.repeat_interleave(C // groups, dim=1) * scale.float()  # (B, C)
    b = bias.float() - mean.repeat_interleave(C // groups, dim=1) * a
    if scale_shift is not None:
        k = 1.0 + scale_shift[0].float().reshape(B, C)
        a = a * k
        b = b * k + scale_shift[1].float().reshape(B, C)
    return mean, rstd, a, b


def _bshape(x):
    return (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)


def group_norm_apply_plain(x, a, b, silu: bool):
    """Plain version of K3's apply entry: [SiLU](x * a + b) in x's dtype."""
    y = x.float() * a.reshape(_bshape(x)) + b.reshape(_bshape(x))
    if silu:
        y = torch.nn.functional.silu(y)
    return y.to(x.dtype)


def group_norm_apply_cuda(x, a, b, silu: bool):
    """K3's apply entry on a CUDA tensor x (B, *spatial, C), contiguous;
    a, b (B, C) f32."""
    _check_split(x, "group_norm_apply")
    B, C = x.shape[0], x.shape[-1]
    a, b = (t.to(device=x.device, dtype=torch.float32).reshape(B, C).contiguous() for t in (a, b))
    y = torch.empty_like(x)
    rc = build.load().gdc_group_norm_apply(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), B, x.numel() // (B * C), C, int(silu),
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "gdc_group_norm_apply")
    group_norm_apply_cuda.launches += 1
    return y


group_norm_apply_cuda.launches = 0


def group_norm_apply(x, a, b, silu: bool):
    """K3's apply entry: plain on the CPU, its kernel on CUDA."""
    if x.device.type == "cpu":
        return group_norm_apply_plain(x, a, b, silu)
    if x.device.type == "cuda":
        return group_norm_apply_cuda(x, a, b, silu)
    raise ValueError(f"group_norm_apply: no implementation for device {x.device}")


def group_norm_quant_apply_plain(x, a, b, inv, silu: bool, out_dtype=torch.int8):
    """Plain version of K4's apply entry: q = clip(round([SiLU](x * a + b) *
    inv[b]), -127, 127) in ``out_dtype``, inv (B,) the images' 1/s."""
    y = x.float() * a.reshape(_bshape(x)) + b.reshape(_bshape(x))
    if silu:
        y = torch.nn.functional.silu(y)
    q = torch.round(y * inv.reshape((x.shape[0],) + (1,) * (y.dim() - 1))).clamp(-127, 127)
    return q.to(out_dtype)


def group_norm_quant_apply_cuda(x, a, b, inv, silu: bool, out_dtype=torch.int8):
    """K4's apply entry on a CUDA tensor x (B, *spatial, C), contiguous."""
    _check_split(x, "group_norm_quant_apply")
    if out_dtype not in (torch.int8, x.dtype):
        raise TypeError(f"group_norm_quant_apply kernel emits int8 or x's dtype, not {out_dtype}")
    B, C = x.shape[0], x.shape[-1]
    a, b = (t.to(device=x.device, dtype=torch.float32).reshape(B, C).contiguous() for t in (a, b))
    inv = inv.to(device=x.device, dtype=torch.float32).reshape(B).contiguous()
    q = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    rc = build.load().gdc_group_norm_quant_apply(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), inv.data_ptr(), q.data_ptr(), B, x.numel() // (B * C), C,
        int(silu), _DTYPE_CODE[x.dtype], int(out_dtype == torch.int8),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "gdc_group_norm_quant_apply")
    group_norm_quant_apply_cuda.launches += 1
    return q


group_norm_quant_apply_cuda.launches = 0


def group_norm_quant_apply(x, a, b, inv, silu: bool, out_dtype=torch.int8):
    """K4's apply entry: plain on the CPU, its kernel on CUDA."""
    if x.device.type == "cpu":
        return group_norm_quant_apply_plain(x, a, b, inv, silu, out_dtype)
    if x.device.type == "cuda":
        return group_norm_quant_apply_cuda(x, a, b, inv, silu, out_dtype)
    raise ValueError(f"group_norm_quant_apply: no implementation for device {x.device}")


def _group_norm_split(x, scale, bias, groups, eps, silu, scale_shift, quant: bool, out_dtype):
    """K3 (or K4 with ``quant``) on a row shard x: the stats entry, the sums
    all-reduced over the space group (and K4's extremes: MAX of max and of
    -min), the fold over the whole image's count, the apply entry. Returns
    (y, stats) or (q, s, stats), as the unsharded calls do."""
    B, C = x.shape[0], x.shape[-1]
    sums, ext = group_norm_stats(x, groups, quant)
    sp.reduce_sum_(sums)
    n = x.numel() // (B * groups) * sp.size()
    mean, rstd, a, b = _fold(sums, n, scale, bias, groups, eps, scale_shift)
    stats = torch.stack([mean, rstd])
    if not quant:
        return group_norm_apply(x, a, b, silu), stats
    ext[0].neg_()
    sp.reduce_max_(ext)
    s, inv = _bound_scale(a, b, -ext[0], ext[1], silu)
    return group_norm_quant_apply(x, a, b, inv, silu, out_dtype), s, stats


def _group_norm_channels(x, scale, bias, groups, eps, silu, scale_shift, out_dtype):
    """K4 on the rank's channels under tensor parallelism, whole groups of
    them: the stats entry with each channel's extremes, the fold (local),
    each image's bound over these channels all-reduced MAX over the model
    group, the quant-apply entry. Returns (q, s, stats) as K4 does."""
    B = x.shape[0]
    sums, ext = group_norm_stats(x, groups, True)
    mean, rstd, a, b = _fold(sums, x.numel() // (B * groups), scale, bias, groups, eps, scale_shift)
    s, inv = _scale(tp.reduce_max_(_bound(a, b, ext[0], ext[1])), silu)
    return group_norm_quant_apply(x, a, b, inv, silu, out_dtype), s, torch.stack([mean, rstd])
