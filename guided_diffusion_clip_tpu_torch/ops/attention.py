"""QKV self-attention over flattened spatial tokens.

Counterpart of ``guided_diffusion_clip_tpu/ops/attention.py``, in the same
layout at the public surface: qkv is ``(B, T, 3C)``, the output ``(B, T, C)``.
Two head-split channel layouts exist in released checkpoints and both are
supported:

  - legacy (``new_order=False``): qkv channels laid out [head][q|k|v][d]
  - new    (``new_order=True``):  qkv channels laid out [q|k|v][head][d]

Both pre-scale q and k by d^-1/4 and run the softmax in f32.

``attention`` dispatches on the tensor's device: a CPU tensor goes to the
plain PyTorch version ``qkv_attention_plain``; a CUDA tensor goes to the
hand-written kernel K1 (``csrc/attention_fwd.cu``), or raises. An input that
requires grad goes through ``AttentionFunction``, whose backward is the
hand-written kernel K2 (``csrc/attention_bwd.cu``) on the card and
``attention_bwd_plain`` on the CPU; the gradient comes back as ``(B, T, 3C)``
in the input's head order.

Kernel K1 replaces ``guided_diffusion_clip_tpu/ops/pallas_attention.py::
_attn_kernel``. On the H100 it is compute-bound (4*T*T*d FLOPs per head
against 4*T*d elements moved); this first version runs on the f32 FMA pipes
with an online softmax over K/V tiles, so shared memory stays O(tile*d)
where the TPU kernel held a whole head's K/V in VMEM. Kernel K2 replaces
``_attn_bwd_kernel``: a Q-stationary kernel for dQ and the row statistics,
then a K/V-stationary kernel for dK and dV, with no float atomics. See the
sources' headers for the designs.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from . import build

# d values K1 is instantiated for: 64 is the ADM-256 UNet's head width;
# 192 and 256 are the fork's 128 px recipe (num_heads 1 at C = 192 and 256).
KERNEL_HEAD_DIMS = (32, 64, 128, 192, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def split_qkv(qkv: torch.Tensor, num_heads: int, new_order: bool):
    """Split a (B, T, 3C) qkv tensor into q/k/v of shape (B, T, H, d) (views)."""
    B, T, W = qkv.shape
    if W % (3 * num_heads):
        raise ValueError(f"qkv width {W} not divisible by 3*{num_heads}")
    d = W // (3 * num_heads)
    if new_order:
        x = qkv.reshape(B, T, 3, num_heads, d)
        return x[:, :, 0], x[:, :, 1], x[:, :, 2]
    x = qkv.reshape(B, T, num_heads, 3, d)
    return x[:, :, :, 0], x[:, :, :, 1], x[:, :, :, 2]


def merge_heads(a: torch.Tensor) -> torch.Tensor:
    """(B, T, H, d) -> (B, T, C)."""
    B, T, H, d = a.shape
    return a.reshape(B, T, H * d)


def qkv_attention_plain(qkv: torch.Tensor, num_heads: int, *, new_order: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K1: (B, T, 3C) -> (B, T, C).

    q*s and k*s are rounded to the input dtype (as the TPU kernel's
    ``(q * scale).astype(q.dtype)``), the logits are f32 products of those
    values, the softmax is f32, the weights are rounded to v's dtype, and
    P.V accumulates in f32 before the cast back.
    """
    q, k, v = split_qkv(qkv, num_heads, new_order)
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(math.sqrt(d))
    qs = (q * scale).to(qkv.dtype).float().permute(0, 2, 1, 3)  # (B, H, T, d)
    ks = (k * scale).to(qkv.dtype).float().permute(0, 2, 3, 1)  # (B, H, d, T)
    logits = torch.matmul(qs, ks)  # (B, H, T, T) f32
    weights = torch.softmax(logits, dim=-1).to(v.dtype).float()
    out = torch.matmul(weights, v.float().permute(0, 2, 1, 3))  # (B, H, T, d)
    return merge_heads(out.permute(0, 2, 1, 3).to(qkv.dtype))


def attention_bwd_plain(q, k, v, do):
    """Plain PyTorch version of K2, line for line ``_attn_bwd_kernel``.

    q, k, v, do: (..., T, d). Returns (dq, dk, dv): P is recomputed in f32
    from q*s and k*s (rounded to the input dtype, as the forward);
    dV = P^T dO, dS = P o (dP - rowsum(dP o P)), dQ = dS K s^2,
    dK = dS^T Q s^2, all in f32; dq is cast to q's dtype, dk and dv to k's
    and v's.
    """
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(math.sqrt(d))
    dof = do.float()
    logits = torch.matmul((q * scale).float(), (k * scale).float().transpose(-1, -2))
    p = torch.softmax(logits, dim=-1)  # (..., T, T) f32
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = (torch.matmul(ds, k.float()) * (scale * scale)).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * (scale * scale)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def qkv_attention_bwd_plain(qkv, do, num_heads: int, new_order: bool) -> torch.Tensor:
    """``attention_bwd_plain`` on the (B, T, 3C) layout: dqkv in qkv's head order."""
    B, T, _ = qkv.shape
    q, k, v = (a.transpose(1, 2) for a in split_qkv(qkv, num_heads, new_order))  # (B, H, T, d)
    dout = do.reshape(B, T, num_heads, -1).transpose(1, 2)
    grads = [g.transpose(1, 2) for g in attention_bwd_plain(q, k, v, dout)]  # (B, T, H, d)
    return torch.stack(grads, dim=2 if new_order else 3).reshape(qkv.shape)


def _check_kernel_input(qkv: torch.Tensor, num_heads: int) -> int:
    """Raise on what kernels K1 and K2 do not take; returns the head dim."""
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"attention kernel takes float32 or bfloat16, got {qkv.dtype}")
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError(f"attention kernel needs a contiguous (B, T, 3C) tensor, got {tuple(qkv.shape)}")
    W = qkv.shape[-1]
    if W % (3 * num_heads):
        raise ValueError(f"qkv width {W} not divisible by 3*{num_heads}")
    d = W // (3 * num_heads)
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel has no instantiation for head dim {d} (has {KERNEL_HEAD_DIMS})")
    if qkv.device.type != "cuda":
        raise ValueError(f"attention kernel needs a CUDA tensor, got one on {qkv.device}")
    return d


def attention_fwd_cuda(qkv: torch.Tensor, num_heads: int, *, new_order: bool = False) -> torch.Tensor:
    """Launch kernel K1 on a CUDA (B, T, 3C) tensor; raises on what it does not take.

    It records no backward: an input that requires grad goes through
    ``attention``, which wraps K1 and K2 in ``AttentionFunction``.
    """
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise RuntimeError("attention_fwd_cuda records no backward; call attention()")
    d = _check_kernel_input(qkv, num_heads)
    B, T, _ = qkv.shape
    lib = build.load()
    out = torch.empty((B, T, num_heads * d), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = lib.gdc_attention_fwd(
        qkv.data_ptr(), out.data_ptr(), B, T, num_heads, d, int(new_order),
        _DTYPE_CODE[qkv.dtype], 1.0 / math.sqrt(math.sqrt(d)), stream,
    )
    build.check(rc, "gdc_attention_fwd")
    attention_fwd_cuda.launches += 1
    return out


attention_fwd_cuda.launches = 0


def attention_bwd_cuda(qkv: torch.Tensor, do: torch.Tensor, num_heads: int, *, new_order: bool = False) -> torch.Tensor:
    """Launch kernel K2: the gradient of ``attention_fwd_cuda(qkv)`` given the
    output cotangent ``do`` (B, T, C), as (B, T, 3C) in qkv's head order and
    dtype. ``do`` is made contiguous here (autograd may hand over a view)."""
    d = _check_kernel_input(qkv, num_heads)
    B, T, _ = qkv.shape
    if do.shape != (B, T, num_heads * d) or do.dtype != qkv.dtype or do.device != qkv.device:
        raise ValueError(
            f"attention backward: cotangent {tuple(do.shape)} {do.dtype} on {do.device} does not match "
            f"the output ({B}, {T}, {num_heads * d}) {qkv.dtype} on {qkv.device}"
        )
    do = do.contiguous()
    lib = build.load()
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((3, B * num_heads, T), dtype=torch.float32, device=qkv.device)
    scale = 1.0 / math.sqrt(math.sqrt(d))
    rc = lib.gdc_attention_bwd(
        qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        B, T, num_heads, d, int(new_order), _DTYPE_CODE[qkv.dtype], scale, scale * scale,
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    build.check(rc, "gdc_attention_bwd")
    attention_bwd_cuda.launches += 1
    return dqkv


attention_bwd_cuda.launches = 0


def _attention_fwd(qkv: torch.Tensor, num_heads: int, new_order: bool) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, num_heads, new_order=new_order)
    if qkv.device.type == "cuda":
        return attention_fwd_cuda(qkv, num_heads, new_order=new_order)
    raise ValueError(f"attention: no implementation for device {qkv.device}")


class AttentionFunction(torch.autograd.Function):
    """K1 forward and K2 backward (the plain versions on the CPU), the
    counterpart of ``_flash_bhtd``'s custom VJP. Saves qkv only: the backward
    recomputes P, as the TPU kernel does."""

    @staticmethod
    def forward(ctx, qkv, num_heads, new_order):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.new_order = num_heads, new_order
        return _attention_fwd(qkv, num_heads, new_order)

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        if qkv.device.type == "cuda":
            dqkv = attention_bwd_cuda(qkv, do, ctx.num_heads, new_order=ctx.new_order)
        else:
            dqkv = qkv_attention_bwd_plain(qkv, do, ctx.num_heads, ctx.new_order)
        return dqkv, None, None


def attention(qkv: torch.Tensor, num_heads: int, *, new_order: bool = False) -> torch.Tensor:
    """Dispatching entry point used by the models: plain on CPU, K1 on CUDA;
    an input that requires grad goes through ``AttentionFunction`` (K2)."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return AttentionFunction.apply(qkv, num_heads, new_order)
    return _attention_fwd(qkv, num_heads, new_order)
