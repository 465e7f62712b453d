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
hand-written kernel K1, or raises. An input that requires grad goes through
``AttentionFunction``, whose backward is the hand-written kernel K2 on the
card and ``attention_bwd_plain`` on the CPU; the gradient comes back as
``(B, T, 3C)`` in the input's head order.

Kernel K1 replaces ``guided_diffusion_clip_tpu/ops/pallas_attention.py::
_attn_kernel``, kernel K2 ``_attn_bwd_kernel``. On the H100 both are
compute-bound at the UNet's T = 1024 (4*T*T*d FLOPs per head against 4*T*d
elements moved, the backward a few times that). Each exists twice, and the
wrappers pick by the tensor's dtype, with no setting:

  - bfloat16 (every d of ``MMA_HEAD_DIMS``, which is ``KERNEL_HEAD_DIMS``):
    ``csrc/attention_fwd_mma.cu`` and ``csrc/attention_bwd_mma.cu``, every
    product on the tensor cores (``mma.sync`` bf16 with f32 sums, operands
    brought by ``cp.async`` and ``ldmatrix``); K2 feeds its f32 P and dS as
    three bf16 terms that hold all 24 mantissa bits. At d = 192 and 256 (the
    128 px training recipe's one-head attention) K1 reloads Q's fragments at
    each k-step and streams 32-key tiles, with 64 or 32 query rows a block
    (``fwd_q_rows``), and K2's dK/dV kernel gives dV and dK to separate warps.
    They count in ``launches_mma`` as well as in ``launches``;
  - float32 (any d of ``KERNEL_HEAD_DIMS``): ``csrc/attention_fwd.cu`` and
    ``csrc/attention_bwd.cu`` on the f32 FMA pipes, exact to 1e-4. The
    classifier's attention pool is their one user on a main path.

All run an online softmax over K/V tiles, so shared memory stays O(tile*d)
where the TPU kernel held a whole head's K/V in VMEM; K2 is a Q-stationary
kernel for dQ and the row statistics, then a K/V-stationary kernel for dK and
dV, with no float atomics. See the sources' headers for the designs.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.autograd.function import once_differentiable

from . import build

# d values K1 and K2 are instantiated for: 64 is the ADM-256 UNet's and its
# classifier's head width; 96 and 128 are the 64 px quality proxies' (the
# generator's 4 heads at 384 and 512 channels, the classifier's 2 at 192;
# tools/_proxies.py); 192 and 256 are the fork's 128 px recipe (num_heads 1 at
# C = 192 and 256); 32 is the tests' narrow models'.
KERNEL_HEAD_DIMS = (32, 64, 96, 128, 192, 256)
# d values the tensor-core kernels (bfloat16 only) are instantiated for: all of them
MMA_HEAD_DIMS = KERNEL_HEAD_DIMS
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


def _use_mma(dtype: torch.dtype, d: int) -> bool:
    """Whether K1 and K2 run on the tensor cores for this dtype and head dim."""
    return dtype == torch.bfloat16 and d in MMA_HEAD_DIMS


def fwd_q_rows(T: int, bh: int, d: int, sms: int) -> int:
    """Query rows of a block of K1's tensor-core kernel: 64, or at d = 192 and
    256 (the only widths built with two-warp blocks) 32 where blocks of 64
    rows, ceil(T / 64) for each of the ``bh`` (batch, head) pairs, would not
    give each of the card's ``sms`` SMs one."""
    if d <= 128 or -(-T // 64) * bh >= sms:
        return 64
    return 32


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_aligned(t: torch.Tensor, what: str) -> None:
    """The tensor-core kernels copy 16 bytes a ``cp.async``."""
    if t.data_ptr() % 16:
        raise ValueError(f"attention kernel needs {what} 16-byte aligned, got data_ptr() % 16 == {t.data_ptr() % 16}")


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
    if _use_mma(qkv.dtype, d):
        _check_aligned(qkv, "qkv")
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
    scale = 1.0 / math.sqrt(math.sqrt(d))
    if _use_mma(qkv.dtype, d):
        rows = fwd_q_rows(T, B * num_heads, d, _sm_count(qkv.device.index))
        rc = lib.gdc_attention_fwd_mma(
            qkv.data_ptr(), out.data_ptr(), B, T, num_heads, d, int(new_order), rows, scale, stream)
        build.check(rc, "gdc_attention_fwd_mma")
        attention_fwd_cuda.launches_mma += 1
    else:
        rc = lib.gdc_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), B, T, num_heads, d, int(new_order),
            _DTYPE_CODE[qkv.dtype], scale, stream,
        )
        build.check(rc, "gdc_attention_fwd")
    attention_fwd_cuda.launches += 1
    return out


attention_fwd_cuda.launches = 0
attention_fwd_cuda.launches_mma = 0  # those of ``launches`` that ran on the tensor cores


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
    mma = _use_mma(qkv.dtype, d)
    if mma:
        _check_aligned(do, "the cotangent")
    lib = build.load()
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((3, B * num_heads, T), dtype=torch.float32, device=qkv.device)
    scale = 1.0 / math.sqrt(math.sqrt(d))
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    if mma:
        rc = lib.gdc_attention_bwd_mma(
            qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
            B, T, num_heads, d, int(new_order), scale, scale * scale, stream,
        )
        build.check(rc, "gdc_attention_bwd_mma")
        attention_bwd_cuda.launches_mma += 1
    else:
        rc = lib.gdc_attention_bwd(
            qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
            B, T, num_heads, d, int(new_order), _DTYPE_CODE[qkv.dtype], scale, scale * scale, stream,
        )
        build.check(rc, "gdc_attention_bwd")
    attention_bwd_cuda.launches += 1
    return dqkv


attention_bwd_cuda.launches = 0
attention_bwd_cuda.launches_mma = 0  # those of ``launches`` that ran on the tensor cores


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
