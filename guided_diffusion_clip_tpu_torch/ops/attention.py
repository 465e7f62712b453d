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
hand-written kernel K1 (``csrc/attention_fwd.cu``), or raises.

Kernel K1 replaces ``guided_diffusion_clip_tpu/ops/pallas_attention.py::
_attn_kernel``. On the H100 it is compute-bound (4*T*T*d FLOPs per head
against 4*T*d elements moved); this first version runs on the f32 FMA pipes
with an online softmax over K/V tiles, so shared memory stays O(tile*d)
where the TPU kernel held a whole head's K/V in VMEM. See the source's header
for the design.
"""

from __future__ import annotations

import math

import torch

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


def attention_fwd_cuda(qkv: torch.Tensor, num_heads: int, *, new_order: bool = False) -> torch.Tensor:
    """Launch kernel K1 on a CUDA (B, T, 3C) tensor; raises on what it does not take."""
    if qkv.requires_grad:
        raise NotImplementedError("attention backward: slice 2")
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"attention kernel takes float32 or bfloat16, got {qkv.dtype}")
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError(f"attention kernel needs a contiguous (B, T, 3C) tensor, got {tuple(qkv.shape)}")
    B, T, W = qkv.shape
    if W % (3 * num_heads):
        raise ValueError(f"qkv width {W} not divisible by 3*{num_heads}")
    d = W // (3 * num_heads)
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel has no instantiation for head dim {d} (has {KERNEL_HEAD_DIMS})")
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


def attention(qkv: torch.Tensor, num_heads: int, *, new_order: bool = False) -> torch.Tensor:
    """Dispatching entry point used by the models: plain on CPU, K1 on CUDA."""
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, num_heads, new_order=new_order)
    if qkv.device.type == "cuda":
        return attention_fwd_cuda(qkv, num_heads, new_order=new_order)
    raise ValueError(f"attention: no implementation for device {qkv.device}")
