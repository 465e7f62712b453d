"""Fused 3x3 conv of a bf16/f32 input, quantizing in the kernel: kernel K6.

Counterpart of ``guided_diffusion_clip_tpu/ops/pallas_conv.py::fused_conv3x3``,
in the same layout at the public surface: x NHWC ``(B, H, W, C)``, w HWIO
``(3, 3, C, K)``, stride 1, SAME padding, output ``(B, H, W, K)`` in x's dtype.

``quantized=True``: weights s8 per output channel, ``w_q = round(w / s_w)``
(quantized here, in PyTorch, as the JAX wrapper does outside its kernel);
activations s8 with one scale per (image, band of ``bh`` output rows),
``s = max(amax, 1e-8) / 127`` where amax spans the input rows
``[i*bh - 1, (i+2)*bh - 1)`` clipped to the image (both row blocks the TPU
kernel holds for band i), ``q = clip(round(x * (1/s)), -127, 127)``; s32 sums;
``out = acc * (s_x * s_w) + bias``. An output row is computed from inputs
quantized with ITS band's scale, so the rows next to a band edge are quantized
twice, once for each band. ``bh`` is therefore part of the function and
``_pick_tiles`` keeps the JAX package's rule for it.

``quantized=False``: x and w rounded to bf16, f32 sums, ``+ bias``.

On a CPU tensor ``fused_conv3x3`` is the plain version; on a CUDA tensor it is
the hand-written kernel (``csrc/conv_fused.cu``), or it raises. No model
dispatches it: ``tools/conv_bench.py`` is its entry point, as
``tools/pallas_conv_bench.py`` is the TPU kernel's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

_EPS = 1e-8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _pick_tiles(B: int, H: int, W: int, C: int, K: int):
    """The band height ``bh`` for a shape, or None if unsupported: the JAX
    package's rule (bands of at least 512 padded pixels where the image
    allows, ``H % bh == 0``). Its ``nb`` and ``bk`` are TPU tiling only."""
    if C % 128 or K % 128 or W % 8 or W < 16 or H < 2:
        return None
    bh = 2
    while bh * (W + 8) < 512 and bh * 2 <= H:
        bh *= 2
    if H % bh:
        return None
    return bh


def supports_shape(B: int, H: int, W: int, C: int, K: int) -> bool:
    return _pick_tiles(B, H, W, C, K) is not None


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127 by a true division, as the reference: PyTorch
    divides a CUDA tensor by a Python scalar as a product with its rounded
    reciprocal, which is off by an ulp now and then."""
    return amax.clamp(min=_EPS) / torch.full((), 127.0, dtype=torch.float32, device=amax.device)


def quantize_weights(w: torch.Tensor):
    """HWIO f32 weights -> (s8 values, per-output-channel scales (K,))."""
    wf = w.float()
    s_w = _scale_of(wf.abs().amax(dim=(0, 1, 2)))
    return torch.round(wf / s_w).clamp(-127, 127).to(torch.int8), s_w


def band_scales(x: torch.Tensor, bh: int) -> torch.Tensor:
    """(B, H // bh) activation scales of NHWC x."""
    B, H = x.shape[:2]
    rows = x.float().abs().amax(dim=(2, 3))  # (B, H)
    # 1 zero row on top, bh - 1 below: band i spans padded blocks i and i + 1
    blocks = F.pad(rows, (1, bh - 1)).reshape(B, H // bh + 1, bh).amax(dim=2)
    amax = torch.maximum(blocks[:, :-1], blocks[:, 1:])
    return _scale_of(amax)


def _oihw(w_hwio: torch.Tensor) -> torch.Tensor:
    return w_hwio.permute(3, 2, 0, 1)


def fused_conv3x3_plain(x, w, bias=None, *, quantized: bool = True):
    """Plain PyTorch version of K6 (the integer sums as an f32 conv of
    integer-valued tensors: exact while they stay under 2^24)."""
    B, H, W, C = x.shape
    K = w.shape[-1]
    bh = _pick_tiles(B, H, W, C, K)
    if bh is None:
        raise ValueError(f"unsupported fused-conv shape {tuple(x.shape)} -> {K}")
    b = None if bias is None else bias.float()
    if not quantized:
        y = F.conv2d(
            x.bfloat16().float().permute(0, 3, 1, 2), _oihw(w.float().bfloat16().float()), b, padding=1
        )
        return y.permute(0, 2, 3, 1).to(x.dtype)
    w_q, s_w = quantize_weights(w)
    s_x = band_scales(x, bh)  # (B, nb)
    nb = H // bh
    # every band's input window, rows [i*bh - 1, i*bh + bh + 1) of the zero-padded image
    win = F.pad(x.float(), (0, 0, 0, 0, 1, 1)).unfold(1, bh + 2, bh)  # (B, nb, W, C, bh + 2)
    inv = (1.0 / s_x).reshape(B, nb, 1, 1, 1)
    q = torch.round(win * inv).clamp(-127, 127)
    acc = F.conv2d(
        q.permute(0, 1, 3, 4, 2).reshape(B * nb, C, bh + 2, W), _oihw(w_q.float()), padding=(0, 1)
    )  # (B * nb, K, bh, W)
    acc = acc.reshape(B, nb, K, bh, W).permute(0, 1, 3, 4, 2)  # (B, nb, bh, W, K)
    y = acc * (s_x.reshape(B, nb, 1, 1, 1) * s_w)
    if b is not None:
        y = y + b
    return y.reshape(B, H, W, K).to(x.dtype)


def fused_conv3x3_cuda(x, w, bias=None, *, quantized: bool = True):
    """Kernel K6 on a CUDA tensor; raises on what the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv3x3 kernel needs a CUDA tensor, got one on {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_conv3x3 kernel takes float32 or bfloat16 x, got {x.dtype}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"fused_conv3x3: x {tuple(x.shape)} and HWIO w {tuple(w.shape)} do not match")
    if x.requires_grad or w.requires_grad:
        raise ValueError("fused_conv3x3 kernel has no backward: detach its inputs")
    B, H, W, C = x.shape
    K = w.shape[-1]
    bh = _pick_tiles(B, H, W, C, K)
    if bh is None:
        raise ValueError(f"unsupported fused-conv shape {tuple(x.shape)} -> {K}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_conv3x3 kernel needs x contiguous (B, H, W, C) and 16-byte aligned")
    dev = x.device
    w = w.to(dev)
    if quantized:
        w_q, s_w = quantize_weights(w)
        rows = w_q.permute(3, 0, 1, 2).reshape(K, 9 * C).contiguous()
        s_w = s_w.contiguous()
        scales = torch.empty((B, H // bh), dtype=torch.float32, device=dev)
    else:
        rows = w.float().bfloat16().permute(3, 0, 1, 2).reshape(K, 9 * C).contiguous()
        s_w = scales = None
    b = None if bias is None else bias.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((B, H, W, K), dtype=x.dtype, device=dev)
    rc = build.load().gdc_conv_fused(
        x.data_ptr(), rows.data_ptr(), None if scales is None else scales.data_ptr(),
        None if s_w is None else s_w.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
        B, H, W, C, K, bh, int(quantized), _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(rc, "gdc_conv_fused")
    fused_conv3x3_cuda.launches += 1
    return out


fused_conv3x3_cuda.launches = 0


def fused_conv3x3(x, w, bias=None, *, quantized: bool = True):
    """``conv3x3_same(x, w) + bias`` in one fused pass: x (B, H, W, C) f32 or
    bf16, w (3, 3, C, K) f32, bias (K,) or None; returns (B, H, W, K) in x's
    dtype. The plain version on the CPU, K6 on CUDA. Check ``supports_shape``
    before calling."""
    if x.device.type == "cpu":
        return fused_conv3x3_plain(x, w, bias, quantized=quantized)
    if x.device.type == "cuda":
        return fused_conv3x3_cuda(x, w, bias, quantized=quantized)
    raise ValueError(f"fused_conv3x3: no implementation for device {x.device}")
