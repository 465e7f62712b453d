"""Dynamic int8 convolution: the ``--conv_impl int8`` path.

Counterpart of ``guided_diffusion_clip_tpu/ops/quant.py``, in the same
layout at the public surface: activations are NHWC ``(B, H, W, C)``, conv
weights HWIO ``(kh, kw, C, K)``, convs pad symmetrically by ``(k - 1) // 2``.

Scheme (weight per output channel, activation per tensor or per image,
symmetric):
    w_q[..., o] = round(w[..., o] / s_w[o]),   s_w[o] = max|w[..., o]| / 127
    x_q         = round(x / s_x),              s_x    = max|x| / 127
    y           = conv_s8(x_q, w_q) * s_w * s_x + b

``conv_s8`` is the s8 x s8 -> s32 convolution with the dequantizing
epilogue. On a CPU tensor it is the plain version, the JAX package's CPU
emulation: an f32 conv of the integer-valued tensors (products are exact,
sums round once they pass 2^24). On a CUDA tensor it is the hand-written
kernel K5, or it raises: PyTorch has no int8 convolution on CUDA. K5 runs
on the tensor cores, in one of three kernels picked by shape with no
setting: layers with C % 16 == 0 and K > 16 run ``csrc/conv_s8_mma.cu``
(counted in ``conv_s8_cuda.launches_mma`` as well as ``launches``;
``pick_tile`` chooses the block tile and the split of the reduction for
layers with few pixels); the thin layers (``uses_thin_kernel``) run the two
kernels of ``csrc/conv_s8_thin.cu`` (counted in ``launches_thin``): the
stems, 3 or 6 channels in, and the heads, 3 or 6 channels out. The
``__dp4a`` kernel (``csrc/conv_s8.cu``) is on no model's path: it is the
yardstick the others are held to bit for bit (``conv_s8_dp4a``), and it
runs what neither takes (a stride-2 stem, say). All give the same bits.
Kernel K5 replaces ``guided_diffusion_clip_tpu/ops/pallas_conv.py::fused_conv3x3_s8``
(and, on the TPU, XLA's s8 conv, which the JAX package's ``conv_prequant``
and ``int8_conv`` call, and which takes the stems and heads there).

``int8_conv``'s per-tensor quantize is ``quantize_per_tensor`` on the CPU and
two hand-written passes on CUDA (``csrc/quantize.cu``: an absmax reduction,
then one pass that reads x once and writes s8, the scale and the conv's
dequantizing factors ``s_x * s_w``). It has no TPU kernel behind it: XLA
fuses that pass on the TPU. Under spatial partitioning (``parallel/sp.py``)
the scale is that of the tensor the data group holds: the two passes run
apart (``absmax``, ``quantize_given``) with an all-reduce MAX of the amax
over the space group between them.

``int8_conv`` and ``conv_prequant`` are autograd Functions with the JAX
package's straight-through backwards: ``int8_conv`` differentiates the f32
conv at the original x and w; ``conv_prequant`` differentiates a bf16 conv
at ``q * s_img`` (``s_img`` is stop-gradient). Neither backward is a TPU
kernel, so both are convolutions in PyTorch (cuDNN on the card).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..parallel import sp
from . import build

_EPS = 1e-8
# the operand type of conv_prequant's straight-through backward convs, as the
# JAX package's (full-rate tensor cores)
_STE_DTYPE = torch.bfloat16
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMS = 132       # the H100's streaming multiprocessors
_FILL = 99       # blocks that count as filling them: three quarters (tools/conv_tune.py: 128 unsplit beat 256 split)
_STAGE = 64      # reduction bytes of one stage of the tensor-core kernel (csrc/conv_mma.cuh, kBK)
_MIN_SLICE = 32  # stages: a shorter slice does not pay for the zeroing, the atomics and the second kernel
_TILE_N = 128    # output channels of a block's tile (kBN)


def quantize_per_tensor(x: torch.Tensor):
    """Symmetric per-tensor int8: (values s8, scale f32 scalar tensor)."""
    xf = x.float()
    scale = xf.abs().amax().clamp(min=_EPS) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127)
    return q.to(torch.int8), scale


def _check_quantize(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the quantize kernels need a CUDA tensor, got one on {x.device}")
    if x.dtype not in _OUT_CODE:
        raise TypeError(f"the quantize kernels take float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16 or x.numel() == 0:
        raise ValueError("the quantize kernels need a non-empty contiguous, 16-byte aligned tensor")


def _absmax(x: torch.Tensor) -> torch.Tensor:
    """``gdc_absmax`` on a checked tensor: the amax word, (1,) int32."""
    bits = torch.zeros(1, dtype=torch.int32, device=x.device)
    rc = build.load().gdc_absmax(x.data_ptr(), x.numel(), bits.data_ptr(), _OUT_CODE[x.dtype],
                                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "gdc_absmax")
    return bits


def _quantize_given(x: torch.Tensor, amax_bits: torch.Tensor, s_w: torch.Tensor | None):
    """``gdc_quantize_given`` on a checked tensor: (q, s_x, factors)."""
    dev = x.device
    q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    s_x = torch.empty((), dtype=torch.float32, device=dev)
    factors = None
    if s_w is not None:
        s_w = s_w.to(device=dev, dtype=torch.float32).contiguous()
        factors = torch.empty_like(s_w)
    rc = build.load().gdc_quantize_given(
        x.data_ptr(), x.numel(), amax_bits.data_ptr(), q.data_ptr(), s_x.data_ptr(),
        None if s_w is None else s_w.data_ptr(), None if s_w is None else factors.data_ptr(),
        0 if s_w is None else s_w.numel(), _OUT_CODE[x.dtype], torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(rc, "gdc_quantize_given")
    return q, s_x, factors


def quantize_per_tensor_cuda(x: torch.Tensor, s_w: torch.Tensor | None = None):
    """``quantize_per_tensor`` on a CUDA tensor by the two kernels of
    ``csrc/quantize.cu`` back to back: (values s8, scale f32 scalar tensor,
    factors). With ``s_w`` (K,) f32, ``factors`` is ``scale * s_w``, written
    by the second kernel; else None. x float32 or bfloat16, contiguous,
    16-byte aligned; raises on anything else. Counted here, not in the
    split passes' counts."""
    _check_quantize(x)
    out = _quantize_given(x, _absmax(x), s_w)
    quantize_per_tensor_cuda.launches += 1
    return out


quantize_per_tensor_cuda.launches = 0


def absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the first quantize pass: max |x| (f32 scalar tensor)."""
    return x.float().abs().amax()


def absmax_cuda(x: torch.Tensor) -> torch.Tensor:
    """The first quantize kernel alone on a CUDA tensor: max |x| as the bits
    of the f32 value in a (1,) int32 tensor (non-negative floats order as
    their bits, so a MAX over ranks takes it as it is)."""
    _check_quantize(x)
    bits = _absmax(x)
    absmax_cuda.launches += 1
    return bits


absmax_cuda.launches = 0


def quantize_given_plain(x: torch.Tensor, amax: torch.Tensor):
    """Plain version of the second pass: ``quantize_per_tensor`` with the
    amax given: (values s8, scale f32 scalar tensor)."""
    scale = amax.float().reshape(()).clamp(min=_EPS) / 127.0
    q = torch.round(x.float() / scale).clamp(-127, 127)
    return q.to(torch.int8), scale


def quantize_given_cuda(x: torch.Tensor, amax_bits: torch.Tensor, s_w: torch.Tensor | None = None):
    """The second quantize kernel alone on a CUDA tensor, from an amax word
    (``absmax_cuda``'s, all-reduced): (values s8, scale, factors) as
    ``quantize_per_tensor_cuda``'s."""
    _check_quantize(x)
    out = _quantize_given(x, amax_bits, s_w)
    quantize_given_cuda.launches += 1
    return out


quantize_given_cuda.launches = 0


def quantize_per_out_channel(w: torch.Tensor):
    """Symmetric per-output-channel int8 over the last axis of HWIO weights:
    (values s8 in w's layout, scales f32 (K,))."""
    wf = w.float()
    scale = wf.abs().amax(dim=tuple(range(w.dim() - 1))).clamp(min=_EPS) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127)
    return q.to(torch.int8), scale


def conv_s8_plain(q, w_q, s_img, s_w, bias, stride: int, out_dtype):
    """Plain PyTorch version of K5: an f32 conv of the integer values, then
    ``acc * s_w * s_img + bias`` in f32 (``s_img`` None: no per-image
    factor), cast to ``out_dtype``. NHWC in and out."""
    kh = w_q.shape[0]
    p = (kh - 1) // 2
    acc = F.conv2d(
        q.float().permute(0, 3, 1, 2), w_q.float().permute(3, 2, 0, 1), stride=stride, padding=p,
    ).permute(0, 2, 3, 1)
    y = acc * s_w
    if s_img is not None:
        y = y * s_img.reshape(-1, 1, 1, 1)
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def _pack_weights(w_q: torch.Tensor) -> torch.Tensor:
    """HWIO s8 weights as the kernel's (K, KRp) rows: each output channel's
    (kh, kw, C) taps in order, zero-padded to a multiple of 32 bytes. A view
    (no copy) when ``w_q`` is an HWIO view of OHWI memory and kh*kw*C is a
    multiple of 32."""
    K = w_q.shape[-1]
    rows = w_q.permute(3, 0, 1, 2).reshape(K, -1)
    pad = -rows.shape[1] % 32
    if pad:
        rows = F.pad(rows, (0, pad))
    return rows.contiguous()


def uses_tensor_cores(C: int, K: int, ks: int) -> bool:
    """Whether K5 runs a (ks, ks, C, K) conv on the tensor cores: a 16-byte
    copy must lie inside one tap's channels, a tile of 128 output channels
    must be worth filling, and a pixel's taps are one bit each of a word."""
    return C % 16 == 0 and K > 16 and ks * ks <= 25


def uses_thin_kernel(C: int, K: int, ks: int, stride: int):
    """Which kernel of ``csrc/conv_s8_thin.cu`` runs a (ks, ks, C, K) conv
    at ``stride``, or None: ``"stem"`` where the tensor-core kernel does not
    and a pixel's reduction is one or two 32-byte steps (the stems, 3 or 6
    channels in at 3x3) with whole 8-channel mma tiles out; ``"head"`` where
    a 16-byte copy lies inside one tap and one 8-channel tile holds every
    output (the heads, 3 or 6 channels out, at 3x3 and 1x1). Stride 1 only."""
    if stride != 1:
        return None
    if not uses_tensor_cores(C, K, ks) and ks * ks * C <= 64 and K % 8 == 0:
        return "stem"
    if C % 16 == 0 and K <= 8 and ks in (1, 3):
        return "head"
    return None


def stem_taps(C: int, ks: int, W: int) -> list:
    """The stem kernel's table of a pixel's reduction bytes, as ``_pack_weights``
    orders them: for byte j < ks*ks*C, tap (ky, kx) = divmod(j // C, ks) and
    channel c = j % C, the entry ``(offset << 8) | (ky << 4) | kx`` with
    ``offset = (ky * W + kx - pad) * C + c`` bytes from the NHWC byte
    ``((oy - pad) * W + ox) * C`` of output pixel (oy, ox) of a W-wide
    image; the tap lies in the image where 0 <= oy - pad + ky < H and
    0 <= ox - pad + kx < W. Bytes past ks*ks*C, up to the next multiple of
    32, are zeros: ky = kx = 15, which no image row or column holds."""
    pad = (ks - 1) // 2
    KR = ks * ks * C
    out = []
    for j in range(-(-KR // 32) * 32):
        if j >= KR:
            out.append((15 << 4) | 15)
            continue
        tap, c = divmod(j, C)
        ky, kx = divmod(tap, ks)
        out.append((((ky * W + kx - pad) * C + c) << 8) | (ky << 4) | kx)
    return out


@functools.lru_cache(maxsize=64)
def _stem_taps_host(C: int, ks: int, W: int):
    """``stem_taps`` as the C array the kernel's entry point copies (kept alive here)."""
    taps = stem_taps(C, ks, W)
    return (ctypes.c_int * len(taps))(*taps)


def pick_tile(M: int, K: int, KRp: int):
    """(rows of a block's tile, slices of the reduction) for the tensor-core
    kernel on M output pixels, K output channels and KRp reduction bytes:
    128 x 128 tiles where they fill the card (``_FILL`` blocks), else 64-row
    tiles, else 64-row tiles with the reduction split so that a block per SM
    runs, in slices of at least ``_MIN_SLICE`` stages. ``split_ranges`` says
    which bytes a slice takes."""
    n_tiles = -(-K // _TILE_N)
    for bm in (128, 64):
        if -(-M // bm) * n_tiles >= _FILL:
            return bm, 1
    blocks = -(-M // 64) * n_tiles
    stages = -(-KRp // _STAGE)
    split = max(1, min(-(-_SMS // blocks), stages // _MIN_SLICE))
    return 64, -(-stages // (stages // split))  # equal slices, none empty


def split_ranges(KRp: int, split: int):
    """The [begin, end) reduction bytes of each of ``split`` slices, as the
    kernel cuts them: whole 64-byte stages, equal but for the last."""
    stages = -(-KRp // _STAGE)
    per = -(-stages // split)
    return [(z * per * _STAGE, min(KRp, (z + 1) * per * _STAGE)) for z in range(split)]


def _conv_s8_launch(q, w_q, s_img, s_w, bias, stride: int, out_dtype, rows, kernel: str):
    """Check the operands of K5 and launch ``kernel``: "mma" (``conv_s8_mma.cu``),
    "stem" or "head" (``conv_s8_thin.cu``) or "dp4a" (``conv_s8.cu``); raises
    on what the kernel does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"conv_s8 kernel needs a CUDA tensor, got one on {q.device}")
    if q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"conv_s8 kernel takes int8 q and w_q, got {q.dtype} and {w_q.dtype}")
    if out_dtype not in _OUT_CODE:
        raise TypeError(f"conv_s8 kernel writes float32 or bfloat16, not {out_dtype}")
    if q.dim() != 4 or w_q.dim() != 4 or w_q.shape[2] != q.shape[3] or w_q.shape[0] != w_q.shape[1]:
        raise ValueError(f"conv_s8: q {tuple(q.shape)} and HWIO w_q {tuple(w_q.shape)} do not match")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("conv_s8 kernel needs q contiguous (B, H, W, C) and 16-byte aligned")
    B, H, W, C = q.shape
    kh, K = w_q.shape[0], w_q.shape[-1]
    p = (kh - 1) // 2
    Ho, Wo = (H + 2 * p - kh) // stride + 1, (W + 2 * p - kh) // stride + 1
    dev = q.device
    if rows is None:
        rows = _pack_weights(w_q.to(dev))
    KRp = -(-kh * kh * C // 32) * 32
    if (rows.dtype != torch.int8 or rows.device != dev or tuple(rows.shape) != (K, KRp)
            or not rows.is_contiguous() or rows.data_ptr() % 16):
        raise ValueError(f"conv_s8: packed weight rows {tuple(rows.shape)} {rows.dtype} on {rows.device} are not "
                         f"the contiguous, 16-byte aligned ({K}, {KRp}) int8 rows of w_q on {dev}")
    sw = s_w.to(device=dev, dtype=torch.float32).contiguous()
    si = None if s_img is None else s_img.to(device=dev, dtype=torch.float32).reshape(B).contiguous()
    b = None if bias is None else bias.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((B, Ho, Wo, K), dtype=out_dtype, device=dev)
    ptrs = (q.data_ptr(), rows.data_ptr(), None if si is None else si.data_ptr(), sw.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr())
    dims = (B, H, W, C, K, kh, stride, p, Ho, Wo, KRp, _OUT_CODE[out_dtype])
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kernel == "mma":
        M = B * Ho * Wo
        bm, split = pick_tile(M, K, KRp)
        # a split launch adds its s32 partial sums into zeroed scratch
        scratch = torch.zeros((M, K), dtype=torch.int32, device=dev) if split > 1 else None
        rc = build.load().gdc_conv_s8_mma(
            *ptrs, None if scratch is None else scratch.data_ptr(), *dims, bm, split, stream)
        build.check(rc, "gdc_conv_s8_mma")
    elif kernel in ("stem", "head"):
        if stride != 1:  # the kernels write (B, H, W, K)
            raise ValueError(f"conv_s8: the thin kernels take stride 1, not {stride}")
        taps = _stem_taps_host(C, kh, W) if kernel == "stem" else None
        rc = build.load().gdc_conv_s8_thin(*ptrs, B, H, W, C, K, kh, KRp, _OUT_CODE[out_dtype],
                                           int(kernel == "head"), taps, stream)
        build.check(rc, "gdc_conv_s8_thin")
    else:
        rc = build.load().gdc_conv_s8(*ptrs, *dims, stream)
        build.check(rc, "gdc_conv_s8")
    return out


def conv_s8_cuda(q, w_q, s_img, s_w, bias, stride: int, out_dtype, rows=None):
    """Kernel K5 on CUDA tensors: q (B, H, W, C) s8 contiguous, w_q
    (kh, kw, C, K) s8, s_img (B,) f32 or None, s_w (K,) f32, bias (K,) or
    None; symmetric (kh - 1) // 2 padding. ``rows``: ``_pack_weights(w_q)``
    where the caller has it cached, else packed here. Output (B, Ho, Wo, K)
    in ``out_dtype`` (f32 or bf16). The shape picks the kernel: the
    tensor-core kernel where ``uses_tensor_cores``, else a thin kernel where
    ``uses_thin_kernel``, else ``__dp4a``. Raises on what the kernel does
    not take."""
    kernel = "dp4a"
    if q.dim() == 4 and w_q.dim() == 4:
        C, K, ks = q.shape[3], w_q.shape[3], w_q.shape[0]
        kernel = "mma" if uses_tensor_cores(C, K, ks) else uses_thin_kernel(C, K, ks, stride) or "dp4a"
    out = _conv_s8_launch(q, w_q, s_img, s_w, bias, stride, out_dtype, rows, kernel)
    conv_s8_cuda.launches += 1
    conv_s8_cuda.launches_mma += int(kernel == "mma")
    conv_s8_cuda.launches_thin += int(kernel in ("stem", "head"))
    return out


conv_s8_cuda.launches = 0
conv_s8_cuda.launches_mma = 0   # those of ``launches`` that ran conv_s8_mma.cu
conv_s8_cuda.launches_thin = 0  # those that ran conv_s8_thin.cu (the stems and heads)


def conv_s8_dp4a(q, w_q, s_img, s_w, bias, stride: int, out_dtype, rows=None):
    """K5's ``__dp4a`` kernel whatever the shape: what the tensor-core
    kernels (``conv_s8_mma.cu``, ``conv_s8_thin.cu``) are held to, bit for
    bit (exact sums, the same epilogue). On no model's path and not counted."""
    return _conv_s8_launch(q, w_q, s_img, s_w, bias, stride, out_dtype, rows, "dp4a")


def conv_s8(q, w_q, s_img, s_w, bias=None, stride: int = 1, out_dtype=torch.float32, rows=None):
    """``conv(q, w_q) * s_w * s_img + bias`` with an s32-exact product:
    the plain version on the CPU, K5 on CUDA. q (B, H, W, C) s8, w_q HWIO
    s8; ``s_img`` (B,) per-image scales or None; ``rows``: the kernel's
    packed weight rows where the caller has them (unused on the CPU)."""
    if q.device.type == "cpu":
        return conv_s8_plain(q, w_q, s_img, s_w, bias, stride, out_dtype)
    if q.device.type == "cuda":
        return conv_s8_cuda(q, w_q, s_img, s_w, bias, stride, out_dtype, rows)
    raise ValueError(f"conv_s8: no implementation for device {q.device}")


def _oihw(w_hwio: torch.Tensor) -> torch.Tensor:
    return w_hwio.permute(3, 2, 0, 1)


def _int8_conv_fwd(x, w_q, s_w, bias, stride, rows=None):
    if sp.sharded():  # the data group's scale: the amax all-reduced between the two passes
        if x.device.type == "cuda":
            bits = sp.reduce_max_(absmax_cuda(x))
            x_q, _, factors = quantize_given_cuda(x, bits, s_w)
        else:
            x_q, s_x = quantize_given_plain(x, sp.reduce_max_(absmax_plain(x)))
            factors = s_x * s_w
    elif x.device.type == "cuda":  # the quantize kernels, which also write s_x * s_w
        x_q, _, factors = quantize_per_tensor_cuda(x, s_w)
    else:
        x_q, s_x = quantize_per_tensor(x)
        factors = s_x * s_w
    return conv_s8(x_q, w_q, None, factors, bias, stride, x.dtype, rows)


class Int8ConvFunction(torch.autograd.Function):
    """``int8_conv``: quantize x per tensor, K5 (plain on the CPU) with
    ``s_w * s_x`` folded into one per-channel factor as the JAX package
    computes ``acc * (s_x * s_w)``, then ``+ bias``, in x's dtype. Backward:
    the f32 conv's VJP at the original x and w (straight-through)."""

    @staticmethod
    def forward(ctx, x, w, bias, w_q, s_w, stride, rows=None):
        ctx.save_for_backward(x, w, bias)
        ctx.stride = stride
        return _int8_conv_fwd(x, w_q, s_w, bias, stride, rows)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        p = (w.shape[0] - 1) // 2
        g32 = g.float().permute(0, 3, 1, 2)
        xs = x.permute(0, 3, 1, 2)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(
                xs.shape, _oihw(w).float(), g32, stride=ctx.stride, padding=p,
            ).permute(0, 2, 3, 1).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(
                xs.float(), _oihw(w).shape, g32, stride=ctx.stride, padding=p,
            ).permute(2, 3, 1, 0).to(w.dtype)
        if bias is not None and ctx.needs_input_grad[2]:
            db = g32.sum((0, 2, 3)).to(bias.dtype)
        return dx, dw, db, None, None, None, None


def int8_conv(x, w, bias=None, stride: int = 1, *, w_q=None, s_w=None, rows=None):
    """Quantized NHWC conv of x with HWIO f32 weights w, plus bias, in x's
    dtype. Differentiable (STE). ``w_q``/``s_w``: w's quantization when the
    caller has it cached (``quantize_per_out_channel(w)`` otherwise), and
    ``rows`` the kernel's packed rows of that ``w_q``."""
    if w_q is None:
        w_q, s_w = quantize_per_out_channel(w)
        rows = None
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, bias)):
        return Int8ConvFunction.apply(x, w, bias, w_q, s_w, stride, rows)
    return _int8_conv_fwd(x, w_q, s_w, bias, stride, rows)


class ConvPrequantFunction(torch.autograd.Function):
    """``conv_prequant`` on an integer-valued float q (the quantizing
    GroupNorm's differentiable emission). Backward (straight-through, as the
    JAX package): the VJP of ``conv((q * s_img).bf16, w.bf16) + b`` in bf16;
    ``s_img`` is stop-gradient."""

    @staticmethod
    def forward(ctx, q, s_img, w, bias, w_q, s_w, stride, out_dtype, rows=None):
        y = conv_s8(q.to(torch.int8), w_q, s_img, s_w, bias, stride, out_dtype, rows)
        ctx.save_for_backward(q, s_img, w)
        ctx.stride, ctx.has_bias = stride, bias is not None
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, s_img, w = ctx.saved_tensors
        p = (w.shape[0] - 1) // 2
        gb = g.to(_STE_DTYPE).permute(0, 3, 1, 2)
        s4 = s_img.reshape(-1, 1, 1, 1)
        dq = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(
                (q.shape[0], q.shape[3], q.shape[1], q.shape[2]), _oihw(w).to(_STE_DTYPE), gb,
                stride=ctx.stride, padding=p,
            )
            dq = (dx.float().permute(0, 2, 3, 1) * s4).to(q.dtype)
        if ctx.needs_input_grad[2]:
            xb = (q.float() * s4).to(_STE_DTYPE).permute(0, 3, 1, 2)
            dw = torch.nn.grad.conv2d_weight(
                xb, _oihw(w).shape, gb, stride=ctx.stride, padding=p,
            ).permute(2, 3, 1, 0).to(w.dtype)
        if ctx.has_bias and ctx.needs_input_grad[3]:
            db = gb.sum((0, 2, 3)).to(torch.float32)
        return dq, None, dw, db, None, None, None, None, None


def conv_prequant(q, s_img, w, bias=None, stride: int = 1, out_dtype=torch.float32, *, w_q=None, s_w=None,
                  rows=None):
    """``conv(q, w) * s_w * s_img + bias`` in int8: q (B, H, W, C) from a
    quantizing GroupNorm (real s8, or integer-valued float when gradients
    flow), ``s_img`` (B,) its per-image scales, w HWIO f32. Output in
    ``out_dtype`` (the module's compute dtype, as the JAX package casts).
    ``rows``: the kernel's packed rows of a cached ``w_q``."""
    if w_q is None:
        w_q, s_w = quantize_per_out_channel(w)
        rows = None
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, w, bias)):
        return ConvPrequantFunction.apply(q, s_img, w, bias, w_q, s_w, stride, out_dtype, rows)
    return conv_s8(q.to(torch.int8), w_q, s_img, s_w, bias, stride, out_dtype, rows)
