"""T accumulating (512 x 2048) @ (2048 x 512) products: kernel K7.

Counterpart of ``tools/pallas_mxu_ceiling.py::make``: ``accumulating_dots(x,
w, T)`` is the sum over T repeats of ``x @ w``, for s8 operands with an s32
sum and for bf16 operands with an f32 sum. ``tools/mxu_ceiling.py`` times it
at two values of T and reads the tensor cores' rate from the slope.

The s32 sum wraps around by design (one product's entries reach 2048 * 127^2,
about 3.3e7, so a few dozen repeats pass 2^31): the kernel's ``mma.sync``
accumulates modulo 2^32, and the plain version computes the exact sum and
reduces it modulo 2^32, so the two agree bit for bit at every T.

On a CPU tensor ``accumulating_dots`` is the plain version; on a CUDA tensor
it is the hand-written kernel (``csrc/mma_probe.cu``), or it raises.
"""

from __future__ import annotations

import torch

from . import build

BM, BK, BN = 512, 2048, 512
SPLIT = 8  # reduction slices of the kernel, one partial sum each
_DTYPE_CODE = {torch.int8: 0, torch.bfloat16: 1}


def _check(x, w, T):
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"accumulating_dots takes int8 or bfloat16 operands, got {x.dtype} and {w.dtype}")
    if tuple(x.shape) != (BM, BK) or tuple(w.shape) != (BK, BN):
        raise ValueError(f"accumulating_dots takes ({BM}, {BK}) @ ({BK}, {BN}), got {tuple(x.shape)} @ {tuple(w.shape)}")
    if int(T) < 1:
        raise ValueError(f"T must be >= 1, got {T}")


def accumulating_dots_plain(x, w, T: int):
    """Plain PyTorch version of K7. s8: the exact product in f64 (entries
    below 2^53), times T in int64, reduced modulo 2^32 to int32. bf16: the
    f64 product times T, rounded once to f32 (the kernel rounds at every
    accumulation, so it agrees only to f32 accumulation error)."""
    _check(x, w, T)
    p = x.double() @ w.double()
    if x.dtype == torch.int8:
        total = p.to(torch.int64) * int(T)
        return (((total + 2**31) % 2**32) - 2**31).to(torch.int32)
    return (p * int(T)).float()


def accumulating_dots_cuda(x, w, T: int):
    """Kernel K7 on CUDA tensors; raises on what the kernel does not take."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"accumulating_dots kernel needs CUDA tensors on one device, got {x.device} and {w.device}")
    _check(x, w, T)
    xc = x.contiguous()
    wt = w.t().contiguous()  # a column's reduction run contiguous, as the B fragments want it
    acc = torch.int32 if x.dtype == torch.int8 else torch.float32
    partial = torch.empty((SPLIT, BM, BN), dtype=acc, device=x.device)  # the reduction slices' sums
    out = torch.empty((BM, BN), dtype=acc, device=x.device)
    rc = build.load().gdc_mma_probe(
        xc.data_ptr(), wt.data_ptr(), partial.data_ptr(), out.data_ptr(), int(T), _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "gdc_mma_probe")
    accumulating_dots_cuda.launches += 1
    return out


accumulating_dots_cuda.launches = 0


def accumulating_dots(x, w, T: int):
    """Sum over T repeats of ``x @ w``: x (512, 2048), w (2048, 512), both s8
    (s32 out, wrapping) or bf16 (f32 out). Plain on the CPU, K7 on CUDA."""
    if x.device.type == "cpu":
        return accumulating_dots_plain(x, w, T)
    if x.device.type == "cuda":
        return accumulating_dots_cuda(x, w, T)
    raise ValueError(f"accumulating_dots: no implementation for device {x.device}")
