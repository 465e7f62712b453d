"""Build the port's CUDA kernels (``ops/csrc/*.cu``) at first use.

Each ``.cu`` source compiles in its own ``nvcc`` process, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). The library is cached under ``build/gdc_torch_kernels/`` at the root
of the checkout, keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the cached file.

Every C entry point returns the ``cudaError_t`` of its launch (0 = launched);
``check`` turns anything else into an exception. A failed build or load
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "gdc_torch_kernels",
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes, one entry per extern "C" function in csrc/
_SIGNATURES = {
    # qkv, out, B, T, H, D, new_order, dtype, scale, stream
    "gdc_attention_fwd": [_P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    # qkv, dout, dqkv, stats, B, T, H, D, new_order, dtype, scale, scale2, stream
    "gdc_attention_bwd": [_P] * 4 + [_I] * 6 + [ctypes.c_float] * 2 + [_P],
    # the bf16 tensor-core kernels: as the two above, without the dtype; the forward with the
    # query rows of a block (q_rows) before the scale
    "gdc_attention_fwd_mma": [_P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    "gdc_attention_bwd_mma": [_P] * 4 + [_I] * 5 + [ctypes.c_float] * 2 + [_P],
    # the float32 tensor-core kernels: the forward as the bf16 one (q_rows from f32_rows); the backward with
    # the stationary rows of a block (rows, from f32_bwd_rows) after new_order
    "gdc_attention_fwd_f32mma": [_P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    "gdc_attention_bwd_f32mma": [_P] * 4 + [_I] * 6 + [ctypes.c_float] * 2 + [_P],
    # x, slots, gamma, beta, ss, sb, stats, y, B, HW, C, G, eps, silu, vec, dtype, grid, chunks,
    # n_chunks, ng, stream
    "gdc_group_norm": [_P] * 8 + [_I] * 4 + [ctypes.c_float] + [_I] * 4 + [_P, _I, _I, _P],
    # x, slots, gamma, beta, ss, sb, stats, scales, q, B, HW, C, G, eps, silu, vec, dtype, s8, grid,
    # chunks, n_chunks, ng, stream
    "gdc_group_norm_quant": [_P] * 9 + [_I] * 4 + [ctypes.c_float] + [_I] * 5 + [_P, _I, _I, _P],
    # the split entries (spatial partitioning): x, sums, ext, B, HW, C, G, dtype, stream
    "gdc_group_norm_stats": [_P] * 3 + [_I] * 5 + [_P],
    # x, a, b, y, B, HW, C, silu, dtype, stream
    "gdc_group_norm_apply": [_P] * 4 + [_I] * 5 + [_P],
    # x, a, b, inv, q, B, HW, C, silu, dtype, s8, stream
    "gdc_group_norm_quant_apply": [_P] * 5 + [_I] * 6 + [_P],
    # quant, dtype, s8, vec, silu, C, G, ng, &blocks
    "gdc_group_norm_blocks": [_I] * 8 + [_P],
    # q, w, s_img, s_w, bias, out, B, H, W, C, K, ksize, stride, pad, Ho, Wo, KRp, out_dtype, stream
    "gdc_conv_s8": [_P] * 6 + [_I] * 12 + [_P],
    # the tensor-core kernel: q, w, s_img, s_w, bias, out, scratch, B, H, W, C, K, ksize, stride, pad, Ho,
    # Wo, KRp, out_dtype, bm, split, stream
    "gdc_conv_s8_mma": [_P] * 7 + [_I] * 14 + [_P],
    # the thin kernels (stems, heads): q, w, s_img, s_w, bias, out, B, H, W, C, K, ksize, KRp, out_dtype, kind,
    # taps (host), stream
    "gdc_conv_s8_thin": [_P] * 6 + [_I] * 9 + [_P, _P],
    # the quantize kernels' two passes: x, n, amax_bits, dtype, stream; then x, n, amax_bits, q, s_x, s_w,
    # factors, K, dtype, stream
    "gdc_absmax": [_P, ctypes.c_longlong, _P, _I, _P],
    "gdc_quantize_given": [_P, ctypes.c_longlong] + [_P] * 5 + [_I] * 2 + [_P],
    # x, w, scales, s_w, bias, out, B, H, W, C, K, bh, quantized, dtype, stream
    "gdc_conv_fused": [_P] * 6 + [_I] * 8 + [_P],
    # x, wt, partial, out, T, dtype, stream
    "gdc_mma_probe": [_P] * 4 + [_I] * 2 + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (ptxas register/spill report) of the last build
build_seconds = 0.0


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libgdc_kernels_{h.hexdigest()[:16]}.so")


def load() -> ctypes.CDLL:
    """Build (if not cached) and load the kernel library; raises on failure."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            t0 = time.perf_counter()
            build_log = _build(path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; their output, or raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (rc {proc.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def _build(path: str) -> str:
    """Compile every source to an object (one nvcc each, in parallel), link
    them into ``path``; returns nvcc's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    cu = [s for s in _sources() if s.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in cu]
    try:
        log = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(cu, objs)])
        log += _run_all([[_nvcc(), "-shared", "-o", f"{path}.{tag}", *objs]])
        os.replace(f"{path}.{tag}", path)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return log


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
