"""ctypes bindings of the native C++ image decoder (``native/gdc_loader.cpp``).

The port's copy of ``guided_diffusion_clip_tpu/data/native_loader.py``. The
C library decodes JPEG and PNG, BOX-halves and BICUBIC-resizes with Pillow's
fixed-point algorithm, crops, flips and scales to [-1, 1], a batch of files a
call (``gdc_process_batch``), with the GIL released for the call; the Python pipeline keeps
the order, the pairing and the CLIP lookup. Its pixels are bit-identical to
the PIL path's (same system libjpeg and libpng).

The library is compiled at first use from ``native/gdc_loader.cpp`` with the
compiler, flags and libraries that ``native/Makefile`` names, into
``build/gdc_loader/`` at the root of the checkout (keyed by a hash of the
source, the command and the host's CPU, since the flags hold
``-march=native``), and loaded with ``ctypes``. ``native/`` is not
written. A failed build or load raises ``OSError``: unlike the JAX package's
loader, the port does not fall back to PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import re
import subprocess
import threading
from typing import Sequence

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "build", "gdc_loader")
_lock = threading.Lock()
_lib = None


def _make_vars() -> dict:
    """``CXX``, ``CXXFLAGS`` and ``LDLIBS`` as ``native/Makefile`` sets them
    (``?=`` defaults give way to the environment, as under make)."""
    out = {}
    with open(os.path.join(NATIVE_DIR, "Makefile")) as f:
        for line in f:
            m = re.match(r"^(CXX|CXXFLAGS|LDLIBS)\s*(\?=|=)\s*(.*?)\s*$", line)
            if m:
                name, op, value = m.groups()
                out[name] = os.environ.get(name, value) if op == "?=" else value
    missing = {"CXX", "CXXFLAGS", "LDLIBS"} - set(out)
    if missing:
        raise OSError(f"native/Makefile does not set {sorted(missing)}")
    return out


def _command(out_path: str) -> list[str]:
    v = _make_vars()
    return [*v["CXX"].split(), *v["CXXFLAGS"].split(), "-shared", "-o", out_path,
            os.path.join(NATIVE_DIR, "gdc_loader.cpp"), *v["LDLIBS"].split()]


def _host_cpu() -> str:
    """The CPU that ``-march=native`` targets: its model name and feature
    flags as ``/proc/cpuinfo`` lists them (the machine's name where there is
    no such file)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [line for line in f if line.startswith(("model name", "flags", "Features", "CPU part"))]
    except OSError:
        lines = []
    return "".join(dict.fromkeys(lines)) or f"{platform.machine()} {platform.processor()}"


def library_path() -> str:
    """Where the library for this source, build command and CPU is kept."""
    h = hashlib.sha256(" ".join(_command("OUT")).encode())
    h.update(_host_cpu().encode())
    with open(os.path.join(NATIVE_DIR, "gdc_loader.cpp"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgdc_loader_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(_command(tmp), capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise OSError(f"native loader build failed: {e}") from e
    if proc.returncode != 0:
        raise OSError(f"native loader build failed (rc {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def load_library() -> ctypes.CDLL:
    """Build (if not cached) and load the library; raises ``OSError`` on failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.gdc_process_batch.restype = ctypes.c_int
        lib.gdc_process_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        _lib = lib
        return lib


def process_batch(
    paths: Sequence[str],
    image_size: int,
    *,
    random_crop: bool = False,
    random_flip: bool = True,
    seeds: Sequence[int] | None = None,
    num_threads: int = 0,
):
    """Decode and preprocess a batch natively: (images f32 (N, S, S, 3) in
    [-1, 1], flipped uint8 (N,)). Each image draws its crop and flip from its
    seed. Raises ``IOError`` on any decode failure."""
    lib = load_library()
    n = len(paths)
    out = np.empty((n, image_size, image_size, 3), np.float32)
    flipped = np.zeros((n,), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if seeds is None:
        seeds = np.arange(1, n + 1, dtype=np.uint64)
    c_seeds = np.ascontiguousarray(seeds, dtype=np.uint64)
    ok = lib.gdc_process_batch(
        c_paths, n, image_size, int(random_crop), int(random_flip),
        c_seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        flipped.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        num_threads,
    )
    if ok != n:
        raise IOError(f"native loader processed {ok}/{n} images")
    return out, flipped
