"""The process group and host-side collectives: the port of
``guided_diffusion_clip_tpu/parallel/dist.py`` (reference dist_util.py).

``setup_dist`` starts ``torch.distributed`` from torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
whenever they are all set, at world 1 too, and does nothing without them, as
the JAX package's does without its coordinator. The backend follows the
device: a CUDA run binds ``cuda:LOCAL_RANK`` and takes NCCL for CUDA tensors,
with gloo beside it for CPU tensors (the host gathers here and
``torch.distributed.checkpoint``'s asynchronous save); a CPU run takes gloo.
NCCL needs one GPU a rank. A failure to start the group raises: a CUDA run
never carries on under gloo alone or on the CPU.

Without a group every query answers for one process: rank 0 of 1.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def under_torchrun() -> bool:
    return all(k in os.environ for k in TORCHRUN_VARS)


def local_device(device="cuda") -> torch.device:
    """``device`` as this process runs it: ``cuda:LOCAL_RANK`` for a CUDA
    device under torchrun (one GPU a rank), else ``device`` itself."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and under_torchrun():
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def setup_dist(device="cuda") -> bool:
    """Start the process group from torchrun's variables; returns whether
    this call started it (the caller then ends it with ``destroy``)."""
    if dist.is_initialized() or not under_torchrun():
        return False
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("cpu:gloo,cuda:nccl", device_id=dev)
    else:
        dist.init_process_group("gloo")
    return True


@contextmanager
def process_group(device="cuda"):
    """A CLI's ``main``: the process group for the length of the block when
    torchrun's variables are set (ended there if the block started it);
    yields this process's device (``local_device``)."""
    started = setup_dist(device)
    try:
        yield local_device(device)
    finally:
        if started:
            destroy()


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return rank() == 0


def barrier(name: str = "barrier") -> None:
    """Wait for every rank (``name`` says where, for a reader of a hang)."""
    if dist.is_initialized():
        dist.barrier()


def all_gather_host(x) -> np.ndarray:
    """Gather a host array of the same shape on every rank: ``[world, ...]``
    in rank order (the JAX package's ``process_allgather``)."""
    x = np.ascontiguousarray(x)
    if not dist.is_initialized():
        return x[None]
    t = torch.from_numpy(x)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (a run directory's name)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_gather_object(obj) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
