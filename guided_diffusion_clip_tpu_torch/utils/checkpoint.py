"""Checkpoint names, and reference-format ``.pt`` state_dicts in and out.

The port's native format is the reference torch ``state_dict``. A JAX
``.flax`` checkpoint reaches it as ``.pt`` through the JAX package's own
``guided_diffusion_clip_tpu.utils.checkpoint.save_pt_copy``; reading msgpack
``.flax`` here would need flax, which the port does not import. The trainer
writes the reference's names (train_util.py:243-267) with the ``.pt``
extension: ``model{step:06d}.pt``, ``ema_{rate}_{step:06d}.pt`` (state_dicts
under the reference's keys, which the JAX package's ``load_params`` reads) and
``opt{step:06d}.pt``. Paths may be URLs (gs://, memory://, ...): the files
are read and written through ``utils/bf_io.py``, as the JAX package's are.

Under ``--ckpt_backend orbax`` the trainer writes ``torch.distributed.checkpoint``
(DCP) directories, ``{run}/orbax/{step}/`` holding ``model``, ``ema_{rate}``
and ``opt``, on a local file system. ``load_state_dict`` reads
``<run>/orbax`` (the newest step's ``model``) and ``<run>/orbax@ema_<rate>``
(another entry), as the JAX package's ``load_params`` does, so the sampling
CLIs take them as they are. A JAX orbax directory (tensorstore files) is
refused with the recipe that converts it.
"""

from __future__ import annotations

import os
import re

import torch
from torch import nn

from . import bf_io


def checkpoint_name(kind: str, step: int, ema_rate: float | str | None = None, ext: str = "pt") -> str:
    """Reference filename scheme (train_util.py:249-251)."""
    if kind == "model":
        return f"model{step:06d}.{ext}"
    if kind == "ema":
        return f"ema_{ema_rate}_{step:06d}.{ext}"
    if kind == "opt":
        return f"opt{step:06d}.{ext}"
    raise ValueError(kind)


def parse_resume_step_from_filename(filename: str) -> int:
    """model123456(.pt|.flax) -> 123456; 0 if unparseable (train_util.py:344-356)."""
    m = re.match(r"^model(\d+)\.\w+$", os.path.basename(filename))
    return int(m.group(1)) if m else 0


def find_ema_checkpoint(main_checkpoint: str | None, step: int, rate) -> str | None:
    """The EMA file beside a model checkpoint, or None (train_util.py:371-378)."""
    if main_checkpoint is None:
        return None
    ext = main_checkpoint.rsplit(".", 1)[-1]
    path = bf_io.join(os.path.dirname(main_checkpoint), checkpoint_name("ema", step, rate, ext=ext))
    return path if bf_io.exists(path) else None


def save_state_dict(path: str, state_dict: dict) -> None:
    """Write a state_dict (tensors, or nested dicts of them and numbers) as
    ``.pt``, every tensor moved to the CPU."""
    def host(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu()
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        return v

    with bf_io.open_file(path, "wb") as f:
        torch.save(host(state_dict), f)


def is_dcp_path(path: str) -> bool:
    """``<run>/orbax`` or ``<run>/orbax@<entry>``."""
    return os.path.basename(path.split("@", 1)[0].rstrip("/")) == "orbax"


def latest_dcp_step(orbax_dir: str) -> tuple[int, str]:
    """(step, its directory) of the newest step under a DCP ``orbax``
    directory; a JAX orbax directory raises ``ValueError`` with the recipe
    that converts it."""
    steps = sorted(int(n) for n in os.listdir(orbax_dir) if n.isdigit()) if os.path.isdir(orbax_dir) else []
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {orbax_dir}")
    step_dir = os.path.join(orbax_dir, str(steps[-1]))
    if not os.path.exists(os.path.join(step_dir, ".metadata")):
        raise ValueError(
            f"{step_dir} is not a torch.distributed.checkpoint directory (a JAX orbax checkpoint's tensorstore "
            "files?): write a .pt with the JAX package, guided_diffusion_clip_tpu.utils.checkpoint.save_pt_copy("
            "path, load_params('<run>/orbax@ema_<rate>', template))"
        )
    return steps[-1], step_dir


def load_dcp_entry(path: str) -> dict[str, torch.Tensor]:
    """One entry (``model`` unless ``@<entry>`` names another) of the newest
    step of a DCP ``orbax`` directory, full tensors on the CPU, read without
    a process group."""
    import torch.distributed.checkpoint as dcp

    base, entry = path.split("@", 1) if "@" in os.path.basename(path) else (path, "model")
    step, step_dir = latest_dcp_step(base.rstrip("/"))
    meta = dcp.FileSystemReader(step_dir).read_metadata().state_dict_metadata
    prefix = entry + "."
    out = {k[len(prefix):]: torch.empty(m.size, dtype=m.properties.dtype)
           for k, m in meta.items() if k.startswith(prefix) and hasattr(m, "size")}
    if not out:
        entries = sorted({m.group(1) for k in meta if (m := re.match(r"(model|opt|ema_[\d.]*\d)\.", k))})
        raise KeyError(f"{entry!r} is not in {step_dir} (step {step}), which holds {entries}")
    dcp.load({entry: out}, checkpoint_id=step_dir, no_dist=True)
    return out


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Read a ``.pt`` state_dict, or an entry of a DCP ``orbax`` directory
    (``is_dcp_path``), onto the CPU (tensors only, no pickled code)."""
    if is_dcp_path(path):
        return load_dcp_entry(path)
    if not path.endswith(".pt"):
        raise ValueError(
            f"{path}: the PyTorch package loads reference-format .pt files; convert a "
            ".flax checkpoint with guided_diffusion_clip_tpu.utils.checkpoint.save_pt_copy"
        )
    with bf_io.open_file(path, "rb") as f:
        return torch.load(f, map_location="cpu", weights_only=True)


def load_model_weights(model: nn.Module, path: str) -> nn.Module:
    """``model.load_state_dict(strict=True)`` from a ``.pt`` file; every key
    must match. Weights are cast on copy to each parameter's dtype (the
    model's bf16 torso takes an f32 checkpoint). The same for the UNet and
    the ``EncoderUNetModel`` classifier, whose head keys depend on its pool."""
    model.load_state_dict(load_state_dict(path), strict=True)
    return model
