"""FSDP2 for ``--param_sharding fsdp``: the port of the FSDP part of
``guided_diffusion_clip_tpu/parallel/mesh.py``.

The mesh is 1-D, ``("data", world)``, one device a process, so the global
batch is ``batch_size * world`` (``TrainLoop.global_batch``); the JAX
package's ``create_data_mesh`` instead picks the largest divisor of the batch
over the devices of one process. ``shard_model`` wraps each
``TimestepEmbedSequential`` block (its layers as one group), then the root, in
``fully_shard``. FSDP2 shards dim 0 of every
parameter (padded where it does not divide); the JAX package shards each
leaf's largest divisible dimension and replicates leaves under 16384
elements (``fsdp_spec``). That is a choice of layout and changes no result.

No ``MixedPrecisionPolicy``: the torso's convs cast their f32 weights to
bf16 at each call, and the GroupNorms, the embeddings and the head stay f32.
FSDP2 takes contiguous parameters only, so ``shard_model`` gives the convs
NCHW weights; the training cast hands cuDNN and K5 a channels_last copy
(``models/nn.py``). Its all-gathers refill the unsharded parameters in place
without a new version, so a cache keyed on a weight's version (the int8
convs' ``w_q``) must be dropped after each update (``TrainLoop.update``).

The helpers below move a tensor between a DTensor parameter's layout and its
full value; on a plain tensor they do nothing.
"""

from __future__ import annotations

import torch
from torch import nn


def data_mesh(device: torch.device):
    from torch.distributed.device_mesh import init_device_mesh

    from . import dist as pdist

    return init_device_mesh(device.type, (pdist.world_size(),), mesh_dim_names=("data",))


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """``fully_shard`` each ``TimestepEmbedSequential`` block, then the root.
    A block is an ``nn.ModuleList``, which some torch versions refuse to
    shard, so its layers are sharded as one group (the same parameters, one
    all-gather)."""
    from torch.distributed.fsdp import fully_shard

    from ..models.unet import TimestepEmbedSequential

    model.to(memory_format=torch.contiguous_format)
    for m in list(model.modules()):
        if isinstance(m, TimestepEmbedSequential):
            fully_shard(list(m), mesh=mesh)
    fully_shard(model, mesh=mesh)
    return model


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def as_dtensor(local: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``local`` (a shard laid out as DTensor ``like``'s) as a DTensor."""
    if not is_dtensor(like):
        return local
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def full_tensor(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The full value of ``t``, a DTensor or ``like``'s local shard (a
    collective on every rank when ``like`` is a DTensor)."""
    if not is_dtensor(like):
        return t
    return (t if is_dtensor(t) else as_dtensor(t, like)).full_tensor()


def distribute_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` laid out as ``like``: a DTensor of the same mesh and
    placements, or a plain tensor on ``like``'s device and dtype."""
    full = full.to(device=like.device, dtype=like.dtype)
    if not is_dtensor(like):
        return full
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full, like.device_mesh, like.placements)
