"""The factoring of a world of W ranks as ``W = D x K`` that spatial
partitioning (K space ranks, ``parallel/sp.py``) and tensor parallelism (K
model ranks, ``parallel/tp.py``) share, and the data groups' queries that the
CLIs, the loader and the trainers read.

Rank ``r = d * K + k`` is rank k of data group d. A data group plays the part
of one JAX process: its K ranks hold the same batch rows, the same timesteps
and the same generators, so the CLIs count samples, the loader shards files
and the trainers seed by data group (``data_rank``, ``data_size``). SP and TP
are exclusive: at most one of them holds a ``Groups`` at a time, and without
either every query answers for the process group itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Groups:
    size: int  # K: the ranks of a data group
    data_size: int  # D: the data groups
    rank: int  # this rank's place in its data group (its space or model rank)
    data_rank: int
    group: object  # this rank's data group: the K ranks that share its images
    data_group: object  # the D ranks of this rank's place in every data group


def factor(k: int, flag: str) -> Groups:
    """Split the world into D data groups of ``k`` ranks; every rank calls it
    (``new_group`` is a collective). ``flag`` names the option in the
    refusals."""
    if not dist.is_initialized():
        raise ValueError(f"{flag} {k} needs a process group of a multiple of {k} ranks: launch under "
                         f"torchrun (python -m torch.distributed.run --nproc_per_node {k} ...)")
    w, r = dist.get_world_size(), dist.get_rank()
    if k < 1 or w % k:
        raise ValueError(f"{flag} {k} does not divide the world of {w} ranks")
    d = w // k
    own = [dist.new_group([g * k + j for j in range(k)]) for g in range(d)]
    across = [dist.new_group([g * k + j for g in range(d)]) for j in range(k)]
    return Groups(k, d, r % k, r // k, own[r // k], across[r % k])


def current() -> Groups | None:
    """The groups of whichever of SP and TP is set, else None."""
    from . import sp, tp

    return sp._STATE or tp._STATE


def size() -> int:
    """K, the ranks that share a data group's images (1 without SP or TP)."""
    g = current()
    return g.size if g is not None else 1


def data_rank() -> int:
    """This rank's data group (the process's rank without SP or TP)."""
    g = current()
    if g is not None:
        return g.data_rank
    return dist.get_rank() if dist.is_initialized() else 0


def data_size() -> int:
    """D, the data groups (the world without SP or TP)."""
    g = current()
    if g is not None:
        return g.data_size
    return dist.get_world_size() if dist.is_initialized() else 1


def gather_data_groups(a):
    """A host array of every data group, in data-rank order (``[D, ...]``),
    gathered over this rank's place in every data group (a data group's
    ranks hold the same array); the process group's ``all_gather_host``
    without SP or TP."""
    from . import dist as pdist

    g = current()
    if g is None:
        return pdist.all_gather_host(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    parts = [torch.empty_like(t) for _ in range(g.data_size)]
    dist.all_gather(parts, t, group=g.data_group)
    return torch.stack(parts).numpy()
