"""Tensor parallelism (TP): each activation's channels split across ranks.
The port of ``guided_diffusion_clip_tpu/parallel/tp.py``.

TP is the deep-trunk complement to spatial partitioning (``parallel/sp.py``):
SP splits an image's rows, the knob for the high-resolution levels; TP splits
the channels, the knob for the 8-16 px levels that carry C = 1024 while H
stops dividing. Per-GPU activation memory falls by the model factor while the
parameters stay whole on every rank, under the same ``state_dict`` names.

Layout, which differs from the JAX package's: there TP spans the local
devices of one process and XLA's partitioner inserts the collectives; here a
process drives one GPU, so the world of W ranks factors as ``W = D x T``: D
data groups of T model ranks, rank ``r = d * T + m`` (``parallel/groups.py``,
shared with SP). A data group plays the part of one JAX process: its T ranks
hold the same batch rows, the same timesteps and the same generators. Model
rank m holds channels ``[m C/T, (m + 1) C/T)`` of every NCHW activation
between blocks whose C divides by T; any other activation is whole on every
rank, as JAX's ``constrain_channels`` falls back: the 3- and 6-channel model
input, the output head, the timestep and ``clip_feat`` embeddings.

What XLA's partitioner did is written by hand in the modules
(``models/nn.py``, ``models/unet.py``), with ``all_reduce`` (SUM, MAX) and
``all_gather`` only, so the same code runs on gloo on the CPU, on gloo with
CUDA tensors and on NCCL:

  - a conv is column-parallel: its input's channels gathered
    (``gather_channels``), the rank's output channels of the weight
    (``channel_slices``), whose int8 quantization (kernel K5's rows and
    per-channel scales) is the slice of the whole weight's; a conv whose
    output channels do not divide runs whole;
  - GroupNorm: where T divides the 32 groups, each rank holds 32/T whole
    groups and K3 runs on its channels with no collective, backward too; the
    quantizing GroupNorm (K4) splits at its statistics, its per-image scale
    the max over the model group (``reduce_max_``); where T does not divide
    the groups, the norm runs on the gathered channels and keeps the rank's;
  - attention: qkv column-parallel in whole heads (three slices in the
    ``[q|k|v][head][d]`` order), K1 (and K2) on the rank's heads, proj_out
    column-parallel on the gathered heads; where T does not divide the heads
    the block runs whole on the gathered channels (``run_whole``);
  - the emb projection's rows of the rank's channels: under
    ``use_scale_shift_norm`` two slices, its scale's and its shift's.

Each collective that gradients cross is an autograd Function whose backward
is its adjoint (an all-gather's: an all-reduce, each rank keeping its own
slot). Every rank then backpropagates its own copy of a replicated loss, and
the ranks' parameter gradients sum to T times the loss's gradient: a train
step's replicated loss under DDP's (or FSDP2's, or ZeRO-1's) mean over W ranks
is the data-parallel gradient. A gradient of one replicated scalar with
respect to the whole input (the guidance gradients) weights the scalar by
``owner_weight()`` and sums the ranks' gradients (``reduce_sum_``), so that
it is counted once.

The state is process-global and read when a model runs; with T <= 1 every
hook returns its input itself. SP and TP are exclusive.
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager

import torch
import torch.distributed as dist

from .groups import Groups, factor

_STATE: Groups | None = None
_WHOLE = 0  # depth of ``whole()`` blocks: the model runs unsharded there


def set_tensor_sharding(tensor_shard: int) -> None:
    """Split the world into D data groups of ``tensor_shard`` model ranks;
    every rank calls it (``new_group`` is a collective). Refused while
    spatial partitioning is set."""
    from . import sp

    global _STATE
    t = int(tensor_shard)
    if sp.active():
        raise ValueError("--spatial_shard and --tensor_shard are mutually exclusive")
    _STATE = factor(t, "--tensor_shard")
    if 32 % t:
        warnings.warn(f"--tensor_shard {t} does not divide the 32 GroupNorm groups: groups split across ranks, so "
                      "each GroupNorm runs on the gathered channels (values stay correct; expect extra collective "
                      "traffic)", stacklevel=2)


def clear_tensor_sharding() -> None:
    global _STATE
    _STATE = None


def active() -> bool:
    return _STATE is not None


@contextmanager
def tensor_sharding(tensor_shard: int):
    """TP for the block, the previous state restored after it."""
    global _STATE
    prev = _STATE
    set_tensor_sharding(tensor_shard)
    try:
        yield
    finally:
        _STATE = prev


def setup_from_flag(tensor_shard: int, batch_size: int) -> Groups | None:
    """Activate TP for a CLI's ``--tensor_shard`` (after the process group is
    up): ``tensor_shard <= 1`` clears it and returns None. Every rank of a
    data group samples or trains on the same ``batch_size`` rows."""
    if not tensor_shard or int(tensor_shard) <= 1:
        clear_tensor_sharding()
        return None
    from ..utils import logger

    set_tensor_sharding(tensor_shard)
    logger.log(f"tensor sharding: {_STATE.data_size} data group(s) x {_STATE.size} model ranks, "
               f"{batch_size} rows a data group, each rank 1/{_STATE.size} of every activation's channels")
    return _STATE


@contextmanager
def from_flag(tensor_shard, batch_size: int):
    """``setup_from_flag`` for the length of the block (a CLI's run)."""
    state = setup_from_flag(tensor_shard, batch_size)
    try:
        yield state
    finally:
        if state is not None:
            clear_tensor_sharding()


def size() -> int:
    """T, the ranks that share an activation's channels (1 without TP)."""
    return _STATE.size if _STATE is not None else 1


def model_rank() -> int:
    return _STATE.rank if _STATE is not None else 0


def owner_weight() -> float:
    """1.0 on model rank 0, 0.0 on the others: the weight of a replicated
    scalar whose gradient every rank takes, so that the ranks' sum counts it
    once."""
    return 1.0 if model_rank() == 0 else 0.0


def sharded() -> bool:
    """Whether the models' activations are channel shards here: TP is active
    and no ``whole()`` block is open."""
    return _STATE is not None and _WHOLE == 0


def splits(channels: int) -> bool:
    """Whether an activation of ``channels`` channels is split over the ranks."""
    return sharded() and channels % _STATE.size == 0


def whole_groups(groups: int) -> bool:
    """Whether each rank holds whole groups of a GroupNorm of ``groups``."""
    return groups % size() == 0


def channel_slices(channels: int, pieces: int = 1) -> list:
    """The rank's rows of a weight of ``pieces`` consecutive blocks of
    ``channels`` output channels each: its C/T of every block (the emb
    projection's scale and shift, qkv's q, k and v in the new head order)."""
    c = channels // _STATE.size
    lo = _STATE.rank * c
    return [slice(p * channels + lo, p * channels + lo + c) for p in range(pieces)]


def local_shape(shape) -> tuple:
    """A 4-D NCHW shape as a rank holds it: C / T channels where they split."""
    shape = tuple(shape)
    if len(shape) != 4 or not splits(shape[1]):
        return shape
    return (shape[0], shape[1] // _STATE.size) + shape[2:]


@contextmanager
def whole():
    """Run the block unsharded: every hook is the identity inside it."""
    global _WHOLE
    _WHOLE += 1
    try:
        yield
    finally:
        _WHOLE -= 1


def bound(fn):
    """``fn`` called under the current ``whole()`` depth wherever it is
    called again (``torch.utils.checkpoint`` recomputes a block in the
    backward)."""
    if _STATE is None:
        return fn
    depth = _WHOLE

    def call(*args):
        global _WHOLE
        prev, _WHOLE = _WHOLE, depth
        try:
            return fn(*args)
        finally:
            _WHOLE = prev

    return call


# ---------------------------------------------------------------- collectives
def _last(x: torch.Tensor) -> torch.Tensor:
    """x with its channel axis (dim 1) last, contiguous (free for a
    channels_last map)."""
    return x.movedim(1, -1).contiguous()


def reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the model group, in place (no autograd)."""
    if _STATE is not None:
        dist.all_reduce(t, group=_STATE.group)
    return t


def reduce_max_(t: torch.Tensor) -> torch.Tensor:
    """Max of ``t`` over the model group, in place (no autograd)."""
    if _STATE is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_STATE.group)
    return t


class _GatherChannels(torch.autograd.Function):
    """Every rank's channels (dim 1), in rank order, with the channel axis
    last in memory (channels_last for a 4-D map); the adjoint all-reduces the
    cotangent and keeps the rank's channels."""

    @staticmethod
    def forward(ctx, x):
        xl = _last(x)
        parts = [torch.empty_like(xl) for _ in range(_STATE.size)]
        dist.all_gather(parts, xl, group=_STATE.group)
        return torch.cat(parts, dim=-1).movedim(-1, 1)

    @staticmethod
    def backward(ctx, g):
        gl = reduce_sum_(g.movedim(1, -1).clone(memory_format=torch.contiguous_format))
        c = gl.shape[-1] // _STATE.size
        return gl[..., _STATE.rank * c:(_STATE.rank + 1) * c].contiguous().movedim(-1, 1)


def gather_channels(x: torch.Tensor, channels: int) -> torch.Tensor:
    """x with all ``channels`` channels (dim 1): x itself where it holds
    them, else every rank's shard gathered; differentiable, any dtype (the
    int8 path's s8 q too)."""
    if not sharded() or x.shape[1] == channels:
        return x
    if x.shape[1] * _STATE.size != channels:
        raise ValueError(f"a shard of {x.shape[1]} channels is not 1/{_STATE.size} of {channels}")
    return _GatherChannels.apply(x)


def shard_channels(x: torch.Tensor) -> torch.Tensor:
    """The rank's channels (dim 1) of a whole x where they split, with the
    channel axis last in memory, else x; the slice is its own adjoint's
    transpose, so gradients flow as autograd's."""
    if not splits(x.shape[1]):
        return x
    (sl,) = channel_slices(x.shape[1])
    return x.movedim(1, -1)[..., sl].contiguous().movedim(-1, 1)


def run_whole(fn, x: torch.Tensor, channels: int, *args):
    """``fn(x with all its channels, *args)`` on every rank inside
    ``whole()``: the same output on every rank."""
    if not sharded():
        return fn(x, *args)
    full = gather_channels(x, channels)
    with whole():
        return fn(full, *args)
