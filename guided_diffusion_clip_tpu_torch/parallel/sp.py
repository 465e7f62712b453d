"""Spatial partitioning (SP): each image's H axis split across ranks. The
port of ``guided_diffusion_clip_tpu/parallel/sp.py``.

Layout, which differs from the JAX package's: there SP spans the local
devices of one process and XLA's partitioner inserts the collectives; here a
process drives one GPU, so the world of W ranks (torchrun, ``parallel/dist.py``)
factors as ``W = D x S``: D data groups of S space ranks each, rank
``r = d * S + s``. A data group plays the part of one JAX process: its S ranks
hold the same batch rows (the CLIs' sample counter and the loader's file shard
go by data group: ``data_rank``, ``data_size``, shared with tensor
parallelism in ``parallel/groups.py``), the same timesteps and the
same generators, and space rank s holds rows ``[s H/S, (s + 1) H/S)`` of every
NCHW activation. Noise is drawn at full size from the sample's generator and
sliced (``shard_rows``), so a sharded chain draws what the unsharded chain
draws.

What XLA's partitioner did is written by hand here, with ``all_reduce`` (SUM,
MAX) and ``all_gather`` only (gloo takes no CUDA tensor in send/recv), so the
same code runs on gloo on the CPU, on gloo with CUDA tensors and on NCCL:

  - ``halo(x, above, below)``: a 3x3 conv's rows from the neighbours, by an
    all-gather of every rank's edge rows (zeros beyond the image's ends);
  - GroupNorm's per-(image, group) sums, and K4's per-channel extremes,
    all-reduced between the statistics and the apply (``ops/groupnorm.py``);
    ``int8_conv``'s absmax likewise (``ops/quant.py``);
  - attention runs gathered: ``gather_rows``, the block whole on every rank
    (``whole``), then the rank's rows, as JAX's ``constrain_batch``;
  - a level whose H does not give every rank an even number of rows runs
    whole on every rank (``shardable``), where JAX's partitioner pads.

Each collective that gradients cross is an autograd Function whose backward
is its adjoint (an all-gather's: an all-reduce, each rank keeping its own
slot). Backpropagating every rank's own loss then gives, summed over the
ranks, the gradient of the sum of the ranks' losses: a train step whose
per-rank loss is the mean over its rows (or a replicated loss) matches DDP's
mean over W ranks. A gradient of one replicated scalar (the guidance
gradients) weights it by ``owner_weight()`` so that it is counted once.

The state is process-global and read when a model runs, as
``ops.config.set_conv_impl`` in the JAX package; with S <= 1 every hook
returns its input itself.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.distributed as dist

from .groups import Groups, data_rank, data_size, factor, gather_data_groups  # noqa: F401 (the data groups' queries)

_STATE: Groups | None = None
_WHOLE = 0  # depth of ``whole()`` blocks: the model runs unsharded there


def set_spatial_sharding(spatial_shard: int) -> None:
    """Split the world into D data groups of ``spatial_shard`` space ranks;
    every rank calls it (``new_group`` is a collective). Refused while
    tensor parallelism is set."""
    from . import tp

    global _STATE
    if tp.active():
        raise ValueError("--spatial_shard and --tensor_shard are mutually exclusive")
    _STATE = factor(int(spatial_shard), "--spatial_shard")


def clear_spatial_sharding() -> None:
    global _STATE
    _STATE = None


def active() -> bool:
    return _STATE is not None


@contextmanager
def spatial_sharding(spatial_shard: int):
    """SP for the block, the previous state restored after it."""
    global _STATE
    prev = _STATE
    set_spatial_sharding(spatial_shard)
    try:
        yield
    finally:
        _STATE = prev


def setup_from_flag(spatial_shard: int, batch_size: int) -> Groups | None:
    """Activate SP for a CLI's ``--spatial_shard`` (after the process group
    is up): ``spatial_shard <= 1`` clears it and returns None. Every rank of
    a data group samples or trains on the same ``batch_size`` rows."""
    if not spatial_shard or int(spatial_shard) <= 1:
        clear_spatial_sharding()
        return None
    from ..utils import logger

    set_spatial_sharding(spatial_shard)
    logger.log(f"spatial sharding: {_STATE.data_size} data group(s) x {_STATE.size} space ranks, "
               f"{batch_size} rows a data group, each rank 1/{_STATE.size} of every image's H")
    return _STATE


def check_flags(spatial_shard, tensor_shard) -> None:
    """A CLI's refusals, before it makes anything: both flags above 1 (as in
    the JAX package), and either above 1 outside torchrun."""
    from . import dist as pdist

    s, t = int(spatial_shard or 0), int(tensor_shard or 0)
    if s > 1 and t > 1:
        raise SystemExit("--spatial_shard and --tensor_shard are mutually exclusive")
    for flag, k in (("--spatial_shard", s), ("--tensor_shard", t)):
        if k > 1 and not (dist.is_initialized() or pdist.under_torchrun()):
            raise SystemExit(f"{flag} {k}: launch under torchrun with a multiple of {k} ranks (python -m "
                             f"torch.distributed.run --nproc_per_node {k} -m ...)")


@contextmanager
def from_flag(spatial_shard, batch_size: int):
    """``setup_from_flag`` for the length of the block (a CLI's run)."""
    state = setup_from_flag(spatial_shard, batch_size)
    try:
        yield state
    finally:
        if state is not None:
            clear_spatial_sharding()


def size() -> int:
    """S, the ranks that share an image (1 without SP)."""
    return _STATE.size if _STATE is not None else 1


def space_rank() -> int:
    return _STATE.rank if _STATE is not None else 0


def sharded(x: torch.Tensor | None = None) -> bool:
    """Whether a model's (4-D, NCHW) activations are row shards here: SP is
    active and no ``whole()`` block is open (and ``x``, if given, is 4-D)."""
    return _STATE is not None and _WHOLE == 0 and (x is None or x.dim() == 4)


def shardable(h: int) -> bool:
    """Whether a map of ``h`` rows runs sharded: every rank an even number
    of rows (a 2x pool or a stride-2 conv keeps the split even)."""
    s = size()
    return h % s == 0 and (h // s) % 2 == 0


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
    called again: ``torch.utils.checkpoint`` recomputes a block in the
    backward, outside the block that ran it whole."""
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


def owner_weight() -> float:
    """1.0 on space rank 0, 0.0 on the others: the weight of a replicated
    scalar whose gradient every rank takes, so that the adjoints' sums count
    it once."""
    return 1.0 if space_rank() == 0 else 0.0


def local_shape(shape) -> tuple:
    """A 4-D NCHW shape as a rank holds it: H / S rows on a shard."""
    shape = tuple(shape)
    if not sharded() or len(shape) != 4:
        return shape
    if shape[2] % size():
        raise ValueError(f"{shape[2]} rows do not split over {size()} space ranks")
    return shape[:2] + (shape[2] // size(),) + shape[3:]


def full_shape(shape) -> tuple:
    """The full image's 4-D NCHW shape of a rank's shard's shape."""
    shape = tuple(shape)
    if not sharded() or len(shape) != 4:
        return shape
    return shape[:2] + (shape[2] * size(),) + shape[3:]


def full_rows(h: int) -> int:
    """The full H of a shard of ``h`` rows."""
    return h * size()


# ---------------------------------------------------------------- collectives
def _group():
    return _STATE.group


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """x's NHWC memory as a contiguous (B, H, W, C) tensor (free for a
    channels_last x)."""
    return x.movedim(1, -1).contiguous()


def _nchw(h: torch.Tensor) -> torch.Tensor:
    """The NHWC tensor as logical NCHW in channels_last memory."""
    return h.movedim(-1, 1)


def _all_gather(t: torch.Tensor) -> list:
    parts = [torch.empty_like(t) for _ in range(_STATE.size)]
    dist.all_gather(parts, t, group=_group())
    return parts


def _all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=_group())
    return t


def reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the space group, in place (no autograd)."""
    return _all_reduce(t) if _STATE is not None else t


def reduce_max_(t: torch.Tensor) -> torch.Tensor:
    """Max of ``t`` over the space group, in place (no autograd)."""
    return _all_reduce(t, dist.ReduceOp.MAX) if _STATE is not None else t


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.h = x.shape[2]
        return _nchw(torch.cat(_all_gather(_nhwc(x)), dim=1))

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(_nhwc(g).clone())
        s, h = _STATE.rank, ctx.h
        return _nchw(g[:, s * h:(s + 1) * h].contiguous())


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone())


class _Halo(torch.autograd.Function):
    """The rows around a shard: ``above`` rows of the previous rank's bottom
    and ``below`` rows of the next rank's top, zeros beyond the ends. One
    all-gather of every rank's (top ``below``, bottom ``above``) rows; the
    adjoint all-reduces the cotangents of the rows a rank lent (each in its
    owner's slot) and adds the rank's own slot to its edge rows."""

    @staticmethod
    def forward(ctx, x, above, below):
        h = x.shape[2]
        if h < max(above, below):
            raise ValueError(f"a shard of {h} rows cannot lend {max(above, below)} halo rows")
        xh = _nhwc(x)
        B, _, W, C = xh.shape
        row = W * C
        edges = _all_gather(torch.cat([xh[:, :below].reshape(B, -1), xh[:, h - above:].reshape(B, -1)], dim=1))
        s, S = _STATE.rank, _STATE.size
        zeros = xh.new_zeros
        top = edges[s - 1][:, below * row:].reshape(B, above, W, C) if s > 0 else zeros(B, above, W, C)
        bottom = edges[s + 1][:, :below * row].reshape(B, below, W, C) if s < S - 1 else zeros(B, below, W, C)
        ctx.shape = (B, h, W, C, above, below)
        return _nchw(torch.cat([top, xh, bottom], dim=1))

    @staticmethod
    def backward(ctx, g):
        B, h, W, C, above, below = ctx.shape
        s, S = _STATE.rank, _STATE.size
        gh = _nhwc(g)
        dx = gh[:, above:above + h].clone()
        lent = gh.new_zeros(S, B, (below + above) * W * C)
        if s > 0:  # the rows above came from the previous rank's bottom
            lent[s - 1, :, below * W * C:] = gh[:, :above].reshape(B, -1)
        if s < S - 1:  # the rows below from the next rank's top
            lent[s + 1, :, :below * W * C] = gh[:, above + h:].reshape(B, -1)
        mine = _all_reduce(lent)[s]
        dx[:, :below] += mine[:, :below * W * C].reshape(B, below, W, C)
        dx[:, h - above:] += mine[:, below * W * C:].reshape(B, above, W, C)
        return _nchw(dx), None, None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The full map (B, C, H, W), channels_last, from every rank's rows; its
    adjoint sums the ranks' cotangents and keeps the rank's rows."""
    if not sharded(x):
        return x
    return _GatherRows.apply(x)


def shard_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a full 4-D map (a channels_last copy); the slice
    is its own adjoint's transpose, so gradients flow as autograd's."""
    if not sharded(x):
        return x
    S, s = _STATE.size, _STATE.rank
    H = x.shape[2]
    if H % S:
        raise ValueError(f"{H} rows do not split over {S} space ranks")
    h = H // S
    return x[:, :, s * h:(s + 1) * h].contiguous(memory_format=torch.channels_last)


def halo(x: torch.Tensor, above: int, below: int) -> torch.Tensor:
    """x's rows with ``above`` rows of the rank before and ``below`` rows of
    the rank after (zeros at the image's ends), channels_last; differentiable.
    Any dtype (the int8 path's s8 q too)."""
    if not sharded(x):
        return x
    return _Halo.apply(x, above, below)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the space group; differentiable (its adjoint is itself)."""
    if not sharded():
        return x
    return _AllReduceSum.apply(x)


def mean_hw(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """The mean over (H, W) of a map, of the full image when x is a shard."""
    if not sharded(x):
        return x.mean(dim=(2, 3), keepdim=keepdim)
    return all_reduce_sum(x.sum(dim=(2, 3), keepdim=keepdim)) / (full_rows(x.shape[2]) * x.shape[3])


def relayout(x: torch.Tensor, is_shard: bool, want_shard: bool) -> torch.Tensor:
    """x (a shard or the full map) as ``want_shard`` asks."""
    if is_shard == want_shard:
        return x
    return shard_rows(x) if want_shard else gather_rows(x)


def run_whole(fn, x: torch.Tensor, *args):
    """``fn(full x, *args)`` on every rank on the gathered map, then the
    rank's rows of its output (4-D) or the output itself (replicated)."""
    if not sharded(x):
        return fn(x, *args)
    full = gather_rows(x)
    with whole():
        out = fn(full, *args)
    return shard_rows(out) if out.dim() == 4 else out
