"""The split GroupNorm's plan (``ops/groupnorm.py::_split_plan``), which cuts
x (B, hw, C) into the row tiles that ``csrc/groupnorm_split.cu``'s two
kernels walk, held on the CPU: every value is read by exactly one thread of
one block, the grid fills the card's SMs wherever the map holds enough
tiles, no tile falls below its minimum, and the per-tile sums, folded in the
kernel's fixed order, compose to the untiled statistics. The wrappers'
refusals, which come before any launch, are held here too; the kernels
themselves run only on the card (``tests/test_torch_kernels.py``, marked
``gpu``)."""

import numpy as np
import pytest
import torch

from guided_diffusion_clip_tpu_torch.ops import groupnorm as G
from test_torch_groupnorm import _full_size, _gn_calls

SMS = 132  # the H100's SMs


def _recipe():
    """The fork's recipe model (``configs/config.yaml``: 128 px, 64 channels,
    one head) on the meta device."""
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_model

    with torch.device("meta"):
        return create_model(128, 64, 2, learn_sigma=True, class_cond=True, num_heads=1, attention_resolutions="16,8")


def _phase17_18_maps():
    """(B, hw, C, G) of every GroupNorm of phases 17 and 18 of the smoke: the
    ADM-256 UNet and ADM-G 256's classifier at batch 2, the recipe at batch
    48, each with two space ranks (half the rows) and with two model ranks
    (half the channels, 16 of the 32 groups)."""
    maps = set()
    for model, size, batch in ((_full_size("unet"), 256, 2), (_full_size("classifier"), 256, 2),
                               (_recipe(), 128, 48)):
        for hw, C, _ in _gn_calls(model, size):
            maps.add((batch, hw // 2, C, 32))
            maps.add((batch, hw, C // 2, 16))
    return sorted(maps)


MAPS = _phase17_18_maps()


def test_the_maps_cover_the_models():
    """The walk gives ADM-256's levels (C / G up to 64 at the concatenations)
    and the recipe's C / G = 2 and 6."""
    widths = {C // groups for _, _, C, groups in MAPS}
    assert {2, 6, 8, 16, 24, 32, 48, 64} <= widths, widths
    assert (2, 256 * 256 // 2, 256, 32) in MAPS and (48, 128 * 128 // 2, 64, 32) in MAPS


@pytest.mark.parametrize("per_sm", [G._STATS_PER_SM, G._APPLY_PER_SM], ids=["stats", "apply"])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("vec_wide", [True, False])
def test_plan_fills_the_sms_and_keeps_its_minimum(itemsize, vec_wide, per_sm):
    """At every map of phases 17 and 18, in f32 and bf16, at 16-byte vectors
    and at 1, for the stats kernel's grid and the applies': a block of
    256-512 threads, lanes x C / vec of them, enough to fold 2 G sums; at
    least 2 x 132 blocks wherever the map holds 2 x 132 tiles of its
    minimum, at most ``per_sm`` an SM (rounded up to whole images); every
    tile at least its minimum rows unless it is the whole image."""
    for B, hw, C, groups in MAPS:
        vec = 16 // itemsize if vec_wide else 1
        if C // vec > G._SPLIT_MAX_THREADS:
            with pytest.raises(ValueError, match="at most"):
                G._split_plan(B, hw, C, vec, itemsize, SMS, per_sm)
            continue
        tiles, lanes, threads = G._split_plan(B, hw, C, vec, itemsize, SMS, per_sm)
        _, _, min_rows = G._split_block(C, vec, itemsize)
        case = (B, hw, C, groups, itemsize, vec)
        assert threads == lanes * (C // vec) and 256 <= threads <= 512 and 2 * groups <= threads, case
        if B * (hw // min_rows) >= 2 * SMS:
            assert B * tiles >= 2 * SMS, case
        assert B * tiles <= per_sm * SMS + B - 1, case
        rows = [r1 - r0 for r0, r1 in G._split_rows(hw, tiles)]
        assert tiles == 1 or min(rows) >= min_rows, case
        assert min_rows * C * itemsize >= G._SPLIT_MIN_TILE_BYTES and min_rows >= lanes, case


@pytest.mark.parametrize("C,vec,hw", [(256, 8, 32768), (256, 4, 32768), (2048, 8, 32), (1536, 8, 128),
                                      (768, 8, 2048), (192, 8, 4096), (64, 8, 8192), (96, 4, 35), (12, 1, 6),
                                      (48, 8, 7), (512, 1, 100)])
def test_plan_reads_every_value_once(C, vec, hw):
    """Each row of an image is read by one lane of one tile, each channel
    vector by one thread of a lane: the kernels' map from (block, thread) to
    (row, vector) is a partition of the image, as the plan cuts it."""
    for B, per_sm in ((1, 4), (2, 2), (2, 4), (8, 2)):
        tiles, lanes, threads = G._split_plan(B, hw, C, vec, 2, SMS, per_sm)
        cv = C // vec
        read = np.zeros((hw, cv), dtype=np.int64)
        edges = G._split_rows(hw, tiles)
        assert edges[0][0] == 0 and edges[-1][1] == hw and all(a[1] == b[0] for a, b in zip(edges, edges[1:]))
        for r0, r1 in edges:
            for t in range(threads):
                j, lane = t % cv, t // cv
                read[r0 + lane:r1:lanes, j] += 1
        assert (read == 1).all(), (B, C, vec, hw)


def test_plan_is_a_pure_function():
    """The same shape gives the same plan (the fold's order) every time."""
    for B, hw, C, _ in MAPS[:20]:
        assert G._split_plan(B, hw, C, 8, 2, SMS, G._STATS_PER_SM) == G._split_plan(B, hw, C, 8, 2, SMS, 2)


def _tiled_stats(x, groups, tiles):
    """The stats composed from the plan's row tiles: ``group_norm_stats_plain``
    of each tile (f32), the tiles' sums added in tile order in float64, so
    that only each tile's own rounding remains, and the extremes as min and
    max over the tiles."""
    B, hw, C = x.shape
    parts = [G.group_norm_stats_plain(x[:, r0:r1], groups, True) for r0, r1 in G._split_rows(hw, tiles)]
    sums = torch.zeros(2, B, groups, dtype=torch.float64)
    for p in parts:
        sums += p[0].double()
    lo = torch.stack([p[1][0] for p in parts]).amin(0)
    hi = torch.stack([p[1][1] for p in parts]).amax(0)
    return sums, torch.stack([lo, hi])


@pytest.mark.parametrize("B,hw,C,groups", [(2, 4096, 256, 32), (2, 2048, 768, 32), (3, 35, 96, 32),
                                           (2, 512, 64, 32), (2, 1024, 128, 16), (1, 7, 48, 16)])
def test_tiled_stats_compose_to_the_untiled(B, hw, C, groups):
    """In f32, the plan's tiles compose to the untiled sums within 1e-6
    relative, and to the extremes exactly: every row is in one tile. x takes
    the values k / 4, |k| <= 8, so that every partial sum at these sizes is
    exact in f32 (under 2^20 in steps of 1/16) and a difference can only be
    a row read twice or missed; the kernel's own f32 sums of randn values
    are held on the card to 1e-5 of the sum of |x|."""
    rs = np.random.RandomState(hw + C)
    x = torch.from_numpy((rs.randint(-8, 9, (B, hw, C)) / 4).astype(np.float32))
    tiles, _, _ = G._split_plan(B, hw, C, 4, 4, SMS, G._STATS_PER_SM)
    sums, ext = _tiled_stats(x, groups, tiles)
    ref, rext = G.group_norm_stats_plain(x, groups, True)
    assert tiles > 1 or hw < 64
    assert ((sums - ref.double()).abs() <= 1e-6 * ref.double().abs()).all()
    assert torch.equal(sums.float(), ref) and torch.equal(ext, rext)


def test_split_plan_refuses_what_the_kernels_do_not_take():
    """More than 512 vectors a row, or C not a multiple of the vector."""
    with pytest.raises(ValueError, match="at most 512"):
        G._split_plan(2, 64, 4096, 4, 4, SMS, G._STATS_PER_SM)
    with pytest.raises(ValueError, match="multiple"):
        G._split_plan(2, 64, 36, 8, 2, SMS, G._APPLY_PER_SM)


@pytest.mark.parametrize("entry", ["stats", "apply", "quant_apply", "stats_simple", "apply_simple",
                                   "quant_apply_simple"])
def test_split_wrappers_refuse_on_the_cpu(entry):
    """A kernel wrapper raises, before any launch, on a CPU tensor, on a
    non-contiguous x and on a dtype other than f32 and bf16; no launch is
    counted."""
    a = b = torch.zeros(2, 64)
    inv = torch.ones(2)
    call = {
        "stats": lambda x: G.group_norm_stats_cuda(x, 32, True),
        "apply": lambda x: G.group_norm_apply_cuda(x, a, b, True),
        "quant_apply": lambda x: G.group_norm_quant_apply_cuda(x, a, b, inv, True),
        "stats_simple": lambda x: G.group_norm_stats_simple(x, 32, True),
        "apply_simple": lambda x: G.group_norm_apply_simple(x, a, b, True),
        "quant_apply_simple": lambda x: G.group_norm_quant_apply_simple(x, a, b, inv, True),
    }[entry]
    counts = (G.group_norm_stats_cuda.launches, G.group_norm_apply_cuda.launches,
              G.group_norm_quant_apply_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(torch.zeros(2, 4, 64))
    with pytest.raises(ValueError, match="contiguous"):
        call(torch.zeros(2, 64, 4).transpose(1, 2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        call(torch.zeros(2, 4, 64, dtype=torch.float16))
    assert counts == (G.group_norm_stats_cuda.launches, G.group_norm_apply_cuda.launches,
                      G.group_norm_quant_apply_cuda.launches)
