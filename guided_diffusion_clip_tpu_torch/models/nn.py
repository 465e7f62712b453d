"""NN primitives with the numerics contracts the ADM checkpoints depend on.

Counterpart of ``guided_diffusion_clip_tpu/models/nn.py``:
  - GroupNorm computes its statistics in f32 and casts back (GroupNorm32),
    32 groups, eps 1e-5;
  - zero-initialized output convs/projections (the ``zero_module`` contract);
  - sinusoidal timestep embedding, max_period 1e4, [cos, sin] channel order;
  - convs pad symmetrically by (k-1)//2 on both sides, so stride-2 windows
    sit where the reference's do.

Modules take logical NCHW tensors in ``torch.channels_last`` memory, which is
the JAX package's NHWC in memory; GroupNorm32 reaches ``ops.groupnorm``
through ``movedim(1, -1)``, a view, so nothing is copied on the way to the
kernel. Parameters carry the reference torch ``state_dict`` names.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.groupnorm import group_norm


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embeddings, [cos, sin] order, computed in f32.

    ``timesteps`` may be fractional (rescaled respacing).
    """
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


class GroupNorm32(nn.Module):
    """GroupNorm over the channel axis (dim 1), statistics in f32.

    Output is cast back to the input dtype, so a bf16 torso keeps its dtype
    across the norm. Optionally fuses SiLU and the adaGN scale-shift
    GN(h) * (1 + s) + b into the same passes (``ops.groupnorm``).
    """

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups = min(num_groups, channels)
        if channels % self.num_groups:
            raise ValueError(f"channels {channels} not divisible by {self.num_groups} groups")
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, activation: str | None = None, scale_shift=None) -> torch.Tensor:
        B, C = x.shape[0], x.shape[1]
        if scale_shift is not None:
            scale_shift = tuple(t.reshape(B, C).float() for t in scale_shift)
        y = group_norm(
            x.movedim(1, -1), self.weight, self.bias,
            groups=self.num_groups, eps=self.eps,
            silu=(activation == "silu"), scale_shift=scale_shift,
        )
        return y.movedim(-1, 1)


def normalization(channels: int) -> GroupNorm32:
    return GroupNorm32(channels)


def _zero_(module: nn.Module) -> nn.Module:
    for p in module.parameters():
        nn.init.zeros_(p)
    return module


def conv2d(in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1, zero: bool = False) -> nn.Conv2d:
    """Conv2d with symmetric (k-1)//2 padding; ``zero`` gives zero init."""
    conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=(kernel_size - 1) // 2)
    return _zero_(conv) if zero else conv


def linear(in_f: int, out_f: int, zero: bool = False) -> nn.Linear:
    lin = nn.Linear(in_f, out_f)
    return _zero_(lin) if zero else lin


class Conv1x1(nn.Module):
    """The reference's ``conv_nd(1, in, out, 1)`` over (B, T, C) tokens.

    The weight keeps the conv1d layout ``(O, I, 1)`` of the reference
    state_dict (``qkv``, ``proj_out``); the product is a linear map over the
    channel (last) axis, as the JAX package's Dense.
    """

    def __init__(self, in_ch: int, out_ch: int, zero: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 1))
        self.bias = nn.Parameter(torch.empty(out_ch))
        if zero:
            nn.init.zeros_(self.weight)
            nn.init.zeros_(self.bias)
        else:  # torch Conv1d's default init
            nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
            bound = 1.0 / math.sqrt(in_ch)
            nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0], self.bias)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool (reference Downsample avg_pool_nd path)."""
    return F.avg_pool2d(x, kernel_size=2, stride=2)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Exact nearest-x2 (reference F.interpolate(scale_factor=2, mode="nearest"))."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
