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

The int8 path (``--conv_impl int8``, the JAX package's ``_QuantConvCore``):
``GroupNorm32(..., quantize=True)`` returns the quantizing GroupNorm's
``(q, s)``, and ``Conv2d`` -- an ``nn.Conv2d`` with the same ``weight`` and
``bias`` -- runs ``ops.quant.conv_prequant`` on such a pair, or
``ops.quant.int8_conv`` on a float input when its ``int8`` flag is set,
instead of cuDNN.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.groupnorm import group_norm, group_norm_quant
from ..ops.quant import _pack_weights, conv_prequant, int8_conv, quantize_per_out_channel


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

    def forward(self, x: torch.Tensor, activation: str | None = None, scale_shift=None,
                quantize: bool = False):
        """The normalized x, or with ``quantize`` the int8 pair (q, s): q in
        x's shape (s8, or integer values in x's dtype when gradients flow),
        s the (B,) f32 per-image scales (``ops.groupnorm.group_norm_quant``)."""
        B, C = x.shape[0], x.shape[1]
        if scale_shift is not None:
            scale_shift = tuple(t.reshape(B, C).float() for t in scale_shift)
        fn = group_norm_quant if quantize else group_norm
        y = fn(
            x.movedim(1, -1), self.weight, self.bias,
            groups=self.num_groups, eps=self.eps,
            silu=(activation == "silu"), scale_shift=scale_shift,
        )
        if quantize:
            return y[0].movedim(-1, 1), y[1]
        return y.movedim(-1, 1)


def normalization(channels: int) -> GroupNorm32:
    return GroupNorm32(channels)


def _zero_(module: nn.Module) -> nn.Module:
    for p in module.parameters():
        nn.init.zeros_(p)
    return module


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (cuDNN) that also runs the int8 path.

    ``forward(q, prequant_scales=s)`` is ``conv_prequant`` on a quantizing
    GroupNorm's (q, s), output in ``out_dtype``; with ``int8`` set, a float
    input goes through ``int8_conv`` (output in its dtype). The weight's
    quantization (``quantize_per_out_channel`` of the f32 weight, s8 in the
    weight's OHWI memory) is cached together with kernel K5's packed
    ``(K, KRp)`` rows of it, and recomputed when the weight's data pointer or
    version changes (``.to(device)``, ``load_state_dict``).
    """

    int8 = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._wq_key = None
        self._wq = None
        self._rows = None

    def packed_weight(self):
        """Kernel K5's rows of the current weight's ``w_q``: (K, KRp) s8, each
        output channel's (kh, kw, C) taps in order, zero-padded to a multiple
        of 32 bytes (``ops.quant._pack_weights``); a view of ``w_q``'s memory
        where no padding is needed."""
        self.quantized_weight()
        return self._rows

    def quantized_weight(self):
        """(w_q HWIO s8, s_w (K,) f32) of the current weight."""
        w = self.weight
        # an inference tensor (made under inference_mode) has no version counter
        key = (w.data_ptr(), None if w.is_inference() else w._version, w.device, w.dtype)
        if key != self._wq_key:
            with torch.no_grad():
                w_q, s_w = quantize_per_out_channel(w.permute(2, 3, 1, 0))
            # OHWI memory: the kernel's (K, kh*kw*C) rows are then a view
            self._wq = (w_q.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0), s_w)
            self._rows = _pack_weights(self._wq[0])
            self._wq_key = key
        return self._wq

    def forward(self, x, prequant_scales=None, out_dtype=None):
        if prequant_scales is None and not self.int8:
            w = self.weight
            if w.dtype != x.dtype or not w.is_contiguous(memory_format=torch.channels_last):
                # f32 parameters under a bf16 torso (training), as flax's
                # Conv(dtype=...) with f32 params: cast at the call, so
                # autograd hands the f32 weight an f32 gradient; a channels_last
                # copy where FSDP2 holds the weight NCHW (parallel/mesh.py), so
                # that cuDNN runs the convs it runs on the model's own weights
                w = w.to(x.dtype, memory_format=torch.channels_last)
                return self._conv_forward(x, w, self.bias.to(x.dtype))
            return super().forward(x)
        w_q, s_w = self.quantized_weight()
        w = self.weight
        if not w.is_contiguous(memory_format=torch.channels_last):
            w = w.contiguous(memory_format=torch.channels_last)  # FSDP2's NCHW weight, laid out as the model's
        w = w.permute(2, 3, 1, 0)  # HWIO view
        if prequant_scales is not None:
            y = conv_prequant(
                x.movedim(1, -1), prequant_scales, w, self.bias, self.stride[0],
                out_dtype or torch.float32, w_q=w_q, s_w=s_w, rows=self._rows,
            )
        else:
            y = int8_conv(x.movedim(1, -1), w, self.bias, self.stride[0], w_q=w_q, s_w=s_w, rows=self._rows)
        return y.movedim(-1, 1)


def conv2d(in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1, zero: bool = False) -> Conv2d:
    """Conv2d with symmetric (k-1)//2 padding; ``zero`` gives zero init."""
    conv = Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=(kernel_size - 1) // 2)
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
        # cast at the call where the parameters are f32 and the torso is not (as Conv2d)
        return F.linear(x, self.weight[:, :, 0].to(x.dtype), self.bias.to(x.dtype))


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool (reference Downsample avg_pool_nd path)."""
    return F.avg_pool2d(x, kernel_size=2, stride=2)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Exact nearest-x2 (reference F.interpolate(scale_factor=2, mode="nearest"))."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def bilinear_resize(x: torch.Tensor, new_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear upsampling with half-pixel centres, in x's dtype: what
    ``SuperResModel`` does to ``low_res`` (reference unet.py:679), and
    ``jax.image.resize(..., "linear")`` for a size that does not shrink.
    A shrink raises: JAX antialiases there and this path never shrinks."""
    if new_hw[0] < x.shape[-2] or new_hw[1] < x.shape[-1]:
        raise ValueError(f"bilinear_resize upsamples only: {tuple(x.shape[-2:])} -> {tuple(new_hw)}")
    return F.interpolate(x, size=tuple(new_hw), mode="bilinear", align_corners=False)


def upsample_nearest_2x_cl(x: torch.Tensor) -> torch.Tensor:
    """Nearest-x2 of a (B, C, H, W) channels_last tensor of any dtype (the
    s8 q of the int8 path), as an expand and reshape of its NHWC memory:
    channels_last out, the same values as ``upsample_nearest_2x``."""
    h = x.movedim(1, -1)
    B, H, W, C = h.shape
    h = h[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(B, 2 * H, 2 * W, C)
    return h.movedim(-1, 1)
