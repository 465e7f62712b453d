"""The ADM UNet (the ``unet`` and ``clip_feat`` variants) and the
``EncoderUNetModel`` classifier as PyTorch modules.

Counterpart of ``guided_diffusion_clip_tpu/models/unet.py``. Config-driven
modules; ``build_plan`` unrolls the structure exactly as the JAX package does,
and the module trees carry the reference torch ``state_dict`` names
(``input_blocks.3.0.in_layers.0.weight``, ``time_embed.0.weight``,
``label_emb.2.weight``, ``out.2.weight``, ``out.2.qkv_proj.weight``, ...), so
a reference-format ``.pt`` loads with ``load_state_dict(strict=True)``.

Precision split (as the JAX model and the reference's fp16_util): a bf16
torso when ``dtype=torch.bfloat16`` -- the torso's conv and conv1d weights are
cast once, at construction, and a loaded f32 checkpoint is cast on copy --
with f32 GroupNorm statistics, f32 embedding MLPs and emb projections, and an
f32 output head. The trainer keeps every parameter f32 (``model.float()``,
flax's ``param_dtype``); a torso conv then casts its weight to the
activations' bf16 at each call, so the gradients reach f32 parameters.

``use_checkpoint`` recomputes each ResBlock and AttentionBlock in the
backward (``torch.utils.checkpoint``, the JAX package's ``nn.remat``), in
train mode with gradients enabled; dropout runs in train mode.

Layout: logical NCHW in ``torch.channels_last`` memory (the JAX package's
NHWC in memory), activations and conv weights alike; attention blocks see
``(B, T, C)`` token views of it.

``conv_impl``: "xla" (or "auto", the JAX package's default) runs every conv
through cuDNN in the torso's dtype; "int8" is the JAX package's int8 path
(``GDC_CONV_IMPL=int8``, ``_QuantConvCore``): each ResBlock's GroupNorm+SiLU
quantizes (kernel K4) and the following conv consumes the s8 pair
(``conv_prequant``, kernel K5), except a down block's in_conv; every other
conv -- stem, skips, resampling convs, the output heads -- quantizes its
input per tensor (``int8_conv``, K5). The conv weights then stay f32 (the
JAX package quantizes the f32 parameter) while the attention projections
take the torso's dtype.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.attention import attention
from .nn import (
    Conv1x1,
    Conv2d,
    avg_pool_2x,
    conv2d,
    linear,
    normalization,
    timestep_embedding,
    upsample_nearest_2x,
    upsample_nearest_2x_cl,
)

CONV_IMPLS = ("auto", "xla", "int8")


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Static architecture config (mirrors the JAX UNetConfig)."""

    image_size: int
    in_channels: int
    model_channels: int
    out_channels: int
    num_res_blocks: int
    attention_resolutions: tuple  # downsample factors, e.g. (8, 16, 32)
    dropout: float = 0.0
    channel_mult: tuple = (1, 2, 4, 8)
    conv_resample: bool = True
    num_classes: Optional[int] = None
    use_checkpoint: bool = False
    num_heads: int = 1
    num_head_channels: int = -1
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    use_new_attention_order: bool = False
    # "embedding" = class table; "mlp" = 2-layer MLP on a float vector (the
    # JAX package's "mlp_zero" warm-start variant is not ported yet)
    label_emb_type: str = "embedding"
    # "unet" (plain UNetModel) or "clip_feat" (y = clip_feat); the other JAX
    # variants are not ported yet
    variant: str = "unet"

    @property
    def time_embed_dim(self) -> int:
        return self.model_channels * 4

    def resolve_heads(self, ch: int, upsample: bool = False) -> int:
        if self.num_head_channels != -1:
            assert ch % self.num_head_channels == 0
            return ch // self.num_head_channels
        if upsample and self.num_heads_upsample != -1:
            return self.num_heads_upsample
        return self.num_heads


def build_plan(cfg: UNetConfig):
    """Statically unroll the UNet structure (same plan as the JAX package).

    Returns (input_blocks, middle_block, output_blocks, feature_size), each
    block a list of layer-spec dicts of kind "stem", "res", "attn", "down" or
    "up". Indices match the reference's ``input_blocks.{i}.{j}`` keys.
    """
    mc = cfg.model_channels
    ch = int(cfg.channel_mult[0] * mc)
    input_blocks = [[dict(kind="stem", out=ch)]]
    feature_size = ch
    input_block_chans = [ch]
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            layers = [dict(kind="res", out=int(mult * mc))]
            ch = int(mult * mc)
            if ds in cfg.attention_resolutions:
                layers.append(dict(kind="attn", heads=cfg.resolve_heads(ch)))
            input_blocks.append(layers)
            feature_size += ch
            input_block_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            if cfg.resblock_updown:
                input_blocks.append([dict(kind="res", out=ch, down=True)])
            else:
                input_blocks.append([dict(kind="down", out=ch)])
            input_block_chans.append(ch)
            ds *= 2
            feature_size += ch

    middle_block = [
        dict(kind="res", out=ch),
        dict(kind="attn", heads=cfg.resolve_heads(ch)),
        dict(kind="res", out=ch),
    ]
    feature_size += ch

    output_blocks = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            input_block_chans.pop()
            layers = [dict(kind="res", out=int(mc * mult))]
            ch = int(mc * mult)
            if ds in cfg.attention_resolutions:
                layers.append(dict(kind="attn", heads=cfg.resolve_heads(ch, upsample=True)))
            if level and i == cfg.num_res_blocks:
                if cfg.resblock_updown:
                    layers.append(dict(kind="res", out=ch, up=True))
                else:
                    layers.append(dict(kind="up", out=ch))
                ds //= 2
            output_blocks.append(layers)
    return input_blocks, middle_block, output_blocks, feature_size


class ResBlock(nn.Module):
    """Residual block with timestep-embedding conditioning (reference unet.py:143-256).

    Submodule indices follow the reference Sequentials: ``in_layers.{0,2}``,
    ``emb_layers.1``, ``out_layers.{0,3}``, ``skip_connection``. With
    ``int8`` set (by the model's ``conv_impl``), the JAX package's int8
    branch: GroupNorm+SiLU emits (q, s) for the 3x3 conv after it.
    """

    int8 = False

    def __init__(self, channels, emb_channels, out_channels, dropout=0.0,
                 use_scale_shift_norm=False, up=False, down=False):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down
        self.in_layers = nn.ModuleList(
            [normalization(channels), nn.SiLU(), conv2d(channels, out_channels, 3)]
        )
        self.emb_layers = nn.ModuleList(
            [nn.SiLU(), linear(emb_channels, 2 * out_channels if use_scale_shift_norm else out_channels)]
        )
        self.out_layers = nn.ModuleList([
            normalization(out_channels), nn.SiLU(), nn.Dropout(dropout),
            conv2d(out_channels, out_channels, 3, zero=True),
        ])
        if out_channels == channels:
            self.skip_connection = nn.Identity()
        else:
            self.skip_connection = conv2d(channels, out_channels, 1)

    def forward(self, x, emb):
        dtype = x.dtype  # the torso's compute dtype
        if self.int8 and not self.down:
            # nearest-x2 duplicates values, so an up block's q stays integer
            # with the same per-image scale; a down block's avg-pool would
            # leave the int8 grid, so it takes the float branch below
            q, s = self.in_layers[0](x, activation="silu", quantize=True)
            if self.up:
                q, x = upsample_nearest_2x_cl(q), upsample_nearest_2x(x)
            h = self.in_layers[2](q, prequant_scales=s, out_dtype=dtype)
        else:
            h = self.in_layers[0](x, activation="silu")
            if self.up:
                h, x = upsample_nearest_2x(h), upsample_nearest_2x(x)
            elif self.down:
                h, x = avg_pool_2x(h), avg_pool_2x(x)
            h = self.in_layers[2](h)
        # emb MLP stays f32, cast at the join like the reference's .type(h.dtype)
        emb_out = self.emb_layers[1](F.silu(emb)).to(h.dtype)[:, :, None, None]
        # dropping q entries would break the q * s pairing
        quant_out = self.int8 and (self.out_layers[2].p == 0.0 or not self.training)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self.out_layers[0](h, activation="silu", scale_shift=(scale, shift), quantize=quant_out)
        else:
            h = self.out_layers[0](h + emb_out, activation="silu", quantize=quant_out)
        if quant_out:
            h = self.out_layers[3](h[0], prequant_scales=h[1], out_dtype=dtype)
        else:
            h = self.out_layers[3](self.out_layers[2](h))
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """Global self-attention over flattened spatial tokens (reference unet.py:259-305)."""

    def __init__(self, channels, num_heads, use_new_attention_order=False):
        super().__init__()
        self.num_heads = num_heads
        self.new_order = use_new_attention_order
        self.norm = normalization(channels)
        self.qkv = Conv1x1(channels, 3 * channels)
        self.proj_out = Conv1x1(channels, channels, zero=True)

    def forward(self, x):
        B, C, H, W = x.shape
        h = x.movedim(1, -1).reshape(B, H * W, C)  # a view of channels_last memory
        hn = self.norm(h.transpose(1, 2)).transpose(1, 2)
        a = attention(self.qkv(hn), self.num_heads, new_order=self.new_order)
        a = self.proj_out(a)
        return (h + a).reshape(B, H, W, C).movedim(-1, 1)


class Downsample(nn.Module):
    """Stride-2 conv or 2x2 avgpool (reference unet.py:113-140)."""

    def __init__(self, channels, use_conv, out_channels):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.op = conv2d(channels, out_channels, 3, stride=2)
        elif channels != out_channels:
            raise ValueError("avg-pool Downsample cannot change the channel count")

    def forward(self, x):
        return self.op(x) if self.use_conv else avg_pool_2x(x)


class Upsample(nn.Module):
    """Nearest-x2 + optional conv (reference unet.py:81-110)."""

    def __init__(self, channels, use_conv, out_channels):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.conv = conv2d(channels, out_channels, 3)

    def forward(self, x):
        x = upsample_nearest_2x(x)
        return self.conv(x) if self.use_conv else x


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling head (reference unet.py:22-51).

    The mean token is prepended to the HW tokens, a learned
    ``positional_embedding`` of the reference's (C, HW + 1) shape is added,
    and qkv_proj / attention (new head order, T = HW + 1) / c_proj give the
    output of token 0. It runs in the input's dtype: the classifier hands it
    f32, as the JAX pool keeps its default dtype in a bf16 classifier.
    """

    def __init__(self, spacial_dim: int, embed_dim: int, num_head_channels: int, output_dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.randn(embed_dim, spacial_dim**2 + 1) / embed_dim**0.5
        )
        self.qkv_proj = Conv1x1(embed_dim, 3 * embed_dim)
        self.c_proj = Conv1x1(embed_dim, output_dim)
        self.num_heads = embed_dim // num_head_channels

    def forward(self, x):
        B, C, H, W = x.shape
        h = x.movedim(1, -1).reshape(B, H * W, C)
        h = torch.cat([h.mean(dim=1, keepdim=True), h], dim=1)  # (B, HW + 1, C)
        h = h + self.positional_embedding.t()[None].to(h.dtype)
        a = attention(self.qkv_proj(h), self.num_heads, new_order=True)
        return self.c_proj(a[:, 0])  # per token: only token 0 is kept


class TimestepEmbedSequential(nn.ModuleList):
    """One UNet block: its layers in order, ResBlocks also given the embedding.

    With ``use_checkpoint``, ResBlocks and AttentionBlocks run under
    ``torch.utils.checkpoint`` in train mode with gradients enabled: their
    activations are recomputed in the backward (the default generator's
    state is replayed, so dropout draws the same mask).
    """

    def __init__(self, use_checkpoint: bool = False):
        super().__init__()
        self.use_checkpoint = use_checkpoint

    def forward(self, x, emb):
        remat = self.use_checkpoint and self.training and torch.is_grad_enabled()
        for layer in self:
            args = (x, emb) if isinstance(layer, ResBlock) else (x,)
            if remat and isinstance(layer, (ResBlock, AttentionBlock)):
                x = torch.utils.checkpoint.checkpoint(layer, *args, use_reentrant=False)
            else:
                x = layer(*args)
        return x


def _make_block(cfg: UNetConfig, specs, ch):
    """The modules of one planned block, from ``ch`` input channels."""
    layers = TimestepEmbedSequential(cfg.use_checkpoint)
    for spec in specs:
        kind = spec["kind"]
        if kind == "stem":
            layers.append(conv2d(ch, spec["out"], 3))
            ch = spec["out"]
        elif kind == "res":
            layers.append(ResBlock(
                ch, cfg.time_embed_dim, spec["out"], dropout=cfg.dropout,
                use_scale_shift_norm=cfg.use_scale_shift_norm,
                up=spec.get("up", False), down=spec.get("down", False),
            ))
            ch = spec["out"]
        elif kind == "attn":
            layers.append(AttentionBlock(ch, spec["heads"], cfg.use_new_attention_order))
        elif kind == "down":
            layers.append(Downsample(ch, cfg.conv_resample, spec["out"]))
            ch = spec["out"]
        elif kind == "up":
            layers.append(Upsample(ch, cfg.conv_resample, spec["out"]))
            ch = spec["out"]
        else:
            raise ValueError(kind)
    return layers, ch


def _convert_torso(blocks, dtype: torch.dtype, int8: bool = False) -> None:
    """Cast the conv and conv1d weights (not the GroupNorms or emb
    projections) under ``blocks`` to ``dtype``, as the reference's
    convert_to_fp16. Under int8 the convs keep f32 weights: their int8
    quantization is taken of the f32 parameter, as in the JAX package (a
    bf16-rounded copy would give other w_q and s_w)."""
    kinds = (Conv1x1,) if int8 else (nn.Conv2d, Conv1x1)
    for block in blocks:
        for m in block.modules():
            if isinstance(m, kinds):
                m.to(dtype)


def _set_conv_impl(model: nn.Module, conv_impl: str) -> bool:
    """Validate ``conv_impl`` and flag the model's convs and ResBlocks for
    the int8 path; returns whether it is int8."""
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl {conv_impl!r}: choose from {CONV_IMPLS}")
    int8 = conv_impl == "int8"
    for m in model.modules():
        if isinstance(m, (Conv2d, ResBlock)):
            m.int8 = int8
    return int8


class UNetModel(nn.Module):
    """The ADM UNet (reference unet.py:396-664), ``unet`` and ``clip_feat`` variants.

    Call: ``model(x, timesteps, y=None, clip_feat=None)`` with x of shape
    (B, in_channels, H, W); returns (B, out_channels, H, W) in x's dtype.
    ``low_res``, ``clip_feat2`` and ``img2`` (the inputs of the SR and
    image-pair variants, which the data loader yields with every CLIP batch)
    are accepted and ignored, as by the JAX model, so one call serves every
    variant.
    ``conv_impl``: "auto"/"xla" (cuDNN) or "int8" (see the module docstring).
    """

    def __init__(self, config: UNetConfig, dtype: torch.dtype = torch.float32, conv_impl: str = "auto"):
        super().__init__()
        if config.variant not in ("unet", "clip_feat"):
            raise NotImplementedError(f"UNet variant {config.variant!r}: not yet ported")
        self.config = cfg = config
        self.dtype = dtype
        mc, ted = cfg.model_channels, cfg.time_embed_dim

        self.time_embed = nn.Sequential(linear(mc, ted), nn.SiLU(), linear(ted, ted))
        if cfg.num_classes is not None:
            if cfg.label_emb_type == "embedding":
                self.label_emb = nn.Embedding(cfg.num_classes, ted)
            elif cfg.label_emb_type == "mlp":
                self.label_emb = nn.Sequential(linear(cfg.num_classes, ted), nn.SiLU(), linear(ted, ted))
            else:
                raise NotImplementedError(f"label_emb_type {cfg.label_emb_type!r}: not yet ported")

        input_plan, middle_plan, output_plan, _ = build_plan(cfg)
        ch = cfg.in_channels
        chans = []
        self.input_blocks = nn.ModuleList()
        for block in input_plan:
            layers, ch = _make_block(cfg, block, ch)
            self.input_blocks.append(layers)
            chans.append(ch)
        self.middle_block, ch = _make_block(cfg, middle_plan, ch)
        self.output_blocks = nn.ModuleList()
        for block in output_plan:
            layers, ch = _make_block(cfg, block, ch + chans.pop())
            self.output_blocks.append(layers)
        self.out = nn.Sequential(
            normalization(ch), nn.SiLU(), conv2d(ch, cfg.out_channels, 3, zero=True)
        )
        self.conv_impl = conv_impl
        self.int8 = _set_conv_impl(self, conv_impl)
        if dtype != torch.float32:
            self.convert_torso(dtype)
        # conv weights in the activations' layout, once: cuDNN would otherwise
        # copy every NCHW weight to channels_last on every call
        self.to(memory_format=torch.channels_last)

    def convert_torso(self, dtype: torch.dtype) -> None:
        """Cast the torso's conv (not under int8) and conv1d weights to ``dtype``."""
        _convert_torso((self.input_blocks, self.middle_block, self.output_blocks), dtype, self.int8)

    def forward(self, x, timesteps, y=None, clip_feat=None, low_res=None, clip_feat2=None, img2=None,
                deep_cache=None, cache_mode: str = "off", cache_cut: int = 0):
        """``cache_mode`` / ``cache_cut`` / ``deep_cache``: DeepCache-style block
        caching (Ma et al. 2023), as the JAX ``UNetModel.__call__``:

          "off"      plain forward, returns the output (default)
          "full"     full forward; returns ``(out, deep)`` where ``deep`` is the
                     activation entering the first shallow output block
                     (before its skip concat)
          "shallow"  runs only ``input_blocks[:cut]`` and the last ``cut``
                     output blocks around ``deep_cache``; returns
                     ``(out, deep_cache)``

        ``cache_cut`` is the number of shallow input blocks; 0 picks
        ``num_res_blocks + 1`` (the full-resolution level).
        """
        cfg = self.config
        if x.shape[1] != cfg.in_channels:
            raise ValueError(f"input channels {x.shape[1]} != config {cfg.in_channels}")
        if cfg.variant == "clip_feat" and cfg.num_classes is not None:
            if clip_feat is None:
                raise ValueError("clip_feat-conditional model requires clip_feat")
            y = clip_feat.reshape(x.shape[0], -1).float()

        # timestep + label embedding, f32
        emb = self.time_embed(timestep_embedding(timesteps, cfg.model_channels))
        if cfg.num_classes is not None:
            if y is None:
                raise ValueError("class-conditional model requires y")
            emb = emb + self.label_emb(y if cfg.label_emb_type == "embedding" else y.float())
        elif y is not None and cfg.variant != "unet":
            raise ValueError("y given to an unconditional model")

        n_in = len(self.input_blocks)
        assert cache_mode in ("off", "full", "shallow"), cache_mode
        cut = cache_cut if cache_cut > 0 else cfg.num_res_blocks + 1
        if cache_mode != "off":
            assert 1 <= cut <= n_in, (cut, n_in)
            assert (cache_mode == "shallow") == (deep_cache is not None), (
                "deep_cache must be given exactly when cache_mode='shallow'"
            )

        # torso, in self.dtype
        h = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        hs = []
        shallow = cache_mode == "shallow"
        for block in itertools.islice(self.input_blocks, cut if shallow else None):
            h = block(h, emb)
            hs.append(h)
        deep_out = None
        if shallow:
            h = deep_cache.to(dtype=self.dtype, memory_format=torch.channels_last)
            out_start = n_in - cut
        else:
            h = self.middle_block(h, emb)
            out_start = 0
        for i in range(out_start, n_in):
            if cache_mode == "full" and i == n_in - cut:
                deep_out = h
            h = self.output_blocks[i](torch.cat([h, hs.pop()], dim=1), emb)

        # output head, f32 (or x's dtype)
        h = h.to(x.dtype)
        h = self.out[0](h, activation="silu")
        out = self.out[2](h)
        if cache_mode == "off":
            return out
        return out, (deep_out if cache_mode == "full" else deep_cache)


class EncoderUNetModel(nn.Module):
    """Half-UNet classifier/encoder with a pooling head (reference
    unet.py:684-895; JAX ``EncoderUNetModel``).

    ``pool`` is "adaptive", "attention", "spatial" or "spatial_v2"; the head
    keeps the reference's ``out.{i}`` indices for each (``out.0`` and
    ``out.3`` for adaptive; ``out.0`` and ``out.2.{positional_embedding,
    qkv_proj,c_proj}`` for attention; ``out.0`` and ``out.2`` for spatial;
    ``out.0``, ``out.1`` and ``out.3`` for spatial_v2). The torso runs in
    ``dtype``, the head in f32. Call: ``model(x, timesteps)`` with x of shape
    (B, in_channels, H, W); returns (B, out_channels) logits in x's dtype.
    ``conv_impl`` as for ``UNetModel``.
    """

    def __init__(self, config: UNetConfig, pool: str = "adaptive", dtype: torch.dtype = torch.float32,
                 conv_impl: str = "auto"):
        super().__init__()
        if pool not in ("adaptive", "attention", "spatial", "spatial_v2"):
            raise NotImplementedError(f"unexpected pool: {pool}")
        self.config = cfg = config
        self.pool = pool
        self.dtype = dtype
        mc, ted = cfg.model_channels, cfg.time_embed_dim
        self.time_embed = nn.Sequential(linear(mc, ted), nn.SiLU(), linear(ted, ted))

        input_plan, middle_plan, _, feature_size = build_plan(cfg)
        ch = cfg.in_channels
        self.input_blocks = nn.ModuleList()
        for block in input_plan:
            layers, ch = _make_block(cfg, block, ch)
            self.input_blocks.append(layers)
        self.middle_block, ch = _make_block(cfg, middle_plan, ch)

        out = cfg.out_channels
        if pool == "adaptive":
            self.out = nn.Sequential(
                normalization(ch), nn.SiLU(), nn.AdaptiveAvgPool2d((1, 1)),
                conv2d(ch, out, 1, zero=True), nn.Flatten(),
            )
        elif pool == "attention":
            if cfg.num_head_channels == -1:
                raise ValueError("the attention pool needs num_head_channels")
            ds = 2 ** (len(cfg.channel_mult) - 1)
            self.out = nn.Sequential(
                normalization(ch), nn.SiLU(),
                AttentionPool2d(cfg.image_size // ds, ch, cfg.num_head_channels, out),
            )
        elif pool == "spatial":
            self.out = nn.Sequential(nn.Linear(feature_size, 2048), nn.ReLU(), nn.Linear(2048, out))
        else:
            self.out = nn.Sequential(
                nn.Linear(feature_size, 2048), normalization(2048), nn.SiLU(), nn.Linear(2048, out)
            )
        self.conv_impl = conv_impl
        self.int8 = _set_conv_impl(self, conv_impl)
        if dtype != torch.float32:
            _convert_torso((self.input_blocks, self.middle_block), dtype, self.int8)
        self.to(memory_format=torch.channels_last)

    def forward(self, x, timesteps):
        cfg = self.config
        if x.shape[1] != cfg.in_channels:
            raise ValueError(f"input channels {x.shape[1]} != config {cfg.in_channels}")
        emb = self.time_embed(timestep_embedding(timesteps, cfg.model_channels))
        h = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        spatial = self.pool.startswith("spatial")
        results = []
        for block in self.input_blocks:
            h = block(h, emb)
            if spatial:
                results.append(h.to(x.dtype).mean(dim=(2, 3)))
        h = self.middle_block(h, emb)

        if self.pool == "adaptive":
            h = self.out[0](h.to(x.dtype), activation="silu")
            h = self.out[3](h.mean(dim=(2, 3), keepdim=True))
            return h.reshape(h.shape[0], -1)
        if self.pool == "attention":
            return self.out[2](self.out[0](h.to(x.dtype), activation="silu"))
        results.append(h.to(x.dtype).mean(dim=(2, 3)))
        h = self.out[0](torch.cat(results, dim=-1))
        if self.pool == "spatial_v2":
            h = self.out[1](h[:, :, None], activation="silu")[:, :, 0]
            return self.out[3](h)
        return self.out[2](F.relu(h))
