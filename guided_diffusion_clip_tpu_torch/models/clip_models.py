"""Fork model variants: the CLIP-embedding-conditioned UNet and the SR models.

Counterpart of ``guided_diffusion_clip_tpu/models/clip_models.py`` (reference
unet_other.py). Every variant is a thin configuration over the one
``UNetModel`` (models/unet.py), which implements each variant's input
concatenation and conditioning; this file gives the reference's factory
names and the warm-start surgery of ``SRImageModel_Feat_cont``
(unet_other.py:116-136) on a torch state_dict.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from .unet import UNetConfig, UNetModel


def UNetModel_clip_feat(config: UNetConfig, dtype: torch.dtype = torch.float32,
                        conv_impl: str = "auto") -> UNetModel:
    """UNet conditioned on a 512-d CLIP image embedding (reference unet_other.py:25-41).

    The class-label table is replaced by a 2-layer MLP on the embedding;
    ``num_classes`` is repurposed as the embedding dim.
    """
    cfg = dataclasses.replace(config, variant="clip_feat", label_emb_type="mlp")
    return UNetModel(cfg, dtype=dtype, conv_impl=conv_impl)


def SRImageModel_Feat(config: UNetConfig, dtype: torch.dtype = torch.float32,
                      conv_impl: str = "auto") -> UNetModel:
    """Image-to-image model conditioned on the CLIP feature delta
    (reference unet_other.py:43-77): x = x ++ img2, y = clip_feat -
    clip_feat2 + bias_feat. ``config.in_channels`` counts both images (6)."""
    cfg = dataclasses.replace(config, variant="sr_img_feat", label_emb_type="mlp")
    return UNetModel(cfg, dtype=dtype, conv_impl=conv_impl)


def SRImageModel_Feat_cont(config: UNetConfig, dtype: torch.dtype = torch.float32,
                           conv_impl: str = "auto") -> UNetModel:
    """``SRImageModel_Feat`` for a warm start from a plain checkpoint: the
    label MLP starts at zero (reference unet_other.py:90-95) and the stem is
    widened on load (``warmstart_from_plain_checkpoint``)."""
    cfg = dataclasses.replace(config, variant="sr_img_feat", label_emb_type="mlp_zero")
    return UNetModel(cfg, dtype=dtype, conv_impl=conv_impl)


def SpatFeatureModel(config: UNetConfig, dtype: torch.dtype = torch.float32,
                     conv_impl: str = "auto") -> UNetModel:
    """UNet with the 512-d feature tiled into two 128x128 input planes
    (reference unet_other.py:6-22). ``config.in_channels`` is the image's + 2."""
    cfg = dataclasses.replace(config, variant="spat_feat")
    return UNetModel(cfg, dtype=dtype, conv_impl=conv_impl)


def SuperResModel(config: UNetConfig, dtype: torch.dtype = torch.float32,
                  conv_impl: str = "auto") -> UNetModel:
    """Upstream SR model: x ++ bilinear-upsampled low_res (reference
    unet.py:667-681). ``config.in_channels`` counts both (6)."""
    cfg = dataclasses.replace(config, variant="super_res")
    return UNetModel(cfg, dtype=dtype, conv_impl=conv_impl)


def widen_stem_kernel(kernel: torch.Tensor, new_in: int) -> torch.Tensor:
    """Warm-start surgery (reference unet_other.py:121-136): the stem conv's
    OIHW weight (O, I_old, kh, kw) widened to (O, new_in, kh, kw), the old
    weights in the first I_old input channels and zeros in the rest."""
    out, old_in, kh, kw = kernel.shape
    if new_in < old_in:
        raise ValueError(f"widen_stem_kernel: {old_in} input channels cannot narrow to {new_in}")
    widened = kernel.new_zeros((out, new_in, kh, kw))
    widened[:, :old_in] = kernel
    return widened


def warmstart_from_plain_checkpoint(model: UNetModel, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a plain (narrow-stem) UNet checkpoint, a CLIP UNet's or an
    unconditional one, into an ``SRImageModel_Feat_cont`` ``model`` in place
    (reference unet_other.py:116-136; JAX ``warmstart_from_plain_checkpoint``).

    The stem's weight ``input_blocks.0.0.weight`` is widened with zeros for
    the img2 channels. ``label_emb.*`` and ``bias_feat`` may be absent: they
    keep the model's init (the zero MLP, the random bias); where present
    they load, as the reference's non-strict load does. Any other missing
    key, and any key the model does not have, raises.
    """
    own = model.state_dict()
    sd = dict(state_dict)
    stem = "input_blocks.0.0.weight"
    if stem in sd and sd[stem].shape[1] < own[stem].shape[1]:
        sd[stem] = widen_stem_kernel(sd[stem], own[stem].shape[1])
    optional = {k for k in own if k == "bias_feat" or k.startswith("label_emb.")}
    missing = set(own) - set(sd) - optional
    unexpected = set(sd) - set(own)
    if missing or unexpected:
        raise KeyError(f"warm start: missing {sorted(missing)[:10]}, unexpected {sorted(unexpected)[:10]}")
    model.load_state_dict(sd, strict=False)
