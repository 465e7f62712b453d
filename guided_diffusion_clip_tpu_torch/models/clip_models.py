"""Fork model variants: the CLIP-embedding-conditioned UNet.

Counterpart of ``guided_diffusion_clip_tpu/models/clip_models.py``; only the
serving model is ported so far (the SR and spatial-feature variants wait).
"""

from __future__ import annotations

import dataclasses

import torch

from .unet import UNetConfig, UNetModel


def UNetModel_clip_feat(config: UNetConfig, dtype: torch.dtype = torch.float32) -> UNetModel:
    """UNet conditioned on a 512-d CLIP image embedding (reference unet_other.py:25-41).

    The class-label table is replaced by a 2-layer MLP on the embedding;
    ``num_classes`` is repurposed as the embedding dim.
    """
    cfg = dataclasses.replace(config, variant="clip_feat", label_emb_type="mlp")
    return UNetModel(cfg, dtype=dtype)
