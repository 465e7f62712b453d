"""Load reference-format ``.pt`` state_dicts into the port's models.

The port's native format is the reference torch ``state_dict``. A JAX
``.flax`` checkpoint reaches it as ``.pt`` through the JAX package's own
``guided_diffusion_clip_tpu.utils.checkpoint.save_pt_copy``; reading msgpack
``.flax`` here would need flax, which the port does not import.
"""

from __future__ import annotations

import torch
from torch import nn


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Read a ``.pt`` state_dict onto the CPU (tensors only, no pickled code)."""
    if not path.endswith(".pt"):
        raise ValueError(
            f"{path}: the PyTorch package loads reference-format .pt files; convert a "
            ".flax checkpoint with guided_diffusion_clip_tpu.utils.checkpoint.save_pt_copy"
        )
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model_weights(model: nn.Module, path: str) -> nn.Module:
    """``model.load_state_dict(strict=True)`` from a ``.pt`` file; every key
    must match. Weights are cast on copy to each parameter's dtype (the
    model's bf16 torso takes an f32 checkpoint). The same for the UNet and
    the ``EncoderUNetModel`` classifier, whose head keys depend on its pool."""
    model.load_state_dict(load_state_dict(path), strict=True)
    return model
