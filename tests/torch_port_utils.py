"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from guided_diffusion_clip_tpu.models.clip_models import UNetModel_clip_feat as JaxClipFeat
from guided_diffusion_clip_tpu.models.unet import EncoderUNetModel as JaxEncoder
from guided_diffusion_clip_tpu.models.unet import UNetConfig as JaxConfig
from guided_diffusion_clip_tpu.models.unet import UNetModel as JaxUNet
from guided_diffusion_clip_tpu_torch.models.clip_models import UNetModel_clip_feat
from guided_diffusion_clip_tpu_torch.models.unet import EncoderUNetModel, UNetConfig, UNetModel
from guided_diffusion_clip_tpu_torch.utils.convert import state_dict_from_flax


def random_params(shapes, seed):
    """Every leaf random (the init's zero output layers would make the
    forward exactly 0): norm scales near 1, everything else N(0, 0.1)."""
    rs = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, v in flat:
        noise = rs.standard_normal(v.shape).astype(np.float32)
        leaves.append(1.0 + 0.1 * noise if path[-1].key == "scale" else 0.1 * noise)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def clip_feat_pair(kw, seed=0):
    """(jax model, numpy params, torch model with the same weights) for a
    clip_feat UNet config ``kw``; shapes via eval_shape (no init compute)."""
    jm = JaxClipFeat(JaxConfig(**kw))
    s = kw["image_size"]
    shapes = jax.eval_shape(
        lambda: jm.init(
            jax.random.key(0), jnp.zeros((1, s, s, kw["in_channels"])), jnp.zeros((1,), jnp.int32),
            clip_feat=jnp.zeros((1, 512)),
        )
    )["params"]
    params = random_params(shapes, seed)
    tm = UNetModel_clip_feat(UNetConfig(**kw)).eval()
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    return jm, params, tm


def encoder_pair(kw, pool, seed=0):
    """(jax classifier, numpy params, torch classifier with the same weights)
    for an EncoderUNetModel config ``kw`` and ``pool``."""
    jm = JaxEncoder(JaxConfig(**kw), pool=pool)
    s = kw["image_size"]
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.key(0), jnp.zeros((1, s, s, kw["in_channels"])), jnp.zeros((1,), jnp.int32))
    )["params"]
    params = random_params(shapes, seed)
    tm = EncoderUNetModel(UNetConfig(**kw), pool=pool).eval()
    tm.load_state_dict(state_dict_from_flax(params, model="encoder", pool=pool), strict=True)
    return jm, params, tm


def upstream_pair(kw, seed=0):
    """(jax model, numpy params, torch model) for a plain ``unet``-variant
    UNet with a class table (the ADM-G generator), config ``kw``."""
    kw = dict(kw, variant="unet", label_emb_type="embedding")
    jm = JaxUNet(JaxConfig(**kw))
    s = kw["image_size"]
    shapes = jax.eval_shape(
        lambda: jm.init(
            jax.random.key(0), jnp.zeros((1, s, s, kw["in_channels"])), jnp.zeros((1,), jnp.int32),
            y=jnp.zeros((1,), jnp.int32),
        )
    )["params"]
    params = random_params(shapes, seed)
    tm = UNetModel(UNetConfig(**kw)).eval()
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    return jm, params, tm


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)
