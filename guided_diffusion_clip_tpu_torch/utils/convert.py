"""JAX parameter tree -> the port's ``state_dict``, without jax.

Reimplements ``guided_diffusion_clip_tpu/utils/torch_import.py``'s
``flax_path_to_torch_key`` and ``_from_flax_tensor`` on plain nested dicts of
numpy arrays, so the same weights can be given to both frameworks (the tests
do) and a flax tree saved as msgpack-free numpy can reach the port. Layouts:

  conv2d  (kh, kw, I, O) -> (O, I, kh, kw)
  dense   (I, O)         -> (O, I), or (O, I, 1) for the conv1d layers
                            (qkv, proj_out, qkv_proj, c_proj)
  positional_embedding (T+1, C) -> (C, T+1)
  norm scale/bias, biases, embeddings: unchanged

The output head's names depend on the model and, for the classifier
(``model="encoder"``), on its pool (JAX ``torch_import.py::_head_map``).

``model="clip"`` takes the JAX CLIP's ``(vision, text, logit_scale)`` trees
(``models/clip_vit.py``) to OpenAI CLIP's names, the inverse of the JAX
``import_openai_clip_pt``: the patch kernel HWIO -> OIHW, ``q_proj``,
``k_proj`` and ``v_proj`` concatenated into ``in_proj_weight`` and
``in_proj_bias``, dense kernels transposed, ``visual_projection`` and
``text_projection`` kept (W, D) as they are stored.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_SUBLAYER_MAP = {
    "in_norm": "in_layers.0",
    "in_conv": "in_layers.2",
    "emb_proj": "emb_layers.1",
    "out_norm": "out_layers.0",
    "out_conv": "out_layers.3",
    "skip": "skip_connection",
    "norm": "norm",
    "qkv": "qkv",
    "proj_out": "proj_out",
    "op": "op",
    "conv": "conv",
}
_BLOCK_RE = re.compile(r"^(input_blocks|output_blocks)_(\d+)_(\d+)$")
_MIDDLE_RE = re.compile(r"^middle_block_(\d+)$")
_CONV1D_NAMES = ("qkv", "proj_out", "qkv_proj", "c_proj")
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight"}


def _head_map(model: str, pool: str | None) -> Mapping[str, str]:
    """Output-head name map, per model and pool (reference unet.py:613-617, 825-854)."""
    if model == "unet":
        return {"out_norm": "out.0", "out_conv": "out.2"}
    if model != "encoder":
        raise ValueError(f"unknown model {model!r}")
    heads = {
        "adaptive": {"out_norm": "out.0", "out_conv": "out.3"},
        "attention": {"out_norm": "out.0", "out_pool": "out.2"},
        "spatial": {"out_0": "out.0", "out_3": "out.2"},
        "spatial_v2": {"out_0": "out.0", "out_norm": "out.1", "out_3": "out.3"},
    }
    if pool not in heads:
        raise ValueError(f"unknown pool {pool!r}")
    return heads[pool]


def flax_path_to_torch_key(path: tuple[str, ...], *, model: str = "unet", pool: str | None = None) -> str:
    """Translate one flax param path to the reference torch state_dict key."""
    parts = list(path)
    top = parts[0]
    # strip the Conv/Dense wrapper level ("conv"/"dense" just before the leaf)
    if len(parts) >= 2 and parts[-2] in ("conv", "dense"):
        parts = parts[:-2] + [parts[-1]]
    leaf_t = _LEAF.get(parts[-1], parts[-1])

    if top == "bias_feat":  # the SR-delta model's learned offset of the CLIP delta
        return "bias_feat"
    if top in ("time_embed_0", "time_embed_2"):
        return f"time_embed.{top[-1]}.{leaf_t}"
    if top == "label_emb":
        return f"label_emb.{leaf_t}"
    if top in ("label_emb_0", "label_emb_2"):
        return f"label_emb.{top[-1]}.{leaf_t}"
    head = _head_map(model, pool)
    if top in head:  # e.g. out_pool/qkv_proj/kernel -> out.2.qkv_proj.weight
        return ".".join([head[top], *parts[1:-1], leaf_t])

    m = _BLOCK_RE.match(top) or _MIDDLE_RE.match(top)
    if m is None:
        raise KeyError(f"unmapped flax path: {path}")
    if m.re is _MIDDLE_RE:
        prefix = f"middle_block.{m.group(1)}"
    else:
        prefix = f"{m.group(1)}.{m.group(2)}.{m.group(3)}"
    if len(parts) == 2:  # stem conv: input_blocks_0_0/{kernel,bias}
        return f"{prefix}.{leaf_t}"
    sub = parts[1]
    if sub not in _SUBLAYER_MAP:
        raise KeyError(f"unmapped sublayer {sub} in {path}")
    return f"{prefix}.{_SUBLAYER_MAP[sub]}.{leaf_t}"


def _from_flax_tensor(arr: np.ndarray, path) -> np.ndarray:
    arr = np.asarray(arr)
    if path[-1] == "positional_embedding":
        return arr.T
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 2 and path[-1] == "kernel":
        if any(p in _CONV1D_NAMES for p in path):
            return arr.T[:, :, None]
        return arr.T
    return arr


def _iter_leaves(tree: Mapping, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _iter_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _clip_block(p: Mapping, prefix: str) -> dict:
    f32 = lambda a: np.asarray(a, dtype=np.float32)
    attn = p["self_attn"]
    out = {
        f"{prefix}.attn.in_proj_weight": np.concatenate([f32(attn[f"{n}_proj"]["kernel"]).T for n in "qkv"]),
        f"{prefix}.attn.in_proj_bias": np.concatenate([f32(attn[f"{n}_proj"]["bias"]) for n in "qkv"]),
        f"{prefix}.attn.out_proj.weight": f32(attn["out_proj"]["kernel"]).T,
        f"{prefix}.attn.out_proj.bias": f32(attn["out_proj"]["bias"]),
    }
    for src, dst in (("layer_norm1", "ln_1"), ("layer_norm2", "ln_2")):
        out[f"{prefix}.{dst}.weight"], out[f"{prefix}.{dst}.bias"] = f32(p[src]["scale"]), f32(p[src]["bias"])
    for src, dst in (("fc1", "mlp.c_fc"), ("fc2", "mlp.c_proj")):
        out[f"{prefix}.{dst}.weight"], out[f"{prefix}.{dst}.bias"] = f32(p[src]["kernel"]).T, f32(p[src]["bias"])
    return out


def _clip_state_dict(vision: Mapping, text: Mapping, logit_scale) -> dict:
    f32 = lambda a: np.asarray(a, dtype=np.float32)
    out = {
        "visual.conv1.weight": f32(vision["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1),
        "visual.class_embedding": f32(vision["class_embedding"]),
        "visual.positional_embedding": f32(vision["position_embedding"]),
        "visual.proj": f32(vision["visual_projection"]["kernel"]),
        "token_embedding.weight": f32(text["token_embedding"]["embedding"]),
        "positional_embedding": f32(text["position_embedding"]),
        "text_projection": f32(text["text_projection"]["kernel"]),
        "logit_scale": np.asarray(logit_scale, dtype=np.float32),
    }
    for src, dst in ((vision["pre_layernorm"], "visual.ln_pre"), (vision["post_layernorm"], "visual.ln_post"),
                     (text["final_layer_norm"], "ln_final")):
        out[f"{dst}.weight"], out[f"{dst}.bias"] = f32(src["scale"]), f32(src["bias"])
    for tree, prefix in ((vision, "visual.transformer.resblocks"), (text, "transformer.resblocks")):
        i = 0
        while f"layer_{i}" in tree:
            out.update(_clip_block(tree[f"layer_{i}"], f"{prefix}.{i}"))
            i += 1
    return {k: torch.from_numpy(np.ascontiguousarray(v)).reshape(v.shape) for k, v in out.items()}


def state_dict_from_flax(params, *, model: str = "unet", pool: str | None = None) -> dict[str, torch.Tensor]:
    """The JAX package's parameter tree (nested dicts of numpy arrays) as the
    port's ``state_dict`` (f32 CPU tensors). ``model`` is "unet", "encoder"
    (which also names its ``pool``) or "clip", whose ``params`` are the JAX
    CLIP's ``(vision, text, logit_scale)``."""
    if model == "clip":
        return _clip_state_dict(*params)
    out = {}
    for path, value in _iter_leaves(params):
        arr = np.ascontiguousarray(_from_flax_tensor(np.asarray(value, dtype=np.float32), path))
        out[flax_path_to_torch_key(path, model=model, pool=pool)] = torch.from_numpy(arr)
    return out
