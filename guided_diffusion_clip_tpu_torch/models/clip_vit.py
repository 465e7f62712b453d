"""CLIP ViT-B/32 image and text encoders (for CLIP embeddings and CLIP guidance).

Counterpart of ``guided_diffusion_clip_tpu/models/clip_vit.py``. The fork
conditions on precomputed CLIP ViT-B/32 image embeddings
(``data/image_datasets.py``, two a file: plain and flipped) and its model card
samples with CLIP guidance; these modules compute both.

The module tree carries OpenAI CLIP's ``state_dict`` names, so a released
``ViT-B-32.pt`` loads with ``strict=True`` (``load_clip_params``):

  visual.conv1, visual.class_embedding, visual.positional_embedding,
  visual.ln_pre, visual.transformer.resblocks.{i}.{ln_1, attn.in_proj_weight,
  attn.in_proj_bias, attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj},
  visual.ln_post, visual.proj (W, D);
  token_embedding, positional_embedding, transformer.resblocks.{i},
  ln_final, text_projection (W, D), logit_scale.

``CLIPVisionEncoder`` holds the ``visual.*`` tree, ``CLIPTextEncoder`` the
text tower's keys, and ``CLIP`` (a text encoder with ``visual`` and
``logit_scale`` beside it, as OpenAI's own class is laid out) the whole file.
The arithmetic is the JAX modules': pre-LN blocks with quickGELU, packed q, k,
v projections, logits scaled by 1/sqrt(d) after QK^T, an additive causal mask
of -inf in the text tower, softmax in f32 with its weights cast to the input
dtype, the vision tower projecting token 0 after ``ln_post``, the text tower
pooling at ``argmax(token_ids)`` (the end-of-text token has the highest id).
That attention is XLA math in the JAX package, not a Pallas kernel, and is
plain PyTorch ops here. Images are NCHW.
"""

from __future__ import annotations

import dataclasses
import math
import os
import zipfile
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..diffusion import gaussian as G
from ..diffusion.guidance import potential_cond_fn
from ..parallel import sp

IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    # vision
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    # text
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    # joint
    embed_dim: int = 512


# GDC_CLIP_TINY=1: the tiny CLIP of the JAX clip_guided_sample.py, for tests with random weights
TINY_CLIP = CLIPConfig(image_size=32, patch_size=16, vision_width=64, vision_layers=2, vision_heads=4,
                       vocab_size=100, context_length=12, text_width=32, text_layers=2, text_heads=2, embed_dim=16)


def clip_config() -> CLIPConfig:
    """ViT-B/32, or the tiny test config under ``GDC_CLIP_TINY``."""
    return TINY_CLIP if os.environ.get("GDC_CLIP_TINY") else CLIPConfig()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class MHA(nn.Module):
    """Multi-head attention with packed q, k, v projections (OpenAI's
    ``in_proj_weight`` / ``in_proj_bias`` and ``out_proj``)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width).normal_(std=width ** -0.5))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        B, T, C = x.shape
        d = C // self.heads
        q, k, v = (
            h.reshape(B, T, self.heads, d).transpose(1, 2)
            for h in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        )
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(d)
        if mask is not None:
            logits = logits + mask
        w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        return self.out_proj((w @ v).transpose(1, 2).reshape(B, T, C))


class MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x):
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    """The pre-LN block (JAX ``TransformerBlock``)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = MHA(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = MLP(width)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads) for _ in range(layers))

    def forward(self, x, mask=None):
        for block in self.resblocks:
            x = block(x, mask)
        return x


class CLIPVisionEncoder(nn.Module):
    """The image tower: ``pixels`` (B, 3, S, S), CLIP-normalized, to (B, embed_dim)."""

    def __init__(self, config: CLIPConfig):
        super().__init__()
        self.config = cfg = config
        W, P = cfg.vision_width, cfg.patch_size
        n = (cfg.image_size // P) ** 2
        self.conv1 = nn.Conv2d(3, W, P, stride=P, bias=False)
        self.class_embedding = nn.Parameter(torch.randn(W) * W ** -0.5)
        self.positional_embedding = nn.Parameter(torch.randn(n + 1, W) * W ** -0.5)
        self.ln_pre = nn.LayerNorm(W, eps=1e-5)
        self.transformer = Transformer(W, cfg.vision_layers, cfg.vision_heads)
        self.ln_post = nn.LayerNorm(W, eps=1e-5)
        self.proj = nn.Parameter(torch.randn(W, cfg.embed_dim) * W ** -0.5)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        B = pixels.shape[0]
        h = self.conv1(pixels.to(self.conv1.weight.dtype)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(h.dtype).expand(B, 1, -1)
        h = torch.cat([cls, h], dim=1) + self.positional_embedding.to(h.dtype)
        h = self.transformer(self.ln_pre(h))
        return self.ln_post(h[:, 0]).float() @ self.proj.float()


class CLIPTextEncoder(nn.Module):
    """The text tower: ``token_ids`` (B, T <= context_length) to (B, embed_dim),
    pooled at the argmax token id."""

    def __init__(self, config: CLIPConfig):
        super().__init__()
        self.config = cfg = config
        W = cfg.text_width
        self.token_embedding = nn.Embedding(cfg.vocab_size, W)
        self.positional_embedding = nn.Parameter(torch.randn(cfg.context_length, W) * 0.01)
        self.transformer = Transformer(W, cfg.text_layers, cfg.text_heads)
        self.ln_final = nn.LayerNorm(W, eps=1e-5)
        self.text_projection = nn.Parameter(torch.randn(W, cfg.embed_dim) * W ** -0.5)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        token_ids = token_ids.long()
        B, T = token_ids.shape
        h = self.token_embedding(token_ids) + self.positional_embedding[:T].to(self.token_embedding.weight.dtype)
        causal = torch.full((T, T), float("-inf"), device=h.device).triu(1)
        h = self.ln_final(self.transformer(h, causal))
        pooled = h[torch.arange(B, device=h.device), token_ids.argmax(dim=-1)]
        return pooled.float() @ self.text_projection.float()


class CLIP(CLIPTextEncoder):
    """OpenAI's CLIP layout: the text tower at the top level, ``visual`` and
    ``logit_scale`` beside it. Called, it is the text encoder."""

    def __init__(self, config: CLIPConfig):
        super().__init__(config)
        self.visual = CLIPVisionEncoder(config)
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07))))


def preprocess_for_clip(x: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """[-1, 1] NCHW images to CLIP-normalized pixels at ``image_size``.

    Differentiable, so guidance gradients flow through it. The resize is
    bilinear with half-pixel centers and, when it shrinks, the antialiasing
    filter that ``jax.image.resize(..., "bilinear")`` applies."""
    pixels = (x + 1.0) / 2.0
    if tuple(pixels.shape[-2:]) != (image_size, image_size):
        pixels = F.interpolate(pixels, size=(image_size, image_size), mode="bilinear",
                               align_corners=False, antialias=True)
    mean = torch.tensor(IMAGE_MEAN, dtype=pixels.dtype, device=pixels.device).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGE_STD, dtype=pixels.dtype, device=pixels.device).reshape(1, 3, 1, 1)
    return (pixels - mean) / std


def clip_guidance_cond_fn(
    image_embed_fn: Callable,
    target_embed: torch.Tensor,
    scale: float = 1.0,
    *,
    clip_image_size: int = 224,
    sched=None,
    mean_type=None,
    var_type=None,
    model_fn: Callable | None = None,
    use_pred_xstart: bool = False,
) -> Callable:
    """Guidance gradient ``d/dx [cosine(embed(x'), target)] * scale``, a
    ``potential_cond_fn``.

    x' is the noisy x (the classifier-guidance convention), or with
    ``use_pred_xstart`` the model's x0 prediction from ``p_mean_variance``
    (unclipped), so that the gradient goes through the UNet (on this
    rank's rows under spatial partitioning, x' gathered before the encoder); that needs
    ``sched``, ``mean_type``, ``var_type`` and ``model_fn``. The sampling
    loops hand a cond_fn the model's timesteps; the x0 prediction is taken at
    the schedule's own step whose model timestep that is
    (``DiffusionSchedule.local_timesteps``). The JAX function indexes the
    schedule with the model timestep itself, which is the same step only
    without respacing.
    """
    target = target_embed / target_embed.norm(dim=-1, keepdim=True)

    def similarity(x_img):
        # under spatial partitioning the encoder takes the gathered image on every rank; the
        # gather's adjoint hands each rank its rows of the gradient
        x_img = sp.gather_rows(x_img)
        with sp.whole():
            emb = image_embed_fn(preprocess_for_clip(x_img, clip_image_size))
        emb = emb / emb.norm(dim=-1, keepdim=True)
        return (emb * target.to(emb)).sum()

    if not use_pred_xstart:
        return potential_cond_fn(lambda x, t, **kwargs: similarity(x), scale)
    if sched is None or model_fn is None:
        raise ValueError("use_pred_xstart needs sched and model_fn")

    on_device = {}  # the schedule on each device it is called on, its timestep table built once

    def potential(x, t, **kwargs):
        s = on_device.get(x.device) or on_device.setdefault(x.device, sched.to(x.device))
        out = G.p_mean_variance(
            s, model_fn, x, s.local_timesteps(t),
            mean_type=mean_type, var_type=var_type, clip_denoised=False, model_kwargs=kwargs,
        )
        return similarity(out.pred_xstart)

    return potential_cond_fn(potential, scale)


# ---------------------------------------------------------------------------
# Weights: OpenAI CLIP .pt (TorchScript archive or state_dict) and HF CLIPModel
# ---------------------------------------------------------------------------

# buffers of OpenAI's archive that no module holds (clip/model.py::build_model drops them too)
_OPENAI_EXTRAS = ("input_resolution", "context_length", "vocab_size")


def openai_state_dict_from_hf(sd: dict) -> dict:
    """An HF ``CLIPModel.state_dict()`` under OpenAI's names (the inverse of
    JAX ``import_clip_torch_state_dict`` composed with ``import_openai_clip_pt``):
    q, k and v packed into ``in_proj_*``, the projections stored (W, D)."""
    out = {}

    def tower(hf_prefix, prefix, layers):
        for i in range(layers):
            src, dst = f"{hf_prefix}.encoder.layers.{i}", f"{prefix}transformer.resblocks.{i}"
            for a, b in (("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"), ("self_attn.out_proj", "attn.out_proj"),
                         ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj")):
                for leaf in ("weight", "bias"):
                    out[f"{dst}.{b}.{leaf}"] = sd[f"{src}.{a}.{leaf}"]
            for leaf in ("weight", "bias"):
                out[f"{dst}.attn.in_proj_{leaf}"] = torch.cat(
                    [sd[f"{src}.self_attn.{p}_proj.{leaf}"] for p in "qkv"], dim=0)

    vp, tp = "vision_model", "text_model"
    out["visual.conv1.weight"] = sd[f"{vp}.embeddings.patch_embedding.weight"]
    out["visual.class_embedding"] = sd[f"{vp}.embeddings.class_embedding"]
    out["visual.positional_embedding"] = sd[f"{vp}.embeddings.position_embedding.weight"]
    pre = f"{vp}.pre_layrnorm" if f"{vp}.pre_layrnorm.weight" in sd else f"{vp}.pre_layernorm"
    for leaf in ("weight", "bias"):
        out[f"visual.ln_pre.{leaf}"] = sd[f"{pre}.{leaf}"]
        out[f"visual.ln_post.{leaf}"] = sd[f"{vp}.post_layernorm.{leaf}"]
        out[f"ln_final.{leaf}"] = sd[f"{tp}.final_layer_norm.{leaf}"]
    out["visual.proj"] = sd["visual_projection.weight"].T
    n_vision = 1 + max(int(k.split(".")[3]) for k in sd if k.startswith(f"{vp}.encoder.layers."))
    n_text = 1 + max(int(k.split(".")[3]) for k in sd if k.startswith(f"{tp}.encoder.layers."))
    tower(vp, "visual.", n_vision)
    out["token_embedding.weight"] = sd[f"{tp}.embeddings.token_embedding.weight"]
    out["positional_embedding"] = sd[f"{tp}.embeddings.position_embedding.weight"]
    out["text_projection"] = sd["text_projection.weight"].T
    tower(tp, "", n_text)
    out["logit_scale"] = sd["logit_scale"]
    return {k: v.contiguous() for k, v in out.items()}


def _is_torchscript(path: str) -> bool:
    """A TorchScript archive (OpenAI's released ``ViT-B-32.pt``) holds a
    ``constants.pkl``; a ``torch.save`` file does not."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.split("/")[-1] == "constants.pkl" for n in z.namelist())


def load_clip_state_dict(path: str) -> dict:
    """OpenAI-named f32 CPU tensors from an OpenAI ``.pt`` (TorchScript
    archive, whose ``.state_dict()`` is taken, or a state_dict) or an HF
    ``CLIPModel`` state_dict, which is mapped to OpenAI's names."""
    if _is_torchscript(path):
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if not any(k.startswith("visual.") for k in sd):
        sd = openai_state_dict_from_hf(sd)
    return {k: v.float() for k, v in sd.items() if k not in _OPENAI_EXTRAS}


def load_clip_params(path: str, cfg: CLIPConfig = CLIPConfig(), device="cpu"):
    """(vision encoder, text encoder) of ``cfg`` with the weights of ``path``
    (``load_clip_state_dict``), every key matched (``strict=True``), in eval
    mode on ``device``, where the model is built (its initializer, which the
    weights replace, runs there). The text encoder is the whole ``CLIP`` (its
    ``visual`` is the vision encoder returned)."""
    with torch.device(device):
        model = CLIP(cfg)
    model.load_state_dict(load_clip_state_dict(path), strict=True)
    model.eval()
    return model.visual, model
