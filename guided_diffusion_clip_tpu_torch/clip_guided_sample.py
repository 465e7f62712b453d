"""CLIP-guided sampling on PyTorch/CUDA: the port of scripts/clip_guided_sample.py.

    python -m guided_diffusion_clip_tpu_torch.clip_guided_sample \\
        --model_path model.pt --clip_model_path ViT-B-32.pt \\
        --image_size 256 --num_channels 256 --num_res_blocks 2 \\
        --attention_resolutions 32,16,8 --num_head_channels 64 \\
        --resblock_updown True --use_scale_shift_norm True --learn_sigma True \\
        --class_cond True --use_fp16 True --timestep_respacing 100 \\
        --target_image target.png --clip_scale 100 --batch_size 8

The flags are scripts/clip_guided_sample.py's, plus ``--device`` (default
``cuda``; a missing card is an error). The generator is the fork's
CLIP-conditioned UNet (``--model_path``, a reference-format ``.pt``; a
``.flax`` file is refused with the conversion's recipe); with ``--class_cond``
the target embedding is its ``clip_feat``. The target is the CLIP text
embedding of ``--text`` (tokenized with ``--clip_vocab`` or
``$CLIP_BPE_PATH``, whose size must be the model's vocabulary), the image
embedding of ``--target_image``, or the vector in ``--target_embed`` (an
``.npz``'s ``arr_0``). The CLIP weights (``--clip_model_path``) are an
OpenAI CLIP ``.pt`` or an HF ``CLIPModel`` state_dict; ``GDC_CLIP_TINY=1``
builds a tiny CLIP instead of ViT-B/32, for tests.

Each step adds ``clip_scale`` times the gradient of the cosine similarity
between the target and the CLIP embedding of x, or with
``--grad_through_pred_xstart True`` (the default) of the UNet's x0
prediction, through the UNet's backward (``models/clip_vit.py::
clip_guidance_cond_fn``). Under ``--conv_impl int8`` that backward runs the
int8 UNet's straight-through VJPs (``ops/quant.py``, the quantizing
GroupNorm's), while the loop's own forwards emit real s8. ``--clip_scale`` is a
comma list: one chain a scale, each drawing from its own per-sample
generators (``sample_seed(seed, (scale_index * world + rank) * batch_size +
i)``, so that one process draws what it always drew).
``--cfg_scale`` (with ``--cfg_cache``) guides the embedding conditioning
without a classifier (a zero ``clip_feat`` as the null) while the CLIP
gradient keeps the plain conditional model; ``--guidance_interval lo,hi``
gates the CLIP gradient (and CFG) to that window of model timesteps and
``--guidance_cache N`` recomputes the gradient one step in N; ``--sampler``
picks the loop (``resolve_sampler``). The UNet runs under ``torch.no_grad()``
and the gradient is taken inside the cond_fn.

Written to the logger's directory, per scale: ``clip_guided_scale{s:g}.png``
(a grid) and ``clip_guided_scale{s:g}.npz`` (uint8 NHWC). Under torchrun
(JAX :87, :169, :253) each rank runs its own chains and rank 0 writes its
own. ``--spatial_shard S`` (torchrun with a multiple of S ranks,
``parallel/sp.py``) splits every image's rows over the S ranks of each data
group, which seeds as one rank of the unsharded run (its data rank); the
chain's rows are gathered before CLIP's encoder and before the write.
``--tensor_shard T`` (torchrun with a multiple of T ranks, ``parallel/tp.py``)
splits every activation's channels over the T ranks of each data group, which
seeds as one rank of the unsharded run (its data rank); the model's output is
whole on every rank; CLIP runs whole on it. Both flags above 1 are refused, as
is either outside torchrun.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from .diffusion.guidance import (
    cached_cond_fn,
    cfg_cached_model_fn,
    cfg_cached_state0,
    cfg_model_fn,
    interval_cond_fn,
    parse_guidance_interval,
)
from .diffusion.sampling import sample_generators
from .models.clip_vit import clip_config, clip_guidance_cond_fn, load_clip_params, preprocess_for_clip
from .models.unet import CONV_IMPLS
from .parallel import dist as pdist
from .parallel import sp, tp
from .utils import logger
from .utils.checkpoint import load_model_weights
from .utils.saving_imgs import save_img, tensor2img
from .utils.script_util import (
    add_dict_to_argparser,
    args_to_dict,
    create_model_and_diffusion,
    model_and_diffusion_defaults,
    parse_yaml,
    resolve_sampler,
)


def _refuse(args) -> None:
    sp.check_flags(getattr(args, "spatial_shard", 0), getattr(args, "tensor_shard", 0))
    if args.conv_impl not in CONV_IMPLS:
        raise SystemExit(f"--conv_impl {args.conv_impl!r}: choose from {', '.join(CONV_IMPLS)}")
    if int(args.cfg_cache) > 1 and not args.cfg_scale:
        raise SystemExit("--cfg_cache caches the CFG uncond branch; it needs --cfg_scale")
    if args.cfg_scale and not args.class_cond:
        raise SystemExit("--cfg_scale needs an embedding-conditioned model (--class_cond True); an "
                         "unconditional model has no conditioning to guide on")
    if not (args.text or args.target_image or args.target_embed):
        raise SystemExit("provide --text, --target_image or --target_embed")


def load_target(args, cfg, vision, text_encoder, tokenizer, device) -> torch.Tensor:
    """The (embed_dim,) target: the text's, the image's or the file's embedding."""
    with torch.no_grad():
        if args.text:
            tokens = torch.from_numpy(tokenizer(args.text)).to(device)
            logger.log(f"text target: {args.text!r} -> {cfg.embed_dim}-d embedding")
            return text_encoder(tokens)[0]
        if args.target_image:
            from PIL import Image

            with Image.open(args.target_image) as img:
                arr = np.asarray(img.convert("RGB"), np.float32) / 127.5 - 1.0
            x = torch.from_numpy(arr).permute(2, 0, 1)[None].to(device)
            return vision(preprocess_for_clip(x, cfg.image_size))[0]
    return torch.from_numpy(np.load(args.target_embed)["arr_0"]).float().reshape(-1).to(device)


def main(argv=None) -> dict:
    """Run the CLI; returns {"paths": the .npz per scale, "chain_seconds": per
    scale (CUDA events on the card, else wall time), "steps": steps a chain, "calls": the
    UNet's forwards and the CLIP encoder's, over all chains}."""
    args = parse_yaml(create_argparser().parse_args(argv))
    _refuse(args)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    with (pdist.process_group(args.device) as device, sp.from_flag(args.spatial_shard, args.batch_size),
          tp.from_flag(args.tensor_shard, args.batch_size)):
        return sample(args, device)


def sample(args, device: torch.device) -> dict:
    logger.configure(args=args)

    logger.log("creating model and diffusion...")
    # the model built on its device: the initializer, which the loaded weights replace, runs there
    with torch.device(device):
        model, diffusion = create_model_and_diffusion(
            **args_to_dict(args, model_and_diffusion_defaults().keys()), conv_impl=args.conv_impl)
    try:
        load_model_weights(model, args.model_path)
    except ValueError as e:  # a .flax checkpoint
        raise SystemExit(str(e)) from None
    model = model.to(device).eval().requires_grad_(False)

    logger.log("loading CLIP...")
    cfg, tokenizer = clip_config(), None
    if args.text:
        # tokenize first, so that the tiny CLIP takes its vocabulary size from the merges file
        from .models.clip_tokenizer import SimpleTokenizer

        tokenizer = SimpleTokenizer(bpe_path=args.clip_vocab or None, context_length=cfg.context_length)
        if os.environ.get("GDC_CLIP_TINY"):
            cfg = dataclasses.replace(cfg, vocab_size=len(tokenizer.encoder))
        elif len(tokenizer.encoder) != cfg.vocab_size:
            raise SystemExit(f"vocab size mismatch: merges file yields {len(tokenizer.encoder)} tokens, "
                             f"CLIP model expects {cfg.vocab_size}")
    vision, text_encoder = load_clip_params(args.clip_model_path, cfg, device)
    vision = vision.to(device).requires_grad_(False)
    text_encoder = text_encoder.to(device).requires_grad_(False)
    target = load_target(args, cfg, vision, text_encoder, tokenizer, device)

    calls = {"unet": 0, "clip": 0}

    def base_fn(x, t, **kw):
        calls["unet"] += 1
        return model(x, t, **kw)

    def inject_target(x, kw):
        # condition on the target embedding itself (the fork's pathway)
        return dict(kw, clip_feat=target.expand(x.shape[0], -1)) if args.class_cond else kw

    def model_fn(x, t, **kw):
        return base_fn(x, t, **inject_target(x, kw))

    def embed(pixels):
        calls["clip"] += 1
        return vision(pixels)

    B, size = args.batch_size, args.image_size
    shape = (B, 3, size, size)
    g_interval = parse_guidance_interval(args.guidance_interval)
    loop = resolve_sampler(diffusion, args)
    scales = [float(s) for s in str(args.clip_scale).split(",")]
    paths, chain_seconds = [], []
    rank, world = sp.data_rank(), sp.data_size()  # a data group's ranks draw alike under --spatial_shard
    for j, scale in enumerate(scales):
        # classifier-free guidance over the embedding conditioning; the CLIP
        # gradient keeps the plain conditional model
        loop_model_fn, model_state0 = model_fn, None
        if args.cfg_scale and int(args.cfg_cache) > 1:
            cached = cfg_cached_model_fn(base_fn, args.cfg_scale, {"clip_feat": 0.0}, int(args.cfg_cache),
                                         interval=g_interval)
            model_state0 = cfg_cached_state0((B, model.config.out_channels, size, size), device=device)

            def loop_model_fn(x, t, state, **kw):
                return cached(x, t, state, **inject_target(x, kw))
        elif args.cfg_scale:
            cfg_fn = cfg_model_fn(base_fn, args.cfg_scale, {"clip_feat": 0.0}, interval=g_interval)

            def loop_model_fn(x, t, **kw):
                return cfg_fn(x, t, **inject_target(x, kw))

        cond_fn = clip_guidance_cond_fn(
            embed, target, scale, clip_image_size=cfg.image_size, sched=diffusion.sched,
            mean_type=diffusion.mean_type, var_type=diffusion.var_type, model_fn=model_fn,
            use_pred_xstart=args.grad_through_pred_xstart,
        )
        if g_interval is not None:
            # outside [lo, hi] neither CLIP nor (in pred-x0 mode) the extra UNet forward runs
            cond_fn = interval_cond_fn(cond_fn, *g_interval)
        cond_state0 = None
        if int(args.guidance_cache) > 1:
            cond_fn, cond_state0 = cached_cond_fn(cond_fn, int(args.guidance_cache), shape, device=device)
        first = (j * world + rank) * B
        rng = sample_generators([args.seed] * B, range(first, first + B), device)
        t0 = time.perf_counter()
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        with torch.no_grad():  # not inference_mode: cond_fn differentiates through the models
            sample = loop(loop_model_fn, shape, rng, clip_denoised=args.clip_denoised, cond_fn=cond_fn,
                          cond_state0=cond_state0, model_state0=model_state0)
        sample = sp.gather_rows(sample).permute(0, 2, 3, 1).float().cpu().numpy()
        if device.type == "cuda":
            end.record()
            end.synchronize()
            chain_seconds.append(start.elapsed_time(end) / 1e3)
        else:
            chain_seconds.append(time.perf_counter() - t0)
        out = os.path.join(logger.get_dir(), f"clip_guided_scale{scale:g}.png")
        paths.append(os.path.join(logger.get_dir(), f"clip_guided_scale{scale:g}.npz"))
        if pdist.rank() == 0:
            save_img(tensor2img(sample), out)
            np.savez(paths[-1], ((sample + 1) * 127.5).clip(0, 255).astype(np.uint8))
        logger.log(f"scale {scale} -> {out}")
    pdist.barrier("clip_guided_sample")
    logger.log("clip-guided sampling complete")
    return {"paths": paths, "chain_seconds": chain_seconds, "steps": diffusion.num_timesteps, "calls": calls}


def create_argparser():
    defaults = dict(
        clip_denoised=True,
        num_samples=8,
        batch_size=8,
        use_ddim=False,
        sampler="",  # "" (use_ddim decides), ancestral, ddim or dpm++2m
        model_path="",
        clip_model_path="",
        text="",  # text prompt target (tokenized with --clip_vocab merges)
        clip_vocab="",  # path to bpe_simple_vocab_16e6.txt(.gz); else $CLIP_BPE_PATH
        target_image="",
        target_embed="",
        clip_scale="100.0",
        grad_through_pred_xstart=True,
        main_path="",
        seed=0,
        device="cuda",
        conv_impl="auto",  # auto or xla: cuDNN; int8: kernels K4 and K5
        spatial_shard=0,  # S > 1: each image's rows over S ranks (torchrun, a multiple of S ranks)
        tensor_shard=0,  # T > 1: each activation's channels over T ranks (torchrun, a multiple of T ranks)
        cfg_scale=0.0,  # > 0: classifier-free guidance (a model trained with cond_dropout)
        cfg_cache=0,  # N > 1: recompute the CFG uncond branch 1 step in N
        guidance_interval="",  # "lo,hi": guide only for t in [lo, hi] (original units)
        guidance_cache=0,  # N > 1: recompute the guidance gradient 1 step in N
    )
    defaults.update(model_and_diffusion_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


if __name__ == "__main__":
    main()
