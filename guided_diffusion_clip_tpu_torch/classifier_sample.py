"""Classifier-guided sampling on PyTorch/CUDA: the port of scripts/classifier_sample.py.

    python -m guided_diffusion_clip_tpu_torch.classifier_sample \\
        --model_path model.pt --classifier_path classifier.pt \\
        --image_size 256 --num_channels 256 --num_res_blocks 2 \\
        --attention_resolutions 32,16,8 --num_head_channels 64 \\
        --resblock_updown True --use_scale_shift_norm True --learn_sigma True \\
        --class_cond True --use_fp16 True --classifier_use_fp16 True \\
        --timestep_respacing 250 --classifier_scale 1.0 \\
        --batch_size 8 --num_samples 8

The same flags as scripts/classifier_sample.py, plus ``--device`` (default
``cuda``; the models run where it says, and a missing card is an error).
``--model_path`` is the upstream class-conditional UNet (1000-row class
table) and ``--classifier_path`` the ``EncoderUNetModel`` classifier, both
reference-format ``.pt`` state_dicts loaded with ``strict=True``.

Each batch draws its classes in [0, 1000) and its noise from two explicit
``torch.Generator``s seeded from ``--seed``, runs the UNet under
``torch.no_grad()`` and adds the classifier's gradient of log p(y | x_t)
every step (``diffusion/guidance.py``). The result is written as
``samples_{N}x{H}x{W}x3.npz`` (uint8 images, int32 labels) in the logger's
directory.

Not yet ported, and rejected at startup: ``--guidance_interval``,
``--guidance_cache``, ``--deep_cache``, ``--conv_impl int8``,
``--sampler dpm++2m``, ``--spatial_shard`` and ``--tensor_shard``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .diffusion.guidance import classifier_cond_fn, model_fn_dropping_y
from .diffusion.sampling import sample_seed
from .utils import logger
from .utils.checkpoint import load_model_weights
from .utils.script_util import (
    add_dict_to_argparser,
    args_to_dict,
    classifier_defaults,
    create_classifier,
    create_gaussian_diffusion,
    create_upstream_model,
    model_and_diffusion_defaults,
    parse_yaml,
    resolve_sampler,
)

# flag -> largest value that leaves the feature off; anything else is a
# feature not yet ported
_UNPORTED = {"deep_cache": 1, "guidance_cache": 1, "spatial_shard": 1, "tensor_shard": 1}
_UNET_KEYS = (
    "image_size", "num_channels", "num_res_blocks", "channel_mult", "learn_sigma",
    "class_cond", "use_checkpoint", "attention_resolutions", "num_heads",
    "num_head_channels", "num_heads_upsample", "use_scale_shift_norm", "dropout",
    "resblock_updown", "use_fp16", "use_new_attention_order",
)


def _refuse_unported(args) -> None:
    for name, off in _UNPORTED.items():
        if int(getattr(args, name, 0)) > off:
            raise SystemExit(f"--{name}: not yet ported to the PyTorch package")
    if getattr(args, "guidance_interval", ""):
        raise SystemExit("--guidance_interval: not yet ported to the PyTorch package")
    if getattr(args, "conv_impl", "auto") != "auto":
        raise SystemExit(
            f"--conv_impl {args.conv_impl}: not yet ported to the PyTorch package "
            "(convs run through cuDNN in the model's dtype)"
        )


def main(argv=None) -> dict:
    """Run the CLI; returns {"path": the npz, "chain_seconds": [per batch],
    "steps": steps per chain, "batches": chains run}."""
    args = parse_yaml(create_argparser().parse_args(argv))
    _refuse_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    if not args.model_path or not args.classifier_path:
        raise SystemExit("--model_path and --classifier_path: reference-format .pt state_dicts are required")
    diffusion = create_gaussian_diffusion(
        steps=args.diffusion_steps,
        learn_sigma=args.learn_sigma,
        noise_schedule=args.noise_schedule,
        use_kl=args.use_kl,
        predict_xstart=args.predict_xstart,
        rescale_timesteps=args.rescale_timesteps,
        rescale_learned_sigmas=args.rescale_learned_sigmas,
        timestep_respacing=args.timestep_respacing,
    )
    loop = resolve_sampler(diffusion, args)  # refuses dpm++2m
    logger.configure(args=args)

    logger.log("creating model and diffusion...")
    model = create_upstream_model(**args_to_dict(args, _UNET_KEYS))
    load_model_weights(model, args.model_path)
    model = model.to(device).eval().requires_grad_(False)

    logger.log("loading classifier...")
    classifier = create_classifier(**args_to_dict(args, classifier_defaults().keys()))
    load_model_weights(classifier, args.classifier_path)
    # gradients with respect to x only, as jax.grad with respect to x
    classifier = classifier.to(device).eval().requires_grad_(False)

    cond_fn = classifier_cond_fn(classifier, args.classifier_scale)
    model_fn = model_fn_dropping_y(model, args.class_cond)

    logger.log("sampling...")
    B, size = args.batch_size, args.image_size
    noise_gen = torch.Generator(device=device).manual_seed(sample_seed(args.seed, 0))
    class_gen = torch.Generator(device=device).manual_seed(sample_seed(args.seed, 1))
    n_batches = -(-args.num_samples // B)
    all_images, all_labels, chain_seconds = [], [], []
    for _ in range(n_batches):
        # the classifier and the label table have 1000 classes (NUM_CLASSES
        # = 512 is the fork's CLIP width, not a class count)
        classes = torch.randint(0, 1000, (B,), generator=class_gen, device=device)
        t0 = time.perf_counter()
        with torch.no_grad():  # not inference_mode: cond_fn differentiates the classifier
            sample = loop(
                model_fn, (B, 3, size, size), noise_gen,
                clip_denoised=args.clip_denoised, model_kwargs={"y": classes}, cond_fn=cond_fn,
            )
            sample = ((sample + 1) * 127.5).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
            all_images.append(sample.cpu().numpy())
        chain_seconds.append(time.perf_counter() - t0)
        all_labels.append(classes.cpu().numpy().astype(np.int32))
        logger.log(f"created {len(all_images) * B} samples ({chain_seconds[-1]:.3f} s for the batch)")

    arr = np.concatenate(all_images, axis=0)[: args.num_samples]
    label_arr = np.concatenate(all_labels, axis=0)[: args.num_samples]
    shape_str = "x".join(str(x) for x in arr.shape)
    out_path = os.path.join(logger.get_dir(), f"samples_{shape_str}.npz")
    logger.log(f"saving to {out_path}")
    np.savez(out_path, arr, label_arr)
    logger.log("sampling complete")
    return {
        "path": out_path, "chain_seconds": chain_seconds,
        "steps": diffusion.num_timesteps, "batches": n_batches,
    }


def create_argparser():
    defaults = dict(
        clip_denoised=True,
        num_samples=10000,
        batch_size=16,
        use_ddim=False,
        sampler="",  # "" (use_ddim decides), ancestral or ddim; dpm++2m not yet ported
        model_path="",
        classifier_path="",
        classifier_scale=1.0,
        main_path="",
        seed=0,
        device="cuda",
        conv_impl="auto",  # int8 not yet ported
        spatial_shard=0,  # not yet ported
        tensor_shard=0,  # not yet ported
        deep_cache=0,  # not yet ported
        deep_cache_cut=0,
        guidance_interval="",  # not yet ported
        guidance_cache=0,  # not yet ported
    )
    defaults.update(model_and_diffusion_defaults())
    defaults.update(classifier_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


if __name__ == "__main__":
    main()
