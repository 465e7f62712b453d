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
``--conv_impl int8`` runs both models' convs on the int8 path (kernels K4
and K5; the JAX package's headline mode); ``auto`` and ``xla`` run them
through cuDNN in the models' dtype.

Each batch draws its classes in [0, 1000) and its noise from two explicit
``torch.Generator``s seeded from ``--seed``, runs the UNet under
``torch.no_grad()`` and adds the classifier's gradient of log p(y | x_t)
every step (``diffusion/guidance.py``). The result is written as
``samples_{N}x{H}x{W}x3.npz`` (uint8 images, int32 labels) in the logger's
directory.

The sampling knobs of the JAX package's deploy preset
(``configs/deploy256_fast.yaml``) compose as there: ``--guidance_interval
lo,hi`` guides only while the model's timestep lies in the window (outside it
the classifier runs neither forward nor backward), ``--guidance_cache N``
recomputes the gradient one step in N (the interval inside the cache, so the
counter counts every step), ``--deep_cache N`` with ``--deep_cache_cut``
refreshes the generator's deep sub-UNet one step in N (the classifier's
gradient stays as fresh as the other two flags leave it), and ``--sampler
dpm++2m`` takes guidance through ``condition_score``.

Under torchrun (JAX :171-203) each rank runs ``ceil(num_samples / (B *
world))`` chains from its own two generators, seeded ``sample_seed(seed,
2 * rank)`` and ``sample_seed(seed, 2 * rank + 1)`` (rank 0's as one
process's); every batch is gathered in rank order and rank 0 writes the
``.npz``, then a barrier. ``--spatial_shard S`` (torchrun with a multiple of
S ranks, ``parallel/sp.py``) splits every image's rows over the S ranks of
each data group, which seed and gather as one rank of the unsharded run
(``sample_seed(seed, 2 * d)``, d the data group); the classifier pools over
the ranks, so each rank's guidance gradient is its rows of the unsharded
one. ``--tensor_shard T`` (torchrun with a multiple of T ranks,
``parallel/tp.py``) splits every activation's channels over the T ranks of each
data group, which seed and gather as one rank of the unsharded run (its data
rank); the model's output is whole on every rank, and each rank's guidance
gradient, summed over the model group, is the unsharded one. Both flags above 1
are refused, as is either outside torchrun.
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import numpy as np
import torch

from .diffusion.deep_cache import deep_cache_model_fn, zero_state
from .diffusion.guidance import (
    cached_cond_fn,
    classifier_cond_fn,
    interval_cond_fn,
    parse_guidance_interval,
)
from .diffusion.sampling import sample_seed
from .models.unet import CONV_IMPLS
from .parallel import dist as pdist
from .parallel import sp, tp
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

_UNET_KEYS = (
    "image_size", "num_channels", "num_res_blocks", "channel_mult", "learn_sigma",
    "class_cond", "use_checkpoint", "attention_resolutions", "num_heads",
    "num_head_channels", "num_heads_upsample", "use_scale_shift_norm", "dropout",
    "resblock_updown", "use_fp16", "use_new_attention_order",
)


def _refuse_unported(args) -> None:
    sp.check_flags(getattr(args, "spatial_shard", 0), getattr(args, "tensor_shard", 0))
    if getattr(args, "conv_impl", "auto") not in CONV_IMPLS:
        raise SystemExit(f"--conv_impl {args.conv_impl!r}: choose from {CONV_IMPLS}")


def main(argv=None) -> dict:
    """Run the CLI; returns {"path": the npz, "chain_seconds": [per batch],
    "steps": steps per chain, "batches": chains run, "calls": how often each
    network ran: {"unet_full", "unet_shallow", "classifier"}}."""
    args = parse_yaml(create_argparser().parse_args(argv))
    _refuse_unported(args)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    if not args.model_path or not args.classifier_path:
        raise SystemExit("--model_path and --classifier_path: reference-format .pt state_dicts are required")
    with (pdist.process_group(args.device) as device, sp.from_flag(args.spatial_shard, args.batch_size),
          tp.from_flag(args.tensor_shard, args.batch_size)):
        return sample(args, device)


def sample(args, device: torch.device) -> dict:
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
    loop = resolve_sampler(diffusion, args)
    logger.configure(args=args)

    logger.log("creating model and diffusion...")
    # both models built on their device: the initializer, which the loaded weights replace, runs there
    with torch.device(device):
        model = create_upstream_model(**args_to_dict(args, _UNET_KEYS), conv_impl=args.conv_impl)
    load_model_weights(model, args.model_path)
    model = model.to(device).eval().requires_grad_(False)

    logger.log("loading classifier...")
    with torch.device(device):
        classifier = create_classifier(**args_to_dict(args, classifier_defaults().keys()),
                                       conv_impl=args.conv_impl)
    load_model_weights(classifier, args.classifier_path)
    # gradients with respect to x only, as jax.grad with respect to x; under
    # int8 the classifier's quantizing GroupNorms then emit integer-valued
    # floats (differentiable), the generator's (under no_grad) real s8
    classifier = classifier.to(device).eval().requires_grad_(False)

    calls = {"unet_full": 0, "unet_shallow": 0, "classifier": 0}

    def classifier_fn(x, t):
        calls["classifier"] += 1
        return classifier(x, t)

    def unet(x, t, y=None, cache_mode="off", **kw):
        calls["unet_shallow" if cache_mode == "shallow" else "unet_full"] += 1
        return model(x, t, y=y if args.class_cond else None, cache_mode=cache_mode, **kw)

    B, size = args.batch_size, args.image_size
    shape = (B, 3, size, size)
    cond_fn = classifier_cond_fn(classifier_fn, args.classifier_scale)
    g_interval = parse_guidance_interval(args.guidance_interval)
    if g_interval is not None:
        cond_fn = interval_cond_fn(cond_fn, *g_interval)
    cond_state0 = None
    if int(args.guidance_cache) > 1:
        # the interval inside the cache: the counter counts every step
        cond_fn, cond_state0 = cached_cond_fn(cond_fn, int(args.guidance_cache), shape, device=device)
    model_fn, model_state0 = unet, None
    deep_cut = int(args.deep_cache_cut)
    if int(args.deep_cache) > 1:
        # DeepCache on the generator only: the guidance stays fresh
        def apply_shallow(x, t, deep, **kw):
            return unet(x, t, deep_cache=deep, cache_mode="shallow", cache_cut=deep_cut, **kw)

        model_fn = deep_cache_model_fn(
            functools.partial(unet, cache_mode="full", cache_cut=deep_cut),
            apply_shallow, int(args.deep_cache),
        )
        model_state0 = zero_state(model.config, B, deep_cut, dtype=model.dtype, device=device)

    logger.log("sampling...")
    rank, world = sp.data_rank(), sp.data_size()  # a data group's ranks draw alike under --spatial_shard
    noise_gen = torch.Generator(device=device).manual_seed(sample_seed(args.seed, 2 * rank))
    class_gen = torch.Generator(device=device).manual_seed(sample_seed(args.seed, 2 * rank + 1))
    n_batches = -(-args.num_samples // (B * world))
    all_images, all_labels, chain_seconds = [], [], []
    for _ in range(n_batches):
        # the classifier and the label table have 1000 classes (NUM_CLASSES
        # = 512 is the fork's CLIP width, not a class count)
        classes = torch.randint(0, 1000, (B,), generator=class_gen, device=device)
        t0 = time.perf_counter()
        with torch.no_grad():  # not inference_mode: cond_fn differentiates the classifier
            sample = loop(
                model_fn, shape, noise_gen,
                clip_denoised=args.clip_denoised, model_kwargs={"y": classes}, cond_fn=cond_fn,
                model_state0=model_state0, cond_state0=cond_state0,
            )
            sample = sp.gather_rows(sample)
            sample = ((sample + 1) * 127.5).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
            all_images.extend(sp.gather_data_groups(sample.cpu().numpy()))  # data-rank order
        chain_seconds.append(time.perf_counter() - t0)
        all_labels.extend(sp.gather_data_groups(classes.cpu().numpy().astype(np.int32)))
        logger.log(f"created {len(all_images) * B} samples ({chain_seconds[-1]:.3f} s for the batch)")

    arr = np.concatenate(all_images, axis=0)[: args.num_samples]
    label_arr = np.concatenate(all_labels, axis=0)[: args.num_samples]
    shape_str = "x".join(str(x) for x in arr.shape)
    out_path = os.path.join(logger.get_dir(), f"samples_{shape_str}.npz")
    if rank == 0:
        logger.log(f"saving to {out_path}")
        np.savez(out_path, arr, label_arr)
    pdist.barrier("sampling")
    logger.log("sampling complete")
    return {
        "path": out_path, "chain_seconds": chain_seconds,
        "steps": diffusion.num_timesteps, "batches": n_batches, "calls": calls,
    }


def create_argparser():
    defaults = dict(
        clip_denoised=True,
        num_samples=10000,
        batch_size=16,
        use_ddim=False,
        sampler="",  # "" (use_ddim decides), ancestral, ddim or dpm++2m; cond_fn composes
        model_path="",
        classifier_path="",
        classifier_scale=1.0,
        main_path="",
        seed=0,
        device="cuda",
        conv_impl="auto",  # auto or xla: cuDNN; int8: kernels K4 and K5
        spatial_shard=0,  # S > 1: each image's rows over S ranks (torchrun, a multiple of S ranks)
        tensor_shard=0,  # T > 1: each activation's channels over T ranks (torchrun, a multiple of T ranks)
        deep_cache=0,  # N > 1: refresh the deep sub-UNet every N steps (DeepCache)
        deep_cache_cut=0,  # shallow input blocks; 0 = below the full-resolution level
        guidance_interval="",  # "lo,hi": guide only for t in [lo, hi] (original units)
        guidance_cache=0,  # N > 1: recompute the guidance gradient 1 step in N
    )
    defaults.update(model_and_diffusion_defaults())
    defaults.update(classifier_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


if __name__ == "__main__":
    main()
