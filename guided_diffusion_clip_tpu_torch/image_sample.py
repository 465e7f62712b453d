"""Sample the fork's CLIP-conditioned UNet from a checkpoint: the port of scripts/image_sample.py.

    python -m guided_diffusion_clip_tpu_torch.image_sample \\
        --config-file configs/image_sample_config.yaml \\
        --main_path runs --f <run> --load_file ema_0.9999_010000.pt \\
        --data_dir_test <images> --clip_file_path_test <clip dict>

The flags are scripts/image_sample.py's, plus ``--device`` (default ``cuda``;
a missing card is an error). A config file's keys win over the command
line's. The checkpoint is ``--model_path``, or ``{main_path}/{run}/{load_file}``
where ``run`` is the newest folder under ``--main_path`` whose name holds
``--f`` (``load_folder_path_parse``); either way a reference-format ``.pt``
state_dict, as ``image_train`` writes them (a ``.flax`` file is refused). With
``--sub_dir_tstsave`` the run directory ``{yymmdd_HHMMSS}_{description}`` is
made under ``{main_path}/{sub_dir_tstsave}``, else under ``--main_path``, else
it is ``$OPENAI_LOGDIR``.

Each batch takes its CLIP conditioning and its partner image (``img2``) from
the test set (``--data_dir_test``, ``--clip_file_path_test``; in order, no
crop or flip) and runs one chain of ``resolve_sampler``'s loop
(``--use_ddim``, ``--sampler``) under ``torch.inference_mode``, drawing from one
``torch.Generator`` a batch, seeded ``sample_seed(seed, batch)``.
``--denoise_start_point`` is given in the original schedule's steps and mapped
into the respaced chain, which then starts from ``img2`` noised to that step.
``--cfg_scale`` guides without a classifier (zero ``clip_feat``, or
``--cfg_null_y``, as the null), with ``--cfg_cache N`` (the unconditional half
one step in N) and ``--guidance_interval lo,hi``; ``--deep_cache N`` reuses the
deep sub-UNet's feature for N - 1 steps in N, with or without CFG;
``--conv_impl int8`` runs the int8 convs (kernels K4 and K5);
``--profile_dir`` writes a ``torch.profiler`` trace of the second batch's
chain.

Written to the run directory: ``samples_test{i}.png`` and ``target_{i}.png``
(a grid of batch i's samples and of its test images) and
``samples_{N}x{H}x{W}x3.npz`` (uint8). Batch i's copy to the host, its PNGs
and its uint8 conversion run while the card works on batch i + 1's chain
(``overlap_device_host``; the copy goes to pinned memory behind an event).

Under torchrun (``python -m torch.distributed.run --nproc_per_node N -m
guided_diffusion_clip_tpu_torch.image_sample ...``, one GPU a rank; JAX
:65-83, :240-279) each rank samples ``--batch_size`` rows a batch from its
shard of the test set, ``ceil(num_samples / (batch_size * world))`` batches;
batch i of rank r seeds its generator ``sample_seed(seed, i * world + r)``,
so one process draws what it always drew. Every batch is gathered in rank
order; rank 0 writes the PNGs of its own rows and the ``.npz``, then a
barrier. ``--spatial_shard S`` (torchrun with a multiple of S ranks,
``parallel/sp.py``) splits every image's rows over the S ranks of each data
group: the world is D = world / S data groups, batch i of data group d seeds
``sample_seed(seed, i * D + d)``, the data group's ranks read its shard of
the test set, and each chain's rows are gathered before they are written, so
the samples are the unsharded run's. ``--tensor_shard T`` (torchrun with a
multiple of T ranks, ``parallel/tp.py``) splits every activation's channels
over the T ranks of each data group, which reads, seeds and gathers as one rank
of the unsharded run (its data rank); the model's output is whole on every
rank. Both flags above 1 are refused, as is either outside torchrun.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .data.image_datasets import load_data
from .diffusion.deep_cache import cfg_deep_cache_pair, deep_cache_model_fn, zero_state
from .diffusion.guidance import cfg_cached_model_fn, cfg_cached_state0, cfg_model_fn, parse_guidance_interval
from .diffusion.sampling import sample_seed
from .models.unet import CONV_IMPLS
from .parallel import dist as pdist
from .parallel import sp, tp
from .utils import logger
from .utils.checkpoint import load_model_weights
from .utils.profiling import StepProfiler, annotate
from .utils.sample_util import add_delta_imgimg, overlap_device_host, to_device, to_host
from .utils.saving_imgs import save_img, tensor2img
from .utils.script_util import (
    add_dict_to_argparser,
    args_to_dict,
    create_model_and_diffusion,
    load_folder_path_parse,
    model_and_diffusion_defaults,
    parse_yaml,
    resolve_sampler,
)


def _refuse(args) -> None:
    sp.check_flags(getattr(args, "spatial_shard", 0), getattr(args, "tensor_shard", 0))
    if args.conv_impl not in CONV_IMPLS:
        raise SystemExit(f"--conv_impl {args.conv_impl!r}: choose from {', '.join(CONV_IMPLS)}")


def respaced_start(diffusion, denoise_start_point) -> int:
    """``--denoise_start_point`` (original-schedule steps; -1, None, "None" or
    "" for none) as a step of the respaced chain, or -1."""
    dsp = denoise_start_point
    dsp = -1 if dsp in (None, "None", "") else int(dsp)
    if dsp == -1:
        return -1
    T = diffusion.num_timesteps
    return min(int(round(dsp * T / diffusion.sched.original_num_steps)), T)


def make_chain(model, diffusion, args, calls=None):
    """The denoise chain of one batch that ``args`` ask for, as
    scripts/image_sample.py composes it: ``run_chain(batch, model_kwargs, rng,
    init_image=None, *, noise=None, step_noise=None)`` returns the samples.
    ``noise`` and ``step_noise`` replace the generator's draws (the start noise
    and each step's), for tests; ``calls`` (a dict), when given, counts the
    UNet's forwards under "unet_full" and "unet_shallow". Exits, as the JAX
    script does, on flags that do not compose."""
    cfg_scale = float(getattr(args, "cfg_scale", 0.0))
    cfg_cache_n = int(getattr(args, "cfg_cache", 0))
    deep_cache_n = int(getattr(args, "deep_cache", 0))
    deep_cut = int(getattr(args, "deep_cache_cut", 0))
    g_interval = parse_guidance_interval(getattr(args, "guidance_interval", ""))
    if g_interval is not None and not cfg_scale:
        raise SystemExit("--guidance_interval here gates CFG; it needs --cfg_scale")
    if g_interval is not None and deep_cache_n > 1:
        # the CFG branch's cache holds 2B rows, the plain branch's B
        raise SystemExit("--guidance_interval does not compose with --deep_cache + CFG")
    if cfg_cache_n > 1 and not cfg_scale:
        raise SystemExit("--cfg_cache caches the CFG uncond branch; it needs --cfg_scale")
    if cfg_cache_n > 1 and deep_cache_n > 1:
        # both wrappers own the loop's model state
        raise SystemExit("--cfg_cache does not compose with --deep_cache (yet)")
    loop = resolve_sampler(diffusion, args)
    dsp = respaced_start(diffusion, getattr(args, "denoise_start_point", -1))
    size, out_ch = model.config.image_size, model.config.out_channels

    def unet(x, t, cache_mode="off", **kw):
        if calls is not None:
            key = "unet_shallow" if cache_mode == "shallow" else "unet_full"
            calls[key] = calls.get(key, 0) + 1
        return model(x, t, cache_mode=cache_mode, **kw)

    def build_null(model_kwargs):
        # classifier-free guidance needs a model trained with --cond_dropout;
        # the null is a zero clip_feat or the reserved null class
        null = {}
        if model_kwargs.get("clip_feat") is not None:
            null["clip_feat"] = 0.0
        if model_kwargs.get("y") is not None:
            if args.cfg_null_y < 0:
                raise SystemExit("--cfg_scale on a y-labelled model needs --cfg_null_y")
            null["y"] = args.cfg_null_y
        if not null:
            # identical branches would double every call for an unguided result
            raise SystemExit(
                "--cfg_scale needs conditioning to guide on (clip_feat or y "
                "in the batch — is --clip_file_path_test/--class_cond set?)"
            )
        return null

    def run_chain(B, model_kwargs, rng, init_image=None, *, noise=None, step_noise=None):
        shape = (B, model.config.in_channels, size, size)
        device = next(model.parameters()).device
        kw = dict(clip_denoised=args.clip_denoised, model_kwargs=model_kwargs, denoise_start_point=dsp,
                  init_image=init_image, noise=noise)
        if step_noise is not None:
            kw["step_noise"] = step_noise
        model_fn = unet
        if deep_cache_n > 1:
            def cached_apply(x, t, **k):
                return unet(x, t, cache_cut=deep_cut, **k)

            if cfg_scale:
                apply_full, apply_shallow = cfg_deep_cache_pair(cached_apply, cfg_scale, build_null(model_kwargs))
                rows = 2 * B
            else:
                def apply_full(x, t, **k):
                    return cached_apply(x, t, cache_mode="full", **k)

                def apply_shallow(x, t, deep, **k):
                    return cached_apply(x, t, deep_cache=deep, cache_mode="shallow", **k)

                rows = B
            kw["model_state0"] = zero_state(model.config, rows, deep_cut, dtype=model.dtype, device=device)
            model_fn = deep_cache_model_fn(apply_full, apply_shallow, deep_cache_n)
        elif cfg_scale and cfg_cache_n > 1:
            model_fn = cfg_cached_model_fn(unet, cfg_scale, build_null(model_kwargs), cfg_cache_n,
                                           interval=g_interval)
            kw["model_state0"] = cfg_cached_state0((B, out_ch, size, size), device=device)
        elif cfg_scale:
            model_fn = cfg_model_fn(unet, cfg_scale, build_null(model_kwargs), interval=g_interval)
        return loop(model_fn, shape, rng, **kw)

    return run_chain


def main(argv=None) -> dict:
    """Run the CLI; returns {"path": the npz, "batch_seconds": each chain's
    time (CUDA events on the card), "batches", "steps": steps a chain,
    "calls": the UNet's full and shallow forwards}."""
    args = parse_yaml(create_argparser().parse_args(argv))
    _refuse(args)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    with (pdist.process_group(args.device) as device, sp.from_flag(args.spatial_shard, args.batch_size),
          tp.from_flag(args.tensor_shard, args.batch_size)):
        return sample(args, device)


def sample(args, device: torch.device) -> dict:
    load_folder_path_parse(args)
    if getattr(args, "main_path", None) and getattr(args, "sub_dir_tstsave", None):
        args.main_path = os.path.join(args.main_path, args.sub_dir_tstsave)
    if not args.model_path:
        raise SystemExit("--model_path (or --main_path, --f and --load_file): a reference-format .pt is required")

    # the model built on its device: the initializer, which the loaded weights replace, runs there
    with torch.device(device):
        model, diffusion = create_model_and_diffusion(
            **args_to_dict(args, model_and_diffusion_defaults().keys()), conv_impl=args.conv_impl)
    try:
        load_model_weights(model, args.model_path)
    except ValueError as e:  # a .flax checkpoint
        raise SystemExit(str(e)) from None
    model = model.to(device).eval().requires_grad_(False)
    calls = {"unet_full": 0, "unet_shallow": 0}
    run_chain = make_chain(model, diffusion, args, calls)
    dsp = respaced_start(diffusion, args.denoise_start_point)

    logger.configure(args=args)
    logger.log("\n\t".join(f"{k} = {v}" for k, v in vars(args).items()))
    logger.log(f"model loaded from {args.model_path}")
    if dsp != -1:
        logger.log(f"denoise_start_point {args.denoise_start_point} -> respaced step {dsp}")
    logger.log("loading data...")
    data = load_data(
        data_dir=args.data_dir_test,
        batch_size=args.batch_size,
        image_size=args.image_size,
        class_cond=args.class_cond,
        deterministic=True,
        random_crop=False,
        random_flip=False,
        clip_file_path=args.clip_file_path_test or None,
    )

    # the first batch's chain builds the kernels' plans; the second is the steady state
    prof = StepProfiler(args.profile_dir, first_step=1, num_steps=1)
    cuda = device.type == "cuda"
    # under --spatial_shard a data group's ranks draw and write alike
    rank, world = sp.data_rank(), sp.data_size()
    n_batches = -(-args.num_samples // (args.batch_size * world))
    all_images, batch_seconds = [], []
    logger.log("sampling...")

    def dispatched():
        for counter in range(n_batches):
            imgs, kwargs = next(data)
            model_kwargs = {k: to_device(v, device) for k, v in add_delta_imgimg(kwargs).items()}
            init_image = model_kwargs.get("img2") if dsp != -1 else None
            rng = torch.Generator(device=device).manual_seed(sample_seed(args.seed, counter * world + rank))
            prof.maybe_start(counter)
            if cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            else:
                t0 = time.perf_counter()
            with prof.step_scope(counter), annotate("sample_chain"), torch.inference_mode():
                sample = sp.gather_rows(run_chain(len(imgs), model_kwargs, rng, init_image))
                sample = sample.permute(0, 2, 3, 1).contiguous()
            if cuda:
                end.record()
                timing = (start, end)
            else:
                timing = time.perf_counter() - t0
            prof.maybe_stop(counter)
            yield counter, imgs, to_host(sample), timing

    def write_batch(item):
        counter, imgs, (host, event), timing = item
        if event is not None:
            event.synchronize()
            timing = timing[0].elapsed_time(timing[1]) / 1e3
        batch_seconds.append(timing)
        sample_np = host.numpy()
        sample_u8 = ((sample_np + 1) * 127.5).clip(0, 255).astype(np.uint8)
        if pdist.rank() == 0:
            save_img(tensor2img(sample_np), os.path.join(logger.get_dir(), f"samples_test{counter}.png"))
            save_img(tensor2img(np.asarray(imgs).transpose(0, 2, 3, 1)),
                     os.path.join(logger.get_dir(), f"target_{counter}.png"))
        all_images.extend(sp.gather_data_groups(sample_u8))  # data-rank order
        logger.log(f"created {len(all_images) * args.batch_size} samples ({timing:.3f} s for the batch)")

    try:
        overlap_device_host(dispatched(), write_batch)
    finally:
        prof.stop()

    arr = np.concatenate(all_images, axis=0)[: args.num_samples]
    shape_str = "x".join(str(x) for x in arr.shape)
    out_path = os.path.join(logger.get_dir(), f"samples_{shape_str}.npz")
    if pdist.rank() == 0:
        logger.log(f"saving to {out_path}")
        np.savez(out_path, arr)
    pdist.barrier("sampling")
    logger.log("sampling complete")
    return {"path": out_path, "batch_seconds": batch_seconds, "batches": n_batches,
            "steps": diffusion.num_timesteps if dsp == -1 else dsp, "calls": calls}


def create_argparser():
    defaults = dict(
        clip_denoised=True,
        num_samples=10000,
        batch_size=16,
        use_ddim=False,
        model_path="",
        denoise_start_point=-1,
        data_dir_test="",
        clip_file_path_test="",
        main_path="",
        sub_dir_tstsave="",
        load_file="",
        f="",
        seed=0,
        device="cuda",
        conv_impl="auto",  # auto or xla: cuDNN; int8: kernels K4 and K5
        cfg_scale=0.0,  # > 0: classifier-free guidance (a model trained with cond_dropout)
        cfg_null_y=-1,  # null class index for CFG on y-labelled models
        cfg_cache=0,  # N > 1: recompute the CFG uncond branch 1 step in N
        guidance_interval="",  # "lo,hi": CFG only for t in [lo, hi] (original units)
        deep_cache=0,  # N > 1: refresh the deep sub-UNet every N steps (DeepCache)
        deep_cache_cut=0,  # shallow input blocks; 0 = below the full-resolution level
        spatial_shard=0,  # S > 1: each image's rows over S ranks (torchrun, a multiple of S ranks)
        tensor_shard=0,  # T > 1: each activation's channels over T ranks (torchrun, a multiple of T ranks)
        sampler="",  # "" (use_ddim decides), ancestral, ddim or dpm++2m
        profile_dir="",  # a torch.profiler trace of the second batch's chain here
    )
    defaults.update(model_and_diffusion_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


if __name__ == "__main__":
    main()
