"""Sweep the denoising start depth over test images: the port of
scripts/super_res_depth_sweep_sample.py.

    python -m guided_diffusion_clip_tpu_torch.super_res_depth_sweep_sample \\
        --model_path <model.pt> --data_dir_test <images> --clip_file_path_test <clip dict> ...

The model is the fork's CLIP UNet (``create_model_and_diffusion``). One
batch of the test set (in order, no crop or flip; its kwargs staged by
``process1``) is denoised from ``img2`` noised to each depth of
``range(500, 1000, 199)`` (original-schedule steps, reference :62), mapped
into the respaced chain as ``image_sample``'s ``--denoise_start_point``
(``respaced_start``), by the ancestral loop. Depth i draws from a
``torch.Generator`` seeded ``sample_seed(seed, i * world + rank)``: under
torchrun (JAX :50, :93) each rank sweeps the first batch of its shard of the
test set, and rank 0 writes the PNGs of its own. The checkpoint is
``--model_path``, or ``{main_path}/{run}/{load_file}`` with ``--f``
(``load_folder_path_parse``); ``--sub_dir_tstsave`` puts the run directory
under ``{main_path}/{sub_dir_tstsave}``.

Written to the run directory: ``depth_{depth}.png`` for each depth (a grid of
the batch's samples), ``target.png`` (the test images) and ``start.png``
(img2). The flags are the JAX script's, plus ``--device`` (default ``cuda``;
a missing card is an error); ``--conv_impl int8`` runs the int8 convs.
``--spatial_shard S`` (torchrun with a multiple of S ranks,
``parallel/sp.py``) splits every image's rows over the S ranks of each data
group, which reads and seeds as one rank of the unsharded run (its data
rank); each chain's rows are gathered before the write. ``--tensor_shard T``
(torchrun with a multiple of T ranks, ``parallel/tp.py``) splits every
activation's channels over the T ranks of each data group, which reads and
seeds as one rank of the unsharded run (its data rank); the model's output is
whole on every rank. Both flags above 1 are refused, as is either outside
torchrun.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .data.image_datasets import load_data
from .diffusion.sampling import sample_seed
from .image_sample import _refuse, respaced_start
from .parallel import dist as pdist
from .parallel import sp, tp
from .utils import logger
from .utils.checkpoint import load_model_weights
from .utils.sample_util import process1, to_device
from .utils.saving_imgs import save_img, tensor2img
from .utils.script_util import (
    add_dict_to_argparser,
    args_to_dict,
    create_model_and_diffusion,
    load_folder_path_parse,
    model_and_diffusion_defaults,
    parse_yaml,
)

DEPTHS = tuple(range(500, 1000, 199))  # reference :62


def main(argv=None) -> dict:
    """Run the CLI; returns {"dir": the run directory, "depths": {depth:
    (respaced start step, seconds of its chain)}, "calls": the UNet's
    forwards}. A chain's seconds are CUDA events on the card."""
    args = parse_yaml(create_argparser().parse_args(argv))
    _refuse(args)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    with (pdist.process_group(args.device) as device, sp.from_flag(args.spatial_shard, args.batch_size),
          tp.from_flag(args.tensor_shard, args.batch_size)):
        return sweep(args, device)


def sweep(args, device: torch.device) -> dict:
    load_folder_path_parse(args)
    if getattr(args, "main_path", None) and getattr(args, "sub_dir_tstsave", None):
        args.main_path = os.path.join(args.main_path, args.sub_dir_tstsave)
    if not args.model_path:
        raise SystemExit("--model_path (or --main_path, --f and --load_file): a reference-format .pt is required")
    logger.configure(args=args)
    logger.log("\n\t".join(f"{k} = {v}" for k, v in vars(args).items()))

    logger.log("creating model and diffusion...")
    model, diffusion = create_model_and_diffusion(
        **args_to_dict(args, model_and_diffusion_defaults().keys()), conv_impl=args.conv_impl)
    try:
        load_model_weights(model, args.model_path)
    except ValueError as e:  # a .flax checkpoint
        raise SystemExit(str(e)) from None
    model = model.to(device).eval().requires_grad_(False)
    calls = {"unet": 0}

    def unet(x, t, **kw):
        calls["unet"] += 1
        return model(x, t, **kw)

    logger.log("loading data...")
    data = load_data(data_dir=args.data_dir_test, batch_size=args.batch_size, image_size=args.image_size,
                     class_cond=args.class_cond, deterministic=True, random_crop=False, random_flip=False,
                     clip_file_path=args.clip_file_path_test or None)
    imgs, kwargs = next(data)
    model_kwargs = {k: to_device(v, device) for k, v in process1(kwargs).items()}
    start = model_kwargs.get("img2", to_device(imgs, device))
    shape = (len(imgs), 3, args.image_size, args.image_size)
    out, cuda = {}, device.type == "cuda"
    rank, world = sp.data_rank(), sp.data_size()  # a data group's ranks draw alike under --spatial_shard
    for i, depth in enumerate(DEPTHS):
        st = respaced_start(diffusion, depth)
        rng = torch.Generator(device=device).manual_seed(sample_seed(args.seed, i * world + rank))
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        with torch.inference_mode():
            sample = diffusion.p_sample_loop(unet, shape, rng, clip_denoised=args.clip_denoised,
                                             model_kwargs=model_kwargs, denoise_start_point=st, init_image=start)
        if cuda:
            ev[1].record()
        sample = sp.gather_rows(sample).permute(0, 2, 3, 1).float().cpu().numpy()  # waits for the chain
        secs = ev[0].elapsed_time(ev[1]) / 1e3 if cuda else time.perf_counter() - t0
        path = os.path.join(logger.get_dir(), f"depth_{depth}.png")
        if pdist.rank() == 0:
            save_img(tensor2img(sample), path)
        out[depth] = (st, secs)
        logger.log(f"depth {depth} (respaced {st}) -> {path} ({secs:.3f} s)")
    if pdist.rank() == 0:
        save_img(tensor2img(np.asarray(imgs).transpose(0, 2, 3, 1)), os.path.join(logger.get_dir(), "target.png"))
        save_img(tensor2img(start.permute(0, 2, 3, 1).float().cpu().numpy()),
                 os.path.join(logger.get_dir(), "start.png"))
    pdist.barrier("sweep")
    logger.log("sweep complete")
    return {"dir": logger.get_dir(), "depths": out, "calls": calls}


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(
        clip_denoised=True,
        num_samples=8,
        batch_size=8,
        use_ddim=False,
        model_path="",
        data_dir_test="",
        clip_file_path_test="",
        main_path="",
        sub_dir_tstsave="",
        load_file="",
        f="",
        seed=0,
        device="cuda",
        conv_impl="auto",  # auto or xla: cuDNN; int8: kernels K4 and K5
        spatial_shard=0,  # S > 1: each image's rows over S ranks (torchrun, a multiple of S ranks)
        tensor_shard=0,  # T > 1: each activation's channels over T ranks (torchrun, a multiple of T ranks)
        denoise_start_point=-1,
    )
    defaults.update(model_and_diffusion_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


if __name__ == "__main__":
    main()
