"""Train the upstream super-resolution model: the port of scripts/super_res_train.py.

    python -m guided_diffusion_clip_tpu_torch.super_res_train --data_dir <images> \\
        --large_size 128 --small_size 64 ...

``load_superres_data`` wraps the image loader and adds a ``low_res`` kwarg,
the large batch area-downsampled to ``--small_size`` (super_res_train.py:82-92).
The model is the SR factory's configuration re-dispatched to the upstream
``super_res`` variant (x ++ bilinear-upsampled low_res; a class table when
``--class_cond``), as the JAX script does: the fork's factory builds the
img2 / CLIP-delta model, and these batches carry ``low_res``; the checkpoint
is the one ``super_res_sample`` reads. The flags are the JAX script's, plus
``--device`` (default ``cuda``; a missing card is an error); the rest is
``image_train``'s: the run directory, the checkpoints, ``--train_conv_impl
int8``, torchrun with ``--param_sharding fsdp``, ``--opt_impl zero1`` and
``--ckpt_backend orbax``, and the refusals of what is not yet ported.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .data.image_datasets import load_data
from .image_train import _refuse_unported
from .parallel import dist as pdist
from .parallel import sp, tp
from .training.resample import create_named_schedule_sampler
from .training.train_loop import TrainLoop
from .utils import logger
from .utils.script_util import (
    add_dict_to_argparser,
    args_to_dict,
    parse_yaml,
    sr_create_model_and_diffusion,
    sr_model_and_diffusion_defaults,
    upstream_super_res,
)


def area_downsample(batch: np.ndarray, size: int) -> np.ndarray:
    """NCHW area (average-pool) downsample to ``size``, as
    ``F.interpolate(mode="area")`` for an integer factor (super_res_train.py:89)."""
    B, C, H, W = batch.shape
    f = H // size
    if f * size != H or W != H:
        raise ValueError(f"area downsample needs a square batch and an integer factor, got {H}x{W} -> {size}")
    return batch.reshape(B, C, size, f, size, f).mean(axis=(3, 5))


def load_superres_data(data_dir, batch_size, large_size, small_size, class_cond=False, clip_file_path=None):
    """``load_data``'s batches with ``low_res``, each batch area-downsampled to ``small_size``."""
    data = load_data(data_dir=data_dir, batch_size=batch_size, image_size=large_size, class_cond=class_cond,
                     clip_file_path=clip_file_path)
    for large_batch, model_kwargs in data:
        model_kwargs["low_res"] = area_downsample(large_batch, small_size)
        yield large_batch, model_kwargs


def main(argv=None) -> None:
    args = parse_yaml(create_argparser().parse_args(argv))
    _refuse_unported(args)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    with (pdist.process_group(args.device) as device, sp.from_flag(args.spatial_shard, args.batch_size),
          tp.from_flag(args.tensor_shard, args.batch_size)):
        train(args, device)


def train(args, device: torch.device) -> None:
    logger.configure(args=args)

    logger.log("creating model...")
    model, diffusion = sr_create_model_and_diffusion(
        **args_to_dict(args, sr_model_and_diffusion_defaults().keys()), conv_impl=args.train_conv_impl)
    model = upstream_super_res(model, args.class_cond).to(device)
    schedule_sampler = create_named_schedule_sampler(args.schedule_sampler, diffusion.num_timesteps)

    logger.log("creating data loader...")
    data = load_superres_data(args.data_dir, args.batch_size, large_size=args.large_size,
                              small_size=args.small_size, class_cond=args.class_cond,
                              clip_file_path=args.clip_file_path or None)

    logger.log("training...")
    TrainLoop(
        model=model,
        diffusion=diffusion,
        data=data,
        batch_size=args.batch_size,
        microbatch=args.microbatch,
        lr=args.lr,
        ema_rate=args.ema_rate,
        log_interval=args.log_interval,
        save_interval=args.save_interval,
        resume_checkpoint=args.resume_checkpoint,
        schedule_sampler=schedule_sampler,
        weight_decay=args.weight_decay,
        lr_anneal_steps=args.lr_anneal_steps,
        loss_weighting=args.loss_weighting,
        param_sharding=args.param_sharding,
        opt_impl=args.opt_impl,
        ckpt_backend=args.ckpt_backend,
        tensor_shard=args.tensor_shard,  # the CLI's TP, pinned to the loop's own groups
    ).run_loop()


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(
        data_dir="",
        clip_file_path="",
        main_path="",
        schedule_sampler="uniform",
        lr=1e-4,
        weight_decay=0.0,
        lr_anneal_steps=0,
        batch_size=1,
        microbatch=-1,
        ema_rate="0.9999",
        log_interval=10,
        save_interval=10000,
        resume_checkpoint="",
        use_fp16=False,
        fp16_scale_growth=1e-3,
        param_sharding="replicated",  # "fsdp": FSDP2 (under torchrun)
        opt_impl="tree",  # "flat": the same fused AdamW; "zero1": ZeRO-1 (under torchrun)
        spatial_shard=0,  # S > 1: each image's rows over S ranks (torchrun, a multiple of S ranks)
        tensor_shard=0,  # T > 1: each activation's channels over T ranks (torchrun, a multiple of T ranks)
        ckpt_backend="flax",  # the per-kind checkpoint files (.pt here); "orbax": DCP directories
        train_conv_impl="xla",  # "int8": the int8 convs (K4, K5) in the forward, straight-through backward
        loss_weighting="",  # "min_snr_5": SNR-clipped loss re-weighting
        device="cuda",
    )
    defaults.update(sr_model_and_diffusion_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


if __name__ == "__main__":
    main()
