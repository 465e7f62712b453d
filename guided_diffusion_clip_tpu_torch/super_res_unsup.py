"""Train the fork's SR-delta model: the port of scripts/super_res_unsup.py.

    python -m guided_diffusion_clip_tpu_torch.super_res_unsup --data_dir <images> \\
        --clip_file_path <clip dict> --class_cond True --large_size 128 ...

Trains ``SRImageModel_Feat`` (``sr_create_model_and_diffusion``: x ++ img2 on
the channels, conditioned on clip_feat - clip_feat2 + bias_feat) on the
(image, img2, clip_feat, clip_feat2) quadruples that the CLIP-paired loader
yields (the reference's low_res path is dead code, super_res_unsup.py:43-68).
Validation samples come from ``--data_dir`` and, when given,
``--data_dir_test`` (``--val_batch_size``). ``--load <fragment>`` resumes
from ``{main_path}/{run}/{load_file}``, ``run`` the newest folder under
``--main_path`` whose name holds the fragment (``load_folder_path_parse``).
The flags are the JAX script's, plus ``--device`` (default ``cuda``; a
missing card is an error); ``--train_conv_impl int8`` trains through the int8
convs, as ``image_train``. The run directory and its checkpoints are
``image_train``'s.

Under torchrun each rank trains on its shard of the folder, and
``--param_sharding fsdp``, ``--opt_impl zero1`` and ``--ckpt_backend orbax``
run as under ``image_train``, and ``--spatial_shard S`` too (each image's
rows over the S ranks of a data group, ``parallel/sp.py``) and
``--tensor_shard T`` (each activation's channels over the T ranks of a data
group, ``parallel/tp.py``), with ``image_train``'s refusals.
"""

from __future__ import annotations

import argparse

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
    load_folder_path_parse,
    parse_yaml,
    sr_create_model_and_diffusion,
    sr_model_and_diffusion_defaults,
)


def main(argv=None) -> None:
    args = parse_yaml(create_argparser().parse_args(argv))
    _refuse_unported(args)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    if args.load:
        args.f = args.load
        load_folder_path_parse(args)
        args.resume_checkpoint = args.model_path
    with (pdist.process_group(args.device) as device, sp.from_flag(args.spatial_shard, args.batch_size),
          tp.from_flag(args.tensor_shard, args.batch_size)):
        train(args, device)


def train(args, device: torch.device) -> None:
    logger.configure(args=args)
    logger.log("\n\t".join(f"{k} = {v}" for k, v in vars(args).items()))

    logger.log("creating model...")
    model, diffusion = sr_create_model_and_diffusion(
        **args_to_dict(args, sr_model_and_diffusion_defaults().keys()), conv_impl=args.train_conv_impl)
    model.to(device)
    schedule_sampler = create_named_schedule_sampler(args.schedule_sampler, diffusion.num_timesteps)

    logger.log("creating data loaders...")
    data = load_data(data_dir=args.data_dir, batch_size=args.batch_size, image_size=args.large_size,
                     class_cond=args.class_cond, clip_file_path=args.clip_file_path or None)
    val_datasets = [
        load_data(data_dir=data_dir, batch_size=args.val_batch_size, image_size=args.large_size,
                  class_cond=args.class_cond, deterministic=True, clip_file_path=clip_file or None)
        for data_dir, clip_file in ((args.data_dir, args.clip_file_path),
                                    (args.data_dir_test, args.clip_file_path_test))
        if data_dir
    ]

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
        val_datasets=val_datasets or None,
        val_batch_size=args.val_batch_size,
        loss_weighting=args.loss_weighting,
        param_sharding=args.param_sharding,
        opt_impl=args.opt_impl,
        ckpt_backend=args.ckpt_backend,
        tensor_shard=args.tensor_shard,  # the CLI's TP, pinned to the loop's own groups
    ).run_loop()


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(
        data_dir="",
        data_dir_test="",
        clip_file_path="",
        clip_file_path_test="",
        main_path="",
        schedule_sampler="uniform",
        lr=1e-4,
        weight_decay=0.0,
        lr_anneal_steps=0,
        batch_size=1,
        microbatch=-1,
        ema_rate="0.9999",
        log_interval=100,
        save_interval=5000,
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
        # the fork's extras (super_res_unsup.py:148-149)
        SR_mode=True,
        resume_ema_opt=False,
        val_batch_size=8,
        load="",  # a run-folder fragment under main_path to resume from (with load_file)
        load_file="",
        f="",
        device="cuda",
    )
    defaults.update(sr_model_and_diffusion_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


if __name__ == "__main__":
    main()
