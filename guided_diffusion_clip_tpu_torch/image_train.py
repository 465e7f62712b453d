"""Train a diffusion model on images: the port of scripts/image_train.py.

    python -m guided_diffusion_clip_tpu_torch.image_train --config-file configs/config.yaml

The fork's recipe (``configs/config.yaml``) trains the CLIP-conditioned UNet
at 128 px on an image folder (``--data_dir``) with a dict of CLIP image
embeddings (``--clip_file_path``, ``.pt`` or ``.npz``, two per file: plain and
flipped). The flags are scripts/image_train.py's, plus ``--device`` (default
``cuda``; a missing card is an error). A config file's keys win over the
command line's (``parse_yaml``). The run directory is
``{main_path}/{yymmdd_HHMMSS}_{description}`` (``-d``), else
``$OPENAI_LOGDIR``; it receives ``log.txt``, ``progress.csv``, the
checkpoints ``model{step:06d}.pt``, ``ema_{rate}_{step:06d}.pt`` and
``opt{step:06d}.pt`` every ``--save_interval`` steps, and the validation
grids. ``DIFFUSION_TRAINING_TEST=1`` stops after the first save.

``--train_conv_impl int8`` trains through the int8 convs (kernels K4, K5 and
the quantize kernels in the forward, straight-through convs on cuDNN in the
backward; ``auto`` and ``xla`` are cuDNN throughout), ``--profile_dir`` writes
a ``torch.profiler`` trace of steps 1 to 3, and
``GDC_NATIVE_LOADER=1`` decodes the images with the native C++ library (built
at first use; a failed build is an error).

Not yet ported, and refused at startup: ``--param_sharding fsdp``,
``--opt_impl zero1``, ``--spatial_shard``, ``--tensor_shard`` and
``--ckpt_backend orbax``.
"""

from __future__ import annotations

import argparse

import torch

from .data.image_datasets import load_data
from .models.unet import CONV_IMPLS
from .training.resample import create_named_schedule_sampler
from .training.train_loop import TrainLoop, check_ported
from .utils import logger
from .utils.script_util import (
    add_dict_to_argparser,
    args_to_dict,
    create_model_and_diffusion,
    image_train_defaults,
    model_and_diffusion_defaults,
    parse_yaml,
)


def _refuse_unported(args) -> None:
    """Exit on a flag that is not yet ported or not known, before the run directory is made;
    ``TrainLoop`` is then given none of the flags ``check_ported`` reads (the
    model's dtype picks the bf16 torso, so ``--use_fp16``'s loss scaling has
    nothing to act on, and ``--opt_impl tree`` and ``flat`` run one AdamW)."""
    try:
        check_ported(param_sharding=args.param_sharding, opt_impl=args.opt_impl,
                     spatial_shard=args.spatial_shard, tensor_shard=args.tensor_shard,
                     ckpt_backend=args.ckpt_backend)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(str(e)) from None
    if args.train_conv_impl not in CONV_IMPLS:
        raise SystemExit(f"--train_conv_impl {args.train_conv_impl!r}: choose from {', '.join(CONV_IMPLS)}")


def main(argv=None) -> None:
    args = parse_yaml(create_argparser().parse_args(argv))
    _refuse_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    logger.configure(args=args)

    logger.log("\n\t".join(f"{k} = {v}" for k, v in vars(args).items()))
    logger.log("creating model and diffusion...")
    model, diffusion = create_model_and_diffusion(
        **args_to_dict(args, model_and_diffusion_defaults().keys()), conv_impl=args.train_conv_impl)
    model.to(device)
    schedule_sampler = create_named_schedule_sampler(args.schedule_sampler, diffusion.num_timesteps)

    logger.log(f"creating data loader... dir: {args.data_dir}")
    data = load_data(
        data_dir=args.data_dir,
        batch_size=args.batch_size,
        image_size=args.image_size,
        class_cond=args.class_cond,
        clip_file_path=args.clip_file_path or None,
    )
    # val/test loaders only for the folders that are given
    val_datasets = []
    for data_dir, clip_file in ((args.data_dir, args.clip_file_path), (args.data_dir_test, args.clip_file_path_test)):
        if data_dir:
            val_datasets.append(load_data(
                data_dir=data_dir,
                batch_size=args.val_batch_size,
                image_size=args.image_size,
                class_cond=args.class_cond,
                deterministic=True,
                clip_file_path=clip_file or None,
            ))

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
        cond_dropout=args.cond_dropout,
        cond_null_y=args.cfg_null_y,
        profile_dir=args.profile_dir,
    ).run_loop()


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(image_train_defaults(), device="cuda")
    defaults.update(model_and_diffusion_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


if __name__ == "__main__":
    main()
