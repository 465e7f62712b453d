"""Approximate bits per dimension of an image model: the port of scripts/image_nll.py.

    python -m guided_diffusion_clip_tpu_torch.image_nll --model_path ema_0.9999_010000.pt \\
        --data_dir <images> --clip_file_path <clip dict> --num_samples 1000 --batch_size 8 <model flags>

The flags are scripts/image_nll.py's, plus ``--device`` (default ``cuda``; a
missing card is an error). Each batch of the folder (in order, no crop or
flip) runs the whole chain of ``calc_bpd_loop`` (every t of the schedule, one
UNet forward each) under ``torch.inference_mode``, its noise from one
``torch.Generator`` seeded with the rank (0 for one process). Logged: the running mean bpd. Written to the
run directory: ``vb_terms.npz``, ``mse_terms.npz`` and ``xstart_mse_terms.npz``,
each the (T,) per-t term averaged over the batch and then over the batches.
Under torchrun (JAX :98-110) each rank scores its shard of the folder, each
batch's terms and bpd are averaged over the ranks, and rank 0 writes the
files, then a barrier.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .data.image_datasets import load_data
from .parallel import dist as pdist
from .utils import logger
from .utils.checkpoint import load_model_weights
from .utils.script_util import (
    add_dict_to_argparser,
    args_to_dict,
    create_model_and_diffusion,
    model_and_diffusion_defaults,
    parse_yaml,
)


def main(argv=None) -> dict:
    """Run the CLI; returns ``run_bpd_evaluation``'s result."""
    args = parse_yaml(create_argparser().parse_args(argv))
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    with pdist.process_group(args.device) as device:
        return evaluate(args, device)


def evaluate(args, device: torch.device) -> dict:
    model, diffusion = create_model_and_diffusion(**args_to_dict(args, model_and_diffusion_defaults().keys()))
    try:
        load_model_weights(model, args.model_path)
    except ValueError as e:  # a .flax checkpoint
        raise SystemExit(str(e)) from None
    model = model.to(device).eval().requires_grad_(False)
    logger.configure(args=args)
    logger.log(f"model loaded from {args.model_path}")

    logger.log("creating data loader...")
    data = load_data(
        data_dir=args.data_dir,
        batch_size=args.batch_size,
        image_size=args.image_size,
        class_cond=args.class_cond,
        deterministic=True,
        clip_file_path=args.clip_file_path or None,
    )
    logger.log("evaluating...")
    return run_bpd_evaluation(model, diffusion, data, args.num_samples, args.clip_denoised)


def run_bpd_evaluation(model, diffusion, data, num_samples, clip_denoised, *, noise=None) -> dict:
    """``calc_bpd_loop`` on the model's device over batches of ``data`` until
    ``num_samples`` images are done; writes ``{vb, mse, xstart_mse}_terms.npz`` (each the (T,) term
    averaged over a batch, then over the batches) to the logger's directory.
    ``noise[i]``, when given, is batch i's per-t noise (``calc_bpd_loop``'s
    ``noise``), for tests. Returns {"bpd": each batch's mean total bpd,
    "terms": the three (T,) arrays, "samples": images done}."""
    device = next(model.parameters()).device
    rng = torch.Generator(device=device).manual_seed(pdist.rank())
    all_bpd = []
    all_metrics = {"vb": [], "mse": [], "xstart_mse": []}
    num_complete = 0
    while num_complete < num_samples:
        batch, model_kwargs = next(data)
        x = torch.as_tensor(batch).to(device)
        kwargs = {k: torch.as_tensor(v).to(device) for k, v in model_kwargs.items()}
        with torch.inference_mode():
            metrics = diffusion.calc_bpd_loop(
                model, x, rng, noise=None if noise is None else noise[len(all_bpd)],
                clip_denoised=clip_denoised, model_kwargs=kwargs,
            )
        for key, term_list in all_metrics.items():
            term_list.append(pdist.all_gather_host(metrics[key].float().mean(dim=0).cpu().numpy()).mean(axis=0))
        all_bpd.append(float(pdist.all_gather_host(metrics["total_bpd"].float().mean().cpu().numpy()).mean()))
        num_complete += pdist.world_size() * x.shape[0]
        logger.log(f"done {num_complete} samples: bpd={np.mean(all_bpd)}")

    terms = {name: np.mean(np.stack(v), axis=0) for name, v in all_metrics.items()}
    if pdist.is_primary():
        for name, value in terms.items():
            out_path = os.path.join(logger.get_dir(), f"{name}_terms.npz")
            logger.log(f"saving {name} terms to {out_path}")
            np.savez(out_path, value)
    pdist.barrier("nll")
    logger.log("evaluation complete")
    return {"bpd": all_bpd, "terms": terms, "samples": num_complete}


def create_argparser():
    defaults = dict(
        data_dir="",
        clip_file_path="",
        main_path="",
        clip_denoised=True,
        num_samples=1000,
        batch_size=1,
        model_path="",
        device="cuda",
    )
    defaults.update(model_and_diffusion_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


if __name__ == "__main__":
    main()
