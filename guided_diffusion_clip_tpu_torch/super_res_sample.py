"""Upsample base samples with the SR model: the port of scripts/super_res_sample.py.

    python -m guided_diffusion_clip_tpu_torch.super_res_sample --model_path <model.pt> \\
        --base_samples <samples_Nx64x64x3.npz> --large_size 128 --small_size 64 ...

The base samples are an ``image_sample`` npz (NHWC uint8, ``arr_0``; with
``--class_cond`` the labels ``arr_1``), read in order and looped
(``load_data_for_worker``, rows ``rank::world``) as ``low_res`` in [-1, 1] NCHW. The
model is ``super_res_train``'s: the SR factory's configuration re-dispatched
to the upstream ``super_res`` variant, loaded strict from a reference-format
``.pt``. Each batch runs the ancestral chain, as the reference (which ignores
``--use_ddim`` here); ``--sampler ddim`` or ``dpm++2m`` is the opt-in for a
fast chain. One ``torch.Generator`` a batch, batch i of rank r seeded
``sample_seed(seed, i * world + r)``. ``--conv_impl int8`` runs the int8
convs (kernels K4 and K5).

The flags are the JAX script's, plus ``--device`` (default ``cuda``; a
missing card is an error). The run directory is ``{main_path}/{yymmdd_HHMMSS}_
{description}``, else ``$OPENAI_LOGDIR``; it receives ``samples_{N}x{H}x{W}x3.npz``
(NHWC uint8), as the JAX script writes it. Batch i's copy to the host and its
uint8 conversion run while the card works on batch i + 1's chain
(``overlap_device_host``).

Under torchrun (JAX :45-46, :126-152) each rank runs ``ceil(num_samples /
(batch_size * world))`` batches of its rows; every batch is gathered in rank
order and rank 0 writes the ``.npz``, then a barrier. ``--spatial_shard S``
(torchrun with a multiple of S ranks, ``parallel/sp.py``) splits every
image's rows over the S ranks of each data group, which reads, seeds and
gathers as one rank of the unsharded run (its data rank); the model
upsamples the full ``low_res`` and slices it, and each chain's rows are
gathered before the write. ``--tensor_shard T`` (torchrun with a multiple of T
ranks, ``parallel/tp.py``) splits every activation's channels over the T ranks
of each data group, which reads, seeds and gathers as one rank of the unsharded
run (its data rank); the model's output is whole on every rank. Both flags
above 1 are refused, as is either outside torchrun.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .diffusion.sampling import sample_seed
from .models.unet import CONV_IMPLS
from .parallel import dist as pdist
from .parallel import sp, tp
from .utils import logger
from .utils.checkpoint import load_model_weights
from .utils.sample_util import overlap_device_host, to_device, to_host
from .utils.script_util import (
    add_dict_to_argparser,
    args_to_dict,
    parse_yaml,
    resolve_sampler,
    sr_create_model_and_diffusion,
    sr_model_and_diffusion_defaults,
    upstream_super_res,
)


def _refuse(args) -> None:
    sp.check_flags(getattr(args, "spatial_shard", 0), getattr(args, "tensor_shard", 0))
    if args.conv_impl not in CONV_IMPLS:
        raise SystemExit(f"--conv_impl {args.conv_impl!r}: choose from {', '.join(CONV_IMPLS)}")


def load_data_for_worker(base_samples, batch_size, class_cond):
    """Batches of this rank's rows of the npz (``rank::world``) in order,
    looped (super_res_sample.py:77-100): {"low_res": (B, 3, h, w) f32 in
    [-1, 1]} and, with ``class_cond`` and labels in the file, "y"."""
    with open(base_samples, "rb") as f:
        obj = np.load(f)
        image_arr = obj["arr_0"]
        label_arr = obj["arr_1"] if class_cond and "arr_1" in obj else None
    rank, world = sp.data_rank(), sp.data_size()
    buffer, label_buffer = [], []
    while True:
        for i in range(rank, len(image_arr), world):
            buffer.append(image_arr[i])
            if label_arr is not None:
                label_buffer.append(label_arr[i])
            if len(buffer) == batch_size:
                batch = np.stack(buffer).astype(np.float32) / 127.5 - 1.0
                res = {"low_res": np.ascontiguousarray(batch.transpose(0, 3, 1, 2))}
                if label_arr is not None:
                    res["y"] = np.stack(label_buffer)
                yield res
                buffer, label_buffer = [], []


def make_chain(model, diffusion, args, calls=None):
    """The chain of one batch: ``run_chain(model_kwargs, rng, *, noise=None,
    step_noise=None)`` returns (B, 3, large_size, large_size) samples of
    ``resolve_sampler(..., honor_use_ddim=False)``'s loop; ``noise`` and
    ``step_noise`` replace the generator's draws, for tests; ``calls`` (a
    dict), when given, counts the UNet's forwards under "unet"."""
    loop = resolve_sampler(diffusion, args, honor_use_ddim=False)
    size = args.large_size

    def unet(x, t, **kw):
        if calls is not None:
            calls["unet"] = calls.get("unet", 0) + 1
        return model(x, t, **kw)

    def run_chain(model_kwargs, rng, *, noise=None, step_noise=None):
        shape = (len(model_kwargs["low_res"]), 3, size, size)
        kw = {} if step_noise is None else {"step_noise": step_noise}
        return loop(unet, shape, rng, clip_denoised=args.clip_denoised, model_kwargs=model_kwargs, noise=noise,
                    **kw)

    return run_chain


def main(argv=None) -> dict:
    """Run the CLI; returns {"path": the npz, "batch_seconds": each chain's
    time (CUDA events on the card), "batches", "steps": steps a chain,
    "calls": the UNet's forwards}."""
    args = parse_yaml(create_argparser().parse_args(argv))
    _refuse(args)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    if not args.model_path:
        raise SystemExit("--model_path: a reference-format .pt is required")
    with (pdist.process_group(args.device) as device, sp.from_flag(args.spatial_shard, args.batch_size),
          tp.from_flag(args.tensor_shard, args.batch_size)):
        return sample(args, device)


def sample(args, device: torch.device) -> dict:
    logger.configure(args=args)

    logger.log("creating model...")
    model, diffusion = sr_create_model_and_diffusion(
        **args_to_dict(args, sr_model_and_diffusion_defaults().keys()), conv_impl=args.conv_impl)
    model = upstream_super_res(model, args.class_cond)
    try:
        load_model_weights(model, args.model_path)
    except ValueError as e:  # a .flax checkpoint
        raise SystemExit(str(e)) from None
    model = model.to(device).eval().requires_grad_(False)
    calls = {"unet": 0}
    run_chain = make_chain(model, diffusion, args, calls)

    logger.log("loading data...")
    data = load_data_for_worker(args.base_samples, args.batch_size, args.class_cond)
    cuda = device.type == "cuda"
    rank, world = sp.data_rank(), sp.data_size()  # a data group's ranks draw alike under --spatial_shard
    n_batches = -(-args.num_samples // (args.batch_size * world))
    all_images, batch_seconds = [], []
    logger.log("creating samples...")

    def dispatched():
        for counter in range(n_batches):
            model_kwargs = {k: to_device(v, device) for k, v in next(data).items()}
            rng = torch.Generator(device=device).manual_seed(sample_seed(args.seed, counter * world + rank))
            if cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            else:
                t0 = time.perf_counter()
            with torch.inference_mode():
                sample = sp.gather_rows(run_chain(model_kwargs, rng)).permute(0, 2, 3, 1).contiguous()
            if cuda:
                end.record()
                timing = (start, end)
            else:
                timing = time.perf_counter() - t0
            yield to_host(sample), timing

    def gather_batch(item):
        (host, event), timing = item
        if event is not None:
            event.synchronize()
            timing = timing[0].elapsed_time(timing[1]) / 1e3
        batch_seconds.append(timing)
        # data-rank order
        all_images.extend(sp.gather_data_groups(((host.float().numpy() + 1) * 127.5).clip(0, 255).astype(np.uint8)))
        logger.log(f"created {len(all_images) * args.batch_size} samples ({timing:.3f} s for the batch)")

    overlap_device_host(dispatched(), gather_batch)

    arr = np.concatenate(all_images, axis=0)[: args.num_samples]
    shape_str = "x".join(str(x) for x in arr.shape)
    out_path = os.path.join(logger.get_dir(), f"samples_{shape_str}.npz")
    if pdist.rank() == 0:
        logger.log(f"saving to {out_path}")
        np.savez(out_path, arr)
    pdist.barrier("sr_sampling")
    logger.log("sampling complete")
    return {"path": out_path, "batch_seconds": batch_seconds, "batches": n_batches,
            "steps": diffusion.num_timesteps, "calls": calls}


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(
        clip_denoised=True,
        num_samples=10000,
        batch_size=16,
        use_ddim=False,  # accepted for the flags' parity; the reference ignores it here
        sampler="",  # "" (ancestral, as the reference), ddim or dpm++2m
        base_samples="",
        model_path="",
        main_path="",
        seed=0,
        device="cuda",
        conv_impl="auto",  # auto or xla: cuDNN; int8: kernels K4 and K5
        spatial_shard=0,  # S > 1: each image's rows over S ranks (torchrun, a multiple of S ranks)
        tensor_shard=0,  # T > 1: each activation's channels over T ranks (torchrun, a multiple of T ranks)
    )
    defaults.update(sr_model_and_diffusion_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


if __name__ == "__main__":
    main()
