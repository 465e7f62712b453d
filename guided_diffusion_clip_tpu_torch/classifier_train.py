"""Train a noised image classifier: the port of scripts/classifier_train.py.

    python -m guided_diffusion_clip_tpu_torch.classifier_train \\
        --data_dir <folder of {class}_*.png> --val_data_dir <folder> \\
        --image_size 256 --classifier_width 128 --classifier_depth 2 \\
        --classifier_attention_resolutions 32,16,8 --classifier_pool attention \\
        --classifier_use_fp16 True --batch_size 32 --microbatch 16 \\
        --noised True --anneal_lr True --iterations 150000

The flags are scripts/classifier_train.py's, plus ``--device`` (default
``cuda``; a missing card is an error). The model is the ``EncoderUNetModel``
classifier of ``create_classifier_and_diffusion``; the class of an image is
its file name up to the first ``_``. ``classifier_use_fp16`` keeps f32
parameters under a bf16 torso, as ``training/train_loop.py`` does for the
UNet.

A step (``ClassifierTrainer.step``, JAX ``train_step`` :161-213): timesteps
from the schedule sampler (``np.random.default_rng(rank)``, rank 0's as the
JAX script's; all zero without ``--noised``), the batch noised by
``q_sample`` (noise from the trainer's ``torch.Generator``, seeded with the
rank), cross-entropy, and
microbatches whose gradients are scaled by ``micro / B`` and summed; then
one ``torch.optim.AdamW`` (fused on the card; b1 0.9, b2 0.999, eps 1e-8,
decay ``weight_decay`` times the rate, as ``optax.adamw``) at the rate
``lr * max(0, 1 - count / iterations)`` under ``--anneal_lr``, ``count`` the
updates made before. Dropout draws from torch's default generator, seeded
with the rank. Each step's ``loss``, ``acc@1`` and ``acc@5`` (over every
rank's rows) are read back one step late
(pinned memory behind an event), with ``step`` and ``samples``; every
``--eval_interval`` steps the classifier's logits at t = 0 on a
``--val_data_dir`` batch give ``val_loss``, ``val_acc@1`` and ``val_acc@5``.

Checkpoints go to ``get_blob_logdir()`` every ``--save_interval`` steps and
at the end: ``model{step:06d}.pt`` (the classifier's reference-format
state_dict, which ``classifier_sample --classifier_path`` loads) and
``opt{step:06d}.pt`` (the AdamW state_dict). ``--resume_checkpoint`` loads
the parameters only, and the loop starts at the step in its name, as the JAX
script does; a ``.flax`` file is refused with the conversion's recipe.
``DIFFUSION_TRAINING_TEST=1`` stops after the first save.

Under torchrun (JAX :63, :143-153, :270-305) each rank reads its shard of the
folders and ``--batch_size`` is each rank's: the model runs under DDP (the
gradient the mean over the ranks, the first microbatches under
``no_sync()``), or FSDP2 under ``--param_sharding fsdp`` (which needs
torchrun, at one process too; ``parallel/mesh.py``); rank 0 writes the
checkpoints, full values under the same names in both modes, and the run ends
with ``barrier("classifier_train")``. ``--spatial_shard`` and
``--tensor_shard`` are not yet ported and are refused.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from .data.image_datasets import load_data
from .diffusion.gaussian import q_sample
from .parallel import dist as pdist
from .parallel import mesh as pmesh
from .training.resample import create_named_schedule_sampler
from .training.train_loop import get_blob_logdir
from .utils import bf_io
from .utils import checkpoint as ckpt
from .utils import logger
from .utils.sample_util import to_device, to_host
from .utils.script_util import (
    add_dict_to_argparser,
    args_to_dict,
    classifier_and_diffusion_defaults,
    create_classifier_and_diffusion,
    parse_yaml,
)


def compute_top_k(logits, labels, k: int) -> float:
    """The share of rows whose label is among the k largest logits (classifier_train.py:185-191)."""
    top = np.argsort(np.asarray(logits), axis=-1)[:, -k:]
    return float((top == np.asarray(labels)[:, None]).any(axis=-1).mean())


def _refuse(args) -> None:
    if args.param_sharding not in ("replicated", "fsdp"):
        raise SystemExit(f"--param_sharding {args.param_sharding!r}: choose from replicated, fsdp")
    if args.param_sharding == "fsdp" and not pdist.under_torchrun():
        raise SystemExit("--param_sharding fsdp: launch under torchrun (python -m torch.distributed.run "
                         "--nproc_per_node N -m ...); FSDP2 needs a process group")
    for flag, unported in (
        (f"spatial_shard {args.spatial_shard}", int(args.spatial_shard) > 1),
        (f"tensor_shard {args.tensor_shard}", int(args.tensor_shard) > 1),
    ):
        if unported:
            raise SystemExit(f"--{flag}: not yet ported to the PyTorch package")


class ClassifierTrainer:
    """The classifier, its AdamW and the step of scripts/classifier_train.py;
    under a process group wrapped in DDP, or FSDP2 with ``fsdp``."""

    def __init__(self, model, diffusion, *, batch_size: int, microbatch: int = -1, lr: float = 3e-4,
                 weight_decay: float = 0.0, anneal_lr: bool = False, iterations: int = 1, noised: bool = True,
                 schedule_sampler=None, seed: int = 0, fsdp: bool = False):
        if fsdp and not pdist.is_initialized():
            raise ValueError("fsdp needs a process group: launch under torchrun")
        self.rank, self.fsdp = pdist.rank(), fsdp
        self.model = model.float().train()
        self.device = next(model.parameters()).device
        self.sched = diffusion.sched.to(self.device)
        self.batch_size = batch_size
        self.microbatch = microbatch if microbatch > 0 else batch_size
        if batch_size % self.microbatch:
            raise ValueError(f"batch_size {batch_size} is not a multiple of microbatch {self.microbatch}")
        self.lr, self.anneal_lr, self.iterations, self.noised = lr, anneal_lr, iterations, noised
        self.schedule_sampler = schedule_sampler or create_named_schedule_sampler("uniform", diffusion.num_timesteps)
        self.np_rng = np.random.default_rng(seed + self.rank)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + self.rank)
        torch.manual_seed(seed + self.rank)  # the model's dropout
        self.ddp = None
        if fsdp:
            pmesh.shard_model(self.model, pmesh.data_mesh(self.device))
        elif pdist.is_initialized():
            from torch.nn.parallel import DistributedDataParallel

            self.ddp = DistributedDataParallel(
                self.model, device_ids=[self.device] if self.device.type == "cuda" else None)
        opt_kw = {"fused": True} if self.device.type == "cuda" else {"foreach": True}
        self.opt = torch.optim.AdamW(self.model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=weight_decay, **opt_kw)
        self.opt_count = 0  # updates made: the schedule's count

    def _upload(self, a, dtype) -> torch.Tensor:
        return to_device(a, self.device).to(dtype)

    def sample_t(self) -> np.ndarray:
        if self.noised:
            return self.schedule_sampler.sample(self.batch_size, self.np_rng)[0]
        return np.zeros((self.batch_size,), np.int64)

    def losses(self, x, y, t, noise=None):
        """One microbatch's forward: (per-row cross-entropy, logits), x noised
        to t first when ``noised`` (by ``noise``, else the generator's)."""
        if self.noised:
            if noise is None:
                noise = torch.randn(x.shape, generator=self.generator, device=self.device)
            x = q_sample(self.sched, x, t, noise)
        logits = (self.ddp or self.model)(x, t)
        return F.cross_entropy(logits.float(), y.long(), reduction="none"), logits

    def step(self, batch, labels, t=None, noise=None):
        """One update on a batch (B, 3, H, W) in [-1, 1] and its labels; ``t``
        (else ``sample_t()``) and ``noise`` (the batch's shape, else the
        generator's draws) may be given, for tests. Returns the rows'
        cross-entropy and logits, on the device."""
        x = self._upload(batch, torch.float32)
        y = self._upload(labels, torch.long)
        t = self._upload(self.sample_t() if t is None else t, torch.long)
        noise = None if noise is None else self._upload(noise, torch.float32)
        self.opt.zero_grad(set_to_none=True)
        ces, logits = [], []
        B, m = self.batch_size, self.microbatch
        for i in range(B // m):
            rows = slice(i * m, (i + 1) * m)
            with self._grad_sync(i == B // m - 1):
                ce, lg = self.losses(x[rows], y[rows], t[rows], None if noise is None else noise[rows])
                # microbatch scaling m / B (classifier_train.py:136): the summed
                # gradients are the full batch's mean
                (ce.mean() * (m / B)).backward()
            ces.append(ce.detach())
            logits.append(lg.detach())
        self.update()
        return torch.cat(ces), torch.cat(logits)

    def _grad_sync(self, last: bool):
        """Only the last microbatch reduces the gradients over the ranks."""
        if self.fsdp:
            self.model.set_requires_gradient_sync(last)
        elif self.ddp is not None and not last:
            return self.ddp.no_sync()
        return contextlib.nullcontext()

    def update(self) -> None:
        for p in self.model.parameters():  # a parameter no loss reached still decays, as under optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        frac = max(0.0, 1.0 - self.opt_count / self.iterations) if self.anneal_lr else 1.0
        for group in self.opt.param_groups:
            group["lr"] = self.lr * frac
        self.opt.step()
        self.opt_count += 1

    @torch.no_grad()
    def eval_logits(self, batch) -> torch.Tensor:
        """Logits at t = 0, in eval mode (no dropout)."""
        x = self._upload(batch, torch.float32)
        self.model.eval()
        try:
            return self.model(x, torch.zeros((x.shape[0],), dtype=torch.long, device=self.device)).float()
        finally:
            self.model.train()

    def save(self, step: int) -> None:
        """Every rank takes part (FSDP2 gathers the full values); rank 0 writes."""
        def full(v):
            return v.full_tensor() if pmesh.is_dtensor(v) else v

        model = {k: full(v) for k, v in self.model.state_dict().items()}
        opt = self.opt.state_dict()
        opt["state"] = {i: {k: full(v) for k, v in st.items()} for i, st in opt["state"].items()}
        if self.rank == 0:
            out = get_blob_logdir()
            ckpt.save_state_dict(bf_io.join(out, ckpt.checkpoint_name("model", step)), model)
            ckpt.save_state_dict(bf_io.join(out, ckpt.checkpoint_name("opt", step)), opt)


def main(argv=None) -> dict:
    """Run the CLI; returns {"steps": steps taken, "evals": validation
    batches, "resume_step", "step_ms": each step's time (CUDA events around
    the update on the card, else wall time), "dir": the run directory}."""
    args = parse_yaml(create_argparser().parse_args(argv))
    _refuse(args)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    with pdist.process_group(args.device) as device:
        return train(args, device)


def train(args, device: torch.device) -> dict:
    logger.configure(args=args)

    logger.log("creating model and diffusion...")
    model, diffusion = create_classifier_and_diffusion(
        **args_to_dict(args, classifier_and_diffusion_defaults().keys()))
    resume_step = 0
    if args.resume_checkpoint:
        resume_step = ckpt.parse_resume_step_from_filename(args.resume_checkpoint)
        logger.log(f"loading model from checkpoint: {args.resume_checkpoint}... ({resume_step})")
        try:
            ckpt.load_model_weights(model, args.resume_checkpoint)
        except ValueError as e:  # a .flax checkpoint
            raise SystemExit(str(e)) from None
    model.to(device)
    trainer = ClassifierTrainer(
        model, diffusion, batch_size=args.batch_size, microbatch=args.microbatch, lr=args.lr,
        weight_decay=args.weight_decay, anneal_lr=args.anneal_lr, iterations=args.iterations,
        noised=args.noised,
        schedule_sampler=create_named_schedule_sampler(args.schedule_sampler, diffusion.num_timesteps),
        fsdp=args.param_sharding == "fsdp",
    )

    logger.log("creating data loader...")
    data = load_data(data_dir=args.data_dir, batch_size=args.batch_size, image_size=args.image_size,
                     class_cond=True, class_cond_from_filenames=True, random_crop=True)
    val_data = (
        load_data(data_dir=args.val_data_dir, batch_size=args.batch_size, image_size=args.image_size,
                  class_cond=True, class_cond_from_filenames=True)
        if args.val_data_dir else None
    )

    logger.log(f"training classifier for {args.iterations} iterations...")
    cuda = device.type == "cuda"
    pending = None  # step k's (labels, host copies, event), logged after step k + 1 is queued
    step_ms, timings, evals = [], [], 0

    def flush_pending():
        nonlocal pending
        if pending is None:
            return
        labels_p, (ces, ev_ces), (logits, ev_logits) = pending
        pending = None
        for event in (ev_ces, ev_logits):
            if event is not None:
                event.synchronize()
        # every rank's rows
        ces, logits_np, labels_p = (pdist.all_gather_host(a) for a in (ces.numpy(), logits.float().numpy(), labels_p))
        logits_np, labels_p = logits_np.reshape(-1, logits_np.shape[-1]), labels_p.reshape(-1)
        logger.logkv_mean("loss", float(ces.mean()))
        logger.logkv_mean("acc@1", compute_top_k(logits_np, labels_p, 1))
        logger.logkv_mean("acc@5", compute_top_k(logits_np, labels_p, 5))

    steps = 0
    for step in range(args.iterations - resume_step):
        cur = step + resume_step
        logger.logkv("step", cur)
        logger.logkv("samples", (cur + 1) * args.batch_size * pdist.world_size())
        batch, cond = next(data)
        labels = cond["y"]
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        ces, logits = trainer.step(batch, labels)
        if cuda:
            end.record()
            timings.append((start, end))
        else:
            step_ms.append(1000 * (time.perf_counter() - t0))
        steps += 1
        flush_pending()
        pending = (labels, to_host(ces), to_host(logits))

        if val_data is not None and not cur % args.eval_interval:
            vb, vcond = next(val_data)
            vlogits = pdist.all_gather_host(trainer.eval_logits(vb).cpu().numpy())
            vlogits, vy = vlogits.reshape(-1, vlogits.shape[-1]), pdist.all_gather_host(vcond["y"]).reshape(-1)
            vce = F.cross_entropy(torch.from_numpy(vlogits), torch.as_tensor(vy).long(), reduction="none")
            logger.logkv_mean("val_loss", float(vce.mean()))
            logger.logkv_mean("val_acc@1", compute_top_k(vlogits, vy, 1))
            logger.logkv_mean("val_acc@5", compute_top_k(vlogits, vy, 5))
            evals += 1

        if not cur % args.log_interval:
            flush_pending()  # include this step in the dump
            logger.dumpkvs()
        if cur and not (cur + 1) % args.save_interval:
            logger.log("saving model...")
            trainer.save(cur)
            if os.environ.get("DIFFUSION_TRAINING_TEST", ""):
                break

    flush_pending()
    logger.log("saving final model...")
    trainer.save(args.iterations - 1)
    pdist.barrier("classifier_train")
    step_ms += [s.elapsed_time(e) for s, e in timings]  # the save synchronized the card
    return {"steps": steps, "evals": evals, "resume_step": resume_step, "step_ms": step_ms,
            "dir": logger.get_dir()}


def create_argparser():
    defaults = dict(
        data_dir="",
        val_data_dir="",
        main_path="",
        noised=True,
        iterations=150000,
        lr=3e-4,
        weight_decay=0.0,
        anneal_lr=False,
        batch_size=4,
        microbatch=-1,
        schedule_sampler="uniform",
        resume_checkpoint="",
        log_interval=10,
        eval_interval=5,
        save_interval=10000,
        param_sharding="replicated",  # "fsdp": FSDP2 (under torchrun)
        spatial_shard=0,  # > 1: not yet ported
        tensor_shard=0,  # > 1: not yet ported
        device="cuda",
    )
    defaults.update(classifier_and_diffusion_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    return parser


if __name__ == "__main__":
    main()
