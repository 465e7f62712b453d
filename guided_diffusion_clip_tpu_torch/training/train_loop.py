"""Training loop on one GPU: AdamW, EMA, microbatches and checkpoints.

Counterpart of ``guided_diffusion_clip_tpu/training/train_loop.py`` (reference
guided_diffusion/train_util.py, TrainLoop :24) for one process. What the step
keeps of the JAX one (``:615-787``):

  - f32 parameters with the model's bf16 torso: the loop calls
    ``model.float()``, and the torso's convs cast their weights to bf16 at each
    call (``models/unet.py``), as flax's ``dtype=bf16`` with f32 params; no
    second copy of the weights is kept;
  - AdamW as ``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8 outside the square
    root, decay ``weight_decay`` times the rate): one ``torch.optim.AdamW``,
    fused on the card and ``foreach`` on the CPU, for both ``opt_impl`` values
    (in the JAX loop ``tree`` and ``flat`` are two layouts of the same
    arithmetic); the rate of update k is
    ``lr * max(0, 1 - k / lr_anneal_steps)``, k the count before the update;
  - microbatches: each contributes the gradient of mean(loss * weights) over
    its rows, and the contributions are summed (train_util.py:193-225);
  - ``grad_norm``: the global L2 norm of the summed gradients (no clipping);
    ``param_norm``: that of the parameters before the update;
  - one EMA a rate, ``e <- e + (1 - rate)(p - e)`` on the updated parameters;
  - ``loss_weighting min_snr_G`` and ``cond_dropout`` as in the JAX loop;
  - metrics read back one step late: step k's are copied to pinned host memory
    behind an event and logged after step k + 1 is launched, so nothing in a
    step waits for the card (``LossSecondMomentResampler`` needs each step's
    losses before the next draw and stays synchronous, as in the JAX loop).

Randomness: the timesteps come from ``np.random.default_rng(seed)`` (rank 0),
so they equal the JAX loop's; the noise and the conditioning-dropout masks
from the loop's ``torch.Generator`` on the model's device, seeded from
``seed``; the model's dropout from torch's default generator, seeded from
``seed`` too (``nn.Dropout`` takes no generator, and ``torch.utils.checkpoint``
replays the default generator's state when it recomputes a block).
``run_step(noise=...)`` takes the noise of the whole batch instead, for tests.

Checkpoints: ``model{step:06d}.pt`` and ``ema_{rate}_{step:06d}.pt`` are
state_dicts under the reference's keys; ``opt{step:06d}.pt`` holds the Adam
count and moments by parameter name. Unlike the JAX loop, the constructor takes
no batch from ``data``: the model arrives with its parameters.

``profile_dir``: a ``torch.profiler`` trace of steps 1 to ``PROFILE_STEPS``
(``utils/profiling.py``), with the ``data``, ``train_step`` and
``val_sample`` scopes named in it, as the JAX loop traces them.

The int8 forward (``--train_conv_impl int8``) is the model's: build it with
``conv_impl="int8"``. Its convs then quantize the f32 parameters at each
call (``Conv2d.quantized_weight`` recomputes ``w_q`` when the weight's
version changes, which ``update`` bumps after AdamW's step), the quantizing
GroupNorms emit integer-valued floats under autograd, and the backwards are
straight-through convs on cuDNN; the EMA copies and ``val_sample`` run the
same convs under ``no_grad``, which emits real s8.

Not yet ported, and refused by ``check_ported``: ``param_sharding !=
"replicated"``, ``opt_impl zero1``, ``spatial_shard``, ``tensor_shard`` and
``ckpt_backend orbax``. The constructor takes these options only to refuse
them; ``image_train`` refuses its flags with the same function before it
makes the run directory, and passes none of them on.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Iterator, Optional

import numpy as np
import torch

from ..diffusion.api import Diffusion
from ..training.resample import LossAwareSampler, ScheduleSampler, UniformSampler
from ..utils import checkpoint as ckpt
from ..utils import logger
from ..utils.profiling import StepProfiler, annotate
from ..utils.saving_imgs import save_img, tensor2img


def check_ported(*, param_sharding="replicated", opt_impl="tree", spatial_shard=0, tensor_shard=0,
                 ckpt_backend="flax") -> None:
    """Raise NotImplementedError for the JAX loop's options this loop lacks,
    ValueError for values the JAX loop does not know either."""
    if param_sharding not in ("replicated", "fsdp"):
        raise ValueError(f"param_sharding {param_sharding!r}")
    if opt_impl not in ("tree", "flat", "zero1"):
        raise ValueError(f"opt_impl {opt_impl!r}")
    if ckpt_backend not in ("flax", "orbax"):
        raise ValueError(f"ckpt_backend {ckpt_backend!r}")
    for flag, unported in (
        (f"param_sharding {param_sharding}", param_sharding != "replicated"),
        ("opt_impl zero1", opt_impl == "zero1"),
        (f"spatial_shard {spatial_shard}", int(spatial_shard) > 1),
        (f"tensor_shard {tensor_shard}", int(tensor_shard) > 1),
        ("ckpt_backend orbax", ckpt_backend == "orbax"),
    ):
        if unported:
            raise NotImplementedError(f"--{flag}: not yet ported to the PyTorch package")


def drop_conditioning(generator: torch.Generator, cond: dict, p: float, null_y: int = -1) -> dict:
    """Per-example conditioning dropout for classifier-free guidance training
    (JAX ``drop_conditioning``): with probability ``p`` an example's
    ``clip_feat`` row is zeroed and its ``y`` set to ``null_y``; other keys
    (low_res, img2, ...) pass through. One mask a batch, from ``generator``."""
    if not p:
        return cond
    keys = [k for k in ("clip_feat", "y") if cond.get(k) is not None]
    if not keys:
        return cond
    some = cond[keys[0]]
    mask = torch.rand(some.shape[0], generator=generator, device=generator.device) < p
    out = dict(cond)
    if "clip_feat" in keys:
        v = cond["clip_feat"]
        out["clip_feat"] = torch.where(mask.reshape((-1,) + (1,) * (v.dim() - 1)), torch.zeros_like(v), v)
    if "y" in keys:
        if null_y < 0:
            raise ValueError("cond_dropout on a class-labelled model needs a reserved null class index "
                             "(TrainLoop cond_null_y / image_train --cfg_null_y)")
        v = cond["y"]
        out["y"] = torch.where(mask, torch.full_like(v, null_y), v)
    return out


PROFILE_STEPS = 3  # steps traced under profile_dir, the JAX loop's default profile_steps

_METRIC_KEYS = ("loss", "grad_norm", "param_norm", "loss_vec", "mse_vec", "vb_vec")


def _global_norm(tensors) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class TrainLoop:
    def __init__(
        self,
        *,
        model: torch.nn.Module,
        diffusion: Diffusion,
        data: Iterator,
        batch_size: int,
        microbatch: int,
        lr: float,
        ema_rate,
        log_interval: int,
        save_interval: int,
        resume_checkpoint: str = "",
        schedule_sampler: Optional[ScheduleSampler] = None,
        weight_decay: float = 0.0,
        lr_anneal_steps: int = 0,
        val_datasets=None,
        val_batch_size: int = 8,
        use_ddim_for_val: bool = False,
        seed: int = 0,
        profile_dir: str = "",
        param_sharding: str = "replicated",
        opt_impl: str = "tree",
        ckpt_backend: str = "flax",
        loss_weighting: str = "",
        spatial_shard: int = 0,
        tensor_shard: int = 0,
        cond_dropout: float = 0.0,
        cond_null_y: int = -1,
    ):
        check_ported(param_sharding=param_sharding, opt_impl=opt_impl, spatial_shard=spatial_shard,
                     tensor_shard=tensor_shard, ckpt_backend=ckpt_backend)
        self.model = model.float().train()
        self.device = next(model.parameters()).device
        # the schedule's tables on the model's device once, not at every step
        self.diffusion = dataclasses.replace(diffusion, sched=diffusion.sched.to(self.device))
        self.data = data
        self.batch_size = batch_size
        self.microbatch = microbatch if microbatch > 0 else batch_size
        if batch_size % self.microbatch:
            raise ValueError(f"batch_size {batch_size} is not a multiple of microbatch {self.microbatch}")
        self.n_micro = batch_size // self.microbatch
        self.lr = lr
        self.ema_rate = (
            [ema_rate] if isinstance(ema_rate, float) else [float(x) for x in str(ema_rate).split(",")]
        )
        self.log_interval = log_interval
        self.save_interval = save_interval
        self.resume_checkpoint = resume_checkpoint
        self.schedule_sampler = schedule_sampler or UniformSampler(diffusion.num_timesteps)
        self.weight_decay = weight_decay
        self.lr_anneal_steps = lr_anneal_steps
        self.val_datasets = val_datasets
        self.val_batch_size = val_batch_size
        self.use_ddim_for_val = use_ddim_for_val
        self.profile_dir = profile_dir
        self.step = 0
        self.resume_step = 0
        self.global_batch = batch_size

        self._loss_weight_table = None
        if loss_weighting:
            if not loss_weighting.startswith("min_snr_"):
                raise ValueError(f"unknown loss_weighting: {loss_weighting!r}")
            gamma = float(loss_weighting[len("min_snr_"):])
            ab = self.diffusion.sched.alphas_cumprod.double().cpu().numpy()
            snr = ab / (1.0 - ab)
            self._loss_weight_table = (np.minimum(snr, gamma) / snr).astype(np.float32)
        self.cond_dropout = float(cond_dropout)
        self.cond_null_y = int(cond_null_y)
        if self.cond_dropout and self.cond_null_y >= 0:
            # an index outside the class table would not name a null class
            mcfg = getattr(model, "config", None)
            if (mcfg is not None and getattr(mcfg, "label_emb_type", "") == "embedding"
                    and mcfg.num_classes is not None and self.cond_null_y >= mcfg.num_classes):
                raise ValueError(
                    f"cfg_null_y {self.cond_null_y} is outside the Embed table (num_classes="
                    f"{mcfg.num_classes}); train with num_classes+1 rows to reserve a null class"
                )
        self.np_rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        torch.manual_seed(seed)  # the model's dropout

        self.names, self.params = zip(*self.model.named_parameters())
        opt_kw = {"fused": True} if self.device.type == "cuda" else {"foreach": True}
        self.opt = torch.optim.AdamW(
            self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay, **opt_kw
        )
        self.opt_count = 0  # updates made: the schedule's count
        self.ema_params = [[p.detach().clone() for p in self.params] for _ in self.ema_rate]
        self._pending_log = None
        self._maybe_resume()

    # ------------------------------------------------------------ resume
    def _maybe_resume(self):
        resume = self.resume_checkpoint or find_resume_checkpoint()
        if not resume:
            return
        self.resume_step = ckpt.parse_resume_step_from_filename(resume)
        logger.log(f"loading model from checkpoint: {resume}... (step {self.resume_step})")
        self.model.load_state_dict(ckpt.load_state_dict(resume), strict=True)
        for i, rate in enumerate(self.ema_rate):
            path = ckpt.find_ema_checkpoint(resume, self.resume_step, rate)
            if path:
                logger.log(f"loading EMA from checkpoint: {path}...")
                sd = ckpt.load_state_dict(path)
                self.ema_params[i] = [sd[n].to(p) for n, p in zip(self.names, self.params)]
            else:
                self.ema_params[i] = [p.detach().clone() for p in self.params]
        opt_path = os.path.join(os.path.dirname(resume), ckpt.checkpoint_name("opt", self.resume_step))
        if os.path.exists(opt_path):
            logger.log(f"loading optimizer state from checkpoint: {opt_path}")
            self._load_opt(torch.load(opt_path, map_location="cpu", weights_only=True))

    def _opt_state_for_save(self) -> dict:
        """{"count", "m", "v"}: the Adam count and moments by parameter name."""
        state = [self.opt.state.get(p, {}) for p in self.params]
        return {
            "count": self.opt_count,
            "m": {n: s.get("exp_avg", torch.zeros_like(p)) for n, p, s in zip(self.names, self.params, state)},
            "v": {n: s.get("exp_avg_sq", torch.zeros_like(p)) for n, p, s in zip(self.names, self.params, state)},
        }

    def _load_opt(self, saved: dict):
        count = int(saved["count"])
        sd = self.opt.state_dict()
        # torch places each value as this optimizer keeps it (the fused one's step on the card)
        sd["state"] = {
            i: {"step": torch.tensor(float(count)), "exp_avg": saved["m"][n], "exp_avg_sq": saved["v"][n]}
            for i, n in enumerate(self.names)
        }
        self.opt.load_state_dict(sd)
        self.opt_count = count

    # ------------------------------------------------------------ the step
    def _upload(self, a) -> torch.Tensor:
        """A host array or tensor on the model's device, copied without
        waiting for the card (pinned memory) when it goes there."""
        t = torch.as_tensor(a)
        if t.device.type == "cpu" and self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def micro_loss(self, x, cond, t, weights, noise=None):
        """One microbatch's forward: (mean(loss * weights), terms)."""
        if self.cond_dropout:
            cond = drop_conditioning(self.generator, cond, self.cond_dropout, self.cond_null_y)
        if noise is None:
            noise = torch.randn(x.shape, generator=self.generator, device=self.device)
        terms = self.diffusion.training_losses(self.model, x, t, noise, model_kwargs=cond)
        return (terms["loss"] * weights).mean(), terms

    def update(self) -> tuple:
        """AdamW and the EMAs on the summed gradients; returns (grad_norm,
        param_norm), the latter of the parameters before the update."""
        for p in self.params:  # a parameter no loss reached still decays, as under optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            grad_norm = _global_norm([p.grad for p in self.params])
            param_norm = _global_norm(self.params)
        frac = max(0.0, 1.0 - self.opt_count / self.lr_anneal_steps) if self.lr_anneal_steps else 1.0
        for group in self.opt.param_groups:
            group["lr"] = self.lr * frac
        self.opt.step()
        if self.model.int8:
            # the fused AdamW writes the parameters without bumping their version
            # counters, on which the int8 convs' cached weight quantization is keyed
            torch.autograd.graph.increment_version(self.params)
        self.opt_count += 1
        with torch.no_grad():
            for ema, rate in zip(self.ema_params, self.ema_rate):
                torch._foreach_lerp_(ema, self.params, 1.0 - rate)
        return grad_norm, param_norm

    def _train_step(self, batch, cond, t, weights, noise=None) -> dict:
        self.opt.zero_grad(set_to_none=True)
        losses, vecs = [], {"loss": [], "mse": [], "vb": []}
        for i in range(self.n_micro):
            rows = slice(i * self.microbatch, (i + 1) * self.microbatch)
            loss, terms = self.micro_loss(
                batch[rows], {k: v[rows] for k, v in cond.items()}, t[rows], weights[rows],
                None if noise is None else noise[rows],
            )
            loss.backward()
            losses.append(loss.detach())
            vecs["loss"].append(terms["loss"].detach())
            vecs["mse"].append(terms.get("mse", terms["loss"]).detach())
            vecs["vb"].append(terms["vb"].detach() if "vb" in terms else torch.zeros_like(vecs["loss"][-1]))
        grad_norm, param_norm = self.update()
        return dict(
            loss=torch.stack(losses).mean(), grad_norm=grad_norm, param_norm=param_norm,
            **{f"{k}_vec": torch.cat(v) for k, v in vecs.items()},
        )

    # ------------------------------------------------------------ main loop
    def run_loop(self):
        prof = StepProfiler(self.profile_dir, num_steps=PROFILE_STEPS)
        try:
            while not self.lr_anneal_steps or self.step + self.resume_step < self.lr_anneal_steps:
                prof.maybe_start(self.step)
                with prof.step_scope(self.step):
                    with logger.profile_kv("data"), annotate("data"):
                        batch, cond = next(self.data)
                    with logger.profile_kv("step"), annotate("train_step"):
                        self.run_step(batch, cond)
                prof.maybe_stop(self.step)
                if self.step % self.log_interval == 0:
                    self.flush_metrics()  # include this step in the dump
                    logger.dumpkvs()
                if self.step % self.save_interval == 0 and self.step > 0:
                    self.flush_metrics()
                    with logger.profile_kv("val"), annotate("val_sample"):
                        self.save()
                        self.val_sample()
                    if os.environ.get("DIFFUSION_TRAINING_TEST", ""):
                        return
                self.step += 1
            self.flush_metrics()
            if (self.step - 1) % self.save_interval != 0:
                self.save()
        finally:
            prof.stop()

    def run_step(self, batch, cond, noise=None):
        """One update on a host batch (B, C, H, W) and its cond dict;
        ``noise`` (the batch's shape) replaces the generator's draws."""
        t_np, w_np = self.schedule_sampler.sample(self.batch_size, self.np_rng)
        if self._loss_weight_table is not None:
            w_np = (w_np * self._loss_weight_table[t_np]).astype(np.float32)
        metrics = self._train_step(
            self._upload(batch).float(), {k: self._upload(v) for k, v in cond.items()},
            self._upload(t_np).long(), self._upload(w_np),
            None if noise is None else self._upload(noise),
        )
        if isinstance(self.schedule_sampler, LossAwareSampler):
            # the sampler needs this step's losses before the next draw (train_util.py:190)
            self.flush_metrics()
            host = self._fetch(self._start_fetch(metrics))
            self.schedule_sampler.update_with_local_losses(t_np, host["loss_vec"])
            self._log_step_metrics(t_np, host)
        else:
            # step k - 1's metrics, copied while step k was queued
            self.flush_metrics()
            self._pending_log = (self.step + self.resume_step, t_np, self._start_fetch(metrics))

    def _start_fetch(self, metrics: dict):
        """Queue the copy of a step's metrics to the host: (host tensor, the
        event that marks the copy's end or None, the vector length)."""
        flat = torch.cat([metrics[k].reshape(-1).float() for k in _METRIC_KEYS])
        n = metrics["loss_vec"].numel()
        if flat.device.type != "cuda":
            return flat, None, n
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event, n

    @staticmethod
    def _fetch(pending) -> dict:
        host, event, n = pending
        if event is not None:
            event.synchronize()
        a = host.numpy()
        return {"loss": a[0], "grad_norm": a[1], "param_norm": a[2],
                "loss_vec": a[3:3 + n], "mse_vec": a[3 + n:3 + 2 * n], "vb_vec": a[3 + 2 * n:]}

    def flush_metrics(self):
        """Log the deferred previous step's metrics."""
        pending, self._pending_log = self._pending_log, None
        if pending is not None:
            step, t_np, fetch = pending
            self._log_step_metrics(t_np, self._fetch(fetch), step=step)

    def _log_step_metrics(self, t_np, metrics, step=None):
        step = self.step + self.resume_step if step is None else step
        logger.logkv("step", step)
        logger.logkv("samples", (step + 1) * self.global_batch)
        for k in ("loss", "grad_norm", "param_norm"):
            logger.logkv_mean(k, float(metrics[k]))
        T = self.diffusion.num_timesteps
        for name in ("loss", "mse", "vb"):  # per-quartile losses (train_util.py:381-387)
            for sub_t, sub_loss in zip(t_np, metrics[f"{name}_vec"]):
                logger.logkv_mean(f"{name}_q{int(4 * sub_t / T)}", float(sub_loss))

    def _anneal_frac(self):
        if not self.lr_anneal_steps:
            return 0.0
        return (self.step + self.resume_step) / self.lr_anneal_steps

    # ------------------------------------------------------------ save / val
    def save(self):
        step = self.step + self.resume_step
        out_dir = get_blob_logdir()
        logger.log(f"saving model at step {step}...")
        ckpt.save_state_dict(os.path.join(out_dir, ckpt.checkpoint_name("model", step)), self.model.state_dict())
        for rate, ema in zip(self.ema_rate, self.ema_params):
            ckpt.save_state_dict(os.path.join(out_dir, ckpt.checkpoint_name("ema", step, rate)),
                                 dict(zip(self.names, ema)))
        ckpt.save_state_dict(os.path.join(out_dir, ckpt.checkpoint_name("opt", step)), self._opt_state_for_save())

    def ema_model(self, i: int = 0) -> torch.nn.Module:
        """A copy of the model in eval mode with the i-th EMA's weights, its
        torso cast in place as a sampler loads a checkpoint."""
        model = copy.deepcopy(self.model).eval()
        with torch.no_grad():
            torch._foreach_copy_(list(model.parameters()), self.ema_params[i])
        if model.dtype != torch.float32:
            model.convert_torso(model.dtype)
        return model

    def val_sample(self, which: int | None = None, num_samples: int = 8):
        """Sample a small grid from each val dataset with the first EMA
        (train_util.py:269-341): ``val_samples_{i}_{step}.npz`` and ``.png``,
        and ``val_targets_{i}_{step}.png``, NHWC as the JAX loop writes them."""
        if not self.val_datasets:
            return
        datasets = self.val_datasets if which is None else [self.val_datasets[which]]
        loop = self.diffusion.ddim_sample_loop if self.use_ddim_for_val else self.diffusion.p_sample_loop
        step = self.step + self.resume_step
        out_dir = get_blob_logdir()
        model = self.ema_model(0)
        for di, ds in enumerate(datasets):
            try:
                batch, cond = next(ds)
            except StopIteration:
                continue
            n = min(num_samples, len(batch))
            x = self._upload(batch[:n]).float()
            cond = {k: self._upload(v[:n]) for k, v in cond.items()}
            with torch.no_grad():
                sample = loop(model, tuple(x.shape), self.generator, model_kwargs=cond)
            sample = sample.permute(0, 2, 3, 1).float().cpu().numpy()
            targets = x.permute(0, 2, 3, 1).cpu().numpy()
            np.savez(os.path.join(out_dir, f"val_samples_{di}_{step:06d}.npz"), sample)
            save_img(tensor2img(sample), os.path.join(out_dir, f"val_samples_{di}_{step:06d}.png"))
            save_img(tensor2img(targets), os.path.join(out_dir, f"val_targets_{di}_{step:06d}.png"))



def get_blob_logdir() -> str:
    """Where checkpoints and samples go (train_util.py:359-362)."""
    return os.environ.get("DIFFUSION_BLOB_LOGDIR", logger.get_dir())


def find_resume_checkpoint():
    """The newest ``model*.pt`` in the blob log dir when
    DIFFUSION_AUTO_RESUME=1, else None (the JAX loop's fix-forward of the
    reference's stub, train_util.py:365-368)."""
    if os.environ.get("DIFFUSION_AUTO_RESUME", "") != "1":
        return None
    out_dir = get_blob_logdir()
    if not out_dir or not os.path.isdir(out_dir):
        return None
    best_step, best = -1, None
    for name in os.listdir(out_dir):
        if name.startswith("model") and name.endswith(".pt"):
            step = ckpt.parse_resume_step_from_filename(name)
            if step > best_step:
                best_step, best = step, os.path.join(out_dir, name)
    return best


def log_loss_dict(diffusion: Diffusion, ts, losses: dict):
    """train_util.py:381-387 parity helper for scripts that log by hand."""
    for key, values in losses.items():
        values = np.asarray(values)
        logger.logkv_mean(key, float(values.mean()))
        for sub_t, sub_loss in zip(np.asarray(ts), values):
            logger.logkv_mean(f"{key}_q{int(4 * sub_t / diffusion.num_timesteps)}", float(sub_loss))
