"""Training loop: AdamW, EMA, microbatches and checkpoints, on one GPU or
more than one process.

Counterpart of ``guided_diffusion_clip_tpu/training/train_loop.py`` (reference
guided_diffusion/train_util.py, TrainLoop :24). What the step keeps of the
JAX one (``:615-787``):

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

More than one process (a process group started by ``parallel/dist.py``;
``batch_size`` is each rank's, the global batch ``batch_size * world``):

  - ``param_sharding replicated`` wraps the model in DDP whenever a group is
    up, at world 1 too: the gradient is the mean over the ranks, and the
    first microbatches run under ``no_sync()``, only the last one reduces
    (train_util.py:193-225);
  - ``param_sharding fsdp``: FSDP2 (``parallel/mesh.py``), the parameters,
    their Adam moments and the EMA copies sharded alike; ``opt_impl`` ``flat``
    or ``zero1`` with it raises ``ValueError``, as the JAX loop (:270-273);
  - ``opt_impl zero1``: DDP with ``ZeroRedundancyOptimizer`` around the same
    AdamW; each rank keeps the moments and the EMA of the parameters it owns,
    and the updated parameters are broadcast from their owners;
  - every checkpoint holds the full values under the same names in every
    mode, so a run resumes across ``tree``, ``flat``, ``zero1`` and ``fsdp``;
    the ``.pt`` files are written by rank 0, then a ``barrier("save")``;
  - ``val_sample`` runs on every rank on its shard of the val set; rank 0
    writes the gathered samples and targets (JAX :986-1041);
  - the logged metrics are the global batch's: each step's losses and
    timesteps are gathered over the ranks before they are read back.

``fsdp`` and ``zero1`` need a process group: at world 1, launch under
torchrun.

Randomness: the timesteps come from ``np.random.default_rng(seed + rank)``, so
rank 0's equal the JAX loop's (:319); the noise and the conditioning-dropout
masks from the loop's ``torch.Generator`` on the model's device, seeded
``seed + rank``; the model's dropout from torch's default generator, seeded
``seed + rank`` too (``nn.Dropout`` takes no generator, and
``torch.utils.checkpoint`` replays the default generator's state when it
recomputes a block). ``run_step(noise=..., t=...)`` takes the noise and the
timesteps of the whole batch instead, for tests.

Checkpoints (``ckpt_backend flax``): ``model{step:06d}.pt`` and
``ema_{rate}_{step:06d}.pt`` are state_dicts under the reference's keys;
``opt{step:06d}.pt`` holds the Adam count and moments by parameter name.
``ckpt_backend orbax`` writes ``torch.distributed.checkpoint`` (DCP)
directories instead, ``{run_dir}/orbax/{step}/`` holding ``model``,
``ema_{rate}`` and ``opt`` (JAX :908-930), each rank its own shards, with
``async_save``: the state is copied to host memory before the step goes on,
and each save waits for the one before, as the loop's end does. A resume
from a path named ``orbax`` takes its newest step (JAX :399); a JAX orbax
directory is refused with the conversion's recipe (``utils/checkpoint.py``).
Unlike the JAX loop, the constructor takes no batch from ``data``: the model
arrives with its parameters.

``profile_dir``: a ``torch.profiler`` trace of steps 1 to ``PROFILE_STEPS``
(``utils/profiling.py``), with the ``data``, ``train_step`` and
``val_sample`` scopes named in it, as the JAX loop traces them.

The int8 forward (``--train_conv_impl int8``) is the model's: build it with
``conv_impl="int8"``. Its convs then quantize the f32 parameters at each
call (``Conv2d.quantized_weight`` recomputes ``w_q`` when the weight's
version changes, which ``update`` bumps after AdamW's step and ZeRO's
broadcast; under FSDP2 it drops the cached ``w_q`` instead), the quantizing
GroupNorms emit integer-valued floats under autograd, and the backwards are
straight-through convs on cuDNN; the EMA copies and ``val_sample`` run the
same convs under ``no_grad``, which emits real s8.

Spatial partitioning (``spatial_shard`` S > 1, ``parallel/sp.py``): the
world of W ranks is D data groups of S space ranks. A data group's ranks
take the same host batch, timesteps and noise (the timesteps, the noise and
the dropout masks come from generators seeded ``seed + data_rank``, the
noise drawn at the batch's full size), and each runs the model on its rows
of every image: its loss is the mean over its rows, and DDP's (or FSDP2's,
or ZeRO-1's) mean over all W ranks is then the data-parallel gradient, the
collectives' adjoints summing what crossed the ranks. The logged losses are
the data groups' (each per-sample term the mean of its ranks' means), which
the loss-aware sampler takes too; ``global_batch`` is ``batch_size * D``.
``val_sample`` gathers each chain's rows before it writes.

Tensor parallelism (``tensor_shard`` T > 1, ``parallel/tp.py``): the world
is D data groups of T model ranks, which draw alike as SP's data groups do;
each rank holds its channels of every activation, and the model's output,
the loss and the logged metrics are the data group's on every rank. Each
rank backpropagates its copy of the loss, and the ranks' gradients sum to T
times its gradient, so DDP's (FSDP2's, ZeRO-1's) mean over all W ranks is
the data-parallel gradient. As in the JAX loop, a loop with ``tensor_shard``
T > 1 sets TP on groups of its own (stale SP or TP left on by a CLI is
cleared first), and a loop without it clears TP left on. Both
``tensor_shard`` and ``spatial_shard`` above 1 are refused, as there.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..diffusion.api import Diffusion
from ..models.nn import Conv2d
from ..parallel import dist as pdist
from ..parallel import mesh as pmesh
from ..parallel import groups, sp, tp
from ..training.resample import LossAwareSampler, ScheduleSampler, UniformSampler
from ..utils import bf_io
from ..utils import checkpoint as ckpt
from ..utils import logger
from ..utils.profiling import StepProfiler, annotate
from ..utils.sample_util import to_device
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
    if opt_impl != "tree" and param_sharding == "fsdp":
        raise ValueError(f"opt_impl={opt_impl!r} does not compose with FSDP sharding")
    if int(spatial_shard or 0) > 1 and int(tensor_shard or 0) > 1:
        raise ValueError("spatial_shard and tensor_shard are mutually exclusive")
    for flag, k in (("spatial_shard", spatial_shard), ("tensor_shard", tensor_shard)):
        if int(k or 0) > 1 and not (pdist.is_initialized() or pdist.under_torchrun()):
            raise ValueError(f"{flag} {k} needs a process group: launch under torchrun "
                             f"(python -m torch.distributed.run --nproc_per_node {k} ...)")


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


def _global_norm(tensors, sharded: bool = False) -> torch.Tensor:
    """The L2 norm of all of ``tensors``; ``sharded``: of DTensors, each
    rank's shards summed over the ranks."""
    if not sharded:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))
    sq = torch.stack(torch._foreach_norm([pmesh.local_tensor(t) for t in tensors])).square().sum()
    torch.distributed.all_reduce(sq)
    return sq.sqrt()


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
        self.fsdp = param_sharding == "fsdp"
        self.zero1 = opt_impl == "zero1"
        if (self.fsdp or self.zero1) and not pdist.is_initialized():
            raise ValueError(f"param_sharding {param_sharding!r} / opt_impl {opt_impl!r} need a process group: "
                             "launch under torchrun (python -m torch.distributed.run --nproc_per_node N ...)")
        self.rank, self.world = pdist.rank(), pdist.world_size()
        if int(tensor_shard or 0) > 1:  # requested TP supersedes stale SP, and is pinned to this loop's groups
            sp.clear_spatial_sharding()
            tp.clear_tensor_sharding()
            tp.setup_from_flag(int(tensor_shard), batch_size)
        else:
            tp.clear_tensor_sharding()  # TP left on by a CLI in this process
            if int(spatial_shard) > 1 and sp.size() != int(spatial_shard):
                sp.setup_from_flag(int(spatial_shard), batch_size)
        # the ranks that share a data group's rows draw alike
        self.data_rank, self.data_world = groups.data_rank(), groups.data_size()
        self.ckpt_backend = ckpt_backend
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
        self.global_batch = batch_size * self.data_world

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
        self.np_rng = np.random.default_rng(seed + self.data_rank)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + self.data_rank)
        torch.manual_seed(seed + self.data_rank)  # the model's dropout

        self.ddp = None
        self._proto = None  # under FSDP2: the unsharded model on the meta device, for ema_model
        if self.fsdp:
            self._proto = _meta_copy(self.model)
            pmesh.shard_model(self.model, pmesh.data_mesh(self.device))
        elif pdist.is_initialized():
            from torch.nn.parallel import DistributedDataParallel

            self.ddp = DistributedDataParallel(
                self.model, device_ids=[self.device] if self.device.type == "cuda" else None)
        self._convs = [m for m in self.model.modules() if isinstance(m, Conv2d)]
        self.names, self.params = zip(*self.model.named_parameters())
        opt_kw = {"fused": True} if self.device.type == "cuda" else {"foreach": True}
        adamw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay, **opt_kw)
        if self.zero1:
            from torch.distributed.optim import ZeroRedundancyOptimizer

            self.opt = ZeroRedundancyOptimizer(self.params, optimizer_class=torch.optim.AdamW, **adamw)
            self._local_opt = self.opt.optim
        else:
            self.opt = torch.optim.AdamW(self.params, **adamw)
            self._local_opt = self.opt
        # the parameters this rank updates, in its optimizer's order: all of
        # them but under zero1; it keeps their moments and their EMA
        index = {id(p): i for i, p in enumerate(self.params)}
        self._owned = [index[id(p)] for g in self._local_opt.param_groups for p in g["params"]]
        self._owner = None
        if self.zero1:
            self._owner = [0] * len(self.params)
            for r, owned in enumerate(pdist.all_gather_object(self._owned)):
                for i in owned:
                    self._owner[i] = r
        self.opt_count = 0  # updates made: the schedule's count
        self.ema_params = [self._own_copy() for _ in self.ema_rate]
        self._pending_log = None
        self._dcp_group = None
        self._dcp_pending = None
        resume = self.resume_checkpoint or find_resume_checkpoint()
        if resume:
            self._resume(resume)

    # ------------------------------------------------------------ state by rank
    def _own_copy(self) -> list:
        """A copy of this rank's parameters (their local shards under FSDP2)."""
        return [pmesh.local_tensor(self.params[j]).detach().clone() for j in self._owned]

    def _full(self, local: list) -> list:
        """Full values, one a parameter, of ``local`` (one a parameter this
        rank owns, as ``_own_copy`` lays them out); a collective on every rank
        under FSDP2 and zero1."""
        if self.fsdp:
            return [pmesh.full_tensor(t, p) for t, p in zip(local, self.params)]
        if self.zero1:
            mine, out = dict(zip(self._owned, local)), []
            for i, p in enumerate(self.params):
                buf = mine[i] if i in mine else torch.empty_like(p)
                torch.distributed.broadcast(buf, src=self._owner[i])
                out.append(buf)
            return out
        return list(local)

    def _shard(self, full: list) -> list:
        """The inverse of ``_full``: this rank's part of ``full`` (one a parameter)."""
        return [pmesh.local_tensor(pmesh.distribute_like(full[j], self.params[j])) for j in self._owned]

    def _moments(self) -> tuple:
        """(m, v): this rank's Adam moments, zeros before the first update."""
        out = ([], [])
        for j in self._owned:
            state = self._local_opt.state.get(self.params[j], {})
            for lst, key in zip(out, ("exp_avg", "exp_avg_sq")):
                lst.append(pmesh.local_tensor(state[key]) if key in state
                           else torch.zeros_like(pmesh.local_tensor(self.params[j])))
        return out

    def _set_moments(self, m: list, v: list, count: int) -> None:
        sd = self._local_opt.state_dict()
        # torch places each value as this optimizer keeps it (the fused one's step on the card)
        sd["state"] = {
            k: {"step": torch.tensor(float(count)), "exp_avg": pmesh.as_dtensor(mk, self.params[j]),
                "exp_avg_sq": pmesh.as_dtensor(vk, self.params[j])}
            for k, (j, mk, vk) in enumerate(zip(self._owned, m, v))
        }
        self._local_opt.load_state_dict(sd)
        self.opt_count = count

    # ------------------------------------------------------------ resume
    def _resume(self, resume: str):
        if os.path.basename(str(resume).rstrip("/")) == "orbax":
            self._resume_dcp(resume)
            return
        self.resume_step = ckpt.parse_resume_step_from_filename(resume)
        logger.log(f"loading model from checkpoint: {resume}... (step {self.resume_step})")
        sd = ckpt.load_state_dict(resume)
        if self.fsdp:
            if set(sd) != set(self.names):
                raise KeyError(f"{resume}: keys differ from the model's: {sorted(set(sd) ^ set(self.names))[:8]}")
            with torch.no_grad():
                for n, p in zip(self.names, self.params):
                    pmesh.local_tensor(p).copy_(pmesh.local_tensor(pmesh.distribute_like(sd[n], p)))
        else:
            self.model.load_state_dict(sd, strict=True)
        for i, rate in enumerate(self.ema_rate):
            path = ckpt.find_ema_checkpoint(resume, self.resume_step, rate)
            if path:
                logger.log(f"loading EMA from checkpoint: {path}...")
                sd = ckpt.load_state_dict(path)
                self.ema_params[i] = self._shard([sd[n] for n in self.names])
            else:
                self.ema_params[i] = self._own_copy()
        opt_path = bf_io.join(os.path.dirname(resume), ckpt.checkpoint_name("opt", self.resume_step))
        if bf_io.exists(opt_path):
            logger.log(f"loading optimizer state from checkpoint: {opt_path}")
            self._load_opt(ckpt.load_state_dict(opt_path))

    def _resume_dcp(self, path: str):
        """The newest step of a DCP directory, every rank its own part."""
        import torch.distributed.checkpoint as dcp

        step, step_dir = ckpt.latest_dcp_step(path)
        logger.log(f"loading orbax (DCP) checkpoint {step_dir}... (step {step})")
        state = self._dcp_state()
        dcp.load(state, checkpoint_id=step_dir, process_group=self._dcp_process_group())
        self.resume_step = step
        m, v = ([state["opt"][k][self.names[j]] for j in self._owned] for k in ("m", "v"))
        self._set_moments([pmesh.local_tensor(t) for t in m], [pmesh.local_tensor(t) for t in v],
                          int(state["opt"]["count"]))

    def _opt_state_for_save(self) -> dict:
        """{"count", "m", "v"}: the Adam count and moments by parameter name
        (a collective under FSDP2 and zero1)."""
        m, v = self._moments()
        return {"count": self.opt_count, "m": dict(zip(self.names, self._full(m))),
                "v": dict(zip(self.names, self._full(v)))}

    def _load_opt(self, saved: dict):
        m, v = (self._shard([saved[k][n] for n in self.names]) for k in ("m", "v"))
        self._set_moments(m, v, int(saved["count"]))

    def _dcp_state(self) -> dict:
        """The state a DCP checkpoint holds, as live tensors laid out as this
        rank holds them: ``model``, ``ema_{rate}`` and ``opt`` (count, m, v)."""
        def owned(tensors):
            return {self.names[j]: pmesh.as_dtensor(t, self.params[j]) for j, t in zip(self._owned, tensors)}

        m, v = self._moments()
        return {"model": {n: p.detach() for n, p in zip(self.names, self.params)},
                **{f"ema_{rate}": owned(e) for rate, e in zip(self.ema_rate, self.ema_params)},
                "opt": {"count": torch.tensor(self.opt_count), "m": owned(m), "v": owned(v)}}

    def _dcp_process_group(self):
        """A gloo group of its own for DCP (None without a process group): an
        asynchronous save's collectives run in a thread of their own."""
        if self._dcp_group is None and pdist.is_initialized():
            self._dcp_group = torch.distributed.new_group(backend="gloo")
        return self._dcp_group

    # ------------------------------------------------------------ the step
    def _upload(self, a) -> torch.Tensor:
        """A host array or tensor on the model's device (``to_device``)."""
        return to_device(a, self.device)

    def micro_loss(self, x, cond, t, weights, noise=None):
        """One microbatch's forward: (mean(loss * weights), terms)."""
        if self.cond_dropout:
            cond = drop_conditioning(self.generator, cond, self.cond_dropout, self.cond_null_y)
        if noise is None:
            noise = torch.randn(x.shape, generator=self.generator, device=self.device)
        # under SP: the rank's rows of the batch and of its noise, each loss term a mean over them
        x, noise = sp.shard_rows(x.contiguous(memory_format=torch.channels_last)), sp.shard_rows(noise)
        terms = self.diffusion.training_losses(self.ddp or self.model, x, t, noise, model_kwargs=cond)
        return (terms["loss"] * weights).mean(), terms

    def _grad_sync(self, last: bool):
        """The context of one microbatch's forward and backward: only the
        last one reduces the gradients over the ranks."""
        if self.fsdp:
            self.model.set_requires_gradient_sync(last)
        elif self.ddp is not None and not last:
            return self.ddp.no_sync()
        return contextlib.nullcontext()

    def update(self) -> tuple:
        """AdamW and the EMAs on the summed gradients; returns (grad_norm,
        param_norm), the latter of the parameters before the update."""
        for p in self.params:  # a parameter no loss reached still decays, as under optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            grad_norm = _global_norm([p.grad for p in self.params], self.fsdp)
            param_norm = _global_norm(self.params, self.fsdp)
        frac = max(0.0, 1.0 - self.opt_count / self.lr_anneal_steps) if self.lr_anneal_steps else 1.0
        for group in self.opt.param_groups:
            group["lr"] = self.lr * frac
        self.opt.step()
        if self.model.int8:
            if self.fsdp:
                # FSDP2 refills the unsharded weights in place, their version kept
                for m in self._convs:
                    m._wq_key = None
            else:
                # the fused AdamW (and ZeRO's broadcast) write the parameters without
                # bumping their version counters, on which the int8 convs' cached
                # weight quantization is keyed
                torch.autograd.graph.increment_version(self.params)
        self.opt_count += 1
        with torch.no_grad():
            owned = [pmesh.local_tensor(self.params[j]) for j in self._owned]
            for ema, rate in zip(self.ema_params, self.ema_rate):
                torch._foreach_lerp_(ema, owned, 1.0 - rate)
        return grad_norm, param_norm

    def _train_step(self, batch, cond, t, weights, noise=None) -> dict:
        self.opt.zero_grad(set_to_none=True)
        losses, vecs = [], {"loss": [], "mse": [], "vb": []}
        for i in range(self.n_micro):
            rows = slice(i * self.microbatch, (i + 1) * self.microbatch)
            with self._grad_sync(i == self.n_micro - 1):
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
            self.wait_for_save()

    def run_step(self, batch, cond, noise=None, t=None):
        """One update on a host batch (B, C, H, W) and its cond dict;
        ``noise`` (the batch's shape) and ``t`` (B,) replace the generator's
        and the schedule sampler's draws, for tests."""
        if t is None:
            t_np, w_np = self.schedule_sampler.sample(self.batch_size, self.np_rng)
        else:
            p = self.schedule_sampler.weights()
            p = p / np.sum(p)
            t_np = np.asarray(t, dtype=np.int64)
            w_np = (1.0 / (len(p) * p[t_np])).astype(np.float32)
        if self._loss_weight_table is not None:
            w_np = (w_np * self._loss_weight_table[t_np]).astype(np.float32)
        t = self._upload(t_np).long()
        metrics = self._train_step(
            self._upload(batch).float(), {k: self._upload(v) for k, v in cond.items()},
            t, self._upload(w_np), None if noise is None else self._upload(noise),
        )
        if isinstance(self.schedule_sampler, LossAwareSampler):
            # the sampler needs this step's losses before the next draw (train_util.py:190);
            # they are every rank's already
            self.flush_metrics()
            host = self._fetch(self._start_fetch(metrics, t))
            self.schedule_sampler.update_with_all_losses(host["t"].tolist(), host["loss_vec"].tolist())
            self._log_step_metrics(host)
        else:
            # step k - 1's metrics, copied while step k was queued
            self.flush_metrics()
            self._pending_log = (self.step + self.resume_step, t_np, self._start_fetch(metrics, t))

    def _start_fetch(self, metrics: dict, t: torch.Tensor):
        """Queue the copy of a step's metrics and timesteps, gathered over the
        data groups, to the host: (host tensor, the event that marks the
        copy's end or None, the vector length of one rank)."""
        if sp.size() > 1:  # the data group's terms: the mean of its ranks' means over their rows
            metrics = dict(metrics)
            for k in ("loss", "loss_vec", "mse_vec", "vb_vec"):
                metrics[k] = sp.reduce_sum_(metrics[k].float().clone()) / sp.size()
        flat = torch.cat([metrics[k].reshape(-1).float() for k in _METRIC_KEYS] + [t.float()])
        n = metrics["loss_vec"].numel()
        if self.world > 1:
            parts = [torch.empty_like(flat) for _ in range(self.world)]
            torch.distributed.all_gather(parts, flat)
            flat = torch.cat(parts[::groups.size()])  # one rank a data group
        if flat.device.type != "cuda":
            return flat, None, n
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event, n

    @staticmethod
    def _fetch(pending) -> dict:
        """The global batch's metrics: the loss averaged over the ranks, the
        vectors and ``t`` in rank order."""
        host, event, n = pending
        if event is not None:
            event.synchronize()
        a = host.numpy().reshape(-1, 3 + 4 * n)  # a row a rank
        vec = [a[:, 3 + i * n:3 + (i + 1) * n].ravel() for i in range(4)]
        return {"loss": a[:, 0].mean(), "grad_norm": a[0, 1], "param_norm": a[0, 2],
                "loss_vec": vec[0], "mse_vec": vec[1], "vb_vec": vec[2], "t": vec[3].astype(np.int64)}

    def flush_metrics(self):
        """Log the deferred previous step's metrics; returns them as
        ``_fetch`` reads them (``loss``, ``grad_norm``, ``param_norm``, the
        vectors and ``t``), or None when no step was pending."""
        pending, self._pending_log = self._pending_log, None
        if pending is None:
            return None
        step, _, fetch = pending
        metrics = self._fetch(fetch)
        self._log_step_metrics(metrics, step=step)
        return metrics

    def _log_step_metrics(self, metrics, step=None):
        step = self.step + self.resume_step if step is None else step
        logger.logkv("step", step)
        logger.logkv("samples", (step + 1) * self.global_batch)
        for k in ("loss", "grad_norm", "param_norm"):
            logger.logkv_mean(k, float(metrics[k]))
        T = self.diffusion.num_timesteps
        for name in ("loss", "mse", "vb"):  # per-quartile losses (train_util.py:381-387)
            for sub_t, sub_loss in zip(metrics["t"], metrics[f"{name}_vec"]):
                logger.logkv_mean(f"{name}_q{int(4 * sub_t / T)}", float(sub_loss))

    def _anneal_frac(self):
        if not self.lr_anneal_steps:
            return 0.0
        return (self.step + self.resume_step) / self.lr_anneal_steps

    # ------------------------------------------------------------ save / val
    def save(self):
        """Every rank takes part (the full values are gathered under FSDP2
        and zero1); rank 0 writes the ``.pt`` files, then a barrier. Under
        ``ckpt_backend orbax`` every rank starts its part of a DCP save."""
        step = self.step + self.resume_step
        out_dir = get_blob_logdir()
        if self.ckpt_backend == "orbax":
            self._save_dcp(step, os.path.join(out_dir, "orbax", str(step)))
            return
        logger.log(f"saving model at step {step}...")
        model = (self.model.state_dict() if not self.fsdp
                 else dict(zip(self.names, (pmesh.full_tensor(p, p) for p in self.params))))
        files = [(ckpt.checkpoint_name("model", step), model)]
        files += [(ckpt.checkpoint_name("ema", step, rate), dict(zip(self.names, self._full(ema))))
                  for rate, ema in zip(self.ema_rate, self.ema_params)]
        files.append((ckpt.checkpoint_name("opt", step), self._opt_state_for_save()))
        if self.rank == 0:
            for name, sd in files:
                ckpt.save_state_dict(os.path.join(out_dir, name), sd)
        pdist.barrier("save")

    def _save_dcp(self, step: int, path: str) -> None:
        """Start an asynchronous DCP save of ``_dcp_state`` into ``path``
        after the previous one has ended; the state is copied to host memory
        before this returns."""
        import torch.distributed.checkpoint as dcp

        self.wait_for_save()
        logger.log(f"saving model at step {step} (orbax: DCP, async) into {path}...")
        t0 = time.perf_counter()
        future = dcp.async_save(self._dcp_state(), checkpoint_id=path, process_group=self._dcp_process_group())
        blocked = time.perf_counter() - t0
        done = []
        future.add_done_callback(lambda _: done.append(time.perf_counter()))
        self._dcp_pending = (future, step, t0, blocked, done)

    def wait_for_save(self) -> None:
        """Wait for the DCP save in flight, if any, and log its times."""
        pending, self._dcp_pending = self._dcp_pending, None
        if pending is None:
            return
        future, step, t0, blocked, done = pending
        future.result()
        logger.log(f"orbax (DCP) save of step {step}: {blocked:.3f} s blocking the loop, written "
                   f"{(done[0] if done else time.perf_counter()) - t0:.3f} s after it began")

    def ema_model(self, i: int = 0) -> torch.nn.Module:
        """A copy of the model in eval mode with the i-th EMA's weights, its
        torso cast in place as a sampler loads a checkpoint (a collective
        under FSDP2 and zero1, which gather the EMA)."""
        full = self._full(self.ema_params[i])
        if self._proto is not None:
            model = copy.deepcopy(self._proto).to_empty(device=self.device).eval()
        else:
            model = copy.deepcopy(self.model).eval()
        with torch.no_grad():
            torch._foreach_copy_(list(model.parameters()), full)
        if model.dtype != torch.float32:
            model.convert_torso(model.dtype)
        return model

    def val_sample(self, which: int | None = None, num_samples: int = 8):
        """Sample a small grid from each val dataset with the first EMA
        (train_util.py:269-341), every rank on its shard: rank 0 writes the
        gathered ``val_samples_{i}_{step}.npz`` and ``.png``, and
        ``val_targets_{i}_{step}.png``, NHWC as the JAX loop writes them."""
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
                sample = sp.gather_rows(loop(model, tuple(x.shape), self.generator, model_kwargs=cond))
            sample = sp.gather_data_groups(sample.permute(0, 2, 3, 1).float().cpu().numpy())
            targets = sp.gather_data_groups(x.permute(0, 2, 3, 1).cpu().numpy())
            sample, targets = (a.reshape((-1,) + a.shape[2:]) for a in (sample, targets))
            if self.rank == 0:
                np.savez(os.path.join(out_dir, f"val_samples_{di}_{step:06d}.npz"), sample)
                save_img(tensor2img(sample), os.path.join(out_dir, f"val_samples_{di}_{step:06d}.png"))
                save_img(tensor2img(targets), os.path.join(out_dir, f"val_targets_{di}_{step:06d}.png"))
        pdist.barrier("val_sample")


def _meta_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` whose parameters lie on the meta device (no memory)."""
    memo = {id(p): torch.nn.Parameter(torch.empty_like(p, device="meta"), p.requires_grad)
            for p in model.parameters()}
    return copy.deepcopy(model, memo)


def get_blob_logdir() -> str:
    """Where checkpoints and samples go (train_util.py:359-362)."""
    return os.environ.get("DIFFUSION_BLOB_LOGDIR", logger.get_dir())


def find_resume_checkpoint():
    """The newest ``model*.pt`` in the blob log dir (else its ``orbax``
    directory) when DIFFUSION_AUTO_RESUME=1, else None (the JAX loop's fix-forward of the
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
    orbax = os.path.join(out_dir, "orbax")
    if best is None and os.path.isdir(orbax) and os.listdir(orbax):
        return orbax  # a ckpt_backend orbax run: _resume takes its newest step
    return best


def log_loss_dict(diffusion: Diffusion, ts, losses: dict):
    """train_util.py:381-387 parity helper for scripts that log by hand."""
    for key, values in losses.items():
        values = np.asarray(values)
        logger.logkv_mean(key, float(values.mean()))
        for sub_t, sub_loss in zip(np.asarray(ts), values):
            logger.logkv_mean(f"{key}_q{int(4 * sub_t / diffusion.num_timesteps)}", float(sub_loss))
