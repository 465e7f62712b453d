"""One rank of the port's two-process tests, launched by ``run_ranks`` under
torchrun (``--standalone``, gloo on the CPU). It imports torch and the port
only; the tests in the parent compare what the ranks write with the one-rank
port and with the JAX package.

    python -m torch.distributed.run --standalone --nproc_per_node 2 tests/torch_dist_worker.py <scenario> <dir>

``dir`` holds the parent's inputs; each rank writes its results there.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time

import numpy as np
import torch

from guided_diffusion_clip_tpu_torch.models.clip_models import UNetModel_clip_feat
from guided_diffusion_clip_tpu_torch.models.unet import UNetConfig
from guided_diffusion_clip_tpu_torch.parallel import dist as pdist
from guided_diffusion_clip_tpu_torch.parallel import mesh as pmesh
from guided_diffusion_clip_tpu_torch.training.train_loop import TrainLoop
from guided_diffusion_clip_tpu_torch.utils import logger
from guided_diffusion_clip_tpu_torch.utils.script_util import create_gaussian_diffusion

# the fork's 128 px recipe, shrunk as in test_torch_train.py
KW = dict(image_size=16, in_channels=3, model_channels=32, out_channels=6, num_res_blocks=1,
          attention_resolutions=(2,), channel_mult=(1, 2), num_classes=512, num_heads=1,
          use_scale_shift_norm=True)
B = 4  # each rank's batch
LOOP = dict(lr=1e-4, ema_rate="0.9,0.99", log_interval=10**9, save_interval=10**9, weight_decay=0.05,
            lr_anneal_steps=10, seed=3)
MODES = {"tree": {}, "flat": {"opt_impl": "flat"}, "zero1": {"opt_impl": "zero1"}, "fsdp": {"param_sharding": "fsdp"}}


def run_ranks(scenario: str, directory: str, n: int = 2, timeout: int = 240) -> None:
    """Run ``scenario`` on ``n`` CPU ranks under torchrun; raise with the
    ranks' output if it fails."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(n),
         os.path.abspath(__file__), scenario, directory],
        env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"{scenario} on {n} ranks exited {proc.returncode}:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-8000:]}")


def tiny_model(int8: bool = False, remat: bool = False):
    """The tiny CLIP UNet, every weight drawn from N(0, 0.05) (GroupNorm
    scales about 1) with a fixed seed, so that every parameter gets a
    gradient; ``remat``: with ``use_checkpoint`` (the same parameters)."""
    model = UNetModel_clip_feat(UNetConfig(**KW, use_checkpoint=remat), conv_impl="int8" if int8 else "xla")
    rs = np.random.RandomState(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rs.standard_normal(tuple(p.shape)).astype(np.float32) * 0.05))
        for m in model.modules():
            if isinstance(m, torch.nn.GroupNorm):
                m.weight += 1.0
    return model


def diffusion():
    return create_gaussian_diffusion(steps=20, noise_schedule="cosine", learn_sigma=True)


def batches(n: int, seed: int) -> dict:
    """``n`` rows of inputs for a train step: x, clip_feat, t and noise."""
    rs = np.random.RandomState(seed)
    return {"x": rs.uniform(-1, 1, (n, 3, 16, 16)).astype(np.float32),
            "feat": rs.standard_normal((n, 512)).astype(np.float32),
            "t": rs.randint(0, 20, n).astype(np.int64),
            "noise": rs.standard_normal((n, 3, 16, 16)).astype(np.float32)}


def make_loop(log_dir: str, batch_size: int = B, int8: bool = False, remat: bool = False, **kw) -> TrainLoop:
    logger.configure_dir(log_dir, format_strs=[])
    return TrainLoop(model=tiny_model(int8, remat), diffusion=diffusion(), data=None, batch_size=batch_size,
                     **{"microbatch": -1, **LOOP, **kw})


def step(loop: TrainLoop, b: dict, rows: slice) -> None:
    loop.run_step(torch.from_numpy(b["x"][rows]), {"clip_feat": torch.from_numpy(b["feat"][rows])},
                  noise=torch.from_numpy(b["noise"][rows]), t=b["t"][rows])


def state(loop: TrainLoop) -> dict:
    """The full parameters and gradients (after a step) and the metrics."""
    full = {n: pmesh.full_tensor(p.detach(), p).clone() for n, p in zip(loop.names, loop.params)}
    grad = {n: pmesh.full_tensor(p.grad, p).clone() for n, p in zip(loop.names, loop.params)}
    met = loop._fetch(loop._pending_log[2]) if loop._pending_log else None
    return {"params": full, "grad": grad, "loss": None if met is None else float(met["loss"])}


def stale_w_q(loop: TrainLoop, weights: dict) -> list:
    """The int8 convs whose cached ``w_q`` is not the quantization of
    ``weights``, the parameters that their last forward read."""
    from guided_diffusion_clip_tpu_torch.models.nn import Conv2d
    from guided_diffusion_clip_tpu_torch.ops.quant import quantize_per_out_channel

    def fresh(name, m):
        return m._wq is not None and torch.equal(
            m._wq[0], quantize_per_out_channel(weights[f"{name}.weight"].permute(2, 3, 1, 0))[0])

    return [name for name, m in loop.model.named_modules() if isinstance(m, Conv2d) and not fresh(name, m)]


# ---------------------------------------------------------------- scenarios
def scenario_basics(d: str) -> None:
    """The process group's queries and collectives, the loader's shard, the
    loss-aware sampler, the weighted mean and the per-rank log files."""
    from guided_diffusion_clip_tpu_torch.data.image_datasets import load_data
    from guided_diffusion_clip_tpu_torch.training.resample import LossSecondMomentResampler

    started = pdist.setup_dist("cpu")
    r, w = pdist.rank(), pdist.world_size()
    out = {"started": started, "rank": r, "world": w, "primary": pdist.is_primary()}
    out["gathered"] = pdist.all_gather_host(np.full((2, 3), r + 0.5, np.float32))
    marker = os.path.join(d, "barrier_marker")
    if r == 1:
        time.sleep(0.5)
        with open(marker, "w") as f:
            f.write("1")
    pdist.barrier("test")
    out["marker_after_barrier"] = os.path.exists(marker)
    data = load_data(data_dir=os.path.join(d, "images"), batch_size=2, image_size=16, random_crop=True,
                     clip_file_path=os.path.join(d, "clip.npz"), seed=5, prefetch=0)
    out["loader"] = [next(data) for _ in range(3)]
    sampler = LossSecondMomentResampler(10, history_per_term=2)
    rs = np.random.RandomState(100 + r)
    for _ in range(8):
        t = rs.randint(0, 10, 6)
        sampler.update_with_local_losses(t, rs.uniform(0, 2, 6) * (1 + t))
    out["sampler_weights"] = sampler.weights()
    out["weighted_mean"] = logger.distributed_weighted_mean({"a": r + 1.0, "b": 2.0 * r}, {"a": r + 1, "b": 1})
    os.environ.pop("OPENAI_LOG_FORMAT", None)
    os.environ.pop("OPENAI_LOG_FORMAT_MPI", None)
    log_dir = logger.configure_dir(os.path.join(d, "logs"))
    logger.logkv("x", r)
    logger.dumpkvs()
    logger.reset()
    pdist.barrier("logs")
    out["log_files"] = sorted(os.listdir(log_dir))
    torch.save(out, os.path.join(d, f"basics_rank{r}.pt"))
    pdist.destroy()


def scenario_sample(d: str) -> None:
    """``image_sample`` and ``classifier_sample`` at world 2 (the group is
    started here, so the CLIs leave it up)."""
    from guided_diffusion_clip_tpu_torch import classifier_sample, image_sample

    pdist.setup_dist("cpu")
    with open(os.path.join(d, "image_sample.argv")) as f:
        out = {"image": image_sample.main(f.read().split("\n"))["path"]}
    with open(os.path.join(d, "classifier_sample.argv")) as f:
        out["classifier"] = classifier_sample.main(f.read().split("\n"))["path"]
    torch.save(out, os.path.join(d, f"sample_rank{pdist.rank()}.pt"))
    pdist.destroy()


def scenario_train(d: str) -> None:
    """One step in each mode from the same weights, each rank on its half of
    a batch of 2B, and with ``use_checkpoint`` under tree, zero1 and fsdp; the
    checkpoints; a second step after a resume across modes;
    int8 under DDP and FSDP2; a DCP save and resume; the classifier's step."""
    pdist.setup_dist("cpu")
    r = pdist.rank()
    rows = slice(r * B, (r + 1) * B)
    b1, b2 = batches(2 * B, 1), batches(2 * B, 2)
    out = {}
    loops = {}
    for mode, kw in MODES.items():
        loop = loops[mode] = make_loop(os.path.join(d, mode), **kw)
        step(loop, b1, rows)
        out[mode] = state(loop)
        loop.save()
    for mode in ("tree", "zero1", "fsdp"):  # the blocks recomputed in the backward
        loop = make_loop(os.path.join(d, f"remat_{mode}"), remat=True, **MODES[mode])
        step(loop, b1, rows)
        out[f"remat_{mode}"] = state(loop)
    loop = make_loop(os.path.join(d, "tree_micro"), microbatch=2)
    step(loop, b1, rows)
    out["tree_micro"] = state(loop)

    step(loops["tree"], b2, rows)  # the uninterrupted run's second step
    out["tree_step2"] = state(loops["tree"])
    for src, mode in (("tree", "zero1"), ("zero1", "tree"), ("flat", "zero1"), ("zero1", "flat"), ("tree", "fsdp"),
                      ("fsdp", "tree")):
        loop = make_loop(os.path.join(d, f"resume_{src}_{mode}"), resume_checkpoint=os.path.join(
            d, src, "model000000.pt"), **MODES[mode])
        step(loop, b2, rows)
        out[f"resume_{src}_{mode}"] = state(loop)

    for mode in ("tree", "fsdp"):  # int8 at a rate that moves many weights a level
        loop = make_loop(os.path.join(d, f"int8_{mode}"), int8=True, **{**MODES[mode], "lr": 1e-2})
        step(loop, b1, rows)
        out[f"int8_{mode}_step1"] = state(loop)
        step(loop, b2, rows)
        out[f"int8_{mode}"] = state(loop)
        out[f"int8_{mode}"]["stale_w_q"] = stale_w_q(loop, out[f"int8_{mode}_step1"]["params"])

    loop = make_loop(os.path.join(d, "dcp"), ckpt_backend="orbax", **MODES["fsdp"])
    step(loop, b1, rows)
    loop.save()
    loop.wait_for_save()
    step(loop, b2, rows)
    out["dcp_uninterrupted"] = state(loop)
    for mode in ("fsdp", "zero1", "tree"):
        loop = make_loop(os.path.join(d, f"dcp_resume_{mode}"), ckpt_backend="orbax",
                         resume_checkpoint=os.path.join(d, "dcp", "orbax"), **MODES[mode])
        out[f"dcp_resume_{mode}_step"] = loop.resume_step
        step(loop, b2, rows)
        out[f"dcp_resume_{mode}"] = state(loop)

    out["classifier"] = classifier_step(d, r)
    torch.save(out, os.path.join(d, f"train_rank{r}.pt"))
    pdist.destroy()


CLF_ARGS = (64, False, 32, 1, "8", True, True, "attention")  # create_classifier's positional arguments


def classifier_batch(n: int):
    rs = np.random.RandomState(11)
    return (rs.uniform(-1, 1, (n, 3, 64, 64)).astype(np.float32), rs.randint(0, 1000, n),
            rs.randint(0, 40, n), rs.standard_normal((n, 3, 64, 64)).astype(np.float32))


def classifier_trainer(batch_size: int, fsdp: bool = False):
    from guided_diffusion_clip_tpu_torch.classifier_train import ClassifierTrainer
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_classifier

    torch.manual_seed(0)
    model = create_classifier(*CLF_ARGS)
    return ClassifierTrainer(model, create_gaussian_diffusion(steps=40, noise_schedule="cosine"),
                             batch_size=batch_size, microbatch=batch_size // 2, lr=1e-3, fsdp=fsdp)


def classifier_step(d: str, r: int) -> dict:
    """The classifier's step under DDP and FSDP2 on this rank's half of a
    batch of 4: its full gradients and updated parameters."""
    x, y, t, noise = classifier_batch(4)
    rows = slice(2 * r, 2 * r + 2)
    out = {}
    for fsdp in (False, True):
        trainer = classifier_trainer(2, fsdp)
        trainer.step(x[rows], y[rows], t=t[rows], noise=noise[rows])
        ps = dict(trainer.model.named_parameters())
        out["fsdp" if fsdp else "ddp"] = {
            "grad": {n: pmesh.full_tensor(p.grad, p).clone() for n, p in ps.items()},
            "params": {n: pmesh.full_tensor(p.detach(), p).clone() for n, p in ps.items()}}
    return out


# ---------------------------------------------------------------- spatial partitioning
SP_CFG = dict(image_size=16, in_channels=3, model_channels=32, out_channels=6, num_res_blocks=1,
              attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2, use_scale_shift_norm=True)
# a level that gives each of two ranks one row (the 2 px level of channel_mult (1, 1, 2, 2)): run whole
SP_DEEP = dict(SP_CFG, channel_mult=(1, 1, 2, 2), attention_resolutions=(4,))


def sp_models(d: str, inputs: str = "sp_inputs.pt", **kw) -> dict:
    """The models of ``inputs`` (the parent's weights), eval mode."""
    from guided_diffusion_clip_tpu_torch.models.unet import EncoderUNetModel, UNetModel

    inp = torch.load(os.path.join(d, inputs), weights_only=False)
    out = {}
    for name, (cfg, extra, sd) in inp["models"].items():
        cls = EncoderUNetModel if "pool" in extra else UNetModel
        m = cls(UNetConfig(**{**cfg, **kw.get(name, {})}), **extra).eval()
        m.load_state_dict(sd, strict=True)
        out[name] = m
    return inp, out


def rows_of(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a full NCHW tensor (``sp.shard_rows``)."""
    from guided_diffusion_clip_tpu_torch.parallel import sp

    return sp.shard_rows(x.contiguous(memory_format=torch.channels_last))


def part_of(ref: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's part of a full NCHW tensor as ``like`` holds it: its rows
    under SP, its channels under TP, else ``ref``."""
    from guided_diffusion_clip_tpu_torch.parallel import tp

    if ref.shape == like.shape:
        return ref
    if ref.shape[2] != like.shape[2]:
        return rows_of(ref)
    return tp.shard_channels(ref.contiguous(memory_format=torch.channels_last))


def whole_of(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A rank's part of an NCHW map, gathered to the full shape ``like``'s."""
    from guided_diffusion_clip_tpu_torch.parallel import sp, tp

    if x.shape[2] != like.shape[2]:
        return sp.gather_rows(x)
    return tp.gather_channels(x, like.shape[1])


class Int8Forcing:
    """Teacher forcing of the sharded int8 forward to the unsharded one's
    roundings: ``record`` keeps each quantizing GroupNorm's (q, s) and each
    per-tensor int8 conv's output of an unsharded forward and every
    per-tensor scale; ``force`` checks each against the sharded forward's
    (on the rank's rows), keeps the readings, and passes the unsharded value
    on, so that no rounding the other way compounds. The output head is left
    alone. ``by_name``: the values to hold and force by module name (the JAX
    package's int8 forward's captured intermediates, full size), in place of
    a recorded forward; no scales are compared then. Under SP the rank's
    rows are compared, under TP its channels (``part_of``)."""

    def __init__(self, by_name: dict | None = None):
        self.rec, self.scales, self.readings, self.handles = [], [], [], []
        self.pos = 0
        self.by_name = by_name

    def _scale_hooks(self, store):
        from guided_diffusion_clip_tpu_torch.ops import quant as Q

        fns = {"quantize_per_tensor": Q.quantize_per_tensor, "quantize_given_plain": Q.quantize_given_plain}

        def wrap(fn):
            def call(*a, **k):
                q, s = fn(*a, **k)
                store.append(s.clone())
                return q, s
            return call

        for name, fn in fns.items():
            setattr(Q, name, wrap(fn))
        return lambda: [setattr(Q, n, f) for n, f in fns.items()]

    def _hook(self, forcing, name):
        def hook(mod, args, kwargs, out):
            quant_gn = kwargs.get("quantize", False)
            if not quant_gn and (kwargs.get("prequant_scales") is not None or not getattr(mod, "int8", False)):
                return None
            if not forcing:
                self.rec.append(tuple(t.detach().clone() for t in (out if quant_gn else (out,))))
                return None
            ref = self.rec[self.pos] if self.by_name is None else self.by_name[name]
            self.pos += 1
            if quant_gn:
                (q, sc), (rq, rsc) = out, ref
                rq = part_of(rq, q)
                # the groups' offsets over the whole image: the one-pass variance loses (mean / std)^2 ulps
                x = args[0].detach()
                xf = x if x.shape == ref[0].shape else whole_of(x, ref[0])
                xg = xf.movedim(1, -1).double().reshape(xf.shape[0], -1, 32, xf.shape[1] // 32)
                ratio = (xg.mean((1, 3)).abs() / xg.std((1, 3))).max().item()
                d_q = (q.float() - rq.float()).abs()
                self.readings.append({"kind": "gn", "s_err": ((sc - rsc).abs() / rsc).max().item(),
                                      "s_tol": 1e-6 + ratio ** 2 * 2.0 ** -20, "q_max": d_q.max().item(),
                                      "flips": int((d_q > 0).sum()), "n": d_q.numel()})
                return rq.to(q.dtype), rsc
            (r,) = ref
            r = part_of(r, out)
            dd = (out - r).abs()
            self.readings.append({"kind": "conv", "max": dd.max().item(), "ref_max": r.abs().max().item(),
                                  "l2": (dd.norm() / r.norm()).item()})
            return r

        return hook

    def run(self, model, x, t, forcing, **kw):
        from guided_diffusion_clip_tpu_torch.models.nn import Conv2d, GroupNorm32

        store = [] if forcing else self.scales
        restore = self._scale_hooks(store)
        self.pos = 0
        for name, m in model.named_modules():
            if isinstance(m, (GroupNorm32, Conv2d)) and not name.startswith("out."):
                self.handles.append(m.register_forward_hook(self._hook(forcing, name), with_kwargs=True))
        try:
            with torch.no_grad():
                out = model(x, t, **kw)
        finally:
            restore()
            for h in self.handles:
                h.remove()
            self.handles = []
        if forcing and self.by_name is None:
            assert self.pos == len(self.rec), (self.pos, len(self.rec))
            self.scale_pairs = [(a.item(), b.item()) for a, b in zip(store, self.scales)]
            assert len(store) == len(self.scales), (len(store), len(self.scales))
        return out


def _tried(fn):
    """``fn()``'s refusal as text, or None where it ran."""
    try:
        fn()
        return None
    except (ValueError, NotImplementedError, SystemExit) as e:
        return f"{type(e).__name__}: {e}"


def scenario_sp(d: str) -> None:
    """Two ranks, one data group of two space ranks (``--spatial_shard 2``):
    the forwards, int8 teacher-forced, the classifiers and their guidance
    gradient, DeepCache, the chains, the train steps, the CLIs, the
    refusals. Each rank writes its rows; the parent holds them to the
    unsharded port and to the JAX package."""
    from guided_diffusion_clip_tpu_torch import classifier_sample, image_sample
    from guided_diffusion_clip_tpu_torch.diffusion.deep_cache import zero_state
    from guided_diffusion_clip_tpu_torch.diffusion.guidance import cfg_model_fn, classifier_cond_fn
    from guided_diffusion_clip_tpu_torch.parallel import sp
    from guided_diffusion_clip_tpu_torch.training.train_loop import check_ported

    pdist.setup_dist("cpu")
    r = pdist.rank()
    out = {}
    # the refusals first, before SP is set
    for what, fn in (("S4_at_world2", lambda: sp.set_spatial_sharding(4)),
                     ("both_flags", lambda: check_ported(spatial_shard=2, tensor_shard=2)),
                     ("cli_both", lambda: sp.check_flags(2, 2)), ("cli_tp", lambda: sp.check_flags(0, 2))):
        out[f"refuse_{what}"] = _tried(fn)
    out["identity"] = not sp.active() and all(
        f(t) is t for t in (torch.ones(2, 3, 4, 4),) for f in (sp.shard_rows, sp.gather_rows, lambda u: sp.halo(u, 1, 1)))
    sp.set_spatial_sharding(2)
    out["groups"] = (sp.size(), sp.space_rank(), sp.data_rank(), sp.data_size())
    inp, models = sp_models(d)
    x, t, feat = inp["x"], inp["t"], inp["feat"]
    xs = rows_of(x)
    with torch.no_grad():
        out["fwd_clip"] = models["clip"](xs, t, clip_feat=feat)
        out["fwd_plain"] = models["plain"](xs, t)
        out["fwd_deep"] = models["deep"](xs, t)
        out["fwd_super_res"] = models["super_res"](xs, t, low_res=inp["low_res"])
        out["fwd_sr_img_feat"] = models["sr_img_feat"](xs, t, clip_feat=feat, clip_feat2=inp["feat2"], img2=inp["img2"])
        out["clf_attention"] = models["clf_attention"](xs, t)
        out["clf_spatial"] = models["clf_spatial"](xs, t)
        full, deep = models["clip"](xs, t, clip_feat=feat, cache_mode="full")
        out["cache_full"], out["cache_deep"] = full, deep
        out["cache_shallow"] = models["clip"](xs, t, clip_feat=feat, cache_mode="shallow", deep_cache=deep)[0]
        out["cache_zero_state"] = tuple(zero_state(models["clip"].config, x.shape[0])[1].shape)
    # the classifier's guidance gradient, and the backward through a remat UNet and the whole-run level
    cond = classifier_cond_fn(lambda u, tt: models["clf_attention"](u, tt), 3.0)
    out["guidance"] = cond(xs, t, y=inp["y"])
    for name, m, kw in (("remat", sp_models(d, clip={"use_checkpoint": True})[1]["clip"], {"clip_feat": feat}),
                        ("deep_grad", models["deep"], {})):
        m.train()
        xg = xs.clone().requires_grad_(True)
        (m(xg, t, **kw).square().sum()).backward()
        out[name] = {"x": xg.grad, "params": {n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None}}
        m.eval()
    # int8, teacher-forced to the unsharded int8 forward's roundings
    _, m8 = sp_models(d)
    m8 = m8["clip8"]
    forcing = Int8Forcing()
    with sp.whole():
        ref8 = forcing.run(m8, x, t, False, clip_feat=feat)
    got8 = forcing.run(m8, xs, t, True, clip_feat=feat)
    out["int8"] = {"readings": forcing.readings, "scales": forcing.scale_pairs, "out": got8, "ref_rows": rows_of(ref8)}
    # and teacher-forced to the JAX package's int8 forward of the same weights and inputs
    forcing = Int8Forcing(by_name=inp["jax_int8"])
    out["int8_jax"] = {"readings": forcing.readings, "out": forcing.run(m8, xs, t, True, clip_feat=feat)}
    # chains: DDIM from a generator, and CFG over clip_feat
    diff = create_gaussian_diffusion(steps=20, noise_schedule="cosine", learn_sigma=True,
                                     rescale_learned_sigmas=True, timestep_respacing="ddim5")
    with torch.no_grad():
        g = torch.Generator().manual_seed(3)
        out["ddim"] = diff.ddim_sample_loop(models["plain"], tuple(x.shape), g)
        g = torch.Generator().manual_seed(7)
        out["cfg"] = diff.ddim_sample_loop(cfg_model_fn(models["clip"], 2.5, {"clip_feat": 0.0}), tuple(x.shape), g,
                                           model_kwargs={"clip_feat": feat})
    # the train steps: DDP, ZeRO-1 and FSDP2 with SP, and DDP with use_checkpoint
    b1 = batches(B, 1)
    for mode, kw in (("tree", {}), ("zero1", MODES["zero1"]), ("fsdp", MODES["fsdp"]), ("remat_tree", {"remat": True})):
        loop = make_loop(os.path.join(d, f"sp_{mode}"), spatial_shard=2, **kw)
        step(loop, b1, slice(None))
        out[f"train_{mode}"] = state(loop)
    torch.save(out, os.path.join(d, f"sp_rank{r}.pt"))
    # the CLIs, each a run of its own
    cli = {}
    for name, main in (("image", image_sample.main), ("classifier", classifier_sample.main)):
        with open(os.path.join(d, f"sp_{name}.argv")) as f:
            cli[name] = main(f.read().split("\n"))["path"]
    sp.clear_spatial_sharding()
    with open(os.path.join(d, "sp_image.argv")) as f:  # at world 2 without SP: two data groups of one rank
        argv = f.read().split("\n")
    i = argv.index("--spatial_shard")
    cli["image_dp"] = image_sample.main(argv[:i] + argv[i + 2:] + ["--main_path", os.path.join(d, "dp2")])["path"]
    torch.save(cli, os.path.join(d, f"sp_cli_rank{r}.pt"))
    # the other CLIs that take --spatial_shard, each as the parent wrote its flags and environment
    run_clis(os.path.join(d, "sp_clis.pt"))
    pdist.destroy()


def run_clis(path: str) -> None:
    """Each CLI of ``path`` (the parent's {name: (module, flags,
    environment)}) through its ``main``, in the environment given."""
    for name, (module, argv, env) in torch.load(path, weights_only=False).items():
        old_env = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        torch.manual_seed(0)  # the trainers' initial weights, as the parent's one-process run draws them
        try:
            importlib.import_module(f"guided_diffusion_clip_tpu_torch.{module}").main(argv)
        finally:
            for k, v in old_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            logger.reset()


def scenario_sp4(d: str) -> None:
    """Four ranks, two data groups of two space ranks: a DDP train step, each
    data group on its half of a batch of 2B, and ``image_sample``."""
    from guided_diffusion_clip_tpu_torch import image_sample
    from guided_diffusion_clip_tpu_torch.parallel import sp

    pdist.setup_dist("cpu")
    r = pdist.rank()
    sp.set_spatial_sharding(2)
    out = {"groups": (sp.size(), sp.space_rank(), sp.data_rank(), sp.data_size())}
    rows = slice(sp.data_rank() * B, (sp.data_rank() + 1) * B)
    loop = make_loop(os.path.join(d, "sp4_tree"), spatial_shard=2)
    step(loop, batches(2 * B, 1), rows)
    out["train_tree"] = state(loop)
    torch.save(out, os.path.join(d, f"sp4_rank{r}.pt"))
    with open(os.path.join(d, "sp_image.argv")) as f:
        argv = f.read().split("\n")
    out = {"image": image_sample.main(argv + ["--main_path", os.path.join(d, "sp4_image")])["path"]}
    torch.save(out, os.path.join(d, f"sp4_cli_rank{r}.pt"))
    pdist.destroy()


# ---------------------------------------------------------------- tensor parallelism
TP_INPUTS = "tp_inputs.pt"
# T = 3 on a model 96 channels wide: each rank 32 channels, 10 2/3 of the 32 groups of 3 (the groups split)
TP3_CFG = dict(SP_CFG, model_channels=96, num_heads=3)


def _sharded_and_whole(fn):
    """(``fn()`` under TP, ``fn()`` unsharded inside ``tp.whole()``), no grad."""
    from guided_diffusion_clip_tpu_torch.parallel import tp

    with torch.no_grad():
        got = fn()
        with tp.whole():
            ref = fn()
    return got, ref


def _backward(model, x, t, **kw) -> dict:
    """The gradients of the sum of squares of ``model``'s output, train mode."""
    model.train()
    model.zero_grad(set_to_none=True)
    xg = x.clone().requires_grad_(True)
    model(xg, t, **kw).square().sum().backward()
    model.eval()
    return {"x": xg.grad.clone(), "params": {n: p.grad.clone() for n, p in model.named_parameters()
                                             if p.grad is not None}}


def _tp_backward(model, x, t, **kw) -> dict:
    """``_backward`` under TP and unsharded (each rank its own loss copy)."""
    from guided_diffusion_clip_tpu_torch.parallel import tp

    got = _backward(model, x, t, **kw)
    with tp.whole():
        ref = _backward(model, x, t, **kw)
    return {"got": got, "ref": ref}


def _int8_forced(m8, x, t, jax_values=None, **kw) -> dict:
    """The int8 model under TP teacher-forced to its unsharded forward (and,
    with ``jax_values``, to the JAX package's): the readings, the scales and
    the unforced head's output beside the unsharded one."""
    from guided_diffusion_clip_tpu_torch.parallel import tp

    forcing = Int8Forcing()
    with tp.whole():
        ref = forcing.run(m8, x, t, False, **kw)
    got = forcing.run(m8, x, t, True, **kw)
    out = {"readings": forcing.readings, "scales": forcing.scale_pairs, "out": got, "ref": ref}
    if jax_values is not None:
        forcing = Int8Forcing(by_name=jax_values)
        out["jax"] = {"readings": forcing.readings, "out": forcing.run(m8, x, t, True, **kw)}
    return out


def _guidance(clf, x, t, y):
    """``classifier_cond_fn`` at scale 3 under TP and unsharded."""
    from guided_diffusion_clip_tpu_torch.diffusion.guidance import classifier_cond_fn
    from guided_diffusion_clip_tpu_torch.parallel import tp

    cond = classifier_cond_fn(lambda u, tt: clf(u, tt), 3.0)
    got = cond(x, t, y=y)
    with tp.whole():
        ref = cond(x, t, y=y)
    return got, ref


def scenario_tp(d: str) -> None:
    """Two ranks, one data group of two model ranks (``--tensor_shard 2``):
    the refusals and the stale state first, then the forwards of every
    variant, DeepCache, the classifiers, int8 teacher-forced, the guidance
    gradient, the backward with ``use_checkpoint``, the chains, each beside
    the same call unsharded (``tp.whole()``); the train steps under DDP,
    ZeRO-1, FSDP2 and with ``use_checkpoint``; the CLIs."""
    from guided_diffusion_clip_tpu_torch import classifier_sample, image_sample
    from guided_diffusion_clip_tpu_torch.diffusion.deep_cache import zero_state
    from guided_diffusion_clip_tpu_torch.diffusion.guidance import cfg_model_fn
    from guided_diffusion_clip_tpu_torch.parallel import groups, sp, tp
    from guided_diffusion_clip_tpu_torch.training.train_loop import check_ported

    pdist.setup_dist("cpu")
    r = pdist.rank()
    out = {"identity": not tp.active() and all(
        f(u) is u for u in (torch.ones(2, 32, 4, 4),) for f in (tp.shard_channels, lambda v: tp.gather_channels(v, 64)))}
    out["refuse_T4_at_world2"] = _tried(lambda: tp.set_tensor_sharding(4))
    out["refuse_both_flags"] = _tried(lambda: check_ported(spatial_shard=2, tensor_shard=2))
    out["refuse_cli_both"] = _tried(lambda: sp.check_flags(2, 2))
    with sp.spatial_sharding(2):
        out["refuse_tp_under_sp"] = _tried(lambda: tp.set_tensor_sharding(2))
    with tp.tensor_sharding(2):
        out["refuse_sp_under_tp"] = _tried(lambda: sp.set_spatial_sharding(2))
    # a loop without tensor_shard clears TP left on; one with it pins TP to groups of its own
    tp.set_tensor_sharding(2)
    make_loop(os.path.join(d, "stale"))
    out["stale_cleared"] = not tp.active()
    tp.set_tensor_sharding(2)
    ambient = tp._STATE
    make_loop(os.path.join(d, "repin"), tensor_shard=2)
    out["repinned"] = tp.active() and tp._STATE is not ambient and tp.size() == 2

    tp.set_tensor_sharding(2)
    out["groups"] = (tp.size(), tp.model_rank(), groups.data_rank(), groups.data_size())
    rgb, wide = torch.ones(2, 3, 4, 4), torch.ones(2, 32, 4, 4)
    out["indivisible"] = (tp.shard_channels(rgb) is rgb, tuple(tp.shard_channels(wide).shape),
                          tp.local_shape((2, 3, 4, 4)), tp.local_shape((2, 32, 4, 4)))
    inp, models = sp_models(d, TP_INPUTS)
    x, t, feat = inp["x"], inp["t"], inp["feat"]
    clip = models["clip"]
    for name, fn in (
            ("fwd_clip", lambda: clip(x, t, clip_feat=feat)),
            ("fwd_plain", lambda: models["plain"](x, t)),
            ("fwd_new_order", lambda: models["new_order"](x, t)),
            ("fwd_heads1", lambda: models["heads1"](x, t)),
            ("fwd_no_scale_shift", lambda: models["no_scale_shift"](x, t)),
            ("fwd_super_res", lambda: models["super_res"](x, t, low_res=inp["low_res"])),
            ("fwd_sr_img_feat", lambda: models["sr_img_feat"](x, t, clip_feat=feat, clip_feat2=inp["feat2"],
                                                              img2=inp["img2"])),
            ("cache_full", lambda: clip(x, t, clip_feat=feat, cache_mode="full")[0]),
            ("cache_deep", lambda: clip(x, t, clip_feat=feat, cache_mode="full")[1]),
            ("clf_attention", lambda: models["clf_attention"](x, t)),
            ("clf_spatial", lambda: models["clf_spatial"](x, t)),
            ("clf_adaptive", lambda: models["clf_adaptive"](x, t))):
        out[name] = _sharded_and_whole(fn)
    deep = out["cache_deep"]
    out["cache_shallow"] = _sharded_and_whole(lambda: clip(x, t, clip_feat=feat, cache_mode="shallow", deep_cache=(
        deep[0] if tp.sharded() else deep[1]))[0])
    out["cache_zero_state"] = tuple(zero_state(clip.config, x.shape[0])[1].shape)
    # the emb projection's rows: the rank's scale and shift, each the slice of the whole projection's half
    block = clip.input_blocks[1][0]  # 32 channels, the rank's 16
    emb = torch.randn(4, 128, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        rows = block._emb_out(emb, 16)
        full = block.emb_layers[1](torch.nn.functional.silu(emb))
    out["emb_rows"] = (rows, full)
    out["guidance"] = _guidance(models["clf_attention"], x, t, inp["y"])
    out["remat"] = _tp_backward(sp_models(d, TP_INPUTS, clip={"use_checkpoint": True})[1]["clip"], x, t,
                                clip_feat=feat)
    out["int8"] = _int8_forced(models["clip8"], x, t, inp["jax_int8"], clip_feat=feat)
    diff = create_gaussian_diffusion(steps=20, noise_schedule="cosine", learn_sigma=True,
                                     rescale_learned_sigmas=True, timestep_respacing="ddim5")
    out["ddim"] = _sharded_and_whole(lambda: diff.ddim_sample_loop(models["plain"], tuple(x.shape),
                                                                   torch.Generator().manual_seed(3)))
    out["cfg"] = _sharded_and_whole(lambda: diff.ddim_sample_loop(
        cfg_model_fn(clip, 2.5, {"clip_feat": 0.0}), tuple(x.shape), torch.Generator().manual_seed(7),
        model_kwargs={"clip_feat": feat}))
    # the train steps: DDP, ZeRO-1 and FSDP2 with TP, and DDP with use_checkpoint, both ranks on the same rows
    b1 = batches(B, 1)
    for mode, kw in (("tree", {}), ("zero1", MODES["zero1"]), ("fsdp", MODES["fsdp"]), ("remat_tree", {"remat": True})):
        loop = make_loop(os.path.join(d, f"tp_{mode}"), tensor_shard=2, **kw)
        step(loop, b1, slice(None))
        out[f"train_{mode}"] = state(loop)
    tp.clear_tensor_sharding()
    torch.save(out, os.path.join(d, f"tp_rank{r}.pt"))
    cli = {}
    for name, main in (("image", image_sample.main), ("classifier", classifier_sample.main)):
        with open(os.path.join(d, f"tp_{name}.argv")) as f:
            cli[name] = main(f.read().split("\n"))["path"]
        cli[f"{name}_after"] = tp.active()
    torch.save(cli, os.path.join(d, f"tp_cli_rank{r}.pt"))
    run_clis(os.path.join(d, "tp_clis.pt"))  # the other CLIs that take --tensor_shard
    pdist.destroy()


def scenario_tp3(d: str) -> None:
    """Three ranks, T = 3 on a model 96 channels wide: the groups split
    across the ranks (each GroupNorm on the gathered channels), the heads
    (3 at 192 channels) do not; the forward, int8 teacher-forced, the
    backward and the classifier's guidance gradient beside the unsharded
    calls."""
    import warnings

    from guided_diffusion_clip_tpu_torch.parallel import tp

    pdist.setup_dist("cpu")
    r = pdist.rank()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tp.set_tensor_sharding(3)
    out = {"warned": [str(w.message) for w in caught]}
    inp, models = sp_models(d, TP_INPUTS)
    x, t, feat = inp["x"], inp["t"], inp["feat"]
    wide = models["wide"]
    out["fwd_wide"] = _sharded_and_whole(lambda: wide(x, t, clip_feat=feat))
    out["int8"] = _int8_forced(models["wide8"], x, t, clip_feat=feat)
    out["backward"] = _tp_backward(wide, x, t, clip_feat=feat)
    out["guidance"] = _guidance(models["clf_wide"], x, t, inp["y"])
    tp.clear_tensor_sharding()
    torch.save(out, os.path.join(d, f"tp3_rank{r}.pt"))
    pdist.destroy()


def scenario_tp4(d: str) -> None:
    """Four ranks: two data groups of two model ranks (DDP, ZeRO-1 and FSDP2
    train steps, each data group on its half of a batch of 2B), then one
    data group of four (T = 4, the pure-model layout: the forward and the
    guidance gradient beside the unsharded calls)."""
    from guided_diffusion_clip_tpu_torch.parallel import groups, tp

    pdist.setup_dist("cpu")
    r = pdist.rank()
    tp.set_tensor_sharding(2)
    out = {"groups": (tp.size(), tp.model_rank(), groups.data_rank(), groups.data_size())}
    rows = slice(groups.data_rank() * B, (groups.data_rank() + 1) * B)
    for mode in ("tree", "zero1", "fsdp"):
        loop = make_loop(os.path.join(d, f"tp4_{mode}"), tensor_shard=2, **MODES[mode])
        step(loop, batches(2 * B, 1), rows)
        out[f"train_{mode}"] = state(loop)
    tp.clear_tensor_sharding()
    tp.set_tensor_sharding(4)
    out["groups_t4"] = (tp.size(), tp.model_rank(), groups.data_rank(), groups.data_size())
    inp, models = sp_models(d, TP_INPUTS)
    x, t, feat = inp["x"], inp["t"], inp["feat"]
    out["fwd_clip"] = _sharded_and_whole(lambda: models["clip"](x, t, clip_feat=feat))
    out["guidance"] = _guidance(models["clf_attention"], x, t, inp["y"])
    tp.clear_tensor_sharding()
    torch.save(out, os.path.join(d, f"tp4_rank{r}.pt"))
    pdist.destroy()


if __name__ == "__main__":
    torch.set_num_threads(1)
    globals()[f"scenario_{sys.argv[1]}"](sys.argv[2])
