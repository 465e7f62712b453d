"""One rank of the port's two-process tests, launched by ``run_ranks`` under
torchrun (``--standalone``, gloo on the CPU). It imports torch and the port
only; the tests in the parent compare what the ranks write with the one-rank
port and with the JAX package.

    python -m torch.distributed.run --standalone --nproc_per_node 2 tests/torch_dist_worker.py <scenario> <dir>

``dir`` holds the parent's inputs; each rank writes its results there.
"""

from __future__ import annotations

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


if __name__ == "__main__":
    torch.set_num_threads(1)
    globals()[f"scenario_{sys.argv[1]}"](sys.argv[2])
