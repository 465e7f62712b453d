"""The port's SR CLIs (``python -m guided_diffusion_clip_tpu_torch.super_res_unsup``,
``.super_res_train``, ``.super_res_sample``, ``.super_res_depth_sweep_sample``)
against the JAX package, f32 on the CPU.

One ``TrainLoop.run_step`` of the SR-delta model against the JAX loop's, from
the same weights, batch (x, img2, clip_feat, clip_feat2), timesteps and noise:
loss, grad_norm and param_norm within 1e-4 relative, the updated parameters
within 1e-4 relative L2, as tests/test_torch_train.py holds the recipe; the
port's SR checkpoints load in the JAX package. ``area_downsample`` and
``load_superres_data`` against the JAX script's functions (imported from
scripts/ here only); a 3-step ``super_res_sample`` chain against the JAX
library functions that the script composes, with the JAX loop's own noise
(5e-4, as the port's other chains); the depth sweep's mapping into the
respaced chain. Then each CLI end to end on the CPU at a tiny size, and the
refusals.
"""

import importlib
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from guided_diffusion_clip_tpu.diffusion import sampling as JS
from guided_diffusion_clip_tpu.models import clip_models as JCM
from guided_diffusion_clip_tpu.models.unet import UNetConfig as JaxConfig
from guided_diffusion_clip_tpu.models.unet import UNetModel as JaxUNet
from guided_diffusion_clip_tpu.parallel.mesh import create_mesh
from guided_diffusion_clip_tpu.training.train_loop import TrainLoop as JaxTrainLoop
from guided_diffusion_clip_tpu.utils import checkpoint as jckpt
from guided_diffusion_clip_tpu.utils import logger as jlogger
from guided_diffusion_clip_tpu.utils import script_util as JSU
from guided_diffusion_clip_tpu_torch import (
    super_res_depth_sweep_sample,
    super_res_sample,
    super_res_train,
    super_res_unsup,
)
from guided_diffusion_clip_tpu_torch.image_sample import respaced_start
from guided_diffusion_clip_tpu_torch.models import clip_models as TCM
from guided_diffusion_clip_tpu_torch.models.unet import UNetConfig, UNetModel
from guided_diffusion_clip_tpu_torch.training import train_loop as TL
from guided_diffusion_clip_tpu_torch.utils import logger
from guided_diffusion_clip_tpu_torch.utils import script_util as TSU
from guided_diffusion_clip_tpu_torch.utils.checkpoint import load_model_weights
from guided_diffusion_clip_tpu_torch.utils.convert import state_dict_from_flax
from torch_port_utils import nchw, nhwc, random_params

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the fork's recipe, shrunk, through the SR factory's channels: x ++ img2
SR = dict(image_size=16, in_channels=6, model_channels=32, out_channels=6, num_res_blocks=1,
          attention_resolutions=(2,), channel_mult=(1, 2), num_classes=512, num_heads=1,
          use_scale_shift_norm=True)
B = 4
LOOP = dict(batch_size=B, lr=1e-4, ema_rate="0.9,0.99", log_interval=10**9, save_interval=10**9,
            weight_decay=0.05, lr_anneal_steps=10, seed=3)
DIFFUSION = dict(steps=20, noise_schedule="cosine", learn_sigma=True)
# the SR factory's smallest size (64 px, channel_mult (1, 2, 3, 4)), narrow and shallow
TINY_SR = ["--large_size", "64", "--small_size", "32", "--num_channels", "32", "--num_res_blocks", "1",
           "--attention_resolutions", "8", "--num_heads", "1", "--learn_sigma", "True", "--diffusion_steps", "8",
           "--noise_schedule", "cosine", "--device", "cpu"]


def _jax_script(name):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))


@pytest.fixture(scope="module")
def weights():
    """(jax SR-delta model, numpy params): every weight random, bias_feat included."""
    jm = JCM.SRImageModel_Feat(JaxConfig(**SR))
    z = jnp.zeros((1, 16, 16, 3))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), z, jnp.zeros((1,), jnp.int32),
                                            clip_feat=jnp.zeros((1, 512)), clip_feat2=jnp.zeros((1, 512)), img2=z))
    return jm, jax.device_get(random_params(shapes["params"], 0))


def _batch(seed=0):
    """(x, {clip_feat, clip_feat2, img2}) NHWC, as the JAX loader yields a CLIP batch."""
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    feat = rs.standard_normal((B, 512)).astype(np.float32)
    return x, {"clip_feat": feat, "clip_feat2": np.roll(feat, 1, axis=0), "img2": np.roll(x, 1, axis=0)}


def _port_cond(cond):
    return {k: nchw(v) if v.ndim == 4 else torch.from_numpy(v) for k, v in cond.items()}


def _port_loop(params, tmp=None, **kw):
    model = TCM.SRImageModel_Feat(UNetConfig(**SR))
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    logger.configure_dir(tmp or tempfile.mkdtemp(), format_strs=[])
    return TL.TrainLoop(model=model, diffusion=TSU.create_gaussian_diffusion(**DIFFUSION), data=None,
                        **{**LOOP, "microbatch": -1, **kw})


def _rel(ours: dict, theirs: dict) -> float:
    num = sum(float(np.sum((np.asarray(ours[k], np.float64) - np.asarray(theirs[k], np.float64)) ** 2))
              for k in theirs)
    return (num / sum(float(np.sum(np.asarray(theirs[k], np.float64) ** 2)) for k in theirs)) ** 0.5


def test_sr_delta_train_step_matches_jax(weights):
    """``super_res_unsup``'s step: the SR-delta model's loss and gradient (and
    the AdamW update and EMAs on it) against the JAX loop's step."""
    jm, params = weights
    x, cond = _batch()
    jlogger.configure_dir(dir=tempfile.mkdtemp(), format_strs=[])
    mesh = create_mesh(axes=(("data", 1),), devices=jax.devices()[:1])
    jloop = JaxTrainLoop(model=jm, diffusion=JSU.create_gaussian_diffusion(**DIFFUSION), data=iter(()), mesh=mesh,
                         init_params=params, microbatch=-1, **LOOP)
    _, step_rng = jax.random.split(jloop.rng)  # what run_step splits off, then the step's own split
    noise = np.asarray(jax.random.normal(jax.random.split(jax.random.split(step_rng, 1)[0])[1], (B, 16, 16, 3)))
    jloop.run_step(x, cond)
    jmet = jax.device_get(jloop._pending_log[2])

    loop = _port_loop(params)
    loop.run_step(nchw(x), _port_cond(cond), noise=nchw(noise))
    met = loop._fetch(loop._pending_log[2])
    for k in ("loss", "grad_norm", "param_norm"):
        np.testing.assert_allclose(met[k], np.asarray(jmet[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(met["loss_vec"], np.asarray(jmet["loss_vec"]), rtol=1e-4, atol=1e-6)
    ours = {n: p.detach().numpy() for n, p in zip(loop.names, loop.params)}
    assert _rel(ours, state_dict_from_flax(jax.device_get(jloop.params))) <= 1e-4
    grad = {n: 10 * loop.opt.state[p]["exp_avg"].numpy() for n, p in zip(loop.names, loop.params)}
    assert np.abs(grad["bias_feat"]).max() > 0  # the CLIP delta's offset learns
    assert loop.model.bias_feat.dtype == torch.float32


def test_sr_checkpoints_load_in_the_jax_package(weights, tmp_path):
    """The SR-delta ``model*.pt`` and ``ema_*.pt`` that the port's loop saves
    load through the JAX package's ``load_params``; the JAX forward on them
    matches the port's within 1e-4."""
    jm, params = weights
    loop = _port_loop(params, str(tmp_path), lr=1e-2)
    x, cond = _batch(4)
    loop.run_step(nchw(x), _port_cond(cond))
    loop.step = 1
    loop.save()
    t = np.array([2, 7, 11, 19], np.int32)
    apply = jax.jit(jm.apply)
    for name, tensors in (("model000001.pt", loop.params), ("ema_0.9_000001.pt", loop.ema_params[0])):
        jparams = jckpt.load_params(str(tmp_path / name), params)
        ref = np.asarray(apply({"params": jparams}, jnp.asarray(x), jnp.asarray(t),
                               **{k: jnp.asarray(v) for k, v in cond.items()}))
        model = TCM.SRImageModel_Feat(UNetConfig(**SR)).eval()
        model.load_state_dict(dict(zip(loop.names, tensors)), strict=True)
        with torch.no_grad():
            out = nhwc(model(nchw(x), torch.from_numpy(t), **_port_cond(cond)))
        assert np.abs(ref).max() > 0.1
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4, err_msg=name)


# --- super_res_train's loader -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """12 PNGs of 64 px (two of another size) and their flip-indexed CLIP dict."""
    root = tmp_path_factory.mktemp("sr_data")
    imgs = root / "imgs"
    imgs.mkdir()
    rs = np.random.RandomState(0)
    clip = {}
    for i in range(12):
        name = f"img_{i:03d}.png"
        h, w = (64, 64) if i % 5 else (80, 96)
        Image.fromarray(rs.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(imgs / name)
        clip[name] = rs.randn(2, 512).astype(np.float32)
    np.savez(root / "clip.npz", **clip)
    return root


def test_area_downsample_matches_the_jax_script():
    jtrain = _jax_script("super_res_train")
    x = np.random.RandomState(1).uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    for size in (32, 16, 64):
        ours = super_res_train.area_downsample(np.ascontiguousarray(x.transpose(0, 3, 1, 2)), size)
        np.testing.assert_allclose(ours.transpose(0, 2, 3, 1), jtrain.area_downsample(x, size), rtol=0, atol=1e-6)
    # F.interpolate(mode="area"), which the reference calls (super_res_train.py:89)
    ref = torch.nn.functional.interpolate(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), size=(16, 16), mode="area")
    np.testing.assert_allclose(super_res_train.area_downsample(x.transpose(0, 3, 1, 2), 16), ref.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="integer factor"):
        super_res_train.area_downsample(np.zeros((1, 3, 64, 64), np.float32), 48)


def test_load_superres_data_matches_the_jax_script(folder):
    """The same batches, in order, with the same ``low_res`` (the loaders
    draw their shuffles, crops and flips from the same seeds)."""
    jtrain = _jax_script("super_res_train")
    kw = dict(batch_size=4, large_size=64, small_size=32, class_cond=True, clip_file_path=str(folder / "clip.npz"))
    ours = super_res_train.load_superres_data(str(folder / "imgs"), **kw)
    theirs = jtrain.load_superres_data(str(folder / "imgs"), **kw)
    for _ in range(4):
        (x, c), (jx, jc) = next(ours), next(theirs)
        np.testing.assert_allclose(x.transpose(0, 2, 3, 1), jx, atol=1e-6)
        assert sorted(c) == sorted(jc) == ["clip_feat", "clip_feat2", "img2", "low_res"]
        np.testing.assert_allclose(c["low_res"].transpose(0, 2, 3, 1), jc["low_res"], atol=1e-6)
        np.testing.assert_array_equal(c["clip_feat"], jc["clip_feat"])
        assert c["low_res"].shape == (4, 3, 32, 32)


# --- super_res_sample's chain and loader -------------------------------------------------------------


def _sample_args(*flags):
    return super_res_sample.create_argparser().parse_args(
        ["--large_size", "16", "--small_size", "8", "--batch_size", "2", *flags])


@pytest.mark.parametrize("flags,class_cond", [([], False), (["--use_ddim", "True"], True),
                                              (["--sampler", "ddim"], False)])
def test_sr_sample_chain_matches_jax(flags, class_cond):
    """3 steps of ``make_chain`` against the JAX script's ``run_chain`` (the
    loop of ``resolve_sampler(..., honor_use_ddim=False)`` on the upstream
    SuperResModel), from the same weights, low_res and the JAX loop's own
    noise, within 5e-4; ``--use_ddim`` is ignored, as by the reference."""
    kw = dict(SR, num_classes=10 if class_cond else None, variant="super_res", label_emb_type="embedding")
    jm = JaxUNet(JaxConfig(**kw))
    rs = np.random.RandomState(5)
    low = rs.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    jkw = {"low_res": jnp.asarray(low)}
    tkw = {"low_res": nchw(low)}
    if class_cond:
        jkw["y"], tkw["y"] = jnp.array([1, 7], jnp.int32), torch.tensor([1, 7])
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)),
                                            **{k: v[:1] for k, v in jkw.items()}))["params"]
    params = jax.device_get(random_params(shapes, 2))
    args = _sample_args(*flags)
    diff_kw = dict(steps=1000, noise_schedule="cosine", learn_sigma=True, timestep_respacing="3")
    jdiff = JSU.create_gaussian_diffusion(**diff_kw)
    loop = JSU.resolve_sampler(jdiff, args, honor_use_ddim=False)
    key = jax.random.key(4)
    shape = (2, 16, 16, 3)
    ref = np.asarray(jax.jit(lambda p, k, mk: loop(lambda x, t, **a: jm.apply({"params": p}, x, t, **a), shape, k,
                                                   clip_denoised=True, model_kwargs=mk))(params, key, jkw))
    loop_rng, init_rng = jax.random.split(key, 2)
    start = nchw(np.asarray(JS._normal(init_rng, shape, jnp.float32)))
    step_noise = [nchw(np.asarray(JS._normal(k, shape, jnp.float32))) for k in jax.random.split(loop_rng, 3)]

    tm = UNetModel(UNetConfig(**kw)).eval()
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    calls = {}
    run_chain = super_res_sample.make_chain(tm, TSU.create_gaussian_diffusion(**diff_kw), args, calls)
    with torch.inference_mode():
        ours = run_chain(tkw, None, noise=start, step_noise=step_noise)
    assert calls == {"unet": 3} and ours.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(nhwc(ours), ref, rtol=5e-4, atol=5e-4)


def test_load_data_for_worker_matches_the_jax_script(tmp_path):
    jsample = _jax_script("super_res_sample")
    rs = np.random.RandomState(6)
    np.savez(tmp_path / "base.npz", rs.randint(0, 256, (5, 8, 8, 3), dtype=np.uint8), rs.randint(0, 10, (5,)))
    for class_cond in (False, True):
        ours = super_res_sample.load_data_for_worker(str(tmp_path / "base.npz"), 2, class_cond)
        theirs = jsample.load_data_for_worker(str(tmp_path / "base.npz"), 2, class_cond)
        for _ in range(4):  # past the end: the rows loop
            a, b = next(ours), next(theirs)
            assert sorted(a) == sorted(b) == (["low_res", "y"] if class_cond else ["low_res"])
            np.testing.assert_array_equal(a["low_res"], b["low_res"].transpose(0, 3, 1, 2))
            if class_cond:
                np.testing.assert_array_equal(a["y"], b["y"])


def test_depth_sweep_maps_depths_into_the_respaced_chain():
    """Depths 500, 699, 898 (original steps), mapped as the JAX script's
    ``min(round(depth * T / T_orig), T)``."""
    assert super_res_depth_sweep_sample.DEPTHS == (500, 699, 898)
    for respacing, want in (("", [500, 699, 898]), ("100", [50, 70, 90]), ("10", [5, 7, 9]), ("ddim25", [12, 17, 22])):
        diffusion = TSU.create_gaussian_diffusion(steps=1000, noise_schedule="cosine", timestep_respacing=respacing)
        jdiff = JSU.create_gaussian_diffusion(steps=1000, noise_schedule="cosine", timestep_respacing=respacing)
        T = jdiff.num_timesteps
        jax_map = [min(int(round(d * T / jdiff.sched.original_num_steps)), T) for d in super_res_depth_sweep_sample.DEPTHS]
        assert [respaced_start(diffusion, d) for d in super_res_depth_sweep_sample.DEPTHS] == jax_map == want


# --- the CLIs end to end ------------------------------------------------------------------------------


def _with_env(env, fn, *a):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn(*a)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        logger.reset()


def test_super_res_train_then_super_res_sample(folder, tmp_path):
    """``super_res_train`` two steps and its save (the upstream ``super_res``
    model, low_res from the loader), then ``super_res_sample`` on that
    checkpoint from a 32 px npz, f32 and int8: NHWC uint8 samples at 64 px,
    int8's other than f32's."""
    _with_env(
        {"DIFFUSION_TRAINING_TEST": "1", "OPENAI_LOG_FORMAT": "log,csv"}, super_res_train.main,
        [*TINY_SR, "--data_dir", str(folder / "imgs"), "--batch_size", "2", "--save_interval", "2",
         "--log_interval", "1", "--main_path", str(tmp_path / "train"), "--lr", "1e-2"])
    (run,) = os.listdir(tmp_path / "train")
    ckpt = tmp_path / "train" / run / "model000002.pt"
    assert {"model000002.pt", "ema_0.9999_000002.pt", "opt000002.pt", "progress.csv"} <= set(
        os.listdir(tmp_path / "train" / run))
    sd = torch.load(ckpt, weights_only=True)
    assert sd["input_blocks.0.0.weight"].shape[1] == 6 and "bias_feat" not in sd and "label_emb.weight" not in sd

    rs = np.random.RandomState(7)
    np.savez(tmp_path / "base.npz", rs.randint(0, 256, (3, 32, 32, 3), dtype=np.uint8))
    outs = {}
    for name, extra in (("f32", []), ("int8", ["--conv_impl", "int8"])):
        out = _with_env({}, super_res_sample.main,
                        [*TINY_SR, "--model_path", str(ckpt), "--base_samples", str(tmp_path / "base.npz"),
                         "--timestep_respacing", "3", "--batch_size", "2", "--num_samples", "3", "--main_path",
                         str(tmp_path / name), *extra])
        assert os.path.basename(out["path"]) == "samples_3x64x64x3.npz"
        assert out["batches"] == 2 and out["steps"] == 3 and out["calls"] == {"unet": 6}
        outs[name] = np.load(out["path"])["arr_0"]
        assert outs[name].dtype == np.uint8 and outs[name].std() > 0
    assert not np.array_equal(outs["f32"], outs["int8"])


def test_super_res_unsup_with_a_validation_set_and_a_resume(folder, tmp_path):
    """Two steps, the save at step 2 and its validation grids for
    ``--data_dir`` and ``--data_dir_test``; then ``--load <fragment>
    --load_file model000002.pt`` resumes it (under ``--train_conv_impl int8``,
    the 6-channel stem on the int8 path) to step 4."""
    argv = [*TINY_SR, "--class_cond", "True", "--data_dir", str(folder / "imgs"), "--clip_file_path",
            str(folder / "clip.npz"), "--data_dir_test", str(folder / "imgs"), "--clip_file_path_test",
            str(folder / "clip.npz"), "--batch_size", "2", "--val_batch_size", "2", "--save_interval", "2",
            "--log_interval", "1", "--main_path", str(tmp_path)]
    _with_env({"DIFFUSION_TRAINING_TEST": "1", "OPENAI_LOG_FORMAT": "log,csv"}, super_res_unsup.main,
              [*argv, "-d", "first"])
    (run,) = os.listdir(tmp_path)
    files = set(os.listdir(tmp_path / run))
    assert {"model000002.pt", "ema_0.9999_000002.pt", "val_samples_0_000002.png", "val_samples_1_000002.png",
            "val_targets_1_000002.png"} <= files
    sd = torch.load(tmp_path / run / "model000002.pt", weights_only=True)
    assert sd["bias_feat"].shape == (512,) and sd["input_blocks.0.0.weight"].shape[1] == 6
    model, _ = TSU.sr_create_model_and_diffusion(**{**TSU.sr_model_and_diffusion_defaults(), "large_size": 64,
                                                    "num_channels": 32, "num_res_blocks": 1, "num_heads": 1,
                                                    "attention_resolutions": "8", "learn_sigma": True,
                                                    "class_cond": True, "use_fp16": True})
    load_model_weights(model, str(tmp_path / run / "ema_0.9999_000002.pt"))

    _with_env({"OPENAI_LOG_FORMAT": "log,csv"}, super_res_unsup.main,
              [*argv, "-d", "second", "--load", "first", "--load_file", "model000002.pt", "--lr_anneal_steps", "4",
               "--train_conv_impl", "int8"])
    second = next(d for d in os.listdir(tmp_path) if d.endswith("_second"))
    with open(tmp_path / second / "log.txt") as f:
        text = f.read()
    assert "loading model from checkpoint" in text and "(step 2)" in text
    assert {"model000004.pt", "ema_0.9999_000004.pt"} <= set(os.listdir(tmp_path / second))


def test_depth_sweep_cli(folder, tmp_path):
    """From a CLIP UNet checkpoint: a PNG for each depth plus target and
    start, and the forwards of the three mapped chains."""
    kw = dict(image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2", attention_resolutions="8",
              num_heads=1, learn_sigma=True, class_cond=True, use_scale_shift_norm=True)
    model = TSU.create_model(**kw)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.02, generator=torch.Generator().manual_seed(p.numel()))
    torch.save(model.state_dict(), tmp_path / "clip_unet.pt")
    out = _with_env({}, super_res_depth_sweep_sample.main, [
        "--image_size", "16", "--num_channels", "32", "--num_res_blocks", "1", "--channel_mult", "1,2",
        "--attention_resolutions", "8", "--num_heads", "1", "--learn_sigma", "True", "--class_cond", "True",
        "--diffusion_steps", "1000", "--noise_schedule", "cosine", "--timestep_respacing", "10",
        "--model_path", str(tmp_path / "clip_unet.pt"), "--data_dir_test", str(folder / "imgs"),
        "--clip_file_path_test", str(folder / "clip.npz"), "--batch_size", "4", "--main_path",
        str(tmp_path / "runs"), "--sub_dir_tstsave", "sweep", "--device", "cpu"])
    assert os.path.dirname(out["dir"]) == str(tmp_path / "runs" / "sweep")
    assert {"depth_500.png", "depth_699.png", "depth_898.png", "target.png", "start.png"} <= set(os.listdir(out["dir"]))
    assert {d: st for d, (st, _) in out["depths"].items()} == {500: 5, 699: 7, 898: 9}
    assert out["calls"] == {"unet": 21}
    grid = np.asarray(Image.open(os.path.join(out["dir"], "depth_699.png")))
    assert grid.shape == (2 + 2 * 18, 2 + 2 * 18, 3) and grid.std() > 0


# --- refusals -------------------------------------------------------------------------------------------


@pytest.mark.parametrize("flags,message", [
    # the ids from when fsdp, zero1 and orbax were not yet ported: outside torchrun fsdp and zero1 are now
    # refused for want of a process group, and orbax runs, so its case is an unknown backend
    pytest.param(["--param_sharding", "fsdp"], "launch under torchrun", id="flags0-not yet ported"),
    pytest.param(["--opt_impl", "zero1"], "launch under torchrun", id="flags1-not yet ported"),
    # and --spatial_shard's and --tensor_shard's from when they were not yet ported: outside torchrun each is
    # refused for want of a process group
    pytest.param(["--spatial_shard", "2"], "launch under torchrun", id="flags2-not yet ported"),
    pytest.param(["--tensor_shard", "2"], "tensor_shard 2 needs a process group: launch under torchrun",
                 id="flags3-not yet ported"),
    pytest.param(["--ckpt_backend", "tensorstore"], "ckpt_backend 'tensorstore'", id="flags4-not yet ported"),
    (["--train_conv_impl", "fp8"], "choose from auto, xla, int8"),
])
@pytest.mark.parametrize("cli", [super_res_unsup, super_res_train])
def test_trainers_refuse_unported_flags(cli, flags, message, tmp_path):
    """With ``image_train``'s messages, before the run directory is made."""
    with pytest.raises(SystemExit, match=message):
        cli.main([*TINY_SR, "--data_dir", "x", "--main_path", str(tmp_path), *flags])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flags,message", [
    # the ids from when the flags were not yet ported: outside torchrun each is now refused for want of a
    # process group
    pytest.param(["--spatial_shard", "2"], "--spatial_shard 2: launch under torchrun",
                 id="flags0---spatial_shard: not yet ported"),
    pytest.param(["--tensor_shard", "2"], "--tensor_shard 2: launch under torchrun",
                 id="flags1---tensor_shard: not yet ported"),
    (["--conv_impl", "fp8"], "--conv_impl 'fp8'"),
    (["--model_path", ""], "--model_path"),
])
@pytest.mark.parametrize("cli", [super_res_sample, super_res_depth_sweep_sample])
def test_samplers_refuse(cli, flags, message, tmp_path):
    with pytest.raises(SystemExit, match=message):
        cli.main(["--device", "cpu", "--model_path", "m.pt", "--main_path", str(tmp_path), *flags])
    assert not os.listdir(tmp_path)


def test_jax_messages(tmp_path):
    """What the JAX package refuses, the port refuses with its words: an
    unknown ``--sampler`` (``resolve_sampler``) and a size the SR factory has
    no channel mults for."""
    diff_kw = dict(steps=10, noise_schedule="cosine")
    with pytest.raises(SystemExit) as jinfo:
        JSU.resolve_sampler(JSU.create_gaussian_diffusion(**diff_kw), _sample_args("--sampler", "euler"),
                            honor_use_ddim=False)
    with pytest.raises(SystemExit) as info:
        super_res_sample.make_chain(None, TSU.create_gaussian_diffusion(**diff_kw), _sample_args("--sampler", "euler"))
    assert str(info.value.code) == str(jinfo.value.code)
    kw = dict(JSU.sr_model_and_diffusion_defaults(), large_size=96)
    with pytest.raises(ValueError) as jerr:
        JSU.sr_create_model(**{k: kw[k] for k in JSU.sr_create_model.__code__.co_varnames[:15]})
    with pytest.raises(ValueError) as err:
        TSU.sr_create_model_and_diffusion(**kw)
    assert str(err.value) == str(jerr.value) == "unsupported large size: 96"


@pytest.mark.parametrize("cli", [super_res_unsup, super_res_train, super_res_sample, super_res_depth_sweep_sample])
def test_missing_card_is_an_error(cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--data_dir", "x", "--main_path", str(tmp_path)]
                 if cli in (super_res_unsup, super_res_train) else ["--model_path", "m.pt", "--main_path", str(tmp_path)])
    assert not os.listdir(tmp_path)
