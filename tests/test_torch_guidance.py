"""Classifier guidance in the port against the JAX package: condition_mean and
condition_score, a 3-step guided ancestral chain (given the noise JAX draws)
and a guided DDIM eta=0 chain through a class-conditional UNet and an
attention-pool classifier with the same weights, f32 on the CPU within 5e-4
(the 5-step chain bound of ROADMAP.md); and ``classifier_sample`` end to end
on the CPU at 64 px."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guided_diffusion_clip_tpu.diffusion import gaussian as JG
from guided_diffusion_clip_tpu.diffusion import guidance as JGd
from guided_diffusion_clip_tpu.diffusion import sampling as JS
from guided_diffusion_clip_tpu.diffusion import schedules as JSch
from guided_diffusion_clip_tpu_torch import classifier_sample as CS
from guided_diffusion_clip_tpu_torch.diffusion import gaussian as TG
from guided_diffusion_clip_tpu_torch.diffusion import guidance as TGd
from guided_diffusion_clip_tpu_torch.diffusion import sampling as TS
from guided_diffusion_clip_tpu_torch.diffusion import schedules as TSch
from guided_diffusion_clip_tpu_torch.utils.script_util import create_classifier, create_upstream_model
from torch_port_utils import encoder_pair, nchw, nhwc, upstream_pair

torch.set_num_threads(2)

# ADM-G's generator and classifier topologies, shrunk to 16 px: scale-shift,
# resblock up/down, 64-channel heads, learned sigma, a 1000-class table; the
# classifier's attention pool takes 8 x 8 + 1 = 65 tokens
UNET = dict(
    image_size=16, in_channels=3, model_channels=64, out_channels=6, num_res_blocks=1,
    attention_resolutions=(2, 4), channel_mult=(1, 1, 2), num_classes=1000,
    num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True,
)
CLASSIFIER = dict(
    image_size=16, in_channels=3, model_channels=64, out_channels=1000, num_res_blocks=1,
    attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=64,
    use_scale_shift_norm=True, resblock_updown=True,
)
SCALE = 2.0


@pytest.mark.parametrize("which", ["mean", "score"])
def test_conditioning_matches(which):
    """condition_mean / condition_score on a fixed model output and an
    x-dependent gradient field."""
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, 4, 4, 3)).astype(np.float32)
    out = (rs.standard_normal((2, 4, 4, 6)) * 0.5).astype(np.float32)
    t = np.array([3, 17], np.int32)
    js = JSch.build_schedule(steps=100, noise_schedule="cosine", timestep_respacing="25")
    ts = TSch.build_schedule(steps=100, noise_schedule="cosine", timestep_respacing="25")
    kw = dict(var_type=JSch.ModelVarType.LEARNED_RANGE, clip_denoised=True)
    ref0 = JG.p_mean_variance(js, lambda xx, tt, **k: jnp.asarray(out), jnp.asarray(x), jnp.asarray(t), **kw)
    ours0 = TG.p_mean_variance(
        ts, lambda xx, tt, **k: nchw(out), nchw(x), torch.from_numpy(t).long(),
        var_type=TSch.ModelVarType.LEARNED_RANGE, clip_denoised=True,
    )
    jcond = lambda xx, tt, y=None: 0.3 * jnp.sin(xx) * (1.0 + tt[:, None, None, None] / 1000.0) + y
    tcond = lambda xx, tt, y=None: 0.3 * torch.sin(xx) * (1.0 + tt[:, None, None, None] / 1000.0) + y
    jfn, tfn = (JG.condition_mean, TG.condition_mean) if which == "mean" else (JG.condition_score, TG.condition_score)
    ref = jfn(js, jcond, ref0, jnp.asarray(x), jnp.asarray(t), model_kwargs={"y": 0.5})
    ours = tfn(ts, tcond, ours0, nchw(x), torch.from_numpy(t).long(), model_kwargs={"y": 0.5})
    for field in ref._fields:
        r = np.broadcast_to(np.asarray(getattr(ref, field)), x.shape)
        o = getattr(ours, field).expand(2, 3, 4, 4)
        np.testing.assert_allclose(nhwc(o), r, rtol=2e-5, atol=2e-5, err_msg=field)


def _guided_fns():
    jm, params, tm = upstream_pair(UNET, seed=1)
    jc, cparams, tc = encoder_pair(CLASSIFIER, "attention", seed=2)
    tc.requires_grad_(False)
    jcond = JGd.classifier_cond_fn(lambda x, t: jc.apply({"params": cparams}, x, t), SCALE)
    jmodel = JGd.model_fn_dropping_y(lambda x, t, **kw: jm.apply({"params": params}, x, t, **kw), True)
    return jmodel, jcond, TGd.model_fn_dropping_y(tm, True), TGd.classifier_cond_fn(tc, SCALE)


def test_guided_ancestral_chain_matches_with_jax_noise():
    """3 guided ancestral steps from the same x_T; the port is given the
    noise JAX's loop draws at each step."""
    jmodel, jcond, tmodel, tcond = _guided_fns()
    rs = np.random.RandomState(3)
    x_T = rs.standard_normal((2, 16, 16, 3)).astype(np.float32)
    y = np.array([5, 871], np.int32)
    js = JSch.build_schedule(steps=1000, timestep_respacing="3")
    ts = TSch.build_schedule(steps=1000, timestep_respacing="3")
    key = jax.random.key(11)
    ref = jax.jit(lambda n: JS.p_sample_loop(
        js, jmodel, n.shape, key, noise=n, cond_fn=jcond, model_kwargs={"y": jnp.asarray(y)},
    ))(jnp.asarray(x_T))
    loop_rng, _ = jax.random.split(key, 2)  # the split JS._scan_loop makes
    step_noise = [nchw(np.array(JS._normal(k, x_T.shape, jnp.float32))) for k in jax.random.split(loop_rng, 3)]
    with torch.no_grad():
        ours = TS.p_sample_loop(
            ts, tmodel, (2, 3, 16, 16), None, noise=nchw(x_T), step_noise=step_noise,
            cond_fn=tcond, model_kwargs={"y": torch.from_numpy(y).long()},
        )
    unguided = jax.jit(lambda n: JS.p_sample_loop(
        js, jmodel, n.shape, key, noise=n, model_kwargs={"y": jnp.asarray(y)},
    ))(jnp.asarray(x_T))
    assert np.abs(np.asarray(ref) - np.asarray(unguided)).max() > 1e-2  # the guidance acts
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), rtol=5e-4, atol=5e-4)


def test_guided_ddim_chain_eta0_matches():
    """3 guided DDIM steps at eta 0 (condition_score) from the same x_T."""
    jmodel, jcond, tmodel, tcond = _guided_fns()
    x_T = np.random.RandomState(4).standard_normal((2, 16, 16, 3)).astype(np.float32)
    y = np.array([0, 999], np.int32)
    js = JSch.build_schedule(steps=1000, timestep_respacing="ddim3")
    ts = TSch.build_schedule(steps=1000, timestep_respacing="ddim3")
    ref = jax.jit(lambda n: JS.ddim_sample_loop(
        js, jmodel, n.shape, jax.random.key(0), noise=n, cond_fn=jcond, model_kwargs={"y": jnp.asarray(y)},
    ))(jnp.asarray(x_T))
    with torch.no_grad():
        ours = TS.ddim_sample_loop(
            ts, tmodel, (2, 3, 16, 16), None, noise=nchw(x_T), cond_fn=tcond,
            model_kwargs={"y": torch.from_numpy(y).long()},
        )
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), rtol=5e-4, atol=5e-4)


def test_potential_cond_fn():
    x = torch.randn(2, 3, 4, 4)
    with torch.no_grad():
        g = TGd.potential_cond_fn(lambda x_, t: (x_ * x_).sum() * t, scale=0.5)(x, 3.0)
    torch.testing.assert_close(g, 3.0 * x)


# the CLI at 64 px: a bf16 generator and classifier (the smallest classifier
# the factory builds: 64 px, width 64, depth 1)
CLI_UNET = dict(
    image_size=64, num_channels=64, num_res_blocks=1, attention_resolutions="16,8",
    num_head_channels=64, resblock_updown=True, use_scale_shift_norm=True,
    learn_sigma=True, class_cond=True,
)
CLI_CLASSIFIER = dict(
    image_size=64, classifier_use_fp16=True, classifier_width=64, classifier_depth=1,
    classifier_attention_resolutions="32,16,8", classifier_use_scale_shift_norm=True,
    classifier_resblock_updown=True, classifier_pool="attention",
)


def _random_pt(model, path, seed):
    g = torch.Generator().manual_seed(seed)
    torch.save({k: torch.randn(v.shape, generator=g) * 0.02 for k, v in model.state_dict().items()}, path)


def test_classifier_sample_cli_on_cpu(tmp_path):
    """The entry point on the CPU: strict .pt loads, 3 ancestral steps,
    2 batches of 2 for 3 samples, npz (uint8 images, int32 labels in
    [0, 1000)) in the run directory; the same seed gives the same bytes."""
    _random_pt(create_upstream_model(**CLI_UNET), tmp_path / "model.pt", 0)
    _random_pt(create_classifier(**CLI_CLASSIFIER), tmp_path / "classifier.pt", 1)
    argv = [
        "--device", "cpu", "--model_path", str(tmp_path / "model.pt"),
        "--classifier_path", str(tmp_path / "classifier.pt"), "--use_fp16", "True",
        "--timestep_respacing", "3", "--batch_size", "2", "--num_samples", "3",
        "--classifier_scale", "10.0", "--seed", "7", "--main_path", str(tmp_path / "runs"),
    ]
    for k, v in {**CLI_UNET, **CLI_CLASSIFIER}.items():
        argv += [f"--{k}", str(v)]
    out = CS.main(argv)
    assert out["steps"] == 3 and out["batches"] == 2 and len(out["chain_seconds"]) == 2
    assert os.path.basename(out["path"]) == "samples_3x64x64x3.npz"
    assert os.path.dirname(os.path.dirname(out["path"])) == str(tmp_path / "runs")
    data = np.load(out["path"])
    images, labels = data["arr_0"], data["arr_1"]
    assert images.shape == (3, 64, 64, 3) and images.dtype == np.uint8
    assert labels.shape == (3,) and labels.dtype == np.int32 and ((0 <= labels) & (labels < 1000)).all()
    assert all(images[i].std() > 0 for i in range(3))
    again = np.load(CS.main(argv)["path"])
    np.testing.assert_array_equal(again["arr_0"], images)
    np.testing.assert_array_equal(again["arr_1"], labels)


def _cli_argv(tmp_path, *extra):
    argv = [
        "--device", "cpu", "--model_path", str(tmp_path / "model.pt"),
        "--classifier_path", str(tmp_path / "classifier.pt"), "--use_fp16", "True",
        "--timestep_respacing", "3", "--batch_size", "2", "--num_samples", "2",
        "--classifier_scale", "10.0", "--seed", "7", *extra,
    ]
    for k, v in {**CLI_UNET, **CLI_CLASSIFIER}.items():
        argv += [f"--{k}", str(v)]
    return argv


def test_classifier_sample_conv_impls_on_cpu(tmp_path):
    """``--conv_impl xla`` is the default bf16 path (the same bytes as
    ``auto``); ``--conv_impl int8`` (K4 and K5's plain versions here) gives
    other samples of the same kind, and the same bytes again."""
    _random_pt(create_upstream_model(**CLI_UNET), tmp_path / "model.pt", 0)
    _random_pt(create_classifier(**CLI_CLASSIFIER), tmp_path / "classifier.pt", 1)
    images = {}
    for impl in ("auto", "xla", "int8", "int8"):
        out = CS.main(_cli_argv(tmp_path, "--conv_impl", impl, "--main_path", str(tmp_path / impl)))
        data = np.load(out["path"])
        assert data["arr_0"].shape == (2, 64, 64, 3) and data["arr_0"].dtype == np.uint8
        if impl in images:
            np.testing.assert_array_equal(data["arr_0"], images[impl])
        images[impl] = data["arr_0"]
    np.testing.assert_array_equal(images["xla"], images["auto"])
    assert (images["int8"] != images["auto"]).any()
    assert all(images["int8"][i].std() > 0 for i in range(2))


def test_classifier_sample_refuses_unknown_conv_impl(tmp_path):
    argv = ["--device", "cpu", "--model_path", "m.pt", "--classifier_path", "c.pt",
            "--main_path", str(tmp_path), "--conv_impl", "int4"]
    with pytest.raises(SystemExit, match="choose from"):
        CS.main(argv)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flag,value", [
    ("guidance_interval", "100,900"), ("guidance_cache", "2"), ("deep_cache", "2"),
    ("sampler", "dpm++2m"), ("spatial_shard", "2"), ("tensor_shard", "2"),
])
def test_classifier_sample_refuses_what_is_not_ported(flag, value, tmp_path):
    """The two sharding flags are refused outside torchrun before any run
    directory is made (``tests/test_torch_sp.py`` and
    ``tests/test_torch_tp.py`` run them under torchrun).
    The sampling knobs once refused as not yet ported now run: 3 steps (model
    timesteps 999, 500, 0), with each network called as often as the flag says."""
    if flag in ("spatial_shard", "tensor_shard"):
        argv = ["--device", "cpu", "--model_path", "m.pt", "--classifier_path", "c.pt",
                "--main_path", str(tmp_path), f"--{flag}", value]
        with pytest.raises(SystemExit, match=f"{flag} {value}: launch under torchrun"):
            CS.main(argv)
        assert not os.listdir(tmp_path)
        return
    _random_pt(create_upstream_model(**CLI_UNET), tmp_path / "model.pt", 0)
    _random_pt(create_classifier(**CLI_CLASSIFIER), tmp_path / "classifier.pt", 1)
    out = CS.main(_cli_argv(tmp_path, f"--{flag}", value, "--main_path", str(tmp_path / "runs")))
    images = np.load(out["path"])["arr_0"]
    assert images.shape == (2, 64, 64, 3) and all(images[i].std() > 0 for i in range(2))
    want = {
        "guidance_interval": {"unet_full": 3, "unet_shallow": 0, "classifier": 1},  # only t = 500
        "guidance_cache": {"unet_full": 3, "unet_shallow": 0, "classifier": 2},  # steps 0 and 2
        "deep_cache": {"unet_full": 2, "unet_shallow": 1, "classifier": 3},
        "sampler": {"unet_full": 3, "unet_shallow": 0, "classifier": 3},
    }[flag]
    assert out["calls"] == want
    if flag in ("deep_cache", "sampler"):  # random weights give a gradient too small to show in uint8
        plain = np.load(CS.main(_cli_argv(tmp_path, "--main_path", str(tmp_path / "plain")))["path"])["arr_0"]
        assert (plain != images).any()
