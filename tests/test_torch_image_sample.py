"""``python -m guided_diffusion_clip_tpu_torch.image_sample`` (and ``.image_sample_repeat``,
``.image_nll``) against the JAX package, f32 on the CPU.

The chain that ``image_sample.make_chain`` builds from the CLI's flags is held
against the JAX library functions that scripts/image_sample.py composes for
the same flags (the loop from ``resolve_sampler``, ``cfg_model_fn``,
``cfg_cached_model_fn``, ``deep_cache_model_fn``, ``cfg_deep_cache_pair``), from
the same weights (``state_dict_from_flax``), conditioning and noise (the JAX
loop's own draws, handed to the port): 3-5 steps within 5e-4, as the port's
other chains. ``image_nll``'s bpd terms are held to the JAX script's
``run_bpd_evaluation`` on the same folder, weights and noise, within 1e-4.
The CLIs then run on the CPU from a checkpoint that the port's ``image_train``
wrote, reached through ``--main_path``, ``--f`` and ``--load_file``, and every
flag combination the JAX script refuses is refused with its message.
"""

import ast
import functools
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from guided_diffusion_clip_tpu.data import image_datasets as JData
from guided_diffusion_clip_tpu.diffusion import deep_cache as JD
from guided_diffusion_clip_tpu.diffusion import guidance as JGd
from guided_diffusion_clip_tpu.diffusion import sampling as JS
from guided_diffusion_clip_tpu.utils import logger as jlogger
from guided_diffusion_clip_tpu.utils import script_util as JSU
from guided_diffusion_clip_tpu_torch import image_nll, image_sample, image_sample_repeat, image_train
from guided_diffusion_clip_tpu_torch.data import image_datasets as TData
from guided_diffusion_clip_tpu_torch.diffusion.sampling import sample_seed
from guided_diffusion_clip_tpu_torch.utils import logger
from guided_diffusion_clip_tpu_torch.utils import script_util as TSU
from guided_diffusion_clip_tpu_torch.utils.checkpoint import load_model_weights
from torch_port_utils import clip_feat_pair, nchw, nhwc

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the fork's recipe, shrunk: CLIP conditioning, scale-shift, one head at 8 px
UNET = dict(image_size=16, in_channels=3, model_channels=32, out_channels=6, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_classes=512, num_heads=1,
            use_scale_shift_norm=True)
B = 2
SHAPE_J, SHAPE_T = (B, 16, 16, 3), (B, 3, 16, 16)
DIFFUSION = dict(steps=1000, noise_schedule="cosine", learn_sigma=True, timestep_respacing="5")
TINY = ["--image_size", "16", "--num_channels", "32", "--num_res_blocks", "1", "--channel_mult", "1,2",
        "--attention_resolutions", "8", "--num_heads", "1", "--learn_sigma", "True", "--class_cond", "True",
        "--diffusion_steps", "20", "--noise_schedule", "cosine"]


@functools.lru_cache(maxsize=None)
def _pair():
    return clip_feat_pair(UNET, seed=8)


def _cond():
    """A test-set batch's conditioning, as the loaders give it (NHWC for JAX,
    NCHW for the port), after ``add_delta_imgimg``."""
    rs = np.random.RandomState(9)
    feat = (rs.standard_normal((B, 512)) * 2).astype(np.float32)
    img2 = rs.uniform(-1, 1, SHAPE_J).astype(np.float32)
    jkw = {"clip_feat": jnp.asarray(feat), "img2": jnp.asarray(img2), "clip_feat2": jnp.asarray(feat[::-1].copy())}
    tkw = {"clip_feat": torch.from_numpy(feat), "img2": nchw(img2), "clip_feat2": torch.from_numpy(feat[::-1].copy())}
    return jkw, tkw


def _args(*flags):
    return image_sample.create_argparser().parse_args(["--batch_size", str(B), *flags])


def _jax_chain(args, key):
    """scripts/image_sample.py's ``run_chain`` for ``args``, composed from the
    JAX library functions it calls (f32: ``int8_emit`` has nothing to act on)."""
    jm, params, _ = _pair()
    diffusion = JSU.create_gaussian_diffusion(**DIFFUSION)
    loop = JSU.resolve_sampler(diffusion, args)
    dsp, T = int(args.denoise_start_point), diffusion.num_timesteps
    if dsp != -1:  # the script's mapping into the respaced chain
        dsp = min(int(round(dsp * T / diffusion.sched.original_num_steps)), T)
    null = {"clip_feat": 0.0}

    def model_fn(x, t, **kw):
        return jm.apply({"params": params}, x, t, **kw)

    def run(key, model_kwargs, init_image):
        common = dict(clip_denoised=args.clip_denoised, model_kwargs=model_kwargs, denoise_start_point=dsp,
                      init_image=init_image)
        zeros = (jnp.zeros(SHAPE_J), jnp.zeros((B,), jnp.int32))
        if args.deep_cache > 1:
            def cached_apply(x, t, **kw):
                return jm.apply({"params": params}, x, t, cache_cut=args.deep_cache_cut, **kw)

            if args.cfg_scale:
                full, shallow = JD.cfg_deep_cache_pair(cached_apply, args.cfg_scale, null)
            else:
                def full(x, t, **kw):
                    return cached_apply(x, t, cache_mode="full", **kw)

                def shallow(x, t, deep, **kw):
                    return cached_apply(x, t, deep_cache=deep, cache_mode="shallow", **kw)

            state0 = JD.zero_state(full, *zeros, **model_kwargs)
            return loop(JD.deep_cache_model_fn(full, shallow, args.deep_cache), SHAPE_J, key,
                        model_state0=state0, **common)
        interval = JGd.parse_guidance_interval(args.guidance_interval)
        if args.cfg_scale and args.cfg_cache > 1:
            fn = JGd.cfg_cached_model_fn(model_fn, args.cfg_scale, null, args.cfg_cache, interval=interval)
            return loop(fn, SHAPE_J, key, model_state0=JGd.cfg_cached_state0(model_fn, *zeros, **model_kwargs),
                        **common)
        if args.cfg_scale:
            return loop(JGd.cfg_model_fn(model_fn, args.cfg_scale, null, interval=interval), SHAPE_J, key, **common)
        return loop(model_fn, SHAPE_J, key, **common)

    jkw, _ = _cond()
    init = jkw["img2"] if dsp != -1 else None
    return np.asarray(jax.jit(run)(key, jkw, init)), dsp, diffusion.num_timesteps


def _jax_draws(key, steps):
    """The start noise and each step's noise that ``JS._scan_loop`` draws from
    ``key`` over ``steps`` steps, NCHW."""
    loop_rng, init_rng = jax.random.split(key, 2)
    start = nchw(np.asarray(JS._normal(init_rng, SHAPE_J, jnp.float32)))
    return start, [nchw(np.asarray(JS._normal(k, SHAPE_J, jnp.float32))) for k in jax.random.split(loop_rng, steps)]


@pytest.mark.parametrize("flags,forwards", [
    (["--use_ddim", "True"], {"unet_full": 5}),
    ([], {"unet_full": 5}),
    (["--cfg_scale", "3"], {"unet_full": 5}),  # one doubled batch a step
    (["--cfg_scale", "3", "--cfg_cache", "2", "--use_ddim", "True"], {"unet_full": 8}),
    (["--cfg_scale", "3", "--guidance_interval", "300,700", "--use_ddim", "True"], {"unet_full": 5}),
    (["--deep_cache", "2", "--use_ddim", "True"], {"unet_full": 3, "unet_shallow": 2}),
    (["--deep_cache", "2", "--cfg_scale", "3"], {"unet_full": 3, "unet_shallow": 2}),
    (["--denoise_start_point", "600"], {"unet_full": 3}),
    (["--sampler", "dpm++2m"], {"unet_full": 5}),
], ids=["ddim", "ancestral", "cfg", "cfg_cache", "cfg_interval", "deep_cache", "deep_cache_cfg",
        "denoise_start_point", "dpm++2m"])
def test_chain_matches_jax(flags, forwards):
    args = _args(*flags)
    key = jax.random.key(11)
    ref, dsp, T = _jax_chain(args, key)
    steps = T if dsp == -1 else dsp
    assert steps == (3 if "--denoise_start_point" in flags else 5)
    start, step_noise = _jax_draws(key, steps)
    _, _, tm = _pair()
    calls = {}
    run_chain = image_sample.make_chain(tm, TSU.create_gaussian_diffusion(**DIFFUSION), args, calls)
    _, tkw = _cond()
    with torch.inference_mode():
        ours = run_chain(B, tkw, None, tkw["img2"] if dsp != -1 else None, noise=start,
                         step_noise=None if "dpm++2m" in flags else step_noise)
    assert calls == forwards
    np.testing.assert_allclose(nhwc(ours), ref, rtol=5e-4, atol=5e-4)


def test_denoise_start_point_maps_into_the_respaced_chain():
    diffusion = TSU.create_gaussian_diffusion(steps=1000, noise_schedule="cosine", timestep_respacing="100")
    assert [image_sample.respaced_start(diffusion, v) for v in (-1, "None", "", None, 800, 1000, 5000, 3)] == [
        -1, -1, -1, -1, 80, 100, 100, 0]


def _jax_messages(script):
    """Every literal message of a ``raise SystemExit(...)`` in a JAX script."""
    with open(os.path.join(REPO, "scripts", script)) as f:
        tree = ast.parse(f.read())
    return {n.exc.args[0].value for n in ast.walk(tree) if isinstance(n, ast.Raise) and isinstance(n.exc, ast.Call)
            and getattr(n.exc.func, "id", "") == "SystemExit" and isinstance(n.exc.args[0], ast.Constant)}


@pytest.mark.parametrize("flags,cond", [
    (["--guidance_interval", "200,800"], "clip"),
    (["--guidance_interval", "200,800", "--cfg_scale", "2", "--deep_cache", "2"], "clip"),
    (["--cfg_cache", "2"], "clip"),
    (["--cfg_cache", "2", "--cfg_scale", "2", "--deep_cache", "2"], "clip"),
    (["--cfg_scale", "2"], "y"),
    (["--cfg_scale", "2"], "none"),
])
def test_refusals_carry_the_jax_messages(flags, cond):
    _, _, tm = _pair()
    kwargs = {"clip": {"clip_feat": torch.zeros(B, 512)}, "y": {"y": torch.zeros(B, dtype=torch.long)},
              "none": {}}[cond]
    with pytest.raises(SystemExit) as info:
        run_chain = image_sample.make_chain(tm, TSU.create_gaussian_diffusion(**DIFFUSION), _args(*flags))
        run_chain(B, kwargs, torch.Generator().manual_seed(0))
    assert str(info.value.code) in _jax_messages("image_sample.py")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny checkpoint that the port's image_train wrote (two steps and the
    save at step 2), and the folder it trained on with its CLIP dict."""
    root = tmp_path_factory.mktemp("sample_cli")
    imgs = root / "imgs"
    imgs.mkdir()
    rs = np.random.RandomState(0)
    clip = {}
    for i in range(6):
        name = f"img_{i:03d}.png"
        Image.fromarray(rs.randint(0, 255, (16, 16, 3), dtype=np.uint8)).save(imgs / name)
        clip[name] = rs.randn(2, 512).astype(np.float32)
    np.savez(root / "clip.npz", **clip)
    old = os.environ.get("DIFFUSION_TRAINING_TEST")
    os.environ["DIFFUSION_TRAINING_TEST"] = "1"
    try:
        image_train.main([*TINY, "--device", "cpu", "--data_dir", str(imgs), "--clip_file_path",
                          str(root / "clip.npz"), "--batch_size", "2", "--save_interval", "2",
                          "--log_interval", "1", "--val_batch_size", "2", "--main_path", str(root / "runs"),
                          "-d", "tiny"])
    finally:
        if old is None:
            del os.environ["DIFFUSION_TRAINING_TEST"]
        else:
            os.environ["DIFFUSION_TRAINING_TEST"] = old
        logger.reset()
    return root


def _sample_argv(root, *extra):
    return [*TINY, "--device", "cpu", "--main_path", str(root / "runs"), "--f", "tiny",
            "--load_file", "ema_0.9999_000002.pt", "--data_dir_test", str(root / "imgs"),
            "--clip_file_path_test", str(root / "clip.npz"), "--timestep_respacing", "4",
            "--batch_size", "3", "--num_samples", "5", *extra]


def test_image_sample_cli_from_an_image_train_checkpoint(trained):
    """``--main_path``/``--f``/``--load_file`` reach the EMA checkpoint, the
    run directory goes under ``--sub_dir_tstsave``, and the npz holds the
    uint8 samples of the chains that ``make_chain`` gives for each batch of
    the test set with the generator of ``sample_seed(seed, batch)``."""
    out = image_sample.main(_sample_argv(trained, "--sub_dir_tstsave", "tst", "--seed", "4", "-d", "cli"))
    logger.reset()
    run_dir = os.path.dirname(out["path"])
    assert os.path.dirname(run_dir) == str(trained / "runs" / "tst") and run_dir.endswith("_cli")
    assert {"samples_test0.png", "samples_test1.png", "target_0.png", "target_1.png",
            "samples_5x16x16x3.npz", "log.txt"} <= set(os.listdir(run_dir))
    assert out["batches"] == 2 and out["steps"] == 4 and out["calls"] == {"unet_full": 8, "unet_shallow": 0}
    arr = np.load(out["path"])["arr_0"]
    assert arr.shape == (5, 16, 16, 3) and arr.dtype == np.uint8

    args = image_sample.create_argparser().parse_args(_sample_argv(trained, "--seed", "4"))
    TSU.load_folder_path_parse(args)
    assert args.model_path.endswith(os.path.join("_tiny", "ema_0.9999_000002.pt"))
    model, diffusion = TSU.create_model_and_diffusion(**TSU.args_to_dict(args, TSU.model_and_diffusion_defaults()))
    load_model_weights(model, args.model_path)
    run_chain = image_sample.make_chain(model.eval(), diffusion, args)
    data = TData.load_data(data_dir=str(trained / "imgs"), batch_size=3, image_size=16, class_cond=True,
                           deterministic=True, random_flip=False, clip_file_path=str(trained / "clip.npz"),
                           prefetch=0)
    want = []
    for i in range(2):
        _, kw = next(data)
        with torch.inference_mode():
            s = run_chain(3, {k: torch.from_numpy(v) for k, v in kw.items()},
                          torch.Generator().manual_seed(sample_seed(4, i)))
        want.append(((nhwc(s) + 1) * 127.5).clip(0, 255).astype(np.uint8))
    np.testing.assert_array_equal(arr, np.concatenate(want)[:5])
    grid = np.asarray(Image.open(os.path.join(run_dir, "samples_test1.png")))
    assert grid.shape == (2 + 3 * 18, 2 + 18, 3)  # 3 samples in one column, 2 px padding


def test_image_sample_int8_and_the_knobs_run(trained, tmp_path):
    """``--conv_impl int8`` with CFG and its cache, and DeepCache from
    ``--denoise_start_point``: finite uint8 samples."""
    for extra in (["--conv_impl", "int8", "--cfg_scale", "3", "--cfg_cache", "2"],
                  ["--deep_cache", "2", "--denoise_start_point", "500", "--use_ddim", "True"]):
        out = image_sample.main(_sample_argv(trained, "--main_path", str(tmp_path), "--model_path",
                                             str(next((trained / "runs").glob("*_tiny")) / "model000002.pt"),
                                             "--f", "", *extra))
        logger.reset()
        assert np.load(out["path"])["arr_0"].shape == (5, 16, 16, 3)


def test_image_sample_repeat_makes_a_run_directory_each(trained, tmp_path):
    outs = image_sample_repeat.main(_sample_argv(trained, "--main_path", str(tmp_path), "--model_path",
                                                 str(next((trained / "runs").glob("*_tiny")) / "ema_0.9999_000002.pt"),
                                                 "--f", "", "--repeats", "2", "--seed", "3", "-d", "sweep"))
    dirs = sorted(os.listdir(tmp_path))
    assert len(dirs) == 2 and dirs[0].endswith("_sweep_rep0") and dirs[1].endswith("_sweep_rep1")
    a, b = (np.load(o["path"])["arr_0"] for o in outs)
    assert a.shape == b.shape == (5, 16, 16, 3) and not np.array_equal(a, b)  # seeds 3 and 4


@pytest.mark.parametrize("flags,message", [
    (["--spatial_shard", "2"], "--spatial_shard: not yet ported"),
    (["--tensor_shard", "2"], "--tensor_shard: not yet ported"),
    (["--conv_impl", "fp8"], "--conv_impl 'fp8'"),
    (["--model_path", "ema_0.9999_505000.flax", "--f", ""], "save_pt_copy"),
])
def test_cli_refuses(trained, tmp_path, flags, message):
    with pytest.raises(SystemExit, match=message):
        image_sample.main(_sample_argv(trained, "--main_path", str(tmp_path), *flags))
    assert not os.listdir(tmp_path)


def test_image_sample_config_names_a_flax_file_and_is_refused(tmp_path):
    """configs/image_sample_config.yaml (the recipe's sampler: batch 8, 100
    respaced steps) names a ``.flax`` load_file: the port reads ``.pt`` only,
    and says how to convert it. Its main_path is pointed at a folder here."""
    import yaml

    with open(os.path.join(REPO, "configs", "image_sample_config.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert cfg["load_file"].endswith(".flax")
    (tmp_path / "runs" / "261017_000000_recipe").mkdir(parents=True)
    cfg.update(main_path=str(tmp_path / "runs"), f="recipe")
    with open(tmp_path / "sample.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    args = TSU.parse_yaml(image_sample.create_argparser().parse_args(["--config-file", str(tmp_path / "sample.yaml")]))
    assert (args.image_size, args.num_channels, args.batch_size, args.timestep_respacing) == (128, 64, 8, 100)
    # an int respacing is one section of that many steps (the JAX package raises TypeError on it)
    assert TSU.create_gaussian_diffusion(steps=1000, timestep_respacing=100).num_timesteps == 100
    assert (TSU.create_gaussian_diffusion(steps=1000, timestep_respacing=100).sched.timestep_map.tolist()
            == TSU.create_gaussian_diffusion(steps=1000, timestep_respacing="100").sched.timestep_map.tolist())
    with pytest.raises(SystemExit, match="save_pt_copy"):
        image_sample.main(["--config-file", str(tmp_path / "sample.yaml"), "--device", "cpu"])
    assert os.listdir(tmp_path / "runs") == ["261017_000000_recipe"]


def test_missing_card_is_an_error(trained, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = [a for a in _sample_argv(trained, "--main_path", str(tmp_path)) if a not in ("--device", "cpu")]
    for main in (image_sample.main, image_nll.main):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(argv if main is image_sample.main else [*TINY, "--model_path", "m.pt"])


def test_image_nll_terms_match_the_jax_script(trained, tmp_path):
    """``image_nll.run_bpd_evaluation`` on two batches of the folder against
    the JAX script's ``run_bpd_evaluation`` with the same weights (the port's
    checkpoint, read by the JAX package) and the same noise."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        jnll = importlib.import_module("image_nll")
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    from guided_diffusion_clip_tpu.utils.checkpoint import init_template, load_params

    ckpt = str(next((trained / "runs").glob("*_tiny")) / "ema_0.9999_000002.pt")
    flags = dict(image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2", attention_resolutions="8",
                 num_heads=1, learn_sigma=True, class_cond=True, diffusion_steps=6, noise_schedule="cosine")
    jm, jdiff = JSU.create_model_and_diffusion(**{**JSU.model_and_diffusion_defaults(), **flags})
    template = init_template(jm, jnp.zeros((2, 16, 16, 3)), jnp.zeros((2,)), clip_feat=jnp.zeros((2, 512)))
    params = load_params(ckpt, template)
    data_kw = dict(data_dir=str(trained / "imgs"), batch_size=2, image_size=16, class_cond=True, deterministic=True,
                   clip_file_path=str(trained / "clip.npz"), prefetch=0)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jlogger.configure_dir(dir=str(jdir), format_strs=[])

    def make_model_fn(p):
        return lambda x, t, **kw: jm.apply({"params": p}, x, t, **kw)

    jnll.run_bpd_evaluation(make_model_fn, params, jdiff, JData.load_data(**data_kw), 4, True)

    model, diffusion = TSU.create_model_and_diffusion(**{**TSU.model_and_diffusion_defaults(), **flags})
    load_model_weights(model, ckpt)
    rng, noise = jax.random.key(0), []
    for _ in range(2):  # the JAX script's split a batch, then calc_bpd_loop's fold_in a t
        rng, bpd_rng = jax.random.split(rng)
        noise.append([nchw(np.asarray(jax.random.normal(jax.random.fold_in(bpd_rng, t), (2, 16, 16, 3))))
                      for t in range(6)])
    logger.configure_dir(str(tdir), format_strs=[])
    out = image_nll.run_bpd_evaluation(model.eval(), diffusion, TData.load_data(**data_kw), 4, True, noise=noise)
    logger.reset()
    assert out["samples"] == 4 and len(out["bpd"]) == 2
    for name in ("vb", "mse", "xstart_mse"):
        ours, ref = (np.load(d / f"{name}_terms.npz")["arr_0"] for d in (tdir, jdir))
        assert ours.shape == ref.shape == (6,)
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6, err_msg=name)


def test_image_nll_cli(trained, tmp_path):
    ckpt = str(next((trained / "runs").glob("*_tiny")) / "model000002.pt")
    out = image_nll.main([*TINY, "--device", "cpu", "--model_path", ckpt, "--data_dir", str(trained / "imgs"),
                          "--clip_file_path", str(trained / "clip.npz"), "--batch_size", "2", "--num_samples", "3",
                          "--main_path", str(tmp_path), "--timestep_respacing", "5"])
    logger.reset()
    (run,) = os.listdir(tmp_path)
    assert {"vb_terms.npz", "mse_terms.npz", "xstart_mse_terms.npz"} <= set(os.listdir(tmp_path / run))
    assert out["samples"] == 4 and all(np.isfinite(b) and b > 0 for b in out["bpd"])
    assert np.load(tmp_path / run / "vb_terms.npz")["arr_0"].shape == (5,)
