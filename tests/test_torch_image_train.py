"""The port's data pipeline and ``python -m guided_diffusion_clip_tpu_torch.image_train``.

The loader against the JAX package's on the same folder (the port's batches
NCHW, the JAX loader's NHWC): deterministic, and shuffled with random crops
and flips from the same seed (both draw from Python's ``random``). The CLI
on the CPU at a tiny size on a generated folder, as
tests/test_scripts_e2e.py's ``dataset`` fixture builds one, with
``--train_conv_impl int8``, ``--profile_dir`` and the native loader, and each
flag that is not yet ported refused.
"""

import csv
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from guided_diffusion_clip_tpu.data import image_datasets as JD
from guided_diffusion_clip_tpu_torch import image_train
from guided_diffusion_clip_tpu_torch.data import image_datasets as TD
from guided_diffusion_clip_tpu_torch.utils.checkpoint import load_model_weights
from guided_diffusion_clip_tpu_torch.utils.script_util import create_model, parse_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = [
    "--image_size", "16", "--num_channels", "32", "--num_res_blocks", "1", "--channel_mult", "1,2",
    "--attention_resolutions", "8", "--num_heads", "1", "--learn_sigma", "True", "--class_cond", "True",
    "--diffusion_steps", "20", "--noise_schedule", "cosine",
]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """16 PNGs of mixed sizes (one in a subfolder) and their flip-indexed
    CLIP dict, as .npz and as .pt."""
    root = tmp_path_factory.mktemp("data")
    img_dir = root / "imgs"
    (img_dir / "sub").mkdir(parents=True)
    rs = np.random.RandomState(0)
    clip = {}
    for i in range(16):
        name = f"img_{i:03d}.png"
        h, w = (16, 16) if i % 3 else (24 + i, 40 - i)
        Image.fromarray(rs.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(
            img_dir / ("sub" if i == 7 else "") / name)
        clip[name] = rs.randn(2, 512).astype(np.float32)
    np.savez(root / "clip.npz", **clip)
    torch.save({k: torch.from_numpy(v) for k, v in clip.items()}, root / "clip.pt")
    return str(img_dir), str(root / "clip.npz"), str(root / "clip.pt")


@pytest.mark.parametrize("deterministic,random_crop", [(True, False), (False, False), (False, True)])
def test_load_data_matches_jax(dataset, deterministic, random_crop):
    img_dir, clip_npz, clip_pt = dataset
    kw = dict(data_dir=img_dir, batch_size=4, image_size=16, class_cond=True, deterministic=deterministic,
              random_crop=random_crop, seed=5)
    ours = TD.load_data(clip_file_path=clip_pt, prefetch=0, **kw)
    theirs = JD.load_data(clip_file_path=clip_npz, prefetch=0, **kw)
    for _ in range(6):  # one and a half epochs
        (x, c), (jx, jc) = next(ours), next(theirs)
        assert x.shape == (4, 3, 16, 16) and x.dtype == np.float32
        np.testing.assert_array_equal(x, jx.transpose(0, 3, 1, 2))
        assert sorted(c) == sorted(jc) == ["clip_feat", "clip_feat2", "img2"]
        np.testing.assert_array_equal(c["img2"], jc["img2"].transpose(0, 3, 1, 2))
        for k in ("clip_feat", "clip_feat2"):
            np.testing.assert_array_equal(c[k], jc[k])


def test_config_yaml_is_the_recipe():
    """``--config-file configs/config.yaml`` gives the fork's 128 px recipe,
    its keys over the command line's."""
    args = image_train.create_argparser().parse_args(
        ["--config-file", os.path.join(REPO, "configs", "config.yaml"), "--image_size", "64", "--lr_anneal_steps", "7"])
    args = parse_yaml(args)
    assert (args.image_size, args.num_channels, args.num_res_blocks, args.num_heads) == (128, 64, 2, 1)
    assert args.learn_sigma and args.class_cond and args.use_fp16
    assert (args.noise_schedule, args.diffusion_steps, args.lr, args.batch_size) == ("cosine", 1000, 1e-4, 48)
    assert args.lr_anneal_steps == 7 and args.device == "cuda" and args.weight_decay == 0.0


def _run(argv, env_extra=None, timeout=600):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "guided_diffusion_clip_tpu_torch.image_train", *argv],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout)


def test_image_train_cli(dataset, tmp_path):
    """Two steps and the first save (``DIFFUSION_TRAINING_TEST=1``): the three
    checkpoints, a validation grid for each folder and ``progress.csv`` with
    finite losses; the model checkpoint loads strict=True into a sampler model."""
    img_dir, clip_npz, _ = dataset
    proc = _run([*TINY, "--device", "cpu", "--data_dir", img_dir, "--clip_file_path", clip_npz,
                 "--data_dir_test", img_dir, "--clip_file_path_test", clip_npz, "--batch_size", "4",
                 "--save_interval", "2", "--log_interval", "1", "--val_batch_size", "4",
                 "--main_path", str(tmp_path), "-d", "tiny"],
                {"DIFFUSION_TRAINING_TEST": "1", "OPENAI_LOG_FORMAT": "stdout,log,csv"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    (run,) = os.listdir(tmp_path)
    assert run.endswith("_tiny")
    files = set(os.listdir(tmp_path / run))
    assert {"model000002.pt", "ema_0.9999_000002.pt", "opt000002.pt", "log.txt", "progress.csv",
            "val_samples_0_000002.png", "val_samples_1_000002.png", "val_targets_0_000002.png"} <= files
    with open(tmp_path / run / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [0, 1, 2]
    assert all(math.isfinite(float(r["loss"])) and float(r["loss"]) > 0 for r in rows)
    grid = np.asarray(Image.open(tmp_path / run / "val_samples_0_000002.png"))
    assert grid.shape == (38, 38, 3)  # 2 x 2 samples of 16 px, 2 px padding
    kw = dict(image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2", attention_resolutions="8",
              num_heads=1, learn_sigma=True, class_cond=True, use_scale_shift_norm=True)
    load_model_weights(create_model(**kw), str(tmp_path / run / "model000002.pt"))
    opt = torch.load(tmp_path / run / "opt000002.pt", weights_only=True)
    assert opt["count"] == 3 and sorted(opt) == ["count", "m", "v"]


def test_image_train_cli_int8_native_loader_profiled(dataset, tmp_path, monkeypatch):
    """``--train_conv_impl int8``, ``--profile_dir`` and ``GDC_NATIVE_LOADER=1``
    together: the forwards go through the int8 convs (K5's plain version on
    the CPU), the images through the native library, and the trace is written."""
    from guided_diffusion_clip_tpu_torch.data import native_loader
    from guided_diffusion_clip_tpu_torch.ops import quant as Q
    from guided_diffusion_clip_tpu_torch.utils import logger

    calls = {"conv_s8": 0, "native": 0}

    def counted(fn, key):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(Q, "conv_s8_plain", counted(Q.conv_s8_plain, "conv_s8"))
    monkeypatch.setattr(native_loader, "process_batch", counted(native_loader.process_batch, "native"))
    monkeypatch.setenv("GDC_NATIVE_LOADER", "1")
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    monkeypatch.setenv("OPENAI_LOG_FORMAT", "log,csv")
    img_dir, clip_npz, _ = dataset
    try:
        image_train.main([*TINY, "--device", "cpu", "--data_dir", img_dir, "--clip_file_path", clip_npz,
                          "--batch_size", "4", "--save_interval", "2", "--log_interval", "1", "--val_batch_size", "4",
                          "--main_path", str(tmp_path / "runs"), "--train_conv_impl", "int8",
                          "--profile_dir", str(tmp_path / "prof")])
    finally:
        logger.reset()
    (run,) = os.listdir(tmp_path / "runs")
    files = set(os.listdir(tmp_path / "runs" / run))
    assert {"model000002.pt", "ema_0.9999_000002.pt", "val_samples_0_000002.png"} <= files
    with open(tmp_path / "runs" / run / "progress.csv") as f:
        assert all(math.isfinite(float(r["loss"])) for r in csv.DictReader(f))
    # 3 steps and the validation chain of the save, each forward 25 convs
    assert calls["conv_s8"] >= 3 * 25 and calls["native"] >= 3 * 4
    assert [n for n in os.listdir(tmp_path / "prof") if n.endswith(".pt.trace.json")]


def test_unknown_train_conv_impl_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="choose from auto, xla, int8"):
        image_train.main([*TINY, "--device", "cpu", "--data_dir", "x", "--main_path", str(tmp_path),
                          "--train_conv_impl", "fp8"])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("argv,env", [
    (["--param_sharding", "fsdp"], {}), (["--opt_impl", "zero1"], {}),
    (["--spatial_shard", "2"], {}), (["--tensor_shard", "2"], {}), (["--ckpt_backend", "orbax"], {}),
])
def test_unported_flags_are_refused(argv, env, tmp_path, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match="not yet ported"):
        image_train.main([*TINY, "--device", "cpu", "--data_dir", "x", "--main_path", str(tmp_path), *argv])
    assert not os.listdir(tmp_path)


def test_missing_card_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        image_train.main([*TINY, "--data_dir", "x", "--main_path", str(tmp_path)])
