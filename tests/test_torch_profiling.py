"""``--profile_dir`` in the port (``utils/profiling.py``, on ``torch.profiler``):
``StepProfiler``'s window (step 0 skipped, ``num_steps`` traced), and a trace
written by ``TrainLoop.run_loop`` with its ``data``, ``train_step`` and
``val_sample`` scopes, and by ``image_sample``, as tests/test_profiling.py
asks of the JAX loop."""

import glob
import json
import os

import numpy as np
import torch

from guided_diffusion_clip_tpu_torch import image_sample
from guided_diffusion_clip_tpu_torch.models.unet import UNetConfig, UNetModel
from guided_diffusion_clip_tpu_torch.training.train_loop import TrainLoop
from guided_diffusion_clip_tpu_torch.utils import logger
from guided_diffusion_clip_tpu_torch.utils.profiling import StepProfiler, annotate
from guided_diffusion_clip_tpu_torch.utils.script_util import create_gaussian_diffusion, create_model

torch.set_num_threads(2)


def _traces(profile_dir):
    return glob.glob(os.path.join(profile_dir, "**", "*.pt.trace.json"), recursive=True)


def _names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_window_skips_step_0_and_traces_num_steps(tmp_path):
    prof = StepProfiler(str(tmp_path), first_step=1, num_steps=2)
    for step in range(5):
        prof.maybe_start(step)
        with prof.step_scope(step), annotate(f"work{step}"):
            torch.ones(8, 8) @ torch.ones(8, 8)
        prof.maybe_stop(step)
    prof.stop()
    (trace,) = _traces(str(tmp_path))
    names = _names(trace)
    assert {"step#1", "step#2", "work1", "work2"} <= names
    assert not {"step#0", "step#3", "work0", "work3", "work4"} & names


def test_no_profile_dir_does_nothing(tmp_path):
    prof = StepProfiler("", first_step=0, num_steps=1)
    prof.maybe_start(0)
    with prof.step_scope(0):
        pass
    prof.maybe_stop(0)
    prof.stop()
    assert prof.profile_dir is None and not os.listdir(tmp_path)


def test_train_loop_writes_a_trace(tmp_path, monkeypatch):
    logger.configure_dir(str(tmp_path / "logs"), format_strs=[])
    cfg = UNetConfig(image_size=8, in_channels=3, model_channels=32, out_channels=3, num_res_blocks=1,
                     attention_resolutions=(), channel_mult=(1,), num_classes=None, num_heads=2)

    def gen():
        rs = np.random.RandomState(0)
        while True:
            yield rs.uniform(-1, 1, (4, 3, 8, 8)).astype(np.float32), {}

    def val():
        while True:
            yield np.zeros((2, 3, 8, 8), np.float32), {}

    loop = TrainLoop(model=UNetModel(cfg), diffusion=create_gaussian_diffusion(steps=4, noise_schedule="cosine"),
                     data=gen(), batch_size=4, microbatch=4, lr=1e-4, ema_rate="0.9999", log_interval=1,
                     save_interval=2, profile_dir=str(tmp_path / "trace"), val_datasets=[val()])
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    loop.run_loop()
    # the window (steps 1-3) is open at the save of step 2, whose val_sample ends the run
    (trace,) = _traces(str(tmp_path / "trace"))
    assert {"step#1", "step#2", "data", "train_step", "val_sample"} <= _names(trace)
    assert "step#0" not in _names(trace)


def test_image_sample_writes_a_trace_of_its_second_batch(tmp_path):
    from PIL import Image

    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rs = np.random.RandomState(1)
    clip = {}
    for i in range(4):
        Image.fromarray(rs.randint(0, 255, (16, 16, 3), dtype=np.uint8)).save(imgs / f"{i}.png")
        clip[f"{i}.png"] = rs.randn(2, 512).astype(np.float32)
    np.savez(tmp_path / "clip.npz", **clip)
    flags = dict(image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2", attention_resolutions="8",
                 num_heads=1, learn_sigma=True, class_cond=True, use_scale_shift_norm=True)
    torch.save(create_model(**flags).state_dict(), tmp_path / "model.pt")
    argv = ["--device", "cpu", "--model_path", str(tmp_path / "model.pt"), "--data_dir_test", str(imgs),
            "--clip_file_path_test", str(tmp_path / "clip.npz"), "--batch_size", "2", "--num_samples", "4",
            "--diffusion_steps", "10", "--timestep_respacing", "3", "--noise_schedule", "cosine",
            "--main_path", str(tmp_path / "runs"), "--profile_dir", str(tmp_path / "trace")]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    out = image_sample.main(argv)
    logger.reset()
    assert out["batches"] == 2
    (trace,) = _traces(str(tmp_path / "trace"))
    assert {"step#1", "sample_chain"} <= _names(trace) and "step#0" not in _names(trace)
