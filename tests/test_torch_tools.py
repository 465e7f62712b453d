"""The port's measuring tools on the CPU at tiny sizes, through their
environment variables: ``train_step_bench``, ``perf_breakdown``,
``serve_bench`` and ``block_microbench`` (``guided_diffusion_clip_tpu_torch/
tools/``). Each ``main()`` prints one JSON line with the JAX tool's keys and
``card``; on the CPU it reports times but no rate. The steps they time are
held to the port's own composition: the train step to ``TrainLoop.run_step``,
the guided step to ``p_sample_step`` with ``cond_fn``. Without a card and
without ``--device cpu`` every tool exits non-zero."""

import json

import numpy as np
import pytest
import torch

from guided_diffusion_clip_tpu_torch.diffusion import sampling as S
from guided_diffusion_clip_tpu_torch.diffusion.guidance import classifier_cond_fn
from guided_diffusion_clip_tpu_torch.tools import block_microbench, perf_breakdown, serve_bench, train_step_bench
from guided_diffusion_clip_tpu_torch.training.train_loop import TrainLoop
from guided_diffusion_clip_tpu_torch.utils import logger
from guided_diffusion_clip_tpu_torch.utils.script_util import create_gaussian_diffusion, create_model

torch.set_num_threads(2)

# the keys of the JAX tools' JSON lines
JAX_KEYS = {
    # tools/train_step_bench.py:144-150
    "train_step_bench": {"config", "ms_per_step", "samples_per_sec_per_chip", "compile_sec", "window_steps"},
    # tools/perf_breakdown.py:176-200
    "perf_breakdown": {"batch", "attention_impl", "unet_fwd_ms", "cls_fwd_ms", "cls_grad_ms", "full_step_ms",
                       "per_sample_step_ms", "proj_samples_per_min_250"},
    # tools/serve_bench.py:194-211, without coalescing or buckets
    "serve_bench": {"config", "compile_to_healthy_s", "first_request_s", "warm_latency_best_s",
                    "warm_latency_median_s", "sustained_sec_per_request", "requests_per_min", "samples_per_min",
                    "known_limit"},
    # tools/block_microbench.py:90-105
    "block_microbench": {"shape", "bf16_block_ms", "int8_block_ms", "gn_only_ms", "gnq_only_ms", "conv_bf16_tfs",
                         "conv_int8_tfs"},
}
TSB_TINY = {"TSB_CONFIG": "fork128", "TSB_IMAGE_SIZE": "64", "TSB_CH": "32", "TSB_BATCH": "2",
            "TSB_REPEATS": "1", "TSB_WINDOW": "1"}
BD_TINY = {"BD_IMAGE_SIZE": "64", "BD_CH": "64", "BD_CLF_CH": "64", "BD_REPS": "1"}


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def setenv(monkeypatch, env: dict) -> None:
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def test_train_step_bench_on_cpu(monkeypatch, capsys):
    setenv(monkeypatch, TSB_TINY)
    row = train_step_bench.main(["--device", "cpu"])
    assert set(row) == JAX_KEYS["train_step_bench"] | {"card", "flops_per_step", "model_tflops_per_s",
                                                       "device_ms_per_step"}
    assert last_json(capsys) == row
    assert row["card"] == "cpu" and row["samples_per_sec_per_chip"] is None and row["model_tflops_per_s"] is None
    assert row["device_ms_per_step"] is None
    assert row["ms_per_step"] > 0 and row["compile_sec"] > 0 and row["window_steps"] == 1
    assert row["flops_per_step"] == train_step_bench.step_flops(train_step_bench.settings()) > 1e9
    assert row["config"] == "64px fork recipe (ch32, clip_feat cond) train step, batch 2 (micro 2), bf16"


def test_train_step_bench_steps_as_run_step(monkeypatch):
    """One step of the tool's window moves the parameters and the EMA as one
    ``TrainLoop.run_step`` of the recipe's model (built here from
    ``create_model``) from the same weights and batch."""
    setenv(monkeypatch, TSB_TINY)
    s = train_step_bench.settings()
    logger.configure_dir(format_strs=[])
    loop = train_step_bench.make_loop(s, torch.device("cpu"), s["batch"], s["micro"])
    ref_model = create_model(
        image_size=64, num_channels=32, num_res_blocks=2, learn_sigma=True, class_cond=True,
        attention_resolutions="16,8", num_heads=1, use_scale_shift_norm=True, use_fp16=True)
    ref_model.load_state_dict(loop.model.state_dict())
    ref = TrainLoop(model=ref_model, diffusion=create_gaussian_diffusion(steps=1000, learn_sigma=True,
                                                                         noise_schedule="cosine"),
                    data=None, batch_size=2, microbatch=-1, lr=1e-4, ema_rate="0.9999", log_interval=10**9,
                    save_interval=10**9)
    before = [p.detach().clone() for p in loop.params]
    batch = train_step_bench.make_batch(s, 2, np.random.RandomState(0))
    train_step_bench.run_window(loop, iter([batch]), 1, torch.device("cpu"))
    ref.run_step(*batch)
    assert loop.names == ref.names
    assert any(not torch.equal(p, b) for p, b in zip(loop.params, before))
    for p, q in zip(loop.params, ref.params):
        assert torch.equal(p, q)
    for e, f in zip(loop.ema_params[0], ref.ema_params[0]):
        assert torch.equal(e, f)


def test_perf_breakdown_on_cpu(monkeypatch, capsys):
    setenv(monkeypatch, BD_TINY)
    row = perf_breakdown.main(["1", "--device", "cpu"])
    assert set(row) == JAX_KEYS["perf_breakdown"] | {"card", *perf_breakdown.DEVICE_KEYS.values()}
    assert last_json(capsys) == row
    assert row["batch"] == 1 and row["card"] == "cpu" and row["proj_samples_per_min_250"] is None
    assert all(row[k] is None for k in perf_breakdown.DEVICE_KEYS.values())
    assert all(row[k] > 0 for k in perf_breakdown.PARTS)
    assert row["per_sample_step_ms"] == row["full_step_ms"]
    monkeypatch.setenv("BD_ONLY", "unet")
    row = perf_breakdown.main(["1", "--device", "cpu"])
    assert "unet_fwd_ms" in row and "full_step_ms" not in row and "per_sample_step_ms" not in row
    assert "unet_fwd_device_ms" in row and "full_step_device_ms" not in row


def test_perf_breakdown_full_step_is_the_guided_step():
    """The timed full step computes what ``p_sample_step`` with the
    classifier's ``cond_fn`` gives at the same injected noise; the timed
    gradient part is that ``cond_fn``, non-zero (with N(0, 0.02) weights it
    is ~4e-9, below the mean's f32 resolution, so the step cannot show it)."""
    step = perf_breakdown.build_step(2, 64, "auto", 64, 64, torch.device("cpu"))
    noise = torch.from_numpy(np.random.RandomState(4).standard_normal((2, 3, 64, 64)).astype(np.float32))
    cond_fn = classifier_cond_fn(step.classifier, 1.0)
    with torch.no_grad():
        want, _ = S.p_sample_step(step.sched, lambda x, t, y=None: step.model(x, t, y=y), step.x, step.t, None,
                                  cfg=step.cfg, noise=noise, cond_fn=cond_fn, model_kwargs={"y": step.y})
        grad = cond_fn(step.x, step.sched.model_timesteps(step.t), y=step.y)
    assert torch.equal(step.full_step(noise), want)
    assert torch.equal(step.parts["cls_grad_ms"](), grad) and float(grad.abs().max()) > 0
    assert step.parts["full_step_ms"] is step.full_step


def test_serve_bench_on_cpu(monkeypatch, capsys, tmp_path):
    """A tiny server subprocess (64 px, 64 channels, two DDIM steps, int8)
    answers the warm-up request, one timed and one back-to-back request, and
    is stopped; its last /healthz counts its forwards."""
    setenv(monkeypatch, {"SB_IMAGE_SIZE": "64", "SB_CH": "64", "SB_BATCH": "1", "SB_RESPACING": "ddim2",
                         "SB_REQUESTS": "1", "SB_CKPT_DIR": str(tmp_path)})
    out = serve_bench.main(["--device", "cpu"])
    row = last_json(capsys)
    assert set(row) == JAX_KEYS["serve_bench"] | {"card"}
    assert {k: v for k, v in out.items() if k != "server"} == row
    assert row["card"] == "cpu" and row["requests_per_min"] is None and row["warm_latency_best_s"] > 0
    server = out["server"]
    # two warm-up chains at start, then three requests, each a chain of two steps
    assert server["dispatches"] == 5 and server["forwards"] == 10
    assert set(server["kernel_launches"].values()) == {0}
    assert (tmp_path / "serve_bench_ckpt_64_64.pt").exists()


def test_serve_bench_reports_a_server_that_dies(monkeypatch, tmp_path):
    setenv(monkeypatch, {"SB_IMAGE_SIZE": "64", "SB_CH": "64", "SB_CONV_IMPL": "no_such_impl",
                         "SB_CKPT_DIR": str(tmp_path)})
    (tmp_path / "serve_bench_ckpt_64_64.pt").write_bytes(b"")  # never read: the server dies on its flags first
    with pytest.raises(SystemExit, match="server died rc=1(.|\n)*no_such_impl"):
        serve_bench.main(["--device", "cpu"])


def test_block_microbench_on_cpu(monkeypatch, capsys):
    setenv(monkeypatch, {"BMB_SHAPES": "1x8x64x64,2x16x32x64", "CMB_ITERS": "1"})
    rows = block_microbench.main(["--device", "cpu"])
    assert last_json(capsys) == rows
    assert [r["shape"] for r in rows] == ["B1 8x8 64->64", "B2 16x16 32->64"]
    for row in rows:
        assert set(row) == JAX_KEYS["block_microbench"] | {"card"}
        assert row["card"] == "cpu" and row["conv_bf16_tfs"] is None and row["conv_int8_tfs"] is None
        assert all(row[k] > 0 for k in row if k.endswith("_ms"))
    assert block_microbench.SHAPES == [(16, 64, 512, 512), (16, 128, 256, 256), (16, 256, 256, 256),
                                       (16, 32, 512, 512)]


def test_block_microbench_rows_run_the_int8_and_bf16_paths():
    """The two blocks compute the same GroupNorm+SiLU -> conv within the int8
    path's error (per-image activations, per-channel weights)."""
    x, gamma, beta, conv, conv_bf16 = block_microbench.make_block(1, 8, 64, 64, torch.device("cpu"))
    fns = block_microbench.rows_of(x, gamma, beta, conv, conv_bf16)
    with torch.no_grad():
        a, b = fns["bf16_block"]().float(), fns["int8_block"]()
        q = fns["gnq_only"]()
    assert q.dtype == torch.int8 and a.shape == b.shape == (1, 64, 8, 8)
    assert float((a - b).norm() / a.norm()) < 2e-2


@pytest.mark.parametrize("tool", [train_step_bench, perf_breakdown, serve_bench, block_microbench],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tools_need_a_card_unless_told_otherwise(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device") as e:
        tool.main([])
    assert e.value.code != 0
