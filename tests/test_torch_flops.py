"""The port's FLOP accounting (guided_diffusion_clip_tpu_torch/utils/flops.py)
against the JAX package's (utils/flops.py), on the CPU.

The count is ``FlopCounterMode``'s, 2 operations a multiply-add of every
product and conv the call dispatches. XLA's cost model counts the same
products but leaves out a conv's taps that fall on its zero padding, and adds
the elementwise work, so the port's count of a UNet forward lies above XLA's
by about the padding's share: 1.089 at 16 px, where a 3x3 conv's taps are
(48/46)^2 = 1.089 times those inside the image, and 1.052 at 32 px. The band [1.0, 1.15] holds both
readings and would catch a product counted twice or missed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guided_diffusion_clip_tpu.utils import flops as jax_flops
from guided_diffusion_clip_tpu_torch.models.clip_models import UNetModel_clip_feat
from guided_diffusion_clip_tpu_torch.models.nn import Conv1x1
from guided_diffusion_clip_tpu_torch.models.unet import AttentionBlock, UNetConfig
from guided_diffusion_clip_tpu_torch.tools import train_step_bench as tsb
from guided_diffusion_clip_tpu_torch.training.train_loop import TrainLoop
from guided_diffusion_clip_tpu_torch.utils import flops
from guided_diffusion_clip_tpu_torch.utils import logger
from guided_diffusion_clip_tpu_torch.utils.script_util import create_gaussian_diffusion
from torch_port_utils import clip_feat_pair, nchw

torch.set_num_threads(2)

# the recipe (configs/config.yaml) shrunk: one head at ds 2, scale-shift, learned sigma
SMALL = dict(image_size=16, in_channels=3, model_channels=32, out_channels=6, num_res_blocks=1,
             attention_resolutions=(2,), channel_mult=(1, 2), num_classes=512, num_heads=1,
             use_scale_shift_norm=True)
# wider, with attention at two levels in 64-channel heads
WIDER = dict(image_size=32, in_channels=3, model_channels=64, out_channels=6, num_res_blocks=1,
             attention_resolutions=(2, 4), channel_mult=(1, 2, 2), num_classes=512, num_head_channels=64,
             use_scale_shift_norm=True)
# train_step_bench's fork128 at a CPU size
TSB_TINY = {"TSB_CONFIG": "fork128", "TSB_IMAGE_SIZE": "64", "TSB_CH": "32", "TSB_BATCH": "2"}


def inputs(kw, n, seed=1):
    rs = np.random.RandomState(seed)
    s = kw["image_size"]
    return (rs.standard_normal((n, s, s, 3)).astype(np.float32), np.arange(n, dtype=np.int32) * 97,
            rs.standard_normal((n, 512)).astype(np.float32))


def cpu_loop(model, batch_size: int) -> TrainLoop:
    logger.configure_dir(format_strs=[])
    return TrainLoop(model=model, diffusion=create_gaussian_diffusion(steps=20, noise_schedule="cosine",
                                                                      learn_sigma=True),
                     data=None, batch_size=batch_size, microbatch=-1, lr=1e-4, ema_rate=0.9999,
                     log_interval=10**9, save_interval=10**9)


def port_forward_flops(tm, x, t, feat) -> float:
    with torch.no_grad():
        return flops.flops_per_step(tm, nchw(x), torch.from_numpy(t), clip_feat=torch.from_numpy(feat))


@pytest.mark.parametrize("args", [(4, 64, 128), (1, 1, 1), (2, 1024, 256), (48, 256, 192)])
def test_attention_formula_matches_jax(args):
    assert flops.attention_matmul_flops(*args) == jax_flops.attention_matmul_flops(*args)
    b, s, c = args
    assert flops.attention_matmul_flops(*args) == 2 * b * s**2 * c  # reference unet.py:308-325


def test_matmul_count_matches_jax():
    """A 64x128 @ 128x32 product: the port counts exactly 2*M*N*K, and XLA's
    count is within its own 25 % of it (tests/test_flops.py)."""
    a, b = np.zeros((64, 128), np.float32), np.zeros((128, 32), np.float32)
    want = 2 * 64 * 128 * 32
    got = flops.compiled_cost(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    assert got["flops"] == want and got["by_op"] == {"aten.mm": want}
    assert flops.flops_per_step(torch.matmul, torch.from_numpy(a), torch.from_numpy(b)) == float(want)
    jax_cost = jax_flops.compiled_cost(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))["flops"]
    assert abs(jax_cost - want) / want < 0.25


@pytest.mark.parametrize("kw", [SMALL, WIDER], ids=["32ch_16px", "64ch_32px"])
def test_unet_forward_count_against_jax(kw):
    """The clip_feat UNet's forward at batch 2: the port's count over XLA's in
    [1.0, 1.15] (see the module's docstring)."""
    jm, params, tm = clip_feat_pair(kw)
    x, t, feat = inputs(kw, 2)
    ours = port_forward_flops(tm, x, t, feat)
    theirs = jax_flops.flops_per_step(
        lambda p, xx, tt, ff: jm.apply({"params": p}, xx, tt, clip_feat=ff), params, jnp.asarray(x),
        jnp.asarray(t), jnp.asarray(feat))
    assert np.isfinite(theirs) and theirs > 1e6
    assert 1.0 <= ours / theirs <= 1.15, (ours, theirs, ours / theirs)


def module_sums(model, x, t, feat) -> tuple:
    """(forward, train step) operations of ``model`` derived from its modules:
    every conv 2*B*Ho*Wo*K*C*kh*kw, every linear map 2*rows*in*out, every
    attention block twice ``attention_matmul_flops`` (2 operations a MAC);
    the step's backward adds the weight's gradient of each conv and linear
    map and its input's gradient where that input needs one, and the
    attention's plain backward five products to the forward's two."""
    layers, attn = [], []

    def on_layer(m, args, out):
        inp = args[0]
        if isinstance(m, torch.nn.Conv2d):
            c, kh, kw = m.weight.shape[1:]
            f = 2 * out.numel() * c * kh * kw
        else:
            f = 2 * out.numel() * inp.shape[-1]
        layers.append((f, inp.requires_grad))

    def on_attn(m, args, out):
        B, C, H, W = args[0].shape
        attn.append(flops.attention_matmul_flops(B, H * W, C))

    hooks = [m.register_forward_hook(on_layer) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear, Conv1x1))]
    hooks += [m.register_forward_hook(on_attn) for m in model.modules() if isinstance(m, AttentionBlock)]
    try:
        model(x, t, clip_feat=feat)
    finally:
        for h in hooks:
            h.remove()
    forward = sum(f for f, _ in layers) + 2 * sum(attn)
    step = sum(f * (2 + grad_in) for f, grad_in in layers) + 7 * sum(attn)
    return forward, step


def test_recipe_count_equals_the_modules_sum():
    """The recipe (shrunk) forward and train step, as the train step bench
    counts it, against the sum derived from the modules."""
    model = UNetModel_clip_feat(UNetConfig(**SMALL))
    x, t, feat = inputs(SMALL, 2)
    xs, ts, fs = nchw(x), torch.from_numpy(t).long(), torch.from_numpy(feat)
    want_fwd, want_step = module_sums(model, xs, ts, fs)
    with torch.no_grad():
        assert flops.flops_per_step(model, xs, ts, clip_feat=fs) == want_fwd
    loop = cpu_loop(model, 2)
    assert flops.flops_per_step(loop.run_step, xs, {"clip_feat": fs}) == want_step


@pytest.mark.parametrize("what", ["forward", "train step"])
def test_count_is_the_same_whatever_implements_it(what):
    """bf16 torso against int8 convs (K4, K5 and the quantize kernels' plain
    versions) at the same shapes: the same count; and batch 2 counts twice
    batch 1."""
    counts = {}
    for conv_impl in ("auto", "int8"):
        for n in (1, 2):
            model = UNetModel_clip_feat(UNetConfig(**SMALL), dtype=torch.bfloat16, conv_impl=conv_impl)
            x, t, feat = inputs(SMALL, n)
            if what == "forward":
                counts[conv_impl, n] = port_forward_flops(model, x, t, feat)
            else:
                loop = cpu_loop(model, n)
                counts[conv_impl, n] = flops.flops_per_step(loop.run_step, nchw(x), {"clip_feat": torch.from_numpy(feat)})
    assert counts["auto", 1] > 1e7
    assert counts["int8", 1] == counts["auto", 1] and counts["int8", 2] == counts["auto", 2]
    assert counts["auto", 2] == 2 * counts["auto", 1]


def test_train_step_bench_count_is_linear_and_the_same_under_int8(monkeypatch):
    """The tool's ``flops_per_step`` (batch 1 on the CPU, times the batch)
    equals a count of the whole batch's step, bf16 and int8 alike."""
    for k, v in TSB_TINY.items():
        monkeypatch.setenv(k, v)
    logger.configure_dir(format_strs=[])
    s = tsb.settings()
    got = tsb.step_flops(s)
    loop = tsb.make_loop(s, torch.device("cpu"), s["batch"], -1)
    x, cond = tsb.make_batch(s, s["batch"], np.random.RandomState(0))
    assert got == flops.flops_per_step(loop.run_step, x, cond) > 1e9
    monkeypatch.setenv("TSB_CONV_IMPL", "int8")
    assert tsb.step_flops(tsb.settings()) == got


def test_guided_step_count_is_its_parts():
    """``perf_breakdown``'s guided step (ADM-G and its classifier at a CPU
    size): the count of the whole step is that of its UNet forward and its
    ``cond_fn`` (the classifier's forward and its backward to x, through
    ``torch.autograd.grad`` on a leaf), the same under int8, linear in the
    batch."""
    from guided_diffusion_clip_tpu_torch.tools import perf_breakdown as pb

    step = pb.build_step(2, 64, "auto", 64, 64, torch.device("cpu"))
    parts = {k: flops.flops_per_step(fn) for k, fn in step.parts.items()}
    assert parts["full_step_ms"] == parts["unet_fwd_ms"] + parts["cls_grad_ms"]
    assert parts["cls_grad_ms"] > 2 * parts["cls_fwd_ms"] > 0
    assert pb.step_flops(2, 64, "auto", 64, 64) == parts["full_step_ms"]
    assert pb.step_flops(2, 64, "int8", 64, 64) == parts["full_step_ms"]
