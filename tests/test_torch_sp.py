"""Spatial partitioning (``parallel/sp.py``, ``--spatial_shard``) on CPU
ranks (gloo), against the unsharded port and the JAX package.

The ranks run ``tests/torch_dist_worker.py`` under torchrun, started once
for the module at world 2 (one data group of two space ranks,
``scenario_sp``) and once at world 4 (two data groups of two,
``scenario_sp4``); each writes its rows. Here the unsharded port runs the
same models, inputs and generators, and the JAX package the forward, the
guidance gradient and the DDIM chain. The models follow
``tests/test_spatial.py``'s ``tiny_cfg`` (16 px, 32 channels, mult (1, 2),
attention at 8 px), whose levels give each of two ranks 8 and 4 rows.

Tolerances: against the unsharded port, rtol 2e-5 and atol 2e-6 (the JAX
package's own SP tests'), 3e-5 and 3e-6 for the 5-step chains, as there, the
atol taken of max|ref| where that exceeds 1 (``_close``); the sums that
cross the ranks are taken in another order. Against the JAX
package, ``ROADMAP.md``'s parity tolerances: 1e-4 for the UNet and the
classifier, 1e-4 x max|ref| for the guidance gradient, 5e-4 for a chain.
int8 runs teacher-forced: every rounding of the sharded forward is held to
the unsharded forward's (scales to rtol 1e-6, plus 2^-20 (mean / std)^2 for
a group's offset, as ``tests/test_torch_quant.py``) and then replaced by it.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from guided_diffusion_clip_tpu.utils.script_util import create_gaussian_diffusion as jax_diffusion
from guided_diffusion_clip_tpu_torch import classifier_sample, image_sample
from guided_diffusion_clip_tpu_torch.diffusion.guidance import cfg_model_fn, classifier_cond_fn
from guided_diffusion_clip_tpu_torch.models.nn import GroupNorm32
from guided_diffusion_clip_tpu_torch.models.unet import EncoderUNetModel, UNetConfig, UNetModel
from guided_diffusion_clip_tpu_torch.ops import groupnorm as G
from guided_diffusion_clip_tpu_torch.ops import quant as Q
from guided_diffusion_clip_tpu_torch.parallel import sp
from guided_diffusion_clip_tpu_torch.training import train_loop as TL
from guided_diffusion_clip_tpu_torch.utils import logger
from guided_diffusion_clip_tpu_torch.utils.script_util import (
    create_classifier, create_gaussian_diffusion, create_model_and_diffusion, create_upstream_model,
    model_and_diffusion_defaults,
)
from test_torch_dist import CLI_CLASSIFIER, CLI_UNET, TINY, _flags, _random_pt
from test_torch_train_dist import rel
from torch_dist_worker import B, SP_CFG, SP_DEEP, batches, make_loop, run_ranks, sp_models, state, step
from torch_port_utils import clip_feat_pair, encoder_pair, nchw, nhwc, upstream_pair

torch.set_num_threads(2)

CLIP = dict(SP_CFG, num_classes=512)
CLF = dict(SP_CFG, out_channels=10, num_head_channels=16)


def _randomize(model, seed):
    """N(0, 0.1) weights, GroupNorm scales about 1 (the init's zero output
    layers would make the forward exactly 0)."""
    g = torch.Generator().manual_seed(seed)
    scales = {id(m.weight) for m in model.modules() if isinstance(m, GroupNorm32)}
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1 + (1.0 if id(p) in scales else 0.0))
    return model


def _rows(parts) -> torch.Tensor:
    """The ranks' rows of a map, in rank order: the full map."""
    return torch.cat(list(parts), dim=2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the JAX pairs, and what the ranks wrote at world 2 and 4."""
    d = tmp_path_factory.mktemp("sp")
    jclip, pclip, tclip = clip_feat_pair(CLIP, seed=0)
    jplain, pplain, tplain = upstream_pair(dict(SP_CFG, num_classes=None), seed=1)
    jclf, pclf, tclf = encoder_pair(CLF, "attention", seed=2)
    models = {
        "clip": (dict(CLIP, variant="clip_feat", label_emb_type="mlp"), {}, tclip.state_dict()),
        "clip8": (dict(CLIP, variant="clip_feat", label_emb_type="mlp"), {"conv_impl": "int8"}, tclip.state_dict()),
        "plain": (dict(SP_CFG, variant="unet"), {}, tplain.state_dict()),
        "clf_attention": (CLF, {"pool": "attention"}, tclf.state_dict()),
    }
    for i, (name, cfg, extra) in enumerate((
            ("deep", dict(SP_DEEP), {}),
            ("super_res", dict(SP_CFG, in_channels=6, variant="super_res"), {}),
            ("sr_img_feat", dict(SP_CFG, in_channels=6, num_classes=512, variant="sr_img_feat",
                                 label_emb_type="mlp"), {}),
            ("clf_spatial", CLF, {"pool": "spatial"}))):
        cls = EncoderUNetModel if "pool" in extra else UNetModel
        models[name] = (cfg, extra, _randomize(cls(UNetConfig(**cfg), **extra), 10 + i).state_dict())
    rs = np.random.RandomState(0)
    inp = {"models": models, "x": torch.from_numpy(rs.uniform(-1, 1, (4, 3, 16, 16)).astype(np.float32)),
           "t": torch.tensor([0.0, 3.0, 9.0, 19.0]), "feat": torch.from_numpy(rs.randn(4, 512).astype(np.float32)),
           "feat2": torch.from_numpy(rs.randn(4, 512).astype(np.float32)),
           "img2": torch.from_numpy(rs.uniform(-1, 1, (4, 3, 16, 16)).astype(np.float32)),
           "low_res": torch.from_numpy(rs.uniform(-1, 1, (4, 3, 8, 8)).astype(np.float32)),
           "y": torch.tensor([1, 4, 7, 2])}
    inp["jax_int8"], jax_int8_out = _jax_int8_values(jclip, pclip, inp)
    torch.save(inp, d / "sp_inputs.pt")
    # the CLIs' inputs, as tests/test_torch_dist.py's
    (d / "images").mkdir()
    for i in range(9):
        Image.fromarray(rs.randint(0, 255, (16, 16, 3), dtype=np.uint8)).save(d / "images" / f"img_{i:03d}.png")
    _random_pt(create_model_and_diffusion(**{**model_and_diffusion_defaults(), **TINY})[0], d / "unet.pt", 0)
    _random_pt(create_upstream_model(**CLI_UNET), d / "model.pt", 0)
    _random_pt(create_classifier(**CLI_CLASSIFIER), d / "classifier.pt", 1)
    argv = {
        "image": [*_flags(TINY), "--device", "cpu", "--model_path", str(d / "unet.pt"), "--data_dir_test",
                  str(d / "images"), "--batch_size", "2", "--num_samples", "6", "--use_ddim", "True", "--seed", "4"],
        "classifier": [*_flags({**CLI_UNET, **CLI_CLASSIFIER}), "--device", "cpu", "--model_path", str(d / "model.pt"),
                       "--classifier_path", str(d / "classifier.pt"), "--use_fp16", "True", "--timestep_respacing",
                       "3", "--batch_size", "2", "--num_samples", "2", "--classifier_scale", "10.0", "--seed", "7"],
    }
    for name, flags in argv.items():
        (d / f"sp_{name}.argv").write_text("\n".join([*flags, "--spatial_shard", "2", "--main_path",
                                                      str(d / f"sp_{name}")]))
    clis = _other_clis(d, rs)
    torch.save({name: (module, [*flags, "--spatial_shard", "2", "--main_path", str(d / "sp_clis" / name)], env)
                for name, (module, flags, env) in clis.items()}, d / "sp_clis.pt")
    run_ranks("sp", str(d), n=2, timeout=400)
    run_ranks("sp4", str(d), n=4, timeout=400)
    load = lambda name, n: [torch.load(d / f"{name}_rank{r}.pt", weights_only=False) for r in range(n)]
    return {"dir": d, "inp": inp, "argv": argv, "clis": clis, "jax_int8_out": jax_int8_out,
            "jax": {"clip": (jclip, pclip), "plain": (jplain, pplain), "clf": (jclf, pclf)},
            "ranks": load("sp", 2), "cli": load("sp_cli", 2), "ranks4": load("sp4", 4), "cli4": load("sp4_cli", 4)}


def _jax_int8_values(jm, params, inp) -> tuple:
    """The JAX package's int8 forward of the fork's CLIP UNet on the
    unsharded inputs: ({the port's module name: each quantizing GroupNorm's
    (q, s) and each per-tensor int8 conv's output, NCHW}, the output NHWC),
    the values ``jax_quantization`` forces in ``tests/test_torch_quant.py``."""
    from test_torch_quant import _jax_int8_apply, _jax_intermediate

    from guided_diffusion_clip_tpu_torch.models.nn import Conv2d

    out, inter = _jax_int8_apply(jm, params, nhwc(inp["x"]), inp["t"].numpy(), clip_feat=inp["feat"].numpy())
    values = {}
    cfg, extra, _ = inp["models"]["clip8"]
    for name, mod in UNetModel(UNetConfig(**cfg), **extra).named_modules():
        if not name.startswith(("input_blocks.", "middle_block.", "output_blocks.")):
            continue
        if isinstance(mod, GroupNorm32) and name.endswith(("in_layers.0", "out_layers.0")):
            q, s = _jax_intermediate(inter, name)
            values[name] = (nchw(np.asarray(q, np.float32)), torch.from_numpy(np.asarray(s)))
        elif isinstance(mod, Conv2d) and mod.int8:
            values[name] = (nchw(np.asarray(_jax_intermediate(inter, name), np.float32)),)
    return values, out


def _other_clis(d, rs) -> dict:
    """The inputs of the other CLIs that take ``--spatial_shard`` (the
    trainers, the CLIP and SR samplers, the depth sweep), at the sizes of
    their own tests: {name: (module, flags, environment)}."""
    from test_torch_clip_cli import JTINY, UNET_FLAGS, _clip_params
    from test_torch_sr_cli import TINY_SR

    from guided_diffusion_clip_tpu_torch.utils import script_util as TSU
    from guided_diffusion_clip_tpu_torch.utils.convert import state_dict_from_flax

    np.savez(d / "clip.npz", **{f"img_{i:03d}.png": rs.randn(2, 512).astype(np.float32) for i in range(9)})
    (d / "cls").mkdir()
    for i in range(8):
        Image.fromarray(rs.randint(0, 255, (72, 80, 3), dtype=np.uint8)).save(d / "cls" / f"c{i % 4}_{i}.png")
    torch.save(state_dict_from_flax((*_clip_params(JTINY), 2.0), model="clip"), d / "clip_tiny.pt")
    np.savez(d / "target.npz", rs.standard_normal(16).astype(np.float32))
    unet16 = dict(image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2", learn_sigma=True,
                  attention_resolutions="8", use_scale_shift_norm=True)
    _random_pt(TSU.create_model(**unet16, class_cond=False, num_heads=2), d / "unet16.pt", 2)
    _random_pt(TSU.create_model(**unet16, class_cond=True, num_heads=1), d / "clip_unet16.pt", 3)
    sr = TSU.sr_create_model_and_diffusion(**{**TSU.sr_model_and_diffusion_defaults(), "large_size": 64,
                                              "small_size": 32, "num_channels": 32, "num_res_blocks": 1,
                                              "attention_resolutions": "8", "num_heads": 1, "learn_sigma": True})[0]
    _random_pt(TSU.upstream_super_res(sr, False), d / "sr.pt", 4)
    np.savez(d / "base.npz", rs.randint(0, 256, (2, 32, 32, 3), dtype=np.uint8))
    imgs, clip = str(d / "images"), str(d / "clip.npz")
    train = ["--batch_size", "2", "--lr_anneal_steps", "2", "--save_interval", "100", "--log_interval", "1"]
    return {
        "image_train": ("image_train", [
            "--image_size", "16", "--num_channels", "32", "--num_res_blocks", "1", "--channel_mult", "1,2",
            "--attention_resolutions", "8", "--num_heads", "1", "--learn_sigma", "True", "--class_cond", "True",
            "--diffusion_steps", "20", "--noise_schedule", "cosine", "--device", "cpu", "--data_dir", imgs,
            "--clip_file_path", clip, *train], {}),
        "super_res_train": ("super_res_train", [*TINY_SR, "--data_dir", imgs, *train], {}),
        "super_res_unsup": ("super_res_unsup", [*TINY_SR, "--class_cond", "True", "--data_dir", imgs,
                                                "--clip_file_path", clip, *train], {}),
        "classifier_train": ("classifier_train", [
            "--image_size", "64", "--classifier_width", "32", "--classifier_depth", "1",
            "--classifier_attention_resolutions", "8", "--diffusion_steps", "40", "--noise_schedule", "cosine",
            "--data_dir", str(d / "cls"), "--batch_size", "4", "--microbatch", "2", "--iterations", "2",
            "--save_interval", "100", "--device", "cpu"], {}),
        "super_res_sample": ("super_res_sample", [
            *TINY_SR, "--model_path", str(d / "sr.pt"), "--base_samples", str(d / "base.npz"),
            "--timestep_respacing", "3", "--batch_size", "2", "--num_samples", "2"], {}),
        "depth_sweep": ("super_res_depth_sweep_sample", [
            "--image_size", "16", "--num_channels", "32", "--num_res_blocks", "1", "--channel_mult", "1,2",
            "--attention_resolutions", "8", "--num_heads", "1", "--learn_sigma", "True", "--class_cond", "True",
            "--diffusion_steps", "1000", "--noise_schedule", "cosine", "--timestep_respacing", "10",
            "--model_path", str(d / "clip_unet16.pt"), "--data_dir_test", imgs, "--clip_file_path_test", clip,
            "--batch_size", "4", "--device", "cpu"], {}),
        "clip_guided": ("clip_guided_sample", [
            *UNET_FLAGS, "--model_path", str(d / "unet16.pt"), "--clip_model_path", str(d / "clip_tiny.pt"),
            "--target_embed", str(d / "target.npz"), "--clip_scale", "10"], {"GDC_CLIP_TINY": "1"}),
    }


@pytest.fixture(scope="module")
def port(world):
    """The unsharded port on the same models and inputs."""
    inp, models = sp_models(str(world["dir"]))
    x, t, feat = inp["x"], inp["t"], inp["feat"]
    out = {}
    with torch.no_grad():
        out["fwd_clip"] = models["clip"](x, t, clip_feat=feat)
        out["fwd_plain"] = models["plain"](x, t)
        out["fwd_deep"] = models["deep"](x, t)
        out["fwd_super_res"] = models["super_res"](x, t, low_res=inp["low_res"])
        out["fwd_sr_img_feat"] = models["sr_img_feat"](x, t, clip_feat=feat, clip_feat2=inp["feat2"], img2=inp["img2"])
        out["clf_attention"] = models["clf_attention"](x, t)
        out["clf_spatial"] = models["clf_spatial"](x, t)
        out["cache_full"], out["cache_deep"] = models["clip"](x, t, clip_feat=feat, cache_mode="full")
        out["cache_shallow"] = models["clip"](x, t, clip_feat=feat, cache_mode="shallow",
                                              deep_cache=out["cache_deep"])[0]
    out["guidance"] = classifier_cond_fn(lambda u, tt: models["clf_attention"](u, tt), 3.0)(x, t, y=inp["y"])
    for name, m, kw in (("remat", models["clip"], {"clip_feat": feat}), ("deep_grad", models["deep"], {})):
        m.train()
        xg = x.clone().requires_grad_(True)
        (m(xg, t, **kw).square().sum()).backward()
        out[name] = {"x": xg.grad, "params": {n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None}}
        m.eval()
    diff = create_gaussian_diffusion(steps=20, noise_schedule="cosine", learn_sigma=True, rescale_learned_sigmas=True,
                                     timestep_respacing="ddim5")
    with torch.no_grad():
        out["ddim"] = diff.ddim_sample_loop(models["plain"], tuple(x.shape), torch.Generator().manual_seed(3))
        out["cfg"] = diff.ddim_sample_loop(cfg_model_fn(models["clip"], 2.5, {"clip_feat": 0.0}), tuple(x.shape),
                                           torch.Generator().manual_seed(7), model_kwargs={"clip_feat": feat})
    loop = make_loop(str(world["dir"] / "one_rank"))
    step(loop, batches(B, 1), slice(None))
    out["train"] = state(loop)
    loop = make_loop(str(world["dir"] / "one_rank_2b"), batch_size=2 * B)
    step(loop, batches(2 * B, 1), slice(None))
    out["train_2b"] = state(loop)
    return out


def _close(got, ref, rtol=2e-5, atol=2e-6):
    """Within rtol and atol x max|ref|: the random weights' outputs reach a few
    units, and f32 roundings (sums taken in another order, K3's folded
    affine on the ranks against the plain version's centred form, convs on
    haloed shapes) reach ~2e-6 of that after some twenty layers."""
    ref = ref.detach().float()
    np.testing.assert_allclose(got.detach().float().numpy(), ref.numpy(), rtol=rtol,
                               atol=atol * max(1.0, float(ref.abs().max())))


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", ["fwd_clip", "fwd_plain", "fwd_deep", "fwd_super_res", "fwd_sr_img_feat",
                                  "cache_full", "cache_deep", "cache_shallow"])
def test_forward_matches_unsharded(world, port, name):
    """The fork's variant, the plain UNet, the SR variants, a model whose
    2 px level runs whole on both ranks (``fwd_deep``), and DeepCache's full
    forward, its cached deep feature (the rank's rows) and the shallow
    forward from it: each rank's rows are the unsharded output's."""
    got = _rows(r[name] for r in world["ranks"])
    assert got.shape == port[name].shape and port[name].abs().max() > 0.1
    _close(got, port[name])


@pytest.mark.timeout(600)
def test_forward_matches_jax(world):
    """The fork's variant, sharded, against the JAX model unsharded (1e-4)."""
    jm, params = world["jax"]["clip"]
    inp = world["inp"]
    ref = jm.apply({"params": params}, jnp.asarray(nhwc(inp["x"])), jnp.asarray(inp["t"].numpy()),
                   clip_feat=jnp.asarray(inp["feat"].numpy()))
    got = _rows(r["fwd_clip"] for r in world["ranks"])
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("pool", ["attention", "spatial"])
def test_classifier_matches_unsharded(world, port, pool):
    """The classifier's logits, every rank's the same: the attention pool on
    the gathered map, the spatial pool's means over the ranks; the attention
    pool's also against the JAX classifier (1e-4)."""
    r0, r1 = (r[f"clf_{pool}"] for r in world["ranks"])
    assert torch.equal(r0, r1)
    _close(r0, port[f"clf_{pool}"])
    if pool == "attention":
        jm, params = world["jax"]["clf"]
        inp = world["inp"]
        ref = jm.apply({"params": params}, jnp.asarray(nhwc(inp["x"])), jnp.asarray(inp["t"].numpy()))
        np.testing.assert_allclose(r0.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.timeout(600)
def test_guidance_gradient_matches_unsharded_and_jax(world, port):
    """``classifier_cond_fn`` on each rank's rows: the ranks' rows of the
    unsharded gradient (the replicated log-probability counted once), and
    within 1e-4 x max|ref| of ``jax.grad`` of the JAX classifier's."""
    got = _rows(r["guidance"] for r in world["ranks"])
    ref = port["guidance"]
    _close(got, ref)
    jm, params = world["jax"]["clf"]
    inp = world["inp"]

    def log_prob(x):
        logits = jm.apply({"params": params}, x, jnp.asarray(inp["t"].numpy()))
        lp = jax.nn.log_softmax(logits, axis=-1)
        return jnp.sum(jnp.take_along_axis(lp, jnp.asarray(inp["y"].numpy())[:, None], axis=-1)) * 3.0

    jref = np.asarray(jax.grad(log_prob)(jnp.asarray(nhwc(inp["x"]))))
    np.testing.assert_allclose(nhwc(got), jref, rtol=0, atol=1e-4 * np.abs(jref).max())


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", ["remat", "deep_grad"])
def test_backward_matches_unsharded(world, port, name):
    """The gradient of the sum of squares of the output, backpropagated on
    each rank from its rows: the input's gradient is the ranks' rows of the
    unsharded one, and the parameters' gradients summed over the ranks are
    the unsharded ones, within 1e-5 relative L2 over all of them (as
    ``tests/test_torch_train_dist.py``; a sum over ranks is taken in another
    order). ``remat``: with ``use_checkpoint``, in train mode, recomputing
    every ResBlock and AttentionBlock (and their collectives) in the
    backward; ``deep_grad``: through the level that runs whole."""
    ranks = world["ranks"]
    ref = port[name]
    _close(_rows(r[name]["x"] for r in ranks), ref["x"])
    summed = {n: ranks[0][name]["params"][n] + ranks[1][name]["params"][n] for n in ref["params"]}
    assert rel(summed, ref["params"]) <= 1e-5


@pytest.mark.timeout(600)
def test_int8_forward_teacher_forced(world):
    """The int8 fork UNet on the ranks' rows against its unsharded forward,
    every rounding held and then forced: each quantizing GroupNorm's
    per-image scale within rtol 1e-6 (+ the offset term) and its q within one
    level on at most 1e-3 of it; each per-tensor scale of ``int8_conv``
    (the amax all-reduced between the quantize kernels' two passes) within
    rtol 1e-6; each int8 conv's output and the unforced head's within
    1e-2 x max|ref| and 5e-3 relative L2 (one flipped level of x_q moves a
    3x3 patch by s_x |w|)."""
    from guided_diffusion_clip_tpu_torch.models.nn import Conv2d
    from guided_diffusion_clip_tpu_torch.models.unet import ResBlock

    _, models = sp_models(str(world["dir"]))
    mods = list(models["clip8"].named_modules())
    n_k4 = sum(1 if m.down else 2 for _, m in mods if isinstance(m, ResBlock))  # as chip_smoke's gn_conv_counts
    n_convs = sum(isinstance(m, Conv2d) for name, m in mods if not name.startswith("out.")) - n_k4
    for r in world["ranks"]:
        rd = r["int8"]["readings"]
        gns = [x for x in rd if x["kind"] == "gn"]
        convs = [x for x in rd if x["kind"] == "conv"]
        assert (len(gns), len(convs)) == (n_k4, n_convs)
        for x in gns:
            assert x["s_err"] <= x["s_tol"] and x["q_max"] <= 1 and x["flips"] <= max(1, 1e-3 * x["n"]), x
        for x in convs:
            assert x["max"] <= 1e-2 * x["ref_max"] and x["l2"] <= 5e-3, x
        scales = r["int8"]["scales"]
        assert len(scales) == len(convs) + 1  # and the head's
        for got, ref in scales:
            assert abs(got - ref) <= 1e-6 * ref, (got, ref)
        out, ref = r["int8"]["out"], r["int8"]["ref_rows"]
        d = (out - ref).abs()
        assert d.max() <= 1e-2 * ref.abs().max() and d.norm() <= 5e-3 * ref.norm()


@pytest.mark.timeout(600)
def test_int8_forward_teacher_forced_matches_jax(world, port):
    """The same int8 fork UNet on the ranks' rows, teacher-forced to the
    JAX package's int8 forward of the same weights and inputs (its captured
    intermediates, as ``tests/test_torch_quant.py``'s ``jax_quantization``):
    each quantizing GroupNorm's scale within rtol 1e-6 (+ the offset term)
    and its q within one level on at most 1e-3 of it, each int8 conv's
    output within 1e-2 x max|ref| and 5e-3 relative L2; the ranks' rows of
    the unforced head's output within 1e-3 x max(1, |ref|) of JAX's on all
    but 0.5 % of the values and 5e-3 relative L2 (``_close_but_flips``, as
    the unsharded port's int8 forward is held)."""
    from test_torch_quant import _close_but_flips

    for r in world["ranks"]:
        rd = r["int8_jax"]["readings"]
        gns = [x for x in rd if x["kind"] == "gn"]
        convs = [x for x in rd if x["kind"] == "conv"]
        # the layers that test_int8_forward_teacher_forced counts from the modules
        assert (len(gns), len(convs)) == tuple(sum(x["kind"] == k for x in r["int8"]["readings"])
                                               for k in ("gn", "conv"))
        for x in gns:
            assert x["s_err"] <= x["s_tol"] and x["q_max"] <= 1 and x["flips"] <= max(1, 1e-3 * x["n"]), x
        for x in convs:
            assert x["max"] <= 1e-2 * x["ref_max"] and x["l2"] <= 5e-3, x
    got = nhwc(_rows(r["int8_jax"]["out"] for r in world["ranks"]))
    ref = world["jax_int8_out"]
    assert np.abs(ref).max() > 0.1 and np.abs(got - nhwc(port["fwd_clip"])).max() > 1e-3 * np.abs(ref).max()
    _close_but_flips(got, ref, 1e-3, max(1.0, np.abs(ref).max()))


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", ["ddim", "cfg"])
def test_chains_match_unsharded(world, port, name):
    """5-step DDIM chains from one generator: the noise is drawn at full size
    and sliced, so each rank's rows are the unsharded chain's, to rtol 3e-5
    (the JAX package's SP chain tests') and atol 1e-4 of the [-1, 1] range:
    the model's ~2e-6 x max|eps| differences grow through 1/sqrt(alpha_bar)
    and, under ``cfg`` (classifier-free guidance over ``clip_feat`` at 2.5,
    the doubled batch sharded alike), the guidance scale (read: 1.1e-5 and
    5.1e-5). The plain chain also against the JAX loop from the same x_T
    (5e-4)."""
    got = _rows(r[name] for r in world["ranks"])
    _close(got, port[name], rtol=3e-5, atol=1e-4)
    if name == "ddim":
        jm, params = world["jax"]["plain"]
        x_t = torch.randn((4, 3, 16, 16), generator=torch.Generator().manual_seed(3))
        diffusion = jax_diffusion(steps=20, noise_schedule="cosine", learn_sigma=True, rescale_learned_sigmas=True,
                                  timestep_respacing="ddim5")
        ref = diffusion.ddim_sample_loop(lambda x, t, **k: jm.apply({"params": params}, x, t), (4, 16, 16, 3),
                                         jax.random.key(0), noise=jnp.asarray(nhwc(x_t)))
        np.testing.assert_allclose(nhwc(got), np.asarray(ref), rtol=5e-4, atol=5e-4)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("mode", ["tree", "zero1", "fsdp", "remat_tree"])
def test_train_step_matches_dp_step(world, port, mode):
    """One step of the tiny CLIP UNet with SP 2 under DDP, ZeRO-1, FSDP2 and
    DDP with ``use_checkpoint``, both ranks on the same B rows, against the
    one-rank step on them: each rank's loss is the mean over its rows, so
    the mean over the ranks of their gradients is the DP gradient; the
    gradient and the parameters within 1e-5 relative L2, the logged loss
    within 1e-6."""
    for r in world["ranks"]:
        got, ref = r[f"train_{mode}"], port["train"]
        assert rel(got["grad"], ref["grad"]) <= 1e-5
        assert rel(got["params"], ref["params"]) <= 1e-5
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-6)


def _flax_params(jm, sd: dict) -> dict:
    """The JAX model's parameter tree holding the port's ``sd``: each leaf
    the inverse of ``state_dict_from_flax``'s layout change, which maps the
    tree back onto ``sd`` exactly (checked)."""
    from guided_diffusion_clip_tpu_torch.utils.convert import flax_path_to_torch_key, state_dict_from_flax

    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32),
                                            clip_feat=jnp.zeros((1, 512))))["params"]

    def leaf(path, shape):
        a = sd[flax_path_to_torch_key(tuple(k.key for k in path))].numpy()
        a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a[:, :, 0].T if a.ndim == 3 else \
            a.T if a.ndim == 2 and path[-1].key == "kernel" else a
        assert a.shape == shape.shape, (path, a.shape, shape.shape)
        return np.ascontiguousarray(a)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    back = state_dict_from_flax(params)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    return params


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's loss and gradient of one train step of the worker's
    tiny CLIP UNet on the rows the ranks trained on (``batches(B, 1)``, the
    same t and noise, uniform weights 1): ``jax.value_and_grad`` of the mean
    of ``training_losses``, as the JAX loop's step takes it, the gradient in
    the port's names."""
    from torch_dist_worker import KW, tiny_model

    from guided_diffusion_clip_tpu.models.clip_models import UNetModel_clip_feat as JaxClipFeat
    from guided_diffusion_clip_tpu.models.unet import UNetConfig as JaxConfig
    from guided_diffusion_clip_tpu_torch.utils.convert import state_dict_from_flax

    jm = JaxClipFeat(JaxConfig(**KW))
    params = _flax_params(jm, tiny_model().state_dict())
    b = batches(B, 1)
    diffusion = jax_diffusion(steps=20, noise_schedule="cosine", learn_sigma=True)

    def loss_fn(p):
        def model_fn(xx, tt, **kw):
            return jm.apply({"params": p}, xx, tt, train=True, rngs={"dropout": jax.random.key(1)}, **kw)

        terms = diffusion.training_losses(model_fn, jnp.asarray(b["x"].transpose(0, 2, 3, 1)), jnp.asarray(b["t"]),
                                          jnp.asarray(b["noise"].transpose(0, 2, 3, 1)),
                                          model_kwargs={"clip_feat": jnp.asarray(b["feat"])})
        return jnp.mean(terms["loss"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), state_dict_from_flax(jax.device_get(grads))


@pytest.mark.timeout(600)
@pytest.mark.parametrize("mode", ["tree", "zero1", "fsdp", "remat_tree"])
def test_train_step_gradient_matches_jax(world, jax_step, mode):
    """The SP 2 train steps of ``test_train_step_matches_dp_step`` (DDP,
    ZeRO-1, FSDP2, DDP with ``use_checkpoint``) against the JAX package
    itself: each rank's gradient (the mean over the ranks of their
    shard-mean gradients) and logged loss within 1e-4 relative of
    ``jax.value_and_grad`` of the JAX step's loss on the same rows, t and
    noise (``ROADMAP.md``'s parity tolerance; the gradient in relative L2
    over all parameters, as ``tests/test_torch_train.py``)."""
    loss, grads = jax_step
    for r in world["ranks"]:
        got = r[f"train_{mode}"]
        assert rel(got["grad"], grads) <= 1e-4
        assert got["loss"] == pytest.approx(loss, rel=1e-4)


@pytest.mark.timeout(600)
def test_world4_train_step_matches_dp_step(world, port):
    """Two data groups of two space ranks (world 4): DDP over the four ranks,
    each data group on its half of a batch of 2B, against the one-rank step
    on the 2B rows."""
    assert [r["groups"] for r in world["ranks4"]] == [(2, s, d, 2) for d in range(2) for s in range(2)]
    for r in world["ranks4"]:
        got, ref = r["train_tree"], port["train_2b"]
        assert rel(got["grad"], ref["grad"]) <= 1e-5
        assert rel(got["params"], ref["params"]) <= 1e-5
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-6)


def _samples_close(got, want):
    """uint8 samples of chains whose floats agree to ~1e-5 (more where a
    classifier's gradient at scale 10 guides): a pixel near a truncation
    boundary may land one level off, on at most 1 % of them (read: 0.17 %
    for the guided chains)."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-2, (d.max(), (d > 0).mean())


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", ["image", "classifier"])
def test_cli_samples_match_one_process(world, name):
    """``image_sample`` and ``classifier_sample`` with ``--spatial_shard 2``
    on two ranks (one data group): one ``.npz``, the one-process run's
    samples (and labels)."""
    main = {"image": image_sample.main, "classifier": classifier_sample.main}[name]
    one = main([*world["argv"][name], "--main_path", str(world["dir"] / f"one_{name}")])["path"]
    logger.reset()
    got_path = world["cli"][0][name]
    assert world["cli"][1][name] == got_path
    got, want = np.load(got_path), np.load(one)
    assert got["arr_0"].shape == want["arr_0"].shape
    _samples_close(got["arr_0"], want["arr_0"])
    if name == "classifier":
        np.testing.assert_array_equal(got["arr_1"], want["arr_1"])


@pytest.mark.timeout(600)
def test_world4_image_sample_splits_by_data_group(world):
    """At world 4 with ``--spatial_shard 2`` the two data groups read and seed
    as the two ranks of an unsharded world-2 run: the same six samples."""
    got = np.load(world["cli4"][0]["image"])["arr_0"]
    want = np.load(world["cli"][0]["image_dp"])["arr_0"]
    assert all(r["image"] == world["cli4"][0]["image"] for r in world["cli4"])
    assert got.shape == want.shape == (6, 16, 16, 3)
    _samples_close(got, want)


@pytest.mark.timeout(600)
def test_ranks_groups_refusals_and_identity(world):
    """The world's factoring, the refusals the ranks met (S not dividing the
    world, both sharding flags; ``--tensor_shard`` alone, refused until it
    was ported, now passes the CLI's check under torchrun), the hooks as the
    identity before SP was set, and ``zero_state`` on the rank's rows."""
    for s, r in enumerate(world["ranks"]):
        assert r["groups"] == (2, s, 0, 1)
        assert "does not divide the world of 2" in r["refuse_S4_at_world2"]
        assert "mutually exclusive" in r["refuse_both_flags"] and "mutually exclusive" in r["refuse_cli_both"]
        assert r["refuse_cli_tp"] is None
        assert r["identity"] is True
        assert r["cache_zero_state"] == tuple(r["cache_deep"].shape) == (4, 64, 8, 16)


def test_hooks_are_identity_when_inactive():
    """As the JAX package's (``test_hooks_are_identity_when_inactive``):
    without SP every hook returns its input itself."""
    sp.clear_spatial_sharding()
    x = torch.ones(2, 3, 4, 4)
    for fn in (sp.shard_rows, sp.gather_rows, sp.all_reduce_sum, lambda u: sp.halo(u, 1, 1),
               lambda u: sp.relayout(u, False, False)):
        assert fn(x) is x
    assert not sp.sharded(x) and sp.size() == 1 and sp.local_shape((2, 3, 4, 4)) == (2, 3, 4, 4)
    assert (sp.data_rank(), sp.data_size(), sp.owner_weight()) == (0, 1, 1.0)


def test_refusals_outside_torchrun(monkeypatch):
    """Outside a process group ``--spatial_shard 2`` cannot run: the loop and
    ``set_spatial_sharding`` say to launch under torchrun."""
    from guided_diffusion_clip_tpu_torch.parallel import dist as pdist

    for k in pdist.TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="launch under torchrun"):
        TL.check_ported(spatial_shard=2)
    with pytest.raises(ValueError, match="launch under torchrun"):
        sp.set_spatial_sharding(2)
    with pytest.raises(SystemExit, match="launch under torchrun"):
        sp.check_flags(2, 0)


@pytest.mark.parametrize("S", [2, 4])
def test_adm256_and_recipe_shard_every_level(S):
    """ADM-256 (6 levels from 256 px) and the recipe (``configs/config.yaml``:
    128 px, channel_mult 1,1,2,3,4) give every rank an even number of rows at
    every level at S = 2 and 4, so no level runs whole; the tiny models here
    too at S = 2, but for ``SP_DEEP``'s 2 px level."""
    def levels(size, mult):
        return [size >> k for k in range(len(mult))]

    for size, mult in ((256, (1, 1, 2, 2, 4, 4)), (128, (1, 1, 2, 3, 4))):
        assert all(h % S == 0 and (h // S) % 2 == 0 for h in levels(size, mult)), (size, S)
    assert [h % 2 == 0 and (h // 2) % 2 == 0 for h in levels(16, SP_DEEP["channel_mult"])] == [True] * 3 + [False]


@pytest.mark.parametrize("silu,scale_shift", [(False, False), (True, True)])
def test_split_group_norm_plain_on_row_shards(silu, scale_shift):
    """The split GroupNorm's plain versions on two row shards: the halves'
    stats summed (and K4's extremes combined), folded over the image's count
    and applied, equal the unsharded plain versions within 1e-6 (K3's folded
    affine ``x a + b`` against its ``(x - mean) rstd gamma + beta``; K4 the
    same q and s); the split quantize's amax of the halves, maxed, gives
    ``quantize_per_tensor``'s q and s exactly."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.standard_normal((2, 8, 6, 64)).astype(np.float32) + 0.3)
    w, b = torch.from_numpy(rs.rand(64).astype(np.float32) + 0.5), torch.from_numpy(rs.randn(64).astype(np.float32))
    ss = tuple(torch.from_numpy(rs.randn(2, 64).astype(np.float32) * 0.2) for _ in range(2)) if scale_shift else None
    halves = (x[:, :4], x[:, 4:])
    parts = [G.group_norm_stats_plain(h, 32, True) for h in halves]
    mean, rstd, a, bb = G._fold(parts[0][0] + parts[1][0], x.numel() // (2 * 32), w, b, 32, 1e-5, ss)
    y = torch.cat([G.group_norm_apply_plain(h, a, bb, silu) for h in halves], dim=1)
    np.testing.assert_allclose(y.numpy(), G.group_norm_plain(x, w, b, 32, 1e-5, silu, ss).numpy(), rtol=1e-6, atol=1e-6)
    lo = torch.minimum(parts[0][1][0], parts[1][1][0])
    hi = torch.maximum(parts[0][1][1], parts[1][1][1])
    s, inv = G._bound_scale(a, bb, lo, hi, silu)
    q = torch.cat([G.group_norm_quant_apply_plain(h, a, bb, inv, silu) for h in halves], dim=1)
    rq, rs_ = G.group_norm_quant_plain(x, w, b, 32, 1e-5, silu, ss)
    np.testing.assert_allclose(s.numpy(), rs_.numpy(), rtol=1e-6)
    assert (q.float() - rq.float()).abs().max() <= 1 and (q != rq).float().mean() <= 1e-3
    amax = torch.maximum(*(Q.absmax_plain(h) for h in halves))
    qq, sq = Q.quantize_given_plain(x, amax)
    rq2, rs2 = Q.quantize_per_tensor(x)
    assert torch.equal(qq, rq2) and torch.equal(sq, rs2)


def _outputs(run_dir) -> dict:
    """What a CLI wrote under its run directory: the checkpoints' and the
    samples' arrays by file name."""
    out = {}
    for root, _, files in os.walk(run_dir):
        for f in files:
            path = os.path.join(root, f)
            if f.startswith(("model", "ema_")) and f.endswith(".pt"):
                out[f] = torch.load(path, weights_only=True)
            elif f.startswith("opt") and f.endswith(".pt"):  # AdamW's first moments, a sum of the gradients
                opt = torch.load(path, weights_only=True)
                out[f] = opt["m"] if "m" in opt else {str(i): st["exp_avg"] for i, st in opt["state"].items()}
            elif f.endswith(".npz"):
                out[f] = np.load(path)["arr_0"]
            elif f.startswith("depth_") and f.endswith(".png"):
                out[f] = np.asarray(Image.open(path))
    return out


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", ["image_train", "super_res_train", "super_res_unsup", "classifier_train",
                                  "super_res_sample", "depth_sweep", "clip_guided"])
def test_other_clis_match_one_process(world, name):
    """The other CLIs that the JAX package runs with ``--spatial_shard``, at
    their tests' sizes, on two ranks with ``--spatial_shard 2`` against one
    process: after two steps the trainers' AdamW first moments (a sum of
    the two gradients) within 1e-5 relative L2, the DP step's bound
    (``tests/test_torch_train_dist.py``), and their parameters and EMAs
    within 1e-4 (an element whose gradient is rounding noise moves by
    +-lr under Adam: read 2.1e-5 for the classifier); the samplers' images
    as ``_samples_close``."""
    _check_cli_against_one_process(world, name, "sp_clis")


def _check_cli_against_one_process(world, name, ranks_dir):
    """Run the CLI ``name`` of ``world["clis"]`` in this process and hold
    what the ranks wrote under ``ranks_dir`` to it."""
    module, flags, env = world["clis"][name]
    main = importlib.import_module(f"guided_diffusion_clip_tpu_torch.{module}").main
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    torch.manual_seed(0)  # the trainers' initial weights, as the ranks drew them
    try:
        main([*flags, "--main_path", str(world["dir"] / "one_clis" / name)])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        logger.reset()
    got, want = (_outputs(world["dir"] / where / name) for where in (ranks_dir, "one_clis"))
    assert got.keys() == want.keys() and want, (sorted(got), sorted(want))
    for f in want:
        if f.endswith(".pt"):
            assert rel(got[f], want[f]) <= (1e-5 if f.startswith("opt") else 1e-4), f
        else:
            assert got[f].shape == want[f].shape, f
            _samples_close(got[f], want[f])
