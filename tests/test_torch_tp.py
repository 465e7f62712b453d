"""Tensor parallelism (``parallel/tp.py``, ``--tensor_shard``) on CPU ranks
(gloo), against the unsharded port and the JAX package.

The ranks run ``tests/torch_dist_worker.py`` under torchrun, started once for
the module at each world size: 2 (one data group of two model ranks,
``scenario_tp``), 3 (T = 3 on a model 96 channels wide, whose 32 groups split
across the ranks, ``scenario_tp3``) and 4 (two data groups of two, then one of
four, ``scenario_tp4``). Each rank runs every call under TP and the same call
unsharded (inside ``tp.whole()``, every hook the identity), and writes both;
here the JAX package runs the forward, the classifier, the guidance gradient,
the int8 forward and the DDIM chain, and the one-process port the train steps
and the CLIs. The models follow ``tests/test_tensor.py``'s ``tiny_cfg`` (16
px, 32 channels, mult (1, 2), two heads at 8 px).

Tolerances: against the unsharded port, rtol 2e-5 and atol 2e-6 x max(1,
|ref|) (the JAX package's own TP tests'), 3e-5 for the 5-step chains, as
there; against the JAX package ``ROADMAP.md``'s parity tolerances: 1e-4 for
the UNet and the classifier, 1e-4 x max|ref| for the guidance gradient, 5e-4
for a chain. int8 runs teacher-forced: every rounding of the sharded forward
is held to the unsharded forward's (scales to rtol 1e-6, plus 2^-20 (mean /
std)^2 for a group's offset, as ``tests/test_torch_quant.py``; q within one
level on at most 1e-3 of a map) and then replaced by it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from guided_diffusion_clip_tpu.utils.script_util import create_gaussian_diffusion as jax_diffusion
from guided_diffusion_clip_tpu_torch import classifier_sample, image_sample
from guided_diffusion_clip_tpu_torch.models.unet import EncoderUNetModel, UNetConfig, UNetModel
from guided_diffusion_clip_tpu_torch.parallel import dist as pdist
from guided_diffusion_clip_tpu_torch.parallel import groups, sp, tp
from guided_diffusion_clip_tpu_torch.training import train_loop as TL
from guided_diffusion_clip_tpu_torch.utils import logger
from guided_diffusion_clip_tpu_torch.utils.script_util import (
    create_classifier, create_model_and_diffusion, create_upstream_model, model_and_diffusion_defaults,
)
from test_torch_dist import CLI_CLASSIFIER, CLI_UNET, TINY, _flags, _random_pt
from test_torch_sp import (  # noqa: F401 (jax_step: a fixture)
    _check_cli_against_one_process, _jax_int8_values, _other_clis, _randomize, _samples_close, jax_step,
)
from test_torch_train_dist import rel
from torch_dist_worker import B, SP_CFG, TP3_CFG, TP_INPUTS, batches, make_loop, run_ranks, state, step
from torch_port_utils import clip_feat_pair, encoder_pair, nhwc, upstream_pair

torch.set_num_threads(2)

CLIP = dict(SP_CFG, num_classes=512)
CLF = dict(SP_CFG, out_channels=10, num_head_channels=16)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the JAX pairs, and what the ranks wrote at worlds 2, 3, 4."""
    d = tmp_path_factory.mktemp("tp")
    jclip, pclip, tclip = clip_feat_pair(CLIP, seed=0)
    jplain, pplain, tplain = upstream_pair(dict(SP_CFG, num_classes=None), seed=1)
    jclf, pclf, tclf = encoder_pair(CLF, "attention", seed=2)
    clip_cfg = dict(CLIP, variant="clip_feat", label_emb_type="mlp")
    wide_cfg = dict(TP3_CFG, num_classes=512, variant="clip_feat", label_emb_type="mlp")
    models = {
        "clip": (clip_cfg, {}, tclip.state_dict()),
        "clip8": (clip_cfg, {"conv_impl": "int8"}, tclip.state_dict()),
        "plain": (dict(SP_CFG, variant="unet"), {}, tplain.state_dict()),
        "clf_attention": (CLF, {"pool": "attention"}, tclf.state_dict()),
    }
    for i, (name, cfg, extra) in enumerate((
            ("new_order", dict(SP_CFG, use_new_attention_order=True), {}),
            ("heads1", dict(SP_CFG, num_heads=1), {}),  # the recipe's single head: the block runs whole
            ("no_scale_shift", dict(SP_CFG, use_scale_shift_norm=False), {}),
            ("super_res", dict(SP_CFG, in_channels=6, variant="super_res"), {}),
            ("sr_img_feat", dict(SP_CFG, in_channels=6, num_classes=512, variant="sr_img_feat",
                                 label_emb_type="mlp"), {}),
            ("clf_spatial", CLF, {"pool": "spatial"}),
            ("clf_adaptive", CLF, {"pool": "adaptive"}),
            ("wide", wide_cfg, {}),
            ("clf_wide", dict(TP3_CFG, out_channels=10, num_head_channels=16), {"pool": "attention"}))):
        cls = EncoderUNetModel if "pool" in extra else UNetModel
        models[name] = (cfg, extra, _randomize(cls(UNetConfig(**cfg), **extra), 20 + i).state_dict())
    models["wide8"] = (wide_cfg, {"conv_impl": "int8"}, models["wide"][2])
    rs = np.random.RandomState(0)
    inp = {"models": models, "x": torch.from_numpy(rs.uniform(-1, 1, (4, 3, 16, 16)).astype(np.float32)),
           "t": torch.tensor([0.0, 3.0, 9.0, 19.0]), "feat": torch.from_numpy(rs.randn(4, 512).astype(np.float32)),
           "feat2": torch.from_numpy(rs.randn(4, 512).astype(np.float32)),
           "img2": torch.from_numpy(rs.uniform(-1, 1, (4, 3, 16, 16)).astype(np.float32)),
           "low_res": torch.from_numpy(rs.uniform(-1, 1, (4, 3, 8, 8)).astype(np.float32)),
           "y": torch.tensor([1, 4, 7, 2])}
    inp["jax_int8"], jax_int8_out = _jax_int8_values(jclip, pclip, inp)
    torch.save(inp, d / TP_INPUTS)
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
        (d / f"tp_{name}.argv").write_text("\n".join([*flags, "--tensor_shard", "2", "--main_path",
                                                      str(d / f"tp_{name}")]))
    clis = _other_clis(d, rs)
    torch.save({name: (module, [*flags, "--tensor_shard", "2", "--main_path", str(d / "tp_clis" / name)], env)
                for name, (module, flags, env) in clis.items()}, d / "tp_clis.pt")
    for scenario, n in (("tp", 2), ("tp3", 3), ("tp4", 4)):
        run_ranks(scenario, str(d), n=n, timeout=400)
    load = lambda name, n: [torch.load(d / f"{name}_rank{r}.pt", weights_only=False) for r in range(n)]
    return {"dir": d, "inp": inp, "argv": argv, "clis": clis, "jax_int8_out": jax_int8_out,
            "jax": {"clip": (jclip, pclip), "plain": (jplain, pplain), "clf": (jclf, pclf)},
            "ranks": load("tp", 2), "cli": load("tp_cli", 2), "ranks3": load("tp3", 3), "ranks4": load("tp4", 4)}


def _close(got, ref, rtol=2e-5, atol=2e-6):
    """Within rtol and atol x max(1, |ref|): the random weights' outputs reach
    a few units, and f32 sums taken in another order (convs on the gathered
    channels, K3 on the rank's groups) differ by ~1e-6 of that."""
    ref = ref.detach().float()
    np.testing.assert_allclose(got.detach().float().numpy(), ref.numpy(), rtol=rtol,
                               atol=atol * max(1.0, float(ref.abs().max())))


FORWARDS = ["fwd_clip", "fwd_plain", "fwd_new_order", "fwd_heads1", "fwd_no_scale_shift", "fwd_super_res",
            "fwd_sr_img_feat", "cache_full", "cache_deep", "cache_shallow"]


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", FORWARDS)
def test_forward_matches_unsharded(world, name):
    """Each UNet variant under TP 2 against the same call unsharded: the
    fork's CLIP variant, the plain UNet, the new head order
    (``[q|k|v][head][d]``: three slices of qkv's rows a rank), a single head
    (``num_heads % T != 0``: the block runs whole on the gathered channels),
    the emb projection without scale-shift, the SR variants, and DeepCache's
    full forward, its cached deep feature (the rank's channels) and the
    shallow forward from it. The output is whole and the same on both
    ranks."""
    r0, r1 = world["ranks"]
    got, ref = r0[name]
    assert ref.abs().max() > 0.1
    if name == "cache_deep":  # the rank's channels of the deep feature
        assert got.shape[1] * 2 == ref.shape[1]
        got = torch.cat([r0[name][0], r1[name][0]], dim=1)
    else:
        assert torch.equal(got, r1[name][0])
    _close(got, ref)


@pytest.mark.timeout(600)
def test_forward_matches_jax(world):
    """The fork's variant under TP 2 against the JAX model unsharded (1e-4)."""
    jm, params = world["jax"]["clip"]
    inp = world["inp"]
    ref = jm.apply({"params": params}, jnp.asarray(nhwc(inp["x"])), jnp.asarray(inp["t"].numpy()),
                   clip_feat=jnp.asarray(inp["feat"].numpy()))
    np.testing.assert_allclose(nhwc(world["ranks"][0]["fwd_clip"][0]), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.timeout(600)
def test_pure_model_layout(world):
    """One data group of four model ranks (world 4, T = 4; JAX's ('model', N)
    latency mesh): 8 channels a rank at the first level; the two heads do
    not split over four, so the attention blocks run whole."""
    for m, r in enumerate(world["ranks4"]):
        assert r["groups_t4"] == (4, m, 0, 1)
        got, ref = r["fwd_clip"]
        _close(got, ref)


@pytest.mark.timeout(600)
def test_indivisible_channels_stay_whole(world):
    """As JAX's ``constrain_channels`` falls back: a 3-channel map (the RGB
    input) stays whole on every rank, a 32-channel one is 16 a rank."""
    for r in world["ranks"]:
        assert r["indivisible"] == (True, (2, 16, 4, 4), (2, 3, 4, 4), (2, 16, 4, 4))


@pytest.mark.timeout(600)
@pytest.mark.parametrize("pool", ["attention", "spatial", "adaptive"])
def test_classifier_matches_unsharded(world, pool):
    """The classifier's logits, every rank's the same, against the unsharded
    classifier; the head runs whole on the gathered channels (the attention
    pool, the spatial pool's means, the adaptive pool's 1x1 conv). The
    attention pool's also against the JAX classifier (1e-4)."""
    r0, r1 = world["ranks"]
    got, ref = r0[f"clf_{pool}"]
    assert torch.equal(got, r1[f"clf_{pool}"][0])
    _close(got, ref)
    if pool == "attention":
        jm, params = world["jax"]["clf"]
        inp = world["inp"]
        jref = jm.apply({"params": params}, jnp.asarray(nhwc(inp["x"])), jnp.asarray(inp["t"].numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=1e-4, atol=1e-4)


def _guidance_jax(world):
    jm, params = world["jax"]["clf"]
    inp = world["inp"]

    def log_prob(x):
        logits = jm.apply({"params": params}, x, jnp.asarray(inp["t"].numpy()))
        lp = jax.nn.log_softmax(logits, axis=-1)
        return jnp.sum(jnp.take_along_axis(lp, jnp.asarray(inp["y"].numpy())[:, None], axis=-1)) * 3.0

    return np.asarray(jax.grad(log_prob)(jnp.asarray(nhwc(inp["x"]))))


@pytest.mark.timeout(600)
@pytest.mark.parametrize("T", [2, 3, 4])
def test_guidance_gradient_matches_unsharded_and_jax(world, T):
    """``classifier_cond_fn`` under TP (the replicated log-probability
    weighted by ``tp.owner_weight()``, the ranks' gradients summed): on every
    rank the unsharded gradient; at T = 2 and 4 within 1e-4 x max|ref| of
    ``jax.grad`` of the JAX classifier's, at T = 3 on the 96-wide classifier
    (groups split across the ranks)."""
    ranks = {2: world["ranks"], 3: world["ranks3"], 4: world["ranks4"]}[T]
    for r in ranks:
        got, ref = r["guidance"]
        assert ref.abs().max() > 0
        _close(got, ref)
        assert torch.equal(got, ranks[0]["guidance"][0])
    if T != 3:
        jref = _guidance_jax(world)
        got = ranks[0]["guidance"][0]
        np.testing.assert_allclose(nhwc(got), jref, rtol=0, atol=1e-4 * np.abs(jref).max())


def _check_backward(ranks, T):
    """Each rank backpropagates its copy of the loss: the input's gradient
    and the parameters' gradients summed over the ranks are T times the
    unsharded ones (1e-5 relative L2 over all parameters, a sum over ranks
    taken in another order)."""
    ref = ranks[0]["ref"]
    x = sum(r["got"]["x"] for r in ranks)
    _close(x, T * ref["x"])
    summed = {n: sum(r["got"]["params"][n] for r in ranks) for n in ref["params"]}
    assert rel(summed, {n: T * g for n, g in ref["params"].items()}) <= 1e-5


@pytest.mark.timeout(600)
@pytest.mark.parametrize("case", ["remat", "groups_split"])
def test_backward_matches_unsharded(world, case):
    """``remat``: the CLIP UNet with ``use_checkpoint`` in train mode at T =
    2, every ResBlock and AttentionBlock (and their gathers) recomputed in
    the backward; ``groups_split``: the 96-wide UNet at T = 3, each
    GroupNorm's backward on the gathered channels."""
    if case == "remat":
        _check_backward([r["remat"] for r in world["ranks"]], 2)
    else:
        _check_backward([r["backward"] for r in world["ranks3"]], 3)


def _check_int8(res: dict):
    rd = res["readings"]
    assert rd and any(x["kind"] == "gn" for x in rd) and any(x["kind"] == "conv" for x in rd)
    for x in rd:
        if x["kind"] == "gn":
            assert x["s_err"] <= x["s_tol"] and x["q_max"] <= 1 and x["flips"] <= max(1, 1e-3 * x["n"]), x
        else:
            assert x["max"] <= 1e-2 * x["ref_max"] and x["l2"] <= 5e-3, x
    assert len(res["scales"]) == sum(x["kind"] == "conv" for x in rd) + 1  # and the head's
    for got, ref in res["scales"]:
        assert abs(got - ref) <= 1e-6 * ref, (got, ref)
    d = (res["out"] - res["ref"]).abs()
    assert d.max() <= 1e-2 * res["ref"].abs().max() and d.norm() <= 5e-3 * res["ref"].norm()


@pytest.mark.timeout(600)
@pytest.mark.parametrize("T", [2, 3])
def test_int8_forward_teacher_forced(world, T):
    """The int8 UNet under TP against its unsharded forward, every rounding
    held and then forced: each quantizing GroupNorm's per-image scale (a max
    over all the channels: the bound reduced over the model group) within
    rtol 1e-6 (+ the offset term) and its q within one level on at most 1e-3
    of the rank's channels; each per-tensor scale of ``int8_conv`` within
    rtol 1e-6; each int8 conv's output (the rank's channels) and the unforced
    head's within 1e-2 x max|ref| and 5e-3 relative L2. T = 3 on the 96-wide
    model, its K4s on the gathered channels."""
    for r in (world["ranks"] if T == 2 else world["ranks3"]):
        _check_int8(r["int8"])


@pytest.mark.timeout(600)
def test_int8_forward_teacher_forced_matches_jax(world):
    """The same int8 fork UNet under TP 2, teacher-forced to the JAX
    package's int8 forward of the same weights and inputs (its captured
    intermediates, the rank's channels of each): the GroupNorms' scales and
    q and the int8 convs' outputs as above; the unforced head's output
    within 1e-3 x max(1, |ref|) of JAX's on all but 0.5 % of the values and
    5e-3 relative L2 (``_close_but_flips``)."""
    from test_torch_quant import _close_but_flips

    for r in world["ranks"]:
        rd = r["int8"]["jax"]["readings"]
        assert [x["kind"] for x in rd] == [x["kind"] for x in r["int8"]["readings"]]
        for x in rd:
            if x["kind"] == "gn":
                assert x["s_err"] <= x["s_tol"] and x["q_max"] <= 1 and x["flips"] <= max(1, 1e-3 * x["n"]), x
            else:
                assert x["max"] <= 1e-2 * x["ref_max"] and x["l2"] <= 5e-3, x
    got = nhwc(world["ranks"][0]["int8"]["jax"]["out"])
    ref = world["jax_int8_out"]
    _close_but_flips(got, ref, 1e-3, max(1.0, np.abs(ref).max()))


@pytest.mark.timeout(600)
def test_groups_split_forward_matches_unsharded(world):
    """T = 3 on the 96-wide model: 32 channels a rank, 10 2/3 of the 32
    groups of 3, so every GroupNorm runs on the gathered channels; the 3
    heads at 192 channels split one a rank. The set-up warned."""
    for r in world["ranks3"]:
        assert any("does not divide the 32 GroupNorm groups" in w for w in r["warned"])
        got, ref = r["fwd_wide"]
        _close(got, ref)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", ["ddim", "cfg"])
def test_chains_match_unsharded(world, name):
    """5-step DDIM chains from one generator (x whole on every rank, so each
    draws what the unsharded chain draws), to rtol 3e-5 (the JAX package's
    TP chain test's) and atol 1e-4 of the [-1, 1] range; under ``cfg``
    (classifier-free guidance over ``clip_feat`` at 2.5) too. The plain chain
    also against the JAX loop from the same x_T (5e-4)."""
    got, ref = world["ranks"][0][name]
    _close(got, ref, rtol=3e-5, atol=1e-4)
    if name == "ddim":
        jm, params = world["jax"]["plain"]
        x_t = torch.randn((4, 3, 16, 16), generator=torch.Generator().manual_seed(3))
        diffusion = jax_diffusion(steps=20, noise_schedule="cosine", learn_sigma=True, rescale_learned_sigmas=True,
                                  timestep_respacing="ddim5")
        jref = diffusion.ddim_sample_loop(lambda x, t, **k: jm.apply({"params": params}, x, t), (4, 16, 16, 3),
                                          jax.random.key(0), noise=jnp.asarray(nhwc(x_t)))
        np.testing.assert_allclose(nhwc(got), np.asarray(jref), rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def one_rank(world):
    """The one-process port's train steps on B rows and on 2B rows."""
    out = {}
    for key, n in (("train", B), ("train_2b", 2 * B)):
        loop = make_loop(str(world["dir"] / f"one_rank_{n}"), batch_size=n)
        step(loop, batches(n, 1), slice(None))
        out[key] = state(loop)
    return out


@pytest.mark.timeout(600)
@pytest.mark.parametrize("mode", ["tree", "zero1", "fsdp", "remat_tree"])
def test_train_step_matches_dp_step(world, one_rank, mode):
    """One step of the tiny CLIP UNet with TP 2 under DDP, ZeRO-1, FSDP2 and
    DDP with ``use_checkpoint``, both ranks on the same B rows, against the
    one-rank step on them: the gradient and the parameters within 1e-5
    relative L2, the logged loss within 1e-6."""
    for r in world["ranks"]:
        got, ref = r[f"train_{mode}"], one_rank["train"]
        assert rel(got["grad"], ref["grad"]) <= 1e-5
        assert rel(got["params"], ref["params"]) <= 1e-5
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-6)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("mode", ["tree", "zero1", "fsdp", "remat_tree"])
def test_train_step_gradient_matches_jax(world, jax_step, mode):
    """The TP 2 train steps against ``jax.value_and_grad`` of the JAX step's
    loss on the same rows, t and noise: the gradient within 1e-4 relative L2
    over all parameters, the logged loss within 1e-4."""
    loss, grads = jax_step
    for r in world["ranks"]:
        got = r[f"train_{mode}"]
        assert rel(got["grad"], grads) <= 1e-4
        assert got["loss"] == pytest.approx(loss, rel=1e-4)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("mode", ["tree", "zero1", "fsdp"])
def test_dp_tp_step_matches_dp_step(world, one_rank, mode):
    """Two data groups of two model ranks (world 4; JAX's ('data', 2) x
    ('model', 2)): DDP, ZeRO-1 and FSDP2 over the four ranks, each data
    group on its half of a batch of 2B, against the one-rank step on the 2B
    rows."""
    assert [r["groups"] for r in world["ranks4"]] == [(2, m, d, 2) for d in range(2) for m in range(2)]
    for r in world["ranks4"]:
        got, ref = r[f"train_{mode}"], one_rank["train_2b"]
        assert rel(got["grad"], ref["grad"]) <= 1e-5
        assert rel(got["params"], ref["params"]) <= 1e-5
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-6)


@pytest.mark.timeout(600)
def test_scale_shift_rows(world):
    """Under ``use_scale_shift_norm`` the emb projection's output is [scale C
    | shift C]: a rank's rows are its C/T of the scale and its C/T of the
    shift (two slices), not a contiguous 2C/T."""
    for m, r in enumerate(world["ranks"]):
        rows, full = r["emb_rows"]
        scale, shift = full.chunk(2, dim=1)
        torch.testing.assert_close(rows, torch.cat([scale[:, 16 * m:16 * (m + 1)], shift[:, 16 * m:16 * (m + 1)]], 1),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.timeout(600)
def test_ranks_groups_refusals_and_stale_state(world):
    """The world's factoring, the refusals the ranks met (T not dividing the
    world, both sharding flags to the loop and to a CLI, TP while SP is set
    and SP while TP is), the hooks as the identity before TP was set, the
    loop clearing TP left on and pinning TP to its own groups (JAX
    ``test_trainloop_clears_stale_tensor_state``,
    ``test_trainloop_repins_ambient_tp_to_loop_mesh``), and ``zero_state``
    on the rank's channels."""
    for m, r in enumerate(world["ranks"]):
        assert r["groups"] == (2, m, 0, 1)
        assert "does not divide the world of 2" in r["refuse_T4_at_world2"]
        for k in ("both_flags", "cli_both", "tp_under_sp", "sp_under_tp"):
            assert "mutually exclusive" in r[f"refuse_{k}"], k
        assert r["identity"] and r["stale_cleared"] and r["repinned"]
        assert r["cache_zero_state"] == tuple(r["cache_deep"][0].shape) == (4, 32, 16, 16)


def test_hooks_are_identity_when_inactive():
    """As the JAX package's (``test_hooks_are_identity_when_inactive``):
    without TP every hook returns its input itself."""
    tp.clear_tensor_sharding()
    x = torch.ones(2, 32, 4, 4)
    assert tp.shard_channels(x) is x and tp.gather_channels(x, 64) is x and tp.reduce_sum_(x) is x
    assert tp.run_whole(lambda u: u, x, 64) is x
    assert not tp.active() and not tp.sharded() and tp.size() == 1 and tp.local_shape((2, 32, 4, 4)) == (2, 32, 4, 4)
    assert (groups.data_rank(), groups.data_size(), tp.owner_weight()) == (0, 1, 1.0)


def test_refusals_outside_torchrun(monkeypatch):
    """Outside a process group ``--tensor_shard 2`` cannot run: the loop, a
    CLI's check and ``set_tensor_sharding`` say to launch under torchrun;
    with ``--spatial_shard`` both are refused (JAX
    ``test_spatial_and_tensor_shard_flags_are_exclusive``)."""
    for k in pdist.TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="launch under torchrun"):
        TL.check_ported(tensor_shard=2)
    with pytest.raises(ValueError, match="launch under torchrun"):
        tp.set_tensor_sharding(2)
    with pytest.raises(SystemExit, match="launch under torchrun"):
        sp.check_flags(0, 2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        TL.check_ported(tensor_shard=4, spatial_shard=2)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", ["image", "classifier"])
def test_cli_samples_match_one_process(world, name):
    """``image_sample`` and ``classifier_sample`` with ``--tensor_shard 2``
    on two ranks (one data group): one ``.npz``, the one-process run's
    samples (and labels), and TP cleared when the CLI returns."""
    main = {"image": image_sample.main, "classifier": classifier_sample.main}[name]
    one = main([*world["argv"][name], "--main_path", str(world["dir"] / f"one_{name}")])["path"]
    logger.reset()
    got_path = world["cli"][0][name]
    assert world["cli"][1][name] == got_path and not world["cli"][0][f"{name}_after"]
    got, want = np.load(got_path), np.load(one)
    assert got["arr_0"].shape == want["arr_0"].shape
    _samples_close(got["arr_0"], want["arr_0"])
    if name == "classifier":
        np.testing.assert_array_equal(got["arr_1"], want["arr_1"])


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", ["image_train", "super_res_train", "super_res_unsup", "classifier_train",
                                  "super_res_sample", "depth_sweep", "clip_guided"])
def test_other_clis_match_one_process(world, name):
    """The other CLIs that the JAX package runs with ``--tensor_shard``, at
    their tests' sizes (``tests/test_torch_sp.py``'s), on two ranks with
    ``--tensor_shard 2`` against one process: after two steps the trainers'
    AdamW first moments within 1e-5 relative L2 and their parameters and
    EMAs within 1e-4, the samplers' images as ``_samples_close``, as the SP
    test holds them."""
    _check_cli_against_one_process(world, name, "tp_clis")
