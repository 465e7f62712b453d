"""The port's one-GPU trainer (``training/``) against the JAX package's, f32 on the CPU.

One ``TrainLoop.run_step`` of the port against one of the JAX loop's jitted
step, from the same weights (``state_dict_from_flax``), batch, timesteps (the
same ``np.random.default_rng(seed)``) and noise (the JAX step's own draws,
given to the port as ``noise``), dropout 0. Loss, grad_norm and param_norm
within 1e-4 relative; the Adam moments, the updated parameters and every EMA
within 1e-4 relative in L2 over all parameters together, as the norms are
taken. Not element by element: a gradient that is zero in exact arithmetic
(an attention block's key bias, a conv bias that a one-channel GroupNorm
group removes) is rounding noise in both frameworks, and Adam's first update
g / (|g| + eps) turns that noise into +-lr. The update's arithmetic is held
element by element instead against optax's on the same gradients
(``test_update_matches_optax``).
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from guided_diffusion_clip_tpu.models.clip_models import UNetModel_clip_feat as JaxClipFeat
from guided_diffusion_clip_tpu.models.unet import UNetConfig as JaxConfig
from guided_diffusion_clip_tpu.parallel.mesh import create_mesh
from guided_diffusion_clip_tpu.training import resample as JR
from guided_diffusion_clip_tpu.training.train_loop import TrainLoop as JaxTrainLoop
from guided_diffusion_clip_tpu.utils import checkpoint as jckpt
from guided_diffusion_clip_tpu.utils import logger as jlogger
from guided_diffusion_clip_tpu.utils.script_util import create_gaussian_diffusion as jax_diffusion
from guided_diffusion_clip_tpu_torch.models.clip_models import UNetModel_clip_feat
from guided_diffusion_clip_tpu_torch.models.unet import UNetConfig, UNetModel
from guided_diffusion_clip_tpu_torch.training import resample as TR
from guided_diffusion_clip_tpu_torch.training import train_loop as TL
from guided_diffusion_clip_tpu_torch.utils import checkpoint as ckpt
from guided_diffusion_clip_tpu_torch.utils import logger
from guided_diffusion_clip_tpu_torch.utils.convert import state_dict_from_flax
from guided_diffusion_clip_tpu_torch.utils.script_util import create_gaussian_diffusion
from torch_port_utils import nchw, nhwc, random_params

torch.set_num_threads(2)

# the fork's 128 px recipe, shrunk: CLIP conditioning, scale-shift, one head
KW = dict(image_size=16, in_channels=3, model_channels=32, out_channels=6, num_res_blocks=1,
          attention_resolutions=(2,), channel_mult=(1, 2), num_classes=512, num_heads=1,
          use_scale_shift_norm=True)
B = 4
LOOP = dict(batch_size=B, lr=1e-4, ema_rate="0.9,0.99", log_interval=10**9, save_interval=10**9,
            weight_decay=0.05, lr_anneal_steps=10, seed=3)


def _diffusion_kw():
    return dict(steps=20, noise_schedule="cosine", learn_sigma=True)


@pytest.fixture(scope="module")
def weights():
    """(jax model, numpy params): every weight random."""
    jm = JaxClipFeat(JaxConfig(**KW))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32), clip_feat=jnp.zeros((1, 512))
    ))["params"]
    return jm, jax.device_get(random_params(shapes, 0))


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return rs.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32), rs.standard_normal((B, 512)).astype(np.float32)


def _port_model(params, **cfg):
    model = UNetModel_clip_feat(UNetConfig(**dict(KW, **cfg)))
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


def _port_loop(params, tmp=None, **kw):
    logger.configure_dir(tmp or tempfile.mkdtemp(), format_strs=[])
    return TL.TrainLoop(model=_port_model(params), diffusion=create_gaussian_diffusion(**_diffusion_kw()),
                        data=None, **{**LOOP, "microbatch": -1, **kw})


def _jax_step(jm, params, x, feat, **kw):
    """One step of the JAX loop on a one-device mesh: (loop, metrics, the
    noise its step drew, NHWC)."""
    jlogger.configure_dir(dir=tempfile.mkdtemp(), format_strs=[])
    mesh = create_mesh(axes=(("data", 1),), devices=jax.devices()[:1])
    loop = JaxTrainLoop(model=jm, diffusion=jax_diffusion(**_diffusion_kw()), data=iter(()), mesh=mesh,
                        init_params=params, **{**LOOP, **kw})
    _, step_rng = jax.random.split(loop.rng)  # what run_step splits off, then the train step's own splits
    noise = np.concatenate([
        np.asarray(jax.random.normal(jax.random.split(r)[1], (B // loop.n_micro, 16, 16, 3)))
        for r in jax.random.split(step_rng, loop.n_micro)
    ])
    loop.run_step(x, {"clip_feat": feat})
    return loop, jax.device_get(loop._pending_log[2]), noise


def _rel(ours: dict, theirs: dict) -> float:
    """Relative L2 distance over all entries of two name -> array dicts."""
    num = sum(float(np.sum((np.asarray(ours[k], np.float64) - np.asarray(theirs[k], np.float64)) ** 2))
              for k in theirs)
    den = sum(float(np.sum(np.asarray(theirs[k], np.float64) ** 2)) for k in theirs)
    return (num / den) ** 0.5


def _named(loop, tensors):
    return {n: t.detach().numpy() for n, t in zip(loop.names, tensors)}


@pytest.mark.parametrize("opt_impl,microbatch,loss_weighting", [
    ("tree", -1, ""), ("tree", 2, ""), ("flat", -1, ""), ("flat", 2, ""), ("tree", -1, "min_snr_5"),
])
def test_train_step_matches_jax(weights, opt_impl, microbatch, loss_weighting):
    jm, params = weights
    x, feat = _batch()
    kw = dict(opt_impl=opt_impl, microbatch=microbatch, loss_weighting=loss_weighting)
    jloop, jmet, noise = _jax_step(jm, params, x, feat, **kw)
    loop = _port_loop(params, **kw)
    loop.run_step(nchw(x), {"clip_feat": torch.from_numpy(feat)}, noise=nchw(noise))
    met = loop._fetch(loop._pending_log[2])
    for k in ("loss", "grad_norm", "param_norm"):
        np.testing.assert_allclose(met[k], np.asarray(jmet[k]), rtol=1e-4, err_msg=k)
    for k in ("loss_vec", "mse_vec", "vb_vec"):
        np.testing.assert_allclose(met[k], np.asarray(jmet[k]), rtol=1e-4, atol=1e-6, err_msg=k)

    if opt_impl == "flat":
        unravel = jloop._unravel
        jm_, jv = unravel(jloop.opt_state["m"]), unravel(jloop.opt_state["v"])
        assert int(jloop.opt_state["count"]) == loop.opt_count == 1
    else:
        adam = next(s for s in jloop.opt_state if isinstance(s, optax.ScaleByAdamState))
        jm_, jv = adam.mu, adam.nu
        assert int(adam.count) == loop.opt_count == 1
    state = [loop.opt.state[p] for p in loop.params]
    for name, ours, theirs in (
        ("params", _named(loop, loop.params), jloop.params),
        ("m", _named(loop, [s["exp_avg"] for s in state]), jm_),
        ("v", _named(loop, [s["exp_avg_sq"] for s in state]), jv),
        *((f"ema {r}", _named(loop, e), jloop._ema_tree(i)) for i, (r, e) in enumerate(zip(loop.ema_rate,
                                                                                          loop.ema_params))),
    ):
        err = _rel(ours, state_dict_from_flax(jax.device_get(theirs)))
        assert err <= 1e-4, f"{name}: relative L2 {err:.3g}"
    # the step moved the parameters by what the JAX step moved them, in L2
    old = state_dict_from_flax(params)
    moved = {k: v - old[k].numpy() for k, v in _named(loop, loop.params).items()}
    jmoved = {k: v.numpy() - old[k].numpy() for k, v in state_dict_from_flax(jax.device_get(jloop.params)).items()}
    assert abs(np.sqrt(sum(np.sum(v**2) for v in moved.values()))
               / np.sqrt(sum(np.sum(v**2) for v in jmoved.values())) - 1) <= 1e-2


@pytest.mark.parametrize("opt_impl", ["tree", "flat"])
def test_update_matches_optax(weights, opt_impl):
    """Three updates from the same given gradients: AdamW with weight decay
    and the annealed rate, and both EMAs, element by element against
    ``optax.adamw`` and ``optax.incremental_update`` (the JAX loop's tree
    path), the rate of update k taken at count k."""
    _, params = weights
    loop = _port_loop(params, opt_impl=opt_impl, lr=1e-3, weight_decay=0.1, lr_anneal_steps=4)
    tree = state_dict_from_flax(params)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in tree.items()}
    opt = optax.adamw(lambda c: 1e-3 * jnp.maximum(0.0, 1.0 - c / 4), weight_decay=0.1)
    jstate, jema = opt.init(jparams), [dict(jparams), dict(jparams)]
    rs = np.random.RandomState(9)
    for _ in range(3):
        grads = {k: (0.01 * rs.standard_normal(v.shape)).astype(np.float32) for k, v in tree.items()}
        for n, p in zip(loop.names, loop.params):
            p.grad = torch.from_numpy(grads[n]).clone()
        loop.update()
        upd, jstate = opt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        jema = [optax.incremental_update(jparams, e, step_size=1.0 - r) for e, r in zip(jema, loop.ema_rate)]
    assert loop.opt_count == 3
    for n, p in zip(loop.names, loop.params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[n]), rtol=1e-5, atol=1e-7, err_msg=n)
        for e, je in zip(loop.ema_params, jema):
            np.testing.assert_allclose(e[loop.names.index(n)].numpy(), np.asarray(je[n]), rtol=1e-5, atol=1e-7,
                                       err_msg=n)


def test_use_checkpoint_gives_the_same_gradients(weights):
    """ResBlocks and AttentionBlocks recomputed in the backward
    (``torch.utils.checkpoint``) give the gradients of the plain backward
    within 1e-6, dropout included (its mask is drawn again from the replayed
    generator state)."""
    _, params = weights
    x, feat = _batch(1)
    grads = []
    for remat in (False, True):
        model = _port_model(params, use_checkpoint=remat, dropout=0.2).train()
        torch.manual_seed(5)
        out = model(nchw(x), torch.tensor([1, 5, 9, 19]), clip_feat=torch.from_numpy(feat), img2=nchw(x))
        out.square().mean().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6, atol=1e-6, msg=n)


def test_metrics_are_logged_one_step_late(weights):
    """``run_step`` launches step k, then logs step k - 1's metrics: after
    step 1 the logger holds step 0's values and step 1's wait in
    ``_pending_log``; ``flush_metrics`` logs them."""
    _, params = weights
    loop = _port_loop(params)
    x, feat = _batch(2)
    loop.run_step(nchw(x), {"clip_feat": torch.from_numpy(feat)})
    assert "loss" not in logger.getkvs() and loop._pending_log[0] == 0
    step0 = loop._fetch(loop._pending_log[2])
    loop.step = 1
    loop.run_step(nchw(x), {"clip_feat": torch.from_numpy(feat)})
    kvs = dict(logger.getkvs())
    assert kvs["step"] == 0 and kvs["loss"] == pytest.approx(float(step0["loss"]))
    assert loop._pending_log[0] == 1
    step1 = loop._fetch(loop._pending_log[2])
    loop.flush_metrics()
    assert loop._pending_log is None and logger.getkvs()["step"] == 1
    assert logger.getkvs()["loss"] == pytest.approx((float(step0["loss"]) + float(step1["loss"])) / 2)


@pytest.mark.parametrize("save_impl,resume_impl", [("tree", "tree"), ("flat", "flat"), ("tree", "flat")])
def test_resume_reproduces_the_next_step(weights, tmp_path, save_impl, resume_impl):
    """Save at step 2, resume from ``model000002.pt`` (EMA and ``opt000002.pt``
    beside it): the resumed step 3 equals the uninterrupted run's step 3, with
    the same batch, t and noise; across ``opt_impl`` within 1e-6."""
    _, params = weights
    x, feat = _batch(3)
    noises = [torch.from_numpy(np.random.RandomState(10 + i).standard_normal((B, 3, 16, 16)).astype(np.float32))
              for i in range(3)]
    cond = {"clip_feat": torch.from_numpy(feat)}
    full = _port_loop(params, str(tmp_path / "full"), opt_impl=save_impl)
    for i in range(2):
        full.step = i
        full.run_step(nchw(x), cond, noise=noises[i])
    full.step = 2
    full.save()
    sampler_state = full.np_rng.bit_generator.state
    full.run_step(nchw(x), cond, noise=noises[2])

    path = os.path.join(str(tmp_path / "full"), ckpt.checkpoint_name("model", 2))
    resumed = _port_loop(params, str(tmp_path / "resumed"), opt_impl=resume_impl, resume_checkpoint=path)
    assert resumed.resume_step == 2 and resumed.step == 0 and resumed.opt_count == 2
    resumed.np_rng.bit_generator.state = sampler_state  # the uninterrupted run's next draw of t
    resumed.run_step(nchw(x), cond, noise=noises[2])
    same = torch.equal if save_impl == resume_impl else (
        lambda a, b: torch.allclose(a, b, rtol=1e-6, atol=1e-7))
    for a, b in zip((*resumed.params, *sum(resumed.ema_params, [])), (*full.params, *sum(full.ema_params, []))):
        assert same(a.detach(), b.detach())
    for p, q in zip(resumed.params, full.params):
        for k in ("exp_avg", "exp_avg_sq"):
            assert same(resumed.opt.state[p][k], full.opt.state[q][k])
    assert resumed.opt_count == full.opt_count == 3


def test_checkpoints_load_in_the_jax_package(weights, tmp_path):
    """The port's ``model*.pt`` and ``ema_*.pt`` load through the JAX
    package's ``load_params``; the JAX forward on them matches the port's
    within 1e-4."""
    jm, params = weights
    loop = _port_loop(params, str(tmp_path), lr=1e-2)
    x, feat = _batch(4)
    loop.run_step(nchw(x), {"clip_feat": torch.from_numpy(feat)})
    loop.step = 1
    loop.save()
    assert sorted(os.listdir(tmp_path)) == ["ema_0.99_000001.pt", "ema_0.9_000001.pt", "model000001.pt",
                                            "opt000001.pt"]
    t = np.array([2, 7, 11, 19], np.int32)
    apply = jax.jit(jm.apply)
    for name, tensors in (("model000001.pt", loop.params), ("ema_0.9_000001.pt", loop.ema_params[0])):
        jparams = jckpt.load_params(str(tmp_path / name), params)
        ref = np.asarray(apply({"params": jparams}, jnp.asarray(x), jnp.asarray(t), clip_feat=jnp.asarray(feat)))
        model = _port_model(params).eval()
        model.load_state_dict(dict(zip(loop.names, tensors)), strict=True)
        with torch.no_grad():
            out = nhwc(model(nchw(x), torch.from_numpy(t), clip_feat=torch.from_numpy(feat)))
        assert np.abs(ref).max() > 0.1
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4, err_msg=name)
    # the sampling model loads the trained weights strict=True
    sampling = UNetModel_clip_feat(UNetConfig(**KW), dtype=torch.bfloat16)
    ckpt.load_model_weights(sampling, str(tmp_path / "model000001.pt"))


def test_cond_dropout():
    g = torch.Generator().manual_seed(0)
    cond = {"clip_feat": torch.randn(6, 512), "img2": torch.randn(6, 3, 4, 4), "y": torch.arange(6)}
    dropped = TL.drop_conditioning(g, cond, 1.0, null_y=9)
    assert torch.count_nonzero(dropped["clip_feat"]) == 0 and (dropped["y"] == 9).all()
    assert dropped["img2"] is cond["img2"]
    assert TL.drop_conditioning(g, cond, 0.0) is cond
    half = TL.drop_conditioning(torch.Generator().manual_seed(1), cond, 0.5, null_y=9)
    rows = (half["clip_feat"] == 0).all(dim=1)
    assert torch.equal(rows, half["y"] == 9)
    assert torch.equal(half["clip_feat"][~rows], cond["clip_feat"][~rows])
    with pytest.raises(ValueError, match="null class"):
        TL.drop_conditioning(g, {"y": torch.arange(3)}, 0.5)


def test_cond_null_y_outside_the_table_raises():
    cfg = UNetConfig(**dict(KW, num_classes=10, variant="unet", label_emb_type="embedding"))
    logger.configure_dir(tempfile.mkdtemp(), format_strs=[])
    kw = dict(diffusion=create_gaussian_diffusion(**_diffusion_kw()), data=None, microbatch=-1, cond_dropout=0.1,
              **LOOP)
    with pytest.raises(ValueError, match="outside the Embed table"):
        TL.TrainLoop(model=UNetModel(cfg), cond_null_y=10, **kw)
    TL.TrainLoop(model=UNetModel(cfg), cond_null_y=9, **kw)


def test_opt_impl_values_run_one_optimizer(weights):
    """``opt_impl`` tree and flat are two layouts of one arithmetic in the JAX
    loop; the port runs one AdamW for both (``foreach`` on the CPU, fused on
    the card), with JAX's betas and eps and the loop's weight decay."""
    _, params = weights
    opts = [_port_loop(params, opt_impl=impl).opt for impl in ("tree", "flat")]
    assert all(type(o) is torch.optim.AdamW for o in opts)
    assert opts[0].defaults == opts[1].defaults
    d = opts[0].defaults
    assert (d["betas"], d["eps"], d["weight_decay"], d["foreach"], d["fused"]) == (
        (0.9, 0.999), 1e-8, LOOP["weight_decay"], True, None)


@pytest.mark.parametrize("option", [
    dict(param_sharding="fsdp"), dict(opt_impl="zero1"), dict(spatial_shard=2), dict(tensor_shard=2),
    dict(ckpt_backend="tensorstore"),
])
def test_unported_options_are_refused(weights, option):
    """``fsdp``, ``zero1``, ``spatial_shard`` and ``tensor_shard`` need a
    process group (``tests/test_torch_train_dist.py``,
    ``tests/test_torch_sp.py`` and ``tests/test_torch_tp.py`` run them on
    more than one rank); ``ckpt_backend`` takes flax or orbax only."""
    _, params = weights
    error, match = {"param_sharding": (ValueError, "need a process group"),
                    "opt_impl": (ValueError, "need a process group"),
                    "spatial_shard": (ValueError, "needs a process group"),
                    "tensor_shard": (ValueError, "tensor_shard 2 needs a process group"),
                    "ckpt_backend": (ValueError, "ckpt_backend 'tensorstore'")}[next(iter(option))]
    with pytest.raises(error, match=match):
        _port_loop(params, **option)


@pytest.mark.parametrize("name", ["uniform", "loss-second-moment"])
def test_samplers_draw_as_jax(name):
    """The same t and weights from the same np.random.Generator; the
    loss-aware sampler after its warm-up too."""
    ours, theirs = TR.create_named_schedule_sampler(name, 20), JR.create_named_schedule_sampler(name, 20)
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    feed = np.random.RandomState(5)
    for _ in range(30):
        (t1, w1), (t2, w2) = ours.sample(16, r1), theirs.sample(16, r2)
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_array_equal(w1, w2)
        assert t1.dtype == np.int32 and w1.dtype == np.float32
        if name != "uniform":
            losses = feed.uniform(0, 2, 16) * (1 + t1)
            ours.update_with_local_losses(t1, losses)
            theirs.update_with_all_losses(t1.tolist(), losses.tolist())
    if name != "uniform":
        assert ours._warmed_up()
        np.testing.assert_array_equal(ours.weights(), theirs.weights())
        assert not np.allclose(ours.weights(), ours.weights().mean())


def test_find_resume_checkpoint(tmp_path, monkeypatch):
    for step in (5, 40, 12):
        (tmp_path / ckpt.checkpoint_name("model", step)).write_bytes(b"")
    (tmp_path / "model000099.flax").write_bytes(b"")
    monkeypatch.setenv("DIFFUSION_BLOB_LOGDIR", str(tmp_path))
    monkeypatch.delenv("DIFFUSION_AUTO_RESUME", raising=False)
    assert TL.find_resume_checkpoint() is None
    monkeypatch.setenv("DIFFUSION_AUTO_RESUME", "1")
    assert TL.find_resume_checkpoint() == str(tmp_path / "model000040.pt")
    assert ckpt.parse_resume_step_from_filename("/a/model000040.pt") == 40
    assert ckpt.parse_resume_step_from_filename("/a/ema_0.9_000040.pt") == 0


def test_loss_aware_sampler_stays_synchronous(weights):
    """With ``LossSecondMomentResampler`` the step's losses feed the sampler
    before the next draw: nothing is left pending, the step is logged at once,
    and the sampler holds each example's loss under its t."""
    _, params = weights
    sampler = TR.create_named_schedule_sampler("loss-second-moment", 20)
    loop = _port_loop(params, schedule_sampler=sampler)
    x, feat = _batch(5)
    loop.run_step(nchw(x), {"clip_feat": torch.from_numpy(feat)})
    assert loop._pending_log is None and logger.getkvs()["step"] == 0
    assert sampler._loss_counts.sum() == B and sampler._loss_history.max() > 0


def test_log_loss_dict():
    logger.configure_dir(tempfile.mkdtemp(), format_strs=[])
    diffusion = create_gaussian_diffusion(**_diffusion_kw())
    TL.log_loss_dict(diffusion, np.array([0, 4, 12, 19]), {"loss": np.array([1.0, 2.0, 3.0, 5.0])})
    kvs = logger.getkvs()
    assert kvs["loss"] == pytest.approx(2.75)
    assert (kvs["loss_q0"], kvs["loss_q2"], kvs["loss_q3"]) == (pytest.approx(1.5), 3.0, 5.0)


# --- --train_conv_impl int8 ---------------------------------------------------


def test_int8_train_step_matches_jax_teacher_forced(weights, monkeypatch):
    """One ``run_step`` of the port's int8 model (``conv_impl="int8"``: the
    quantizing GroupNorms emit integer-valued floats under autograd, the convs
    run K5's plain version, the backwards are straight-through) against the
    gradient of the JAX loop's loss under ``set_conv_impl("int8")``, from the
    same weights, batch, t, weights and noise, with the straight-through convs
    in f32 on both sides. The port is teacher-forced to the quantization of
    that very JAX program (``jax_quantization``): a level
    that rounds the other way would move the gradient by more than the
    algorithm's difference. Loss and the per-example terms within 1e-4
    relative; grad_norm, the gradient (relative L2 over all parameters) and
    the updated parameters within 1e-4 relative as the bf16/f32 step is held
    (``test_train_step_matches_jax``); the output head, which is not forced,
    may flip a level now and then, which these bounds absorb."""
    from test_torch_quant import _conv_prequant_bwd_f32, jax_int8, jax_quantization

    from guided_diffusion_clip_tpu.ops import quant as JQ
    from guided_diffusion_clip_tpu_torch.ops import quant as TQ

    jm, params = weights
    x, feat = _batch(6)
    noise = np.random.RandomState(12).standard_normal((B, 16, 16, 3)).astype(np.float32)
    model = UNetModel_clip_feat(UNetConfig(**KW), conv_impl="int8")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    loop = TL.TrainLoop(model=model, diffusion=create_gaussian_diffusion(**_diffusion_kw()), data=None,
                        **{**LOOP, "microbatch": -1})
    # the t and weights the port's run_step draws (its np.random.default_rng(seed))
    t, w = TR.create_named_schedule_sampler("uniform", 20).sample(B, np.random.default_rng(LOOP["seed"]))
    jdiff = jax_diffusion(**_diffusion_kw())

    def loss_fn(p):
        captured = []

        def model_fn(xx, tt, **kw):
            out, inter = jm.apply({"params": p}, xx, tt, train=True, rngs={"dropout": jax.random.key(1)},
                                  capture_intermediates=True, mutable=["intermediates"], **kw)
            captured.append(inter["intermediates"])
            return out

        terms = jdiff.training_losses(model_fn, jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise),
                                      model_kwargs={"clip_feat": jnp.asarray(feat)})
        assert len(captured) == 1
        return jnp.mean(terms["loss"] * jnp.asarray(w)), (terms, captured[0])

    JQ.conv_prequant.defvjp(JQ._conv_prequant_fwd, _conv_prequant_bwd_f32)
    try:
        with jax_int8():
            (jloss, (jterms, inter)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    finally:
        JQ.conv_prequant.defvjp(JQ._conv_prequant_fwd, JQ._conv_prequant_bwd)
    monkeypatch.setattr(TQ, "_STE_DTYPE", torch.float32)
    with jax_quantization(loop.model, inter):
        loop.run_step(nchw(x), {"clip_feat": torch.from_numpy(feat)}, noise=nchw(noise))
    met = loop._fetch(loop._pending_log[2])

    np.testing.assert_allclose(met["loss"], float(jloss), rtol=1e-4)
    for k in ("loss", "mse", "vb"):
        np.testing.assert_allclose(met[f"{k}_vec"], np.asarray(jterms[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    ref = state_dict_from_flax(jax.device_get(jgrads))
    grads = {n: p.grad.numpy() for n, p in zip(loop.names, loop.params)}
    jnorm = np.sqrt(sum(float(np.sum(np.asarray(v, np.float64) ** 2)) for v in ref.values()))
    np.testing.assert_allclose(met["grad_norm"], jnorm, rtol=1e-4)
    err = _rel(grads, ref)
    assert err <= 1e-4, f"gradient: relative L2 {err:.3g}"
    opt = optax.adamw(lambda c: LOOP["lr"] * jnp.maximum(0.0, 1.0 - c / LOOP["lr_anneal_steps"]),
                      weight_decay=LOOP["weight_decay"])
    jp = {k: jnp.asarray(v.numpy()) for k, v in state_dict_from_flax(params).items()}
    upd, _ = opt.update({k: jnp.asarray(v) for k, v in ref.items()}, opt.init(jp), jp)
    err = _rel(_named(loop, loop.params), optax.apply_updates(jp, upd))
    assert err <= 1e-4, f"updated parameters: relative L2 {err:.3g}"


@pytest.mark.parametrize("fused", [False, True], ids=["foreach", "fused"])
def test_int8_weight_quantization_follows_updates_and_ema_copies(weights, fused):
    """``Conv2d.quantized_weight()`` caches w_q, s_w and K5's packed rows by
    the weight's data pointer and version. AdamW writes the parameters in
    place (the fused AdamW, the card's, without bumping their versions), the
    EMAs move by ``_foreach_lerp_``, and ``ema_model`` copies them into a
    model of its own: after each, the cache must equal
    ``quantize_per_out_channel`` of the weight as it is then."""
    from guided_diffusion_clip_tpu_torch.models.nn import Conv2d
    from guided_diffusion_clip_tpu_torch.ops.quant import _pack_weights, quantize_per_out_channel

    _, params = weights
    model = UNetModel_clip_feat(UNetConfig(**KW), conv_impl="int8")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    logger.configure_dir(tempfile.mkdtemp(), format_strs=[])
    loop = TL.TrainLoop(model=model, diffusion=create_gaussian_diffusion(**_diffusion_kw()), data=None,
                        **{**LOOP, "microbatch": -1, "lr": 1e-2, "ema_rate": "0.5"})
    if fused:
        loop.opt = torch.optim.AdamW(loop.params, lr=1e-2, betas=(0.9, 0.999), eps=1e-8, fused=True)
    convs = [m for m in loop.model.modules() if isinstance(m, Conv2d)]
    assert len(convs) == 25 and all(m.int8 for m in convs)

    def check(mods, label):
        for m in mods:
            w_q, s_w = m.quantized_weight()
            want_q, want_s = quantize_per_out_channel(m.weight.detach().permute(2, 3, 1, 0))
            assert torch.equal(w_q, want_q) and torch.equal(s_w, want_s), label
            assert torch.equal(m.packed_weight(), _pack_weights(want_q)), label

    x, feat = _batch(7)
    for step in range(2):
        before = [m.quantized_weight()[0].clone() for m in convs]
        loop.run_step(nchw(x), {"clip_feat": torch.from_numpy(feat)})  # a forward fills the caches, then AdamW
        check(convs, f"after update {step}")
        assert not all(torch.equal(b, m.quantized_weight()[0]) for b, m in zip(before, convs))
    ema = loop.ema_model(0)
    ema_convs = [m for m in ema.modules() if isinstance(m, Conv2d)]
    assert all(m.int8 and m.weight.dtype == torch.float32 for m in ema_convs)
    check(ema_convs, "EMA copy")
    assert not all(torch.equal(a.quantized_weight()[0], b.quantized_weight()[0]) for a, b in zip(ema_convs, convs))
    with torch.no_grad():
        ema_convs[0].weight.mul_(2)  # an in-place edit of the copy's weight
    check(ema_convs[:1], "after an in-place edit")
