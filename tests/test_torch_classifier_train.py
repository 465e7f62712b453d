"""The port's classifier trainer (``classifier_train.py``) against the JAX
script's step, f32 on the CPU.

The JAX script's step is ``jax.value_and_grad`` of a composition:
``q_sample`` noising, ``model.apply`` and
``optax.softmax_cross_entropy_with_integer_labels``, microbatch gradients
scaled by micro / B and summed, then ``optax.adamw`` with the annealed rate.
Here that composition runs on the same weights (``state_dict_from_flax``),
batch, t and noise with dropout 0, and the port's ``ClassifierTrainer.step``
is held to it: loss, logits and gradient within 1e-4 relative L2;
microbatches within 1e-5 of the full batch; the AdamW updates to optax's.
Then the CLI on a generated, class-named folder: its checkpoints, its
``progress.csv`` keys against the JAX script's, a resume and the refusals.
"""

import ast
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from guided_diffusion_clip_tpu.utils import script_util as JSU
from guided_diffusion_clip_tpu_torch import classifier_train
from guided_diffusion_clip_tpu_torch.utils import checkpoint as ckpt
from guided_diffusion_clip_tpu_torch.utils import script_util as TSU
from guided_diffusion_clip_tpu_torch.utils.convert import state_dict_from_flax
from torch_port_utils import encoder_pair, nchw

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# create_classifier's model at 64 px (the smallest size with a channel_mult
# preset), narrowed: one res block a level, attention at 8 px, attention pool
KW = dict(image_size=64, in_channels=3, model_channels=32, out_channels=1000, num_res_blocks=1,
          attention_resolutions=(8,), channel_mult=(1, 2, 3, 4), num_head_channels=64,
          use_scale_shift_norm=True, resblock_updown=True)
POOL = "attention"
B = 4
DIFF = dict(steps=40, noise_schedule="cosine")
TINY = ["--image_size", "64", "--classifier_width", "32", "--classifier_depth", "1",
        "--classifier_attention_resolutions", "8", "--diffusion_steps", "40", "--noise_schedule", "cosine"]


def _jax_script():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        return importlib.import_module("classifier_train")
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))


@pytest.fixture(scope="module")
def pair():
    return encoder_pair(KW, POOL, seed=0)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32)
    y = rs.randint(0, 1000, (B,)).astype(np.int32)
    t = rs.randint(0, 40, (B,)).astype(np.int32)
    noise = rs.standard_normal((B, 64, 64, 3)).astype(np.float32)
    return x, y, t, noise


def _jax_loss(jm, jdiff):
    def loss(p, x, y, t, noise):
        logits = jm.apply({"params": p}, jdiff.q_sample(x, t, noise), t, train=True,
                          rngs={"dropout": jax.random.key(0)})
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
        return ce.mean(), (ce, logits)

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _trainer(params, microbatch=-1, **kw):
    model = TSU.create_classifier(64, False, 32, 1, "8", True, True, POOL)
    model.load_state_dict(state_dict_from_flax(params, model="encoder", pool=POOL), strict=True)
    return classifier_train.ClassifierTrainer(model, TSU.create_gaussian_diffusion(**DIFF), batch_size=B,
                                              microbatch=microbatch, **kw)


def _grads(trainer) -> dict:
    return {n: p.grad.detach().numpy() for n, p in trainer.model.named_parameters()}


def _params(trainer) -> dict:
    return {n: p.detach().numpy() for n, p in trainer.model.named_parameters()}


def _rel(ours: dict, theirs: dict) -> float:
    """Relative L2 distance over all entries of two name -> array dicts."""
    assert sorted(ours) == sorted(theirs)
    num = sum(float(np.sum((np.asarray(ours[k], np.float64) - np.asarray(theirs[k], np.float64)) ** 2))
              for k in theirs)
    den = sum(float(np.sum(np.asarray(theirs[k], np.float64) ** 2)) for k in theirs)
    return (num / den) ** 0.5


def _as_port(tree) -> dict:
    return {k: v.numpy() for k, v in state_dict_from_flax(jax.device_get(tree), model="encoder", pool=POOL).items()}


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_compute_top_k_matches_the_jax_script(k, seed):
    rs = np.random.RandomState(seed)
    logits = rs.standard_normal((16, 10)).astype(np.float32)
    labels = rs.randint(0, 10, (16,))
    labels[:4] = np.argsort(logits[:4], axis=-1)[:, -1]  # some hits at k = 1
    assert classifier_train.compute_top_k(logits, labels, k) == _jax_script().compute_top_k(logits, labels, k)


def test_train_step_matches_jax(pair):
    """One step's loss, logits and gradient against jax.value_and_grad of the
    JAX step's composition, on the same noise and t."""
    jm, params, _ = pair
    x, y, t, noise = _batch()
    jdiff = JSU.create_gaussian_diffusion(**DIFF)
    (jloss, (jce, jlogits)), jgrads = _jax_loss(jm, jdiff)(params, x, y, t, noise)
    trainer = _trainer(params)
    ce, logits = trainer.step(nchw(x), torch.from_numpy(y), t=torch.from_numpy(t), noise=nchw(noise))
    np.testing.assert_allclose(ce.mean().item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(ce.numpy(), np.asarray(jce), rtol=1e-4, atol=1e-5)
    assert _rel({"l": logits.numpy()}, {"l": np.asarray(jlogits)}) <= 1e-4
    err = _rel(_grads(trainer), _as_port(jgrads))
    assert err <= 1e-4, f"gradient relative L2 {err:.3g}"


def test_microbatches_give_the_full_batch_gradient(pair):
    _, params, _ = pair
    x, y, t, noise = _batch(1)
    full, micro = _trainer(params), _trainer(params, microbatch=2)
    outs = [tr.step(nchw(x), torch.from_numpy(y), t=torch.from_numpy(t), noise=nchw(noise)) for tr in (full, micro)]
    err = _rel(_grads(micro), _grads(full))
    assert err <= 1e-5, f"microbatch 2 of 4 against the full batch: gradient relative L2 {err:.3g}"
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_two_adamw_steps_match_optax(pair):
    """Two steps with ``anneal_lr`` and ``weight_decay`` against optax.adamw
    on the JAX gradients of the same batches; and the port's update on the
    JAX gradients themselves, element by element, as the change in each
    parameter: within 1e-4 of optax's change plus 4 float32 spacings of the
    parameter (each side rounds p twice). The decoupled decay moves p by
    lr * wd * |p| a step, 17-35 spacings here, so an AdamW without decay, or
    with decay coupled into the gradient as Adam's, fails (the worst element
    reads 0.50 of the bound; no decay 34, coupled decay 5.6e5)."""
    jm, params, _ = pair
    lr, wd, iters = 1e-4, 0.05, 3
    opt = optax.adamw(learning_rate=lambda c: lr * jnp.maximum(0.0, 1.0 - c / iters), weight_decay=wd)
    step_fn = _jax_loss(jm, JSU.create_gaussian_diffusion(**DIFF))
    jp, state = params, opt.init(params)
    before = _as_port(params)
    trainer = _trainer(params, lr=lr, weight_decay=wd, anneal_lr=True, iterations=iters)
    replay = _trainer(params, lr=lr, weight_decay=wd, anneal_lr=True, iterations=iters)
    for seed in (2, 3):
        x, y, t, noise = _batch(seed)
        (_, _), g = step_fn(jp, x, y, t, noise)
        updates, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        trainer.step(nchw(x), torch.from_numpy(y), t=torch.from_numpy(t), noise=nchw(noise))
        # the same update on JAX's gradient
        grads = _as_port(g)
        for name, p in replay.model.named_parameters():
            p.grad = torch.from_numpy(grads[name].copy())
        replay.update()
    assert trainer.opt_count == replay.opt_count == 2
    ref = _as_port(jp)
    err = _rel(_params(trainer), ref)
    assert err <= 1e-4, f"parameters after two steps: relative L2 {err:.3g}"
    for name, p in replay.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=1e-5, atol=1e-7, err_msg=name)
        after = p.detach().numpy()
        ours, theirs = (a.astype(np.float64) - before[name] for a in (after, ref[name]))
        spacing = np.spacing(np.maximum(np.abs(after), np.abs(before[name]))).astype(np.float64)
        worst = (np.abs(ours - theirs) / (1e-4 * np.abs(theirs) + 4 * spacing)).max()
        assert worst <= 1, f"{name}: the change in the parameter is {worst:.3g}x its bound from optax's"


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Class-named train and val folders: {class}_{i}.png, 4 classes."""
    root = tmp_path_factory.mktemp("cls")
    rs = np.random.RandomState(0)
    for split, n in (("train", 8), ("val", 4)):
        os.makedirs(root / split)
        for i in range(n):
            img = rs.randint(0, 255, (72, 80, 3), dtype=np.uint8)
            Image.fromarray(img).save(root / split / f"c{i % 4}_{i}.png")
    return root


def _keys_logged_by_the_jax_script() -> set:
    with open(os.path.join(REPO, "scripts", "classifier_train.py")) as f:
        tree = ast.parse(f.read())
    return {n.args[0].value for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", "") in ("logkv", "logkv_mean") and isinstance(n.args[0], ast.Constant)}


def test_cli_trains_saves_and_resumes(folders, tmp_path):
    argv = [*TINY, "--data_dir", str(folders / "train"), "--val_data_dir", str(folders / "val"),
            "--batch_size", "4", "--microbatch", "2", "--anneal_lr", "True", "--weight_decay", "0.05",
            "--log_interval", "1", "--eval_interval", "1", "--save_interval", "2", "--device", "cpu"]
    run = tmp_path / "run"
    os.environ["OPENAI_LOGDIR"] = str(run)
    try:
        out = classifier_train.main([*argv, "--iterations", "3"])
        assert out["steps"] == 3 and out["evals"] == 3 and len(out["step_ms"]) == 3
        assert sorted(os.listdir(run)) == ["log.txt", "model000001.pt", "model000002.pt", "opt000001.pt",
                                           "opt000002.pt", "progress.csv"]
        header, *rows = (run / "progress.csv").read_text().splitlines()
        assert set(header.split(",")) == _keys_logged_by_the_jax_script()
        assert [r.split(",")[header.split(",").index("step")] for r in rows] == ["0", "1", "2"]
        # the checkpoint is the classifier's reference-format state_dict
        clf = TSU.create_classifier(64, False, 32, 1, "8", True, True, POOL)
        ckpt.load_model_weights(clf, str(run / "model000002.pt"))
        assert int(torch.load(run / "opt000002.pt")["state"][0]["step"]) == 3

        resumed = tmp_path / "resumed"
        os.environ["OPENAI_LOGDIR"] = str(resumed)
        out = classifier_train.main([*argv, "--iterations", "4", "--resume_checkpoint",
                                     str(run / "model000002.pt")])
        assert out["resume_step"] == 2 and out["steps"] == 2
        header, *rows = (resumed / "progress.csv").read_text().splitlines()
        assert [r.split(",")[header.split(",").index("step")] for r in rows] == ["2", "3"]
        assert "model000003.pt" in os.listdir(resumed)
    finally:
        os.environ.pop("OPENAI_LOGDIR", None)


def test_training_test_env_stops_after_the_first_save(folders, tmp_path, monkeypatch):
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    monkeypatch.setenv("OPENAI_LOGDIR", str(tmp_path))
    out = classifier_train.main([*TINY, "--data_dir", str(folders / "train"), "--batch_size", "2",
                                 "--iterations", "5", "--save_interval", "2", "--log_interval", "1",
                                 "--noised", "False", "--device", "cpu"])
    assert out["steps"] == 2 and out["evals"] == 0
    assert sorted(p for p in os.listdir(tmp_path) if p.startswith("model")) == ["model000001.pt", "model000004.pt"]


@pytest.mark.parametrize("flags,match", [
    # the id from when the flag was not yet ported: outside torchrun it is now refused for want of a process group
    pytest.param(["--param_sharding", "fsdp"], "param_sharding fsdp: launch under torchrun",
                 id="flags0-param_sharding fsdp: not yet ported"),
    (["--spatial_shard", "2"], "spatial_shard 2: not yet ported"),
    (["--tensor_shard", "2"], "tensor_shard 2: not yet ported"),
    (["--resume_checkpoint", "model000005.flax"], "convert a .flax checkpoint"),
])
def test_refusals(folders, tmp_path, monkeypatch, flags, match):
    monkeypatch.setenv("OPENAI_LOGDIR", str(tmp_path))
    with pytest.raises(SystemExit, match=match):
        classifier_train.main([*TINY, "--data_dir", str(folders / "train"), "--device", "cpu", *flags])


def test_no_card_is_an_error(folders):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        classifier_train.main([*TINY, "--data_dir", str(folders / "train")])
