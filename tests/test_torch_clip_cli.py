"""The port's two CLIP entry points on the CPU: ``compute_clip_embeddings``
against the JAX encoder on the same crops (within 1e-4, the flip order
checked) and read back by the port's loader, and ``clip_guided_sample`` with
a tiny UNet and the tiny CLIP (``GDC_CLIP_TINY=1``) in each of its target and
guidance modes, and its refusals."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from guided_diffusion_clip_tpu.data import image_datasets as JData
from guided_diffusion_clip_tpu.models import clip_vit as J
from guided_diffusion_clip_tpu_torch import clip_guided_sample, compute_clip_embeddings
from guided_diffusion_clip_tpu_torch.data.image_datasets import load_data
from guided_diffusion_clip_tpu_torch.models import clip_vit as P
from guided_diffusion_clip_tpu_torch.models.clip_tokenizer import SimpleTokenizer
from guided_diffusion_clip_tpu_torch.utils.convert import state_dict_from_flax
from guided_diffusion_clip_tpu_torch.utils.script_util import create_model
from torch_port_utils import random_params

torch.set_num_threads(2)
VOCAB = os.path.join(os.path.dirname(__file__), "assets", "tiny_bpe_vocab.txt.gz")
TINY = P.TINY_CLIP
JTINY = J.CLIPConfig(**dataclasses.asdict(TINY))
UNET_FLAGS = ["--image_size", "16", "--num_channels", "32", "--num_res_blocks", "1", "--channel_mult", "1,2",
              "--learn_sigma", "True", "--attention_resolutions", "8", "--num_heads", "2",
              "--diffusion_steps", "40", "--noise_schedule", "cosine", "--timestep_respacing", "3",
              "--batch_size", "2", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _tiny_clip(monkeypatch):
    monkeypatch.setenv("GDC_CLIP_TINY", "1")


def _clip_params(cfg, seed=0):
    venc, tenc = J.CLIPVisionEncoder(cfg), J.CLIPTextEncoder(cfg)
    s = cfg.image_size
    vs = jax.eval_shape(lambda: venc.init(jax.random.key(0), jnp.zeros((1, s, s, 3))))["params"]
    ts = jax.eval_shape(lambda: tenc.init(jax.random.key(0), jnp.zeros((1, cfg.context_length), jnp.int32)))
    return jax.device_get(random_params(vs, seed)), jax.device_get(random_params(ts["params"], seed + 1))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Images of several sizes, the tiny CLIP as an OpenAI-named .pt (and its
    flax vision params), a tiny UNet's .pt each way of class_cond, and one
    CLIP .pt sized to the vendored vocabulary."""
    root = tmp_path_factory.mktemp("clip_cli")
    rs = np.random.RandomState(0)
    os.makedirs(root / "imgs" / "sub")
    for i, (h, w) in enumerate([(40, 56), (64, 48), (50, 50), (33, 70), (48, 64)]):
        where = root / "imgs" / ("sub" if i == 4 else "") / f"img_{i}.png"
        Image.fromarray(rs.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(where)
    vp, tp = _clip_params(JTINY)
    torch.save(state_dict_from_flax((vp, tp, 2.0), model="clip"), root / "clip.pt")
    tok = SimpleTokenizer(bpe_path=VOCAB, context_length=TINY.context_length)
    text_cfg = dataclasses.replace(JTINY, vocab_size=len(tok.encoder))
    torch.save(state_dict_from_flax((*_clip_params(text_cfg, seed=2), 2.0), model="clip"), root / "clip_text.pt")
    g = torch.Generator().manual_seed(0)
    for cond in (False, True):
        m = create_model(16, 32, 1, channel_mult="1,2", learn_sigma=True, class_cond=cond,
                         attention_resolutions="8", num_heads=2, use_scale_shift_norm=True)
        torch.save({k: torch.randn(v.shape, generator=g) * 0.05 for k, v in m.state_dict().items()},
                   root / f"unet_{int(cond)}.pt")
    np.savez(root / "target.npz", rs.standard_normal(16).astype(np.float32))
    return root, vp


@pytest.mark.parametrize("ext", [".pt", ".npz"])
def test_embeddings_match_the_jax_encoder_on_the_same_crops(assets, tmp_path, ext):
    root, vp = assets
    out = str(tmp_path / f"emb{ext}")
    res = compute_clip_embeddings.main(["--data_dir", str(root / "imgs"), "--out", out, "--clip_model_path",
                                        str(root / "clip.pt"), "--image_size", "48", "--batch_size", "2",
                                        "--device", "cpu"])
    assert res["images"] == 5
    got = ({k: v.numpy() for k, v in torch.load(out).items()} if ext == ".pt"
           else dict(np.load(out)))
    files = JData.list_image_files_recursively(str(root / "imgs"))
    assert sorted(got) == sorted(os.path.basename(f) for f in files)
    enc = J.CLIPVisionEncoder(JTINY)
    for f in files:
        arr = JData.center_crop_arr(Image.open(f).convert("RGB"), 48).astype(np.float32) / 127.5 - 1.0
        pair = np.stack([arr, arr[:, ::-1]])  # [unflipped, flipped]
        ref = np.asarray(enc.apply({"params": vp}, J.preprocess_for_clip(jnp.asarray(pair), TINY.image_size)))
        emb = got[os.path.basename(f)]
        assert emb.shape == (2, 16)
        np.testing.assert_allclose(emb, ref, rtol=1e-4, atol=1e-4)
        assert np.abs(emb[0] - emb[1]).max() > 1e-3  # the flip matters

    # the port's loader picks row int(flipped): row 0 without flips
    data = load_data(data_dir=str(root / "imgs"), batch_size=5, image_size=16, deterministic=True,
                     random_flip=False, clip_file_path=out, prefetch=0)
    _, cond = next(data)
    want = np.stack([got[os.path.basename(f)][0] for f in files])
    np.testing.assert_array_equal(cond["clip_feat"], want)


def _sample(assets, tmp_path, *extra, unet=0):
    root, _ = assets
    return clip_guided_sample.main([*UNET_FLAGS, "--model_path", str(root / f"unet_{unet}.pt"),
                                    "--clip_model_path", str(root / "clip.pt"), "--main_path", str(tmp_path),
                                    "--clip_scale", "10,30", *extra])


def _check_outputs(out, scales=("10", "30")):
    assert [os.path.basename(p) for p in out["paths"]] == [f"clip_guided_scale{s}.npz" for s in scales]
    images = []
    for p in out["paths"]:
        arr = np.load(p)["arr_0"]
        assert arr.shape == (2, 16, 16, 3) and arr.dtype == np.uint8
        assert os.path.exists(p[:-4] + ".png")
        images.append(arr)
    return images


@pytest.mark.parametrize("mode", ["target_image", "target_embed", "text"])
def test_targets(assets, tmp_path, mode):
    root, _ = assets
    extra = {"target_image": ["--target_image", str(root / "imgs" / "img_1.png")],
             "target_embed": ["--target_embed", str(root / "target.npz")],
             "text": ["--text", "a photo of a cat", "--clip_vocab", VOCAB,
                      "--clip_model_path", str(root / "clip_text.pt")]}[mode]
    out = _sample(assets, tmp_path, *extra)
    first, second = _check_outputs(out)
    assert not np.array_equal(first, second)  # another scale and other seeds
    # pred-x0 mode: a loop forward, and a forward (with its backward) in cond_fn, a step
    assert out["steps"] == 3 and out["calls"] == {"unet": 2 * 2 * 3, "clip": 2 * 3}
    again = _sample(assets, tmp_path / "again", *extra)
    for a, b in zip(_check_outputs(again), (first, second)):
        np.testing.assert_array_equal(a, b)


def test_noisy_x_mode_runs_no_extra_forward(assets, tmp_path):
    root, _ = assets
    out = _sample(assets, tmp_path, "--target_embed", str(root / "target.npz"), "--grad_through_pred_xstart",
                  "False")
    _check_outputs(out)
    assert out["calls"] == {"unet": 2 * 3, "clip": 2 * 3}


def test_cfg_with_its_cache_on_the_embedding_model(assets, tmp_path, monkeypatch):
    """--class_cond injects the target as clip_feat, so the CLIP's embedding
    width must be the UNet's 512."""
    root, _ = assets
    cfg = dataclasses.replace(TINY, embed_dim=512)
    monkeypatch.setattr(clip_guided_sample, "clip_config", lambda: cfg)
    torch.save(P.CLIP(cfg).state_dict(), tmp_path / "clip512.pt")
    out = _sample(assets, tmp_path, "--class_cond", "True", "--cfg_scale", "2", "--cfg_cache", "2",
                  "--target_image", str(root / "imgs" / "img_0.png"), "--clip_model_path",
                  str(tmp_path / "clip512.pt"), unet=1)
    _check_outputs(out)
    # a step: the conditional forward, the unconditional one on steps 0 and 2, the cond_fn's forward
    assert out["calls"] == {"unet": 2 * (3 + 2 + 3), "clip": 2 * 3}


def test_int8_convs_and_the_guidance_cache(assets, tmp_path):
    root, _ = assets
    out = _sample(assets, tmp_path, "--target_embed", str(root / "target.npz"), "--conv_impl", "int8",
                  "--guidance_cache", "2", "--sampler", "ddim")
    _check_outputs(out)
    assert out["calls"] == {"unet": 2 * (3 + 2), "clip": 2 * 2}  # the gradient on steps 0 and 2


@pytest.mark.parametrize("flags,match", [
    # the ids from when the flags were not yet ported: outside torchrun each is now refused for want of a
    # process group
    pytest.param(["--spatial_shard", "2"], "spatial_shard 2: launch under torchrun",
                 id="flags0-spatial_shard: not yet ported"),
    pytest.param(["--tensor_shard", "2"], "tensor_shard 2: launch under torchrun",
                 id="flags1-tensor_shard: not yet ported"),
    (["--conv_impl", "fp8"], "--conv_impl 'fp8'"),
    (["--cfg_cache", "2"], "needs --cfg_scale"),
    (["--cfg_scale", "2"], "needs an embedding-conditioned model"),
    ([], "provide --text, --target_image or --target_embed"),
])
def test_refusals(assets, tmp_path, flags, match):
    root, _ = assets
    target = [] if not flags else ["--target_embed", str(root / "target.npz")]
    with pytest.raises(SystemExit, match=match):
        _sample(assets, tmp_path, *target, *flags)


def test_refuses_a_flax_checkpoint_and_a_vocabulary_of_another_size(assets, tmp_path, monkeypatch):
    root, _ = assets
    with pytest.raises(SystemExit, match="convert a .flax checkpoint"):
        _sample(assets, tmp_path, "--target_embed", str(root / "target.npz"), "--model_path", "model000001.flax")
    monkeypatch.delenv("GDC_CLIP_TINY")  # ViT-B/32 expects 49408 tokens
    with pytest.raises(SystemExit, match="vocab size mismatch"):
        _sample(assets, tmp_path, "--text", "a cat", "--clip_vocab", VOCAB)


def test_no_card_is_an_error(assets, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root, _ = assets
    argv = [a for a in UNET_FLAGS if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit, match="no CUDA device"):
        clip_guided_sample.main([*argv, "--target_embed", str(root / "target.npz")])
    with pytest.raises(SystemExit, match="no CUDA device"):
        compute_clip_embeddings.main(["--data_dir", str(root / "imgs"), "--out", str(tmp_path / "e.pt"),
                                      "--clip_model_path", str(root / "clip.pt")])
