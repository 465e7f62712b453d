"""The port's acceptance path (guided_diffusion_clip_tpu_torch/acceptance_real_weights.py)
with synthetic stand-ins on the CPU: the four cases of tests/test_acceptance_path.py.

Stand-ins: tiny port models saved as reference-format ``.pt`` state_dicts
(loaded ``strict=True`` by the sampling CLI), random Inception weights in the
converter's npz layout (``random_params(0)``, the JAX module's arrays), random
uint8 reference images and labels; ``--device cpu`` throughout."""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from evaluations import inception_flax as jinc
from guided_diffusion_clip_tpu_torch import acceptance_real_weights as acc
from guided_diffusion_clip_tpu_torch.evaluations import evaluator as ev
from guided_diffusion_clip_tpu_torch.evaluations import inception as inc
from guided_diffusion_clip_tpu_torch.models.clip_tokenizer import SimpleTokenizer
from guided_diffusion_clip_tpu_torch.models.clip_vit import CLIP, TINY_CLIP
from guided_diffusion_clip_tpu_torch.utils.script_util import create_classifier, create_upstream_model

TINY_SIZE = 64
TINY_MODEL_FLAGS = [
    "--image_size", str(TINY_SIZE), "--num_channels", "32",
    "--num_res_blocks", "1", "--attention_resolutions", "8",
    "--num_heads", "2", "--num_head_channels", "16",
    "--class_cond", "True", "--learn_sigma", "True",
    "--use_scale_shift_norm", "False", "--resblock_updown", "False",
    "--use_fp16", "False", "--use_new_attention_order", "False",
    "--diffusion_steps", "40", "--noise_schedule", "cosine",
    "--classifier_width", "32", "--classifier_depth", "1",
    "--classifier_attention_resolutions", "8", "--classifier_pool", "attention",
    "--classifier_use_scale_shift_norm", "False",
    "--classifier_resblock_updown", "False",
    "--classifier_use_fp16", "False",
    "--classifier_scale", "1.0",
]
VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "tiny_bpe_vocab.txt.gz")


def write_standins(assets_dir):
    os.makedirs(assets_dir, exist_ok=True)
    torch.manual_seed(0)
    model = create_upstream_model(
        image_size=TINY_SIZE, num_channels=32, num_res_blocks=1, learn_sigma=True, class_cond=True,
        attention_resolutions="8", num_heads=2, num_head_channels=16,
    )
    classifier = create_classifier(
        image_size=TINY_SIZE, classifier_use_fp16=False, classifier_width=32, classifier_depth=1,
        classifier_attention_resolutions="8", classifier_use_scale_shift_norm=False,
        classifier_resblock_updown=False, classifier_pool="attention",
    )
    for m in (model, classifier):  # every weight random: the init's zero output layers would give eps 0
        with torch.no_grad():
            for p in m.parameters():
                p.normal_(0.0, 0.02)
    torch.save(model.state_dict(), os.path.join(assets_dir, "64x64_diffusion.pt"))
    torch.save(classifier.state_dict(), os.path.join(assets_dir, "64x64_classifier.pt"))
    np.savez(os.path.join(assets_dir, "inception_v3_fid.npz"), **inc.flat_params(jinc.random_params(0)))
    rs = np.random.RandomState(0)
    np.savez(
        os.path.join(assets_dir, "VIRTUAL_imagenet64_labeled.npz"),
        arr_0=rs.randint(0, 255, (32, TINY_SIZE, TINY_SIZE, 3), dtype=np.uint8),
        arr_1=rs.randint(0, 1000, (32,), dtype=np.int64),
    )


def run(argv) -> tuple:
    """(main's return, the stage lines it printed, all it printed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        done = acc.main(argv)
    text = out.getvalue()
    lines = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    return done, {line["stage"]: line for line in lines}, text


def test_acceptance_path_end_to_end(tmp_path):
    assets = str(tmp_path / "assets")
    write_standins(assets)
    done, stages, text = run([
        "--assets_dir", assets, "--num_samples", "4", "--batch_size", "4", "--timestep_respacing", "5",
        "--size_override", " ".join(TINY_MODEL_FLAGS), "--device", "cpu",
    ])
    # resolve found every ADM stand-in (the converted npz in place of the pb); the CLIP assets are
    # missing but block nothing: only clip_check needs them
    assert set(stages["resolve"]["missing"]) == {"ViT-B-32.pt", "bpe_simple_vocab_16e6.txt.gz"}
    assert "inception_v3_fid.npz" in stages["resolve"]["found"]
    assert stages["resolve"]["groups"]["clip"] == ["ViT-B-32.pt", "bpe_simple_vocab_16e6.txt.gz"]
    assert os.path.exists(os.path.join(assets, "assets_manifest.json")) and "manifest" in stages
    assert stages["convert"]["inception_npz"].endswith("inception_v3_fid.npz")
    # sample wrote the npz through the sampling CLI
    arr = np.load(stages["sample"]["npz"])["arr_0"]
    assert arr.shape == (4, TINY_SIZE, TINY_SIZE, 3) and arr.dtype == np.uint8
    assert done["sample"] == stages["sample"]["npz"]
    # evaluate parsed the port evaluator's untagged metric lines
    m = stages["evaluate"]["metrics"]
    assert set(m) == {"inception_score", "fid", "sfid", "precision", "recall"}
    assert all(np.isfinite(v) for v in m.values())
    assert "[pixel-debug]" not in text and f"feature extractor: {ev.InceptionExtractor.name}" in text
    assert stages["evaluate"]["published_targets_imagenet64_guided"]["FID"] == 2.07
    # a second run finds the samples
    _, again, _ = run(["--assets_dir", assets, "--num_samples", "4", "--stages", "sample", "--device", "cpu"])
    assert again["sample"] == {"stage": "sample", "npz": stages["sample"]["npz"], "cached": True}


def test_resolve_reports_missing(tmp_path):
    assets = str(tmp_path / "empty")
    os.makedirs(assets)
    with pytest.raises(SystemExit, match="missing assets"):
        run(["--assets_dir", assets, "--stages", "resolve", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        torch_cuda = torch.cuda.is_available
        try:
            torch.cuda.is_available = lambda: False
            run(["--assets_dir", assets, "--stages", "resolve"])
        finally:
            torch.cuda.is_available = torch_cuda


def test_clip_check_stage_with_standins(tmp_path, monkeypatch):
    """clip_check on synthetic CLIP assets: the tiny CLIP in OpenAI's names
    and the tiny BPE vocabulary, under GDC_CLIP_TINY."""
    monkeypatch.setenv("GDC_CLIP_TINY", "1")
    assets = str(tmp_path / "assets")
    os.makedirs(assets)
    vocab = os.path.join(assets, "bpe_simple_vocab_16e6.txt.gz")
    shutil.copy(VOCAB, vocab)
    tok = SimpleTokenizer(vocab, context_length=TINY_CLIP.context_length)
    import dataclasses

    torch.manual_seed(0)
    cfg = dataclasses.replace(TINY_CLIP, vocab_size=len(tok.encoder))
    torch.save(CLIP(cfg).state_dict(), os.path.join(assets, "ViT-B-32.pt"))
    _, stages, _ = run(["--assets_dir", assets, "--stages", "resolve,clip_check", "--device", "cpu"])
    # the CLIP assets found; the absent ADM assets do not block this lane
    assert "ViT-B-32.pt" in stages["resolve"]["found"]
    c = stages["clip_check"]
    assert c["ok"] and c["embed_dim"] == TINY_CLIP.embed_dim and c["vocab_size"] == len(tok.encoder)
    assert -1.0 <= c["cosine_random_image_vs_prompt"] <= 1.0
    man = json.load(open(os.path.join(assets, "assets_manifest.json")))
    assert "ViT-B-32.pt" in man and "sha256" in man["ViT-B-32.pt"]


def test_manifest_detects_corruption(tmp_path):
    """A second resolve after an asset changed under the manifest fails."""
    assets = str(tmp_path / "assets")
    os.makedirs(assets)
    path = os.path.join(assets, "bpe_simple_vocab_16e6.txt.gz")
    with open(path, "wb") as f:
        f.write(b"original")
    argv = ["--assets_dir", assets, "--stages", "resolve,noop", "--device", "cpu"]
    run(argv)  # records the digest, nothing blocks
    with open(path, "wb") as f:
        f.write(b"tampered")
    with pytest.raises(SystemExit, match="checksum mismatch"):
        run(argv)


def test_published_flags_build_the_published_models():
    """MODEL_FLAGS_64 and CLASSIFIER_FLAGS_64 through the sampling CLI's
    parser: ADM-G 64's widths (192 channels, mult 1-4, 3 res blocks, heads of
    64 at 32/16/8 px, the new attention order, a bf16 torso) and its f32
    classifier (128 wide, depth 4, attention pool); built on the meta device."""
    from guided_diffusion_clip_tpu_torch import classifier_sample as cs
    from guided_diffusion_clip_tpu_torch.utils.script_util import args_to_dict, classifier_defaults

    args = cs.create_argparser().parse_args(acc.MODEL_FLAGS_64 + acc.CLASSIFIER_FLAGS_64)
    with torch.device("meta"):
        model = create_upstream_model(**args_to_dict(args, cs._UNET_KEYS))
        clf = create_classifier(**args_to_dict(args, classifier_defaults().keys()))
    cfg = model.config
    assert (cfg.model_channels, cfg.channel_mult, cfg.num_res_blocks, cfg.num_head_channels) == (192, (1, 2, 3, 4),
                                                                                               3, 64)
    assert cfg.use_new_attention_order and model.dtype == torch.bfloat16
    assert (clf.config.model_channels, clf.config.num_res_blocks, clf.pool) == (128, 4, "attention")
    assert clf.dtype == torch.float32
