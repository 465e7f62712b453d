"""Real-weights acceptance path on PyTorch: released ADM checkpoints -> FID
table. The port of scripts/acceptance_real_weights.py.

    python -m guided_diffusion_clip_tpu_torch.acceptance_real_weights --assets_dir /path/to/assets

The same stages, flags, asset table and sha256 manifest as the JAX script,
plus ``--device`` (default ``cuda``; a missing card is an error), which is
passed to both CLIs:

  resolve   find (or, with --download, fetch) the assets under --assets_dir:
                64x64_diffusion.pt, 64x64_classifier.pt,
                VIRTUAL_imagenet64_labeled.npz (reference batch),
                classify_image_graph_def.pb OR a converted
                inception_v3_fid.npz; the CLIP group (ViT-B-32.pt,
                bpe_simple_vocab_16e6.txt.gz) only for clip_check
  convert   the Inception pb -> npz conversion (``evaluations/inception.py``
            ``convert_pb``, which needs TensorFlow); the .pt checkpoints are
            read as they are
  sample    classifier-guided sampling at the published 64 px flags
            (``MODEL_FLAGS_64``, ``CLASSIFIER_FLAGS_64``) through
            ``classifier_sample``'s ``main`` in this process (the same argv
            as ``python -m guided_diffusion_clip_tpu_torch.classifier_sample``),
            into one npz
  evaluate  the port's evaluator (``evaluations/evaluator.py``, ``main`` in
            this process) with ``--extractor flax-inception``, reference batch
            against the samples; prints the metrics beside the published
            targets (FID 2.07 / P 0.74 / R 0.63)
  clip_check  load the ViT-B/32 .pt and the BPE vocabulary, tokenize a
            prompt, encode it and a random image, check the embeddings'
            geometry (``GDC_CLIP_TINY=1``: the tiny test CLIP)

Every found asset's sha256 is checked against a published digest where one
exists (the ViT-B/32 URL embeds its own), and recorded into
assets_manifest.json otherwise, to be checked on every later run.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import shlex

ASSET_URLS = {
    # reference README.md:13-14 (model zoo) and evaluations/README.md:25
    "64x64_diffusion.pt":
        "https://openaipublic.blob.core.windows.net/diffusion/jul-2021/64x64_diffusion.pt",
    "64x64_classifier.pt":
        "https://openaipublic.blob.core.windows.net/diffusion/jul-2021/64x64_classifier.pt",
    "VIRTUAL_imagenet64_labeled.npz":
        "https://openaipublic.blob.core.windows.net/diffusion/jul-2021/ref_batches/imagenet/64/VIRTUAL_imagenet64_labeled.npz",
    "classify_image_graph_def.pb":
        "http://download.tensorflow.org/models/image/imagenet/inception-2015-12-05.tgz",
    # the CLIP path: the released ViT-B/32 weights and the BPE vocabulary; only clip_check needs them
    "ViT-B-32.pt":
        "https://openaipublic.azureedge.net/clip/models/"
        "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "bpe_simple_vocab_16e6.txt.gz":
        "https://github.com/openai/CLIP/raw/main/clip/bpe_simple_vocab_16e6.txt.gz",
}

CLIP_ASSETS = ("ViT-B-32.pt", "bpe_simple_vocab_16e6.txt.gz")
ADM_ASSETS = tuple(k for k in ASSET_URLS if k not in CLIP_ASSETS)

# known-good digests: the ViT-B/32 sha256 is in its release URL; the other assets' are recorded into
# assets_manifest.json on first resolve and checked on every later run
KNOWN_SHA256 = {
    "ViT-B-32.pt":
        "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af",
}

# the published 64 px guided-sampling recipe (reference README.md:41-50)
MODEL_FLAGS_64 = [
    "--attention_resolutions", "32,16,8", "--class_cond", "True",
    "--diffusion_steps", "1000", "--dropout", "0.1", "--image_size", "64",
    "--learn_sigma", "True", "--noise_schedule", "cosine",
    "--num_channels", "192", "--num_head_channels", "64",
    "--num_res_blocks", "3", "--resblock_updown", "True",
    "--use_new_attention_order", "True", "--use_fp16", "True",
    "--use_scale_shift_norm", "True",
]
CLASSIFIER_FLAGS_64 = [
    "--classifier_depth", "4", "--classifier_scale", "1.0",
]
PUBLISHED_64 = {"FID": 2.07, "precision": 0.74, "recall": 0.63}


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def verify_manifest(args, found: dict) -> dict:
    """Record-on-first-sight / verify-on-every-later-run checksum manifest."""
    mpath = os.path.join(args.assets_dir, "assets_manifest.json")
    manifest = {}
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
    changed = False
    # the GDC_CLIP_TINY stand-in lane ships synthetic assets: no published digest applies there
    known = {} if os.environ.get("GDC_CLIP_TINY") else KNOWN_SHA256
    for name, path in found.items():
        digest = _sha256(path)
        expected = known.get(name) or manifest.get(name, {}).get("sha256")
        if expected and digest != expected:
            raise SystemExit(
                f"checksum mismatch for {name}: got {digest}, expected "
                f"{expected} ({'published' if name in KNOWN_SHA256 else mpath})"
            )
        if name not in manifest:
            manifest[name] = {"sha256": digest, "bytes": os.path.getsize(path), "url": ASSET_URLS.get(name, "")}
            changed = True
    if changed:
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
    print(json.dumps({"stage": "manifest", "verified": sorted(found), "path": mpath}), flush=True)
    return manifest


def resolve(args, stages) -> dict:
    """Locate each asset under --assets_dir; with --download, fetch the
    missing ones. A missing asset fails the run only when a requested stage
    needs it: sample and evaluate (and a bare ``--stages resolve``) need the
    ADM group, clip_check the CLIP group."""
    found, missing = {}, []
    for name in ASSET_URLS:
        p = os.path.join(args.assets_dir, name)
        if os.path.exists(p):
            found[name] = p
        else:
            missing.append(name)
    # a pre-converted Inception npz substitutes for the pb
    npz = os.path.join(args.assets_dir, "inception_v3_fid.npz")
    if "classify_image_graph_def.pb" in missing and os.path.exists(npz):
        missing.remove("classify_image_graph_def.pb")
        found["inception_v3_fid.npz"] = npz
    if missing and args.download:
        import urllib.request

        for name in list(missing):
            url = ASSET_URLS[name]
            dst = os.path.join(args.assets_dir, name)
            print(f"[resolve] downloading {url} -> {dst}", flush=True)
            try:
                urllib.request.urlretrieve(url, dst)
                found[name] = dst
                missing.remove(name)
            except Exception as e:  # noqa: BLE001 - report every asset
                print(f"[resolve] FAILED {name}: {e!r}", flush=True)
    status = {"found": found, "missing": missing,
              "groups": {"adm_fid": sorted(ADM_ASSETS), "clip": sorted(CLIP_ASSETS)}}
    print(json.dumps({"stage": "resolve", **status}), flush=True)
    verify_manifest(args, found)
    needed = set()
    if {"sample", "evaluate"} & set(stages) or list(stages) == ["resolve"]:
        needed |= set(ADM_ASSETS)
    if "clip_check" in stages:
        needed |= set(CLIP_ASSETS)
    blocking = sorted(needed & set(missing))
    if blocking:
        raise SystemExit(
            f"missing assets required by the requested stages: {blocking}. "
            f"Mount them under {args.assets_dir} or run with --download in a "
            "network-enabled environment."
        )
    return found


def convert(args, assets: dict) -> dict:
    """One-time Inception pb -> npz conversion (idempotent)."""
    npz = assets.get("inception_v3_fid.npz") or os.path.join(args.out_dir, "inception_v3_fid.npz")
    if not os.path.exists(npz):
        from .evaluations import inception

        pb = assets["classify_image_graph_def.pb"]
        print(f"[convert] {pb} -> {npz}", flush=True)
        inception.convert_pb(pb, npz)
    assets["inception_v3_fid.npz"] = npz
    print(json.dumps({"stage": "convert", "inception_npz": npz}), flush=True)
    return assets


def sample(args, assets: dict) -> str:
    """Guided sampling through the sampling CLI; returns the samples npz."""
    out = os.path.join(args.out_dir, f"samples_{args.num_samples}.npz")
    if os.path.exists(out):
        print(json.dumps({"stage": "sample", "npz": out, "cached": True}), flush=True)
        return out
    from . import classifier_sample
    from .utils import logger

    model_flags = args.size_override or MODEL_FLAGS_64
    classifier_flags = [] if args.size_override else CLASSIFIER_FLAGS_64
    argv = [
        *model_flags, *classifier_flags,
        "--model_path", assets["64x64_diffusion.pt"],
        "--classifier_path", assets["64x64_classifier.pt"],
        "--batch_size", str(args.batch_size),
        "--num_samples", str(args.num_samples),
        "--timestep_respacing", args.timestep_respacing,
        "--main_path", args.out_dir,
        "--device", args.device,
    ]
    print(f"[sample] python -m guided_diffusion_clip_tpu_torch.classifier_sample {shlex.join(argv)}", flush=True)
    try:
        result = classifier_sample.main(argv)
    finally:
        logger.reset()
    os.replace(result["path"], out)
    print(json.dumps({"stage": "sample", "npz": out}), flush=True)
    return out


def evaluate(args, assets: dict, samples_npz: str) -> dict:
    """The port's evaluator with its Inception; the metrics beside the
    published table."""
    from .evaluations import evaluator

    argv = [assets["VIRTUAL_imagenet64_labeled.npz"], samples_npz, "--extractor", "flax-inception",
            "--device", args.device, "--inception_npz", assets["inception_v3_fid.npz"]]
    print(f"[evaluate] python -m guided_diffusion_clip_tpu_torch.evaluations.evaluator {shlex.join(argv)}",
          flush=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        evaluator.main(argv)
    print(out.getvalue(), flush=True)
    metrics = {}
    for line in out.getvalue().splitlines():
        for key in evaluator.METRIC_LINES:
            if line.strip().startswith(key + ":"):
                metrics[key.lower().replace(" ", "_")] = float(line.split(":", 1)[1].strip())
    result = {
        "stage": "evaluate",
        "metrics": metrics,
        "published_targets_imagenet64_guided": PUBLISHED_64,
        "note": "published table: reference README.md:127 "
                "(250-step classifier-guided, 50k samples; small-sample runs "
                "read HIGHER FID — compare like for like)",
    }
    print(json.dumps(result), flush=True)
    return result


def clip_check(args, assets: dict) -> dict:
    """Load the ViT-B/32 weights and the BPE vocabulary, tokenize a prompt,
    encode it and a random image, and check the embeddings' geometry
    (finite, of the config's width; their cosine in [-1, 1]). Under
    ``GDC_CLIP_TINY`` the tiny config, its vocabulary sized from the merges
    file (``clip_guided_sample``'s pattern)."""
    import dataclasses

    import numpy as np
    import torch

    from .models.clip_tokenizer import SimpleTokenizer
    from .models.clip_vit import clip_config, load_clip_params

    cfg = clip_config()
    tok = SimpleTokenizer(bpe_path=assets["bpe_simple_vocab_16e6.txt.gz"], context_length=cfg.context_length)
    if os.environ.get("GDC_CLIP_TINY"):
        cfg = dataclasses.replace(cfg, vocab_size=len(tok.encoder))
    elif len(tok.encoder) != cfg.vocab_size:
        raise SystemExit(f"BPE vocab yields {len(tok.encoder)} tokens, CLIP expects {cfg.vocab_size}")
    device = torch.device(args.device)
    vision, text = load_clip_params(assets["ViT-B-32.pt"], cfg, device)

    tokens = torch.from_numpy(tok("a photo of a diffusion model")).to(device)  # [1, context]
    rs = np.random.RandomState(0)
    img = rs.uniform(-1, 1, (1, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    with torch.no_grad():
        v = vision(torch.from_numpy(img).to(device)).cpu().numpy()
        t = text(tokens).cpu().numpy()
    if v.shape != (1, cfg.embed_dim) or t.shape != (1, cfg.embed_dim):
        raise SystemExit(f"clip_check: embeddings of shape {v.shape} and {t.shape}, not (1, {cfg.embed_dim})")
    if not (np.isfinite(v).all() and np.isfinite(t).all()):
        raise SystemExit("clip_check: non-finite embeddings")
    cos = float(((v / np.linalg.norm(v)) @ (t / np.linalg.norm(t)).T)[0, 0])
    result = {
        "stage": "clip_check",
        "vocab_size": len(tok.encoder),
        "embed_dim": int(v.shape[-1]),
        "image_embed_norm": float(np.linalg.norm(v)),
        "text_embed_norm": float(np.linalg.norm(t)),
        "cosine_random_image_vs_prompt": cos,
        "ok": True,
    }
    print(json.dumps(result), flush=True)
    return result


def create_argparser():
    ap = argparse.ArgumentParser(description="fetch/convert released ADM assets, sample, evaluate")
    ap.add_argument("--assets_dir", required=True)
    ap.add_argument("--out_dir", default="")
    ap.add_argument("--download", action="store_true", help="attempt HTTP fetch of missing assets")
    ap.add_argument("--num_samples", type=int, default=1000)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--timestep_respacing", default="250")
    ap.add_argument("--stages", default="resolve,convert,sample,evaluate",
                    help="comma subset of resolve,convert,sample,evaluate,clip_check (clip_check = real "
                         "ViT-B/32 + BPE vocab import/encode acceptance)")
    ap.add_argument("--size_override", default="",
                    help="space-separated flag string replacing the published 64px model flags (tests use a "
                         "tiny config)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    """Run the stages; returns {stage: its result} of those that ran."""
    args = create_argparser().parse_args(argv)
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    args.size_override = shlex.split(args.size_override) if args.size_override else None
    args.out_dir = args.out_dir or os.path.join(args.assets_dir, "acceptance_out")
    os.makedirs(args.out_dir, exist_ok=True)
    stages = args.stages.split(",")

    done = {}
    if "resolve" in stages:
        assets = done["resolve"] = resolve(args, stages)
    else:
        assets = {k: os.path.join(args.assets_dir, k) for k in list(ASSET_URLS) + ["inception_v3_fid.npz"]
                  if os.path.exists(os.path.join(args.assets_dir, k))}
    if "convert" in stages:
        assets = done["convert"] = convert(args, assets)
    if "clip_check" in stages:
        done["clip_check"] = clip_check(args, assets)
    samples_npz = sample(args, assets) if "sample" in stages else os.path.join(
        args.out_dir, f"samples_{args.num_samples}.npz")
    if "sample" in stages:
        done["sample"] = samples_npz
    if "evaluate" in stages:
        done["evaluate"] = evaluate(args, assets, samples_npz)
    return done


if __name__ == "__main__":
    main()
