"""Chain-level quality of a sampling knob on a trained proxy: int8 convs,
DeepCache, cached guidance or a cached classifier-free branch, alone or
stacked.

    python -m guided_diffusion_clip_tpu_torch.tools.int8_chain_quality [--device cuda]

Counterpart of ``tools/int8_chain_quality.py``:

  1. train a small ADM UNet on synthetic blobs (``_proxies``: ``TrainLoop``
     on ``RandomState(0)``'s stream, the EMA cloned after a train_steps // 8
     for the positive control); for a ``gcN`` study also a noised
     classifier on the blobs' dominant-color label, for a ``cfgcN`` study a
     ``clip_feat`` generator trained with conditioning dropout 0.15;
  2. sample sets from the EMA with the per-sample generators: ``base_a``
     (bf16 torso and cuDNN on the card, float32 on the CPU; fully guided in
     a guided study, plain CFG in a cfgc study), the ``variant`` from the
     same seeds (the knobs of ``INT8Q_VARIANT``), ``base_b`` and ``base_c``
     from disjoint seeds, and the positive control (the base chain from the
     undertrained snapshot);
  3. per sample, the pixel correlation and the RMS difference over the
     deviation of ``base_a`` and ``variant``; per set, the Frechet distance
     on the trained blob extractor (``fidelity.score_sets``) against the
     floor of three base pairs, and whether the positive control clears it.

``INT8Q_VARIANT`` names the knobs, alone or joined by ``+``: ``int8`` (the
generator, and in a guided study the classifier, built again from the same
weights with ``conv_impl="int8"``: K4, K5 and the quantize kernels), ``dcN``
(``deep_cache_model_fn``, the deep sub-UNet refreshed one step in N),
``gcN`` (``cached_cond_fn``, the gradient one step in N) and ``cfgcN``
(``cfg_cached_model_fn``, the unconditional branch one step in N), composed
as ``classifier_sample`` composes them; ``cfgc`` composes with neither
``dc`` nor ``gc``, as in the JAX tool.

Environment, as the JAX tool's: ``INT8Q_TRAIN_STEPS`` (400),
``INT8Q_SAMPLES`` (64), ``INT8Q_IMAGE`` (16; >= 64 the ADM-style proxy,
>= 128 the headline-class one), ``INT8Q_DIFFUSION_STEPS`` (100),
``INT8Q_BATCH`` (16), ``INT8Q_RESPACING`` ("": no respacing),
``INT8Q_SAMPLER`` (ancestral or ddim), ``INT8Q_VARIANT`` (int8),
``INT8Q_GUIDE_SCALE`` (10), ``INT8Q_CFG_SCALE`` (3), ``INT8Q_FEAT_STEPS``
(300).

One JSON line with the JAX tool's keys (the per-sample statistics
unrounded, where the JAX tool rounds them to 5-6 places) plus ``card``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..diffusion.guidance import cfg_cached_model_fn, cfg_cached_state0, cfg_model_fn
from ..utils import logger
from ..utils.script_util import create_gaussian_diffusion
from . import _proxies as P
from ._chains import classifier_chain, runner
from ._timing import card_label, on_card_defaults, pick_device
from .fidelity import score_sets, train_feature_extractor


def settings() -> dict:
    variant = os.environ.get("INT8Q_VARIANT", "int8")
    parts = variant.split("+")
    s = {
        "train_steps": int(os.environ.get("INT8Q_TRAIN_STEPS", 400)),
        "n_samples": int(os.environ.get("INT8Q_SAMPLES", 64)),
        "size": int(os.environ.get("INT8Q_IMAGE", 16)),
        "T": int(os.environ.get("INT8Q_DIFFUSION_STEPS", 100)),
        "batch": int(os.environ.get("INT8Q_BATCH", 16)),
        "respacing": os.environ.get("INT8Q_RESPACING", ""),
        "sampler": os.environ.get("INT8Q_SAMPLER", "ancestral"),
        "variant": variant,
        "dc": next((int(p[2:]) for p in parts if p.startswith("dc")), 0),
        "cfgc": next((int(p[4:]) for p in parts if p.startswith("cfgc")), 0),
        "gc": next((int(p[2:]) for p in parts if p.startswith("gc")), 0),
        "int8": "int8" in parts,
        "guide_scale": float(os.environ.get("INT8Q_GUIDE_SCALE", 10.0)),
        "cfg_scale": float(os.environ.get("INT8Q_CFG_SCALE", 3.0)),
        "feat_steps": int(os.environ.get("INT8Q_FEAT_STEPS", 300)),
    }
    assert not (s["cfgc"] and s["dc"]), "cfgc does not compose with dc"
    assert not (s["cfgc"] and s["gc"]), "cfgc does not compose with gc"
    if s["sampler"] not in ("ancestral", "ddim"):
        raise SystemExit(f"INT8Q_SAMPLER {s['sampler']!r}: ancestral or ddim")
    return s


def make_chain(s: dict, diffusion, model, classifier=None, *, variant: bool):
    """``run(seed)`` (or ``run(noise=..., step_noise=...)``) of one set's
    chain: ``model`` over ``diffusion``'s ``INT8Q_SAMPLER`` loop at batch
    ``INT8Q_BATCH``. A guided study (``classifier``) guides every set at
    ``INT8Q_GUIDE_SCALE`` for the labels 0, 1, 2, 0, ...; a cfgc study runs
    CFG at ``INT8Q_CFG_SCALE`` on the labels' conditioning rows. With
    ``variant`` the chain takes the study's caches (dcN, gcN, cfgcN);
    ``run.calls`` counts the networks' calls."""
    device, B, size = next(model.parameters()).device, s["batch"], s["size"]
    loop = diffusion.ddim_sample_loop if s["sampler"] == "ddim" else diffusion.p_sample_loop
    classes = torch.arange(B, device=device) % P.N_CLASSES
    shape = (B, 3, size, size)
    if not s["cfgc"]:
        return classifier_chain(loop, model, classifier, classes, deep_cache=s["dc"] if variant else 0,
                                guidance_cache=s["gc"] if variant else 0, scale=s["guide_scale"])
    calls = {"unet_full": 0, "unet_shallow": 0, "classifier": 0}

    def base_fn(x, t, **kw):
        calls["unet_full"] += 1
        return model(x, t, **kw)

    feats = {"clip_feat": torch.from_numpy(P.FEAT_ROWS[np.arange(B) % P.N_CLASSES]).to(device)}
    if variant:
        run = runner(loop, cfg_cached_model_fn(base_fn, s["cfg_scale"], {"clip_feat": 0.0}, s["cfgc"]), classes,
                     shape, model_state0=cfg_cached_state0(shape, device=device), model_kwargs=feats)
    else:
        run = runner(loop, cfg_model_fn(base_fn, s["cfg_scale"], {"clip_feat": 0.0}), classes, shape,
                     model_kwargs=feats)
    run.calls = calls
    return run


def same_seed_stats(a: np.ndarray, b: np.ndarray) -> tuple:
    """(per-sample pixel correlation, per-sample RMS difference over a's
    deviation) of two same-seed sets."""
    fa, fb = a.reshape(len(a), -1), b.reshape(len(b), -1)
    corr = np.array([np.corrcoef(fa[i], fb[i])[0, 1] for i in range(len(a))])
    rel_rmse = np.sqrt(((fa - fb) ** 2).mean(1)) / (fa.std(1) + 1e-12)
    return corr, rel_rmse


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    t0 = time.time()
    s = settings()
    device = pick_device(args.device)
    card = card_label(device)
    on_card_defaults(device)

    def note(msg):
        print(f"[int8q +{time.time() - t0:.0f}s] {msg}", file=sys.stderr, flush=True)

    B, size, steps = s["batch"], s["size"], s["train_steps"]
    logger.configure_dir(dir=tempfile.mkdtemp(prefix="int8_chain_quality_"), format_strs=[])
    cfg = P.generator_config(size, clip_feat=bool(s["cfgc"]))
    torch.manual_seed(0)
    model = P.build_generator(cfg, device=device)
    diffusion = create_gaussian_diffusion(steps=s["T"], noise_schedule="cosine")
    sample_diffusion = (create_gaussian_diffusion(steps=s["T"], noise_schedule="cosine",
                                                  timestep_respacing=s["respacing"]) if s["respacing"] else diffusion)
    rs = np.random.RandomState(0)
    snap_at = max(1, steps // 8)
    note("training the generator")
    loop, undertrained, _ = P.train_generator(model, diffusion, P.blob_stream(rs, B, size, bool(s["cfgc"])), B, steps,
                                              cond_dropout=0.15 if s["cfgc"] else 0.0, snapshot_at=snap_at, note=note)
    note(f"trained {steps} steps")
    ema = P.ema_values(loop)
    undertrained = dict(zip(loop.names, undertrained))
    del loop, model

    classifiers = {"base": None, "variant": None}
    if s["gc"]:
        torch.manual_seed(2)
        clf = P.build_classifier(size, device=device)
        P.train_classifier(clf, diffusion, rs, B, steps, note=note)
        classifiers = {"base": clf, "variant": P.classifier_copy(clf, "int8") if s["int8"] else clf}

    def chain(name, values=ema):
        impl = "int8" if name == "variant" and s["int8"] else "xla"
        model = P.sampling_copy(cfg, values, device, impl)
        return make_chain(s, sample_diffusion, model, classifiers[name], variant=name == "variant")

    base, var = chain("base"), chain("variant")
    sets = {}
    for name, run, seed0 in (("base_a", base, 100), ("variant", var, 100), ("base_b", base, 500),
                             ("base_c", base, 900), ("undertrained_posctrl", chain("base", undertrained), 100)):
        sets[name] = P.sample_set(run, s["n_samples"], B, seed0)
        note(f"{name} sampled")

    corr, rel_rmse = same_seed_stats(sets["base_a"], sets["variant"])
    feats_fn, feat_loss = train_feature_extractor(size, steps=s["feat_steps"], log=note, device=device)
    scores = score_sets(feats_fn, sets)
    floor_max = scores["floor"]["max"]
    chain_desc = s["respacing"] or str(s["T"])
    result = {
        "config": f"{size}px ch{cfg.model_channels} ADM UNet, {chain_desc}-step {s['sampler']} chain (T={s['T']}), "
                  f"{steps} train steps, {s['n_samples']} samples/set",
        "variant": s["variant"],
        "same_seed_pixel_corr_mean": float(corr.mean()),
        "same_seed_pixel_corr_min": float(corr.min()),
        "same_seed_rel_rmse_mean": float(rel_rmse.mean()),
        "same_seed_rel_rmse_max": float(rel_rmse.max()),
        "set_frechet": scores,
        "feat_extractor_final_loss": feat_loss,
        "posctrl_separated": bool(scores["undertrained_posctrl"]["mean"] > floor_max),
        "variant_within_floor": bool(scores["variant"]["mean"] <= floor_max),
        "wall_s": round(time.time() - t0, 1),
        "card": card,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
