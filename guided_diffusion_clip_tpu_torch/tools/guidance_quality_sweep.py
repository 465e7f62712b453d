"""The quality side of the guidance knobs: Frechet distance to real blobs
and the classifier's accuracy, for each guidance window and cache interval.

    python -m guided_diffusion_clip_tpu_torch.tools.guidance_quality_sweep [--device cuda]

Counterpart of ``tools/guidance_quality_sweep.py``:

  1. train a generator on blobs and a noised classifier on their
     dominant-color label (``_proxies``, ``int8_chain_quality``'s machinery
     and configurations: at the default 64 px the generator's attention runs
     at d = 96 and 128, the classifier's at d = 96);
  2. for each sweep point (``interval_cond_fn`` inside ``cached_cond_fn``,
     as ``classifier_sample`` composes them) sample a set of classifier-
     guided ancestral chains for the labels 0, 1, 2, 0, ... from the EMA
     (bf16 torso on the card, float32 on the CPU; the classifier float32);
  3. score each set's features (the trained blob extractor) against three
     class-matched real draws, beside the floor of the real draws' three
     pairs;
  4. read the classifier's accuracy on the samples at t = 0; and the same
     for an unguided set, for context.

Environment, as the JAX tool's: ``GQS_TRAIN_STEPS`` (600), ``GQS_SAMPLES``
(64), ``GQS_IMAGE`` (64), ``GQS_DIFFUSION_STEPS`` (1000), ``GQS_RESPACING``
(250), ``GQS_BATCH`` (16), ``GQS_GUIDE_SCALE`` (10), ``GQS_FEAT_STEPS``
(300), ``GQS_SWEEP`` (comma list of ``lo:hi:gcN`` points, ``off`` for no
window; default ``off:gc1,off:gc2,off:gc4,0:700:gc1,200:800:gc1,200:800:gc2``).

One JSON line with the JAX tool's keys plus ``card``.
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

from ..utils import logger
from ..utils.script_util import create_gaussian_diffusion
from . import _proxies as P
from ._chains import classifier_chain
from ._timing import card_label, on_card_defaults, pick_device
from .fidelity import frechet, train_feature_extractor

DEFAULT_SWEEP = "off:gc1,off:gc2,off:gc4,0:700:gc1,200:800:gc1,200:800:gc2"


def parse_sweep(spec: str) -> list:
    """``lo:hi:gcN`` tokens as (window or None, cache interval): ``gcN`` may
    be left out (1), and ``off`` or nothing before it is no window."""
    pts = []
    for tok in spec.split(","):
        parts = tok.strip().split(":")
        gc = 1
        if parts and parts[-1].startswith("gc"):
            gc = int(parts[-1][2:])
            parts = parts[:-1]
        if parts == ["off"] or not parts or parts == [""]:
            interval = None
        else:
            interval = (float(parts[0]), float(parts[1]))
        pts.append((interval, gc))
    return pts


def point_tag(interval, gc: int) -> str:
    return (f"{int(interval[0])}:{int(interval[1])}" if interval else "off") + f":gc{gc}"


def settings() -> dict:
    return {
        "train_steps": int(os.environ.get("GQS_TRAIN_STEPS", 600)),
        "n_samples": int(os.environ.get("GQS_SAMPLES", 64)),
        "size": int(os.environ.get("GQS_IMAGE", 64)),
        "T": int(os.environ.get("GQS_DIFFUSION_STEPS", 1000)),
        "batch": int(os.environ.get("GQS_BATCH", 16)),
        "respacing": os.environ.get("GQS_RESPACING", "250"),
        "guide_scale": float(os.environ.get("GQS_GUIDE_SCALE", 10.0)),
        "feat_steps": int(os.environ.get("GQS_FEAT_STEPS", 300)),
        "sweep": parse_sweep(os.environ.get("GQS_SWEEP", DEFAULT_SWEEP)),
    }


def point_chain(diffusion, model, classifier, classes, interval, gc: int, scale: float):
    """A sweep point's chain: ancestral, guided at ``scale`` inside
    ``interval`` (None: every step), the gradient reused ``gc`` - 1 steps in
    ``gc``; unguided with ``classifier`` None."""
    return classifier_chain(diffusion.p_sample_loop, model, classifier, classes, interval=interval,
                            guidance_cache=gc if gc > 1 else 0, scale=scale)


def classifier_acc(classifier, x: np.ndarray, want: np.ndarray, batch: int) -> float:
    """The classifier's accuracy on the NHWC samples ``x`` at t = 0, in
    batches of ``batch``."""
    device = next(classifier.parameters()).device
    hits = []
    with torch.no_grad():
        for i in range(0, len(x), batch):
            xb = torch.from_numpy(P.to_nchw(x[i:i + batch])).to(device)
            logits = classifier(xb, torch.zeros(len(xb), device=device))
            hits.append((logits.argmax(-1).cpu().numpy() == want[i:i + batch]))
    return float(np.concatenate(hits).mean())


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
        print(f"[gqs +{time.time() - t0:.0f}s] {msg}", file=sys.stderr, flush=True)

    B, size, n = s["batch"], s["size"], s["n_samples"]
    logger.configure_dir(dir=tempfile.mkdtemp(prefix="guidance_quality_sweep_"), format_strs=[])
    cfg = P.generator_config(size)
    diffusion = create_gaussian_diffusion(steps=s["T"], noise_schedule="cosine")
    sample_diffusion = create_gaussian_diffusion(steps=s["T"], noise_schedule="cosine",
                                                 timestep_respacing=s["respacing"])
    rs = np.random.RandomState(0)
    note("training the generator")
    torch.manual_seed(0)
    loop, _, _ = P.train_generator(P.build_generator(cfg, device=device), diffusion, P.blob_stream(rs, B, size), B,
                                   s["train_steps"], note=note)
    model = P.sampling_copy(cfg, P.ema_values(loop), device)
    del loop
    note("training the noised classifier")
    torch.manual_seed(2)
    clf = P.build_classifier(size, device=device)
    P.train_classifier(clf, diffusion, rs, B, s["train_steps"], note=note)
    classes = torch.arange(B, device=device) % P.N_CLASSES

    note("training the feature extractor")
    feats_fn, feat_loss = train_feature_extractor(size, steps=s["feat_steps"], log=note, device=device)
    f_real = [feats_fn(P.class_matched_real_set(1000 + 97 * i, n, size)) for i in range(3)]
    mu, sd = f_real[0].mean(0), f_real[0].std(0) + 1e-8
    z_real = [(f - mu) / sd for f in f_real]
    floor_vals = [frechet(z_real[0], z_real[1]), frechet(z_real[0], z_real[2]), frechet(z_real[1], z_real[2])]
    result = {
        "config": f"{size}px ch{cfg.model_channels}, {s['respacing'] or s['T']}-step ancestral (T={s['T']}), "
                  f"scale {s['guide_scale']}, {s['train_steps']} train steps, {n} samples/set",
        "feat_extractor_final_loss": feat_loss,
        "floor_real_vs_real": {"values": floor_vals, "mean": float(np.mean(floor_vals)),
                               "max": float(np.max(floor_vals))},
        "sweep": [],
    }
    note(f"floor real-vs-real: {floor_vals}")

    want = np.arange(n) % P.N_CLASSES

    def scored(samples):
        fs = (feats_fn(samples) - mu) / sd
        return [frechet(fs, zr) for zr in z_real], classifier_acc(clf, samples, want, B)

    for interval, gc in s["sweep"]:
        tag = point_tag(interval, gc)
        chain = point_chain(sample_diffusion, model, clf, classes, interval, gc, s["guide_scale"])
        d_real, acc = scored(P.sample_set(chain, n, B, 100))
        result["sweep"].append({
            "point": tag, "frechet_to_real": d_real, "frechet_to_real_mean": float(np.mean(d_real)),
            "over_floor_max": float(np.mean(d_real) / max(max(floor_vals), 1e-12)),
            "classifier_acc_on_samples": acc,
        })
        note(f"{tag}: frechet-to-real {np.mean(d_real):.3f} (floor max {max(floor_vals):.3f}), acc {acc:.3f}")

    d_u, acc_u = scored(P.sample_set(point_chain(sample_diffusion, model, None, classes, None, 1, 0.0), n, B, 700))
    result["unguided_frechet_to_real_mean"] = float(np.mean(d_u))
    result["unguided_classifier_acc"] = acc_u
    result["wall_s"] = round(time.time() - t0, 1)
    result["card"] = card
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
