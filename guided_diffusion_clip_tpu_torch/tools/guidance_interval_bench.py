"""The guidance interval on the card: what a guided chain costs when the
classifier runs only inside a window of timesteps.

    python -m guided_diffusion_clip_tpu_torch.tools.guidance_interval_bench [--device cuda]

Counterpart of ``tools/guidance_interval_bench.py``: ADM-G 256 guided by its
classifier (``_timing.make_models``, N(0, 0.02) weights), ancestral steps,
first with the classifier's gradient every step, then gated by
``interval_cond_fn`` to each window of ``GIB_WINDOWS`` (model timesteps).
The port decides the window on the host, so a step outside it runs neither
the classifier's forward nor its backward. The interval changes the sampled
distribution on purpose, so the samples' correlation with the always-guided
chain's (same generators) is context, not a bound. Each chain runs twice, a
warm-up and then the timed run (CUDA events).

Environment, as the JAX tool's: ``GIB_BATCH`` (16), ``GIB_IMAGE_SIZE``
(256), ``GIB_STEPS`` (the respacing, 250), ``GIB_WINDOWS`` ("0,700;200,800"),
``GIB_CONV_IMPL`` (int8, the default, or xla), ``GIB_DEEP_CACHE`` (0; N > 1
adds DeepCache on the generator) and ``GIB_GUIDANCE_CACHE`` (0; N > 1
recomputes the gradient one step in N, the window inside the cache), as
``classifier_sample`` composes them; ``GIB_CH`` (256 at 256 px, else 192)
and ``GIB_FP16`` (1).

One JSON line with the JAX tool's keys, ``full_guidance_samples_per_min``
and per window ``interval[lo,hi]``: ``samples_per_min``, ``speedup`` and
``corr_vs_full_context_only`` (unrounded), plus each chain's
``secs_per_chain``, each window's ``rel_rmse_vs_full`` (the same context) and
``card``. ``--device cpu`` rehearses the tool: times but no rate.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..models.unet import CONV_IMPLS
from ._chains import classifier_chain, labels
from ._timing import card_label, deviation, make_models, on_card_defaults, per_min, pick_device, timed_twice


def settings() -> dict:
    size = int(os.environ.get("GIB_IMAGE_SIZE", 256))
    s = {
        "batch": int(os.environ.get("GIB_BATCH", 16)),
        "size": size,
        "steps": os.environ.get("GIB_STEPS", "250"),
        "windows": [tuple(float(v) for v in w.split(","))
                    for w in os.environ.get("GIB_WINDOWS", "0,700;200,800").split(";") if w.strip()],
        "conv_impl": os.environ.get("GIB_CONV_IMPL", "int8"),
        "deep_cache": int(os.environ.get("GIB_DEEP_CACHE", 0)),
        "guidance_cache": int(os.environ.get("GIB_GUIDANCE_CACHE", 0)),
        "channels": int(os.environ.get("GIB_CH", 256 if size == 256 else 192)),
        "fp16": os.environ.get("GIB_FP16", "1") == "1",
    }
    if s["conv_impl"] not in CONV_IMPLS:
        raise SystemExit(f"GIB_CONV_IMPL {s['conv_impl']!r}: choose from {CONV_IMPLS}")
    return s


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    s = settings()
    device = pick_device(args.device)
    card = card_label(device)
    on_card_defaults(device)
    model, classifier, diffusion = make_models(s["size"], s["conv_impl"], s["channels"], respacing=s["steps"], fp16=s["fp16"], device=device)
    B, classes = s["batch"], labels(s["batch"], device)

    def run(window, label):
        chain = classifier_chain(diffusion.p_sample_loop, model, classifier, classes, interval=window,
                                 deep_cache=s["deep_cache"], guidance_cache=s["guidance_cache"])
        out, secs = timed_twice(chain, device)
        print(f"[gib] {label}: {secs:.3f} s a chain of {diffusion.num_timesteps} steps at batch {B}, "
              f"network calls over both runs {chain.calls} ({card})", flush=True)
        return out.float().cpu().numpy().ravel().astype(np.float64), secs

    ref, ref_s = run(None, "full-guidance")
    results = {"full_guidance_samples_per_min": per_min(B, ref_s, device), "full_guidance_secs_per_chain": ref_s}
    for lo, hi in s["windows"]:
        label = f"interval[{lo:g},{hi:g}]"
        out, secs = run((lo, hi), label)
        dev = deviation(ref, out)
        results[label] = {"samples_per_min": per_min(B, secs, device), "secs_per_chain": secs,
                          "speedup": ref_s / secs, "corr_vs_full_context_only": dev["corr"],
                          "rel_rmse_vs_full": dev["rel_rmse"]}
    results["card"] = card
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
